"""Operators: linear, EGNN, the edge_mega kernel, attention, pooling."""
