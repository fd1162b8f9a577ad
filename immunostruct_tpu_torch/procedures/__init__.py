"""Training procedures."""
