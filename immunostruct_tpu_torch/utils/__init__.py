"""Checkpoint interchange with the JAX package."""
