"""The wire frame codec shared with the JAX package."""
