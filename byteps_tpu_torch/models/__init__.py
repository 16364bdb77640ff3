"""The decoder-only Transformer and the JAX-parameter converter."""
