"""Metrics registry (the serving subset)."""
