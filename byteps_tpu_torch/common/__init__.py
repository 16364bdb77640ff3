"""Logging, configuration and the credit-scheduled queue."""
