"""Utilities of the port: the model summary."""
