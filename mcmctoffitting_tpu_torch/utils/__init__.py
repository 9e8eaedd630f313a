"""Utilities of the port (synthetic observed data)."""
