"""Utilities of the port: weight converters."""
