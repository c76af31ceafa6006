"""Measurement scripts of the port."""
