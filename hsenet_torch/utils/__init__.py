"""Utilities of the port: weight converters, checkpoints, exports and profiling."""
