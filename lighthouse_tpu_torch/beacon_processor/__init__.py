"""Beacon-processor seams of the port: the shape warmer (``warming``)."""
