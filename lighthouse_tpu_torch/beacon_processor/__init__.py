"""Beacon-processor seams of the port: the priority work queues and batch
former (``processor``) and the shape warmer (``warming``)."""
