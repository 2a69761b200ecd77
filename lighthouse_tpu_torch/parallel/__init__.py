"""Laying a batch over several devices: the port's mesh (``mesh.py``)."""
