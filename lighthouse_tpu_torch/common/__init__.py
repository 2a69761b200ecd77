"""Shared runtime utilities of the port: the metrics registry (``metrics``)
and slot clocks (``slot_clock``), copies of the JAX package's."""
