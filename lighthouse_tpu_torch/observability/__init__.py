"""Observability of the port: the span tracer (``trace``) and the
per-stage engine timers (``stages``), counterparts of the JAX package's
``observability/trace.py`` and ``observability/stages.py``."""
