"""Build and capture events: where did this process's executables come from?

A bucket's first use on the card has different cold-start stories: the
CUDA kernel libraries built with nvcc or loaded from their source-hash
cache (``ops/_build.py``), the native CPU verifier built with g++ or
loaded (``native/__init__.py``), and each stage graph run once eagerly,
captured and instantiated (``ops/graphs.py``), by the warmer or by the
first verify. Which happened is invisible at the call site. This module
gives every such event one spine: ``record(event)`` bumps
``engine_compile_events_total{event}``, observes the seconds it took, if
given, in ``engine_compile_event_seconds{event}``, and drops a trace
instant.

Counterpart: ``lighthouse_tpu/observability/compile_events.py``, which
also subscribes to jax's monitoring bus for its persistent compile-cache
hits. The port has no bus: each event is recorded where it happens.

The event vocabulary (the docs and chip_smoke's ``control`` phase key off
these exact strings):
  kernel_build       a CUDA kernel library compiled with nvcc (seconds)
  kernel_cache_hit   a kernel library loaded from its source-hash cache
  native_build       a native host library compiled with g++ (seconds)
  native_cache_hit   a native host library loaded from its build cache
  graph_capture      a stage graph run eagerly, captured and instantiated
                     (seconds: the three together)
  warm_capture_path  the ShapeWarmer took the capture path for a rung
"""

from __future__ import annotations

from typing import Optional

from ..common import metrics as m
from . import trace

EVENTS = ("kernel_build", "kernel_cache_hit", "native_build", "native_cache_hit",
          "graph_capture", "warm_capture_path")

COMPILE_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
                   120.0, 300.0)


def _events_total(registry: Optional[m.Registry] = None) -> m.LabeledCounter:
    return (registry or m.REGISTRY).counter_vec(
        "engine_compile_events_total",
        "Executable provenance events (kernel_build|kernel_cache_hit|native_build"
        "|native_cache_hit|graph_capture|warm_capture_path)", "event")


def _event_seconds(registry: Optional[m.Registry] = None) -> m.LabeledHistogram:
    return (registry or m.REGISTRY).histogram_vec(
        "engine_compile_event_seconds",
        "Seconds of a kernel or native build, or of a graph's warm-up, capture "
        "and instantiation", labels=("event",), buckets=COMPILE_BUCKETS)


def record(event: str, seconds: Optional[float] = None, **args) -> None:
    """Count one provenance event, observe its seconds when given, and
    mirror it into the trace."""
    _events_total().labels(event).inc()
    if seconds is not None:
        _event_seconds().labels(event).observe(seconds)
        args["seconds"] = round(seconds, 6)
    trace.instant(f"compile:{event}", cat="compile", **args)


def counts() -> dict:
    """Current per-event totals (zero-filled for the vocabulary)."""
    c = _events_total()
    return {e: c.get(e) for e in EVENTS}
