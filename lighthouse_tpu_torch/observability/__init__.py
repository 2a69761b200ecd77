"""Observability of the port, counterparts of the JAX package's
``observability/`` modules:

  * `trace`          — process-global span tracer with Chrome
                       trace-event JSON export; off by default.
  * `stages`         — per-stage engine timers from CUDA events,
                       `engine_stage_seconds{engine,stage}`.
  * `compile_events` — executable provenance: kernel and native builds
                       or cache hits, graph captures, the warmer's path.
  * `report`         — the one probe-script JSON envelope.
  * `timeseries`     — in-process ring buffer of registry snapshots;
                       windowed delta/rate/quantile queries.
  * `slo`            — declarative objectives evaluated over those
                       windows (`slo_status{objective}`).

Submodules import lazily (PEP 562), as in the JAX package.
"""

_SUBMODULES = ("trace", "stages", "compile_events", "report",
               "timeseries", "slo")

__all__ = [
    "trace", "stages", "compile_events", "report", "timeseries", "slo",
    "Tracer", "TRACER", "span", "instant", "enable", "disable",
    "TimeSeries", "SloEngine", "Objective", "serving_objectives",
]

_EXPORTS = {
    "Tracer": ("trace", "Tracer"),
    "TRACER": ("trace", "TRACER"),
    "span": ("trace", "span"),
    "instant": ("trace", "instant"),
    "enable": ("trace", "enable"),
    "disable": ("trace", "disable"),
    "TimeSeries": ("timeseries", "TimeSeries"),
    "SloEngine": ("slo", "SloEngine"),
    "Objective": ("slo", "Objective"),
    "serving_objectives": ("slo", "serving_objectives"),
}


def __getattr__(name):
    import importlib

    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    if name in _EXPORTS:
        mod, attr = _EXPORTS[name]
        return getattr(importlib.import_module(f".{mod}", __name__), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
