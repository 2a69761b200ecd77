"""Per-stage engine timers, on the device's own clock.

Counterpart: ``lighthouse_tpu/observability/stages.py`` (:29-74), whose
``traced`` blocks on each stage while timing is active. The port never
blocks for it: a stage on the card returns before the card has run it,
and a caller may read the verdict much later (a pipelined batch). So on
the card ``traced`` records a CUDA event on the caller's stream before
and after the stage's dispatch, and the pair becomes an
``engine_stage_seconds{engine,stage}`` sample once the end event has
completed: ``settle`` observes every completed pair, and a pending
verdict calls it when its caller reads the verdict. Nothing here waits
on the device as a whole, so timing never serialises dispatch with
execution. On the CPU a stage runs where it is called, and its wall time
is observed at once.

Events are never recorded while the caller's stream is capturing a CUDA
graph: there they would become graph nodes. A stage that replays a graph
is timed by events around its replay; the capture on a bucket's first
use runs on a side stream, outside them (its cost is the graph's
``stats``).

Timing is off by default (one attribute read a stage): on while a trace
is taken, or after ``force_timing(True)`` for servers that want the
/metrics histograms without an unbounded trace. The metric's name, labels,
help string and buckets are the JAX package's, so that one dashboard
reads both; the port's engine label is ``gpu``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import torch

from ..common import metrics as m
from . import trace

# The JAX package's buckets: stage times span ~1 ms (a replayed stage) to
# seconds (an eager stage of a large bucket on the CPU).
STAGE_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 120.0)

_force_timing = False
# Event pairs recorded on the card and not yet observed: (histogram child,
# start, end).
_PENDING: list = []
_PENDING_LOCK = threading.Lock()


def force_timing(on: bool = True) -> None:
    global _force_timing
    _force_timing = on


def timing_active() -> bool:
    return trace.TRACER.enabled or _force_timing


def stage_seconds(registry: m.Registry = None) -> m.LabeledHistogram:
    return (registry or m.REGISTRY).histogram_vec(
        "engine_stage_seconds",
        "Blocked per-stage engine wall time (only sampled while stage "
        "timing is active; first calls include compile)",
        labels=("engine", "stage"), buckets=STAGE_BUCKETS)


def _device(args) -> Optional[torch.device]:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return None


def settle(wait: bool = False) -> int:
    """Observe every recorded stage whose end event has completed; with
    `wait`, first wait on each one's end event (on that event only).
    Returns the number observed."""
    with _PENDING_LOCK:
        marks, _PENDING[:] = list(_PENDING), []
    keep, done = [], 0
    for child, start, end in marks:
        if wait:
            end.synchronize()
        elif not end.query():
            keep.append((child, start, end))
            continue
        child.observe(start.elapsed_time(end) / 1e3)
        done += 1
    if keep:
        with _PENDING_LOCK:
            _PENDING.extend(keep)
    return done


def traced(engine: str, stage: str, fn: Callable, **static_args) -> Callable:
    """Wrap a stage callable. `static_args` (bucket shape etc.) are stamped
    into each span's args, not into metric labels: shapes are
    unbounded-cardinality and belong in the trace, not /metrics."""
    hist = stage_seconds()

    def wrapped(*args):
        if not (trace.TRACER.enabled or _force_timing):
            return fn(*args)
        device = _device(args)
        on_card = device is not None and device.type == "cuda"
        if on_card and torch.cuda.is_current_stream_capturing():
            return fn(*args)
        child = hist.labels(engine=engine, stage=stage)
        with trace.span(f"{engine}:{stage}", cat="stage",
                        engine=engine, stage=stage, **static_args):
            if not on_card:
                t0 = time.perf_counter()
                out = fn(*args)
                child.observe(time.perf_counter() - t0)
                return out
            stream = torch.cuda.current_stream(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            out = fn(*args)
            end.record(stream)
        settle()
        with _PENDING_LOCK:
            _PENDING.append((child, start, end))
        return out

    wrapped.__name__ = f"traced_{stage}"
    wrapped.__wrapped__ = fn
    return wrapped
