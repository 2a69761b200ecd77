"""Span tracer with Chrome trace-event JSON export.

The engine's unit of time is a CUDA graph replay, not a function call,
so profilers that sample the Python stack see nothing: the interesting
boundaries are the three stage dispatches, the captures around them, and
the serving-layer lifecycle that feeds them. This module records exactly
those as spans and exports the standard Chrome trace-event format
(`chrome://tracing` / Perfetto both open it): complete events (`ph:"X"`,
microsecond `ts`/`dur`), instants (`ph:"i"`) and counter series
(`ph:"C"`). A span around a device stage covers its host dispatch; the
stage's device time is `observability/stages.py`'s.

Tracing is OFF by default and the disabled path is one attribute read.
Enable programmatically (`trace.enable()`) or via
`LIGHTHOUSE_TPU_TRACE=1`; setting it to a path (`/tmp/run.trace.json`)
also installs an atexit export to that path.

A copy of ``lighthouse_tpu/observability/trace.py`` (:30-204), with the
same setting: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional


class Tracer:
    """Thread-safe in-memory trace buffer. All timestamps come from one
    `perf_counter` origin so spans from different threads line up."""

    def __init__(self, max_events: int = 200_000):
        self.max_events = max_events
        self.enabled = False
        self._events: List[Dict[str, Any]] = []
        self._dropped = 0
        self._origin = time.perf_counter()
        self._lock = threading.Lock()
        self._depth = threading.local()

    # ------------------------------------------------------------- control

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._events = []
            self._dropped = 0
            self._origin = time.perf_counter()

    def _now_us(self) -> float:
        return (time.perf_counter() - self._origin) * 1e6

    def _depth_stack(self) -> list:
        stack = getattr(self._depth, "stack", None)
        if stack is None:
            stack = self._depth.stack = []
        return stack

    def _push(self, event: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._events) >= self.max_events:
                self._dropped += 1
                return
            self._events.append(event)

    # ----------------------------------------------------------- recording

    @contextmanager
    def span(self, name: str, cat: str = "engine", **args):
        """Record a complete event around the `with` body. Nesting depth
        is tracked per thread and stamped into args so exporters (and the
        balance test) can check containment without re-deriving it."""
        if not self.enabled:
            yield None
            return
        stack = self._depth_stack()
        stack.append(name)
        depth = len(stack)
        t0 = self._now_us()
        try:
            yield self
        finally:
            t1 = self._now_us()
            stack.pop()
            ev_args = {"depth": depth}
            if args:
                ev_args.update(args)
            self._push({
                "name": name, "cat": cat, "ph": "X",
                "ts": t0, "dur": max(t1 - t0, 0.0),
                "pid": os.getpid(), "tid": threading.get_ident(),
                "args": ev_args,
            })

    def instant(self, name: str, cat: str = "engine", **args) -> None:
        if not self.enabled:
            return
        self._push({
            "name": name, "cat": cat, "ph": "i", "s": "t",
            "ts": self._now_us(),
            "pid": os.getpid(), "tid": threading.get_ident(),
            "args": dict(args),
        })

    def counter_series(self, name: str, cat: str = "engine",
                       **values) -> None:
        """A `ph:"C"` sample — one point per keyword on the named series
        (queue depths over time, in-flight batches...)."""
        if not self.enabled:
            return
        self._push({
            "name": name, "cat": cat, "ph": "C",
            "ts": self._now_us(),
            "pid": os.getpid(), "tid": threading.get_ident(),
            "args": dict(values),
        })

    # ------------------------------------------------------------- export

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def export(self) -> Dict[str, Any]:
        """The Chrome trace-event wrapper object (JSON-serialisable)."""
        with self._lock:
            events = list(self._events)
            dropped = self._dropped
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "producer": "lighthouse_tpu_torch.observability",
                "dropped_events": dropped,
            },
        }

    def save(self, path: str) -> str:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.export(), f)
        os.replace(tmp, path)
        return path


# The process-global tracer: every instrumentation seam in the package
# records here, so one enable() captures engine + serving + processor.
TRACER = Tracer()


def enabled() -> bool:
    return TRACER.enabled


def enable() -> Tracer:
    TRACER.enable()
    return TRACER


def disable() -> None:
    TRACER.disable()


def span(name: str, cat: str = "engine", **args):
    return TRACER.span(name, cat, **args)


def instant(name: str, cat: str = "engine", **args) -> None:
    TRACER.instant(name, cat, **args)


def counter_series(name: str, cat: str = "engine", **values) -> None:
    TRACER.counter_series(name, cat, **values)


def export() -> Dict[str, Any]:
    return TRACER.export()


def save(path: str) -> str:
    return TRACER.save(path)


def _init_from_env() -> Optional[str]:
    val = os.environ.get("LIGHTHOUSE_TPU_TRACE", "")
    if not val or val == "0":
        return None
    TRACER.enable()
    if val == "1":
        return None
    # Any other value is an export path; write it out when the process
    # exits so probe runs under the env var need no code changes.
    atexit.register(lambda: TRACER.save(val))
    return val


_TRACE_PATH = _init_from_env()
