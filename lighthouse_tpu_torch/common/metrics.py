"""Metrics registry — prometheus text-format counters/gauges/histograms.

Mirror of common/lighthouse_metrics (global registry + start_timer/
stop_timer macros, src/lib.rs:1-40). Stdlib-only: the exposition format
is plain text.

Label families (`counter_vec`/`gauge_vec`/`histogram_vec`) support one or
more label dimensions; children resolve via `labels(*values)` or
`labels(**by_name)` and are exposed under one HELP/TYPE header with
escaped label values. Naming contract (the JAX package's
scripts/lint_metrics.py enforces it there): snake_case with a unit suffix — `_seconds`,
`_total`, `_bytes`, or a documented dimensionless unit (`_sets`,
`_depth`, `_live`).

A copy of ``lighthouse_tpu/common/metrics.py`` (:30-393): the port
imports nothing of the JAX package, and keeps its metric names, labels
and help strings so that one dashboard reads both. ``MetricsServer``,
the scrape endpoint, waits for the port's HTTP API.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

_DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
    2.5, 5.0, 10.0,
)


def escape_label_value(value: str) -> str:
    """Prometheus exposition-format label-value escaping (backslash,
    double-quote, line feed — in that order, per the spec)."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _label_str(names: Sequence[str], values: Sequence[str]) -> str:
    return ",".join(
        f'{n}="{escape_label_value(v)}"' for n, v in zip(names, values)
    )


class Counter:
    def __init__(self, name: str, help_text: str):
        self.name = name
        self.help = help_text
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def get(self) -> float:
        with self._lock:
            return self._value

    def expose(self) -> str:
        with self._lock:
            value = self._value
        return (f"# HELP {self.name} {self.help}\n"
                f"# TYPE {self.name} counter\n"
                f"{self.name} {value}\n")


class _Family:
    """Shared machinery for labeled metric families: one or more label
    dimensions, children created on first `labels(...)` use, all exposed
    under a single HELP/TYPE header. `labels` accepts positional values
    (in declaration order) or keywords naming every dimension."""

    kind = "untyped"

    def __init__(self, name: str, help_text: str,
                 label_names: Sequence[str]):
        self.name = name
        self.help = help_text
        self.label_names = tuple(label_names)
        self._children: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()

    def _child_factory(self, key: Tuple[str, ...]):
        raise NotImplementedError

    def _resolve_key(self, values, by_name) -> Tuple[str, ...]:
        if by_name:
            if values:
                raise TypeError("labels(): positional and keyword values "
                                "cannot be mixed")
            if set(by_name) != set(self.label_names):
                raise ValueError(
                    f"labels(**kw) must name exactly {self.label_names}, "
                    f"got {tuple(by_name)}")
            values = [by_name[n] for n in self.label_names]
        if len(values) != len(self.label_names):
            raise ValueError(
                f"{self.name} takes {len(self.label_names)} label "
                f"value(s) {self.label_names}, got {len(values)}")
        return tuple(str(v) for v in values)

    def labels(self, *values, **by_name):
        key = self._resolve_key(values, by_name)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._child_factory(key)
            return child

    def _snapshot(self):
        with self._lock:
            return sorted(self._children.items())

    def expose(self) -> str:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} {self.kind}"]
        for key, child in self._snapshot():
            out.extend(self._expose_child(key, child))
        return "\n".join(out) + "\n"

    def _expose_child(self, key, child) -> List[str]:
        raise NotImplementedError


class _Cell:
    """A locked float cell (counter/gauge child)."""

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def get(self) -> float:
        with self._lock:
            return self._value


class LabeledCounter(_Family):
    """A counter family (the lighthouse_metrics `int_counter_vec` analog).
    Single-label declarations keep the historical `label=` spelling;
    multi-label families pass `labels=("route", "reason")` and resolve
    children with `labels(**kw)`."""

    kind = "counter"

    def __init__(self, name: str, help_text: str, label: str = "label",
                 labels: Optional[Sequence[str]] = None):
        super().__init__(name, help_text, labels or (label,))
        self.label = self.label_names[0]

    def _child_factory(self, key):
        return _Cell()

    def get(self, *values, **by_name) -> float:
        key = self._resolve_key(values, by_name)
        with self._lock:
            child = self._children.get(key)
        return child.get() if child is not None else 0.0

    def _expose_child(self, key, child):
        return [f"{self.name}{{{_label_str(self.label_names, key)}}} "
                f"{child.get()}"]


class Gauge:
    def __init__(self, name: str, help_text: str):
        self.name = name
        self.help = help_text
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = value

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def get(self) -> float:
        with self._lock:
            return self._value

    def expose(self) -> str:
        with self._lock:
            value = self._value
        return (f"# HELP {self.name} {self.help}\n"
                f"# TYPE {self.name} gauge\n"
                f"{self.name} {value}\n")


class LabeledGauge(_Family):
    """A gauge family (per-queue depths, per-backend residency...)."""

    kind = "gauge"

    def __init__(self, name: str, help_text: str, label: str = "label",
                 labels: Optional[Sequence[str]] = None):
        super().__init__(name, help_text, labels or (label,))
        self.label = self.label_names[0]

    def _child_factory(self, key):
        return _Cell()

    def get(self, *values, **by_name) -> float:
        key = self._resolve_key(values, by_name)
        with self._lock:
            child = self._children.get(key)
        return child.get() if child is not None else 0.0

    def _expose_child(self, key, child):
        return [f"{self.name}{{{_label_str(self.label_names, key)}}} "
                f"{child.get()}"]


class Histogram:
    def __init__(self, name: str, help_text: str,
                 buckets: Tuple[float, ...] = _DEFAULT_BUCKETS):
        self.name = name
        self.help = help_text
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._total = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        with self._lock:
            self._sum += value
            self._total += 1
            for i, b in enumerate(self.buckets):
                if value <= b:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    def start_timer(self) -> "HistogramTimer":
        return HistogramTimer(self)

    def snapshot(self) -> Tuple[List[int], int, float]:
        """(per-bucket counts, total count, sum) — one consistent view."""
        with self._lock:
            return list(self._counts), self._total, self._sum

    def _sample_lines(self, label_prefix: str = "") -> List[str]:
        counts, total, sum_ = self.snapshot()
        sep = "," if label_prefix else ""
        out = []
        cumulative = 0
        for b, c in zip(self.buckets, counts):
            cumulative += c
            out.append(f'{self.name}_bucket{{{label_prefix}{sep}le="{b}"}} '
                       f'{cumulative}')
        cumulative += counts[-1]
        out.append(f'{self.name}_bucket{{{label_prefix}{sep}le="+Inf"}} '
                   f'{cumulative}')
        suffix = f"{{{label_prefix}}}" if label_prefix else ""
        out.append(f"{self.name}_sum{suffix} {sum_}")
        out.append(f"{self.name}_count{suffix} {total}")
        return out

    def expose(self) -> str:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} histogram"]
        out.extend(self._sample_lines())
        return "\n".join(out) + "\n"


class LabeledHistogram(_Family):
    """A histogram family: per-label-set bucket/sum/count series under
    one header (the stage-timer `engine_stage_seconds{engine=,stage=}`
    shape). Children are full Histograms sharing the family buckets."""

    kind = "histogram"

    def __init__(self, name: str, help_text: str,
                 labels: Sequence[str] = ("label",),
                 buckets: Tuple[float, ...] = _DEFAULT_BUCKETS):
        super().__init__(name, help_text, labels)
        self.buckets = tuple(sorted(buckets))

    def _child_factory(self, key):
        return Histogram(self.name, self.help, self.buckets)

    def get_count(self, *values, **by_name) -> int:
        key = self._resolve_key(values, by_name)
        with self._lock:
            child = self._children.get(key)
        return child.snapshot()[1] if child is not None else 0

    def _expose_child(self, key, child):
        return child._sample_lines(_label_str(self.label_names, key))


class HistogramTimer:
    def __init__(self, histogram: Histogram):
        self.histogram = histogram
        self.start = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self.start
        self.histogram.observe(dt)
        return dt

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


class Registry:
    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help_text: str = "") -> Counter:
        return self._get_or_make(name, lambda: Counter(name, help_text))

    def counter_vec(self, name: str, help_text: str = "",
                    label: str = "label",
                    labels: Optional[Sequence[str]] = None) -> LabeledCounter:
        return self._get_or_make(
            name, lambda: LabeledCounter(name, help_text, label, labels)
        )

    def gauge(self, name: str, help_text: str = "") -> Gauge:
        return self._get_or_make(name, lambda: Gauge(name, help_text))

    def gauge_vec(self, name: str, help_text: str = "",
                  label: str = "label",
                  labels: Optional[Sequence[str]] = None) -> LabeledGauge:
        return self._get_or_make(
            name, lambda: LabeledGauge(name, help_text, label, labels)
        )

    def histogram(self, name: str, help_text: str = "",
                  buckets: Tuple[float, ...] = _DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_make(
            name, lambda: Histogram(name, help_text, buckets)
        )

    def histogram_vec(self, name: str, help_text: str = "",
                      labels: Sequence[str] = ("label",),
                      buckets: Tuple[float, ...] = _DEFAULT_BUCKETS,
                      ) -> LabeledHistogram:
        return self._get_or_make(
            name, lambda: LabeledHistogram(name, help_text, labels, buckets)
        )

    def _get_or_make(self, name, factory):
        with self._lock:
            if name not in self._metrics:
                self._metrics[name] = factory()
            return self._metrics[name]

    def gather(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        return "".join(m.expose() for m in metrics)

    def families(self) -> Dict[str, object]:
        """Snapshot of name -> metric object (for programmatic readers
        like observability/timeseries; later registrations don't appear)."""
        with self._lock:
            return dict(self._metrics)

    def __len__(self) -> int:
        with self._lock:
            return len(self._metrics)

    # An empty registry must stay truthy: the codebase-wide
    # `registry or REGISTRY` default idiom would otherwise silently
    # swap a fresh, still-empty registry for the global one.
    def __bool__(self) -> bool:
        return True


# The global registry (lighthouse_metrics' lazy_static DEFAULT_REGISTRY).
REGISTRY = Registry()
