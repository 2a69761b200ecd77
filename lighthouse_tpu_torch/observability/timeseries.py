"""In-process metric time-series: ring-buffered registry snapshots.

The serving path makes every tuning input live — stage timers, route
latencies, the deadline-margin and accumulation histograms — but a
registry answers only "what is the value NOW". Policies (the SLO engine, the serving
autotuner) need *trends*: a deadline-hit RATE over the last window, the
p50 of a histogram's recent observations, whether a gauge is rising.
This module is that layer, deliberately tiny: `TimeSeries.sample()`
snapshots every family registered in a `common/metrics.Registry` into a
bounded ring buffer, and the query helpers answer windowed questions by
differencing two snapshots — no background thread, no storage, no new
dependency. Whoever owns the control loop owns the sampling cadence.

Windowed semantics (all windows in seconds, measured on the sampler's
own clock so manual-clock tests stay deterministic):

  * `delta(name, window)`   — counter increase across the window.
  * `rate(name, window)`    — `delta / elapsed` (per-second).
  * `value(name)`           — the latest snapshot's instant value.
  * `quantile(name, q, window)` — histogram quantile estimated from the
    per-bucket count deltas across the window, with the standard
    Prometheus-style linear interpolation inside the landing bucket.
    Works on negative-bucketed histograms (the deadline-margin family):
    the first bucket has no lower edge, so it answers its upper bound.
  * `hist_delta(name, window)` — (observations, sum) across the window.

Labeled families address one child with `labels=(v1, ...)` (declaration
order); `labels=None` sums counter children (the "all routes" view).
Every query returns None rather than raising when the window holds too
little data — a policy must treat "no evidence" as "no decision".

A copy of ``lighthouse_tpu/observability/timeseries.py`` on the port's
``common/metrics.py``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..common import metrics as m

# A series key: (family name, child label values) — () for plain metrics.
_Key = Tuple[str, Tuple[str, ...]]


def _hist_quantile(bounds: Sequence[float], counts: Sequence[float],
                   q: float) -> Optional[float]:
    """Prometheus-style quantile from per-bucket (non-cumulative) counts.
    `bounds` are the finite upper edges; `counts` has one extra trailing
    entry for the +Inf overflow bucket. The first bucket reports its
    upper edge (no lower edge exists — bounds may be negative, so 0 is
    not a valid floor); the overflow bucket reports the last finite
    edge, the same clamp promql applies."""
    total = sum(counts)
    if total <= 0:
        return None
    rank = q * total
    cum = 0.0
    for i, b in enumerate(bounds):
        prev = cum
        cum += counts[i]
        if cum >= rank and counts[i] > 0:
            if i == 0:
                return float(b)
            lo = bounds[i - 1]
            frac = (rank - prev) / counts[i]
            return float(lo + (b - lo) * frac)
    return float(bounds[-1])  # landed in the +Inf bucket


class TimeSeries:
    """Ring buffer of registry snapshots + windowed queries. Thread-safe;
    `sample()` is cheap enough to call every control-loop tick (it copies
    floats and small count lists, never metric objects)."""

    def __init__(self, registry: Optional[m.Registry] = None,
                 capacity: int = 512, clock=time.monotonic):
        self.registry = registry or m.REGISTRY
        self.clock = clock
        # Each entry: (t, scalars: {key: float},
        #              hists: {key: (bounds, counts, total, sum)})
        self._samples: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()

    # ------------------------------------------------------------- sampling

    def sample(self, now: Optional[float] = None) -> int:
        """Snapshot every family in the registry; returns the number of
        series captured."""
        t = self.clock() if now is None else float(now)
        scalars: Dict[_Key, float] = {}
        hists: Dict[_Key, Tuple] = {}
        for name, fam in self.registry.families().items():
            if isinstance(fam, (m.Counter, m.Gauge)):
                scalars[(name, ())] = fam.get()
            elif isinstance(fam, (m.LabeledCounter, m.LabeledGauge)):
                for key, child in fam._snapshot():
                    scalars[(name, key)] = child.get()
            elif isinstance(fam, m.Histogram):
                counts, total, sum_ = fam.snapshot()
                hists[(name, ())] = (fam.buckets, counts, total, sum_)
            elif isinstance(fam, m.LabeledHistogram):
                for key, child in fam._snapshot():
                    counts, total, sum_ = child.snapshot()
                    hists[(name, key)] = (fam.buckets, counts, total, sum_)
        with self._lock:
            self._samples.append((t, scalars, hists))
        return len(scalars) + len(hists)

    def __len__(self) -> int:
        with self._lock:
            return len(self._samples)

    def __bool__(self) -> bool:
        # An empty TimeSeries must still be truthy, or `passed_ts or
        # TimeSeries()` defaults would silently orphan the caller's
        # buffer before its first sample (same trap Registry guards).
        return True

    # -------------------------------------------------------------- windows

    def _bracket(self, window_s: Optional[float],
                 now: Optional[float] = None):
        """(old, new) samples bracketing the window: `new` is the latest
        snapshot, `old` the newest snapshot at or before `new.t -
        window_s` (falling back to the oldest held). None without two
        distinct snapshots. `window_s=None` means 'since the first
        snapshot' (the whole buffer)."""
        with self._lock:
            if len(self._samples) < 2:
                return None
            samples = list(self._samples)
        new = samples[-1]
        if window_s is None:
            return samples[0], new
        t_cut = (new[0] if now is None else float(now)) - float(window_s)
        old = samples[0]
        for s in samples[:-1]:
            if s[0] <= t_cut:
                old = s
            else:
                break
        if old[0] >= new[0]:
            return None
        return old, new

    @staticmethod
    def _scalar(sample, name: str,
                labels: Optional[Sequence[str]]) -> Optional[float]:
        _, scalars, _hists = sample
        if labels is None:
            vals = [v for (n, _k), v in scalars.items() if n == name]
            return sum(vals) if vals else None
        return scalars.get((name, tuple(str(v) for v in labels)))

    # -------------------------------------------------------------- queries

    def value(self, name: str,
              labels: Optional[Sequence[str]] = ()) -> Optional[float]:
        with self._lock:
            if not self._samples:
                return None
            latest = self._samples[-1]
        return self._scalar(latest, name, labels)

    def delta(self, name: str, window_s: Optional[float],
              labels: Optional[Sequence[str]] = (),
              now: Optional[float] = None) -> Optional[float]:
        br = self._bracket(window_s, now)
        if br is None:
            return None
        old, new = br
        v0 = self._scalar(old, name, labels)
        v1 = self._scalar(new, name, labels)
        if v1 is None:
            return None
        return v1 - (v0 or 0.0)  # series born mid-window started at 0

    def rate(self, name: str, window_s: Optional[float],
             labels: Optional[Sequence[str]] = (),
             now: Optional[float] = None) -> Optional[float]:
        br = self._bracket(window_s, now)
        if br is None:
            return None
        d = self.delta(name, window_s, labels, now)
        if d is None:
            return None
        elapsed = br[1][0] - br[0][0]
        return d / elapsed if elapsed > 0 else None

    def _hist_window(self, name: str, window_s: Optional[float],
                     labels: Sequence[str] = (),
                     now: Optional[float] = None):
        """(bounds, per-bucket count deltas, n, sum delta) or None."""
        br = self._bracket(window_s, now)
        if br is None:
            return None
        key = (name, tuple(str(v) for v in labels))
        new = br[1][2].get(key)
        if new is None:
            return None
        bounds, counts1, total1, sum1 = new
        old = br[0][2].get(key)
        if old is None:  # series born mid-window: delta from zero
            counts0: List[float] = [0] * len(counts1)
            total0, sum0 = 0, 0.0
        else:
            _, counts0, total0, sum0 = old
        d = [c1 - c0 for c1, c0 in zip(counts1, counts0)]
        return bounds, d, total1 - total0, sum1 - sum0

    def quantile(self, name: str, q: float,
                 window_s: Optional[float] = None,
                 labels: Sequence[str] = (),
                 now: Optional[float] = None) -> Optional[float]:
        hw = self._hist_window(name, window_s, labels, now)
        if hw is None:
            return None
        bounds, deltas, _n, _s = hw
        return _hist_quantile(bounds, deltas, q)

    def hist_delta(self, name: str, window_s: Optional[float] = None,
                   labels: Sequence[str] = (),
                   now: Optional[float] = None
                   ) -> Optional[Tuple[float, float]]:
        hw = self._hist_window(name, window_s, labels, now)
        if hw is None:
            return None
        _bounds, _deltas, n, s = hw
        return n, s

    def mean(self, name: str, window_s: Optional[float] = None,
             labels: Sequence[str] = (),
             now: Optional[float] = None) -> Optional[float]:
        hd = self.hist_delta(name, window_s, labels, now)
        if hd is None or hd[0] <= 0:
            return None
        return hd[1] / hd[0]

    # -------------------------------------------------------------- export

    def describe(self) -> Dict[str, Any]:
        """Debug/report payload: sample count, span, series count."""
        with self._lock:
            samples = list(self._samples)
        if not samples:
            return {"samples": 0}
        return {
            "samples": len(samples),
            "span_seconds": round(samples[-1][0] - samples[0][0], 3),
            "series": len(samples[-1][1]) + len(samples[-1][2]),
        }
