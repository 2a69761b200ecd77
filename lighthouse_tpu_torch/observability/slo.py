"""Declarative SLO engine over the metric time-series.

Lighthouse treats telemetry as a control surface — peer scores gate
real GRAFT/PRUNE decisions — and this module does the same for serving:
an `Objective` declares what "healthy" means as a predicate over a
`timeseries.TimeSeries` window, and `SloEngine.evaluate()` answers
met / breached / no-evidence per objective, exporting
`slo_status{objective}` (1 met, 0 breached; unset until first evidence)
and `slo_breaches_total{objective}`.

Three objective kinds cover the stock serving SLOs:

  * `ratio_min`    — good/(good+bad) >= target over the window
                     (deadline-hit rate from the hit/miss counters).
  * `quantile_max` — histogram quantile <= target over the window
                     (p50 batch latency).
  * `rate_max`     — counter increase per second <= target
                     (route-fallback rate).

An objective with fewer than `min_events` supporting observations in
the window answers None — no gauge write, no breach count. Policies
must not act (and alerts must not fire) on an empty window.

A copy of ``lighthouse_tpu/observability/slo.py`` on the port's metrics,
tracer and time-series. The port's router registers no
``serving_router_fallback_total`` (a device failure propagates, it is not
retried on the CPU), so ``route_fallback_rate`` answers None there: no
evidence, no judgement.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

from ..common import metrics as m
from . import trace
from .timeseries import TimeSeries

KINDS = ("ratio_min", "quantile_max", "rate_max")


@dataclass(frozen=True)
class Objective:
    """One declarative objective. `metric` is the primary family
    (good-counter for ratio_min, histogram for quantile_max, counter for
    rate_max); `bad_metric` is the ratio's complement. Label values
    address one child of a labeled family."""

    name: str
    kind: str
    target: float
    metric: str
    bad_metric: Optional[str] = None
    labels: Tuple[str, ...] = ()
    bad_labels: Tuple[str, ...] = ()
    q: float = 0.5           # quantile_max only
    min_events: int = 1      # observations required before judging

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown SLO kind {self.kind!r} "
                             f"(one of {KINDS})")
        if self.kind == "ratio_min" and self.bad_metric is None:
            raise ValueError(f"{self.name}: ratio_min needs bad_metric")


def serving_objectives(deadline_hit_rate: float = 0.95,
                       p50_batch_latency_s: float = 0.5,
                       fallback_per_s: float = 0.1,
                       min_events: int = 4) -> Tuple[Objective, ...]:
    """The stock serving SLOs: deadline hit rate, p50 batch latency and
    route-fallback rate."""
    return (
        Objective("deadline_hit_rate", "ratio_min", deadline_hit_rate,
                  "serving_scheduler_deadline_hits_total",
                  bad_metric="serving_scheduler_deadline_misses_total",
                  min_events=min_events),
        Objective("batch_latency_p50", "quantile_max", p50_batch_latency_s,
                  "serving_scheduler_batch_seconds", q=0.5,
                  min_events=min_events),
        Objective("route_fallback_rate", "rate_max", fallback_per_s,
                  "serving_router_fallback_total", labels=("retried",),
                  min_events=1),
    )


@dataclass
class Evaluation:
    met: Optional[bool]       # None = not enough evidence
    measured: Optional[float]
    target: float
    kind: str

    def as_dict(self) -> dict:
        return {"met": self.met, "measured": self.measured,
                "target": self.target, "kind": self.kind}


class SloEngine:
    def __init__(self, timeseries: TimeSeries,
                 objectives: Sequence[Objective] = (),
                 window_s: float = 30.0,
                 registry: Optional[m.Registry] = None):
        self.ts = timeseries
        self.objectives = tuple(objectives) or serving_objectives()
        self.window_s = window_s
        reg = registry or m.REGISTRY
        self._status = reg.gauge_vec(
            "slo_status",
            "Objective status over the evaluation window (1 met, 0 "
            "breached; absent until the window holds evidence)",
            "objective")
        self._breaches = reg.counter_vec(
            "slo_breaches_total",
            "Evaluations that found the objective breached", "objective")
        self.last: Dict[str, Evaluation] = {}

    # ------------------------------------------------------------ measuring

    def _measure(self, obj: Objective,
                 now: Optional[float]) -> Tuple[Optional[float], float]:
        """(measured value, supporting event count) for one objective."""
        w = self.window_s
        if obj.kind == "ratio_min":
            good = self.ts.delta(obj.metric, w, obj.labels, now)
            bad = self.ts.delta(obj.bad_metric, w, obj.bad_labels, now)
            if good is None and bad is None:
                return None, 0.0
            good, bad = good or 0.0, bad or 0.0
            n = good + bad
            return (good / n if n > 0 else None), n
        if obj.kind == "quantile_max":
            hd = self.ts.hist_delta(obj.metric, w, obj.labels, now)
            n = hd[0] if hd else 0.0
            return self.ts.quantile(obj.metric, obj.q, w, obj.labels,
                                    now), n
        # rate_max
        r = self.ts.rate(obj.metric, w, obj.labels, now)
        d = self.ts.delta(obj.metric, w, obj.labels, now)
        # A rate of zero is evidence (the counter exists and didn't
        # move), so the event floor counts samples, not increments.
        return r, (1.0 if r is not None else 0.0) + (d or 0.0)

    @staticmethod
    def _met(kind: str, measured: float, target: float) -> bool:
        if kind == "ratio_min":
            return measured >= target
        return measured <= target  # quantile_max / rate_max

    # ----------------------------------------------------------- evaluating

    def evaluate(self, now: Optional[float] = None) -> Dict[str, Evaluation]:
        """Judge every objective against the current window. Does NOT
        sample the time-series — the control loop owns the cadence."""
        out: Dict[str, Evaluation] = {}
        for obj in self.objectives:
            measured, n = self._measure(obj, now)
            if measured is None or n < obj.min_events:
                out[obj.name] = Evaluation(None, measured, obj.target,
                                           obj.kind)
                continue
            met = self._met(obj.kind, measured, obj.target)
            self._status.labels(obj.name).set(1.0 if met else 0.0)
            if not met:
                self._breaches.labels(obj.name).inc()
                trace.instant(f"slo:breach:{obj.name}", cat="autotune",
                              measured=round(measured, 6),
                              target=obj.target)
            out[obj.name] = Evaluation(met, measured, obj.target, obj.kind)
        self.last = out
        return out

    def snapshot(self) -> Dict[str, dict]:
        """Report payload: the latest evaluation per objective."""
        return {name: ev.as_dict() for name, ev in self.last.items()}
