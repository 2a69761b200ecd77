"""Cost-model backend router: heterogeneous CPU-native / device serving.

The reference keeps blst on the host next to every hot path; this stack
has two real verifiers — the native C++ batch verifier (~ms/set, zero
dispatch latency) and the device engine (huge throughput, fixed dispatch
+ bucket-padding cost) — already sharing one registry seam
(`crypto/bls/api.register_backend`). The router owns the choice per
batch, from a measured-latency table instead of a hard-coded size
threshold:

  * small batches never pay device dispatch (the old
    JAX backend's LIGHTHOUSE_TPU_CPU_FALLBACK_MAX heuristic, now one rule
    of several);
  * deadline-critical batches route to whichever backend the table
    predicts will finish inside the remaining slot-third budget;
  * otherwise the predicted-cheaper backend wins, device on ties/unknown
    (bulk traffic rides the card).

The table seeds from warming runs (`LatencyTable.seed`) and keeps
learning online: every routed verification feeds its measured wall time
back in (EWMA). Per-route decisions and latencies export through
`common/metrics` (`serving_router_*`).

The port's router (counterpart: ``lighthouse_tpu/serving/router.py``
:35-229) has the same rules, thresholds, table and metrics, with the card
(backend ``gpu``) as its device route. It does not retry a failed device
batch on the CPU (JAX :196-216): a device-route exception propagates, so
that a kernel that fails to launch is seen, not hidden by the other route
(and ``serving_router_fallback_total`` is not registered). Its
``sharded`` and ``mesh`` go to the device route's backend
(``ops/backend.resolve_mesh``), so that a scheduler over this router
verifies its batches over a mesh.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

from ..common import metrics as m
from ..crypto.bls import api
from ..observability import trace


def _next_pow2(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


class LatencyTable:
    """Measured per-(route, n_bucket) verification latency, EWMA-updated.

    `predict` answers for any bucket: exact entry when present, otherwise
    the nearest known bucket (log2 distance) scaled linearly by the size
    ratio for the cpu route (native verification is ~linear in sets) and
    taken as-is for the device route (bucket latency is capture-amortized
    and far sublinear — the pairing stage rides distinct messages, not
    n). Returns None with no data at all for the route."""

    def __init__(self, alpha: float = 0.25):
        self.alpha = alpha
        self._t: Dict[Tuple[str, int], float] = {}
        self._lock = threading.Lock()

    def seed(self, route: str, n_bucket: int, secs: float) -> None:
        """Install a measurement only if none exists (warming runs seed;
        live traffic overrides)."""
        with self._lock:
            self._t.setdefault((route, n_bucket), float(secs))

    def observe(self, route: str, n_bucket: int, secs: float) -> None:
        with self._lock:
            key = (route, n_bucket)
            prev = self._t.get(key)
            self._t[key] = float(secs) if prev is None else \
                (1 - self.alpha) * prev + self.alpha * float(secs)

    def predict(self, route: str, n_bucket: int) -> Optional[float]:
        with self._lock:
            exact = self._t.get((route, n_bucket))
            if exact is not None:
                return exact
            known = [(b, s) for (r, b), s in self._t.items() if r == route]
        if not known:
            return None
        b, s = min(known, key=lambda kv:
                   abs(math.log2(max(kv[0], 1)) - math.log2(max(n_bucket, 1))))
        if route == "cpu":
            return s * n_bucket / max(b, 1)
        return s

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {f"{r}:{b}": round(s, 6) for (r, b), s in self._t.items()}


class CostModelRouter:
    """Route one batch to the native CPU backend or the device engine and
    run it through the registry seam (`api.verify_signature_sets`).

    Decision order (first match wins; the reason is counted in
    `serving_router_route_total{route}` / `..._reason_total{reason}`):
      1. `small`     — len(sets) <= small_batch_max: cpu.
      2. `deadline`  — a budget is given, the device prediction blows it,
                       and the cpu prediction fits: cpu.
      3. `cost`      — both routes predicted: the cheaper one.
      4. `default`   — device (bulk traffic rides the card).
    """

    def __init__(self, table: Optional[LatencyTable] = None,
                 cpu_backend: str = "cpu", device_backend: str = "gpu",
                 small_batch_max: int = 16, margin_s: float = 0.02,
                 registry: Optional[m.Registry] = None,
                 sharded: Optional[bool] = None, mesh=None):
        self.table = table or LatencyTable()
        self.cpu_backend = cpu_backend
        self.device_backend = device_backend
        # Passed to the device route's backend ("gpu": ops/backend.py
        # resolve_mesh); None and None leave it the backend's defaults.
        self.device_options = {k: v for k, v in (("sharded", sharded), ("mesh", mesh))
                               if v is not None}
        self.small_batch_max = small_batch_max
        self.margin_s = margin_s
        reg = registry or m.REGISTRY
        self._routes = reg.counter_vec(
            "serving_router_route_total",
            "Batches routed, by route (cpu|device)", "route")
        self._reasons = reg.counter_vec(
            "serving_router_reason_total",
            "Routing decisions, by rule (small|deadline|cost|default)",
            "reason")
        self._latency = {
            route: reg.histogram(
                f"serving_router_{route}_verify_seconds",
                f"Measured {route}-route batch verification latency")
            for route in ("cpu", "device")
        }
        self._restored = reg.counter(
            "serving_router_table_restored_total",
            "EWMA latency-table entries restored from a persisted "
            "autotune policy at startup")

    # ------------------------------------------------------------ restore

    def restore_table(self, entries) -> int:
        """Seed the latency table from a persisted policy's
        `table.snapshot()` dict (`"route:bucket" -> seconds`). Seeds only
        — live EWMA traffic still overrides them. Returns the number of
        entries installed (malformed keys/values are skipped, not fatal:
        a half-readable policy is still better than a cold table)."""
        installed = 0
        for key, secs in (entries or {}).items():
            try:
                route, bucket = str(key).rsplit(":", 1)
                secs = float(secs)
                bucket = int(bucket)
            except (ValueError, TypeError):
                continue
            if route not in ("cpu", "device") or bucket < 1 or secs < 0:
                continue
            self.table.seed(route, bucket, secs)
            installed += 1
        if installed:
            self._restored.inc(installed)
        return installed

    # -------------------------------------------------------------- routing

    def backend_name(self, route: str) -> str:
        return self.cpu_backend if route == "cpu" else self.device_backend

    def _options(self, route: str) -> dict:
        return self.device_options if route == "device" else {}

    def route(self, n_sets: int,
              deadline_budget: Optional[float] = None) -> Tuple[str, str]:
        """(route, reason) for a batch of `n_sets`."""
        bucket = _next_pow2(max(1, n_sets))
        if n_sets <= self.small_batch_max:
            return "cpu", "small"
        pd = self.table.predict("device", bucket)
        pc = self.table.predict("cpu", bucket)
        if (deadline_budget is not None and pd is not None
                and pd + self.margin_s > deadline_budget
                and pc is not None
                and pc + self.margin_s <= deadline_budget):
            return "cpu", "deadline"
        if pd is not None and pc is not None:
            return ("cpu", "cost") if pc < pd else ("device", "cost")
        return "device", "default"

    def verify(self, sets: Sequence,
               deadline_budget: Optional[float] = None) -> Tuple[bool, str]:
        """Route + verify one batch; returns (ok, route). Feeds the
        measured latency back into the table and the route metrics. An
        exception on either route propagates."""
        route, reason = self.route(len(sets), deadline_budget)
        self._routes.labels(route).inc()
        self._reasons.labels(reason).inc()
        trace.instant("router:decision", cat="lifecycle", route=route,
                      reason=reason, n_sets=len(sets))
        bucket = _next_pow2(max(1, len(sets)))
        t0 = time.perf_counter()
        with trace.span("router:verify", cat="lifecycle",
                        route=route, n_sets=len(sets)):
            ok = bool(api.verify_signature_sets(
                sets, backend=self.backend_name(route), **self._options(route)))
        dt = time.perf_counter() - t0
        self.table.observe(route, bucket, dt)
        self._latency[route].observe(dt)
        return ok, route

    def find_invalid(self, sets: Sequence, route: str) -> list:
        """Poisoned-batch isolation on the same route that failed (keeps
        the bisection halves on already-captured buckets for the device
        route; the native route has no shape cost either way)."""
        return api.find_invalid_sets(sets, backend=self.backend_name(route),
                                     **self._options(route))
