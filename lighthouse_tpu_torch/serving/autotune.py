"""Online serving autotuner: metrics in, policy out, decisions audited.

Every serving knob was hand-picked offline — the warming grid and bucket
menu, the router's CPU/device cutoff, the scheduler's accumulation
margin — while the serving path makes every input those knobs need
live. This module closes the loop: an `Autotuner` samples
the metric time-series (`observability/timeseries.py`), judges the
serving SLOs (`observability/slo.py`), and re-picks the knobs from the
windowed evidence:

  * **accumulation window** (`scheduler.close_margin_s`) — widened when
    deadline misses appear or the windowed p50 deadline margin goes
    negative (batches must close earlier, buying headroom against the
    measured compile+execute latency), narrowed when the hit rate holds
    and the margin shows large surplus (batches may accumulate longer).
  * **router cutoff** (`router.small_batch_max`) — re-pinned to the
    measured CPU/device crossover bucket from the router's own EWMA
    latency table (the largest power-of-two bucket where the CPU route
    still predicts cheaper than device dispatch).
  * **bucket menu + warming grid** (`AdaptiveBatchPolicy.max_bucket`,
    `beacon_processor/warming.py` shape grid, `M_BUCKET_SHIFTS`
    m-menu) — re-picked from the windowed batch-size and
    distinct-message histograms, so the warmer spends its compile
    budget on the shapes traffic actually produces.

Every decision is emitted as a `cat:"autotune"` trace span carrying the
knob's before/after values plus the triggering evidence, and counted in
`serving_autotune_decisions_total{knob}` — the policy is auditable from
the trace alone.

The learned policy persists into the warm-bundle manifest
(`aot.save_policy` / `aot.load_policy`): a restarted node calls
`apply_policy()` and inherits the tuned menu, router table (seeded —
live EWMA keeps overriding), and scheduler margins instead of defaults,
and warms `warming.tuned_shape_grid(policy)`.

Kill switch: `LIGHTHOUSE_TPU_AUTOTUNE=0` makes `step()` and
`apply_policy()` no-ops — static behavior is bit-identical to a build
without this module.

A copy of ``lighthouse_tpu/serving/autotune.py`` on the port's metrics,
tracer, time-series, SLO engine and policy manifest, with the same
decisions on the same evidence. It reads the live ``M_BUCKET_SHIFTS`` and
``max_n_bucket()`` from ``lighthouse_tpu_torch.ops.backend`` when that
module is loaded (and never imports it), and caps the bucket menu at
``max_n_bucket()``, 4096: the largest bucket the port serves.
"""

from __future__ import annotations

import math
import os
import sys
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from ..common import metrics as m
from ..observability import trace
from ..observability.slo import SloEngine
from ..observability.timeseries import TimeSeries

from .router import _next_pow2

ENV_VAR = "LIGHTHOUSE_TPU_AUTOTUNE"
POLICY_VERSION = 1

# Fallback m-bucket menu shifts and bucket ceiling; the live values are
# read from ops.backend when it is loaded (importing it pulls the device
# stack, which the control plane must not require just to construct).
_DEFAULT_M_SHIFTS = (8, 6, 4, 2, 0)
_DEFAULT_MAX_N_BUCKET = 4096
_BACKEND = "lighthouse_tpu_torch.ops.backend"


def enabled_from_env(default: bool = True) -> bool:
    val = os.environ.get(ENV_VAR)
    if val is None:
        return default
    return val.strip().lower() not in ("0", "false", "off", "")


def _m_bucket_shifts() -> Tuple[int, ...]:
    # Read the live constant only if the device backend is already in
    # the process (never import it: constructing an Autotuner must not
    # pull the device stack into a CPU-only control plane).
    mod = sys.modules.get(_BACKEND)
    if mod is not None:
        return tuple(mod.M_BUCKET_SHIFTS)
    return _DEFAULT_M_SHIFTS


def _max_n_bucket() -> int:
    """The largest bucket the port serves (ops.backend.max_n_bucket)."""
    mod = sys.modules.get(_BACKEND)
    return mod.max_n_bucket() if mod is not None else _DEFAULT_MAX_N_BUCKET


@dataclass
class Decision:
    """One applied knob change (mirrored into the autotune trace)."""

    knob: str
    before: object
    after: object
    reason: str

    def as_dict(self) -> dict:
        return {"knob": self.knob, "before": self.before,
                "after": self.after, "reason": self.reason}


class Autotuner:
    """See module docstring. Construct once around a serving stack
    (scheduler + router + batch policy); drive `step()` from whatever
    owns the control cadence (a slot-tick, a probe loop, a daemon)."""

    def __init__(self, scheduler=None, router=None, batch_policy=None,
                 timeseries: Optional[TimeSeries] = None,
                 slo: Optional[SloEngine] = None,
                 window_s: float = 30.0,
                 hit_rate_target: float = 0.98,
                 widen_factor: float = 1.6,
                 narrow_factor: float = 0.75,
                 margin_bounds: Tuple[float, float] = (0.01, 1.0),
                 surplus_ratio: float = 8.0,
                 cutoff_bounds: Tuple[int, int] = (1, 256),
                 grid_ks: Sequence[int] = (1, 4),
                 min_batches: int = 4,
                 registry: Optional[m.Registry] = None,
                 enabled: Optional[bool] = None):
        self.scheduler = scheduler
        self.router = router or (scheduler.router if scheduler else None)
        self.batch_policy = batch_policy
        reg = registry or m.REGISTRY
        self.ts = timeseries if timeseries is not None else TimeSeries(reg)
        self.slo = slo
        self.window_s = window_s
        self.hit_rate_target = hit_rate_target
        self.widen_factor = widen_factor
        self.narrow_factor = narrow_factor
        self.margin_bounds = margin_bounds
        self.surplus_ratio = surplus_ratio
        self.cutoff_bounds = cutoff_bounds
        self.grid_ks = tuple(grid_ks)
        self.min_batches = min_batches
        self.enabled = (enabled_from_env(True) if enabled is None
                        else bool(enabled))
        self.decisions: List[Decision] = []
        self._warm_grid: List[Tuple[int, int]] = []
        self._m_shifts: Tuple[int, ...] = _m_bucket_shifts()
        self._menu_ceiling: Optional[int] = None
        self._m_decisions = reg.counter_vec(
            "serving_autotune_decisions_total",
            "Applied autotune knob changes (close_margin|router_cutoff|"
            "bucket_menu|warm_grid|m_menu)", "knob")
        self._g_margin = reg.gauge(
            "serving_autotune_close_margin_seconds",
            "Current autotuned scheduler accumulation-close margin")
        self._g_cutoff = reg.gauge(
            "serving_autotune_small_batch_max_sets",
            "Current autotuned router small-batch CPU cutoff")

    # ------------------------------------------------------------ plumbing

    def _apply(self, knob: str, before, after, reason: str,
               fn) -> List[Decision]:
        with trace.span(f"autotune:{knob}", cat="autotune", knob=knob,
                        before=before, after=after, reason=reason):
            fn()
        self._m_decisions.labels(knob).inc()
        d = Decision(knob, before, after, reason)
        self.decisions.append(d)
        return [d]

    # ---------------------------------------------------------------- rules

    def _tune_close_margin(self, now) -> List[Decision]:
        sched = self.scheduler
        if sched is None:
            return []
        w = self.window_s
        hits = self.ts.delta(
            "serving_scheduler_deadline_hits_total", w, now=now)
        misses = self.ts.delta(
            "serving_scheduler_deadline_misses_total", w, now=now)
        if hits is None and misses is None:
            return []
        hits, misses = hits or 0.0, misses or 0.0
        n = hits + misses
        if n < self.min_batches:
            return []
        hit_ratio = hits / n
        margin_p50 = self.ts.quantile(
            "serving_deadline_margin_seconds", 0.5, w, now=now)
        cur = sched.close_margin_s
        lo, hi = self.margin_bounds
        if hit_ratio < self.hit_rate_target or (
                margin_p50 is not None and margin_p50 < 0):
            new = min(cur * self.widen_factor, hi)
            reason = (f"hit_ratio={hit_ratio:.3f}<"
                      f"{self.hit_rate_target}" if hit_ratio <
                      self.hit_rate_target else
                      f"margin_p50={margin_p50:.3f}<0")
        elif (margin_p50 is not None
              and margin_p50 > self.surplus_ratio * cur):
            new = max(cur * self.narrow_factor, lo)
            reason = f"surplus margin_p50={margin_p50:.3f}"
        else:
            return []
        if abs(new - cur) < 1e-9:
            return []

        def apply():
            sched.close_margin_s = new
            self._g_margin.set(new)

        return self._apply("close_margin", round(cur, 4), round(new, 4),
                           reason, apply)

    def _tune_router_cutoff(self) -> List[Decision]:
        router = self.router
        if router is None:
            return []
        table = router.table
        routes = {key.split(":", 1)[0] for key in table.snapshot()}
        if not {"cpu", "device"} <= routes:
            return []  # crossover needs evidence from BOTH routes
        lo, hi = self.cutoff_bounds
        crossover = 0
        b = 1
        while b <= hi:
            pc = table.predict("cpu", b)
            pd = table.predict("device", b)
            if pc is None or pd is None:
                break
            if pc > pd:
                break  # cpu lost; past the crossover
            crossover = b
            b *= 2
        new = max(lo, min(crossover, hi))
        cur = router.small_batch_max
        if new == cur:
            return []

        def apply():
            router.small_batch_max = new
            self._g_cutoff.set(new)

        return self._apply("router_cutoff", cur, new,
                           f"cpu/device crossover at {crossover}", apply)

    def _tune_bucket_menu(self, now) -> List[Decision]:
        policy = self.batch_policy
        if policy is None:
            return []
        w = self.window_s
        hd = self.ts.hist_delta("serving_scheduler_batch_size_sets", w,
                                now=now)
        if hd is None or hd[0] < self.min_batches:
            return []
        p50 = self.ts.quantile("serving_scheduler_batch_size_sets", 0.5,
                               w, now=now)
        p99 = self.ts.quantile("serving_scheduler_batch_size_sets", 0.99,
                               w, now=now)
        if p50 is None or p99 is None:
            return []
        if self._menu_ceiling is None:
            # Never outgrow the policy's menu or the port's largest bucket.
            self._menu_ceiling = min(policy.max_bucket, _max_n_bucket())
        out: List[Decision] = []

        top = min(_next_pow2(max(2, math.ceil(p99))), self._menu_ceiling)
        cur_top = policy.max_bucket
        if top != cur_top:
            out += self._apply(
                "bucket_menu", cur_top, top,
                f"batch_size p99={p99:.0f}",
                lambda: policy.set_max_bucket(top))

        # Warming grid: every pow2 rung from the p50 bucket up to the
        # menu top (the warmer walks smallest-first; rungs below p50
        # warm implicitly on the way up via live traffic).
        floor = min(_next_pow2(max(2, math.ceil(p50))), top)
        ns, b = [], floor
        while b <= top:
            ns.append(b)
            b *= 2
        grid = [(n, k) for n in ns for k in self.grid_ks]
        if grid != self._warm_grid:
            out += self._apply(
                "warm_grid", len(self._warm_grid), len(grid),
                f"buckets {ns}",
                lambda: setattr(self, "_warm_grid", grid))

        out += self._tune_m_menu(now, top)
        return out

    def _tune_m_menu(self, now, top: int) -> List[Decision]:
        """Keep only the M_BUCKET_SHIFTS rungs the observed
        distinct-message counts land on (plus the shift-0 catch-all the
        staging quantizer requires)."""
        q = self.ts.quantile
        d50 = q("serving_batch_distinct_messages_sets", 0.5,
                self.window_s, now=now)
        d99 = q("serving_batch_distinct_messages_sets", 0.99,
                self.window_s, now=now)
        if d50 is None or d99 is None:
            return []
        all_shifts = _m_bucket_shifts()
        keep = {0}
        for d in (d50, d99):
            # The staging quantizer's landing rung for this count
            # (ops.backend._m_bucket_for over the same menu).
            for shift in all_shifts:
                if d <= max(1, top >> shift):
                    keep.add(shift)
                    break
        new = tuple(sorted(keep, reverse=True))
        if new == self._m_shifts:
            return []
        return self._apply(
            "m_menu", list(self._m_shifts), list(new),
            f"distinct p50={d50:.0f} p99={d99:.0f}",
            lambda: setattr(self, "_m_shifts", new))

    # ----------------------------------------------------------------- step

    def step(self, now: Optional[float] = None) -> List[Decision]:
        """One control tick: sample the time-series, judge SLOs, apply
        every knob rule whose evidence supports a change."""
        self.ts.sample(now)
        if self.slo is not None:
            self.slo.evaluate(now)
        if not self.enabled:
            # Kill switch gates actuation only: SLO visibility stays on
            # so a static node still exports slo_status and breaches.
            return []
        out: List[Decision] = []
        out += self._tune_close_margin(now)
        out += self._tune_router_cutoff()
        out += self._tune_bucket_menu(now)
        return out

    # ----------------------------------------------------- policy in / out

    def current_policy(self) -> dict:
        """The persistable TunedPolicy dict (bundle-manifest `policy`)."""
        pol: dict = {
            "policy_version": POLICY_VERSION,
            "updated_unix": round(time.time(), 3),
            "m_menu_shifts": list(self._m_shifts),
        }
        if self._warm_grid:
            pol["warm_grid"] = [list(s) for s in self._warm_grid]
        if self.batch_policy is not None:
            pol["max_bucket"] = self.batch_policy.max_bucket
        if self.router is not None:
            pol["router"] = {
                "small_batch_max": self.router.small_batch_max,
                "margin_s": self.router.margin_s,
                "table": self.router.table.snapshot(),
            }
        if self.scheduler is not None:
            pol["scheduler"] = {
                "close_margin_s": self.scheduler.close_margin_s,
                "default_latency_s": self.scheduler.default_latency_s,
            }
        return pol

    def save(self, bundle_dir: str) -> dict:
        """Persist the current policy into the bundle manifest."""
        from . import aot

        pol = self.current_policy()
        aot.save_policy(bundle_dir, pol)
        trace.instant("autotune:policy_saved", cat="autotune",
                      path=bundle_dir)
        return pol


def apply_policy(policy: Optional[dict], scheduler=None, router=None,
                 batch_policy=None,
                 check_env: bool = True) -> List[Decision]:
    """Install a persisted TunedPolicy on a (re)started serving stack.
    Returns the applied facets as Decisions (traced `cat:autotune` like
    live ones). Honors the LIGHTHOUSE_TPU_AUTOTUNE=0 kill switch unless
    `check_env=False`; a None/malformed policy applies nothing."""
    if not isinstance(policy, dict):
        return []
    if check_env and not enabled_from_env(True):
        return []
    out: List[Decision] = []

    def applied(knob, before, after, reason):
        with trace.span(f"autotune:restore:{knob}", cat="autotune",
                        knob=knob, before=before, after=after,
                        reason=reason):
            pass
        out.append(Decision(knob, before, after, reason))

    sched_pol = policy.get("scheduler") or {}
    if scheduler is not None and sched_pol:
        for attr, knob in (("close_margin_s", "close_margin"),
                           ("default_latency_s", "default_latency")):
            val = sched_pol.get(attr)
            if isinstance(val, (int, float)) and val > 0:
                before = getattr(scheduler, attr)
                if before != float(val):
                    setattr(scheduler, attr, float(val))
                    applied(knob, before, float(val), "restored")

    router_pol = policy.get("router") or {}
    if router is not None and router_pol:
        sbm = router_pol.get("small_batch_max")
        if isinstance(sbm, int) and sbm >= 0 and \
                sbm != router.small_batch_max:
            applied("router_cutoff", router.small_batch_max, sbm,
                    "restored")
            router.small_batch_max = sbm
        table = router_pol.get("table")
        if isinstance(table, dict) and table:
            n = router.restore_table(table)
            if n:
                applied("router_table", 0, n, "restored")

    mb = policy.get("max_bucket")
    if batch_policy is not None and isinstance(mb, int) and mb >= 2:
        before = batch_policy.max_bucket
        if before != mb:
            batch_policy.set_max_bucket(mb)
            applied("bucket_menu", before, batch_policy.max_bucket,
                    "restored")
    return out


def policy_warm_grid(policy: Optional[dict]) -> List[Tuple[int, int]]:
    """The tuned warming grid from a persisted policy dict ([] when
    absent/malformed — callers fall back to the static default grid)."""
    try:
        return [(int(n), int(k))
                for n, k in (policy or {}).get("warm_grid", [])]
    except (TypeError, ValueError):
        return []


def policy_m_menu(policy: Optional[dict], n_bucket: int) -> List[int]:
    """The tuned distinct-message bucket menu for one n bucket ([] when
    the policy carries no tuned shifts)."""
    shifts = (policy or {}).get("m_menu_shifts")
    if not isinstance(shifts, list) or not shifts:
        return []
    try:
        return sorted({max(1, int(n_bucket) >> int(s)) for s in shifts})
    except (TypeError, ValueError):
        return []
