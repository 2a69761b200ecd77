"""Deadline-aware continuous-batching scheduler for verification traffic.

The reference `beacon_processor` is a deadline-driven multi-work-type
scheduler, not a fixed-batch loop (PAPER.md L7): work arrives
continuously, and what matters is landing each batch inside its
slot-third budget. This module evolves the repo's batch former
(`beacon_processor/processor.py`) accordingly:

  * **admit continuously** — `submit` enqueues `VerifyJob`s (one
    SignatureSet each) into per-kind bounded queues, reference capacities
    and priority order (QUEUE_CAPS / PRIORITY);
  * **close on bucket-or-deadline** — a batch closes when the best
    device bucket the AdaptiveBatchPolicy allows has filled, OR when the
    remaining slot-third budget minus the predicted per-shape latency
    (the router's measured table) says waiting any longer would miss the
    deadline. Until then the scheduler keeps accumulating — batches grow
    as large as the deadline allows, never larger;
  * **mixed work types, one device pipeline** — attestations,
    sync-committee signatures, aggregates and BLS-to-execution changes
    (the BATCHABLE kinds) drain into ONE batch in priority order: the
    device equation is per-set, so heterogeneous sets share a dispatch;
  * **heterogeneous backends** — every closed batch routes through the
    CostModelRouter (native CPU for small/deadline-critical, device for
    bulk), and a failed batch isolates its poisoned sets by bisection on
    the same route, per-job callbacks observing individual verdicts.

Deadline math: a slot is three thirds (attestation deadline semantics);
the budget at any instant is the time to the end of the CURRENT third,
`third - (seconds_into_slot % third)`. A batch dispatched with measured
latency <= its dispatch-time budget counts a deadline hit, else a miss
(`serving_scheduler_deadline_{hits,misses}_total`).

`run_until_idle` drains deterministically for tests/probes: with the
intake stopped, deadline waits are moot, so every step flushes.

A copy of ``lighthouse_tpu/serving/scheduler.py`` (:58-282) on the port's
router, batch policy, slot clock and metrics: the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional

from ..beacon_processor.processor import (
    BATCHABLE,
    PRIORITY,
    QUEUE_CAPS,
    AdaptiveBatchPolicy,
)
from ..common import metrics as m
from ..common.slot_clock import SlotClock
from ..observability import trace

from .router import CostModelRouter, _next_pow2

# Batchable kinds in strict priority order (the manager's pop order).
BATCH_KINDS = tuple(k for k in PRIORITY if k in BATCHABLE)

# Deadline margins run negative (a miss overran its budget), so the
# buckets must span zero — the default ms ladder can't express a miss.
MARGIN_BUCKETS = (-2.0, -1.0, -0.5, -0.2, -0.1, -0.05, 0.0, 0.05, 0.1,
                  0.2, 0.5, 1.0, 2.0, 5.0)


@dataclass
class VerifyJob:
    """One queued verification: a SignatureSet plus where its verdict
    goes. `kind` keys priority + queue caps (must be a BATCHABLE kind).
    `t_arrival` anchors the batch-lifecycle clock: it defaults to
    construction time, and gossip-side callers override it with the
    message's arrival stamp so accumulation waits include handoff."""

    kind: str
    sset: object
    on_result: Optional[Callable[[bool], None]] = None
    t_arrival: float = field(default_factory=time.perf_counter)


@dataclass
class SchedulerStats:
    batches: int = 0
    items: int = 0
    dropped: int = 0
    deadline_hits: int = 0
    deadline_misses: int = 0
    poisoned: int = 0
    by_route: Dict[str, int] = field(default_factory=dict)


class ContinuousBatchScheduler:
    """See module docstring. Thread-safe intake; `step`/`run_until_idle`
    drive dispatch (single consumer, like the BeaconProcessor manager)."""

    def __init__(self, clock: SlotClock,
                 policy: Optional[AdaptiveBatchPolicy] = None,
                 router: Optional[CostModelRouter] = None,
                 close_margin_s: float = 0.050,
                 default_latency_s: float = 0.250,
                 registry: Optional[m.Registry] = None):
        self.clock = clock
        self.policy = policy or AdaptiveBatchPolicy()
        self.router = router or CostModelRouter()
        self.close_margin_s = close_margin_s
        # Assumed device latency for never-measured shapes: conservative
        # (a cold shape mid-slot is exactly what the warmer exists to
        # prevent; predicting it cheap would invite one).
        self.default_latency_s = default_latency_s
        self.queues: Dict[str, Deque[VerifyJob]] = {
            k: deque() for k in BATCH_KINDS
        }
        self.stats = SchedulerStats()
        self._lock = threading.Lock()
        reg = registry or m.REGISTRY
        self._m_batches = reg.counter(
            "serving_scheduler_batches_total", "Batches dispatched")
        self._m_hits = reg.counter(
            "serving_scheduler_deadline_hits_total",
            "Batches whose measured latency fit the dispatch-time budget")
        self._m_misses = reg.counter(
            "serving_scheduler_deadline_misses_total",
            "Batches that overran the slot-third budget they closed with")
        self._m_close = reg.counter_vec(
            "serving_scheduler_close_total",
            "Batch close causes (bucket_full|deadline|flush)", "cause")
        self._m_size = reg.histogram(
            "serving_scheduler_batch_size_sets",
            "Dispatched batch sizes (signature sets per batch)",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048,
                     4096, 8192, 16384))
        self._m_margin = reg.histogram(
            "serving_deadline_margin_seconds",
            "Slot-third budget minus measured batch latency at dispatch "
            "(negative = deadline miss)", buckets=MARGIN_BUCKETS)
        self._m_accum = reg.histogram(
            "serving_batch_accumulation_seconds",
            "Per-job wait from arrival to batch dispatch")
        self._m_batch_lat = reg.histogram(
            "serving_scheduler_batch_seconds",
            "Measured batch wall time from close to verdict (what the "
            "p50-latency SLO and the autotuner read)")
        self._m_distinct = reg.histogram(
            "serving_batch_distinct_messages_sets",
            "Distinct messages per dispatched batch (drives the "
            "autotuned M_BUCKET_SHIFTS menu)",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024))

    # ---------------------------------------------------------------- intake

    def submit(self, job: VerifyJob) -> bool:
        """Enqueue; False = queue at its reference capacity, job dropped
        (overflow drops rather than blocking gossip, lib.rs semantics)."""
        q = self.queues[job.kind]  # KeyError = not a batchable kind
        with self._lock:
            if len(q) >= QUEUE_CAPS[job.kind]:
                self.stats.dropped += 1
                return False
            q.append(job)
            return True

    def depth(self) -> int:
        with self._lock:
            return sum(len(q) for q in self.queues.values())

    # -------------------------------------------------------------- deadline

    def _third(self) -> float:
        return self.clock.seconds_per_slot / 3.0

    def deadline_budget(self) -> float:
        """Seconds until the end of the current slot third."""
        third = self._third()
        return third - (self.clock.seconds_into_slot() % third)

    def _predicted_latency(self, n_sets: int) -> float:
        route, _ = self.router.route(n_sets, self.deadline_budget())
        p = self.router.table.predict(route, _next_pow2(max(1, n_sets)))
        return p if p is not None else self.default_latency_s

    # ------------------------------------------------------------- dispatch

    def _close_cause(self, flush: bool) -> Optional[str]:
        """Why (whether) to close a batch NOW. None = keep accumulating."""
        depth = self.depth()
        if depth == 0:
            return None
        limit = self.policy.batch_limit(depth)
        if depth >= limit and depth >= 2:
            return "bucket_full"  # the best allowed bucket has filled
        if flush:
            return "flush"
        # Would one more accumulation interval blow the deadline? Close
        # while the predicted latency still fits the remaining budget.
        if (self.deadline_budget() - self._predicted_latency(depth)
                <= self.close_margin_s):
            return "deadline"
        return None

    def _drain(self, limit: int) -> List[VerifyJob]:
        batch: List[VerifyJob] = []
        with self._lock:
            for kind in BATCH_KINDS:  # strict priority order
                q = self.queues[kind]
                while q and len(batch) < limit:
                    batch.append(q.popleft())
                if len(batch) >= limit:
                    break
        return batch

    def step(self, flush: bool = False) -> bool:
        """One scheduler iteration: close-or-wait, then dispatch. Returns
        False when nothing was dispatched (idle or still accumulating)."""
        cause = self._close_cause(flush)
        if cause is None:
            return False
        jobs = self._drain(self.policy.batch_limit(self.depth()))
        if not jobs:
            return False
        self._m_close.labels(cause).inc()
        trace.instant("batch:close", cat="lifecycle", cause=cause,
                      n_jobs=len(jobs))
        self._dispatch(jobs)
        return True

    def _dispatch(self, jobs: List[VerifyJob]) -> None:
        sets = [j.sset for j in jobs]
        budget = self.deadline_budget()
        t0 = time.perf_counter()
        # Lifecycle: arrival -> accumulation ends here, execution begins.
        for j in jobs:
            self._m_accum.observe(max(t0 - j.t_arrival, 0.0))
        with trace.span("batch:execute", cat="lifecycle",
                        n_sets=len(jobs), budget_s=round(budget, 4)):
            ok, route = self.router.verify(sets, deadline_budget=budget)
        dt = time.perf_counter() - t0

        self.stats.batches += 1
        self.stats.items += len(jobs)
        self.stats.by_route[route] = self.stats.by_route.get(route, 0) + 1
        self._m_batches.inc()
        self._m_size.observe(len(jobs))
        self._m_margin.observe(budget - dt)
        self._m_batch_lat.observe(dt)
        msgs = {getattr(j.sset, "message", None) for j in jobs}
        msgs.discard(None)
        if msgs:
            self._m_distinct.observe(len(msgs))
        trace.instant("batch:verdict", cat="lifecycle", ok=bool(ok),
                      route=route, n_sets=len(jobs),
                      margin_s=round(budget - dt, 4))
        if dt <= budget:
            self.stats.deadline_hits += 1
            self._m_hits.inc()
        else:
            self.stats.deadline_misses += 1
            self._m_misses.inc()
        if route == "device" and len(jobs) >= 2:
            # Only a real device batch warms a bucket shape (the
            # processor's mid-slot cold-capture guard).
            self.policy.note_ran(len(jobs))

        if ok:
            for j in jobs:
                if j.on_result:
                    j.on_result(True)
            return
        # Poisoned batch: bisection isolates culprits on the same route;
        # every other set still verifies.
        invalid = set(self.router.find_invalid(sets, route))
        self.stats.poisoned += len(invalid)
        for i, j in enumerate(jobs):
            if j.on_result:
                j.on_result(i not in invalid)

    def run_until_idle(self) -> int:
        """Drain everything deterministically (tests/probes): intake has
        stopped, so accumulation waits are pointless — every step flushes
        whatever is queued (still bucket-limited per batch)."""
        n = 0
        while self.step(flush=True):
            n += 1
        return n
