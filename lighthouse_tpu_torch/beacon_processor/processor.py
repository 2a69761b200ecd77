"""BeaconProcessor — priority work scheduler + BLS batch former.

Mirror of beacon_node/beacon_processor/src/lib.rs: bounded per-kind FIFO/LIFO
queues (capacities lib.rs:83-196), a manager loop that pops strictly by
priority (blocks > sync contributions > aggregates > unaggregated
attestations > ...; lib.rs:960-1060), and the batch former that converts up
to `max_batch` queued attestations/aggregates into ONE batch work item
(lib.rs:974-1060, cap 64 at :215-216 — sized against poisoned-batch retry
cost, adaptive here because the device backend amortizes far beyond 64).

Differences from the reference, deliberately device-first:
  * batches are handed to a single staging worker that overlaps host staging
    with device verification of the previous batch (double buffering) rather
    than rayon-style per-core workers;
  * `run_until_idle` gives tests deterministic draining; the threaded mode
    drives the same manager step.

A copy of ``lighthouse_tpu/beacon_processor/processor.py`` (:29-304) on the
port's metrics, whose batch policy reads the port's bucket menu
(``ops/backend.max_n_bucket``): the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional

logger = logging.getLogger(__name__)

# Queue capacities (lib.rs:83-196 envelope).
QUEUE_CAPS = {
    "gossip_block": 1024,
    "gossip_aggregate": 4096,
    "gossip_attestation": 16384,
    "gossip_voluntary_exit": 4096,
    "gossip_proposer_slashing": 4096,
    "gossip_attester_slashing": 4096,
    "gossip_bls_to_execution_change": 16384,
    "gossip_sync_signature": 4096,
    "gossip_sync_contribution": 4096,
    "rpc_block": 1024,
    "chain_segment": 64,
    "status": 1024,
    "blocks_by_range": 1024,
    "blocks_by_root": 1024,
    "unknown_block_attestation": 8192,
    "api_request": 1024,
}

# Strict priority order, highest first (the manager's pop order,
# lib.rs:960-1060 — blocks and sync supersede attestation gossip).
PRIORITY = [
    "chain_segment",
    "rpc_block",
    "gossip_block",
    "gossip_sync_contribution",
    "gossip_aggregate",
    "unknown_block_attestation",
    "gossip_attestation",
    "gossip_sync_signature",
    "gossip_attester_slashing",
    "gossip_proposer_slashing",
    "gossip_voluntary_exit",
    "gossip_bls_to_execution_change",
    "status",
    "blocks_by_range",
    "blocks_by_root",
    "api_request",
]

DEFAULT_MAX_BATCH = 64  # lib.rs:215-216
# The reference batches only attestations/aggregates (lib.rs:205-216 —
# CPU batches amortize poorly); the device backend amortizes every
# 1-key set family, so sync messages and BLS-to-execution changes (the
# Capella-storm shapes, eval config #5) batch too.
BATCHABLE = {"gossip_attestation", "gossip_aggregate",
             "gossip_sync_signature", "gossip_bls_to_execution_change"}


class AdaptiveBatchPolicy:
    """Batch-size policy driven by the device bucket grid (SURVEY §7.1(3),
    VERDICT round-1 item 7). The reference pins gossip batches at 64
    because CPU batches amortize poorly against poisoned-batch retries
    (lib.rs:205-216); the device backend amortizes into the thousands and
    isolates poison with on-device bisection, so the cap becomes: the
    largest power-of-two bucket <= the queue depth, bounded by
    `max_bucket` and by one GROWTH STEP past the largest bucket that has
    already run (a gossip burst must not trigger a surprise cold capture
    of a brand-new shape mid-slot; shapes warm progressively, and the
    shape warmer raises the cap as it captures each bucket)."""

    def __init__(self, max_bucket: Optional[int] = None, warm=(64,)):
        # None: resolve from the device backend's bucket menu on first
        # use (ops/backend.max_n_bucket). Resolution is lazy so
        # constructing a policy never imports torch.
        self._max_bucket = max_bucket
        self._lock = threading.Lock()
        self.warm = set(warm)
        # Running max mirrored into a plain int: read by the processor
        # thread while the ShapeWarmer daemon mutates `warm` (a bare
        # max(self.warm) could observe "Set changed size during
        # iteration"; int loads are atomic in CPython).
        self._warm_max = max(self.warm, default=1)

    @property
    def max_bucket(self) -> int:
        if self._max_bucket is None:
            from ..ops.backend import max_n_bucket

            self._max_bucket = max_n_bucket()
        return self._max_bucket

    def batch_limit(self, depth: int) -> int:
        if depth < 2:
            return 1
        b = 1 << (depth.bit_length() - 1)          # largest pow2 <= depth
        b = min(b, self.max_bucket)
        growth_cap = 2 * self._warm_max
        return max(2, min(b, growth_cap))

    def note_ran(self, n: int) -> None:
        if n >= 2:
            bucket = 1 << ((n - 1).bit_length())   # shape the backend pads to
            bucket = min(bucket, self.max_bucket)
            with self._lock:
                self.warm.add(bucket)
                self._warm_max = max(self._warm_max, bucket)

    def set_max_bucket(self, n: int) -> int:
        """Re-pin the bucket-menu ceiling (the autotuner's bucket_menu
        knob, or a restored policy). Floored to a power of two, never
        below 2 — the grid only holds pow2 shapes and a 1-cap would
        disable batching entirely. Returns the value installed."""
        n = max(2, int(n))
        self._max_bucket = 1 << (n.bit_length() - 1)
        return self._max_bucket


@dataclass
class WorkEvent:
    kind: str
    item: object
    process_individual: Optional[Callable] = None
    process_batch: Optional[Callable] = None
    drop_during_sync: bool = False


@dataclass
class ProcessorStats:
    processed: int = 0
    batches: int = 0
    batched_items: int = 0
    dropped: int = 0


class BeaconProcessor:
    def __init__(
        self,
        max_batch: int = DEFAULT_MAX_BATCH,
        max_workers: int = 4,
        batch_policy: Optional[AdaptiveBatchPolicy] = None,
        registry=None,
    ):
        self.max_batch = max_batch
        self.batch_policy = batch_policy   # None => fixed max_batch (CPU)
        self.queues: Dict[str, Deque[WorkEvent]] = {
            k: deque() for k in QUEUE_CAPS
        }
        self.stats = ProcessorStats()
        self._lock = threading.Lock()
        self._work_ready = threading.Condition(self._lock)
        self._running = False
        self._thread: Optional[threading.Thread] = None
        # Per-work-type metrics (the reference's beacon_processor gauge +
        # counter family, lib.rs's *_QUEUE_TOTAL / *_WORK_* mirrors).
        from ..common import metrics as m

        reg = registry or m.REGISTRY
        self._m_depth = reg.gauge_vec(
            "beacon_processor_queue_depth",
            "Current queue depth, by work type", "kind")
        self._m_processed = reg.counter_vec(
            "beacon_processor_processed_total",
            "Work items completed, by work type", "kind")
        self._m_dropped = reg.counter_vec(
            "beacon_processor_dropped_total",
            "Work items dropped at a full queue, by work type", "kind")
        self._m_batches = reg.counter(
            "beacon_processor_batches_total",
            "Batch work items formed from batchable queues")

    # ---------------------------------------------------------------- intake

    def send(self, event: WorkEvent) -> bool:
        """Enqueue; False = queue full, event dropped (the reference drops
        and counts on overflow rather than blocking gossip)."""
        with self._lock:
            q = self.queues[event.kind]
            if len(q) >= QUEUE_CAPS[event.kind]:
                self.stats.dropped += 1
                self._m_dropped.labels(event.kind).inc()
                return False
            q.append(event)
            self._m_depth.labels(event.kind).set(len(q))
            self._work_ready.notify()
            return True

    # -------------------------------------------------------------- manager

    def _pop_next(self) -> Optional[List[WorkEvent]]:
        """Highest-priority work; batchable kinds drain up to max_batch
        (the batch former)."""
        for kind in PRIORITY:
            q = self.queues[kind]
            if not q:
                continue
            if kind in BATCHABLE and len(q) >= 2:
                limit = (self.batch_policy.batch_limit(len(q))
                         if self.batch_policy is not None else self.max_batch)
                batch = []
                while q and len(batch) < limit:
                    batch.append(q.popleft())
                self._m_depth.labels(kind).set(len(q))
                return batch
            ev = q.popleft()
            self._m_depth.labels(kind).set(len(q))
            return [ev]
        return None

    def step(self) -> bool:
        """One manager iteration. Returns False when idle."""
        with self._lock:
            work = self._pop_next()
        if work is None:
            return False
        if len(work) > 1:
            self.stats.batches += 1
            self.stats.batched_items += len(work)
            self._m_batches.inc()
            batch_fn = work[0].process_batch
            if self.batch_policy is not None and batch_fn is not None:
                # Only a REAL device batch warms a bucket shape: a kind
                # drained per-item must not raise the growth cap to an
                # uncaptured shape (mid-slot cold-capture hazard).
                self.batch_policy.note_ran(len(work))
            if batch_fn is not None:
                batch_fn([w.item for w in work])
            else:
                for w in work:
                    if w.process_individual:
                        w.process_individual(w.item)
        else:
            w = work[0]
            self.stats.processed += 1
            if w.process_individual:
                w.process_individual(w.item)
        self._m_processed.labels(work[0].kind).inc(len(work))
        if len(work) == 1:
            return True
        self.stats.processed += len(work)
        return True

    def run_until_idle(self) -> int:
        """Drain everything (deterministic test mode)."""
        n = 0
        while self.step():
            n += 1
        return n

    # ------------------------------------------------------------- threaded

    def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        with self._lock:
            self._work_ready.notify()
        if self._thread:
            self._thread.join(timeout=5)
            self._thread = None

    def _loop(self) -> None:
        while self._running:
            try:
                idle = not self.step()
            except Exception:  # noqa: BLE001 — a failed work item must not
                # kill the manager thread (the node would silently stop
                # importing gossip work); the item is already popped, so
                # log-and-continue matches the reference's per-task
                # error isolation.
                logger.exception("beacon processor work item failed")
                idle = False
            if idle:
                with self._lock:
                    self._work_ready.wait(timeout=0.05)
