"""Background capture of the bucket graphs: the port's ShapeWarmer.

Counterpart: ``lighthouse_tpu/beacon_processor/warming.py`` (``ShapeWarmer``,
``DEFAULT_SHAPE_GRID``, ``_warm_one_bm``). A bucket's first verify pays for
its graphs: one eager run of each stage, then its capture and
instantiation (``ops/graphs.py``). The warmer pays that in a daemon thread
instead, on a stream of its own, walking the grid smallest first and, for
each (n, k) rung, every m bucket of the menu, on a synthetic all-padding
batch (infinity points, every set masked out and its signature checked,
so the keys with all_checked=True that gossip batches reach). A key with
all_checked=False is captured on its first use. A verify in another thread
may run meanwhile: it replays warm keys, and a key being captured is
captured once (its lock), the other caller waiting for it.

The grid stops at (4096, 4), the port's ``max_n_bucket``: the port has no
chunked prep stage, and no verify above 4096 sets has run on the card,
where the JAX warmer also warms 8192 and 16384 (its ``max_n_bucket``).

As each rung's graphs are captured, the warmer tells the batch policy
(``beacon_processor/processor.AdaptiveBatchPolicy``) that its bucket has
run, so the batch former's growth cap rises behind it (JAX
``warming.py:79-85``, ``:286-287``); without it the former stays capped at
twice the largest bucket that has run, 128 sets at first.

Each rung that takes the capture path is recorded as a
``warm_capture_path`` event (``observability/compile_events``), as JAX's
``warm_one`` records ``warm_compile_path``: the port has no warm bundle,
so every rung takes it. ``tuned_shape_grid`` (JAX ``:50-73``) reads the
grid a persisted autotune policy asks for (``serving/autotune.py``).
"""

import contextlib
import threading
import traceback
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..observability import compile_events, trace
from ..ops import backend
from ..ops import limbs as lb

DEFAULT_SHAPE_GRID: Tuple[Tuple[int, int], ...] = (
    (64, 1), (64, 4), (256, 1), (256, 4), (1024, 1), (1024, 4),
    (2048, 1), (2048, 4), (4096, 4),
)


def tuned_shape_grid(policy: Optional[dict],
                     default: Sequence[Tuple[int, int]] = DEFAULT_SHAPE_GRID,
                     ) -> Tuple[Tuple[int, int], ...]:
    """The warming grid a persisted autotune policy asks for (the
    `warm_grid` facet of serving/autotune's TunedPolicy dict), or
    `default` when the policy is absent/malformed — a restarted node
    warms exactly the shapes its own traffic proved it needs instead of
    the full static grid."""
    if not isinstance(policy, dict):
        return tuple(default)
    grid = policy.get("warm_grid")
    if not isinstance(grid, (list, tuple)) or not grid:
        return tuple(default)
    out = []
    for pair in grid:
        try:
            n, k = pair
            n, k = int(n), int(k)
        except (TypeError, ValueError):
            return tuple(default)
        if n < 2 or k < 1:
            return tuple(default)
        out.append((n, k))
    return tuple(out)


def m_menu(n_bucket: int) -> list:
    """Every m bucket that staging can give a batch of n_bucket sets
    (M_BUCKET_SHIFTS through _m_bucket_for, as _warm_one_bm walks it)."""
    return sorted({backend._m_bucket_for(n_bucket, max(1, n_bucket >> shift))
                   for shift in backend.M_BUCKET_SHIFTS})


def synthetic_batch(n_bucket: int, k_bucket: int, m_bucket: int, device) -> tuple:
    """Staged arguments of an all-padding batch at one key: zero field
    elements, infinity keys and signatures, every set masked out with its
    signature checked, scalars 1. Made on the host and copied over, so the
    warmer's thread makes no cached device constant on its own stream."""
    n, L = n_bucket, lb.L
    one = lb.ints_to_limbs_np([1])                      # Montgomery 1, (12, 1)
    g1 = np.zeros((k_bucket, 3, L, n), dtype=np.int32)
    g1[:, 1] = one
    g2 = np.zeros((3, 2, L, n), dtype=np.int32)
    g2[1, 0] = one
    host = (np.zeros((2, 2, L, m_bucket), dtype=np.int32), np.arange(n, dtype=np.int64) % m_bucket,
            np.zeros((m_bucket,), dtype=bool), g1, g2, np.ones((n,), dtype=bool),
            np.zeros((n,), dtype=bool), np.ones((n,), dtype=np.int64))
    return tuple(torch.from_numpy(x).to(device) for x in host)


class ShapeWarmer:
    """Captures the bucket graphs of `shapes` in a daemon thread, and calls
    `policy.note_ran(n)` as each rung is done. `warmed` lists the (n, k)
    rungs done, `captured` (graph name, capture stats) for each graph this
    warmer captured, `failed` ((n, k), traceback) for each rung that
    raised: it is left for first use, as in JAX."""

    def __init__(self, policy=None, shapes: Sequence[Tuple[int, int]] = DEFAULT_SHAPE_GRID,
                 device=None):
        self.policy = policy
        self.shapes = tuple(shapes)
        self.device = lb.default_device(device)
        self.warmed: list = []
        self.captured: list = []
        self.failed: list = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "ShapeWarmer":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._run, daemon=True, name="shape-warmer")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    def warm_one(self, n_bucket: int, k_bucket: int) -> None:
        """Run every m bucket of one rung through its graphs, all_checked."""
        with trace.span("warm_one", cat="warming", n=n_bucket, k=k_bucket):
            compile_events.record("warm_capture_path", n=n_bucket, k=k_bucket)
            for m_bucket in m_menu(n_bucket):
                core = backend.graph_core(n_bucket, k_bucket, m_bucket, True, self.device)
                args = synthetic_batch(n_bucket, k_bucket, m_bucket, self.device)
                with core.lock:
                    fresh = [g for g in core.graphs if g.stats is None]
                    core(*args).item()      # lets go of the lock once the device is done
                self.captured.extend((g.name, g.stats) for g in fresh if g.stats is not None)

    def _run(self) -> None:
        on_card = self.device.type == "cuda"
        stream = torch.cuda.Stream(self.device) if on_card else None
        with torch.cuda.stream(stream) if on_card else contextlib.nullcontext():
            for n_bucket, k_bucket in self.shapes:
                if self._stop.is_set():
                    return
                try:
                    self.warm_one(n_bucket, k_bucket)
                except Exception:  # the rung is left for first use, and recorded
                    self.failed.append(((n_bucket, k_bucket), traceback.format_exc()))
                    continue
                self.warmed.append((n_bucket, k_bucket))
                if self.policy is not None:
                    self.policy.note_ran(n_bucket)
