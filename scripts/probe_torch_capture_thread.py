"""Capture cost of the port's bucket graphs on the main thread and on
other threads, on the card.

    python3 scripts/probe_torch_capture_thread.py
    MALLOC_ARENA_MAX=1 python3 scripts/probe_torch_capture_thread.py

Captures the graphs of (64, 1, m) on the main thread and of (64, 4, m) on
a second thread (one with a stream of its own, as the ShapeWarmer's, and
one on the default stream), alternating, for m = 1, 4, 16, 64, on the
warmer's all-padding batch. Prints one JSON line: per capture, the eager
warm-up, capture and instantiation seconds of each graph it made (a
shared h2g2 or pairing graph appears under the capture that made it).
Comparing the two runs shows what glibc's per-thread malloc arenas cost a
capture made off the main thread.
"""

import json
import os
import sys
import threading
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from lighthouse_tpu_torch.beacon_processor.warming import synthetic_batch  # noqa: E402
from lighthouse_tpu_torch.ops import _build, backend  # noqa: E402


def capture(n, k, m, device):
    core = backend.graph_core(n, k, m, True, device)
    fresh = [g for g in core.graphs if g.stats is None]
    with core.lock:
        core(*synthetic_batch(n, k, m, device)).item()
    return {g.name: {f: g.stats[f] for f in ("warmup_s", "capture_s", "instantiate_s")}
            for g in fresh}


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_torch_capture_thread: no CUDA device", file=sys.stderr)
        return 1
    _build.build_all()
    device = torch.device("cuda", 0)
    out = {}

    def on_thread(tag, m, own_stream):
        def run():
            stream = torch.cuda.Stream(device) if own_stream else None
            with torch.cuda.stream(stream):
                out[tag] = capture(64, 4, m, device)
        t = threading.Thread(target=run)
        t.start()
        t.join()

    for m, own_stream in ((1, True), (4, True), (16, False), (64, True)):
        out[f"main m={m}"] = capture(64, 1, m, device)
        on_thread(f"thread m={m}" + ("" if own_stream else " default stream"), m, own_stream)
    print(json.dumps({"MALLOC_ARENA_MAX": os.environ.get("MALLOC_ARENA_MAX"), "captures": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
