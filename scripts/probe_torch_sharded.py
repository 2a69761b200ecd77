"""The port's sharded verify over every visible card, alone.

    python3 scripts/probe_torch_sharded.py

Builds the kernels, signs the headline batch (4096 sets x 4 keys over 64
messages), its poisoned copy and 256 one-key sets with distinct messages,
then runs chip_smoke.py's `multi` phase: each batch over a mesh of every
visible card and over 2 and 4 shards laid on the first, every verdict
against the unsharded one, the lead's stage-2 outputs against the
unsharded prepare's, and the eager and replayed walls. On a host with
several cards the first mesh spreads the shards over them, which the
one-card `chip_smoke.py` cannot show. Prints chip_smoke's JSON lines, the
seconds taken and the cards' names and power limits.
"""

import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from lighthouse_tpu_torch.crypto.bls import api  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_torch_sharded: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    cs.phase_env()
    base = cs._sign_sets(api, cs.HEADLINE["distinct"], cs.HEADLINE["keys"],
                         lambda i: i.to_bytes(4, "big") * 8, 100_000)
    sets, poisoned = cs._tiled(base, cs.HEADLINE["n_sets"])
    distinct = cs._sign_sets(api, 256, 1, lambda i: b"distinct" + i.to_bytes(24, "big"), 7_000)
    cs.phase_multi(sets, poisoned, distinct)
    cs.emit({"probe": "sharded", "cards": torch.cuda.device_count(),
             "seconds": time.perf_counter() - t0})
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
