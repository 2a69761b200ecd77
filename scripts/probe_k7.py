"""Probe K7 (the Fp inverse and the powers, ops/csrc/fp_pow.cu) on one card.

    python3 scripts/probe_k7.py

Builds scripts/probe_k7.cu (which includes fp_pow.cu, so it times the
kernel's own device functions) and prints one JSON line a step, each the
clock64 cycles of one dependent step on a warp alone on its SM, in a grid of
h2g2's 2 x 64 Fp2 elements: the Fp2 power's square and product as its
four-lane design runs them and their parts (the product's part sum, the
square's operands), one Fp product, and the inverse's divstep batch,
update_fg, update_de and whole chain. The card's name and power limit come
first. Needs a CUDA card and nvcc.
"""

import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from lighthouse_tpu_torch.ops import _build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        exe = Path(tmp) / "probe_k7"
        build = subprocess.run([_build.nvcc()] + _build.ARCH_FLAGS
                               + ["-O3", "-std=c++17", "-Xptxas", "-v", "-I", str(_build.CSRC),
                                  "-o", str(exe), str(ROOT / "scripts" / "probe_k7.cu")],
                               capture_output=True, text=True)
        if build.returncode:
            print(build.stderr[-4000:], file=sys.stderr)
            return 1
        print(subprocess.run([str(exe)], check=True, capture_output=True, text=True).stdout,
              end="", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
