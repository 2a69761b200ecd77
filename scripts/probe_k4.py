"""Probe K4's term batch (signed linear combinations, ops/csrc/fp_add.cu) on
one card: the loads of 1, 4, 6 and 8 terms issued together.

    python3 scripts/probe_k4.py

Builds a copy of fp_add.cu once per kBatch (1, 4, 6, 8), the constant
written into each copy, the nvcc runs started together, and calls each build's lh_fp_lincomb through the port's launch
arguments (fused._lincomb_args) at the paths' plans and shapes (CASES: the
final exponentiation's n = 1, h2g2's m = 64, one-row fp_add, and the Fp6
product at 4096): bit for bit against fp_lincomb_plain first, then each
build timed by graph replay in turns (1, 4, 6, 8, 8, 6, 4, 1), beside an
empty kernel on its grid. Prints JSON lines, the card's name and power
limit first. Needs a CUDA card and nvcc.
"""

import ctypes
import json
import math
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from lighthouse_tpu_torch.ops import _build, curves, fused, h2c, tower  # noqa: E402,F401

BATCHES = (1, 4, 6, 8)
REPS = 200
# (plan name, operand shapes): each plan at a shape its path gives it.
CASES = (("fp_add", ((1, 12, 1), (1, 12, 1))), ("fp_add", ((1, 12, 64), (1, 12, 64))),
         ("fp6_mul", ((18, 12, 1),)), ("fp12_conj", ((12, 12, 1),)),
         ("fp6_inv_c", ((6, 12, 1), (6, 12, 1))),
         ("iso_map_sums", ((2, 32, 12, 64),)), ("fp2_conj", ((3, 2, 12, 64),)),
         ("sswu_tv2", ((2, 2, 12, 64), (2, 2, 12, 64), (2, 12, 1))),
         ("fp6_mul", ((18, 12, 4096),)))


def _builds(work: Path) -> dict:
    """A copy of fp_add.cu in `work` per kBatch, each built -> {batch:
    library}; prints each build's ptxas registers and spills of
    lincomb_kernel."""
    src = (_build.CSRC / "fp_add.cu").read_text()
    pattern = r"constexpr int kBatch = \d+;"
    if len(re.findall(pattern, src)) != 1:
        raise RuntimeError("fp_add.cu: no single kBatch constant to set")
    procs = {}
    for b in BATCHES:
        cu, out = work / f"fp_add_batch{b}.cu", work / f"batch{b}.so"
        cu.write_text(re.sub(pattern, f"constexpr int kBatch = {b};", src))
        cmd = ([_build.nvcc()] + _build.ARCH_FLAGS + _build.FLAGS
               + ["-I", str(_build.CSRC), "-o", str(out), str(cu)])
        procs[b] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True), out)
    libs = {}
    for b, (proc, out) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for kBatch = {b}:\n{log[-3000:]}")
        kernel, entry = [], ""
        for line in log.splitlines():
            if "Compiling entry" in line:
                entry = line
            elif "lincomb_kernel" in entry and ("registers" in line or "spill" in line):
                kernel.append(line.strip())
        print(json.dumps({"built": b, "ptxas": kernel}), flush=True)
        lib = ctypes.CDLL(str(out))
        for name, argtypes in _build.ENTRY_POINTS["fp_add"].items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
        libs[b] = lib
    return libs


def _call(lib, xs, coeffs):
    def call():
        out, _keep, args = fused._lincomb_args(xs, coeffs)
        if lib.lh_fp_lincomb(*args, torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("lh_fp_lincomb: launch failed")
        return out

    return call


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_k4: no CUDA device", file=sys.stderr)
        return 1
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    with tempfile.TemporaryDirectory() as tmp:
        libs = _builds(Path(tmp))
        plans = {**fused.LINCOMB_PLANS, "fp_add": fused._ONE_ROW["fp_add"]}
        for name, shapes in CASES:
            coeffs = plans[name]
            xs = tuple(cs._rand_fp(shape, gen, edges=True) for shape in shapes)
            want = fused.fp_lincomb_plain(xs, coeffs)
            for b, lib in libs.items():
                if not torch.equal(_call(lib, xs, coeffs)(), want):
                    raise AssertionError(f"kBatch = {b} differs from the plain version "
                                         f"at {name} {shapes}")
            lead, n = fused._lincomb_shape(xs)
            rows = math.prod(lead) * len(coeffs)

            def empty():
                lib = libs[BATCHES[0]]
                if lib.lh_fp_add_empty(None, rows, n, torch.cuda.current_stream().cuda_stream):
                    raise RuntimeError("lh_fp_add_empty: launch failed")

            ms = {b: [] for b in BATCHES}
            for b in BATCHES + BATCHES[::-1]:
                ms[b].append(cs.graph_ms(_call(libs[b], xs, coeffs), REPS))
            print(json.dumps({"plan": name, "shapes": shapes, "bit_for_bit": True,
                              "ms_by_batch": ms, "floor_ms": cs.graph_ms(empty, REPS)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
