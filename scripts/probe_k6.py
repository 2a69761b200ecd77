"""Probe K6's pairs layout (a Miller loop's T chain, ops/csrc/curve_op.cu) on
one card: 1, 2 and 4 pairs a block.

    python3 scripts/probe_k6.py

Builds curve_op.cu once per LH_K6_PAIR_P (1, 2, 4), all three nvcc runs
started together, and calls each build's chain (lh_miller_chain) through
the port's launch arguments (fused._k6_args) at 2 and 65 pairs, the paths'
widths in the pairs layout (KZG's two pairs, the headline's m + 1): bit for
bit against the chain's plain version first, then each build timed by graph
replay in turns (1, 2, 4, 4, 2, 1), beside an empty kernel on its grid.
Prints JSON lines, the card's name and power limit first. Needs a CUDA card
and nvcc.
"""

import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from lighthouse_tpu_torch.ops import _build, fused  # noqa: E402
from probe_k5 import _lib  # noqa: E402

PAIRS_A_BLOCK = (1, 2, 4)
NS = (2, 65)
REPS = 50


def _builds(work: Path) -> dict:
    """curve_op.cu built once per LH_K6_PAIR_P, the nvcc runs started
    together -> {pairs a block: library path}; prints each build's ptxas
    registers and spills of the chain's kernels."""
    (work / "curve_plan.h").write_text(fused.k5_plan_header())
    procs = {}
    for p in PAIRS_A_BLOCK:
        out = work / f"pairs{p}.so"
        cmd = ([_build.nvcc()] + _build.ARCH_FLAGS + _build.FLAGS + [f"-DLH_K6_PAIR_P={p}"]
               + ["-I", str(work), "-I", str(_build.CSRC), "-o", str(out),
                  str(_build.CSRC / "curve_op.cu")])
        procs[p] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True), out)
    paths = {}
    for p, (proc, out) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for LH_K6_PAIR_P={p}:\n{log[-3000:]}")
        chain, entry = [], ""
        for line in log.splitlines():
            if "Compiling entry" in line:
                entry = line
            elif "chain_kernel" in entry and ("registers" in line or "spill" in line):
                chain.append(line.strip())
        print(json.dumps({"built": p, "ptxas": chain}), flush=True)
        paths[p] = out
    return paths


def _chain(lib, xs):
    def call():
        (out, lines), _keep, args = fused._k6_args("miller_chain", xs)
        if lib.lh_miller_chain(*args, torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("lh_miller_chain: launch failed")
        return out, lines

    return call


def _empty(lib, n):
    def call():
        if lib.lh_miller_empty(None, 1, n, torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("lh_miller_empty: launch failed")

    return call


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = {p: _lib(path) for p, path in _builds(Path(tmp)).items()}
        gen = torch.Generator(device="cuda")
        gen.manual_seed(cs.SEED)
        ops = {n: cs._operands("miller_chain", cs._operand_shapes("miller_chain", (3, 2, 12, n)),
                               gen) for n in NS}
        for n, xs in ops.items():
            want = fused.PLAIN["miller_chain"](*xs)
            for p, lib in libs.items():
                got = _chain(lib, xs)()
                torch.cuda.synchronize()
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"{p} pairs a block at n = {n}: differs from plain")
        times = {p: {n: [] for n in NS} for p in PAIRS_A_BLOCK}
        floors = {p: {n: [] for n in NS} for p in PAIRS_A_BLOCK}
        for p in PAIRS_A_BLOCK + PAIRS_A_BLOCK[::-1]:
            for n, xs in ops.items():
                times[p][n].append(cs.graph_ms(_chain(libs[p], xs), REPS))
                floors[p][n].append(cs.graph_ms(_empty(libs[p], n), 200))
        for p in PAIRS_A_BLOCK:
            print(json.dumps({"pairs_a_block": p, "chain_ms": times[p], "floor_ms": floors[p]}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
