"""Probe K5 (the G1/G2 group law, ops/csrc/curve_op.cu) on one card.

    python3 scripts/probe_k5.py stamps    # clock64 steps of one warp of the port's
                                          # kernel (block 0, thread 0), n = 64 and 4096
    python3 scripts/probe_k5.py micro     # an Fp product as C and as PTX carry
                                          # chains, a shuffle's latency, and the cost
                                          # of fetching straight-line code

`stamps` builds curve_op.cu with -DLH_K5_STAMPS (its LH_K5_STAMP steps) and
calls it through the port's launch arguments (fused._k5_args); `micro`
builds scripts/probe_k5.cu and a generated fetch probe. Prints JSON lines,
the card's name and power limit first. Needs a CUDA card and nvcc.
"""

import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from lighthouse_tpu_torch.ops import _build, fused  # noqa: E402

ENTRY = {"g1_add": "lh_g1_add", "g1_double": "lh_g1_dbl", "g2_add": "lh_g2_add",
         "g2_double": "lh_g2_dbl"}


def _nvcc(sources: dict, work: Path, extra=()) -> dict:
    """Build each {name: .cu path} into a library in `work`, in parallel,
    against the generated schedule header -> {name: path}."""
    (work / "curve_plan.h").write_text(fused.k5_plan_header())
    procs, out = {}, {}
    for name, src in sources.items():
        out[name] = work / f"{name}.so"
        cmd = ([_build.nvcc()] + _build.ARCH_FLAGS + _build.FLAGS + list(extra)
               + ["-I", str(work), "-I", str(_build.CSRC), "-o", str(out[name]), str(src)])
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(json.dumps({"built": name, "max_spill_bytes": max(map(int, spills or [0]))}),
              flush=True)
    return out


def _lib(path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _build.ENTRY_POINTS["curve_op"].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def _caller(lib, name, xs):
    fn = getattr(lib, ENTRY[name])

    def call():
        out, _keep, args = fused._k5_args(name, xs)
        if fn(*args, torch.cuda.current_stream().cuda_stream):
            raise RuntimeError(f"{name}: launch failed")
        return out

    return call


# The stamps' steps (curve_op.cu LH_K5_STAMP): level -1 the loads, then each
# level's.
_LEVEL_STEPS = ("operands", "rows", "product stored", "barrier", "column sums", "carry pass",
                "REDC main part", "reduction done", "barrier")
_STEPS = {(0, 0): "start", (0, 1): "loads stored"}
_STEPS.update({(lv + 1, k): f"L{lv} {name}" for lv in range(2)
               for k, name in enumerate(_LEVEL_STEPS)})


def stamps():
    with tempfile.TemporaryDirectory() as tmp:
        lib = _lib(_nvcc({"stamped": _build.CSRC / "curve_op.cu"}, Path(tmp),
                         ["-DLH_K5_STAMPS"])["stamped"])
        lib.lh_k5_stamps.argtypes = [ctypes.c_void_p]
        gen = torch.Generator(device="cuda")
        gen.manual_seed(cs.SEED)
        for name in ENTRY:
            for n in (64, 4096):
                shape = (3, 12, n) if name.startswith("g1") else (3, 2, 12, n)
                xs = cs._operands(name, [shape] * (2 if name.endswith("_add") else 1), gen)
                for _ in range(3):
                    got = _caller(lib, name, xs)()
                torch.cuda.synchronize()
                if not torch.equal(got, fused.PLAIN[name](*xs)):
                    raise AssertionError(f"stamped {name} at {n}: differs from the plain version")
                st = (ctypes.c_longlong * 27)()
                if lib.lh_k5_stamps(st):
                    raise RuntimeError("reading the stamps failed")
                marks = sorted((st[9 * lv + k], (lv, k)) for lv, k in _STEPS if st[9 * lv + k])
                steps = [(_STEPS[k], t - prev) for (prev, _), (t, k) in zip(marks, marks[1:])]
                print(json.dumps({"op": name, "n": n, "cycles": marks[-1][0] - marks[0][0],
                                  "steps": steps}), flush=True)


def _fetch_source(sizes) -> str:
    """Kernels of n straight-line adds (8 interleaved chains) and one of a
    256-add body looped: the cost an instruction of fetching code."""
    lines = ["#include <cstdio>"]
    regs = ", ".join(f"r{k} = d[threadIdx.x + {k}]" for k in range(8))
    total = " + ".join(f"r{k}" for k in range(8))

    def body(n):
        return [f'  asm volatile("add.u32 %0, %0, %1;" : "+r"(r{k}) : "r"(r{(k + 1) % 8}));'
                for _ in range(n // 8) for k in range(8)]

    for n in sizes:
        lines += [f"__global__ void k{n}(unsigned* d, long long* cyc) {{", f"  unsigned {regs};",
                  "  long long c0 = clock64();"] + body(n) + [
                  "  long long c1 = clock64();", f"  d[threadIdx.x] = {total};",
                  "  if (threadIdx.x == 0) cyc[0] = c1 - c0;", "}"]
    lines += ["__global__ void kloop(unsigned* d, long long* cyc, int iters) {", f"  unsigned {regs};",
              "  long long c0 = clock64();", "#pragma unroll 1", "  for (int i = 0; i < iters; ++i) {"]
    lines += body(256) + ["  }", "  long long c1 = clock64();", f"  d[threadIdx.x] = {total};",
                          "  if (threadIdx.x == 0) cyc[0] = c1 - c0;", "}"]
    lines += ["int main() {", "  unsigned* d; long long* c; long long h;",
              "  cudaMalloc(&d, 4096); cudaMalloc(&c, 64);"]
    for n in sizes:
        lines.append(f"  k{n}<<<1, 32>>>(d, c); k{n}<<<1, 32>>>(d, c); cudaMemcpy(&h, c, 8, "
                     "cudaMemcpyDeviceToHost);")
        lines.append(f'  printf("{{\\"probe\\": \\"fetch\\", \\"instructions\\": {n}, '
                     f'\\"cycles_an_instruction\\": %.2f}}\\n", (double)h / {n});')
    lines.append("  kloop<<<1, 32>>>(d, c, 64); kloop<<<1, 32>>>(d, c, 64); cudaMemcpy(&h, c, 8, "
                 "cudaMemcpyDeviceToHost);")
    lines.append('  printf("{\\"probe\\": \\"fetch\\", \\"instructions\\": 16384, \\"looped\\": 256, '
                 '\\"cycles_an_instruction\\": %.2f}\\n", (double)h / 16384);')
    lines += ["  return 0;", "}"]
    return "\n".join(lines) + "\n"


def micro():
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        (work / "fetch.cu").write_text(_fetch_source((1024, 2048, 4096, 8192, 16384)))
        for name, src in (("probes", ROOT / "scripts" / "probe_k5.cu"), ("fetch", work / "fetch.cu")):
            exe = work / name
            subprocess.run([_build.nvcc()] + _build.ARCH_FLAGS
                           + ["-O3", "-std=c++17", "-I", str(_build.CSRC), "-o", str(exe), str(src)],
                           check=True, capture_output=True, text=True)
            print(subprocess.run([str(exe)], check=True, capture_output=True, text=True).stdout,
                  end="", flush=True)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    if len(argv) != 2 or argv[1] not in ("stamps", "micro"):
        print("usage: probe_k5.py stamps | micro", file=sys.stderr)
        return 2
    {"stamps": stamps, "micro": micro}[argv[1]]()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
