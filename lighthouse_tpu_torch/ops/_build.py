"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source in ``ops/csrc/*.cu`` becomes one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds). Libraries land in
``lighthouse_tpu_torch/_build/``, named by a hash of the sources and flags, so
a changed source rebuilds and an unchanged one is reused. A source may
include headers generated from Python (``GENERATED``): they are written
beside its library and hashed with it. The first call to ``library``
builds every source at once, one nvcc process each, all started together.
Nothing is built or imported at module import. Each source's first
resolution in a process is recorded (``observability/compile_events``):
``kernel_build`` with its seconds when this process compiled it,
``kernel_cache_hit`` when its library was already built.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from ..observability import compile_events

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("fp_mul", "fp2_mul", "fp12_op", "fp_add", "curve_op", "fp_pow")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_PTR, _INT = ctypes.c_void_p, ctypes.c_longlong


def _sig(n_ptr: int, n_int: int = 2) -> list:
    """ctypes argument types: tensor pointers (output first), integers, then
    the stream (K4's: the geometry pointer, then the stream)."""
    return [_PTR] * n_ptr + [_INT] * n_int + [_PTR]


# C entry points per library: name -> argument types. Most take (output,
# inputs..., rows, n, stream); K4's takes (output, an array of operand
# pointers, their count, rows, n, the plan, the geometry, stream), the plan
# a uint32 array and the geometry an int64 one (csrc/fp_add.cu); K5's
# (output, inputs..., rows, n, geometry, stream), the geometry a pointer to
# int64 strides or null (csrc/curve_op.cu); K6's takes its two outputs (the
# last T, the lines), its five operands, rows, n, the steps (a byte each)
# and their count, the geometry and the stream; K7's powers take (output,
# input, digits, digit count, rows, n, stream). lh_fp_empty,
# lh_fp2_empty, lh_fp12_empty, lh_fp_add_empty, lh_curve_empty,
# lh_miller_empty, lh_fp_inv_empty, lh_fp_pow_empty and lh_fp2_pow_empty
# launch an empty kernel on K1's, K2's, K3's, K4's, K5's, K6's and K7's three
# grids: chip_smoke.py's floor.
ENTRY_POINTS = {
    "fp_mul": {"lh_fp_mul": _sig(3), "lh_fp_sqr": _sig(2), "lh_fp_empty": _sig(1)},
    "fp2_mul": {"lh_fp2_mul": _sig(3), "lh_fp2_sqr": _sig(2), "lh_fp2_empty": _sig(1)},
    "fp12_op": {"lh_fp12_sqr": _sig(2), "lh_fp12_mul": _sig(3), "lh_fp12_line": _sig(3),
                "lh_fp12_empty": _sig(1)},
    "fp_add": {"lh_fp_lincomb": [_PTR, _PTR, _INT, _INT, _INT, _PTR, _PTR, _PTR],
               "lh_fp_add_empty": _sig(1)},
    "curve_op": {"lh_g1_add": _sig(3) + [_PTR], "lh_g1_dbl": _sig(2) + [_PTR],
                 "lh_g2_add": _sig(3) + [_PTR], "lh_g2_dbl": _sig(2) + [_PTR],
                 "lh_miller_chain": [_PTR] * 7 + [_INT] * 2 + [_PTR, _INT, _PTR, _PTR],
                 "lh_curve_empty": _sig(1), "lh_miller_empty": _sig(1)},
    "fp_pow": {"lh_fp_inv": _sig(2), "lh_fp_pow": _sig(3, 3), "lh_fp2_pow": _sig(3, 3),
               "lh_fp_inv_empty": _sig(1), "lh_fp_pow_empty": _sig(1),
               "lh_fp2_pow_empty": _sig(1)},
}

_LIBS: dict = {}
BUILD_SECONDS: dict = {}
_RESOLVED: set = set()      # sources whose provenance this process has recorded


def _resolved(name: str, event: str, **args) -> None:
    """Record how `name`'s library came to be, once a process."""
    if name not in _RESOLVED:
        _RESOLVED.add(name)
        compile_events.record(event, source=name, **args)


def _k3_plan_header() -> str:
    from . import fused     # imports this module: bound at call time
    return fused.k3_plan_header()


def _k5_plan_header() -> str:
    from . import fused
    return fused.k5_plan_header()


# Headers generated from Python per source: name -> {file name: text maker}.
GENERATED = {"fp12_op": {"k3_plan.h": _k3_plan_header},
             "curve_op": {"curve_plan.h": _k5_plan_header}}


def nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _generated(name: str) -> dict:
    return {file: make() for file, make in GENERATED.get(name, {}).items()}


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for path in (CSRC / "fp.cuh", CSRC / f"{name}.cu"):
        h.update(path.read_bytes())
    for file, text in sorted(_generated(name).items()):
        h.update(file.encode() + text.encode())
    h.update(" ".join(ARCH_FLAGS + FLAGS).encode())
    return h.hexdigest()[:16]


def _target(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def build_all() -> dict:
    """Compile every source that has no up-to-date library, in parallel.
    Returns {name: seconds} for the sources built now; the ptxas report of
    each build (registers, spills) is kept beside it as ``<lib>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in SOURCES:
        target = _target(name)
        if target.exists():
            _resolved(name, "kernel_cache_hit")
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        gen = target.with_suffix(".gen")
        gen.mkdir(exist_ok=True)
        for file, text in _generated(name).items():
            (gen / file).write_text(text)
        log = open(target.with_suffix(".log"), "w")
        cmd = ([nvcc()] + ARCH_FLAGS + FLAGS
               + ["-I", str(gen), "-o", str(tmp), str(CSRC / f"{name}.cu")])
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp, target, log)
    failed = []
    for name, (proc, tmp, target, log) in procs.items():
        rc = proc.wait()
        log.close()
        BUILD_SECONDS[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{name} (see {target.with_suffix('.log')})")
        else:
            os.replace(tmp, target)
            _resolved(name, "kernel_build", seconds=BUILD_SECONDS[name])
    if failed:
        raise RuntimeError("nvcc failed: " + ", ".join(failed))
    return {name: BUILD_SECONDS[name] for name in procs}


def ptxas_report(name: str) -> str:
    """The ptxas lines (registers, spill stores/loads) of a built library."""
    log = _target(name).with_suffix(".log")
    if not log.exists():
        return ""
    keep = ("Compiling entry", "registers", "spill")
    return "\n".join(line.strip() for line in log.read_text().splitlines()
                     if any(k in line for k in keep))


def library(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        target = _target(name)
        if not target.exists():
            build_all()
        _resolved(name, "kernel_cache_hit")
        lib = ctypes.CDLL(str(target))
        for fn_name, argtypes in ENTRY_POINTS[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib
