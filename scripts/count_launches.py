"""Count the port's kernel launches and the CUDA kernels a verify would run,
on the CPU.

    python scripts/count_launches.py [--sets 4] [--sites]

Runs a small batch verify (``backend.stage`` then ``backend.core``: sets of
two keys over two messages) and a two-blob KZG batch verify
(``verify_blob_kzg_proof_batch`` on a 16-element dev setup) through the
kernels' plain versions, and prints one JSON line each:

- ``wrapper_calls``: calls of each kernel wrapper (``fused._run`` and its
  siblings): on the card, one launch each. ``k4_family`` sums fp_add,
  fp_sub, fp_neg, fp_mul_small and fp_lincomb, ``k4_at_n`` by operand n
  (h2g2 runs at m, the final exponentiation at n = 1).
- ``cuda_kernels``: a count of the CUDA kernels the same calls would run
  on the card: one per wrapper call, plus every torch operator called
  outside a wrapper that is not a view, a reshape or an allocation
  (``stack``, ``cat``, ``clone``, ``where`` ...), top operators listed.
  It counts dispatches, not a trace: a card's trace (chip_smoke.py
  ``profile``) is the measurement; this is for comparing two trees.
- with ``--sites``, the wrapper calls by the port's call sites.

Compare two trees by running each tree's copy of this script. It imports
only the port (no JAX).
"""

import argparse
import collections
import json
import sys
import traceback
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from lighthouse_tpu_torch.crypto import kzg as tkzg  # noqa: E402
from lighthouse_tpu_torch.crypto.bls import api  # noqa: E402
from lighthouse_tpu_torch.ops import backend, fused  # noqa: E402

K4_FAMILY = ("fp_add", "fp_sub", "fp_neg", "fp_mul_small", "fp_lincomb")
# Operators that launch no CUDA kernel: views, reshapes, allocations, reads.
NO_KERNEL = {"view", "_unsafe_view", "select", "slice", "unsqueeze", "squeeze", "expand",
             "as_strided", "unbind", "split", "split_with_sizes", "t", "transpose", "permute",
             "alias", "detach", "empty", "empty_like", "empty_strided", "unflatten", "flatten",
             "reshape", "lift_fresh", "diagonal", "narrow", "movedim", "unfold", "chunk", "item",
             "_local_scalar_dense", "is_nonzero", "view_as", "new_empty", "new_empty_strided"}
RUNNERS = ("_run", "_run_additive", "_run_curve", "_run_miller", "_run_pow", "_run_lincomb")


class Counter(TorchDispatchMode):
    """Counts torch operators outside the kernel wrappers, and the wrappers'
    calls by kernel name, operand n and call site."""

    def __init__(self, sites: bool):
        super().__init__()
        self.depth, self.sites = 0, sites
        self.ops = collections.Counter()
        self.calls = collections.Counter()
        self.at_n = collections.Counter()
        self.where = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if self.depth == 0 and name not in NO_KERNEL:
            self.ops[name] += 1
        return func(*args, **(kwargs or {}))

    def wrap(self, runner: str):
        orig = getattr(fused, runner)

        def counted(*a, **k):
            if self.depth == 0:
                name, xs = ("fp_lincomb", a[0]) if runner == "_run_lincomb" else (
                    a[0], a[1] if runner != "_run" else a[1:])
                xs = xs if isinstance(xs, (tuple, list)) else (xs,)
                self.calls[name] += 1
                self.at_n[(name, xs[0].shape[-1])] += 1
                if self.sites:
                    frames = [f"{Path(f.filename).name}:{f.lineno}:{f.name}"
                              for f in traceback.extract_stack()[:-1]
                              if "lighthouse_tpu_torch" in f.filename
                              and not f.filename.endswith("fused.py")]
                    self.where[(name, " <- ".join(frames[-3:][::-1]))] += 1
            self.depth += 1
            try:
                return orig(*a, **k)
            finally:
                self.depth -= 1
        setattr(fused, runner, counted)
        return orig

    def report(self, what: str) -> dict:
        k4_at_n = collections.Counter()
        for (name, n), c in self.at_n.items():
            if name in K4_FAMILY:
                k4_at_n[n] += c
        out = {"what": what, "wrapper_calls": dict(sorted(self.calls.items())),
               "k4_family": sum(self.calls[k] for k in K4_FAMILY),
               "k4_at_n": dict(sorted(k4_at_n.items())),
               "cuda_kernels": sum(self.calls.values()) + sum(self.ops.values()),
               "torch_ops_outside_wrappers": dict(self.ops.most_common(12))}
        if self.sites:
            out["sites"] = {f"{k} {s}": c for (k, s), c in sorted(self.where.items())}
        return out


def _sets(count: int):
    out = []
    for i in range(count):
        sks = [api.SecretKey(1000 + i * 64 + j) for j in range(2)]
        msg = bytes([i % 2]) * 32
        agg = api.AggregateSignature.aggregate([sk.sign(msg) for sk in sks])
        out.append(api.SignatureSet(
            signature=api.Signature(point=agg.point, subgroup_checked=True),
            signing_keys=[sk.public_key() for sk in sks], message=msg))
    return out


def _kzg_batch():
    k = tkzg.Kzg.insecure_dev_setup(16)
    blobs = [b"".join(b"\x00" + bytes([(i * 16 + j) % 256]) * 31 for j in range(16))
             for i in (1, 2)]                  # 16 field elements below 2^248 each
    commitments = [k.blob_to_kzg_commitment(b) for b in blobs]
    proofs = [k.compute_blob_kzg_proof(b, c) for b, c in zip(blobs, commitments)]
    return k, blobs, commitments, proofs


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sets", type=int, default=4)
    ap.add_argument("--sites", action="store_true")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    cpu = torch.device("cpu")
    staged, m_bucket, checked = backend.stage(_sets(args.sets), cpu)
    k, blobs, commitments, proofs = _kzg_batch()
    runs = (("bls batch verify", lambda: bool(
                backend.core(*staged, m_bucket=m_bucket, all_checked=checked).item())),
            ("kzg batch verify", lambda: k.verify_blob_kzg_proof_batch(
                blobs, commitments, proofs, device="cpu")))
    for what, fn in runs:
        counter = Counter(args.sites)
        origs = {r: counter.wrap(r) for r in RUNNERS if hasattr(fused, r)}
        try:
            with counter:
                ok = fn()
        finally:
            for r, f in origs.items():
                setattr(fused, r, f)
        if ok is not True:
            raise AssertionError(f"{what} did not verify")
        print(json.dumps(counter.report(what)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
