"""Carry state across from the JAX package, by value.

The JAX engines store an Fp element as 48 float32 digits d_i (value
sum d_i 256^i, digits possibly signed and lazy, the value only
loose-canonical); the port stores 12 32-bit Montgomery limbs, canonical.
``from_jax_limbs`` turns the former into the latter through Python
integers mod p, and ``to_ints`` takes the port's tensors back to integers
mod p, the common ground of every comparison. Signature sets cross as wire
bytes: 48-byte compressed G1 keys, 96-byte compressed G2 signatures and the
32-byte message. A KZG setup crosses by value, as oracle points and
integers. Nothing on the port's main path uses this module.
"""

import numpy as np
import torch

from .crypto.bls import api
from .crypto.bls.constants import P
from .crypto.kzg import Kzg
from .ops import limbs as lb

JAX_DIGITS = 48


def _digits_to_ints(rows: np.ndarray) -> list:
    """(m, 48) digits (float, any sign) -> ints mod p, exactly."""
    ints = np.rint(np.asarray(rows, dtype=np.float64)).astype(np.int64)
    weights = [1 << (8 * i) for i in range(ints.shape[1])]
    return [sum(int(d) * w for d, w in zip(row, weights)) % P for row in ints]


def from_jax_limbs(np_digits, layout: str = "bm", device="cpu") -> torch.Tensor:
    """JAX limb digits -> the port's limb tensor.

    layout "bm":    (..., 48, n) batch-minor digits -> (..., 12, n).
    layout "major": (n, ..., 48) batch-major digits -> (..., 12, n): the
                    leading batch axis becomes the trailing one.
    """
    x = np.asarray(np_digits)
    if layout == "major":
        x = np.moveaxis(x, 0, -1)                   # (..., 48, n)
    elif layout != "bm":
        raise ValueError(f"unknown layout {layout!r}")
    if x.shape[-2] != JAX_DIGITS:
        raise ValueError(f"expected {JAX_DIGITS} digits on axis -2, got shape {x.shape}")
    lead, n = x.shape[:-2], x.shape[-1]
    rows = np.moveaxis(x, -2, -1).reshape(-1, JAX_DIGITS)
    limbs = lb.ints_to_limbs_np(_digits_to_ints(rows))      # (12, rows)
    out = limbs.T.reshape(lead + (n, lb.L))
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(out, -1, -2))).to(device)


def to_ints(t: torch.Tensor) -> list:
    """Port limb tensor (..., 12, n) -> flat list of ints mod p, trailing
    batch axis fastest (the order of ops/bm/limbs.bm_to_ints)."""
    return lb.limbs_to_ints(t)


def from_jax_signature_set(s) -> api.SignatureSet:
    """A JAX-package SignatureSet -> the port's, through wire bytes. The
    signature's subgroup-checked flag crosses as it is."""
    sig = api.Signature.from_bytes(s.signature.to_bytes(), subgroup_check=False)
    sig = api.Signature(point=sig.point, subgroup_checked=s.signature.subgroup_checked)
    keys = [api.PublicKey.from_bytes(pk.to_bytes()) for pk in s.signing_keys]
    return api.SignatureSet(signature=sig, signing_keys=keys, message=bytes(s.message))


def from_jax_kzg(kzg) -> Kzg:
    """A JAX-package Kzg -> the port's: its Lagrange G1 points, [tau]G2 and
    bit-reversed domain, copied as Python integers."""
    def g1(pt):
        return None if pt is None else (int(pt[0]), int(pt[1]))

    (x0, x1), (y0, y1) = kzg.g2_tau
    return Kzg([g1(pt) for pt in kzg.g1_lagrange],
               ((int(x0), int(x1)), (int(y0), int(y1))),
               [int(w) for w in kzg.domain])


def fp12_to_tuples(t: torch.Tensor) -> list:
    """(2, 3, 2, 12, n) -> n oracle Fp12 values (((c0, c1), ...), (...))."""
    n = t.shape[-1]
    flat = to_ints(t)                                   # (h, k, c) major, n fastest

    def at(h, k, c, i):
        return flat[((h * 3 + k) * 2 + c) * n + i]

    return [tuple(tuple((at(h, k, 0, i), at(h, k, 1, i)) for k in range(3))
                  for h in range(2)) for i in range(n)]


def fp12_from_tuples(vals, device="cpu") -> torch.Tensor:
    """n oracle Fp12 values -> (2, 3, 2, 12, n)."""
    coords = [lb.ints_to_limbs([v[h][k][c] for v in vals], device)
              for h in range(2) for k in range(3) for c in range(2)]
    return torch.stack(coords).reshape(2, 3, 2, lb.L, len(vals))
