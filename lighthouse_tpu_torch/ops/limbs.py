"""Fp in the batch-minor layout: ``(..., 12, n)`` int32 tensors holding the
32-bit limbs of x * 2^384 mod p, canonical in [0, p).

Counterparts: ``lighthouse_tpu/ops/limbs.py`` (batch-major, 48 f32 digits
on the last axis) and ``lighthouse_tpu/ops/bm/limbs.py`` (batch-minor,
digits at axis -2). The JAX values are plain (not Montgomery) and only
loose-canonical, in [0, 2^384); the port's are Montgomery and canonical, so
equality is limb equality and comparisons with JAX go through integers mod
p (``convert.to_ints``).

The products are the K1 kernel (``fused.fp_mul``); additions, subtractions,
negations and small multiples are the K4 kernel (``fused.fp_add`` ..., one-row
plans of its linear combinations, ``fused.fp_lincomb``, which the tower and
curve steps call with a whole step's sums), whose operands may broadcast;
the inverse and a public-exponent power are the K7 kernel
(``fused.fp_inv``, ``fused.fp_pow``). All return canonical values.
"""

from functools import lru_cache

import numpy as np
import torch

from ..crypto.bls.constants import P
from . import fused

L = 12
R = 1 << 384
R_MOD_P = R % P
R_INV = pow(R, -1, P)
DTYPE = torch.int32


def default_device(device=None) -> torch.device:
    """Entry points take device=None, meaning the card. Without a card that
    raises: the port never drops to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "lighthouse_tpu_torch: no CUDA device; pass device='cpu' to run "
                "the plain PyTorch versions of the kernels")
        return torch.device("cuda")
    return torch.device(device)


# --- Host staging -----------------------------------------------------------


def ints_to_limbs_np(xs) -> np.ndarray:
    """Python ints -> (12, n) int32 Montgomery limbs (numpy)."""
    buf = b"".join((x * R_MOD_P % P).to_bytes(4 * L, "little") for x in xs)
    arr = np.frombuffer(buf, dtype="<i4").reshape(-1, L)
    return arr.T.copy()


def ints_to_limbs(xs, device) -> torch.Tensor:
    return torch.from_numpy(ints_to_limbs_np(list(xs))).to(device)


def limbs_to_ints(v) -> list:
    """(..., 12, n) limbs -> flat list of standard-form ints (trailing batch
    axis fastest within each leading index)."""
    arr = np.moveaxis(v.detach().cpu().numpy().astype("<i4"), -2, -1)
    rows = np.ascontiguousarray(arr).reshape(-1, L)
    return [int.from_bytes(r.tobytes(), "little") * R_INV % P for r in rows]


class _Consts:
    def __init__(self, device):
        self.zero = torch.zeros((L, 1), dtype=DTYPE, device=device)
        self.one = ints_to_limbs([1], device)            # Montgomery 1
        self.raw_one = torch.zeros((L, 1), dtype=DTYPE, device=device)
        self.raw_one[0, 0] = 1                            # 2^-384 * R: de-Montgomery


@lru_cache(maxsize=None)
def consts(device) -> _Consts:
    return _Consts(torch.device(device))


def zero(device):
    return consts(device).zero


def one(device):
    return consts(device).one


# --- Modular addition (K4) -------------------------------------------------

add = fused.fp_add
sub = fused.fp_sub
neg = fused.fp_neg
mul_small = fused.fp_mul_small


# --- Products (K1) ----------------------------------------------------------


def _pair(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return a.contiguous(), b.contiguous()


def mul(a, b):
    return fused.fp_mul(*_pair(a, b))


def sqr(a):
    return fused.fp_sqr(a.contiguous())


# --- Canonical form & comparisons ------------------------------------------


def canonicalize(a):
    """Standard-form canonical limbs of the value (a * 2^-384 on the stored
    Montgomery form): the port's counterpart of limbs.canonicalize, whose
    output is the value's unique digits in [0, p)."""
    raw_one = consts(a.device).raw_one
    return mul(a, raw_one.expand_as(a))


def is_zero(a):
    return torch.all(a == 0, dim=-2)


def eq(a, b):
    return torch.all(a == b, dim=-2)


def select(mask, a, b):
    """mask (..., n) bool -> limbwise select over (..., 12, n)."""
    return torch.where(mask.unsqueeze(-2), a, b)


def tree_reduce(vals, combine, identity, axis_size: int):
    """Reduce along the LEADING axis in log2 depth (the K/pubkey axis),
    padding with `identity` broadcast to one slice."""
    n = 1
    while n < axis_size:
        n *= 2
    if n != axis_size:
        pad = identity.expand((n - axis_size,) + vals.shape[1:])
        vals = torch.cat([vals, pad], dim=0)
    while n > 1:
        half = n // 2
        vals = combine(vals[:half], vals[half:])
        n = half
    return vals[0]


def tree_reduce_minor(vals, combine, identity, axis_size: int):
    """Reduce (..., n) along the trailing batch axis in log2 depth, padding
    with `identity` (trailing dim 1). Keeps a trailing batch axis of 1."""
    n = 1
    while n < axis_size:
        n *= 2
    if n != axis_size:
        pad = identity.expand(vals.shape[:-1] + (n - axis_size,))
        vals = torch.cat([vals, pad], dim=-1)
    while n > 1:
        half = n // 2
        vals = combine(vals[..., :half], vals[..., half:])
        n = half
    return vals


def pow_fixed(a, exponent: int):
    """a^exponent for a public exponent (ops/bm/limbs.py pow_fixed): K7, one
    launch (fused.fp_pow)."""
    return fused.fp_pow(a.contiguous(), exponent)


def inv(a):
    """a^-1, the value a^(p-2) takes (zero maps to zero): K7's binary GCD, one
    launch (fused.fp_inv)."""
    return fused.fp_inv(a.contiguous())
