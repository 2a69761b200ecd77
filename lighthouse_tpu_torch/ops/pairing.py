"""Optimal ate pairing in the batch-minor layout.

Counterparts: ``lighthouse_tpu/ops/bm/pairing.py`` (followed step for step)
and ``lighthouse_tpu/ops/pairing.py`` (batch-major; its derivation comments
are authoritative): projective, inversion-free doubling and addition steps
with lines homogenized by the Fp factor pz, a Miller loop over |x|, and the
x-chain final exponentiation. Pairs ride the minor axis: P (..., 3, 12, n),
Q (..., 3, 2, 12, n); the per-pair Miller values are multiplied together
along the minor axis into ONE final exponentiation.

Every Miller step is one K3 square and one K3 sparse-line product; the
final exponentiation is K3 squares and products.
"""

import torch

from ..crypto.bls.constants import BLS_X_ABS, P, R
from . import curves as cv
from . import limbs as lb
from . import tower as tw

# Doubling runs of the Miller loop over the bits of |x|, each followed by
# an addition step, then trailing doublings (ops/pairing.py:45-53).
_DBL_RUNS = []
_count = 0
for _c in bin(BLS_X_ABS)[3:]:
    _count += 1
    if _c == "1":
        _DBL_RUNS.append(_count)
        _count = 0
_TAIL_DBLS = _count

# Hard-part decomposition (ops/pairing.py:205-217): with x the (negative)
# BLS parameter and e = (x - 1)^2 / 3,
#     (p^4 - p^2 + 1) / r = e (x + p) (x^2 + p^2 - 1) + 1.
_X = -BLS_X_ABS
_E_EXP = (_X - 1) ** 2 // 3
if _E_EXP * (_X + P) * (_X * _X + P * P - 1) + 1 != (P**4 - P**2 + 1) // R:
    raise AssertionError("final exponentiation chain does not match the hard part")


def _dbl_step(t, px, py, pz):
    """2T and the line through T tangent at T, evaluated at P."""
    X, Y, Z = cv.G2.coords(t)
    m1 = tw.fp2_mul(torch.stack([Y, Y, Z, X, X], dim=-4),
                    torch.stack([Y, Z, Z, Y, X], dim=-4))
    Y2, YZ, Z2, XY, X2 = (m1.select(-4, i) for i in range(5))

    t2b = cv._b3_g2(Z2)
    z8 = lb.mul_small(Y2, 8)
    y3s = lb.add(Y2, t2b)
    t0p = lb.sub(Y2, lb.mul_small(t2b, 3))

    m2 = tw.fp2_mul(torch.stack([t2b, YZ, t0p, t0p, X2, YZ, Y2, X2], dim=-4),
                    torch.stack([z8, z8, y3s, XY, X, Z, Z, Z], dim=-4))
    q0, q1, q2, q3, X3c, YZ2, Y2Z, X2Z = (m2.select(-4, i) for i in range(8))

    t_next = cv.G2.pack(lb.add(q3, q3), lb.add(q0, q2), q1)

    l1_raw = lb.sub(lb.mul_small(X3c, 3), lb.add(Y2Z, Y2Z))
    two_yz2 = lb.add(YZ2, YZ2)
    scaled = tw.fp2_mul_fp(
        torch.stack([tw.fp2_mul_by_xi(two_yz2), lb.mul_small(X2Z, 3), l1_raw], dim=-4),
        torch.stack([py, px, pz], dim=-3))
    l0 = scaled.select(-4, 0)
    l2 = lb.neg(scaled.select(-4, 1))
    l1 = scaled.select(-4, 2)
    return t_next, (l0, l1, l2)


def _add_step(t, q, px, py, pz):
    """T + Q and the line through T and Q, evaluated at P."""
    X1, Y1, Z1 = cv.G2.coords(t)
    xq, yq, zq = cv.G2.coords(q)
    m1 = tw.fp2_mul(torch.stack([yq, xq, Y1, X1], dim=-4),
                    torch.stack([Z1, Z1, zq, zq], dim=-4))
    n = lb.sub(m1.select(-4, 0), m1.select(-4, 2))
    d = lb.sub(m1.select(-4, 1), m1.select(-4, 3))
    m2 = tw.fp2_mul(torch.stack([d, n, n, d], dim=-4),
                    torch.stack([Z1, X1, Z1, Y1], dim=-4))
    dZ1, nX1, nZ1, dY1 = (m2.select(-4, i) for i in range(4))
    scaled = tw.fp2_mul_fp(
        torch.stack([tw.fp2_mul_by_xi(dZ1), nZ1, lb.sub(nX1, dY1)], dim=-4),
        torch.stack([py, px, pz], dim=-3))
    l0 = scaled.select(-4, 0)
    l2 = lb.neg(scaled.select(-4, 1))
    l1 = scaled.select(-4, 2)
    return cv.G2.add(t, q), (l0, l1, l2)


def miller_loop_proj(p_proj, q_proj):
    """p (..., 3, 12, n), q (..., 3, 2, 12, n) -> f (..., 2, 3, 2, 12, n)."""
    px, py, pz = p_proj.select(-3, 0), p_proj.select(-3, 1), p_proj.select(-3, 2)
    one = tw.consts(p_proj.device).fp12_one
    acc = one.expand(px.shape[:-2] + one.shape[:-1] + px.shape[-1:]).contiguous()
    t = q_proj

    def dbl(acc, t):
        acc = tw.fp12_sqr(acc)
        t, (l0, l1, l2) = _dbl_step(t, px, py, pz)
        return tw.fp12_mul_sparse_line(acc, l0, l1, l2), t

    for run in _DBL_RUNS:
        for _ in range(run):
            acc, t = dbl(acc, t)
        t, (l0, l1, l2) = _add_step(t, q_proj, px, py, pz)
        acc = tw.fp12_mul_sparse_line(acc, l0, l1, l2)
    for _ in range(_TAIL_DBLS):
        acc, t = dbl(acc, t)
    return tw.fp12_conj(acc)


def _fp12_pow_abs(f, k: int):
    acc = f
    for c in bin(k)[3:]:
        acc = tw.fp12_sqr(acc)
        if c == "1":
            acc = tw.fp12_mul(acc, f)
    return acc


def final_exponentiation(f):
    """f^((p^12 - 1) / r): easy part, then the x-chain hard part
    (ops/bm/pairing.final_exponentiation)."""
    t = tw.fp12_mul(tw.fp12_conj(f), tw.fp12_inv(f))
    t = tw.fp12_mul(tw.fp12_frob_n(t, 2), t)
    g1 = _fp12_pow_abs(t, _E_EXP)
    g2 = tw.fp12_mul(tw.fp12_conj(_fp12_pow_abs(g1, BLS_X_ABS)), tw.fp12_frob(g1))
    g2x2 = _fp12_pow_abs(_fp12_pow_abs(g2, BLS_X_ABS), BLS_X_ABS)
    g3 = tw.fp12_mul(tw.fp12_mul(g2x2, tw.fp12_frob_n(g2, 2)), tw.fp12_conj(g2))
    return tw.fp12_mul(g3, t)


def multi_pairing_product_proj(p_proj, q_proj, mask):
    """prod_{i: mask} e(P_i, Q_i) with the pair axis minor: p (3, 12, n),
    q (3, 2, 12, n), mask (n,) -> the final-exponentiated Fp12 with a
    trailing batch axis of 1. (Returns a value, not a verdict: see
    multi_pairing_check.)"""
    f = miller_loop_proj(p_proj, q_proj)
    one = tw.consts(f.device).fp12_one
    f = torch.where(mask, f, one)
    prod = lb.tree_reduce_minor(f, tw.fp12_mul, one, f.shape[-1])
    return final_exponentiation(prod)


def multi_pairing_check(p_proj, q_proj, mask):
    """prod_{i: mask} e(P_i, Q_i) == 1 -> () bool tensor."""
    return tw.fp12_is_one(multi_pairing_product_proj(p_proj, q_proj, mask))[..., 0]
