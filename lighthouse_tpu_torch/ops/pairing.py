"""Optimal ate pairing in the batch-minor layout.

Counterparts: ``lighthouse_tpu/ops/bm/pairing.py`` (followed step for step)
and ``lighthouse_tpu/ops/pairing.py`` (batch-major; its derivation comments
are authoritative): projective, inversion-free doubling and addition steps
with lines homogenized by the Fp factor pz, a Miller loop over |x|, and the
x-chain final exponentiation. Pairs ride the minor axis: P (..., 3, 12, n),
Q (..., 3, 2, 12, n); the per-pair Miller values are multiplied together
along the minor axis into ONE final exponentiation.

Every Miller step is one K6 launch (the G2 doubling or addition with its
line evaluated at P) and one K3 sparse-line product, a doubling step also
one K3 square; the final exponentiation is K3 squares and products. K6's
plain versions (``_dbl_step_plain`` / ``_add_step_plain``) are the step
formulas on the plain versions of the field kernels, which the CPU takes.
"""

import torch

from ..crypto.bls.constants import BLS_X_ABS, P, R
from . import curves as cv
from . import fused
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


def _dbl_step_plain(t, px, py, pz):
    """K6's plain version of the doubling step (ops/bm/pairing.py:24): 2T
    and the line through T tangent at T, evaluated at P, stacked (l0, l1,
    l2) -> (..., 3, 2, 12, n), on the plain versions of the field kernels."""
    f, g = cv.FP2_PLAIN, cv.FP_PLAIN
    X, Y, Z = cv.G2.coords(t)
    Y2, YZ, Z2, XY, X2 = f.mul_many([Y, Y, Z, X, X], [Y, Z, Z, Y, X])

    t2b = cv._b3_g2(Z2, 3, f)
    z8 = f.mul_small(Y2, 8)
    y3s = f.add(Y2, t2b)
    t0p = f.sub(Y2, f.mul_small(t2b, 3))

    q0, q1, q2, q3, X3c, YZ2, Y2Z, X2Z = f.mul_many(
        [t2b, YZ, t0p, t0p, X2, YZ, Y2, X2], [z8, z8, y3s, XY, X, Z, Z, Z])

    t_next = cv.G2.pack(f.add(q3, q3), f.add(q0, q2), q1)

    l1_raw = f.sub(f.mul_small(X3c, 3), f.add(Y2Z, Y2Z))
    two_yz2 = f.add(YZ2, YZ2)
    l0, l2, l1 = _times_p(g, [_mul_by_xi(f, two_yz2), f.mul_small(X2Z, 3), l1_raw],
                          [py, px, pz])
    return _with_line(t_next, l0, l1, g.neg(l2))


def _add_step_plain(t, q, px, py, pz):
    """K6's plain version of the addition step (ops/bm/pairing.py:63): T + Q
    and the line through T and Q, evaluated at P, stacked as in
    _dbl_step_plain."""
    f, g = cv.FP2_PLAIN, cv.FP_PLAIN
    X1, Y1, Z1 = cv.G2.coords(t)
    xq, yq, zq = cv.G2.coords(q)
    a, b, c, d = f.mul_many([yq, xq, Y1, X1], [Z1, Z1, zq, zq])
    n, d = f.sub(a, c), f.sub(b, d)
    dZ1, nX1, nZ1, dY1 = f.mul_many([d, n, n, d], [Z1, X1, Z1, Y1])
    l0, l2, l1 = _times_p(g, [_mul_by_xi(f, dZ1), nZ1, f.sub(nX1, dY1)], [py, px, pz])
    return _with_line(cv.G2._add_plain(t, q), l0, l1, g.neg(l2))


def _with_line(t_next, l0, l1, l2):
    """(the point, the line stacked), both of the shape K6 writes: the
    point broadcast over P's leading axes as the line is."""
    line = torch.stack(torch.broadcast_tensors(l0, l1, l2), dim=-4)
    return t_next.expand(line.shape).contiguous(), line


def _mul_by_xi(f, a):
    a0, a1 = a[..., 0, :, :], a[..., 1, :, :]
    return torch.stack([f.sub(a0, a1), f.add(a0, a1)], dim=-3)


def _times_p(g, xs, ps):
    """Fp2 values times P's coordinates, one call of g's Fp product."""
    out = g.mul(torch.stack(torch.broadcast_tensors(*xs), dim=-4),
                torch.stack(torch.broadcast_tensors(*ps), dim=-3).unsqueeze(-3))
    return [out.select(-4, i) for i in range(len(xs))]


def _dbl_step(t, px, py, pz):
    """2T and the line through T tangent at T, evaluated at P, (..., 3, 2,
    12, n): one K6 launch on the card (fused.miller_dbl)."""
    return fused.miller_dbl(t, px, py, pz)


def _add_step(t, q, px, py, pz):
    """T + Q and the line through T and Q, evaluated at P: one K6 launch."""
    return fused.miller_add(t, q, px, py, pz)


def miller_loop_proj(p_proj, q_proj):
    """p (..., 3, 12, n), q (..., 3, 2, 12, n) -> f (..., 2, 3, 2, 12, n)."""
    return tw.fp12_conj(_miller_loop(p_proj, q_proj))


def _miller_loop(p_proj, q_proj):
    """miller_loop_proj before its conjugation (x < 0), which a product of
    Miller values takes once, after the product."""
    px, py, pz = p_proj.select(-3, 0), p_proj.select(-3, 1), p_proj.select(-3, 2)
    one = tw.consts(p_proj.device).fp12_one
    acc = one.expand(px.shape[:-2] + one.shape[:-1] + px.shape[-1:]).contiguous()
    t = q_proj

    def dbl(acc, t):
        acc = tw.fp12_sqr(acc)
        t, line = _dbl_step(t, px, py, pz)
        return tw.fp12_mul_line(acc, line), t

    for run in _DBL_RUNS:
        for _ in range(run):
            acc, t = dbl(acc, t)
        t, line = _add_step(t, q_proj, px, py, pz)
        acc = tw.fp12_mul_line(acc, line)
    for _ in range(_TAIL_DBLS):
        acc, t = dbl(acc, t)
    return acc


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
    f = _miller_loop(p_proj, q_proj)
    one = tw.consts(f.device).fp12_one
    f = torch.where(mask, f, one)
    prod = lb.tree_reduce_minor(f, tw.fp12_mul, one, f.shape[-1])
    # conj is a field automorphism (the p^6 Frobenius) and fixes 1: the
    # conjugate of the product is the product of miller_loop_proj's values.
    return final_exponentiation(tw.fp12_conj(prod))


def multi_pairing_check(p_proj, q_proj, mask):
    """prod_{i: mask} e(P_i, Q_i) == 1 -> () bool tensor."""
    return tw.fp12_is_one(multi_pairing_product_proj(p_proj, q_proj, mask))[..., 0]
