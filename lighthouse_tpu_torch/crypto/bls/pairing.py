"""Optimal ate pairing for BLS12-381 (pure-Python oracle).

e : G1 x G2 -> GT (subgroup of Fp12*). Implemented as a multi-Miller loop
(shared squarings across pairs, one final exponentiation) because that is the
exact shape batch signature verification needs — the reference's hot loop
`verify_multiple_aggregate_signatures` (crypto/bls/src/impls/blst.rs:113-115)
is precisely "n Miller loops + 1 final exp".

Conventions:
  * G2 points live on the M-twist E2'/Fp2: y^2 = x^3 + 4(u+1). The line
    function is computed in twist coordinates and embedded sparsely into Fp12
    via x = x' w^-2, y = y' w^-3 (w^6 = xi = 1+u). Subfield (Fp2) scale
    factors are dropped freely — the final exponentiation kills them.
  * The BLS parameter x is negative; the Miller value is conjugated at the end.

A copy of ``lighthouse_tpu/crypto/bls/pairing.py``: the port imports nothing of
the JAX package. The signature API's oracle backend pairs with it.
"""

from . import fields as f
from .constants import BLS_X_ABS, P, R
from .curves import FP2_OPS, from_jacobian, jac_add, jac_double, to_jacobian

# Exponent of the "hard part" of the final exponentiation.
_HARD_EXP = (P**4 - P**2 + 1) // R
assert (P**4 - P**2 + 1) % R == 0

_X_BITS = bin(BLS_X_ABS)[2:]


def _line(xt, yt, slope, px, py):
    """Sparse Fp12 element for the line through T (twist coords, slope in Fp2)
    evaluated at P = (px, py) in G1:  xi*py  +  (slope*xt - yt) w^3  -  slope*px w^5.
    """
    c00 = f.fp2_mul_scalar(f.XI, py)                       # w^0 coefficient
    c11 = f.fp2_sub(f.fp2_mul(slope, xt), yt)              # w^3 coefficient
    c12 = f.fp2_mul_scalar(f.fp2_neg(slope), px)           # w^5 coefficient
    return ((c00, f.FP2_ZERO, f.FP2_ZERO), (f.FP2_ZERO, c11, c12))


def _dbl_step(t, px, py):
    """Doubling step: line at 2T through T, and T <- 2T (affine twist coords)."""
    xt, yt = t
    slope = f.fp2_mul(f.fp2_mul_scalar(f.fp2_sqr(xt), 3), f.fp2_inv(f.fp2_mul_scalar(yt, 2)))
    line = _line(xt, yt, slope, px, py)
    x3 = f.fp2_sub(f.fp2_sqr(slope), f.fp2_mul_scalar(xt, 2))
    y3 = f.fp2_sub(f.fp2_mul(slope, f.fp2_sub(xt, x3)), yt)
    return (x3, y3), line


def _add_step(t, q, px, py):
    """Addition step: line through T and Q, and T <- T + Q."""
    xt, yt = t
    xq, yq = q
    slope = f.fp2_mul(f.fp2_sub(yq, yt), f.fp2_inv(f.fp2_sub(xq, xt)))
    line = _line(xt, yt, slope, px, py)
    x3 = f.fp2_sub(f.fp2_sub(f.fp2_sqr(slope), xt), xq)
    y3 = f.fp2_sub(f.fp2_mul(slope, f.fp2_sub(xt, x3)), yt)
    return (x3, y3), line


def multi_miller_loop(pairs):
    """Miller loop over [(P_g1_affine, Q_g2_twist_affine), ...], sharing the
    accumulator squaring across pairs. Infinity entries are skipped (their
    pairing contribution is 1)."""
    live = [(p, q) for p, q in pairs if p is not None and q is not None]
    if not live:
        return f.FP12_ONE
    ts = [q for _, q in live]
    acc = f.FP12_ONE
    for i, bit in enumerate(_X_BITS[1:]):
        acc = f.fp12_sqr(acc)
        for j, ((px, py), q) in enumerate(live):
            ts[j], line = _dbl_step(ts[j], px, py)
            acc = f.fp12_mul(acc, line)
        if bit == "1":
            for j, ((px, py), q) in enumerate(live):
                ts[j], line = _add_step(ts[j], q, px, py)
                acc = f.fp12_mul(acc, line)
    # x < 0: conjugate the Miller value.
    return f.fp12_conj(acc)


def final_exponentiation(fv):
    """f -> f^((p^12 - 1) / r)."""
    # Easy part: f^(p^6 - 1) then ^(p^2 + 1).
    t = f.fp12_mul(f.fp12_conj(fv), f.fp12_inv(fv))
    t = f.fp12_mul(f.fp12_frob_n(t, 2), t)
    # Hard part (oracle-grade generic exponentiation).
    return f.fp12_pow(t, _HARD_EXP)


def pairing(p_g1, q_g2):
    """Full pairing e(P, Q) with P in G1 (affine Fp pair), Q in G2 (affine
    twist coords). Callers must have validated subgroup membership."""
    return final_exponentiation(multi_miller_loop([(p_g1, q_g2)]))


def pairings_product_is_one(pairs) -> bool:
    """prod e(P_i, Q_i) == 1 — the core check of (batch) BLS verification."""
    return final_exponentiation(multi_miller_loop(pairs)) == f.FP12_ONE
