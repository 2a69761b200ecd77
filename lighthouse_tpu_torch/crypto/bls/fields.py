"""Field tower arithmetic for BLS12-381 (pure-Python reference oracle).

This module is the CPU *oracle*: a deliberately simple, obviously-correct
implementation over Python bignums. It is the differential-testing ground truth
for the port's limb tensors in ``lighthouse_tpu_torch.ops``, and the host
arithmetic behind staging, signing and the Frobenius constants.

A copy of ``lighthouse_tpu/crypto/bls/fields.py``: the port imports nothing of
the JAX package.

The reference client gets this functionality from the blst native library
(reference: crypto/bls/src/impls/blst.rs — field/curve/pairing ops live in
assembly behind the `blst` crate). We re-implement from the public spec rather
than translating.

Representations (all immutable):
    Fp   : int in [0, P)
    Fp2  : (int, int)                       a0 + a1*u,  u^2 = -1
    Fp6  : (Fp2, Fp2, Fp2)                  a0 + a1*v + a2*v^2,  v^3 = xi = 1+u
    Fp12 : (Fp6, Fp6)                       a0 + a1*w,  w^2 = v
"""

from .constants import P

# ---------------------------------------------------------------------------
# Fp
# ---------------------------------------------------------------------------

def fp_add(a, b):
    return (a + b) % P


def fp_sub(a, b):
    return (a - b) % P


def fp_mul(a, b):
    return (a * b) % P


def fp_neg(a):
    return (-a) % P


def fp_inv(a):
    if a == 0:
        raise ZeroDivisionError("inverse of 0 in Fp")
    return pow(a, P - 2, P)


def fp_sqrt(a):
    """Square root in Fp (p ≡ 3 mod 4), or None if a is not a square."""
    c = pow(a, (P + 1) // 4, P)
    return c if c * c % P == a else None


def fp_sgn0(a):
    return a & 1


# ---------------------------------------------------------------------------
# Fp2 = Fp[u] / (u^2 + 1)
# ---------------------------------------------------------------------------

FP2_ZERO = (0, 0)
FP2_ONE = (1, 0)

def fp2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fp2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fp2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def fp2_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = a0 * b0
    t1 = a1 * b1
    # (a0+a1 u)(b0+b1 u) = (a0b0 - a1b1) + (a0b1 + a1b0) u
    return ((t0 - t1) % P, ((a0 + a1) * (b0 + b1) - t0 - t1) % P)


def fp2_sqr(a):
    a0, a1 = a
    # (a0 + a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u
    return ((a0 + a1) * (a0 - a1) % P, 2 * a0 * a1 % P)


def fp2_mul_scalar(a, k):
    return (a[0] * k % P, a[1] * k % P)


def fp2_conj(a):
    return (a[0], (-a[1]) % P)


def fp2_inv(a):
    a0, a1 = a
    norm = (a0 * a0 + a1 * a1) % P
    if norm == 0:
        raise ZeroDivisionError("inverse of 0 in Fp2")
    ninv = pow(norm, P - 2, P)
    return (a0 * ninv % P, (-a1) * ninv % P)


def fp2_pow(a, e):
    result = FP2_ONE
    base = a
    while e > 0:
        if e & 1:
            result = fp2_mul(result, base)
        base = fp2_sqr(base)
        e >>= 1
    return result


def fp2_is_zero(a):
    return a[0] == 0 and a[1] == 0


def fp2_sgn0(a):
    """RFC 9380 §4.1 sgn0 for m=2 fields."""
    sign_0 = a[0] & 1
    zero_0 = a[0] == 0
    sign_1 = a[1] & 1
    return sign_0 | (zero_0 & sign_1)


def fp2_is_square(a):
    """a is a square in Fp2 iff its norm is a square in Fp."""
    if fp2_is_zero(a):
        return True
    norm = (a[0] * a[0] + a[1] * a[1]) % P
    return pow(norm, (P - 1) // 2, P) == 1


# Tonelli–Shanks setup for Fp2: q - 1 = 2^s * m with q = p^2.
_Q = P * P
_S = 3                      # v2(p^2 - 1): p ≡ 11 (mod 16) → v2(p-1)=1, v2(p+1)=2
_M = (_Q - 1) >> _S
assert _M << _S == _Q - 1 and _M & 1 == 1
# Quadratic non-residue in Fp2: 1 + u (its norm 2 is a non-residue mod p since
# p ≡ 3 mod 8).
_QNR = (1, 1)
_Z_TS = fp2_pow(_QNR, _M)   # generator of the 2-Sylow subgroup


def fp2_sqrt(a):
    """Tonelli–Shanks square root in Fp2; returns None for non-squares.

    Either root may be returned; callers select the sign they need (RFC 9380
    sgn0 correction / ZCash compressed-point sign bit).
    """
    if fp2_is_zero(a):
        return FP2_ZERO
    if not fp2_is_square(a):
        return None
    c = _Z_TS
    t = fp2_pow(a, _M)
    r = fp2_pow(a, (_M + 1) >> 1)
    m = _S
    while t != FP2_ONE:
        # find least i with t^(2^i) == 1
        i = 0
        t2 = t
        while t2 != FP2_ONE:
            t2 = fp2_sqr(t2)
            i += 1
        b = c
        for _ in range(m - i - 1):
            b = fp2_sqr(b)
        c = fp2_sqr(b)
        t = fp2_mul(t, c)
        r = fp2_mul(r, b)
        m = i
    assert fp2_sqr(r) == a
    return r


# ---------------------------------------------------------------------------
# Fp6 = Fp2[v] / (v^3 - xi), xi = 1 + u
# ---------------------------------------------------------------------------

XI = (1, 1)

FP6_ZERO = (FP2_ZERO, FP2_ZERO, FP2_ZERO)
FP6_ONE = (FP2_ONE, FP2_ZERO, FP2_ZERO)


def _mul_by_xi(a):
    # (a0 + a1 u) * (1 + u) = (a0 - a1) + (a0 + a1) u
    return ((a[0] - a[1]) % P, (a[0] + a[1]) % P)


def fp6_add(a, b):
    return (fp2_add(a[0], b[0]), fp2_add(a[1], b[1]), fp2_add(a[2], b[2]))


def fp6_sub(a, b):
    return (fp2_sub(a[0], b[0]), fp2_sub(a[1], b[1]), fp2_sub(a[2], b[2]))


def fp6_neg(a):
    return (fp2_neg(a[0]), fp2_neg(a[1]), fp2_neg(a[2]))


def fp6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = fp2_mul(a0, b0)
    t1 = fp2_mul(a1, b1)
    t2 = fp2_mul(a2, b2)
    c0 = fp2_add(t0, _mul_by_xi(fp2_sub(fp2_mul(fp2_add(a1, a2), fp2_add(b1, b2)), fp2_add(t1, t2))))
    c1 = fp2_add(fp2_sub(fp2_mul(fp2_add(a0, a1), fp2_add(b0, b1)), fp2_add(t0, t1)), _mul_by_xi(t2))
    c2 = fp2_add(fp2_sub(fp2_mul(fp2_add(a0, a2), fp2_add(b0, b2)), fp2_add(t0, t2)), t1)
    return (c0, c1, c2)


def fp6_sqr(a):
    return fp6_mul(a, a)


def fp6_mul_by_v(a):
    # v * (a0 + a1 v + a2 v^2) = xi*a2 + a0 v + a1 v^2
    return (_mul_by_xi(a[2]), a[0], a[1])


def fp6_inv(a):
    a0, a1, a2 = a
    c0 = fp2_sub(fp2_sqr(a0), _mul_by_xi(fp2_mul(a1, a2)))
    c1 = fp2_sub(_mul_by_xi(fp2_sqr(a2)), fp2_mul(a0, a1))
    c2 = fp2_sub(fp2_sqr(a1), fp2_mul(a0, a2))
    t = fp2_add(_mul_by_xi(fp2_add(fp2_mul(a2, c1), fp2_mul(a1, c2))), fp2_mul(a0, c0))
    tinv = fp2_inv(t)
    return (fp2_mul(c0, tinv), fp2_mul(c1, tinv), fp2_mul(c2, tinv))


# ---------------------------------------------------------------------------
# Fp12 = Fp6[w] / (w^2 - v)
# ---------------------------------------------------------------------------

FP12_ONE = (FP6_ONE, FP6_ZERO)
FP12_ZERO = (FP6_ZERO, FP6_ZERO)


def fp12_add(a, b):
    return (fp6_add(a[0], b[0]), fp6_add(a[1], b[1]))


def fp12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = fp6_mul(a0, b0)
    t1 = fp6_mul(a1, b1)
    c0 = fp6_add(t0, fp6_mul_by_v(t1))
    c1 = fp6_sub(fp6_mul(fp6_add(a0, a1), fp6_add(b0, b1)), fp6_add(t0, t1))
    return (c0, c1)


def fp12_sqr(a):
    return fp12_mul(a, a)


def fp12_conj(a):
    """Conjugation a0 - a1 w = a^(p^6) (the 'easy' Frobenius)."""
    return (a[0], fp6_neg(a[1]))


def fp12_inv(a):
    a0, a1 = a
    t = fp6_sub(fp6_sqr(a0), fp6_mul_by_v(fp6_sqr(a1)))
    tinv = fp6_inv(t)
    return (fp6_mul(a0, tinv), fp6_neg(fp6_mul(a1, tinv)))


def fp12_pow(a, e):
    if e < 0:
        return fp12_pow(fp12_inv(a), -e)
    result = FP12_ONE
    base = a
    while e > 0:
        if e & 1:
            result = fp12_mul(result, base)
        base = fp12_sqr(base)
        e >>= 1
    return result


# --- Frobenius ----------------------------------------------------------------
# Coefficients computed at import time from first principles (no memorized
# tables): gamma_1[j] = xi^(j*(p-1)/6) governs w^j under x -> x^p.

_GAMMA1 = [fp2_pow(XI, j * (P - 1) // 6) for j in range(6)]


def fp2_frob(a, power=1):
    return a if power % 2 == 0 else fp2_conj(a)


def fp12_frob(a):
    """a -> a^p on Fp12."""
    (c0, c1, c2), (d0, d1, d2) = a
    # Fp6 part (coefficients of 1, v, v^2 = w^0, w^2, w^4)
    e0 = fp2_conj(c0)
    e1 = fp2_mul(fp2_conj(c1), _GAMMA1[2])
    e2 = fp2_mul(fp2_conj(c2), _GAMMA1[4])
    # w part (coefficients of w, w^3, w^5)
    f0 = fp2_mul(fp2_conj(d0), _GAMMA1[1])
    f1 = fp2_mul(fp2_conj(d1), _GAMMA1[3])
    f2 = fp2_mul(fp2_conj(d2), _GAMMA1[5])
    return ((e0, e1, e2), (f0, f1, f2))


def fp12_frob_n(a, n):
    for _ in range(n % 12):
        a = fp12_frob(a)
    return a
