"""G1/G2 elliptic-curve group operations for BLS12-381 (pure-Python oracle).

Jacobian-coordinate arithmetic written once, generically over a small field-ops
record, and instantiated for Fp (G1) and Fp2 (G2). Includes the ZCash
compressed serialization used by the consensus spec, infinity/subgroup
validation semantics matching the reference's blst backend
(reference: crypto/bls/src/impls/blst.rs:72-135 — signature subgroup checks on
deserialize; crypto/bls/src/generic_public_key.rs — infinity-pubkey rejection),
and the psi-endomorphism used for fast G2 subgroup checks / cofactor clearing.

A point is ``None`` (infinity) or a tuple ``(x, y)`` in affine coordinates;
Jacobian points are ``(X, Y, Z)`` with x = X/Z^2, y = Y/Z^3. Field elements are
ints (Fp) or 2-tuples (Fp2).

A copy of ``lighthouse_tpu/crypto/bls/curves.py``: the port imports nothing of
the JAX package.
"""

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

from . import fields as f
from .constants import (
    B1,
    B2,
    BLS_X_ABS,
    FLAG_COMPRESSED,
    FLAG_INFINITY,
    FLAG_SIGN,
    G1_GENERATOR_X,
    G1_GENERATOR_Y,
    G2_GENERATOR_X,
    G2_GENERATOR_Y,
    H_EFF_G2,
    P,
    R,
)


@dataclass(frozen=True)
class FieldOps:
    zero: Any
    one: Any
    add: Callable
    sub: Callable
    mul: Callable
    sqr: Callable
    neg: Callable
    inv: Callable
    is_zero: Callable
    mul_small: Callable        # multiply by a small int


FP_OPS = FieldOps(
    zero=0,
    one=1,
    add=f.fp_add,
    sub=f.fp_sub,
    mul=f.fp_mul,
    sqr=lambda a: a * a % P,
    neg=f.fp_neg,
    inv=f.fp_inv,
    is_zero=lambda a: a == 0,
    mul_small=lambda a, k: a * k % P,
)

FP2_OPS = FieldOps(
    zero=f.FP2_ZERO,
    one=f.FP2_ONE,
    add=f.fp2_add,
    sub=f.fp2_sub,
    mul=f.fp2_mul,
    sqr=f.fp2_sqr,
    neg=f.fp2_neg,
    inv=f.fp2_inv,
    is_zero=f.fp2_is_zero,
    mul_small=f.fp2_mul_scalar,
)


# ---------------------------------------------------------------------------
# Generic Jacobian arithmetic
# ---------------------------------------------------------------------------

def to_jacobian(pt, ops: FieldOps):
    if pt is None:
        return (ops.one, ops.one, ops.zero)
    return (pt[0], pt[1], ops.one)


def from_jacobian(jp, ops: FieldOps):
    X, Y, Z = jp
    if ops.is_zero(Z):
        return None
    zinv = ops.inv(Z)
    zinv2 = ops.sqr(zinv)
    return (ops.mul(X, zinv2), ops.mul(Y, ops.mul(zinv2, zinv)))


def jac_double(jp, ops: FieldOps):
    """dbl-2009-l formulas (a = 0 curves)."""
    X, Y, Z = jp
    if ops.is_zero(Z) or ops.is_zero(Y):
        return (ops.one, ops.one, ops.zero)
    A = ops.sqr(X)
    B = ops.sqr(Y)
    C = ops.sqr(B)
    D = ops.mul_small(ops.sub(ops.sub(ops.sqr(ops.add(X, B)), A), C), 2)
    E = ops.mul_small(A, 3)
    F = ops.sqr(E)
    X3 = ops.sub(F, ops.mul_small(D, 2))
    Y3 = ops.sub(ops.mul(E, ops.sub(D, X3)), ops.mul_small(C, 8))
    Z3 = ops.mul(ops.mul_small(Y, 2), Z)
    return (X3, Y3, Z3)


def jac_add(p1, p2, ops: FieldOps):
    """add-2007-bl with full special-case handling."""
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    if ops.is_zero(Z1):
        return p2
    if ops.is_zero(Z2):
        return p1
    Z1Z1 = ops.sqr(Z1)
    Z2Z2 = ops.sqr(Z2)
    U1 = ops.mul(X1, Z2Z2)
    U2 = ops.mul(X2, Z1Z1)
    S1 = ops.mul(ops.mul(Y1, Z2), Z2Z2)
    S2 = ops.mul(ops.mul(Y2, Z1), Z1Z1)
    if U1 == U2:
        if S1 == S2:
            return jac_double(p1, ops)
        return (ops.one, ops.one, ops.zero)
    H = ops.sub(U2, U1)
    I = ops.sqr(ops.mul_small(H, 2))
    J = ops.mul(H, I)
    rr = ops.mul_small(ops.sub(S2, S1), 2)
    V = ops.mul(U1, I)
    X3 = ops.sub(ops.sub(ops.sqr(rr), J), ops.mul_small(V, 2))
    Y3 = ops.sub(ops.mul(rr, ops.sub(V, X3)), ops.mul_small(ops.mul(S1, J), 2))
    Z3 = ops.mul(ops.sub(ops.sub(ops.sqr(ops.add(Z1, Z2)), Z1Z1), Z2Z2), H)
    return (X3, Y3, Z3)


def jac_neg(jp, ops: FieldOps):
    X, Y, Z = jp
    return (X, ops.neg(Y), Z)


def jac_mul(jp, k: int, ops: FieldOps):
    """Double-and-add scalar multiplication (oracle; not constant time)."""
    if k < 0:
        return jac_mul(jac_neg(jp, ops), -k, ops)
    acc = (ops.one, ops.one, ops.zero)
    add = jp
    while k:
        if k & 1:
            acc = jac_add(acc, add, ops)
        add = jac_double(add, ops)
        k >>= 1
    return acc


# ---------------------------------------------------------------------------
# Affine-level helpers per group
# ---------------------------------------------------------------------------

G1_GEN = (G1_GENERATOR_X, G1_GENERATOR_Y)
G2_GEN = (G2_GENERATOR_X, G2_GENERATOR_Y)


def g1_add(p1, p2):
    return from_jacobian(jac_add(to_jacobian(p1, FP_OPS), to_jacobian(p2, FP_OPS), FP_OPS), FP_OPS)


def g2_add(p1, p2):
    return from_jacobian(jac_add(to_jacobian(p1, FP2_OPS), to_jacobian(p2, FP2_OPS), FP2_OPS), FP2_OPS)


def g1_mul(pt, k):
    """Scalar multiplication with the scalar taken as-is (callers reduce if
    they mean a subgroup scalar; the subgroup check multiplies by R itself)."""
    return from_jacobian(jac_mul(to_jacobian(pt, FP_OPS), k, FP_OPS), FP_OPS)


def g2_mul(pt, k):
    return from_jacobian(jac_mul(to_jacobian(pt, FP2_OPS), k, FP2_OPS), FP2_OPS)


def g1_neg(pt):
    return None if pt is None else (pt[0], f.fp_neg(pt[1]))


def g2_neg(pt):
    return None if pt is None else (pt[0], f.fp2_neg(pt[1]))


def g1_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - (x * x * x + B1)) % P == 0


def g2_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return f.fp2_sub(f.fp2_sqr(y), f.fp2_add(f.fp2_mul(f.fp2_sqr(x), x), B2)) == f.FP2_ZERO


# ---------------------------------------------------------------------------
# psi endomorphism on E2 (untwist-Frobenius-twist) — used for fast subgroup
# checks and cofactor clearing. Constants derived at import from first
# principles: psi(x, y) = (c_x * conj(x), c_y * conj(y)) with
#   c_x = 1 / xi^((p-1)/3),   c_y = 1 / xi^((p-1)/2)
# for the M-twist with xi = 1 + u.
# ---------------------------------------------------------------------------

PSI_CX = f.fp2_inv(f.fp2_pow(f.XI, (P - 1) // 3))
PSI_CY = f.fp2_inv(f.fp2_pow(f.XI, (P - 1) // 2))


def g2_psi(pt):
    if pt is None:
        return None
    x, y = pt
    return (f.fp2_mul(PSI_CX, f.fp2_conj(x)), f.fp2_mul(PSI_CY, f.fp2_conj(y)))


def g1_in_subgroup(pt) -> bool:
    """Full-order check: r*P == O (oracle-grade; blst uses an endomorphism)."""
    if pt is None:
        return True
    return g1_is_on_curve(pt) and g1_mul(pt, R) is None


def g2_in_subgroup(pt) -> bool:
    """P in G2 iff psi(P) == x*P (Bowe's check, same boolean as blst's)."""
    if pt is None:
        return True
    if not g2_is_on_curve(pt):
        return False
    # x is negative: psi(P) == -|x|*P
    return g2_psi(pt) == g2_neg(g2_mul(pt, BLS_X_ABS))


def g2_clear_cofactor(pt):
    """Multiply by the effective cofactor h_eff (RFC 9380 §8.8.2).

    Tests cross-validate this against the psi-decomposition
    [x^2-x-1]P + [x-1]psi(P) + psi(psi(2P)).
    """
    return g2_mul(pt, H_EFF_G2)


# ---------------------------------------------------------------------------
# Serialization (ZCash compressed format, as used by the consensus spec and
# the reference's PUBLIC_KEY_BYTES_LEN/SIGNATURE_BYTES_LEN constants).
# ---------------------------------------------------------------------------

def _fp_is_lex_largest(y: int) -> bool:
    return y > (P - 1) // 2


def _fp2_is_lex_largest(y) -> bool:
    if y[1] != 0:
        return y[1] > (P - 1) // 2
    return y[0] > (P - 1) // 2


def g1_to_compressed(pt) -> bytes:
    if pt is None:
        out = bytearray(48)
        out[0] = FLAG_COMPRESSED | FLAG_INFINITY
        return bytes(out)
    x, y = pt
    out = bytearray(x.to_bytes(48, "big"))
    out[0] |= FLAG_COMPRESSED
    if _fp_is_lex_largest(y):
        out[0] |= FLAG_SIGN
    return bytes(out)


def g1_from_compressed(data: bytes):
    """Decompress a G1 point. Raises ValueError on malformed encodings.

    Performs the same structural checks as blst deserialize: on-curve is
    implied by construction, infinity must be canonical. Subgroup checking is
    the caller's job (it differs between pubkeys and signatures).
    """
    if len(data) != 48:
        raise ValueError("bad G1 length")
    flags = data[0]
    if not flags & FLAG_COMPRESSED:
        raise ValueError("uncompressed G1 not supported")
    if flags & FLAG_INFINITY:
        if flags & FLAG_SIGN or any(data[1:]) or data[0] != (FLAG_COMPRESSED | FLAG_INFINITY):
            raise ValueError("non-canonical G1 infinity")
        return None
    x = int.from_bytes(bytes([flags & 0x1F]) + data[1:], "big")
    if x >= P:
        raise ValueError("G1 x out of range")
    y2 = (x * x * x + B1) % P
    y = f.fp_sqrt(y2)
    if y is None:
        raise ValueError("G1 x not on curve")
    if _fp_is_lex_largest(y) != bool(flags & FLAG_SIGN):
        y = f.fp_neg(y)
    return (x, y)


def g2_to_compressed(pt) -> bytes:
    if pt is None:
        out = bytearray(96)
        out[0] = FLAG_COMPRESSED | FLAG_INFINITY
        return bytes(out)
    x, y = pt
    out = bytearray(x[1].to_bytes(48, "big") + x[0].to_bytes(48, "big"))
    out[0] |= FLAG_COMPRESSED
    if _fp2_is_lex_largest(y):
        out[0] |= FLAG_SIGN
    return bytes(out)


def g2_from_compressed(data: bytes):
    if len(data) != 96:
        raise ValueError("bad G2 length")
    flags = data[0]
    if not flags & FLAG_COMPRESSED:
        raise ValueError("uncompressed G2 not supported")
    if flags & FLAG_INFINITY:
        if flags & FLAG_SIGN or any(data[1:]) or data[0] != (FLAG_COMPRESSED | FLAG_INFINITY):
            raise ValueError("non-canonical G2 infinity")
        return None
    x1 = int.from_bytes(bytes([flags & 0x1F]) + data[1:48], "big")
    x0 = int.from_bytes(data[48:96], "big")
    if x0 >= P or x1 >= P:
        raise ValueError("G2 x out of range")
    x = (x0, x1)
    y2 = f.fp2_add(f.fp2_mul(f.fp2_sqr(x), x), B2)
    y = f.fp2_sqrt(y2)
    if y is None:
        raise ValueError("G2 x not on curve")
    if _fp2_is_lex_largest(y) != bool(flags & FLAG_SIGN):
        y = f.fp2_neg(y)
    return (x, y)
