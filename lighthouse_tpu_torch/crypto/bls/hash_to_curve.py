"""RFC 9380 hash-to-curve for BLS12-381 G2 (ciphersuite BLS12381G2_XMD:SHA-256_SSWU_RO_).

This is the map from a 32-byte signing root to a point in G2, as used by every
Ethereum consensus signature. The reference obtains it from blst's
`hash_to_g2` with the DST pinned at crypto/bls/src/impls/blst.rs:14; we
implement the spec directly:

    expand_message_xmd(SHA-256) -> hash_to_field(Fp2, count=2)
      -> simplified SWU on E2' -> 3-isogeny to E2 -> clear_cofactor

The 3-isogeny constants (constants.py) are structurally cross-validated in
tests (on-curve images, homomorphism property, Vélu-derived kernel).

A copy of ``lighthouse_tpu/crypto/bls/hash_to_curve.py``: the port imports nothing of
the JAX package.
"""

import hashlib

from . import fields as f
from .constants import DST_G2, ISO3_X_DEN, ISO3_X_NUM, ISO3_Y_DEN, ISO3_Y_NUM, P, SSWU_A2, SSWU_B2, SSWU_Z2
from .curves import g2_add, g2_clear_cofactor

# hash_to_field parameters for this ciphersuite.
_L = 64          # bytes per field coordinate
_H_OUT = 32      # SHA-256 output length
_H_BLOCK = 64    # SHA-256 block length


def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    """RFC 9380 §5.3.1 expand_message_xmd with SHA-256."""
    if len(dst) > 255:
        dst = hashlib.sha256(b"H2C-OVERSIZE-DST-" + dst).digest()
    ell = (len_in_bytes + _H_OUT - 1) // _H_OUT
    if ell > 255 or len_in_bytes > 65535:
        raise ValueError("expand_message_xmd length out of range")
    dst_prime = dst + bytes([len(dst)])
    z_pad = bytes(_H_BLOCK)
    l_i_b_str = len_in_bytes.to_bytes(2, "big")
    b_0 = hashlib.sha256(z_pad + msg + l_i_b_str + b"\x00" + dst_prime).digest()
    b = [hashlib.sha256(b_0 + b"\x01" + dst_prime).digest()]
    for i in range(2, ell + 1):
        tmp = bytes(x ^ y for x, y in zip(b_0, b[-1]))
        b.append(hashlib.sha256(tmp + bytes([i]) + dst_prime).digest())
    return b"".join(b)[:len_in_bytes]


def hash_to_field_fp2(msg: bytes, count: int, dst: bytes = DST_G2):
    """RFC 9380 §5.2 hash_to_field for Fp2 (m=2, L=64)."""
    len_in_bytes = count * 2 * _L
    uniform = expand_message_xmd(msg, dst, len_in_bytes)
    out = []
    for i in range(count):
        coords = []
        for j in range(2):
            offset = _L * (j + i * 2)
            coords.append(int.from_bytes(uniform[offset:offset + _L], "big") % P)
        out.append((coords[0], coords[1]))
    return out


def map_to_curve_simple_swu_g2(u):
    """RFC 9380 §6.6.2 simplified SWU, returning a point on E2' (the iso curve)."""
    A, B, Z = SSWU_A2, SSWU_B2, SSWU_Z2
    zu2 = f.fp2_mul(Z, f.fp2_sqr(u))                      # Z u^2
    tv = f.fp2_add(f.fp2_sqr(zu2), zu2)                   # Z^2 u^4 + Z u^2
    if f.fp2_is_zero(tv):
        # Exceptional case: x1 = B / (Z A)
        x1 = f.fp2_mul(B, f.fp2_inv(f.fp2_mul(Z, A)))
    else:
        # x1 = (-B/A) * (1 + 1/tv)
        x1 = f.fp2_mul(
            f.fp2_mul(f.fp2_neg(B), f.fp2_inv(A)),
            f.fp2_add(f.FP2_ONE, f.fp2_inv(tv)),
        )
    gx1 = f.fp2_add(f.fp2_mul(f.fp2_add(f.fp2_sqr(x1), A), x1), B)   # x1^3 + A x1 + B
    y1 = f.fp2_sqrt(gx1)
    if y1 is not None:
        x, y = x1, y1
    else:
        x2 = f.fp2_mul(zu2, x1)
        gx2 = f.fp2_add(f.fp2_mul(f.fp2_add(f.fp2_sqr(x2), A), x2), B)
        x, y = x2, f.fp2_sqrt(gx2)
    if f.fp2_sgn0(u) != f.fp2_sgn0(y):
        y = f.fp2_neg(y)
    return (x, y)


def _horner(coeffs, x):
    acc = coeffs[-1]
    for c in reversed(coeffs[:-1]):
        acc = f.fp2_add(f.fp2_mul(acc, x), c)
    return acc


def iso_map_g2(pt):
    """Apply the 3-isogeny E2' -> E2 (RFC 9380 Appendix E.3)."""
    if pt is None:
        return None
    x, y = pt
    x_num = _horner(ISO3_X_NUM, x)
    x_den = _horner(ISO3_X_DEN, x)
    y_num = _horner(ISO3_Y_NUM, x)
    y_den = _horner(ISO3_Y_DEN, x)
    if f.fp2_is_zero(x_den) or f.fp2_is_zero(y_den):
        return None  # maps to the point at infinity (kernel x-coordinate)
    return (
        f.fp2_mul(x_num, f.fp2_inv(x_den)),
        f.fp2_mul(y, f.fp2_mul(y_num, f.fp2_inv(y_den))),
    )


def hash_to_g2(msg: bytes, dst: bytes = DST_G2):
    """Full hash_to_curve: msg -> point in G2 (affine twist coordinates)."""
    u0, u1 = hash_to_field_fp2(msg, 2, dst)
    q0 = iso_map_g2(map_to_curve_simple_swu_g2(u0))
    q1 = iso_map_g2(map_to_curve_simple_swu_g2(u1))
    return g2_clear_cofactor(g2_add(q0, q1))
