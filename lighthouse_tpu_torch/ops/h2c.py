"""Hash to G2 in the batch-minor layout.

Counterparts: ``lighthouse_tpu/ops/bm/h2c.py`` (followed step for step) and
``lighthouse_tpu/ops/h2c.py`` (batch-major; its RFC 9380 derivation comments
are authoritative). The host part, expand_message_xmd and hash_to_field,
comes from the port's copy of ``crypto/bls/hash_to_curve.py``
(``ops/bm/h2c.hash_to_field_bm_np`` imports JAX). The device part is the
projective simplified SWU map, the homogeneous 3-isogeny and cofactor
clearing, on (2, 2, 12, m) field elements: two Fp2 per message, messages
minor.
"""

from functools import lru_cache

import numpy as np
import torch

from ..crypto.bls import hash_to_curve as oh2c
from ..crypto.bls.constants import (
    DST_G2,
    ISO3_X_DEN,
    ISO3_X_NUM,
    ISO3_Y_DEN,
    ISO3_Y_NUM,
    SSWU_A2,
    SSWU_B2,
    SSWU_Z2,
)
from . import curves as cv
from . import fused
from . import limbs as lb
from . import tower as tw

# K4 plans (one launch each). SSWU over (tv1^2, tv1, 1): tv2 = tv1^2 + tv1,
# tv2 + 1 and -tv2.
_TV, _TV1, _ONE = (tw._fp2(i) for i in range(3))
_TV2 = tw._sum((1, _TV), (1, _TV1))
_SSWU_TV2 = tw._plan("sswu_tv2", 6, _TV2, tw._sum((1, _TV2), (1, _ONE)), tw._sum((-1, _TV2)))
# g(x)'s numerator over (xn^3, xd^3, xn xd^2, a xn xd^2, b xd^3): xn^3 + a xn
# xd^2 + b xd^3.
_SSWU_GXN = tw._plan("sswu_gxn", 10, tw._sum((1, tw._fp2(0)), (1, tw._fp2(3)), (1, tw._fp2(4))))
_NEG2 = tw._plan("fp2_neg", 2, tw._sum((-1, _TV)))
# The isogeny's four polynomials (x_num, x_den, y_num, y_den), four Fp2
# products each (x_den's last by a zero coefficient): each the sum of its
# row's products.
_ISO_SUMS = tw._plan("iso_map_sums", 32,
                     *(tw._sum(*((1, tw._fp2(4 * i + k)) for k in range(4))) for i in range(4)))


class _Consts:
    def __init__(self, device):
        def fp2(c):
            return tw.fp2_from_int_pairs([c], device)

        def stack(coeffs):
            return torch.stack([fp2(c) for c in coeffs])

        self.a, self.b, self.z = fp2(SSWU_A2), fp2(SSWU_B2), fp2(SSWU_Z2)
        self.xn = stack(ISO3_X_NUM)
        self.xd = stack(list(ISO3_X_DEN) + [(0, 0)])
        self.yn = stack(ISO3_Y_NUM)
        self.yd = stack(ISO3_Y_DEN)
        self.iso = torch.stack([self.xn, self.xd, self.yn, self.yd])   # (4, 4, 2, 12, 1)


@lru_cache(maxsize=None)
def consts(device) -> _Consts:
    return _Consts(torch.device(device))


# --- Host staging -----------------------------------------------------------


def hash_to_field_limbs_np(messages, dst: bytes = DST_G2) -> np.ndarray:
    """Host SHA-256 hash_to_field -> (2, 2, 12, m) int32 limbs (numpy):
    element u0/u1, Fp2 component, limb, message."""
    us = [oh2c.hash_to_field_fp2(msg, 2, dst) for msg in messages]
    flat = lb.ints_to_limbs_np([u[e][c] for e in range(2) for c in range(2) for u in us])
    return np.ascontiguousarray(np.moveaxis(flat.reshape(lb.L, 2, 2, len(us)), 0, 2))


def hash_to_field_limbs(messages, device, dst: bytes = DST_G2) -> torch.Tensor:
    """hash_to_field_limbs_np on `device`."""
    return torch.from_numpy(hash_to_field_limbs_np(list(messages), dst)).to(device)


# --- Device map -------------------------------------------------------------


def _sgn0_fp2(a):
    """RFC 9380 sgn0 on the standard form of (..., 2, 12, n)."""
    std = lb.canonicalize(a)
    a0, a1 = std[..., 0, :, :], std[..., 1, :, :]
    sign0 = (a0[..., 0, :] & 1) == 1
    zero0 = torch.all(a0 == 0, dim=-2)
    sign1 = (a1[..., 0, :] & 1) == 1
    return torch.logical_or(sign0, torch.logical_and(zero0, sign1))


def map_to_curve_sswu_projective(u):
    """(..., 2, 12, n) field elements -> (x_num, x_den, y) on E2'."""
    c = consts(u.device)
    tv1 = tw.fp2_mul(c.z, tw.fp2_sqr(u))
    one = tw.consts(u.device).fp2_one
    tv2, tv2_1, tv2_neg = fused.fp_lincomb((tw.fp2_sqr(tv1), tv1, one),
                                           _SSWU_TV2).unflatten(-3, (3, 2)).unbind(-4)
    tv2_zero = tw.fp2_is_zero(tv2)
    xn = tw.fp2_mul(c.b, tv2_1)
    den_inner = tw.fp2_select(tv2_zero, c.z.expand_as(tv2), tv2_neg)
    xd = tw.fp2_mul(c.a, den_inner)

    sq = tw.fp2_sqr(torch.stack([xn, xd], dim=-4))
    xn2, xd2 = sq.select(-4, 0), sq.select(-4, 1)
    m = tw.fp2_mul(torch.stack([xn2, xd2, xd2], dim=-4),
                   torch.stack([xn, xd, xn], dim=-4))
    xn3, xd3, xnxd2 = m.select(-4, 0), m.select(-4, 1), m.select(-4, 2)
    m2 = tw.fp2_mul(torch.stack([xnxd2, xd3], dim=-4),
                    torch.stack(torch.broadcast_tensors(c.a, c.b), dim=-4))
    gxn = fused.fp_lincomb((tw._terms(m, 1), tw._terms(m2, 1)), _SSWU_GXN)
    is_sq, y1 = tw.fp2_sqrt_ratio(gxn, xd3)

    m3 = tw.fp2_mul(torch.stack([tv1, tw.fp2_mul(tv1, u)], dim=-4),
                    torch.stack([xn, y1], dim=-4))
    x2n, y2 = m3.select(-4, 0), m3.select(-4, 1)
    xn_out = tw.fp2_select(is_sq, xn, x2n)
    y = tw.fp2_select(is_sq, y1, y2)
    flip = torch.logical_xor(_sgn0_fp2(u), _sgn0_fp2(y))
    y = tw.fp2_select(flip, fused.fp_lincomb(y, _NEG2), y)
    return xn_out, xd, y


def iso_map_homogeneous(xn, xd, y):
    """3-isogeny E2' -> E2 on a projective x: (..., 3, 2, 12, n) points."""
    c = consts(xn.device)
    sq = tw.fp2_sqr(torch.stack([xn, xd], dim=-4))
    xn2, xd2 = sq.select(-4, 0), sq.select(-4, 1)
    m = tw.fp2_mul(torch.stack([xn2, xd2, xn2], dim=-4),
                   torch.stack([xn, xd, xd], dim=-4))
    xn3, xd3, xn2xd = m.select(-4, 0), m.select(-4, 1), m.select(-4, 2)
    xnxd2 = tw.fp2_mul(xn, xd2)
    basis = torch.stack([xd3, xnxd2, xn2xd, xn3], dim=-4)
    # The four polynomials' 16 products in one K2 call, their sums in one K4
    # launch.
    prod = tw.fp2_mul(c.iso, basis.unsqueeze(-5))             # (..., 4, 4, 2, 12, n)
    sums = fused.fp_lincomb(tw._terms(prod, 2), _ISO_SUMS).unflatten(-3, (4, 2))
    xnum, xden, ynum, yden = sums.unbind(-4)
    m2 = tw.fp2_mul(torch.stack([xnum, ynum, xden], dim=-4),
                    torch.stack([yden, y, yden], dim=-4))
    X, yyn, Z = m2.select(-4, 0), m2.select(-4, 1), m2.select(-4, 2)
    Y = tw.fp2_mul(yyn, xden)
    return cv.G2.pack(X, Y, Z)


def hash_to_g2_device(u):
    """(2, 2, 12, m) field elements -> (3, 2, 12, m) projective G2 points."""
    xn, xd, y = map_to_curve_sswu_projective(u)    # element axis leads
    q = iso_map_homogeneous(xn, xd, y)             # (2, 3, 2, 12, m)
    return cv.g2_clear_cofactor(cv.G2.add(q[0], q[1]))


def hash_to_g2(messages, device=None, dst: bytes = DST_G2):
    device = lb.default_device(device)
    return hash_to_g2_device(hash_to_field_limbs(messages, device, dst))
