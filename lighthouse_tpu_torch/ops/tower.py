"""Extension towers in the batch-minor layout.

Counterparts: ``lighthouse_tpu/ops/bm/tower.py`` (the batch-minor engine
this module follows function for function) and ``lighthouse_tpu/ops/tower.py``
(batch-major). Shapes (limb axis -2, batch minor -1):

    Fp2  : (..., 2, 12, n)       a0 + a1 u,        u^2 = -1
    Fp6  : (..., 3, 2, 12, n)    a0 + a1 v + a2 v^2, v^3 = xi = 1 + u
    Fp12 : (..., 2, 3, 2, 12, n) a0 + a1 w,        w^2 = v

Fp2 products are the K2 kernel and the public-exponent Fp2 power the K7
kernel; the Fp12 square, product and sparse-line product are the K3
kernel. Everything else stacks its operands so that one kernel call does
all the products of a step.
"""

from functools import lru_cache

import torch

from ..crypto.bls import fields as _of
from ..crypto.bls.constants import P, SSWU_Z2
from . import fused
from . import limbs as lb

add = lb.add
sub = lb.sub
neg = lb.neg


def _pair(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return a.contiguous(), b.contiguous()


def fp2_from_int_pairs(pairs, device) -> torch.Tensor:
    """Host staging: [(c0, c1), ...] -> (2, 12, n)."""
    pairs = list(pairs)
    return torch.stack([lb.ints_to_limbs([c0 for c0, _ in pairs], device),
                        lb.ints_to_limbs([c1 for _, c1 in pairs], device)])


class _Consts:
    def __init__(self, device):
        z = torch.zeros((lb.L, 1), dtype=lb.DTYPE, device=device)
        one = lb.one(device)
        self.fp2_zero = torch.stack([z, z])
        self.fp2_one = torch.stack([one, z])
        self.fp6_one = torch.stack([self.fp2_one, self.fp2_zero, self.fp2_zero])
        self.fp12_one = torch.stack([self.fp6_one, torch.zeros_like(self.fp6_one)])
        k = _K_SQUARE + _K_NONSQ
        self.k_all = torch.stack([fp2_from_int_pairs([c], device) for c in k])
        self.z2 = fp2_from_int_pairs([SSWU_Z2], device)
        gam = [fp2_from_int_pairs([_of._GAMMA1[j]], device) for j in range(6)]
        self.frob_mult = torch.stack([torch.stack([gam[0], gam[2], gam[4]]),
                                      torch.stack([gam[1], gam[3], gam[5]])])


@lru_cache(maxsize=None)
def consts(device) -> _Consts:
    return _Consts(torch.device(device))


# --- Fp2 --------------------------------------------------------------------


def fp2_mul(a, b):
    return fused.fp2_mul(*_pair(a, b))


def fp2_sqr(a):
    return fused.fp2_sqr(a.contiguous())


def fp2_conj(a):
    return torch.stack([a[..., 0, :, :], neg(a[..., 1, :, :])], dim=-3)


def fp2_mul_by_xi(a):
    a0, a1 = a[..., 0, :, :], a[..., 1, :, :]
    return torch.stack([sub(a0, a1), add(a0, a1)], dim=-3)


def fp2_mul_fp(a, s):
    """Fp2 (..., 2, 12, n) times Fp (..., 12, n), both coordinates in one
    K1 call."""
    return lb.mul(a, s.unsqueeze(-3))


def fp2_inv(a):
    a0, a1 = a[..., 0, :, :], a[..., 1, :, :]
    sq = lb.mul(a, a)
    ninv = lb.inv(add(sq[..., 0, :, :], sq[..., 1, :, :]))
    return lb.mul(torch.stack([a0, neg(a1)], dim=-3), ninv.unsqueeze(-3))


def fp2_is_zero(a):
    return torch.all(a == 0, dim=-2).all(dim=-2)


def fp2_eq(a, b):
    return torch.all(a == b, dim=-2).all(dim=-2)


def fp2_select(mask, a, b):
    return torch.where(mask[..., None, None, :], a, b)


def fp2_pow_fixed(a, exponent: int):
    """a^exponent for a public exponent: K7, one launch (fused.fp2_pow)."""
    return fused.fp2_pow(a.contiguous(), exponent)


# --- sqrt_ratio (ops/bm/tower.py fp2_sqrt_ratio, same correction table) -------

_SQRT_RATIO_EXP = (P * P - 9) // 16
_4TH_ROOTS = [(1, 0), _of.fp2_neg((1, 0)),
              _of.fp2_pow((1, 1), (P * P - 1) // 4),
              _of.fp2_pow((1, 1), 3 * (P * P - 1) // 4)]
_ODD_8TH_ROOTS = [_of.fp2_pow((1, 1), j * (P * P - 1) // 8) for j in (1, 3, 5, 7)]
_K_SQUARE = [_of.fp2_sqrt(r) for r in _4TH_ROOTS]
_K_NONSQ = [_of.fp2_sqrt(_of.fp2_mul(SSWU_Z2, _of.fp2_inv(r))) for r in _ODD_8TH_ROOTS]


def fp2_sqrt_ratio(n, d):
    """(is_square, y) with y^2 = n/d when n/d is square, else y^2 = Z n/d:
    one (p^2 - 9)/16 power and eight candidate roots, as in
    ops/bm/tower.fp2_sqrt_ratio."""
    c = consts(n.device)
    d2 = fp2_sqr(d)
    m1 = fp2_mul(torch.stack([n, d2], dim=-4), torch.stack([d2, d2], dim=-4))
    nd2, d4 = m1[..., 0, :, :, :], m1[..., 1, :, :, :]
    m2 = fp2_mul(torch.stack([nd2, d4], dim=-4),
                 torch.stack([d, fp2_mul(nd2, d)], dim=-4))
    nd3, s = m2[..., 0, :, :, :], m2[..., 1, :, :, :]
    y0 = fp2_mul(nd3, fp2_pow_fixed(s, _SQRT_RATIO_EXP))
    shape8 = y0.shape[:-3] + (8,) + y0.shape[-3:]
    cands = fp2_mul(y0.unsqueeze(-4).expand(shape8), c.k_all.expand(shape8))
    lhs = fp2_mul(fp2_sqr(cands), d.unsqueeze(-4))
    want_sq = n.unsqueeze(-4)
    want_ns = fp2_mul(c.z2, n).unsqueeze(-4)
    good = torch.cat([fp2_eq(lhs[..., :4, :, :, :], want_sq),
                      fp2_eq(lhs[..., 4:, :, :, :], want_ns)], dim=-2)   # (..., 8, n)
    idx = torch.argmax(good.to(torch.int32), dim=-2)                   # first True
    is_square = idx < 4
    gather = idx[..., None, None, None, :].expand(
        cands.shape[:-4] + (1,) + cands.shape[-3:])
    root = torch.gather(cands, -4, gather).squeeze(-4)
    return is_square, root


# --- Fp6 --------------------------------------------------------------------


def _fp6_parts(a):
    return a[..., 0, :, :, :], a[..., 1, :, :, :], a[..., 2, :, :, :]


def fp6_mul(a, b):
    """Fp6 schoolbook: the nine Fp2 products in one K2 call."""
    a0, a1, a2 = _fp6_parts(a)
    b0, b1, b2 = _fp6_parts(b)
    pr = fp2_mul(torch.stack([a0, a1, a2, a0, a1, a0, a2, a1, a2], dim=-4),
                 torch.stack([b0, b1, b2, b1, b0, b2, b0, b2, b1], dim=-4))
    p00, p11, p22, p01, p10, p02, p20, p12, p21 = (
        pr[..., i, :, :, :] for i in range(9))
    c0 = add(p00, fp2_mul_by_xi(add(p12, p21)))
    c1 = add(add(p01, p10), fp2_mul_by_xi(p22))
    c2 = add(add(p02, p11), p20)
    return torch.stack([c0, c1, c2], dim=-4)


def fp6_sqr(a):
    return fp6_mul(a, a)


def fp6_mul_by_v(a):
    a0, a1, a2 = _fp6_parts(a)
    return torch.stack([fp2_mul_by_xi(a2), a0, a1], dim=-4)


def fp6_inv(a):
    a0, a1, a2 = _fp6_parts(a)
    st = lambda *p: torch.stack(p, dim=-4)  # noqa: E731
    sq = fp2_sqr(st(a0, a2, a1))
    p1 = fp2_mul(st(a1, a0, a0), st(a2, a1, a2))
    c0 = sub(sq[..., 0, :, :, :], fp2_mul_by_xi(p1[..., 0, :, :, :]))
    c1 = sub(fp2_mul_by_xi(sq[..., 1, :, :, :]), p1[..., 1, :, :, :])
    c2 = sub(sq[..., 2, :, :, :], p1[..., 2, :, :, :])
    tp = fp2_mul(st(a2, a1, a0), st(c1, c2, c0))
    t = add(fp2_mul_by_xi(add(tp[..., 0, :, :, :], tp[..., 1, :, :, :])),
            tp[..., 2, :, :, :])
    tinv = fp2_inv(t)
    return fp2_mul(st(c0, c1, c2), tinv.unsqueeze(-4))


# --- Fp12 -------------------------------------------------------------------


def fp12_mul(a, b):
    return fused.fp12_mul(*_pair(a, b))


def fp12_sqr(a):
    return fused.fp12_sqr(a.contiguous())


def fp12_mul_line(a, line):
    """a * (l0 + l1 w^3 + l2 w^5), line = stack(l0, l1, l2) (..., 3, 2, 12,
    n), as K6 writes it."""
    return fused.fp12_mul_line(a.contiguous(), line.contiguous())


def fp12_mul_sparse_line(a, l0, l1, l2):
    """a * (l0 + l1 w^3 + l2 w^5) (ops/bm/tower.fp12_mul_sparse_line)."""
    return fp12_mul_line(a, torch.stack(torch.broadcast_tensors(l0, l1, l2), dim=-4))


def fp12_conj(a):
    return torch.stack([a[..., 0, :, :, :, :], neg(a[..., 1, :, :, :, :])], dim=-5)


def fp12_inv(a):
    a0, a1 = a[..., 0, :, :, :, :], a[..., 1, :, :, :, :]
    sq = fp6_sqr(torch.stack([a0, a1], dim=-5))
    t = sub(sq[..., 0, :, :, :, :], fp6_mul_by_v(sq[..., 1, :, :, :, :]))
    tinv = fp6_inv(t)
    return fp6_mul(torch.stack([a0, neg(a1)], dim=-5), tinv.unsqueeze(-5))


def fp12_eq(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.all((a == b).flatten(-5, -2), dim=-2)


def fp12_is_one(a):
    return fp12_eq(a, consts(a.device).fp12_one)


def fp12_frob(a):
    conj = torch.cat([a[..., 0:1, :, :], neg(a[..., 1:2, :, :])], dim=-3)
    return fp2_mul(conj, consts(a.device).frob_mult)


def fp12_frob_n(a, n: int):
    for _ in range(n % 12):
        a = fp12_frob(a)
    return a
