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
all the products of a step, and a step's additions, with xi and the
conjugations folded into their coefficients, are one K4 launch
(``fused.fp_lincomb``) over the products as they come out.
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


# --- K4 plans: each step's additions as one signed linear combination over
# a term axis (the Fp values of a tensor's last Fp2 axes, component minor).


def _fp2(i):
    """Fp2 value i of a term axis, as one {term: coefficient} per component."""
    return {2 * i: 1}, {2 * i + 1: 1}


_sum = fused._comb          # sum c x over (c, x) pairs of Fp2 values, per component


def _plan(name, width, *fp2s):
    """The plan whose outputs are the Fp2 values fp2s over `width` terms."""
    return fused.lincomb_plan(name, [[v.get(j, 0) for j in range(width)]
                                     for x in fp2s for v in x])


def _terms(x, axes: int):
    """x (..., a_1 .. a_axes, 2, 12, n), its last `axes` axes of Fp2 values
    and their components as one term axis (..., J, 12, n): a view of a
    contiguous x."""
    return x.flatten(-axes - 3, -3)


_X0, _X1, _X2 = (_fp2(i) for i in range(3))
_CONJ = _plan("fp2_conj", 2, ({0: 1}, {1: -1}))
_XI = _plan("fp2_mul_by_xi", 2, fused._xi(_X0))
# fp6_mul's nine products p00, p11, p22, p01, p10, p02, p20, p12, p21:
# c0 = p00 + xi (p12 + p21), c1 = p01 + p10 + xi p22, c2 = p02 + p11 + p20.
_P = dict(zip(("00", "11", "22", "01", "10", "02", "20", "12", "21"),
              (_fp2(i) for i in range(9))))
_FP6_MUL = _plan("fp6_mul", 18,
                 _sum((1, _P["00"]), (1, fused._xi(_sum((1, _P["12"]), (1, _P["21"]))))),
                 _sum((1, _P["01"]), (1, _P["10"]), (1, fused._xi(_P["22"]))),
                 _sum((1, _P["02"]), (1, _P["11"]), (1, _P["20"])))
_FP6_MUL_BY_V = _plan("fp6_mul_by_v", 6, fused._xi(_X2), _X0, _X1)
# fp6_inv over (a0^2, a2^2, a1^2, a1 a2, a0 a1, a0 a2): c0 = a0^2 - xi a1 a2,
# c1 = xi a2^2 - a0 a1, c2 = a1^2 - a0 a2; then t = xi (a2 c1 + a1 c2) + a0 c0.
_S0, _S1, _S2, _Q0, _Q1, _Q2 = (_fp2(i) for i in range(6))
_FP6_INV_C = _plan("fp6_inv_c", 12, _sum((1, _S0), (-1, fused._xi(_Q0))),
                   _sum((1, fused._xi(_S1)), (-1, _Q1)), _sum((1, _S2), (-1, _Q2)))
_FP6_INV_T = _plan("fp6_inv_t", 6, _sum((1, fused._xi(_sum((1, _X0), (1, _X1)))), (1, _X2)))
# fp2_inv over (a0^2, a1^2, a0, a1): the norm a0^2 + a1^2 and conj(a).
_FP2_INV = fused.lincomb_plan("fp2_inv", ((1, 1, 0, 0), (0, 0, 1, 0), (0, 0, 0, -1)))
# fp12_inv over the squares of a0 and a1 (Fp6 each): a0^2 - v a1^2.
_FP12_INV_T = _plan("fp12_inv_t", 12, _sum((1, _X0), (-1, fused._xi(_fp2(5)))),
                    _sum((1, _X1), (-1, _fp2(3))), _sum((1, _X2), (-1, _fp2(4))))
_FP12_CONJ = fused.lincomb_plan(
    "fp12_conj", [[(1 if j < 6 else -1) if i == j else 0 for j in range(12)] for i in range(12)])


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
    """a0 - a1 u for every Fp2 of (..., 2, 12, n): one K4 launch."""
    return fused.fp_lincomb(a, _CONJ)


def fp2_mul_by_xi(a):
    """xi a = (a0 - a1) + (a0 + a1) u: one K4 launch."""
    return fused.fp_lincomb(a, _XI)


def fp2_mul_fp(a, s):
    """Fp2 (..., 2, 12, n) times Fp (..., 12, n), both coordinates in one
    K1 call."""
    return lb.mul(a, s.unsqueeze(-3))


def fp2_inv(a):
    """conj(a) / (a0^2 + a1^2): the norm and the conjugate in one K4 launch."""
    sq = lb.mul(a, a)
    nc = fused.fp_lincomb((sq, a), _FP2_INV)        # (..., 3, 12, n)
    ninv = lb.inv(nc[..., 0, :, :])
    return lb.mul(nc[..., 1:, :, :], ninv.unsqueeze(-3))


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
    """Fp6 schoolbook: the nine Fp2 products in one K2 call, their sums
    (xi folded in) in one K4 launch."""
    a0, a1, a2 = _fp6_parts(a)
    b0, b1, b2 = _fp6_parts(b)
    pr = fp2_mul(torch.stack([a0, a1, a2, a0, a1, a0, a2, a1, a2], dim=-4),
                 torch.stack([b0, b1, b2, b1, b0, b2, b0, b2, b1], dim=-4))
    return fused.fp_lincomb(_terms(pr, 1), _FP6_MUL).unflatten(-3, (3, 2))


def fp6_sqr(a):
    return fp6_mul(a, a)


def fp6_mul_by_v(a):
    """(xi a2, a0, a1): one K4 launch."""
    return fused.fp_lincomb(_terms(a, 1), _FP6_MUL_BY_V).unflatten(-3, (3, 2))


def fp6_inv(a):
    a0, a1, a2 = _fp6_parts(a)
    st = lambda *p: torch.stack(p, dim=-4)  # noqa: E731
    sq = fp2_sqr(st(a0, a2, a1))
    p1 = fp2_mul(st(a1, a0, a0), st(a2, a1, a2))
    c = fused.fp_lincomb((_terms(sq, 1), _terms(p1, 1)), _FP6_INV_C).unflatten(-3, (3, 2))
    c0, c1, c2 = _fp6_parts(c)
    tp = fp2_mul(st(a2, a1, a0), st(c1, c2, c0))
    tinv = fp2_inv(fused.fp_lincomb(_terms(tp, 1), _FP6_INV_T))
    return fp2_mul(c, tinv.unsqueeze(-4))


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
    """a0 - a1 w: one K4 launch writing the whole value."""
    return fused.fp_lincomb(_terms(a, 2), _FP12_CONJ).unflatten(-3, (2, 3, 2))


def fp12_inv(a, a_conj=None):
    """conj(a) / (a0^2 - v a1^2); a_conj, conj(a) where the caller has it."""
    sq = fp6_sqr(a)                                  # a0^2 and a1^2
    t = fused.fp_lincomb(_terms(sq, 2), _FP12_INV_T).unflatten(-3, (3, 2))
    tinv = fp6_inv(t)
    return fp6_mul(fp12_conj(a) if a_conj is None else a_conj, tinv.unsqueeze(-5))


def fp12_eq(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.all((a == b).flatten(-5, -2), dim=-2)


def fp12_is_one(a):
    return fp12_eq(a, consts(a.device).fp12_one)


def fp12_frob(a):
    return fp2_mul(fp2_conj(a), consts(a.device).frob_mult)


def fp12_frob_n(a, n: int):
    for _ in range(n % 12):
        a = fp12_frob(a)
    return a
