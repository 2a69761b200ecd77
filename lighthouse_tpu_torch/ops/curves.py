"""G1/G2 group operations in the batch-minor layout.

Counterparts: ``lighthouse_tpu/ops/bm/curves.py`` (followed function for
function) and ``lighthouse_tpu/ops/curves.py`` (batch-major; its formula
comments are authoritative): the complete Renes-Costello-Batina projective
formulas for a = 0, fixed- and variable-scalar ladders, the psi
endomorphism, Bowe's subgroup check and Budroni-Pintore cofactor clearing.

    G1 point: (..., 3, 12, n)       projective (X, Y, Z), coords on axis -3
    G2 point: (..., 3, 2, 12, n)    coords on axis -4

The complete addition and doubling are one kernel call each (K5,
``fused.g1_add`` ... ``g2_double``, csrc/curve_op.cu) on the card; their
plain versions (``_add_plain`` / ``_double_plain``) are the formulas below on
the plain versions of the field kernels, which the CPU takes. Elsewhere a
formula batches its independent products into one kernel call
(``mul_many``). Masks and scalars are (..., n); scalars are int64 tensors
holding the bit patterns of unsigned 64-bit values.
"""

from functools import lru_cache

import numpy as np
import torch

from ..crypto.bls import curves as _oc
from ..crypto.bls.constants import BLS_X_ABS
from . import fused
from . import limbs as lb
from . import tower as tw


class _FieldAdapter:
    def __init__(self, tail_ndim, mul, add, sub, neg, mul_small, is_zero, zero, one):
        self.tail_ndim = tail_ndim          # dims of one element incl. batch
        self.mul = mul
        self.add = add
        self.sub = sub
        self.neg = neg
        self.mul_small = mul_small
        self.is_zero = is_zero
        self.zero = zero                    # device -> constant
        self.one = one

    def _many(self, op, xs, ys):
        """One call of `op` on the stacked operands (one kernel launch, or
        one set of torch ops, for a whole formula step)."""
        axis = -(self.tail_ndim + 1)
        out = op(torch.stack(torch.broadcast_tensors(*xs), dim=axis),
                 torch.stack(torch.broadcast_tensors(*ys), dim=axis))
        return [out.select(axis, i) for i in range(len(xs))]

    def mul_many(self, xs, ys):
        return self._many(self.mul, xs, ys)

    def add_many(self, xs, ys):
        return self._many(self.add, xs, ys)

    def sub_many(self, xs, ys):
        return self._many(self.sub, xs, ys)


def _broadcast(op):
    return lambda a, b: op(*torch.broadcast_tensors(a, b))


# A point's negation as a K4 plan over its coordinates' Fp values, by the
# number of Fp values a coordinate has.
_NEG_Y = {comps: fused.lincomb_plan(
    f"g{comps}_neg", [[(-1 if comps <= i < 2 * comps else 1) if i == j else 0
                       for j in range(3 * comps)] for i in range(3 * comps)])
    for comps in (1, 2)}
# The curve equation's Y^2 Z - X^3 - b Z^3 over (Y^2 Z, X^3, Z^3): b = 4 on
# G1, 4 xi on G2 (4 xi z = 4 (z0 - z1) + 4 (z0 + z1) u).
_ON_CURVE = {1: fused.lincomb_plan("g1_on_curve", ((1, -1, -4),)),
             2: fused.lincomb_plan("g2_on_curve", ((1, 0, -1, 0, -4, 4), (0, 1, 0, -1, -4, -4)))}


_FP_OPS = (lb.add, lb.sub, lb.neg, lb.mul_small, lb.is_zero)
_FP_PLAIN_OPS = (fused.fp_add_plain, fused.fp_sub_plain, fused.fp_neg_plain,
                 fused.fp_mul_small_plain, lb.is_zero)
_FP2_CONSTS = (lambda d: tw.consts(d).fp2_zero, lambda d: tw.consts(d).fp2_one)

FP = _FieldAdapter(2, lb.mul, *_FP_OPS, lb.zero, lb.one)
FP2 = _FieldAdapter(3, tw.fp2_mul, *_FP_OPS[:4], tw.fp2_is_zero, *_FP2_CONSTS)
# The same fields on the plain versions of K1, K2 and K4 (pure torch on any
# device): what K5's plain versions compute with.
FP_PLAIN = _FieldAdapter(2, _broadcast(fused.fp_mul_plain), *_FP_PLAIN_OPS, lb.zero, lb.one)
FP2_PLAIN = _FieldAdapter(3, _broadcast(fused.fp2_mul_plain), *_FP_PLAIN_OPS[:4],
                          tw.fp2_is_zero, *_FP2_CONSTS)


class _Group:
    def __init__(self, field: _FieldAdapter, plain: _FieldAdapter, b3_mul, name: str,
                 add, double):
        self.f = field
        self.plain = plain
        self.b3_mul = b3_mul
        self.name = name
        # The complete sum p + q (points broadcast) and 2 p: one K5 launch
        # on the card, the plain versions below on the CPU.
        self.add, self.double = add, double

    def infinity(self, device):
        return _infinity(self.name, torch.device(device))

    def coords(self, p):
        ax = -(self.f.tail_ndim + 1)
        return p.select(ax, 0), p.select(ax, 1), p.select(ax, 2)

    def pack(self, X, Y, Z):
        return torch.stack([X, Y, Z], dim=-(self.f.tail_ndim + 1))

    def is_infinity(self, p):
        return self.f.is_zero(self.coords(p)[2])

    def on_curve(self, p):
        """Y^2 Z - X^3 - b Z^3 == 0, its sum one K4 launch."""
        f = self.f
        X, Y, Z = self.coords(p)
        y2, x2, z2 = f.mul_many([Y, X, Z], [Y, X, Z])
        ax = -(f.tail_ndim + 1)
        prods = f.mul(torch.stack(torch.broadcast_tensors(y2, x2, z2), dim=ax),
                      torch.stack(torch.broadcast_tensors(Z, X, Z), dim=ax))
        comps = f.tail_ndim - 1
        rhs = fused.fp_lincomb(prods.flatten(-4, -3) if comps == 2 else prods, _ON_CURVE[comps])
        return f.is_zero(rhs if comps == 2 else rhs.squeeze(-3))

    def select(self, mask, a, b):
        idx = (Ellipsis,) + (None,) * self.f.tail_ndim + (slice(None),)
        return torch.where(mask[idx], a, b)

    def _add_plain(self, p, q):
        """K5's plain version of add: the complete Renes-Costello-Batina
        addition for a = 0 on the plain field versions."""
        f = self.plain
        X1, Y1, Z1 = self.coords(p)
        X2, Y2, Z2 = self.coords(q)
        s = f.add_many([X1, Y1, X1, X2, Y2, X2], [Y1, Z1, Z1, Y2, Z2, Z2])
        t0, t1, t2, m3, m4, m5 = f.mul_many([X1, Y1, Z1, s[0], s[1], s[2]],
                                            [X2, Y2, Z2, s[3], s[4], s[5]])
        u = f.add_many([t0, t1, t0], [t1, t2, t2])
        t3, t4, ty = f.sub_many([m3, m4, m5], u)
        t03 = f.mul_small(t0, 3)
        t2b, yb = self.b3_many([t2, ty], f)
        z3s, t1b = f.add(t1, t2b), f.sub(t1, t2b)
        p0, p1, p2, p3, p4, p5 = f.mul_many(
            [t4, t3, yb, t1b, t03, z3s],
            [yb, t1b, t03, z3s, t3, t4],
        )
        y3, z3 = f.add_many([p2, p5], [p3, p4])
        return self.pack(f.sub(p1, p0), y3, z3)

    def _double_plain(self, p):
        """K5's plain version of double."""
        f = self.plain
        X, Y, Z = self.coords(p)
        t0, t1, t2, txy = f.mul_many([Y, Y, Z, X], [Y, Z, Z, Y])
        t2b = self.b3_mul(t2, 3, f)
        z8 = f.mul_small(t0, 8)
        y3s = f.add(t0, t2b)
        t0p = f.sub(t0, f.mul_small(t2b, 3))
        q0, q1, q2, q3 = f.mul_many([t2b, t1, t0p, t0p], [z8, z8, y3s, txy])
        return self.pack(f.add(q3, q3), f.add(q0, q2), q1)

    def b3_many(self, xs, f=None):
        axis = -(self.f.tail_ndim + 1)
        out = self.b3_mul(torch.stack(torch.broadcast_tensors(*xs), dim=axis), 3, f or self.f)
        return [out.select(axis, i) for i in range(len(xs))]

    def neg(self, p):
        """(X, -Y, Z): one K4 launch writing the whole point."""
        comps = self.f.tail_ndim - 1                # an Fp coordinate 1, an Fp2 one 2
        terms = p.flatten(-4, -3) if comps == 2 else p
        return fused.fp_lincomb(terms, _NEG_Y[comps]).view(p.shape)

    def mul_fixed_scalar(self, p, k: int):
        """[k]P for a public scalar: double-and-add over k's bits."""
        if k < 0:
            return self.mul_fixed_scalar(self.neg(p), -k)
        if k == 0:
            return self.infinity(p.device).expand_as(p)
        acc = p
        for c in bin(k)[3:]:
            acc = self.double(acc)
            if c == "1":
                acc = self.add(acc, p)
        return acc

    def mul_var_scalar(self, p, k, nbits: int = 64):
        """[k_i]P_i with per-element 64-bit scalars k (int64 bit patterns,
        (..., n)): a 2-bit fixed window, as curves._Group.mul_var_scalar;
        the one-word case of mul_var_scalar_wide."""
        return self.mul_var_scalar_wide(p, k.unsqueeze(0), nbits)

    def mul_var_scalar_wide(self, p, k_words, nbits: int = 256):
        """[k_i]P_i with per-element multi-word scalars (KZG's span the
        255-bit Fr), as curves._Group.mul_var_scalar_wide: a 2-bit fixed
        window over k_words (words, ..., n), little-endian 64-bit words as
        int64 bit patterns. A digit never straddles a word, and
        (word >> s) & 3 is exact on int64 for every even s <= 62 (the mask
        drops the sign's copies)."""
        if nbits % 2:
            raise ValueError("nbits must be even")
        p2 = self.double(p)
        p3 = self.add(p2, p)
        inf = self.infinity(p.device).expand_as(p)
        acc = inf
        for pos in range(nbits - 2, -1, -2):
            acc = self.double(self.double(acc))
            digit = (k_words[pos // 64] >> (pos % 64)) & 3
            entry = self.select(digit == 1, p, self.select(
                digit == 2, p2, self.select(digit == 3, p3, inf)))
            acc = self.add(acc, entry)
        return acc

    def msm_reduce_minor(self, pts, axis_size: int):
        """Sum points along the minor batch axis (log2 complete adds); the
        result keeps a trailing batch axis of 1."""
        return lb.tree_reduce_minor(pts, self.add, self.infinity(pts.device), axis_size)


def _b3_g1(a, k: int = 3, f=FP):
    """[3b] a for G1 (b = 4); k = 1 gives [b] a."""
    return f.mul_small(a, 4 * k)


def _b3_g2(a, k: int = 3, f=FP2):
    """[3b] a for G2 (b = 4 xi); k = 1 gives [b] a."""
    a0, a1 = a[..., 0, :, :], a[..., 1, :, :]
    return f.mul_small(torch.stack([f.sub(a0, a1), f.add(a0, a1)], dim=-3), 4 * k)


G1 = _Group(FP, FP_PLAIN, _b3_g1, "G1", fused.g1_add, fused.g1_double)
G2 = _Group(FP2, FP2_PLAIN, _b3_g2, "G2", fused.g2_add, fused.g2_double)


@lru_cache(maxsize=None)
def _infinity(name: str, device):
    f = G1.f if name == "G1" else G2.f
    return torch.stack([f.zero(device), f.one(device), f.zero(device)])


# --- Host staging (oracle affine <-> batch-minor projective) ---------------


def g1_from_affine_np(pts) -> np.ndarray:
    """[(x, y) | None, ...] -> (3, 12, n) int32 limbs (numpy); None is
    infinity (0 : 1 : 0)."""
    xs, ys, zs = [], [], []
    for pt in pts:
        if pt is None:
            xs.append(0), ys.append(1), zs.append(0)
        else:
            xs.append(pt[0]), ys.append(pt[1]), zs.append(1)
    flat = lb.ints_to_limbs_np(xs + ys + zs)
    return np.ascontiguousarray(flat.reshape(lb.L, 3, len(xs)).transpose(1, 0, 2))


def g2_from_affine_np(pts) -> np.ndarray:
    """[((x0, x1), (y0, y1)) | None, ...] -> (3, 2, 12, n) int32 limbs
    (numpy); None is infinity (0 : 1 : 0)."""
    cols = [[] for _ in range(6)]      # X0, X1, Y0, Y1, Z0, Z1
    for pt in pts:
        (x0, x1), (y0, y1), z0 = ((0, 0), (1, 0), 0) if pt is None else (pt[0], pt[1], 1)
        for col, v in zip(cols, (x0, x1, y0, y1, z0, 0)):
            col.append(v)
    flat = lb.ints_to_limbs_np([v for col in cols for v in col])
    return np.ascontiguousarray(np.moveaxis(flat.reshape(lb.L, 3, 2, len(cols[0])), 0, 2))


def g1_from_affine(pts, device) -> torch.Tensor:
    """g1_from_affine_np on `device`."""
    return torch.from_numpy(g1_from_affine_np(pts)).to(device)


def g2_from_affine(pts, device) -> torch.Tensor:
    """g2_from_affine_np on `device`."""
    return torch.from_numpy(g2_from_affine_np(pts)).to(device)


def to_affine_ints(pts, group: str) -> list:
    """Projective device points -> oracle affine points (host inversion),
    for tests and checks."""
    if group == "G1":
        X, Y, Z = (lb.limbs_to_ints(pts.select(-3, i)) for i in range(3))
        out = []
        for x, y, z in zip(X, Y, Z):
            if z == 0:
                out.append(None)
            else:
                zi = pow(z, -1, _oc.P)
                out.append((x * zi % _oc.P, y * zi % _oc.P))
        return out
    from ..crypto.bls import fields as f
    co = [[lb.limbs_to_ints(pts.select(-4, i).select(-3, c)) for c in range(2)]
          for i in range(3)]
    out = []
    for j in range(len(co[0][0])):
        x, y, z = ((co[i][0][j], co[i][1][j]) for i in range(3))
        if f.fp2_is_zero(z):
            out.append(None)
        else:
            zi = f.fp2_inv(z)
            out.append((f.fp2_mul(x, zi), f.fp2_mul(y, zi)))
    return out


# --- psi endomorphism, subgroup checks, cofactor clearing -------------------


@lru_cache(maxsize=None)
def _psi_consts(device):
    return (tw.fp2_from_int_pairs([_oc.PSI_CX], torch.device(device)),
            tw.fp2_from_int_pairs([_oc.PSI_CY], torch.device(device)))


def g2_psi(p):
    """(cx conj(X), cy conj(Y), conj(Z)): the three conjugations in one K4
    launch."""
    cx, cy = _psi_consts(p.device)
    conj = tw.fp2_conj(p)
    prod = tw.fp2_mul(conj[..., :2, :, :, :],
                      torch.stack(torch.broadcast_tensors(cx, cy), dim=-4))
    return G2.pack(prod.select(-4, 0), prod.select(-4, 1), conj.select(-4, 2))


def g2_in_subgroup(p):
    """psi(P) == [x]P (Bowe), as psi(P) + [|x|]P == O with x < 0."""
    s = G2.add(g2_psi(p), G2.mul_fixed_scalar(p, BLS_X_ABS))
    return torch.logical_and(G2.on_curve(p), G2.is_infinity(s))


def g2_clear_cofactor(p):
    """Budroni-Pintore psi decomposition (curves.g2_clear_cofactor). -[x]P
    is [|x|]P itself (x < 0; the negation of canonical limbs is exact both
    ways), and -P is formed once."""
    neg_xp = G2.mul_fixed_scalar(p, BLS_X_ABS)
    xp = G2.neg(neg_xp)
    xxp = G2.neg(G2.mul_fixed_scalar(xp, BLS_X_ABS))
    neg_p = G2.neg(p)
    term1 = G2.add(G2.add(xxp, neg_xp), neg_p)
    term2 = g2_psi(G2.add(xp, neg_p))
    term3 = g2_psi(g2_psi(G2.double(p)))
    return G2.add(G2.add(term1, term2), term3)
