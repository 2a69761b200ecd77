"""The port's hand-written kernels, their plain PyTorch versions and their
launch counts.

Counterparts: ``lighthouse_tpu/ops/fused.py`` (the Pallas kernels) and the
XLA field/tower products they fuse, ``ops/limbs.py`` / ``ops/tower.py``
(batch-major) and ``ops/bm/limbs.py`` / ``ops/bm/tower.py`` (batch-minor).

    K1  fp_mul / fp_sqr      csrc/fp_mul.cu    replaces fused.py:279 _fwd_call + :319 _inv_call (no offset)
    K2  fp2_mul / fp2_sqr    csrc/fp2_mul.cu   replaces fused.py:279 _fwd_call + :319 _inv_call (offset)
    K3  fp12_sqr / fp12_mul / fp12_mul_line
                             csrc/fp12_op.cu   replaces fused.py:578 _k3_fp12_call
    K4  fp_lincomb (fp_add / fp_sub / fp_neg / fp_mul_small its one-row plans)
                             csrc/fp_add.cu    no Pallas counterpart: the additions XLA
                                               fuses (ops/bm/limbs.py:343-353 add / sub / neg)
    K5  g1_add / g1_double / g2_add / g2_double
                             csrc/curve_op.cu  no Pallas counterpart: the complete group
                                               law XLA fuses (ops/bm/curves.py:100 add,
                                               :122 double)
    K6  miller_chain / miller_dbl / miller_add
                             csrc/curve_op.cu  no Pallas counterpart: the Miller-loop steps
                                               XLA fuses (ops/bm/pairing.py:24 _dbl_step,
                                               :63 _add_step, scans at :107 / :112), on
                                               K5's engine: a loop's whole T chain a launch
    K7  fp_inv / fp_pow / fp2_pow
                             csrc/fp_pow.cu    no Pallas counterpart: the Fp inverse and the
                                               public-exponent powers XLA fuses into one
                                               lax.scan (ops/bm/limbs.py:466 inv, :433
                                               pow_fixed, scan at :462; ops/bm/tower.py:165
                                               fp2_pow_fixed, scan at :193)

Representation (one for the whole port): an Fp element is 12 little-endian
32-bit limbs of its Montgomery form x * 2^384 mod p, canonical in [0, p),
stored as the bit patterns of an int32 tensor, batch-minor: ``(..., 12, n)``.
Fp2 is ``(..., 2, 12, n)`` and Fp12 ``(..., 2, 3, 2, 12, n)``. Canonical
outputs make the kernel and its plain version comparable bit for bit.

Each wrapper takes its plain version only for CPU tensors. For CUDA tensors
it launches the kernel or raises; it never falls back. The plain versions
work on 16-bit sub-limbs (torch on the CPU cannot shift uint32, and an
int64 product of two 32-bit limbs wraps), with products in float64 (exact
integers below 2^53) and carries in int64, and reduce exactly by a fold
and a quotient estimate (below) where the kernels use Montgomery REDC; both
return the canonical value, so they agree bit for bit. The plain versions
take K3's signed sums term for term from the same tables, and those
tables are checked against K3's accumulator bounds. K2's plain table
(``_K2_TABLE``) sums the four schoolbook products, where the kernel sums
three Karatsuba products (a square two); the outputs are canonical, so
the two still agree bit for bit. K4's plain versions run the 12-limb
carry and borrow chains as int64 torch ops with a lookahead on packed
bit vectors; fp_lincomb_plain folds a combination's terms with them one
by one, where the kernel sums them in one pass.

What bounds the kernels on an H100 (3.35 TB/s, 16.75e12 32-bit
multiply-adds/s, i.e. 5 multiply-adds per byte), counting the work each
function needs (Karatsuba products, one reduction per output; chip_smoke.py
WORK): K1 needs 288 multiply-adds per 144 bytes and K2 720 per 288, so both
are bound by bytes; K3 mul needs 9,504 per 1,728 bytes, bound by integer
multiply-adds. K1 gives one element to one thread, 32 elements to a block;
its square runs the 78 distinct products (replayed by
tests/test_torch_k1_plan.py). K2 gives one element's
Karatsuba products (three; a square two) to three warps of a block of 32
elements, and its two reductions to two (replayed by
tests/test_torch_k2_plan.py). K3 gives one element's Fp
products to the lanes of a block: a warp per group of at most 32
products, one product per lane, the groups and their signed column sums
planned here (``k3_plan_words``) and handed to the kernel as a generated
header; its square runs 78 distinct Fp products, its product the 144 of
the schoolbook. None uses tensor cores. K4 evaluates a plan of R signed
linear combinations of J Fp terms (a whole step's additions, xi folded
into the coefficients) in one launch, one thread per output Fp and
column, its inputs strided or broadcast in place (no copy): (J + R) 48
bytes a column and multiplies by small integers only, bound by bytes.
K5 needs 3,024 (G1 add) to 7,776 (G2 add) multiply-adds per 432-864 bytes
a point, bound by operations, but at the paths' widths (16-4096 points) it
is its launch floor plus one block's critical path: its schedule
(``k5_schedule``) runs each level's independent Fp products on parallel
units (lanes or pairs of lanes) of a block, with intermediates in shared
memory. K6 runs a Miller loop's whole T chain in one launch (63 doubling
and 5 addition steps, each its G2 doubling or addition and its line at P
in two levels of the same schedule, T, Q and P kept in shared memory, the
68 lines written to one buffer): 10,368 and 14,400 multiply-adds a pair a
step, bound by operations. K7 runs a whole
chain a call: the Fp inverse as a binary GCD (1,110 divsteps in batches of
30, one lane an element, one Montgomery product at the end), a 4-bit
fixed-window power (Fp: one lane an element; Fp2, its exponent split at p,
e = A p + B, a^e = conj(a)^A a^B on one chain of squares: four lanes an
element, one Fp product a lane a step), the table in shared memory: bound
by operations, but at the paths' 1-256 elements one chain of dependent
steps.
"""

import ctypes
import math
from functools import lru_cache

import torch

from ..crypto.bls.constants import BLS_X_ABS, P
from . import _build

NL = 12
R_BITS = 384

# Launch counts, one per kernel entry point: a wrapper adds one where it
# launches its kernel, and nowhere else.
launches = {
    "fp_mul": 0, "fp_sqr": 0, "fp2_mul": 0, "fp2_sqr": 0,
    "fp12_sqr": 0, "fp12_mul": 0, "fp12_line": 0,
    "fp_add": 0, "fp_sub": 0, "fp_neg": 0, "fp_mul_small": 0, "fp_lincomb": 0,
    "g1_add": 0, "g1_double": 0, "g2_add": 0, "g2_double": 0,
    "miller_dbl": 0, "miller_add": 0, "miller_chain": 0, "fp_inv": 0, "fp_pow": 0,
    "fp2_pow": 0,
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# --------------------------------------------------------------------------
# Plain versions: int64 on 16-bit sub-limbs
# --------------------------------------------------------------------------
#
# Internally the limb axis is LAST, (..., n, limbs), so that every constant
# contraction is one GEMM over all elements. A product T = signed sum of
# x_k * y_k becomes 49 columns of 16-bit partial products (one float64
# matmul of the outer products, exact: |column| < 2^43), and is reduced
# exactly to T * 2^-384 mod p:
#   1. one floor-carry pass: 49 signed limbs, |limb| < 2^27;
#   2. fold: V_j = sum_k limb_k F[k][j], F[k] = 16-bit limbs of
#      2^(16k) 2^-384 mod p, in the same float64 matmul as the estimate
#      V / p = sum_k limb_k (F[k] / p); both exact enough (|V_j| < 2^48);
#   3. q = floor(V / p), off by at most one, W = V - q p in [-p, 2p);
#   4. W - p, W, W + p normalized together (four floor-carry passes, then
#      a carry and a borrow lookahead), and the one in [0, p) picked by the
#      sign bits.
# The kernels compute the same canonical value by Montgomery REDC.

_M16 = 0xFFFF
# K3 accumulator budget (csrc/fp12_op.cu): offset 16 p^2, at most 17 added
# and 16 subtracted products per accumulator; checked on the tables below.
_K3_MAX_POS = 17
_K3_MAX_NEG = 16
_W = 49                                     # product columns, padded


def _int_limbs16(x: int, w: int):
    return [(x >> (16 * i)) & _M16 for i in range(w)]


class _Consts:
    def __init__(self, device):
        def t(vals, dtype=torch.int64):
            return torch.tensor(vals, dtype=dtype, device=device)

        r_inv = pow(1 << R_BITS, -1, P)
        folds = [(1 << (16 * k)) * r_inv % P for k in range(_W)]
        # (49, 25): 24 fold columns, then V / p.
        self.fold = t([_int_limbs16(f, 24) + [f / P] for f in folds], torch.float64)
        # (576, 49): outer-product entry (i, j) -> column i + j.
        diag = torch.zeros((24 * 24, _W), dtype=torch.float64)
        for i in range(24):
            for j in range(24):
                diag[i * 24 + j, i + j] = 1.0
        self.diag = diag.to(device)
        p16 = _int_limbs16(P, 24)
        self.p16 = t(p16)
        self.cands = t([p16, [0] * 24, [-v for v in p16]])     # W + p, W, W - p
        self.pow2 = t([1 << i for i in range(24)])
        self.idx = t(list(range(24)))


@lru_cache(maxsize=None)
def _consts(device) -> _Consts:
    return _Consts(device)


def _to16(x):
    """(..., 12, n) int32 limbs -> (..., n, 24) float64 16-bit limbs."""
    v = x.transpose(-2, -1).to(torch.int64) & 0xFFFFFFFF
    return torch.stack([v & _M16, v >> 16], dim=-1).flatten(-2).to(torch.float64)


def _from16(v):
    """(..., n, 24) int64 16-bit limbs -> (..., 12, n) int32 bit patterns."""
    v = v.unflatten(-1, (NL, 2))
    w = v[..., 0] | (v[..., 1] << 16)
    w = torch.where(w > 0x7FFFFFFF, w - (1 << 32), w).to(torch.int32)
    return w.transpose(-2, -1).contiguous()


def _cols(x, y, c):
    """(..., n, 24) x (..., n, 24) float64 -> (..., n, 49) product columns,
    column k = sum_{i + j = k} x_i y_j."""
    outer = (x.unsqueeze(-1) * y.unsqueeze(-2)).flatten(-2)    # (..., n, 576)
    return torch.matmul(outer, c.diag)


def _carry_pass(x):
    c = x >> 16                                         # floor, also for x < 0
    x = x & _M16
    x[..., 1:] += c[..., :-1]
    return x


def _lookahead(gen, prop, c):
    """Carry (or borrow) into each of 24 limbs from generate / propagate
    flags, by integer addition on packed bit vectors:
    carries = ((G << 1) + P) ^ P."""
    G = (gen * c.pow2).sum(-1, keepdim=True)
    Pb = (prop * c.pow2).sum(-1, keepdim=True)
    return ((((G << 1) + Pb) ^ Pb) >> c.idx) & 1


def _reduce(t):
    """Signed product columns (..., n, 49) float64 of T (exact integers,
    |column| < 2^43) -> (..., 12, n) int32 limbs of T * 2^-384 mod p."""
    c = _consts(t.device)
    x = _carry_pass(t.to(torch.int64))
    vq = torch.matmul(x.to(torch.float64), c.fold)    # (..., n, 25)
    q = torch.floor(vq[..., 24:])
    w = vq[..., :24].to(torch.int64) - q.to(torch.int64) * c.p16
    w = w.unsqueeze(-2) + c.cands                       # (..., n, 3, 24)
    for _ in range(4):                                  # |limb| < 2^52 -> carries in {-1, 0, 1}
        w = _carry_pass(w)
    w = w + _lookahead(w > _M16, w == _M16, c)          # limbs in [-1, 2^16]
    w = w - (w > _M16) * (1 << 16)
    w = (w - _lookahead(w < 0, w == 0, c)) & _M16       # each candidate mod 2^384
    nonneg = w[..., 23] < 0x8000                        # (..., n, 3): W+p, W, W-p
    pick = torch.where(nonneg[..., 2], 2, torch.where(nonneg[..., 1], 1, 0))
    idx = pick[..., None, None].expand(pick.shape + (1, 24))
    return _from16(torch.gather(w, -2, idx).squeeze(-2))


def _lazy(x, y, sign, n_acc: int):
    """Shared lazy reduction of K2 and K3: products x[k] * y[k] (Fp
    coordinates on axis -3), summed per output with the signs of the
    (n_acc, n_products) matrix `sign`, each output reduced once."""
    c = _consts(x.device)
    cols = _cols(_to16(x), _to16(y), c)                 # (..., np, n, 49)
    acc = torch.matmul(cols.movedim(-3, -1), sign.T)    # (..., n, 49, n_acc)
    return _reduce(acc.movedim(-1, -3))


def _fp_mul_plain(a, b):
    c = _consts(a.device)
    return _reduce(_cols(_to16(a), _to16(b), c))


# Fp2 product table: (x coord, y coord, re sign, im sign) per Fp product of
# x * y, and of xi * x * y (csrc/fp.cuh fp2_acc).
_FP2_TERMS = {
    False: ((0, 0, +1, 0), (1, 1, -1, 0), (0, 1, 0, +1), (1, 0, 0, +1)),
    True: ((0, 0, +1, +1), (1, 1, -1, -1), (0, 1, -1, +1), (1, 0, -1, +1)),
}


class _Table:
    """Gather indices and signed accumulation lists of a lazy product. The
    per-accumulator counts of added and subtracted products are the
    kernels' accumulator bound, checked here."""

    def __init__(self, terms, n_acc: int, max_pos: int, max_neg: int):
        # terms: [(x coord, y coord, [(acc, sign), ...]), ...]
        xs, ys, pos, neg = [], [], [], []
        for k, (xc, yc, dests) in enumerate(terms):
            xs.append(xc)
            ys.append(yc)
            for dest, sign in dests:
                (pos if sign > 0 else neg).append((k, dest))
        for lst, cap in ((pos, max_pos), (neg, max_neg)):
            counts = [sum(1 for _, d in lst if d == a) for a in range(n_acc)]
            if max(counts) > cap:
                raise AssertionError(f"lazy accumulator bound exceeded: {counts}")
        self.xs, self.ys, self.pos, self.neg = xs, ys, pos, neg
        self.n_acc = n_acc

    @lru_cache(maxsize=None)
    def on(self, device):
        sign = torch.zeros((self.n_acc, len(self.xs)), dtype=torch.float64)
        for k, dest in self.pos:
            sign[dest, k] += 1.0
        for k, dest in self.neg:
            sign[dest, k] -= 1.0

        def t(v):
            return torch.tensor(v, dtype=torch.int64, device=device)

        return t(self.xs), t(self.ys), sign.to(device)


def _fp2_terms(xi: bool, xa: int, yb: int, acc: int):
    """Fp products of one Fp2 product (Fp2 indices xa, yb; output Fp2 acc),
    in Fp-coordinate indices (Fp2 index * 2 + component)."""
    out = []
    for s, t, re, im in _FP2_TERMS[xi]:
        dests = [(2 * acc + c, sg) for c, sg in ((0, re), (1, im)) if sg]
        out.append((2 * xa + s, 2 * yb + t, dests))
    return out


# K2's plain version: offset p^2, at most 2 added and 1 subtracted product
# of the schoolbook. The kernel (csrc/fp2_mul.cu) sums Karatsuba products
# instead (T1 = (a0 + a1)(b0 + b1) - a0 b0 - a1 b1) with bounds of its own,
# checked by tests/test_torch_k2_plan.py; both reduce to the canonical value.
_K2_TABLE = _Table(_fp2_terms(False, 0, 0, 0), 2, 2, 1)


def _w_store(e: int) -> int:
    """Fp2 index in the (2, 3) storage grid of w-coefficient e = 2k + h."""
    return (e % 2) * 3 + e // 2


_LINE_SLOT = {0: 0, 3: 1, 5: 2}


def _k3_table(kind: str) -> _Table:
    terms = []
    for e in range(6):
        for i in range(6):
            j = (e - i) % 6
            if kind == "line" and j not in _LINE_SLOT:
                continue
            yb = _LINE_SLOT[j] if kind == "line" else _w_store(j)
            terms += _fp2_terms(i > e, _w_store(i), yb, _w_store(e))
    return _Table(terms, 12, _K3_MAX_POS, _K3_MAX_NEG)


_K3_TABLES = {kind: _k3_table(kind) for kind in ("sqr", "mul", "line")}

# The K3 kernel's plan (csrc/fp12_op.cu). A warp of the kernel runs one
# group of Fp products of one element, one product per lane, and sums them
# by columns into the group's accumulators (at most four Fp outputs). The
# groups come from the table above: its products grouped by the output Fp2
# they feed (each feeds one), a square's mirrored pair a_x a_y, a_y a_x
# merged into one product of multiplicity 2, and output Fp2s packed first
# fit, largest first, into groups of at most 32 products. The sums per
# accumulator are the table's, so its bound (16 p^2 offset, at most 17
# added and 16 subtracted products) holds as it is.
K3_LANES = 32
K3_GROUP_ACCS = 4
K3_HAS = 1 << 31


def _k3_plan(kind: str):
    """[(accumulators, [(x coord, y coord, multiplicity per accumulator)])]
    per group."""
    table = _K3_TABLES[kind]
    slots = [{} for _ in range(6)]                      # output Fp2 -> {(x, y): [re, im]}
    for lst, sign in ((table.pos, 1), (table.neg, -1)):
        for k, dest in lst:
            x, y = table.xs[k], table.ys[k]
            if kind == "sqr":
                x, y = min(x, y), max(x, y)
            slots[dest // 2].setdefault((x, y), [0, 0])[dest % 2] += sign
    groups = []
    for s in sorted(range(6), key=lambda s: -len(slots[s])):
        group = next((g for g in groups if len(g[1]) + len(slots[s]) <= K3_LANES
                      and len(g[0]) + 2 <= K3_GROUP_ACCS), None)
        if group is None:
            group = ([], [])
            groups.append(group)
        accs, products = group
        for (x, y), (re, im) in sorted(slots[s].items()):
            mult = [0] * K3_GROUP_ACCS
            mult[len(accs)], mult[len(accs) + 1] = re, im
            products.append((x, y, tuple(mult)))
        accs += [2 * s, 2 * s + 1]
    return [(tuple(accs), products) for accs, products in groups]


def k3_plan_words(kind: str):
    """The plan as the kernel reads it: per group 1 + 32 uint32 words. Word
    0: the number of accumulators (bits 0-3) and accumulator j's Fp output
    index at bits 4 + 4j. Word 1 + k, lane k's product: bit 31 set, x
    coordinate at bits 0-3, y coordinate at bits 4-7, and the signed
    multiplicity for accumulator j at bits 8 + 4j (4 bits each). A lane
    without a product has word 0; the lanes with products come first."""
    out = []
    for accs, products in _k3_plan(kind):
        head = len(accs) | sum(a << (4 + 4 * j) for j, a in enumerate(accs))
        words = [K3_HAS | x | (y << 4) | sum((m & 15) << (8 + 4 * j) for j, m in enumerate(mult))
                 for x, y, mult in products]
        out.append([head] + words + [0] * (K3_LANES - len(words)))
    return out


def k3_plan_header() -> str:
    """csrc/fp12_op.cu's generated header (written at build time by
    ``_build``): per kind its group count, its largest group and the plan
    words as an initializer."""
    lines = ["// Generated by lighthouse_tpu_torch/ops/fused.py (k3_plan_header) from",
             "// the K3 tables: the product plan of csrc/fp12_op.cu. Do not edit.",
             "#pragma once"]
    for kind in ("sqr", "mul", "line"):
        words = k3_plan_words(kind)
        most = max(sum(1 for w in g[1:] if w) for g in words)
        rows = ", \\\n".join("    {" + ", ".join(f"0x{w:08x}u" for w in g) + "}" for g in words)
        name = kind.upper()
        lines += [f"#define LH_K3_GROUPS_{name} {len(words)}",
                  f"#define LH_K3_PRODUCTS_{name} {most}",
                  f"#define LH_K3_PLAN_{name} {{ \\", rows + "}"]
    return "\n".join(lines) + "\n"


def _lazy_plain(table: _Table, x, y):
    xs, ys, sign = table.on(x.device)
    return _lazy(x.index_select(-3, xs), y.index_select(-3, ys), sign, table.n_acc)


def _fp2_plain(a, b):
    return _lazy_plain(_K2_TABLE, a, b)


def _fp12_plain(kind: str, a, b):
    x = a.flatten(-5, -3)                               # (..., 12, 12, n)
    y = (a if kind == "sqr" else b)
    y = y.flatten(-4, -3) if kind == "line" else y.flatten(-5, -3)
    return _lazy_plain(_K3_TABLES[kind], x, y).unflatten(-3, (2, 3, 2))


# Plain versions chunk the minor axis so that their int64 outer products
# stay near 1 GiB whatever the batch.
_PLAIN_BYTES = 1 << 30


def _chunked(fn, words: int, products: int, *xs):
    n = xs[0].shape[-1]
    elems = xs[0].numel() // max(1, n) // words
    step = max(1, _PLAIN_BYTES // (products * 576 * 8 * max(1, elems)))
    if step >= n:
        return fn(*xs)
    parts = [fn(*(x[..., i:i + step] for x in xs)) for i in range(0, n, step)]
    return torch.cat(parts, dim=-1)


def fp_mul_plain(a, b):
    return _chunked(_fp_mul_plain, NL, 1, a, b)


def fp_sqr_plain(a):
    return _chunked(lambda x: _fp_mul_plain(x, x), NL, 1, a)


def fp2_mul_plain(a, b):
    return _chunked(_fp2_plain, 2 * NL, 4, a, b)


def fp2_sqr_plain(a):
    return _chunked(lambda x: _fp2_plain(x, x), 2 * NL, 4, a)


def fp12_sqr_plain(a):
    return _chunked(lambda x: _fp12_plain("sqr", x, None), 12 * NL, 144, a)


def fp12_mul_plain(a, b):
    return _chunked(lambda x, y: _fp12_plain("mul", x, y), 12 * NL, 144, a, b)


def fp12_mul_line_plain(a, line):
    return _chunked(lambda x, y: _fp12_plain("line", x, y), 12 * NL, 72, a, line)


# K4's plain versions: the 12-limb carry and borrow chains on int64 copies
# of the limbs, each chain resolved at once by a lookahead on packed bit
# vectors ((G << 1) + P) ^ P. The outputs are canonical, as the kernel's.

_M32 = 0xFFFFFFFF


class _AddConsts:
    def __init__(self, device):
        def col(vals):
            return torch.tensor(vals, dtype=torch.int64, device=device)[:, None]

        self.p64 = col([(P >> (32 * i)) & _M32 for i in range(NL)])
        self.pow2 = col([1 << i for i in range(NL)])
        self.idx = col(list(range(NL)))


@lru_cache(maxsize=None)
def _add_consts(device) -> _AddConsts:
    return _AddConsts(device)


def _u64(x):
    return x.to(torch.int64) & _M32


def _i32(v):
    return torch.where(v > 0x7FFFFFFF, v - (1 << 32), v).to(torch.int32)


def _limb_lookahead(gen, prop, c):
    """Carries into each of the 12 limbs (axis -2) from generate/propagate
    flags. Returns (carries, carry out)."""
    G = (gen.to(torch.int64) * c.pow2).sum(-2)
    Pb = (prop.to(torch.int64) * c.pow2).sum(-2)
    C = ((G << 1) + Pb) ^ Pb
    return (C.unsqueeze(-2) >> c.idx) & 1, ((C >> NL) & 1).bool()


def _add64(s, c):
    """Resolve limb sums in [0, 2^33) to limbs mod 2^384."""
    carry, _ = _limb_lookahead(s > _M32, s == _M32, c)
    return (s + carry) & _M32


def _sub64(d, c):
    """Resolve limb differences in (-2^32, 2^32) -> (limbs mod 2^384,
    borrow out)."""
    borrow, out = _limb_lookahead(d < 0, d == 0, c)
    return (d - borrow) & _M32, out


def fp_add_plain(a, b):
    a, b = torch.broadcast_tensors(a, b)
    c = _add_consts(a.device)
    s = _add64(_u64(a) + _u64(b), c)                 # a + b < 2p < 2^384
    d, under = _sub64(s - c.p64, c)
    return _i32(torch.where(under.unsqueeze(-2), s, d))


def fp_sub_plain(a, b):
    a, b = torch.broadcast_tensors(a, b)
    c = _add_consts(a.device)
    d, under = _sub64(_u64(a) - _u64(b), c)
    s = _add64(d + c.p64, c)                         # (a - b + p) mod 2^384
    return _i32(torch.where(under.unsqueeze(-2), s, d))


def fp_neg_plain(a):
    return fp_sub_plain(torch.zeros_like(a), a)


def fp_mul_small_plain(a, k: int):
    """a * k for 1 <= k < 2^16, by doubling and adding."""
    acc = None
    dbl = a
    while k:
        if k & 1:
            acc = dbl if acc is None else fp_add_plain(acc, dbl)
        k >>= 1
        if k:
            dbl = fp_add_plain(dbl, dbl)
    return acc


def fp_lincomb_plain(x, coeffs):
    """K4's plain version of fp_lincomb: each output row folded term by term,
    the first nonzero term as it is (fp_neg_plain if negative), each later
    one by fp_add_plain or fp_sub_plain, a term of |c| > 1 first multiplied
    by fp_mul_small_plain; a row of zeros is 0. The kernel sums the terms in
    one pass instead; both are canonical, so they agree bit for bit."""
    xs = _lincomb_operands(x)
    terms = [t for x in xs for t in x.unbind(-3)]
    lead, n = _lincomb_shape(xs)
    shape = lead + (NL, n)
    rows = []
    for row in coeffs:
        acc = None
        for c, t in zip(row, terms):
            if not c:
                continue
            v = t if abs(c) == 1 else fp_mul_small_plain(t, abs(c))
            if acc is None:
                acc = fp_neg_plain(v) if c < 0 else v
            else:
                acc = (fp_sub_plain if c < 0 else fp_add_plain)(acc, v)
        rows.append(torch.zeros(shape, dtype=torch.int32, device=xs[0].device) if acc is None
                    else acc.expand(shape))
    return torch.stack(rows, dim=-3)


# --- K5 and K6: the schedule of csrc/curve_op.cu ------------------------------
#
# K5 (csrc/curve_op.cu) runs one complete Renes-Costello-Batina addition or
# doubling (a = 0) per point in two levels, and K6 (the same source, the same
# engine) a Miller loop's chain of steps per pair, each step in two: a level
# is a step of independent Fp products and then a step of reductions, one
# unit of the block (a lane, or a pair of lanes, of a warp) per product and
# per reduced Fp value. The schedule is written here once per operation,
# from the formulas of curves._Group (``_add_plain`` / ``_double_plain``)
# and pairing (``_dbl_step_plain`` / ``_add_step_plain``), and handed to the
# kernel as the generated header curve_plan.h:
#
#   product   W = A B, 24 limbs, unreduced; A and B are each a linear
#             combination sum_k c_k s_k of Fp values in the block's slots
#             (the inputs, or earlier levels' reductions), evaluated
#             canonically mod p (fp.cuh's chains for +-1 coefficients, else one
#             pass with a quotient estimate: K5_INV_HI), so W < p^2; a term
#             may be an Fp of P (K6), which multiplies each component of an
#             Fp2 in a product of its own;
#   reduce    an Fp value REDC(T), T = o p^2 + sum_i d_i W_i, o the sum of
#             the subtracted |d_i|: 0 <= T <= (sum_i |d_i|) p^2 <= 9 p^2 <
#             p 2^384 (2^384 / p > 9.8), so REDC is canonical.
# An Fp2 product is Karatsuba's three Fp products (a square two:
# (a0 + a1)(a0 - a1) and 2 a0 a1), and a reduction folds the Fp2
# reduction and the formula's sums of products (xi, small multiples, the
# line's negation) into one REDC; where a coefficient sum would pass the
# bound, the small multiple goes into an operand instead. Level 0's
# reductions go to slots, each the lowest one that no later level reads
# (every product of its level has read the slots by then) and, in K6, none
# of Q's and P's, which every step reads. Level 1's go to the output, Fp
# index coordinate * comps + component of the result point, then of the
# line (K6); K6 also keeps the point in T's slots, Fp index = slot, for its
# next step.
#
# Words per product: K5_LIN per operand, a term kHas | slot | |c| << 8 |
# (c < 0) << 24, then zeros. Per reduction: a head o | destination << 8 |
# terms << 16, then K5_RED terms kHas | product | |d| << 8 | (d < 0) << 16.

K5_OPS = ("g1_add", "g1_double", "g2_add", "g2_double")
K6_OPS = ("miller_dbl", "miller_add")   # the steps of K6's chain
K6_INPUTS = 15                          # T's 6 Fp values, Q's 6, px, py, pz
K6_KEPT = frozenset(range(6, K6_INPUTS))   # Q and P: in their slots for every step
K5_LIN = 4
K5_RED = 9
K5_HAS = 1 << 31
K5_REDC_BOUND = P << R_BITS            # REDC is canonical for 0 <= T < p 2^384

# The Miller loop's steps over the bits of |x| after the leading one: a
# doubling a bit, then an addition where the bit is 1 (63 and 5): 0 is a
# doubling, 1 an addition.
MILLER_STEPS = tuple(k for c in bin(BLS_X_ABS)[3:] for k in ((0, 1) if c == "1" else (0,)))
K6_MAX_STEPS = 128                     # csrc/curve_op.cu kMaxSteps


def _k5_inv_hi() -> float:
    """2^352 / p (1 - 2^-51), rounded down to a double: an operand's quotient
    estimate q = trunc(v_hi * this), v_hi = floor(v / 2^352) < 2^47, is
    floor(v / p) or one less (csrc/fp.cuh sum_mod, as kInvHi: K4's linear
    combinations and K5's operands)."""
    from fractions import Fraction
    target = Fraction(1 << 352, P) * (1 - Fraction(1, 1 << 51))
    x = float(target)
    while Fraction(x) > target:
        x = math.nextafter(x, 0.0)
    return x


K5_INV_HI = _k5_inv_hi()


def _sum(*terms):
    """sum c * x over (c, x) pairs, each x {index: coefficient} (an index a
    slot or a product)."""
    acc = {}
    for c, x in terms:
        for k, v in x.items():
            acc[k] = acc.get(k, 0) + c * v
    return {k: v for k, v in acc.items() if v}


def _comb(*terms):
    """_sum per component of field values (tuples of one such sum per
    component)."""
    return tuple(_sum(*((c, x[i]) for c, x in terms)) for i in range(len(terms[0][1])))


def _xi(x, c: int = 1):
    """c xi x for an Fp2 value x (xi = 1 + u)."""
    return _sum((c, x[0]), (-c, x[1])), _sum((c, x[0]), (c, x[1]))


class _K5Level:
    """One level of the schedule: its products and its reductions."""

    def __init__(self, plan, index: int):
        self.plan, self.index, self.comps = plan, index, plan.comps
        self.products, self.reds = [], []

    def _mul(self, x, y):
        self.products.append((x, y))
        return {len(self.products) - 1: 1}

    def mul(self, a, b):
        if self.comps == 1:
            return (self._mul(a[0], b[0]),)
        w0, w1 = self._mul(a[0], b[0]), self._mul(a[1], b[1])
        w2 = self._mul(_sum((1, a[0]), (1, a[1])), _sum((1, b[0]), (1, b[1])))
        return _sum((1, w0), (-1, w1)), _sum((1, w2), (-1, w0), (-1, w1))

    def sqr(self, a):
        if self.comps == 1:
            return self.mul(a, a)
        w0 = self._mul(_sum((1, a[0]), (1, a[1])), _sum((1, a[0]), (-1, a[1])))
        return w0, _sum((2, self._mul(a[0], a[1])))

    def mul_fp(self, a, s):
        """a (each component) times the Fp s: one product a component."""
        return tuple(self._mul(x, s[0]) for x in a)

    def reduce(self, *values, out: bool = False):
        """Reduce each value's components: into slots, as values of the
        later levels, or with `out` to the output's next Fp indices."""
        got = []
        for v in values:
            slots = []
            for sums in v:
                if out:
                    dest = self.plan.n_out
                    self.plan.n_out += 1
                else:
                    dest = ("slot", self.index, len(self.reds))
                    slots.append({dest: 1})
                self.reds.append((dest, sum(-d for d in sums.values() if d < 0), sums, out))
            got.append(tuple(slots))
        return None if out else got


class _K5Plan:
    """A schedule being written: its inputs (Fp values of the points, then
    of P), the inputs no slot may take (`kept`) and its two levels."""

    def __init__(self, comps: int, points: int, fps: int, kept=frozenset()):
        self.comps, self.n_out, self.kept = comps, 0, kept
        pt = [tuple({comps * i + c: 1} for c in range(comps)) for i in range(3 * points)]
        self.points = [pt[3 * k:3 * k + 3] for k in range(points)]
        base = 3 * comps * points
        self.fps = [({base + i: 1},) for i in range(fps)]
        self.inputs = base + fps
        self.levels = [_K5Level(self, i) for i in range(2)]

    def finish(self):
        """-> the levels [(products, reductions)] with the slots placed."""
        where = {i: i for i in range(self.inputs)}
        l0, l1 = self.levels
        if any(out for *_, out in l0.reds) or not all(out for *_, out in l1.reds):
            raise AssertionError("K5: level 0 reduces into slots, level 1 to the output")
        busy = {where[k] for x, y in l1.products for k in (*x, *y) if k in where} | self.kept
        free = (i for i in range(256) if i not in busy)
        for dest, *_ in l0.reds:
            where[dest] = next(free)
        levels = []
        for lv in self.levels:
            products = [tuple({where[k]: c for k, c in lin.items()} for lin in xy)
                        for xy in lv.products]
            reds = [(dest if out else where[dest], off, sums) for dest, off, sums, out in lv.reds]
            levels.append((products, reds))
        return levels


def _rcb_double(l0, l1, p, b3):
    """The complete doubling of point p over two levels: -> level 0's
    reductions Y^2, YZ, Z^2, XY and level 1's products q0 .. q3; the
    output is reduced by the caller."""
    X, Y, Z = p
    t0, t1, t2, txy = l0.reduce(l0.sqr(Y), l0.mul(Y, Z), l0.sqr(Z), l0.mul(X, Y))
    t2b = b3(t2)
    z8, y3s = _comb((8, t0)), _comb((1, t0), (1, t2b))
    t0p = _comb((1, t0), (-3, t2b))
    q = l1.mul(t2b, z8), l1.mul(t1, z8), l1.mul(t0p, y3s), l1.mul(t0p, txy)
    return (t0, t1, t2, txy), q


def _rcb_add(l0, l1, p, q, b3):
    """The complete sum p + q over two levels, its output reduced."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    t0, t1, t2 = l0.mul(X1, X2), l0.mul(Y1, Y2), l0.mul(Z1, Z2)
    m3 = l0.mul(_comb((1, X1), (1, Y1)), _comb((1, X2), (1, Y2)))
    m4 = l0.mul(_comb((1, Y1), (1, Z1)), _comb((1, Y2), (1, Z2)))
    m5 = l0.mul(_comb((1, X1), (1, Z1)), _comb((1, X2), (1, Z2)))
    t0, t1, t2, t3, t4, ty = l0.reduce(
        t0, t1, t2, _comb((1, m3), (-1, t0), (-1, t1)),
        _comb((1, m4), (-1, t1), (-1, t2)), _comb((1, m5), (-1, t0), (-1, t2)))
    t03, t2b, yb = _comb((3, t0)), b3(t2), b3(ty)
    z3s, t1b = _comb((1, t1), (1, t2b)), _comb((1, t1), (-1, t2b))
    p0, p1, p2 = l1.mul(t4, yb), l1.mul(t3, t1b), l1.mul(yb, t03)
    p3, p4, p5 = l1.mul(t1b, z3s), l1.mul(t03, t3), l1.mul(z3s, t4)
    l1.reduce(_comb((1, p1), (-1, p0)), _comb((1, p2), (1, p3)), _comb((1, p5), (1, p4)),
              out=True)


def k5_schedule(op: str):
    """-> (components per coordinate, the two levels [(products,
    reductions)]): a product (A, B), each {slot: coefficient}; a reduction
    (destination, offset o, {product: d})."""
    comps = 2 if op.startswith(("g2", "miller")) else 1
    add = op.endswith("_add")
    miller = op in K6_OPS
    plan = (_K5Plan(comps, 2, 3, K6_KEPT) if miller
            else _K5Plan(comps, 2 if add else 1, 0))
    l0, l1 = plan.levels

    def b3(x):                                  # [3b] x: 12 x (G1), 12 xi x (G2)
        return _comb((12, x)) if comps == 1 else _xi(x, 12)

    if add:
        _rcb_add(l0, l1, *plan.points, b3)
    else:
        (t0, t1, _, _), (q0, q1, q2, q3) = _rcb_double(l0, l1, plan.points[0], b3)
        l1.reduce(_comb((2, q3)), _comb((1, q0), (1, q2)), q1, out=True)
    if miller:
        px, py, pz = plan.fps
    if miller and add:
        # The line through T and Q (pairing._add_step_plain), P's products
        # at level 0: n = yq Z1 - Y1 zq, d = xq Z1 - X1 zq; l0 = xi d (Z1
        # py), l1 = n (X1 pz) - d (Y1 pz), l2 = -n (Z1 px).
        (X1, Y1, Z1), (xq, yq, zq) = plan.points
        a, b = l0.mul(yq, Z1), l0.mul(xq, Z1)
        c, d = l0.mul(Y1, zq), l0.mul(X1, zq)
        n, d = l0.reduce(_comb((1, a), (-1, c)), _comb((1, b), (-1, d)))
        z1py, z1px, x1pz, y1pz = l0.reduce(l0.mul_fp(Z1, py), l0.mul_fp(Z1, px),
                                           l0.mul_fp(X1, pz), l0.mul_fp(Y1, pz))
        l1.reduce(_xi(l1.mul(d, z1py)), _comb((1, l1.mul(n, x1pz)), (-1, l1.mul(d, y1pz))),
                  _comb((-1, l1.mul(n, z1px))), out=True)
    elif miller:
        # The tangent line at T (pairing._dbl_step_plain), P's products at
        # level 0: l0 = 2 xi (YZ)(Z py), l1 = (3 X^2)(X pz) - (2 Y^2)(Z pz),
        # l2 = -(3 X^2)(Z px), the multiples in the operands.
        X, Y, Z = plan.points[0]
        X2, zpy, zpx, xpz, zpz = l0.reduce(l0.sqr(X), l0.mul_fp(Z, py), l0.mul_fp(Z, px),
                                           l0.mul_fp(X, pz), l0.mul_fp(Z, pz))
        x2t, y2t = _comb((3, X2)), _comb((2, t0))
        l1.reduce(_xi(l1.mul(t1, zpy), 2), _comb((1, l1.mul(x2t, xpz)), (-1, l1.mul(y2t, zpz))),
                  _comb((-1, l1.mul(x2t, zpx))), out=True)
    levels = plan.finish()
    _k5_check(levels)
    return comps, levels


def _k5_check(levels):
    """The bounds the kernel relies on, per the comment above."""
    for products, reds in levels:
        for x, y in products:
            for lin in (x, y):
                if len(lin) > K5_LIN or any(not 0 < abs(c) < 1 << 16 for c in lin.values()):
                    raise AssertionError(f"K5 operand out of range: {lin}")
                if any(not 0 <= s < 256 for s in lin):
                    raise AssertionError(f"K5 slot out of range: {lin}")
        for dest, off, sums in reds:
            pos = sum(d for d in sums.values() if d > 0)
            if len(sums) > K5_RED or any(abs(d) > 255 for d in sums.values()):
                raise AssertionError(f"K5 reduction out of range: {sums}")
            if pos * (P - 1) ** 2 + off * P * P >= K5_REDC_BOUND:
                raise AssertionError(f"K5 reduction above REDC's bound: {sums}")
            if not 0 <= dest < 256:
                raise AssertionError(f"K5 destination out of range: {dest}")


def k5_plan_words(op: str):
    """The schedule as the kernel reads it (the comment above)."""
    words = []
    for products, reds in k5_schedule(op)[1]:
        for x, y in products:
            for lin in (x, y):
                terms = [K5_HAS | s | abs(c) << 8 | (c < 0) << 24 for s, c in lin.items()]
                words += terms + [0] * (K5_LIN - len(terms))
        for dest, off, sums in reds:
            terms = [K5_HAS | i | abs(d) << 8 | (d < 0) << 16 for i, d in sums.items()]
            words += [off | dest << 8 | len(terms) << 16] + terms + [0] * (K5_RED - len(terms))
    return words


def k5_counts(op: str) -> dict:
    """The counts of op's struct in curve_plan.h: components, input Fp values
    (fps of them P's), products and reductions per level, slots, the widest
    level's products, the units a point (warps) and the schedule's words."""
    comps, levels = k5_schedule(op)
    fps = 3 if op in K6_OPS else 0
    inputs = K6_INPUTS if op in K6_OPS else (2 if op.endswith("_add") else 1) * 3 * comps
    slots = max([inputs] + [d + 1 for d, _, _ in levels[0][1]])
    per = {}
    for i, (products, reds) in enumerate(levels):
        per[f"np{i}"], per[f"nr{i}"] = len(products), len(reds)
    return {"comps": comps, "inputs": inputs, "fps": fps, **per,
            "slots": slots, "wide": max(len(p) for p, _ in levels),
            "warps": max([inputs] + [max(len(p), len(r)) for p, r in levels]),
            "words": len(k5_plan_words(op))}


def k5_plan_header() -> str:
    """csrc/curve_op.cu's generated header (written at build time by
    ``_build``): per operation a struct of its counts, with its schedule's
    words in device memory."""
    lines = ["// Generated by lighthouse_tpu_torch/ops/fused.py (k5_plan_header) from",
             "// k5_schedule: the schedule of csrc/curve_op.cu. Do not edit.",
             "#pragma once", "#include <cstdint>",
             f"#define LH_K5_LIN {K5_LIN}", f"#define LH_K5_RED {K5_RED}"]
    for op in K5_OPS + K6_OPS:
        words = k5_plan_words(op)
        kernel = "K6" if op in K6_OPS else "K5"
        name = "".join(part.capitalize() for part in op.split("_"))
        counts = ", ".join(f"{k} = {v}" for k, v in k5_counts(op).items())
        rows = ",\n".join("    " + ", ".join(f"0x{w:08x}u" for w in words[i:i + 6])
                          for i in range(0, len(words), 6))
        lines += [f"struct {kernel}{name} {{",
                  f"  static constexpr int {counts};",
                  "  static __device__ __forceinline__ const uint32_t* plan();",
                  "};",
                  f"__device__ const uint32_t k{kernel}Plan{name}[{len(words)}] = {{", rows, "};",
                  f"__device__ __forceinline__ const uint32_t* {kernel}{name}::plan() "
                  f"{{ return k{kernel}Plan{name}; }}"]
    return "\n".join(lines) + "\n"


PLAIN = {
    "fp_mul": fp_mul_plain, "fp_sqr": fp_sqr_plain,
    "fp2_mul": fp2_mul_plain, "fp2_sqr": fp2_sqr_plain,
    "fp12_sqr": fp12_sqr_plain, "fp12_mul": fp12_mul_plain,
    "fp12_line": fp12_mul_line_plain,
    "fp_add": fp_add_plain, "fp_sub": fp_sub_plain, "fp_neg": fp_neg_plain,
    "fp_mul_small": fp_mul_small_plain, "fp_lincomb": fp_lincomb_plain,
}


def _curve_plain(group: str, op: str):
    """K5's plain versions: the formulas of curves._Group on the plain
    versions above (curves imports this module, so it is looked up at call
    time)."""
    def plain(*xs):
        from . import curves
        return getattr(getattr(curves, group), op)(*xs)
    return plain


PLAIN.update({f"{g.lower()}_{op}": _curve_plain(g, f"_{op}_plain")
              for g in ("G1", "G2") for op in ("add", "double")})


def _miller_plain(step: str):
    """K6's plain versions: pairing's step compositions on the plain
    versions of the field kernels (pairing imports this module)."""
    def plain(*xs):
        from . import pairing
        return getattr(pairing, step)(*xs)
    return plain


def miller_chain_plain(t, q, px, py, pz, steps=MILLER_STEPS):
    """K6's chain, plain: pairing's step compositions in `steps`' order
    (0 a doubling, 1 an addition of Q) -> (the last T, the lines stacked,
    (len(steps), ..., 3, 2, 12, n))."""
    from . import pairing
    lines = []
    for add in steps:
        t, line = (pairing._add_step_plain(t, q, px, py, pz) if add
                   else pairing._dbl_step_plain(t, px, py, pz))
        lines.append(line)
    return t, torch.stack(lines)


PLAIN.update(miller_dbl=_miller_plain("_dbl_step_plain"),
             miller_add=_miller_plain("_add_step_plain"), miller_chain=miller_chain_plain)


def pow_digits(exponent: int) -> list:
    """exponent's 4-bit digits, most significant first ([0] for 0): what
    K7's Fp mode reads from its digit buffer."""
    digits = []
    while exponent:
        digits.append(exponent & 15)
        exponent >>= 4
    return digits[::-1] or [0]


def fp2_pow_digits(exponent: int) -> list:
    """What K7's Fp2 mode reads: exponent = A p + B (B < p) as one byte a
    window, most significant first, B's digit in the low nibble and A's in
    the high one (a^e = conj(a)^A a^B in Fp2)."""
    a, b = (pow_digits(x) for x in divmod(exponent, P))
    width = max(len(a), len(b))
    a, b = [0] * (width - len(a)) + a, [0] * (width - len(b)) + b
    return [(hi << 4) | lo for hi, lo in zip(a, b)]


def pow_loop(a, exponent: int, one, mul, sqr):
    """a^exponent for a public exponent by a 4-bit fixed window
    (ops/bm/limbs.py pow_fixed semantics), one mul or sqr call a step; one
    broadcasts to a. K7's plain version on K1's or K2's."""
    if exponent == 0:
        return one.expand_as(a).contiguous()
    if exponent < 16:
        acc = a
        for c in bin(exponent)[3:]:
            acc = sqr(acc)
            if c == "1":
                acc = mul(acc, a)
        return acc
    digits = pow_digits(exponent)
    table = [one.expand_as(a).contiguous(), a, sqr(a)]
    for _ in range(13):
        table.append(mul(table[-1], a))
    acc = table[digits[0]]
    for d in digits[1:]:
        acc = sqr(sqr(sqr(sqr(acc))))
        if d:
            acc = mul(acc, table[d])
    return acc


def fp_pow_plain(a, exponent: int):
    from . import limbs     # imports this module: bound at call time
    return pow_loop(a, exponent, limbs.one(a.device), fp_mul_plain, fp_sqr_plain)


def fp2_pow_plain(a, exponent: int):
    from . import tower
    return pow_loop(a, exponent, tower.consts(a.device).fp2_one, fp2_mul_plain, fp2_sqr_plain)


def fp_inv_plain(a):
    """a^-1 as a^(p - 2) (0 for 0): K7's binary GCD computes the same value."""
    return fp_pow_plain(a, P - 2)


PLAIN.update(fp_inv=fp_inv_plain, fp_pow=fp_pow_plain, fp2_pow=fp2_pow_plain)

# --------------------------------------------------------------------------
# Wrappers
# --------------------------------------------------------------------------

_TAIL = {"fp": (NL,), "fp2": (2, NL), "fp12": (2, 3, 2, NL), "line": (3, 2, NL),
         "g1": (3, NL), "g2": (3, 2, NL)}

# kernel name -> (library, C entry point, operand kinds)
_KERNELS = {
    "fp_mul": ("fp_mul", "lh_fp_mul", ("fp", "fp")),
    "fp_sqr": ("fp_mul", "lh_fp_sqr", ("fp",)),
    "fp2_mul": ("fp2_mul", "lh_fp2_mul", ("fp2", "fp2")),
    "fp2_sqr": ("fp2_mul", "lh_fp2_sqr", ("fp2",)),
    "fp12_sqr": ("fp12_op", "lh_fp12_sqr", ("fp12",)),
    "fp12_mul": ("fp12_op", "lh_fp12_mul", ("fp12", "fp12")),
    "fp12_line": ("fp12_op", "lh_fp12_line", ("fp12", "line")),
    # K4, one kernel: fp_lincomb launches through _run_lincomb, its one-row
    # plans through _run_additive. fp_lincomb's operands are (..., J, 12, n).
    "fp_add": ("fp_add", "lh_fp_lincomb", ("fp", "fp")),
    "fp_sub": ("fp_add", "lh_fp_lincomb", ("fp", "fp")),
    "fp_neg": ("fp_add", "lh_fp_lincomb", ("fp",)),
    "fp_mul_small": ("fp_add", "lh_fp_lincomb", ("fp",)),
    "fp_lincomb": ("fp_add", "lh_fp_lincomb", ("fp",)),
    # K5 launches through _run_curve.
    "g1_add": ("curve_op", "lh_g1_add", ("g1", "g1")),
    "g1_double": ("curve_op", "lh_g1_dbl", ("g1",)),
    "g2_add": ("curve_op", "lh_g2_add", ("g2", "g2")),
    "g2_double": ("curve_op", "lh_g2_dbl", ("g2",)),
    # K6 (the same library, one kernel) launches through _run_miller: the
    # chain, and its one-step calls.
    "miller_dbl": ("curve_op", "lh_miller_chain", ("g2", "fp", "fp", "fp")),
    "miller_add": ("curve_op", "lh_miller_chain", ("g2", "g2", "fp", "fp", "fp")),
    "miller_chain": ("curve_op", "lh_miller_chain", ("g2", "g2", "fp", "fp", "fp")),
    # K7: the inverse launches through _run, the powers through _run_pow.
    "fp_inv": ("fp_pow", "lh_fp_inv", ("fp",)),
    "fp_pow": ("fp_pow", "lh_fp_pow", ("fp",)),
    "fp2_pow": ("fp_pow", "lh_fp2_pow", ("fp2",)),
}


def _check(name, xs):
    kinds = _KERNELS[name][2]
    a = xs[0]
    lead = None
    for x, kind in zip(xs, kinds):
        tail = _TAIL[kind]
        if not isinstance(x, torch.Tensor) or x.dtype != torch.int32:
            raise TypeError(f"{name}: operands must be int32 tensors")
        if x.dim() < len(tail) + 1 or tuple(x.shape[-len(tail) - 1:-1]) != tail:
            raise ValueError(f"{name}: operand shape {tuple(x.shape)} does not end in {tail} + (n,)")
        if x.device != a.device:
            raise ValueError(f"{name}: operands on {a.device} and {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        this = (tuple(x.shape[:-len(tail) - 1]), x.shape[-1])
        if lead is not None and this != lead:
            raise ValueError(f"{name}: operand batch shapes differ: {lead} vs {this}")
        lead = this


def _launch(name, out, xs):
    lib_name, entry, kinds = _KERNELS[name]
    n = out.shape[-1]
    rows = out.numel() // (n * math.prod(_TAIL[kinds[0]]))
    # The current stream's cudaStream_t, read as torch's own kernel
    # launchers read it: torch.cuda.current_stream() builds a Stream object
    # and costs ten times as much (chip_smoke.py, wrapper phase).
    stream = torch._C._cuda_getCurrentRawStream(out.device.index)
    fn = getattr(_build.library(lib_name), entry)
    return fn(out.data_ptr(), *(x.data_ptr() for x in xs), rows, n, stream)


def _run(name, *xs):
    _check(name, xs)
    a = xs[0]
    if a.device.type == "cpu":
        return PLAIN[name](*xs)
    if a.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {a.device}")
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    if a.device.index == torch.cuda.current_device():
        rc = _launch(name, out, xs)
    else:
        with torch.cuda.device(a.device):
            rc = _launch(name, out, xs)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t {rc}")
    launches[name] += 1
    return out


def fp_mul(a, b):
    """K1: a * b * 2^-384 mod p (the Montgomery product) on (..., 12, n)."""
    return _run("fp_mul", a, b)


def fp_sqr(a):
    return _run("fp_sqr", a)


def fp2_mul(a, b):
    """K2: Fp2 product on (..., 2, 12, n), one lazy reduction per output."""
    return _run("fp2_mul", a, b)


def fp2_sqr(a):
    return _run("fp2_sqr", a)


def fp12_sqr(a):
    """K3: whole Fp12 square on (..., 2, 3, 2, 12, n)."""
    return _run("fp12_sqr", a)


def fp12_mul(a, b):
    return _run("fp12_mul", a, b)


def fp12_mul_line(a, line):
    """K3: a * (l0 + l1 w^3 + l2 w^5), line = stack(l0, l1, l2) of shape
    (..., 3, 2, 12, n)."""
    return _run("fp12_line", a, line)


# --- K4 ---------------------------------------------------------------------
#
# K4 evaluates a plan of signed linear combinations, out[r] = sum_j C[r][j]
# x[j] mod p, in one launch (csrc/fp_add.cu): the terms x[j] are the Fp
# values on axis -3 of one operand tensor (..., J, 12, n), or of up to
# LINCOMB_MAX_OPS of them in order, strided or broadcast, read in place;
# the output is a fresh (..., R, 12, n), R = len(C). A call site keeps its
# coefficient matrix as a constant tuple of rows; its packed plan and each
# operand layout's geometry are made once and kept. fp_add, fp_sub, fp_neg
# and fp_mul_small are one-row plans of the same kernel, each with its own
# launch count.

LINCOMB_MAX_OPS = 4
LINCOMB_MAX_TERMS = 64          # J_o, a term's 6 bits in a plan word
LINCOMB_MAX_ROWS = 32           # R
LINCOMB_MAX_WORDS = 128         # nonzero coefficients of a plan
LINCOMB_MAX_COEFF = (1 << 16) - 1
LINCOMB_MAX_SUM = (1 << 18) - 1     # sum_j |C[r][j]|: v < 2^18 p, v_hi < 2^47
MUL_SMALL_MAX = 1 << 16
_FNS: dict = {}
_LINCOMB_GEOMETRY: dict = {}    # ((shape, strides) per operand) -> (lead, rows, n, geometry)
# The paths' plans by call site, registered where they are defined: chip_smoke
# holds the kernel at each of them.
LINCOMB_PLANS: dict = {}


def _kernel_fn(name):
    """K4's and K5's C function for `name`, resolved once."""
    fn = _FNS.get(name)
    if fn is None:
        lib, entry, _ = _KERNELS[name]
        fn = _FNS[name] = getattr(_build.library(lib), entry)
    return fn


def _broadcast_shape(s, t):
    """torch.broadcast_shapes for two shapes, at a tenth of its host time."""
    if len(s) < len(t):
        s, t = t, s
    t = (1,) * (len(s) - len(t)) + tuple(t)
    out = []
    for u, v in zip(s, t):
        if u != v and v != 1 and u != 1:
            raise ValueError(f"shapes {tuple(s)} and {tuple(t)} do not broadcast")
        out.append(v if u == 1 else u)
    return tuple(out)


def _geometry(shape, xs, tail: int = 2):
    """Each input's element strides over an output of `shape`, its lead
    axes (all but the last `tail`: (J, 12, n) for K4, (3, 12, n) or
    (3, 2, 12, n) for K5) folded into two row levels (r1, r0): -> (r0,
    [(s1, s0, strides of the tail axes...) per input]), or None where the
    lead axes fold into more than two levels. A broadcast axis has stride
    0."""
    nd = len(shape)
    strides = []
    for x in xs:
        off = nd - x.dim()
        s = [0] * nd
        for i, (size, st) in enumerate(zip(x.shape, x.stride())):
            if size != 1:
                s[off + i] = st
        strides.append(s)
    dims = []                                   # [(size, [stride per input])], outer first
    for i in range(nd - tail):
        size = shape[i]
        if size == 1:
            continue
        cur = [s[i] for s in strides]
        if dims and all(prev == st * size for prev, st in zip(dims[-1][1], cur)):
            dims[-1] = (dims[-1][0] * size, cur)
        else:
            dims.append((size, cur))
    if len(dims) > 2:
        return None
    while len(dims) < 2:
        dims.insert(0, (1, [0] * len(xs)))
    (_, s1), (r0, s0) = dims
    return r0, [(s1[k], s0[k], *strides[k][nd - tail:]) for k in range(len(xs))]


def _layout(xs, tail: int):
    """The output of one K5 launch over inputs xs (broadcast), the
    inputs its pointers will refer to, its rows and n, and the inputs'
    folded strides from _geometry (None for dense inputs, each of the
    output's shape and contiguous, and for lead axes that fold into no two
    levels, which are copied dense)."""
    a, b = xs[0], xs[-1]
    folded = None
    if a.shape == b.shape and a.is_contiguous() and b.is_contiguous():
        out = torch.empty_like(a)
    else:
        shape = _broadcast_shape(a.shape, b.shape)
        out = torch.empty(shape, dtype=torch.int32, device=a.device)
        folded = _geometry(shape, xs, tail)
        if folded is None:
            xs = [x.expand(shape).contiguous() for x in xs]
    n = out.shape[-1]
    rows = out.numel() // (math.prod(out.shape[-tail:-1]) * n) if n else 0
    return out, xs, rows, n, folded


def _geometry_array(folded):
    """_geometry's (r0, strides per input) as the int64 array the C entry
    points read, or None."""
    if folded is None:
        return None
    r0, strides = folded
    return (ctypes.c_longlong * (1 + sum(map(len, strides))))(r0, *(v for g in strides for v in g))


def _check_coeffs(coeffs, terms):
    """The bounds csrc/fp_add.cu states, on a coefficient matrix over the
    operands' term counts `terms`."""
    j = sum(terms)
    if not 1 <= len(coeffs) <= LINCOMB_MAX_ROWS:
        raise ValueError(f"fp_lincomb: {len(coeffs)} rows, the kernel takes 1 to "
                         f"{LINCOMB_MAX_ROWS}")
    if not all(1 <= t <= LINCOMB_MAX_TERMS for t in terms):
        raise ValueError(f"fp_lincomb: operands of {terms} terms, at most "
                         f"{LINCOMB_MAX_TERMS} each")
    words = 0
    for row in coeffs:
        if len(row) != j:
            raise ValueError(f"fp_lincomb: a row of {len(row)} coefficients for {j} terms")
        if not all(type(c) is int and abs(c) <= LINCOMB_MAX_COEFF for c in row):
            raise ValueError(f"fp_lincomb: coefficients {row} are not ints of magnitude at most "
                             f"{LINCOMB_MAX_COEFF}")
        if sum(map(abs, row)) > LINCOMB_MAX_SUM:
            raise ValueError(f"fp_lincomb: a row's |coefficients| sum past {LINCOMB_MAX_SUM}")
        words += sum(1 for c in row if c)
    if words > LINCOMB_MAX_WORDS:
        raise ValueError(f"fp_lincomb: {words} nonzero coefficients, at most "
                         f"{LINCOMB_MAX_WORDS}")


@lru_cache(maxsize=512)
def _lincomb_plan(coeffs, terms):
    """The plan the C entry point reads (uint32): R, each row's first word
    (R + 1 offsets), then one word per nonzero coefficient, row by row: term
    | operand << 6 | coefficient << 8 (signed, 24 bits)."""
    _check_coeffs(coeffs, terms)
    where = [(o, j) for o, t in enumerate(terms) for j in range(t)]
    words, start = [], [0]
    for row in coeffs:
        words += [j | o << 6 | (c & 0xFFFFFF) << 8 for (o, j), c in zip(where, row) if c]
        start.append(len(words))
    vals = [len(coeffs)] + start + words
    return (ctypes.c_uint32 * len(vals))(*vals)


def lincomb_plan(name: str, coeffs):
    """A call site's coefficient matrix as the tuple of rows fp_lincomb
    takes, checked, and registered under `name` in LINCOMB_PLANS."""
    coeffs = tuple(tuple(row) for row in coeffs)
    _check_coeffs(coeffs, (len(coeffs[0]),))
    LINCOMB_PLANS[name] = coeffs
    return coeffs


def _lincomb_operands(x):
    return (x,) if isinstance(x, torch.Tensor) else tuple(x)


def _check_lincomb(xs, coeffs):
    if not 1 <= len(xs) <= LINCOMB_MAX_OPS:
        raise ValueError(f"fp_lincomb: {len(xs)} operands, the kernel takes 1 to "
                         f"{LINCOMB_MAX_OPS}")
    a = xs[0]
    for x in xs:
        if not isinstance(x, torch.Tensor) or x.dtype != torch.int32:
            raise TypeError("fp_lincomb: operands must be int32 tensors")
        if x.dim() < 3 or x.shape[-2] != NL:
            raise ValueError(f"fp_lincomb: operand shape {tuple(x.shape)} does not end in "
                             "(J, 12, n)")
        if x.device != a.device:
            raise ValueError(f"fp_lincomb: operands on {a.device} and {x.device}")
    return _lincomb_plan(coeffs, tuple(x.shape[-3] for x in xs))


def _lincomb_shape(xs):
    """The output's lead axes and n: the operands' broadcast."""
    lead, n = (), 1
    for x in xs:
        lead = _broadcast_shape(lead, x.shape[:-3])
        n = _broadcast_shape((n,), x.shape[-1:])[0]
    return tuple(lead), n


def _lincomb_geometry(xs):
    """(lead, rows, n, geometry array) of one launch: r0, then per operand
    its term count and element strides s1, s0 over the output's two row
    levels and sj, sl, sn; or None for the geometry where the lead axes fold
    into no two levels."""
    lead, n = _lincomb_shape(xs)
    folded = _geometry(lead + (1, NL, n), xs, 3)
    if folded is None:
        return lead, 0, n, None
    r0, strides = folded
    vals = [r0] + [v for x, st in zip(xs, strides) for v in (x.shape[-3],) + tuple(st)]
    return lead, math.prod(lead), n, (ctypes.c_longlong * len(vals))(*vals)


def _lincomb_args(xs, coeffs, plan=None):
    """The output of one K4 launch and the C entry point's arguments but the
    stream: the output's data pointer, the operands' (an array), their
    count, the lead rows, n, the plan (`plan`, or packed here) and the
    geometry. Also returns the operands the pointers refer to, which the
    caller keeps alive over the launch (copied dense where their lead axes
    fold into no two levels)."""
    key = tuple((x.shape, x.stride()) for x in xs)
    geo = _LINCOMB_GEOMETRY.get(key)
    if geo is None:
        geo = _lincomb_geometry(xs)
        if geo[3] is None:
            xs = tuple(x.expand(geo[0] + x.shape[-3:]).contiguous() for x in xs)
            geo = _lincomb_geometry(xs)
        elif len(_LINCOMB_GEOMETRY) < 256:
            _LINCOMB_GEOMETRY[key] = geo
    lead, rows, n, geom = geo
    out = torch.empty(lead + (len(coeffs), NL, n), dtype=torch.int32, device=xs[0].device)
    ptrs = (ctypes.c_void_p * len(xs))(*(x.data_ptr() for x in xs))
    if plan is None:
        plan = _lincomb_plan(coeffs, tuple(x.shape[-3] for x in xs))
    return out, xs, [out.data_ptr(), ptrs, len(xs), rows, n, plan, geom]


def _call_kernel(name, args, dev):
    """K4's or K5's C entry point on the current stream of `dev`; a
    nonzero cudaError_t raises."""
    fn = _kernel_fn(name)
    if dev.index == torch.cuda.current_device():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t {rc}")
    launches[name] += 1


def _run_lincomb(xs, coeffs):
    plan = _check_lincomb(xs, coeffs)
    dev = xs[0].device
    if dev.type == "cpu":
        return fp_lincomb_plain(xs, coeffs)
    if dev.type != "cuda":
        raise ValueError(f"fp_lincomb: no kernel for device {dev}")
    out, _inputs, args = _lincomb_args(xs, coeffs, plan)
    if out.numel():
        _call_kernel("fp_lincomb", args, dev)
    return out


def fp_lincomb(x, coeffs):
    """K4: out[..., r, :, :] = sum_j coeffs[r][j] x_j mod p, one launch. x is
    a tensor (..., J, 12, n) whose terms x_j lie on axis -3, or a sequence
    of up to four such tensors, their terms in order; the operands
    broadcast. coeffs is a tuple of R tuples of J ints (lincomb_plan), within
    the bounds of csrc/fp_add.cu. -> (..., R, 12, n), canonical."""
    return _run_lincomb(_lincomb_operands(x), coeffs if type(coeffs) is tuple
                        else tuple(tuple(row) for row in coeffs))


# The older entry points, one-row plans over their operands as single terms.
_ONE_ROW = {"fp_add": ((1, 1),), "fp_sub": ((1, -1),), "fp_neg": ((-1,),)}


@lru_cache(maxsize=64)
def _mul_small_row(k: int):
    return ((k,),)


def _k4_args(name, xs, k):
    """_lincomb_args for fp_add, fp_sub, fp_neg or fp_mul_small (k its
    multiple) on (..., 12, n) operands."""
    return _lincomb_args(tuple(x.unsqueeze(-3) for x in xs),
                         _mul_small_row(k) if name == "fp_mul_small" else _ONE_ROW[name])


def _check_additive(name, xs, k):
    a = xs[0]
    for x in xs:
        if not isinstance(x, torch.Tensor) or x.dtype != torch.int32:
            raise TypeError(f"{name}: operands must be int32 tensors")
        if x.dim() < 2 or x.shape[-2] != NL:
            raise ValueError(f"{name}: operand shape {tuple(x.shape)} does not end in (12, n)")
        if x.device != a.device:
            raise ValueError(f"{name}: operands on {a.device} and {x.device}")
    if name == "fp_mul_small" and not (isinstance(k, int) and 1 <= k < MUL_SMALL_MAX):
        raise ValueError(f"fp_mul_small: k = {k!r} is not an int in [1, 2^16)")


def _run_additive(name, xs, k=0):
    _check_additive(name, xs, k)
    dev = xs[0].device
    if dev.type == "cpu":
        return PLAIN[name](*xs, k) if name == "fp_mul_small" else PLAIN[name](*xs)
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    out, _inputs, args = _k4_args(name, xs, k)
    if out.numel():
        _call_kernel(name, args, dev)
    return out.squeeze(-3)


def fp_add(a, b):
    """K4: a + b mod p on (..., 12, n), the operands broadcast."""
    return _run_additive("fp_add", (a, b))


def fp_sub(a, b):
    """K4: a - b mod p, the operands broadcast."""
    return _run_additive("fp_sub", (a, b))


def fp_neg(a):
    """K4: -a mod p (0 for 0)."""
    return _run_additive("fp_neg", (a,))


def fp_mul_small(a, k: int):
    """K4: k a mod p for an int 1 <= k < 2^16."""
    return _run_additive("fp_mul_small", (a,), k)


# --- K5 ---------------------------------------------------------------------
#
# K5's wrapper follows K4's: the C function resolved once, the checks that a
# wrong call would corrupt (dtype, the point's axes, the device), and strided
# and broadcast points handed to the kernel as they are, their strides folded
# into K4's two row levels plus the coordinate, component, limb and column
# strides.

def _k5_args(name, xs):
    """The output of one K5 launch and the C entry point's arguments but the
    stream: the data pointers, rows, n and the geometry (None for dense
    inputs, else an int64 array of r0 and per input s1, s0 and the
    coordinate, component (0 for G1), limb and column strides). Also returns
    the inputs the pointers refer to, which the caller keeps alive over the
    launch."""
    tail = len(_TAIL[_KERNELS[name][2][0]]) + 1
    out, xs, rows, n, folded = _layout(xs, tail)
    if folded is not None and tail == 3:        # G1: no component axis
        r0, strides = folded
        folded = r0, [(s1, s0, sc, 0, sl, sn) for s1, s0, sc, sl, sn in strides]
    return out, xs, [out.data_ptr()] + [x.data_ptr() for x in xs] + [rows, n,
                                                                   _geometry_array(folded)]


def _check_kinds(name, xs, noun):
    """K5's and K6's checks: each operand an int32 tensor ending in its
    kind's tail + (n,), all on one device -> that device."""
    dev = xs[0].device
    for x, kind in zip(xs, _KERNELS[name][2]):
        tail = _TAIL[kind]
        if not isinstance(x, torch.Tensor) or x.dtype != torch.int32:
            raise TypeError(f"{name}: {noun}s must be int32 tensors")
        if x.dim() <= len(tail) or tuple(x.shape[-len(tail) - 1:-1]) != tail:
            raise ValueError(f"{name}: {noun} shape {tuple(x.shape)} does not end in {tail} + (n,)")
        if x.device != dev:
            raise ValueError(f"{name}: {noun}s on {dev} and {x.device}")
    return dev


def _run_curve(name, xs):
    dev = _check_kinds(name, xs, "point")
    if dev.type == "cpu":
        return PLAIN[name](*xs)
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    out, _inputs, args = _k5_args(name, xs)
    if out.numel():
        _call_kernel(name, args, dev)
    return out


def g1_add(p, q):
    """K5: the complete sum p + q of G1 points (..., 3, 12, n), broadcast."""
    return _run_curve("g1_add", (p, q))


def g1_double(p):
    """K5: 2 p for G1 points (..., 3, 12, n)."""
    return _run_curve("g1_double", (p,))


def g2_add(p, q):
    """K5: the complete sum p + q of G2 points (..., 3, 2, 12, n), broadcast."""
    return _run_curve("g2_add", (p, q))


def g2_double(p):
    """K5: 2 p for G2 points (..., 3, 2, 12, n)."""
    return _run_curve("g2_double", (p,))


# --- K6 ---------------------------------------------------------------------
#
# K6's wrapper follows K5's. Each of P's coordinates (..., 12, n) is viewed
# with a G2 point's tail, its coordinate and component axes of size 1
# (stride 0), so that one geometry (K5's six strides) addresses the point
# operands and P's coordinates alike, strided (p_proj.select(-3, i)) or
# broadcast in place. One kernel runs a chain of steps: the Miller loop's
# (MILLER_STEPS), or one step (a doubling, whose launch takes T in Q's
# place, unread). The outputs are two dense tensors: the last T, of the
# operands' broadcast shape, and the lines, one a step in the layout K3's
# fp12_mul_line reads, (steps, ..., 3, 2, 12, n). The steps reach the
# kernel as launch arguments (one bit a step), so a graph that captured a
# launch replays the same chain.

_K6_STEPS = {"miller_dbl": (0,), "miller_add": (1,), "miller_chain": MILLER_STEPS}
_K6_KINDS = ("g2", "g2", "fp", "fp", "fp")
_K6_GEOMETRY: dict = {}      # (name, (shape, strides) per operand) -> launch geometry


@lru_cache(maxsize=None)
def _k6_steps(name):
    """name's steps as the C entry point reads them: a byte a step."""
    steps = _K6_STEPS[name]
    if not 0 < len(steps) <= K6_MAX_STEPS:
        raise ValueError(f"{name}: {len(steps)} steps, the kernel takes 1 to {K6_MAX_STEPS}")
    return (ctypes.c_uint8 * len(steps))(*steps)


def _k6_geometry(xs):
    """(T's shape, rows, n, geometry array or None) of one K6 launch on
    the operands (T, Q, px, py, pz); None where their lead axes fold into
    no two levels."""
    views = [x if kind == "g2" else x[..., None, None, :, :] for x, kind in zip(xs, _K6_KINDS)]
    shape = views[0].shape
    for v in views[1:]:
        shape = _broadcast_shape(shape, v.shape)
    n = shape[-1]
    rows = math.prod(shape[:-4]) if n else 0
    folded = _geometry(shape, views, 4)
    return tuple(shape), rows, n, None if folded is None else _geometry_array(folded)


def _k6_args(name, xs):
    """The outputs (T, lines) of one K6 launch and the C entry point's
    arguments but the stream: both outputs' and the operands' (T, Q, px,
    py, pz) data pointers, rows, n, the steps and their count, and the
    geometry (always given: r0, then per operand s1, s0 and the coordinate,
    component, limb and column strides). Also returns the operands the
    pointers refer to, which the caller keeps alive over the launch. The
    geometry is kept per operand shapes and strides: a path gives K6 a
    handful of them."""
    if name == "miller_dbl":                    # no Q: T in its place, unread
        xs = (xs[0],) + tuple(xs)
    key = (name,) + tuple((x.shape, x.stride()) for x in xs)
    geo = _K6_GEOMETRY.get(key)
    if geo is None:
        geo = _k6_geometry(xs)
        if geo[3] is None:                      # copied dense over the lead axes
            lead = geo[0][:-4]
            xs = [x.expand(lead + x.shape[-4 if kind == "g2" else -2:]).contiguous()
                  for x, kind in zip(xs, _K6_KINDS)]
            geo = _k6_geometry(xs)
        elif len(_K6_GEOMETRY) < 256:
            _K6_GEOMETRY[key] = geo
    shape, rows, n, geom = geo
    steps = _k6_steps(name)
    out = torch.empty(shape, dtype=torch.int32, device=xs[0].device)
    lines = torch.empty((len(steps),) + shape, dtype=torch.int32, device=xs[0].device)
    args = ([out.data_ptr(), lines.data_ptr()] + [x.data_ptr() for x in xs]
            + [rows, n, steps, len(steps), geom])
    return (out, lines), xs, args


def _run_miller(name, xs):
    dev = _check_kinds(name, xs, "operand")
    if dev.type == "cpu":
        return PLAIN[name](*xs)
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    (out, lines), _inputs, args = _k6_args(name, xs)
    if out.numel():
        _call_kernel(name, args, dev)
    return (out, lines) if name == "miller_chain" else (out, lines[0])


def miller_chain(t, q, px, py, pz):
    """K6: the Miller loop's T chain, MILLER_STEPS from T (..., 3, 2, 12, n)
    with Q (the same tail) and P's coordinates (..., 12, n), broadcast, one
    launch -> (the last T, the lines (68, ..., 3, 2, 12, n): line s is
    step s's l0, l1, l2 at P)."""
    return _run_miller("miller_chain", (t, q, px, py, pz))


def miller_dbl(t, px, py, pz):
    """K6, one step: the Miller loop's doubling step, T (..., 3, 2, 12, n)
    and P's coordinates (..., 12, n), broadcast -> (2T, the tangent line at
    T evaluated at P, (..., 3, 2, 12, n): l0, l1, l2)."""
    return _run_miller("miller_dbl", (t, px, py, pz))


def miller_add(t, q, px, py, pz):
    """K6, one step: the addition step -> (T + Q, the line through T and Q
    at P)."""
    return _run_miller("miller_add", (t, q, px, py, pz))


# --- K7 ---------------------------------------------------------------------
#
# K7 reads the exponent's digits (pow_digits, fp2_pow_digits) from a device
# buffer made once per mode, exponent and device and kept here, so a CUDA
# graph that captured a launch reads a live buffer at every replay and no
# capture holds a host copy. The paths' graphs run each stage eagerly
# before capturing it, which makes their buffers.

POW_EXPONENT_BITS = 1 << 22
_K7_DIGITS: dict = {}       # (mode, exponent, device) -> uint8 digits on the device


def _k7_digits(name, exponent: int, device) -> torch.Tensor:
    key = (name, exponent, device)
    buf = _K7_DIGITS.get(key)
    if buf is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("K7: the digits of an exponent are made on the device outside "
                               "a graph capture; run the call once eagerly first")
        digits = (pow_digits if name == "fp_pow" else fp2_pow_digits)(exponent)
        buf = _K7_DIGITS[key] = torch.tensor(digits, dtype=torch.uint8, device=device)
    return buf


def _k7_args(name, a, exponent: int):
    """The output of one K7 launch, the digit buffer it reads, and the C
    entry point's arguments but the stream: the output's, the operand's and
    the digits' data pointers, the digit count, rows and n."""
    digits = _k7_digits(name, exponent, a.device)
    out = torch.empty_like(a)
    n = a.shape[-1]
    rows = a.numel() // (n * math.prod(_TAIL[_KERNELS[name][2][0]]))
    return out, digits, [out.data_ptr(), a.data_ptr(), digits.data_ptr(), digits.numel(), rows, n]


def _run_pow(name, a, exponent):
    _check(name, (a,))
    if not isinstance(exponent, int) or not 0 <= exponent < 1 << POW_EXPONENT_BITS:
        raise ValueError(f"{name}: the exponent is not an int in [0, 2^{POW_EXPONENT_BITS})")
    if a.device.type == "cpu":
        return PLAIN[name](a, exponent)
    if a.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {a.device}")
    if a.numel() == 0:
        return torch.empty_like(a)
    out, _digits, args = _k7_args(name, a, exponent)
    _call_kernel(name, args, a.device)
    return out


def fp_inv(a):
    """K7: a^-1 on (..., 12, n) (0 for 0), a binary GCD, one launch."""
    return _run("fp_inv", a)


def fp_pow(a, exponent: int):
    """K7: a^exponent on (..., 12, n), a public exponent, one launch."""
    return _run_pow("fp_pow", a, exponent)


def fp2_pow(a, exponent: int):
    """K7: a^exponent on (..., 2, 12, n), a public exponent, one launch."""
    return _run_pow("fp2_pow", a, exponent)


WRAPPERS = {
    "fp_mul": fp_mul, "fp_sqr": fp_sqr, "fp2_mul": fp2_mul, "fp2_sqr": fp2_sqr,
    "fp12_sqr": fp12_sqr, "fp12_mul": fp12_mul, "fp12_line": fp12_mul_line,
    "fp_add": fp_add, "fp_sub": fp_sub, "fp_neg": fp_neg, "fp_mul_small": fp_mul_small,
    "fp_lincomb": fp_lincomb,
    "g1_add": g1_add, "g1_double": g1_double, "g2_add": g2_add, "g2_double": g2_double,
    "miller_dbl": miller_dbl, "miller_add": miller_add, "miller_chain": miller_chain,
    "fp_inv": fp_inv, "fp_pow": fp_pow, "fp2_pow": fp2_pow,
}
