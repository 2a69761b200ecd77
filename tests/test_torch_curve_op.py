"""Kernel K5 (csrc/curve_op.cu, the G1/G2 complete add and double) on the
CPU, where it cannot run:

- the schedule's words (ops/fused.py k5_plan_words, which the generated
  header curve_plan.h holds) replayed in Python integers in the kernel's
  order, for both of its layouts: one lane a unit (each operand's
  combination, a chain of modular adds for +-1 coefficients, else column
  sums, a carry pass, the double-precision quotient estimate and one
  conditional subtraction; the product's twelve rows of two carry chains;
  each reduction's signed column sums plus o p^2, its carry pass and the
  REDC's twelve steps of two chains with the deferred carry ec) and a pair
  of lanes a unit (an operand each, level 1's all in the one-pass form; six
  rows each and sub-lane 0's sum of the partials; half the column sums
  each with the signed limb's bias; both lanes' quotient words with the
  products below column 12 and the carries into it; each lane's rows of
  the products above; the partials' sum and one subtraction), with every
  bound the kernel relies on asserted; the results against the pure-Python
  oracle on multiples of the generators, infinity, P + P, P + (-P), O + O
  and Z != 1, and on values off the curve;
- the header's counts and constants against the schedule and p, and the
  source's layouts (shared memory per block within the card's 227 KB);
- _Group.add / double on CPU tensors (the plain versions) with broadcast
  infinity, minor-axis slices, leading-axis halves and permuted strides
  against the contiguous call, and the kernel's addressing of such operands
  replayed from fused._k5_args;
- the wrappers' checks.
"""

import functools
import re
import struct
from pathlib import Path

import pytest
import torch

from lighthouse_tpu_torch.crypto.bls import curves as oc
from lighthouse_tpu_torch.crypto.bls import fields as ff
from lighthouse_tpu_torch.crypto.bls.constants import P
from lighthouse_tpu_torch.ops import curves as cv
from lighthouse_tpu_torch.ops import fused
from lighthouse_tpu_torch.ops import limbs as lb
from lighthouse_tpu_torch.ops import tower as tw

CSRC = Path(fused.__file__).parent / "csrc"
R = 1 << 384
R_INV = pow(R, -1, P)
M32 = (1 << 32) - 1
HAS = fused.K5_HAS
N0 = (-pow(P, -1, 1 << 32)) % (1 << 32)
P_LIMBS = [(P >> (32 * i)) & ((1 << 32) - 1) for i in range(12)]
P2_LIMBS = [(P * P >> (32 * i)) & ((1 << 32) - 1) for i in range(24)]
MASK384 = (1 << 384) - 1
P_EVEN = sum(P_LIMBS[2 * k] << (64 * k) for k in range(6))      # redc_even's pairs
P_ODD = sum(P_LIMBS[2 * k + 1] << (64 * k) for k in range(6))   # redc_odd's


def _limb(x: int, i: int) -> int:
    return (x >> (32 * i)) & M32


def _limbs(x: int, n: int) -> list:
    """x mod 2^(32 n) as n limbs."""
    return list(struct.unpack(f"<{n}I", (x & ((1 << (32 * n)) - 1)).to_bytes(4 * n, "little")))


def _value(t) -> int:
    return int.from_bytes(struct.pack(f"<{len(t)}I", *t), "little")


# --- The kernel's arithmetic, replayed --------------------------------------


def _combine(words, slots, chains=True):
    """csrc/curve_op.cu combine on one lane: -> a canonical value."""
    terms = []
    for w in words:
        if not w & HAS:
            break
        terms.append((w & 0xFF, (w >> 8) & 0xFFFF, bool(w & (1 << 24))))
    assert all(not w & HAS for w in words[len(terms):]), "terms come first"
    assert terms, "an operand has a term"
    for s, _, _ in terms:
        assert 0 <= slots[s] < P
    if chains and all(k == 1 for _, k, _ in terms):      # K4's chains
        s, _, neg = terms[0]
        acc = (P - slots[s]) % P if neg else slots[s]
        for s, _, neg in terms[1:]:
            acc = (acc - slots[s]) % P if neg else (acc + slots[s]) % P
        return acc
    col = [0] * 12
    signed = [0] * 12                                      # the signed-limb form
    m = bias = 0
    for s, k, neg in terms:
        c = -k if neg else k
        m += k if neg else 0
        bias += c << 31
        for i, x in enumerate(_limbs(slots[s], 12)):
            col[i] += c * x
            signed[i] += c * (x - (1 << 31))
            assert abs(col[i]) < 1 << 62 and abs(signed[i]) < 1 << 62
    assert all(x + bias == y for x, y in zip(signed, col))
    carry, v = 0, []
    for i in range(12):
        carry += col[i] + m * P_LIMBS[i]
        v.append(carry & M32)
        carry >>= 32                                       # arithmetic, as the kernel's
    assert 0 <= carry < 1 << 15
    value = sum(x << (32 * i) for i, x in enumerate(v)) + (carry << 384)
    assert value == sum(-k * slots[s] if neg else k * slots[s] for s, k, neg in terms) + m * P
    hi = (carry << 32) | v[11]
    assert hi < 1 << 47
    q = int(float(hi) * fused.K5_INV_HI)                  # IEEE double, truncated
    assert q in (value // P, value // P - 1)
    r = value - q * P
    assert 0 <= r < 2 * P
    return r - P if r >= P else r


def _rows(a, y, y_even, upto=None):
    """csrc/curve_op.cu rows: len(a) rows of a times y = b, two chains a row
    (row_even's pairs b_2k at even limbs, y_even, then row_odd's) -> len(a)
    + 13 limbs, exact (and, with `upto`, also the first `upto` rows' limbs).
    The chains write t[i .. i + 14); after row_even the sum stays below
    2^(32 (i + 12) + 1) and after row_odd below 2^(32 (i + 13)), so
    row_even's carry out of t[i + 12] and row_odd's into t[i + 13] never
    overflow that limb."""
    n = len(a)
    acc = first = 0
    for i in range(n):
        acc += (a[i] * y_even) << (32 * i)                # row_even
        assert acc < 1 << (32 * (i + 12) + 1)
        acc += (a[i] * (y - y_even)) << (32 * i)          # row_odd
        assert acc < 1 << (32 * (i + 13))
        if i + 1 == upto:
            first = acc
    assert acc == _value(a) * y
    if upto is None:
        return _limbs(acc, n + 13)
    return _limbs(acc, n + 13), _limbs(first, upto + 13)


def _products(rec, slots, level):
    """csrc/curve_op.cu product in both layouts -> the 24-limb product. One
    lane: both operands (K4's chains for +-1 coefficients), twelve rows. A
    pair: an operand each (level 1's in the one-pass form), six rows each,
    sub-lane 0 adds sub-lane 1's partial at limb 6."""
    lin = fused.K5_LIN
    x = _combine(rec[:lin], slots)
    y = _combine(rec[lin:], slots)
    for words, v in ((rec[:lin], x), (rec[lin:], y)):
        if level and all((w >> 8) & 0xFFFF == 1 for w in words if w & HAS):
            assert _combine(words, slots, False) == v     # the pair's one-pass form
    a = _limbs(x, 12)
    y_even = sum(((y >> (64 * k)) & M32) << (64 * k) for k in range(6))
    lane, low = _rows(a, y, y_even, upto=6)                # a pair's sub-lane 0: rows 0-5
    lane, high = lane[:24], _rows(a[6:], y, y_even)
    pair, c = [], 0
    for col in range(24):
        c += (low[col] if col < 19 else 0) + (high[col - 6] if col >= 6 else 0)
        pair.append(c & M32)
        c >>= 32
    assert c == 0 and pair == lane and _value(lane) == x * y < P * P
    return lane


def _column_sums(rec, wide, cols):
    """The signed column sums of o p^2 + sum_i d_i W_i over `cols`, in the
    signed-limb form with its bias (the same values as the branchy form)."""
    head = rec[0]
    off, terms = head & 0xFF, (head >> 16) & 0xFF
    assert terms <= fused.K5_RED
    s = {c: off * P2_LIMBS[c] for c in cols}
    bias, expect = 0, off * P * P
    for w in rec[1:1 + terms]:
        assert w & HAS
        k, neg, idx = (w >> 8) & 0xFF, bool((w >> 16) & 1), w & 0xFF
        d = -k if neg else k
        assert 0 <= _value(wide[idx]) < P * P
        bias += d << 31
        for c in cols:
            s[c] += d * (wide[idx][c] - (1 << 31))
            assert abs(s[c]) < 1 << 62                    # the signed form, in 64 bits
        expect += d * _value(wide[idx])
    out = {c: v + bias for c, v in s.items()}
    assert all(abs(v) < 1 << 38 for v in out.values())
    return out, expect


def _carry(sums, expect):
    carry, t = 0, []
    for c in range(24):
        carry += sums[c]
        t.append(carry & M32)
        carry >>= 32                                      # arithmetic
    assert carry == 0 and _value(t) == expect
    assert 0 <= expect < fused.K5_REDC_BOUND              # T < p 2^384
    return t


def _redc_lane(t):
    """redc_lane: twelve steps of redc_even (the pairs m p_2k at limbs i + 2k,
    then t[i + 12] += ec and the chain's carry, k1 that limb's carry out) and
    redc_odd (m p_2k+1 at limbs i + 1 + 2k, k2 its carry out), ec = k1 + k2
    deferred to the next step's t[i + 12]."""
    x = _value(t)
    ec = 0
    for i in range(12):
        m = (x >> (32 * i)) * N0 & M32
        window = (x >> (32 * i) & MASK384) + m * P_EVEN
        x = x & ~(MASK384 << (32 * i)) | (window & MASK384) << (32 * i)
        top = (x >> (32 * (i + 12)) & M32) + ec + (window >> 384)
        x = x & ~(M32 << (32 * (i + 12))) | (top & M32) << (32 * (i + 12))
        window = (x >> (32 * (i + 1)) & MASK384) + m * P_ODD
        x = x & ~(MASK384 << (32 * (i + 1))) | (window & MASK384) << (32 * (i + 1))
        ec = (top >> 32) + (window >> 384)
        assert ec <= 2 and x >> (32 * i) & M32 == 0
    assert ec == 0 and x & (R - 1) == 0
    u = x >> 384
    assert u < 2 * P
    return u


def _redc_pair(t):
    """The pair's REDC: both lanes' quotient words with the products below
    column 12 (step i: a chain over limbs i .. 11, its carry out summed in
    ch), each lane's rows of the products above (sub-lane r: m_(2k + r)
    times p's top 2k + r limbs into its 12-limb partial, a chain from limb 0
    whose carry lands on the partial's next limb), the partials' sum."""
    x = _value(t)
    lo = x & (R - 1)
    m, ch = [], 0
    for i in range(12):
        m.append((lo >> (32 * i)) * N0 & M32)
        width = 32 * (12 - i)
        window = (lo >> (32 * i)) + m[i] * (P & ((1 << width) - 1))
        ch += window >> width
        lo = lo & ((1 << (32 * i)) - 1) | (window & ((1 << width) - 1)) << (32 * i)
        assert lo >> (32 * i) & M32 == 0
    assert lo == 0 and ch < 1 << 36
    parts = []
    for r in range(2):
        h = 0
        for k in range(6):
            i = 2 * k + r
            h += m[i] * (P >> (32 * (12 - i)))                # p's top i limbs, from limb 0
            assert h < 1 << (32 * (2 * k + 2))
        parts.append(h)
    u = (x >> 384) + ch + parts[0] + parts[1]
    M = sum(v << (32 * i) for i, v in enumerate(m))
    assert (x + M * P) % R == 0 and u == (x + M * P) >> 384 and u < 2 * P
    return u


def _reduce(rec, wide):
    """csrc/curve_op.cu reduce in both layouts -> the canonical value. One
    lane: all 24 column sums, the carry pass, redc_lane. A pair: 12 column
    sums each, the carry pass, the split REDC."""
    sums, expect = _column_sums(rec, wide, range(24))     # a pair: 12 each, the same sums
    t = _carry(sums, expect)
    u = _redc_lane(t)
    assert _redc_pair(t) == u and u % P == expect * R_INV % P
    return u - P if u >= P else u


@functools.lru_cache(maxsize=None)
def _plan(op):
    return fused.k5_plan_words(op), fused.k5_schedule(op)[1]


@functools.lru_cache(maxsize=None)
def _replay(op, inputs):
    """The kernel on one point, in both layouts (each step's two paths must
    agree): the input Fp values (Montgomery forms, the load's order) -> the
    output Fp values (Montgomery forms)."""
    words, levels = _plan(op)
    slots = list(inputs)
    out = {}
    pos = 0
    lin = fused.K5_LIN
    for level, (products, reds) in enumerate(levels):
        wide = []
        for k in range(len(products)):
            rec = words[pos + 2 * lin * k:pos + 2 * lin * (k + 1)]
            wide.append(_products(rec, slots, level))
        pos += 2 * lin * len(products)
        new = {}
        for k in range(len(reds)):
            rec = words[pos + (1 + fused.K5_RED) * k:pos + (1 + fused.K5_RED) * (k + 1)]
            (out if level else new)[(rec[0] >> 8) & 0xFF] = _reduce(rec, wide)
        pos += (1 + fused.K5_RED) * len(reds)
        slots = [new[i] if i in new else slots[i] for i in range(max(len(slots), len(new)))]
    assert pos == len(words)
    return [out[i] for i in range(len(out))]


# --- Points -------------------------------------------------------------------


def _g1_proj(pt, z):
    return (0, z, 0) if pt is None else (pt[0] * z % P, pt[1] * z % P, z)


def _g2_proj(pt, z):
    if pt is None:
        return ((0, 0), z, (0, 0))
    return ff.fp2_mul(pt[0], z), ff.fp2_mul(pt[1], z), z


G1S = [None, oc.G1_GEN, oc.g1_mul(oc.G1_GEN, 2), oc.g1_neg(oc.G1_GEN), oc.g1_mul(oc.G1_GEN, 12345)]
G2S = [None, oc.G2_GEN, oc.g2_mul(oc.G2_GEN, 2), oc.g2_neg(oc.G2_GEN)]
G1_ZS = ((1, 1), (7, P - 3))
G2_ZS = (((1, 0), (1, 0)), ((5, 9), (P - 2, 3)))


def _mont(x: int) -> int:
    return x * R % P


def _fp_values(pt, comps):
    """Projective coordinates -> the kernel's input Fp values (coordinate
    major, component minor), in Montgomery form."""
    if comps == 1:
        return [_mont(c) for c in pt]
    return [_mont(c[i]) for c in pt for i in range(2)]


def _to_affine(vals, comps):
    xs = [v * R_INV % P for v in vals]
    if comps == 1:
        x, y, z = xs
        if z == 0:
            return None
        zi = pow(z, -1, P)
        return x * zi % P, y * zi % P
    x, y, z = (tuple(xs[2 * i:2 * i + 2]) for i in range(3))
    if ff.fp2_is_zero(z):
        return None
    zi = ff.fp2_inv(z)
    return ff.fp2_mul(x, zi), ff.fp2_mul(y, zi)


CASES = [("g1", a, b, za, zb) for a in range(len(G1S)) for b in range(len(G1S))
         for za, zb in G1_ZS]
CASES += [("g2", a, b, za, zb) for a in range(len(G2S)) for b in range(len(G2S))
          for za, zb in G2_ZS]


@pytest.mark.parametrize("case", CASES, ids=[f"{g}-{a}-{b}-{i % 2}" for i, (g, a, b, *_) in
                                             enumerate(CASES)])
def test_replay_matches_oracle(case):
    group, a, b, za, zb = case
    comps = 1 if group == "g1" else 2
    pts, proj = (G1S, _g1_proj) if comps == 1 else (G2S, _g2_proj)
    add, mul = (oc.g1_add, oc.g1_mul) if comps == 1 else (oc.g2_add, oc.g2_mul)
    p, q = proj(pts[a], za), proj(pts[b], zb)
    want_add = add(pts[a], pts[b])
    want_dbl = None if pts[a] is None else mul(pts[a], 2)
    got = _replay(f"{group}_add", tuple(_fp_values(p, comps) + _fp_values(q, comps)))
    assert _to_affine(got, comps) == want_add
    got = _replay(f"{group}_double", tuple(_fp_values(p, comps)))    # one replay a (point, Z)
    assert _to_affine(got, comps) == want_dbl


def test_replay_on_values_off_the_curve():
    """Edge values p - 1 and 0 everywhere: no bound is exceeded, and the
    replay equals the plain version (which needs no curve point)."""
    for op, comps in (("g1_add", 1), ("g1_double", 1), ("g2_add", 2), ("g2_double", 2)):
        n_in = (2 if op.endswith("add") else 1) * 3 * comps
        fills = ((P - 1,) * n_in, tuple((P - 1) * (i % 2) for i in range(n_in)))
        # both fills as the two columns of one plain call
        t = torch.stack([lb.ints_to_limbs([f[i] * R_INV % P for f in fills], "cpu")
                         for i in range(n_in)])
        t = t.reshape((2 if op.endswith("add") else 1, 3) + ((2,) if comps == 2 else ()) + (12, 2))
        ref = fused.PLAIN[op](*t.unbind(0)).reshape(-1, 12, 2)
        want = [lb.limbs_to_ints(ref[i]) for i in range(3 * comps)]
        for col, fill in enumerate(fills):
            got = _replay(op, fill)
            assert [v * R_INV % P for v in got] == [w[col] for w in want]


# --- The header ---------------------------------------------------------------


def test_header_counts_and_words():
    header = fused.k5_plan_header()
    for op in fused.K5_OPS:
        comps, ((p0, r0), (p1, r1)) = fused.k5_schedule(op)
        words = fused.k5_plan_words(op)
        name = "".join(part.capitalize() for part in op.split("_"))
        block = header[header.index(f"struct K5{name} {{"):]
        counts = dict(re.findall(r"(\w+) = (\d+)", block[:block.index("};")]))
        inputs = (2 if op.endswith("_add") else 1) * 3 * comps
        assert {k: int(v) for k, v in counts.items()} == {
            "comps": comps, "inputs": inputs, "fps": 0, "levels": 2, "np0": len(p0),
            "nr0": len(r0), "np1": len(p1), "nr1": len(r1), "np2": 0, "nr2": 0,
            "slots": max(inputs, len(r0)), "wide": max(len(p0), len(p1)),
            "warps": max(len(p0), len(r0), len(p1), len(r1)), "words": len(words)}
        assert int(counts["inputs"]) <= int(counts["warps"])    # one input Fp per unit
        body = block[block.index(f"kK5Plan{name}["):]
        got = [int(h, 16) for h in re.findall(r"0x([0-9a-f]{8})u", body[:body.index("};")])]
        assert got == words
    assert f"#define LH_K5_INV_HI {fused.K5_INV_HI.hex()}" in header


def test_schedule_bounds_are_checked():
    """The planner refuses a reduction above REDC's bound and an operand
    with too many terms."""
    big = [([], [(0, 0, {0: 5, 1: 5})])]
    with pytest.raises(AssertionError):
        fused._k5_check(big)
    wide = [([({0: 1, 1: 1, 2: 1, 3: 1, 4: 1}, {0: 1})], [])]
    with pytest.raises(AssertionError):
        fused._k5_check(wide)


def test_quotient_constant():
    """2^352 / p (1 - 2^-51) >= LH_K5_INV_HI: q never overestimates, and
    stays within one of floor(v / p) for v_hi < 2^47."""
    from fractions import Fraction
    inv = Fraction(fused.K5_INV_HI)
    assert inv <= Fraction(1 << 352, P) * (1 - Fraction(1, 1 << 51))
    assert Fraction(1 << 352, P) - inv < Fraction(1, 1 << 76)


def test_source_constants():
    """p^2's immediates in curve_op.cu, p's even and odd limbs in the REDC
    chains' PTX (fp.cuh redc_even, redc_odd), and K5's entry points."""
    src = (CSRC / "curve_op.cu").read_text()
    body = src[src.index("constexpr uint32_t p2_limb"):]
    imms = [int(h, 16) for h in re.findall(r"0x([0-9a-f]{8})u", body[:body.index("};")])]
    assert imms == [_limb(P * P, i) for i in range(24)]
    header = (CSRC / "fp.cuh").read_text()
    for name, first in (("redc_even", 0), ("redc_odd", 1)):
        body = header[header.index(f"uint32_t {name}(uint32_t* t, uint32_t m"):]
        imms = [int(h, 16) for h in re.findall(r"0x([0-9a-f]{8})U", body[:body.index("}")])]
        want = [_limb(P, j) for j in range(first, 12, 2)]
        assert imms == [x for x in want for _ in range(2)]       # lo and hi of each pair
    for entry in ("lh_g1_add", "lh_g1_dbl", "lh_g2_add", "lh_g2_dbl", "lh_curve_empty"):
        assert f'extern "C" int {entry}(' in src


def test_source_layouts():
    """The layouts the launcher runs, (points a block, lanes a unit): pairs
    at 4 points a block, one lane at kLaneP (32 points a block where that
    stays within kLaneThreads threads, else 16: K6). They fit their data: a
    pair's product column holds the product and sub-lane 1's 18-limb
    partial, its reduction scratch 24 64-bit sums and two 12-limb partials;
    the pad limb puts a warp's units on distinct banks; shared memory a
    block stays within the card's 227 KB for every operation, K6's too."""
    src = (CSRC / "curve_op.cu").read_text()
    shape = src[src.index("struct Shape {"):]
    shape = shape[:shape.index("};")]
    fp = int(re.search(r"fp = (\d+) \* P;", shape).group(1))
    w1, w2 = map(int, re.search(r"wide = \(L == 1 \? (\d+) : (\d+)\) \* P;", shape).groups())
    rs = int(re.search(r"rs = L == 1 \? 0 : (\d+) \* P;", shape).group(1))
    assert re.findall(r"run<K, (\w+(?:<K>)?), (\d+)>", src) == [("4", "2"), ("kLaneP<K>", "1")]
    threads = int(re.search(r"kLaneThreads = (\d+);", src).group(1))
    wide_p, narrow_p = map(int, re.search(
        r"kLaneP = K::warps \* 32 <= kLaneThreads \? (\d+) : (\d+);", src).groups())
    assert fp >= 12 and w1 >= 24 and w2 >= 24 + 18 and rs >= 2 * 24 + 2 * 12
    for op in fused.K5_OPS + fused.K6_OPS:
        k = fused.k5_counts(op)
        lane_p = wide_p if k["warps"] * 32 <= threads else narrow_p
        assert lane_p == (32 if op in fused.K5_OPS else 16)
        for pts, lanes in ((4, 2), (lane_p, 1)):
            units = 32 // (pts * lanes)
            assert -(-k["warps"] // units) * 32 <= 1024, (op, pts, lanes)
            wide = (w1 if lanes == 1 else w2) * pts
            assert len({u * wide % 32 for u in range(units)}) == units, (op, pts, lanes)
            words = ((k["words"] + 3) // 4 * 4 + k["slots"] * fp * pts + k["wide"] * wide
                     + k["warps"] * (0 if lanes == 1 else rs * pts))
            assert 4 * words <= 232448, (op, pts, lanes)


# --- The plain versions and the layouts ---------------------------------------


def _canonical(shape, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 1 << 32, shape, generator=g, dtype=torch.int64)
    x[..., 11, :] %= 0x1A0111EA
    return torch.where(x > 0x7FFFFFFF, x - (1 << 32), x).to(torch.int32)


def _points(group, n, seed):
    """(3, [2,] 12, n) random canonical values with curve points and
    infinity in the first columns."""
    x = _canonical((3, 12, n) if group == "G1" else (3, 2, 12, n), seed)
    if group == "G1":
        pts = [_g1_proj(p, z) for p in G1S for z, _ in G1_ZS]
        t = torch.stack([lb.ints_to_limbs([pt[i] for pt in pts], "cpu") for i in range(3)])
    else:
        pts = [_g2_proj(p, z) for p in G2S for z, _ in G2_ZS]
        t = torch.stack([tw.fp2_from_int_pairs([pt[i] for pt in pts], "cpu") for i in range(3)])
    m = min(n, t.shape[-1])
    x[..., :m] = t[..., :m]
    return x


def _layouts(group):
    g = cv.G1 if group == "G1" else cv.G2
    big = _points(group, 12, 1)
    lead = torch.stack([_points(group, 5, s) for s in range(4)])
    perm = (big.movedim(-2, -1).contiguous().movedim(-1, -2))      # limb stride 1
    inf = g.infinity("cpu").expand_as(big[..., :8])
    return {
        "broadcast infinity": (inf, big[..., :8]),
        "minor slices": (big[..., :-4], big[..., 4:]),
        "leading halves": (lead[:2], lead[2:]),
        "leading strided": (lead[::2], lead[1::2]),
        "permuted strides": (perm[..., 2:10], big[..., 1:9]),
        "broadcast column": (big[..., :1], big),
    }


@pytest.mark.parametrize("group", ["G1", "G2"])
def test_group_law_layouts_equal_contiguous(group):
    g = cv.G1 if group == "G1" else cv.G2
    for name, (a, b) in _layouts(group).items():
        shape = torch.broadcast_shapes(a.shape, b.shape)
        dense = [x.expand(shape).contiguous() for x in (a, b)]
        assert torch.equal(g.add(a, b), g.add(*dense)), name
        assert torch.equal(g.double(b), g.double(b.contiguous())), name


@pytest.mark.parametrize("group", ["G1", "G2"])
def test_plain_matches_oracle(group):
    g, pts, comps = (cv.G1, G1S, 1) if group == "G1" else (cv.G2, G2S, 2)
    x = _points(group, 2 * len(pts), 3)                  # every column a point
    y = x.roll(3, dims=-1)
    got = cv.to_affine_ints(g.add(x, y), group)
    dbl = cv.to_affine_ints(g.double(x), group)
    ref_x, ref_y = cv.to_affine_ints(x, group), cv.to_affine_ints(y, group)
    add, mul = (oc.g1_add, oc.g1_mul) if comps == 1 else (oc.g2_add, oc.g2_mul)
    for i in range(2 * len(pts)):
        assert got[i] == add(ref_x[i], ref_y[i])
        assert dbl[i] == (None if ref_x[i] is None else mul(ref_x[i], 2))


def _kernel_reads(name, xs):
    """The kernel's view of each input from the wrapper's arguments: input
    Fp (coordinate c, component k), limb l of point (row, j), row = (r1,
    r0), at r1 s1 + r0 s0 + c sc + k sk + l sl + j sn from its pointer; no
    geometry means dense inputs."""
    out, inputs, args = fused._k5_args(name, xs)
    m = len(inputs)
    ptrs = args[1:1 + m]
    rows, n, geom = args[1 + m:]
    comps = 1 if name.startswith("g1") else 2
    fp = 12 * n
    if geom is None:
        r0, strides = rows, [(0, 3 * comps * fp, comps * fp, fp, n, 1)] * m
    else:
        vals = list(geom)
        assert len(vals) == 1 + 6 * m
        r0, strides = vals[0], [vals[1 + 6 * i:7 + 6 * i] for i in range(m)]
    assert out.is_contiguous() and rows % r0 == 0 and out.numel() == rows * 3 * comps * fp
    e = torch.arange(rows * n)
    row, j = e // n, e % n
    r1, rr0 = row // r0, row % r0
    views = []
    for i, x in enumerate(inputs):
        s1, s0, sc, sk, sl, sn = strides[i]
        flat = torch.as_strided(x, (x.untyped_storage().nbytes() // 4,), (1,), 0)
        base = (ptrs[i] - x.untyped_storage().data_ptr()) // 4
        idx = (base + r1 * s1 + rr0 * s0 + j * sn)[None, None, None, :] \
            + (torch.arange(3) * sc)[:, None, None, None] \
            + (torch.arange(comps) * sk)[None, :, None, None] \
            + (torch.arange(12) * sl)[None, None, :, None]
        got = flat[idx].reshape(3, comps, 12, rows, n).permute(3, 0, 1, 2, 4)
        views.append(got.reshape(out.shape))
    return out, views


@pytest.mark.parametrize("group", ["G1", "G2"])
def test_launch_arguments_address_each_operand(group):
    for name, (a, b) in _layouts(group).items():
        shape = torch.broadcast_shapes(a.shape, b.shape)
        op = group.lower()
        for fn, ops in ((f"{op}_add", (a, b)), (f"{op}_double", (b,))):
            _, views = _kernel_reads(fn, ops)
            want = [x.expand(shape if len(ops) == 2 else x.shape) for x in ops]
            for got, ref in zip(views, want):
                assert torch.equal(got, ref), (name, fn)


# --- The wrappers -------------------------------------------------------------


def test_routing_and_cpu_counts():
    assert cv.G1.add is fused.g1_add and cv.G1.double is fused.g1_double
    assert cv.G2.add is fused.g2_add and cv.G2.double is fused.g2_double
    assert fused.WRAPPERS["g2_add"] is fused.g2_add
    assert all(name in fused.launches and name in fused.PLAIN for name in fused.K5_OPS)
    x = _points("G1", 4, 5)
    fused.reset_launches()
    cv.G1.add(x, x)
    cv.G1.double(x)
    assert all(v == 0 for v in fused.launches.values())    # the plain versions launch nothing


@pytest.mark.parametrize("name", fused.K5_OPS)
def test_wrapper_checks(name):
    fn = fused.WRAPPERS[name]
    tail = (3, 12) if name.startswith("g1") else (3, 2, 12)
    good = torch.zeros(tail + (4,), dtype=torch.int32)
    two = name.endswith("_add")

    def call(*xs):
        return fn(*(xs if two else xs[:1]))

    with pytest.raises(TypeError):
        call(good.to(torch.int64), good)
    with pytest.raises(ValueError):
        call(torch.zeros(tail[:-1] + (11, 4), dtype=torch.int32), good)
    with pytest.raises(ValueError):
        call(good[..., 0, :], good)
    meta = torch.empty(good.shape, dtype=torch.int32, device="meta")
    if two:
        with pytest.raises(ValueError, match="points on"):
            fn(good, meta)
    with pytest.raises(ValueError, match="no kernel for device"):
        call(meta, meta)
