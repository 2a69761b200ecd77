"""Kernel K5 (csrc/curve_op.cu, the G1/G2 complete add and double) on the
CPU, where it cannot run:

- the schedule's words (ops/fused.py k5_plan_words, which the generated
  header curve_plan.h holds) replayed in Python integers in the kernel's
  order: each operand's combination (a chain of modular adds for +-1
  coefficients, else column sums, a carry pass, the double-precision
  quotient estimate and one conditional subtraction), each product, each
  reduction's signed column sums plus o p^2, its carry pass and REDC, with
  every bound the kernel relies on asserted; the results against the
  pure-Python oracle on multiples of the generators, infinity, P + P,
  P + (-P), O + O and Z != 1;
- the header's counts and constants against the schedule and p;
- _Group.add / double on CPU tensors (the plain versions) with broadcast
  infinity, minor-axis slices, leading-axis halves and permuted strides
  against the contiguous call, and the kernel's addressing of such operands
  replayed from fused._k5_args;
- the wrappers' checks.
"""

import re
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


def _limb(x: int, i: int) -> int:
    return (x >> (32 * i)) & M32


# --- The kernel's arithmetic, replayed --------------------------------------


def _combine(words, slots):
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
    if all(k == 1 for _, k, _ in terms):                 # K4's chains
        s, _, neg = terms[0]
        acc = (P - slots[s]) % P if neg else slots[s]
        for s, _, neg in terms[1:]:
            acc = (acc - slots[s]) % P if neg else (acc + slots[s]) % P
        return acc
    col = [0] * 12
    m = 0
    for s, k, neg in terms:
        c = -k if neg else k
        m += k if neg else 0
        for i in range(12):
            col[i] += c * _limb(slots[s], i)
            assert abs(col[i]) < 1 << 62
    carry, v = 0, []
    for i in range(12):
        carry += col[i] + m * _limb(P, i)
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


def _reduce(rec, wide):
    """csrc/curve_op.cu reduce on one lane: -> (the canonical value, T)."""
    head = rec[0]
    off, terms = head & 0xFF, (head >> 16) & 0xFF
    assert terms <= fused.K5_RED
    s = [off * _limb(P * P, c) for c in range(24)]
    expect = off * P * P
    for w in rec[1:1 + terms]:
        assert w & HAS
        k, neg, idx = (w >> 8) & 0xFF, bool((w >> 16) & 1), w & 0xFF
        assert 0 <= wide[idx] < P * P
        for c in range(24):
            s[c] += (-k if neg else k) * _limb(wide[idx], c)
        expect += (-k if neg else k) * wide[idx]
    assert all(abs(x) < 1 << 38 for x in s)
    carry, t = 0, 0
    for c in range(24):
        carry += s[c]
        t |= (carry & M32) << (32 * c)
        carry >>= 32
    assert carry == 0 and t == expect
    assert 0 <= t < fused.K5_REDC_BOUND                  # T < p 2^384
    m = (-t * pow(P, -1, R)) % R                          # REDC's quotient, row by row
    u = (t + m * P) >> 384
    assert (t + m * P) % R == 0 and u < 2 * P
    return (u - P if u >= P else u), t


def _replay(op, inputs):
    """The kernel on one lane: the input Fp values (Montgomery forms, the
    load's order) -> the output Fp values (Montgomery forms)."""
    words = fused.k5_plan_words(op)
    _, levels = fused.k5_schedule(op)
    slots = list(inputs)
    out = {}
    pos = 0
    for level, (products, reds) in enumerate(levels):
        wide = []
        for k in range(len(products)):
            rec = words[pos + 2 * fused.K5_LIN * k:pos + 2 * fused.K5_LIN * (k + 1)]
            x = _combine(rec[:fused.K5_LIN], slots)
            y = _combine(rec[fused.K5_LIN:], slots)
            wide.append(x * y)
        pos += 2 * fused.K5_LIN * len(products)
        new = {}
        for k in range(len(reds)):
            rec = words[pos + (1 + fused.K5_RED) * k:pos + (1 + fused.K5_RED) * (k + 1)]
            value, _ = _reduce(rec, wide)
            (out if level else new)[(rec[0] >> 8) & 0xFF] = value
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
    got = _replay(f"{group}_add", _fp_values(p, comps) + _fp_values(q, comps))
    assert _to_affine(got, comps) == add(pts[a], pts[b])
    got = _replay(f"{group}_double", _fp_values(p, comps))
    want = None if pts[a] is None else mul(pts[a], 2)
    assert _to_affine(got, comps) == want


def test_replay_on_values_off_the_curve():
    """Edge values p - 1 and 0 everywhere: no bound is exceeded, and the
    replay equals the plain version (which needs no curve point)."""
    for op, comps in (("g1_add", 1), ("g1_double", 1), ("g2_add", 2), ("g2_double", 2)):
        n_in = (2 if op.endswith("add") else 1) * 3 * comps
        for fill in ((P - 1,) * n_in, tuple((P - 1) * (i % 2) for i in range(n_in))):
            got = _replay(op, list(fill))
            t = torch.stack([lb.ints_to_limbs([v * R_INV % P], "cpu") for v in fill])
            t = t.reshape((2 if op.endswith("add") else 1, 3) + ((2,) if comps == 2 else ()) + (12, 1))
            ref = fused.PLAIN[op](*t.unbind(0))
            want = [lb.limbs_to_ints(ref.reshape(-1, 12, 1)[i]) for i in range(3 * comps)]
            assert [v * R_INV % P for v in got] == [w[0] for w in want]


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
            "comps": comps, "inputs": inputs, "np0": len(p0), "nr0": len(r0), "np1": len(p1),
            "nr1": len(r1), "slots": max(inputs, len(r0)), "wide": max(len(p0), len(p1)),
            "warps": max(len(p0), len(r0), len(p1), len(r1)), "words": len(words)}
        assert int(counts["inputs"]) <= int(counts["warps"])    # one input Fp per warp
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
    """p^2's immediates in curve_op.cu, and K5's entry points."""
    src = (CSRC / "curve_op.cu").read_text()
    body = src[src.index("constexpr uint32_t p2_limb"):]
    imms = [int(h, 16) for h in re.findall(r"0x([0-9a-f]{8})u", body[:body.index("};")])]
    assert imms == [_limb(P * P, i) for i in range(24)]
    for entry in ("lh_g1_add", "lh_g1_dbl", "lh_g2_add", "lh_g2_dbl", "lh_curve_empty"):
        assert f'extern "C" int {entry}(' in src


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
