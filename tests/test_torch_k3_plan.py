"""The plan of kernel K3 (csrc/fp12_op.cu), replayed in Python integers on
the CPU as the kernel runs it: the product plan that ops/fused.py makes
from its K3 tables and writes into the kernel's generated header, the
signed 64-bit column sums, the 16 p^2 offset and carry pass, Montgomery
REDC and four conditional subtractions. Held against the pure-Python
oracle with tolerance zero, at all inputs p - 1 (the bound's worst case)
and at seeded random ones, with every bound the kernel relies on
asserted on the way."""

import re

import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto.bls import fields as of
from lighthouse_tpu.crypto.bls.constants import P
from lighthouse_tpu_torch.ops import _build, fused


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's test modules pin torch to one intra-op thread, leaving
    the other cores to other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


KINDS = ("sqr", "mul", "line")
MASK = (1 << 32) - 1
R = 1 << 384
N0 = -pow(P, -1, 1 << 32) % (1 << 32)       # lh::kN0
P_LIMBS = [(P >> (32 * i)) & MASK for i in range(12)]
OFFSET = [((16 * P * P) >> (32 * i)) & MASK for i in range(24)]   # lh::kP2x16


def _limbs(x: int, n: int):
    return [(x >> (32 * i)) & MASK for i in range(n)]


def _mult(word: int, j: int) -> int:
    m = (word >> (8 + 4 * j)) & 15
    return m - 16 if m >= 8 else m


def _groups(kind):
    """Decoded plan words: [(accumulators, [(x, y, multiplicities)])]."""
    out = []
    for head, *lanes in fused.k3_plan_words(kind):
        accs = [(head >> (4 + 4 * j)) & 15 for j in range(head & 15)]
        products = [(w & 15, (w >> 4) & 15, [_mult(w, j) for j in range(fused.K3_GROUP_ACCS)])
                    for w in lanes if w & fused.K3_HAS]
        assert all(w & fused.K3_HAS for w in lanes[:len(products)])    # products first
        out.append((accs, products))
    return out


def _redc4(t):
    """lh::redc<4> on 24 limbs, with its bounds asserted."""
    t = list(t)
    ec, q = 0, 0
    for i in range(12):
        m = (t[i] * N0) & MASK
        q |= m << (32 * i)
        c = 0
        for j in range(12):
            c += m * P_LIMBS[j] + t[i + j]
            t[i + j] = c & MASK
            c >>= 32
        s = t[i + 12] + c + ec
        t[i + 12] = s & MASK
        ec = s >> 32
    assert q < R and ec == 0                 # (T + q p) / 2^384 fits in 12 limbs
    u = sum(v << (32 * j) for j, v in enumerate(t[12:]))
    assert u < 5 * P                         # four subtractions reach [0, p)
    for _ in range(4):
        if u >= P:
            u -= P
    assert u < P
    return u


def replay(kind, xs, ys):
    """The kernel on one element: xs the 12 Montgomery coordinates of a,
    ys the 12 of b (6 of the line). Returns the 12 output coordinates."""
    cols = {}
    for accs, products in _groups(kind):
        prods = [(_limbs(xs[x] * ys[y], 24), m) for x, y, m in products]     # one lane each
        for j, acc in enumerate(accs):
            assert acc not in cols
            cols[acc] = [sum(m[j] * p[c] for p, m in prods) for c in range(24)]
            assert all(abs(v) < 1 << 63 for v in cols[acc])
    assert sorted(cols) == list(range(12))
    out = []
    for o in range(12):
        c, w = 0, []
        for k in range(24):
            c += cols[o][k] + OFFSET[k]
            w.append(c & MASK)
            c >>= 32                          # floor, as the kernel's arithmetic shift
        assert c == 0
        total = sum(v << (32 * k) for k, v in enumerate(w))
        assert 0 <= total < 33 * P * P
        out.append(_redc4(w))
    return out


def _fp12(coords):
    """12 Fp coordinates in the kernel's order (h, k, c) -> oracle Fp12."""
    return tuple(tuple((coords[(h * 3 + k) * 2], coords[(h * 3 + k) * 2 + 1])
                       for k in range(3)) for h in range(2))


def _check(kind, a_mont, b_mont):
    """Replay on Montgomery coordinates and compare with the oracle."""
    r_inv = pow(R, -1, P)
    a = _fp12([x * r_inv % P for x in a_mont])
    if kind == "line":
        l0, l1, l2 = [(b_mont[2 * s] * r_inv % P, b_mont[2 * s + 1] * r_inv % P) for s in range(3)]
        z = (0, 0)
        want = of.fp12_mul(a, ((l0, z, z), (z, l1, l2)))
    elif kind == "sqr":
        want = of.fp12_sqr(a)
    else:
        want = of.fp12_mul(a, _fp12([y * r_inv % P for y in b_mont]))
    got = replay(kind, a_mont, a_mont if kind == "sqr" else b_mont)
    assert _fp12([u * r_inv % P for u in got]) == want


@pytest.mark.parametrize("kind", KINDS)
def test_replay_all_p_minus_1(kind):
    """Every Montgomery coordinate p - 1: the largest products, the bound's
    worst case."""
    _check(kind, [P - 1] * 12, [P - 1] * (6 if kind == "line" else 12))


@pytest.mark.parametrize("kind", KINDS)
def test_replay_random(kind):
    rng = np.random.default_rng(31)
    for _ in range(3):
        a = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(12)]
        b = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(12)]
        _check(kind, a, b[:6] if kind == "line" else b)


def _signed_terms(kind, canonical):
    """Per accumulator, the sorted (x, y, sign) of every product counted
    with its multiplicity, from the plan."""
    terms = {acc: [] for acc in range(12)}
    for accs, products in _groups(kind):
        for x, y, m in products:
            for j, acc in enumerate(accs):
                key = (min(x, y), max(x, y)) if canonical else (x, y)
                terms[acc] += [key + (1 if m[j] > 0 else -1,)] * abs(m[j])
    return {acc: sorted(v) for acc, v in terms.items()}


def _table_terms(kind, canonical):
    table = fused._K3_TABLES[kind]
    terms = {acc: [] for acc in range(12)}
    for lst, sign in ((table.pos, 1), (table.neg, -1)):
        for k, acc in lst:
            x, y = table.xs[k], table.ys[k]
            key = (min(x, y), max(x, y)) if canonical else (x, y)
            terms[acc].append(key + (sign,))
    return {acc: sorted(v) for acc, v in terms.items()}


@pytest.mark.parametrize("kind", KINDS)
def test_plan_has_the_tables_terms(kind):
    """Each accumulator gets the table's signed products: the square's
    mirrored pairs merged with multiplicity 2 (78 distinct products of
    the 144), mul and line as they are; within the budget of 17 added and
    16 subtracted products per accumulator."""
    canonical = kind == "sqr"
    plan = _signed_terms(kind, canonical)
    assert plan == _table_terms(kind, canonical)
    for terms in plan.values():
        assert sum(1 for t in terms if t[2] > 0) <= fused._K3_MAX_POS
        assert sum(1 for t in terms if t[2] < 0) <= fused._K3_MAX_NEG
    distinct = sum(len(products) for _, products in _groups(kind))
    assert distinct == {"sqr": 78, "mul": 144, "line": 72}[kind]
    for accs, products in _groups(kind):
        assert len(products) <= fused.K3_LANES and len(accs) <= fused.K3_GROUP_ACCS


def test_header_encodes_the_plan():
    """The generated header the kernel includes holds exactly the plan
    words and the sizes the kernel's shared memory is cut to."""
    text = fused.k3_plan_header()
    for kind in KINDS:
        name = kind.upper()
        words = fused.k3_plan_words(kind)

        def define(key):
            return int(re.search(rf"#define LH_K3_{key}_{name} (\d+)", text).group(1))

        assert define("GROUPS") == len(words)
        assert define("PRODUCTS") == max(len(p) for _, p in _groups(kind))
        body = re.search(rf"#define LH_K3_PLAN_{name} \{{(.*?)\}}\}}", text, re.S).group(1)
        assert [int(v, 16) for v in re.findall(r"0x([0-9a-f]{8})u", body)] == sum(words, [])


def test_build_digest_covers_the_plan(monkeypatch):
    """A changed plan changes the library's name, so it is rebuilt."""
    before = _build._digest("fp12_op")
    monkeypatch.setitem(_build.GENERATED, "fp12_op",
                        {"k3_plan.h": lambda: fused.k3_plan_header() + "// changed\n"})
    assert _build._digest("fp12_op") != before
