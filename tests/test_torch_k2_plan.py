"""Kernel K2 (csrc/fp2_mul.cu), replayed in Python integers on the CPU as
the kernel runs it on one element: the product threads' sums (a0 + a1,
b0 + b1 for the product; a0 + a1, a0 - a1 + p for the square) with their
signed carry chains and their 12 x 12 products (lh::mul_wide, operand
scanning); then each output thread's signed combination of the products'
columns (the p^2 offset, Karatsuba's T1 = P2 - P0 - P1, the square's
2 X1), its one carry pass, Montgomery REDC (lh::redc) and its one
conditional subtraction. Held against the pure-Python oracle with
tolerance zero, with every bound the kernel relies on asserted on the
way, and the constants written into the CUDA sources checked against
their values here."""

import re
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest

from lighthouse_tpu.crypto.bls import fields as of
from lighthouse_tpu.crypto.bls.constants import P

CSRC = Path(__file__).resolve().parents[1] / "lighthouse_tpu_torch" / "ops" / "csrc"
MASK = (1 << 32) - 1
R = 1 << 384
N0 = -pow(P, -1, 1 << 32) % (1 << 32)       # lh::kN0


def _limbs(x: int, n: int):
    return [(x >> (32 * i)) & MASK for i in range(n)]


def _value(limbs):
    return sum(v << (32 * k) for k, v in enumerate(limbs))


P_LIMBS = _limbs(P, 12)
P2_LIMBS = _limbs(P * P, 24)


class Trace:
    """What the replay saw, one entry per bound the kernel relies on."""

    def __init__(self):
        self.sum_carries = []     # final carries of the sums' chains
        self.mad = 0              # largest a[i] b[j] + t[i + j] + carry in mul_wide
        self.column = 0           # largest |column| of an output's combination
        self.pass_carry = []      # final carry of each output's carry pass
        self.acc = []             # (accumulator, T)
        self.redc = []            # (quotient, final carry ec, u)


def _sum_chain(x, y, sign, tr: Trace, offset=None):
    """x + sign * y (+ offset), limb by limb with a signed carry (the
    kernel's cx / cy: int64, arithmetic shift)."""
    c, out = 0, []
    for l in range(12):
        c += x[l] + sign * y[l] + (offset[l] if offset else 0)
        out.append(c & MASK)
        c >>= 32
    tr.sum_carries.append(c)
    return out


def mul_wide(a, b, tr: Trace):
    """lh::mul_wide: row i adds a[i] * b into t[i .. i + 12] with a 64-bit
    carry."""
    t = [0] * 24
    for i in range(12):
        c = 0
        for j in range(12):
            c += a[i] * b[j] + t[i + j]
            tr.mad = max(tr.mad, c)
            t[i + j] = c & MASK
            c >>= 32
        t[i + 12] = c
    assert _value(t) == _value(a) * _value(b)
    return t


def redc1(t, tr: Trace):
    """lh::redc<1> on 24 limbs."""
    t = list(t)
    ec, q = 0, 0
    for i in range(12):
        m = (t[i] * N0) & MASK
        q |= m << (32 * i)
        c = 0
        for j in range(12):
            c += m * P_LIMBS[j] + t[i + j]
            tr.mad = max(tr.mad, c)
            t[i + j] = c & MASK
            c >>= 32
        s = t[i + 12] + c + ec
        t[i + 12] = s & MASK
        ec = s >> 32
    u = _value(t[12:])
    tr.redc.append((q, ec, u))
    return u - P if u >= P else u


def replay(kind: str, a0: int, a1: int, b0: int, b1: int, tr: Trace):
    """One element (Montgomery values in [0, p)): the two output
    coordinates, as warps 0 and 1 store them."""
    A0, A1, B0, B1 = (_limbs(v, 12) for v in (a0, a1, b0, b1))
    if kind == "mul":
        s_a, s_b = _sum_chain(A0, A1, 1, tr), _sum_chain(B0, B1, 1, tr)
        assert (_value(s_a), _value(s_b)) == (a0 + a1, b0 + b1)
        prods = [mul_wide(A0, B0, tr), mul_wide(A1, B1, tr), mul_wide(s_a, s_b, tr)]
    else:
        s, d = _sum_chain(A0, A1, 1, tr), _sum_chain(A0, A1, -1, tr, P_LIMBS)
        assert (_value(s), _value(d)) == (a0 + a1, a0 - a1 + P)
        prods = [mul_wide(s, d, tr), mul_wide(A0, A1, tr)]
    out = []
    for k in range(2):
        c, t = 0, []
        for col in range(24):
            if kind == "mul":
                p0, p1 = prods[0][col], prods[1][col]
                v = P2_LIMBS[col] + p0 - p1 if k == 0 else prods[2][col] - p0 - p1
            else:
                v = prods[0][col] if k == 0 else 2 * prods[1][col]
            tr.column = max(tr.column, abs(v))
            c += v
            t.append(c & MASK)
            c >>= 32                                   # the floor, as the kernel's shift
        tr.pass_carry.append(c)
        tr.acc.append((f"{kind} t{k}", _value(t)))
        out.append(redc1(t, tr))
    return out


# --------------------------------------------------------------------------

def _random(seed):
    rng = np.random.default_rng(seed)
    return tuple(int.from_bytes(rng.bytes(48), "little") % P for _ in range(4))


CASES = {
    "all_p_minus_1": (P - 1, P - 1, P - 1, P - 1),
    "square_edge": (0, P - 1, P - 1, 0),          # a0 - a1 + p at its least, 1
    "zero_one": (0, 1, 1, 0),
    "one_p_minus_1": (1, P - 1, 0, P - 1),
    "zeros": (0, 0, 0, 0),
    "random_1": _random(3),
    "random_2": _random(77),
}
KINDS = ("mul", "sqr")
PARAMS = [(k, c) for k in KINDS for c in CASES]


@lru_cache(maxsize=None)
def _run(kind, case):
    a0, a1, b0, b1 = CASES[case]
    if kind == "sqr":
        b0, b1 = a0, a1
    tr = Trace()
    return replay(kind, a0, a1, b0, b1, tr), tr


@pytest.mark.parametrize("kind,case", PARAMS)
def test_replay_matches_oracle(kind, case):
    out, _ = _run(kind, case)
    a0, a1, b0, b1 = CASES[case]
    r_inv = pow(R, -1, P)
    a = (a0 * r_inv % P, a1 * r_inv % P)
    want = of.fp2_sqr(a) if kind == "sqr" else of.fp2_mul(a, (b0 * r_inv % P, b1 * r_inv % P))
    assert tuple(u * r_inv % P for u in out) == want


@pytest.mark.parametrize("kind,case", PARAMS)
def test_sums_fit_12_limbs(kind, case):
    """a0 + a1, b0 + b1 and a0 - a1 + p lie in [0, 2p), below 2^382: each
    sum's carry chain ends at 0."""
    _, tr = _run(kind, case)
    assert tr.sum_carries == [0, 0]


@pytest.mark.parametrize("kind,case", PARAMS)
def test_multiply_adds_fit_64_bits(kind, case):
    """In mul_wide and REDC, a 32 x 32 product plus a limb plus the carry
    stays below 2^64 (the uint64 the kernel accumulates in)."""
    _, tr = _run(kind, case)
    assert tr.mad < 1 << 64


@pytest.mark.parametrize("kind,case", PARAMS)
def test_column_bound(kind, case):
    """An output's column is the offset limb plus or minus at most three
    product limbs, or twice one: |column| < 2^34, far inside the int64
    carry pass."""
    _, tr = _run(kind, case)
    assert tr.column < 1 << 34


@pytest.mark.parametrize("kind,case", PARAMS)
def test_carry_pass_ends_at_zero(kind, case):
    """Each accumulator is non-negative and below 2^768, so the signed
    carry pass leaves nothing above limb 23."""
    _, tr = _run(kind, case)
    assert tr.pass_carry == [0, 0]


@pytest.mark.parametrize("kind,case", PARAMS)
def test_accumulator_bound(kind, case):
    """mul: T0 = p^2 + a0 b0 - a1 b1 in (0, 2 p^2), T1 = (a0 + a1)(b0 + b1)
    - a0 b0 - a1 b1 = a0 b1 + a1 b0 in [0, 2 p^2); sqr: T0 = (a0 + a1)(a0 -
    a1 + p) in [0, 4 p^2), T1 = 2 a0 a1 in [0, 2 p^2). All below p 2^384,
    REDC<1>'s condition."""
    _, tr = _run(kind, case)
    limit = {"mul t0": 2 * P * P, "mul t1": 2 * P * P, "sqr t0": 4 * P * P, "sqr t1": 2 * P * P}
    for name, t in tr.acc:
        assert 0 <= t < limit[name] and limit[name] <= P * R


@pytest.mark.parametrize("kind,case", PARAMS)
def test_reduction_final_carry_is_zero(kind, case):
    """REDC's quotient stays below 2^384 and its final carry is 0, so U
    is the 12 top limbs."""
    _, tr = _run(kind, case)
    for q, ec, _ in tr.redc:
        assert q < R and ec == 0


@pytest.mark.parametrize("kind,case", PARAMS)
def test_one_subtraction(kind, case):
    """U < 4 p^2 / 2^384 + p < 1.41 p: one conditional subtraction gives
    the canonical value."""
    out, tr = _run(kind, case)
    assert all(u < 1.41 * P for _, _, u in tr.redc)
    assert all(0 <= v < P for v in out)


def test_square_edge_is_the_least_difference():
    """a0 - a1 + p is least at a0 = 0, a1 = p - 1, where it is 1 > 0; the
    largest sum 2p - 2 < 2^382."""
    assert 0 - (P - 1) + P == 1
    assert 2 * (P - 1) < 1 << 382


def _array(text, name):
    body = re.search(rf"{name}\[[^\]]*\] = \{{(.*?)\}};", text, re.S).group(1)
    return [int(v, 16) for v in re.findall(r"0x([0-9a-f]{8})u", body)]


@pytest.mark.parametrize("source,name,want", [
    ("fp.cuh", "kP", P_LIMBS),
    ("fp.cuh", "kP2", P2_LIMBS),
])
def test_source_constants(source, name, want):
    """Each 384- and 768-bit constant K2 reads from the CUDA sources, p and
    the offset p^2 (little-endian 32-bit limbs), against its value here."""
    assert _array((CSRC / source).read_text(), name) == want


def test_source_montgomery_word():
    """lh::kN0 = -p^-1 mod 2^32, REDC's per-word quotient multiplier."""
    text = (CSRC / "fp.cuh").read_text()
    assert int(re.search(r"kN0 = 0x([0-9a-f]{8})u;", text).group(1), 16) == N0
