"""Kernel K1 (csrc/fp_mul.cu), replayed in Python integers on the CPU as
one thread of the kernel runs it on one element: the product's 144
multiply-adds by operand scanning (lh::mul_wide); the square's 66 mirrored
products a_i a_j (j > i) once, by operand scanning, then one carry pass
that doubles them and adds the 12 diagonal squares a_i^2; Montgomery REDC,
row i's quotient being t_i (-p^-1) mod 2^32; then u - p by a signed borrow
chain and the choice of the canonical value by its sign. Held against the
pure-Python oracle with tolerance zero, with every bound the kernel relies
on asserted on the way. Also replayed: the multiply-high that maps an
element to its row (g / n), and the constants written into the CUDA
sources, checked against their values here."""

import re
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto.bls import fields as of
from lighthouse_tpu.crypto.bls.constants import P


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's test modules pin torch to one intra-op thread, leaving
    the other cores to other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


CSRC = Path(__file__).resolve().parents[1] / "lighthouse_tpu_torch" / "ops" / "csrc"
MASK = (1 << 32) - 1
R = 1 << 384
N0 = -pow(P, -1, 1 << 32) % (1 << 32)       # lh::kN0


def _limbs(x: int, n: int):
    return [(x >> (32 * i)) & MASK for i in range(n)]


def _value(limbs):
    return sum(v << (32 * k) for k, v in enumerate(limbs))


P_LIMBS = _limbs(P, 12)


class Trace:
    """What the replay saw, one entry per bound the kernel relies on."""

    def __init__(self):
        self.mads = 0             # multiply-adds of the product or square
        self.mad = 0              # largest x y + t + carry of any multiply-add
        self.row_carry = 0        # largest carry a row writes as a limb
        self.fresh = True         # each row's carry limb was empty before
        self.column = 0           # largest column of the square's doubling pass
        self.pass_carry = []      # final carry of the doubling pass
        self.redc = []            # (quotient, REDC's final carry, u)
        self.borrow = []          # final borrow of u - p


def _mad(tr, c, x, y, t):
    c += x * y + t
    tr.mad = max(tr.mad, c)
    return c


def mul_wide(a, b, tr: Trace):
    """lh::mul_wide: row i adds a_i b into t[i .. i + 12] with a 64-bit
    carry, which it writes to t[i + 12]."""
    t = [0] * 24
    for i in range(12):
        c = 0
        for j in range(12):
            c = _mad(tr, c, a[i], b[j], t[i + j])
            tr.mads += 1
            t[i + j] = c & MASK
            c >>= 32
        tr.row_carry = max(tr.row_carry, c)
        tr.fresh &= t[i + 12] == 0
        t[i + 12] = c
    return t


def sqr_wide(a, tr: Trace):
    """fp_mul.cu sqr_wide: the triangle O of a_i a_j (j > i) by operand
    scanning, then T = 2 O + sum a_i^2 2^(64 i) in one carry pass."""
    t = [0] * 24
    for i in range(11):
        c = 0
        for j in range(i + 1, 12):
            c = _mad(tr, c, a[i], a[j], t[i + j])
            tr.mads += 1
            t[i + j] = c & MASK
            c >>= 32
        tr.row_carry = max(tr.row_carry, c)
        tr.fresh &= t[i + 12] == 0
        t[i + 12] = c
    assert _value(t) == sum(a[i] * a[j] << (32 * (i + j)) for i in range(12) for j in range(i + 1, 12))
    c = 0
    for i in range(12):
        d = a[i] * a[i]
        tr.mads += 1
        for k, half in ((2 * i, d & MASK), (2 * i + 1, d >> 32)):
            col = 2 * t[k] + half + c
            tr.column = max(tr.column, col)
            t[k] = col & MASK
            c = col >> 32
    tr.pass_carry.append(c)
    return t


def redc(t, tr: Trace):
    """fp_mul.cu redc: lh::redc's rows, then u - p beside u by a signed
    borrow chain (the floor, as the kernel's arithmetic shift), and the
    choice by the borrow's sign."""
    t = list(t)
    ec, q = 0, 0
    for i in range(12):
        m = (t[i] * N0) & MASK
        q |= m << (32 * i)
        c = 0
        for j in range(12):
            c = _mad(tr, c, m, P_LIMBS[j], t[i + j])
            t[i + j] = c & MASK
            c >>= 32
        s = t[i + 12] + c + ec
        t[i + 12] = s & MASK
        ec = s >> 32
    assert all(v == 0 for v in t[:12])
    u = t[12:]
    tr.redc.append((q, ec, _value(u)))
    br, d = 0, []
    for j in range(12):
        br += u[j] - P_LIMBS[j]
        d.append(br & MASK)
        br >>= 32
    tr.borrow.append(br)
    return _value(u if br < 0 else d)


def replay(kind: str, a: int, b: int, tr: Trace):
    """One element's Montgomery product (square: b = a), as the thread
    stores it."""
    A, B = _limbs(a, 12), _limbs(b, 12)
    if kind == "sqr":
        t = sqr_wide(A, tr)
        assert _value(t) == a * a
    else:
        t = mul_wide(A, B, tr)
        assert _value(t) == a * b
    return redc(t, tr)


# --------------------------------------------------------------------------

def _random(seed):
    rng = np.random.default_rng(seed)
    return tuple(int.from_bytes(rng.bytes(48), "little") % P for _ in range(2))


CASES = {
    "all_p_minus_1": (P - 1, P - 1),
    "zero_one": (0, 1),
    "one_zero": (1, 0),
    "one_one": (1, 1),
    "zeros": (0, 0),
    "one_p_minus_1": (1, P - 1),
    "random_1": _random(5),
    "random_2": _random(91),
    "random_3": _random(2026),
}
KINDS = ("mul", "sqr")
PARAMS = [(k, c) for k in KINDS for c in CASES]


@lru_cache(maxsize=None)
def _run(kind, case):
    a, b = CASES[case]
    tr = Trace()
    return replay(kind, a, a if kind == "sqr" else b, tr), tr


@pytest.mark.parametrize("kind,case", PARAMS)
def test_replay_matches_oracle(kind, case):
    out, _ = _run(kind, case)
    a, b = CASES[case]
    r_inv = pow(R, -1, P)
    x, y = a * r_inv % P, (a if kind == "sqr" else b) * r_inv % P
    assert out * r_inv % P == of.fp_mul(x, y)


@pytest.mark.parametrize("kind,case", PARAMS)
def test_multiply_adds_fit_64_bits(kind, case):
    """Every multiply-add x y + t + carry (product, square and REDC) stays
    below 2^64, the uint64 the kernel accumulates in; each row's last carry
    fits the 32-bit limb it is written to, which held nothing before."""
    _, tr = _run(kind, case)
    assert tr.mad < 1 << 64
    assert tr.row_carry < 1 << 32 and tr.fresh


@pytest.mark.parametrize("kind,case", PARAMS)
def test_square_does_a_squares_work(kind, case):
    """The square runs 66 mirrored products and 12 diagonal squares (78
    multiply-adds), the product 144."""
    _, tr = _run(kind, case)
    assert tr.mads == (78 if kind == "sqr" else 144)


@pytest.mark.parametrize("case", list(CASES))
def test_doubling_pass(case):
    """The square's pass adds 2 t + a 32-bit half of a_i^2 + its carry:
    every column stays below 2^34 (far inside its uint64), and the pass
    ends at zero (a^2 < 2^768)."""
    _, tr = _run("sqr", case)
    assert tr.column < 1 << 34 < 1 << 63
    assert tr.pass_carry == [0]


@pytest.mark.parametrize("kind,case", PARAMS)
def test_reduction_final_carry_is_zero(kind, case):
    """T < p^2 < p 2^384: REDC's quotient stays below 2^384 and its final
    carry is 0, so u is the 12 top limbs."""
    _, tr = _run(kind, case)
    for q, ec, _ in tr.redc:
        assert q < R and ec == 0


@pytest.mark.parametrize("kind,case", PARAMS)
def test_one_subtraction(kind, case):
    """u < p^2 / 2^384 + p < 1.11 p < 2p before the one subtraction; the
    signed borrow chain of u - p ends at -1 exactly where u < p, and the
    value chosen is canonical."""
    out, tr = _run(kind, case)
    for (_, _, u), br in zip(tr.redc, tr.borrow):
        assert u < 2 * P
        assert br == (-1 if u < P else 0)
    assert 0 <= out < P


def test_bound_edge():
    """The bound the one subtraction rests on, at its extreme inputs."""
    assert ((P - 1) ** 2 + (R - 1) * P) // R < 2 * P


def _divider(n):
    """fp_mul.cu divider(): the magic number and shift of g / n."""
    shift = 0
    while (1 << shift) < n:
        shift += 1
    return ((1 << 32) * ((1 << shift) - n)) // n + 1, shift


@pytest.mark.parametrize("n", [1, 2, 3, 64, 65, 4094, 4095, 4096, 16384, 12345679, (1 << 31) - 1])
def test_row_by_multiply_high(n):
    """r = (mulhi(g, magic) + g) >> shift equals g // n for g < 2^31 (the
    launcher's limit), with the magic number below 2^32 and every
    intermediate in 32 bits."""
    magic, shift = _divider(n)
    assert magic < 1 << 32
    rng = np.random.default_rng(n)
    gs = [0, 1, n - 1, n, n + 1, (1 << 31) - 1] + [int(g) for g in rng.integers(0, 1 << 31, 200)]
    for g in gs:
        hi = (g * magic) >> 32
        assert hi + g < 1 << 32
        assert (hi + g) >> shift == g // n


def test_source_p_limbs():
    """lh::p_limb(j) (fp.cuh, which fp_mul.cu's REDC reads), p as
    immediates, against p's limbs."""
    text = (CSRC / "fp.cuh").read_text()
    body = re.search(r"constexpr uint32_t p_limb\(int j\) \{(.*?)\n\}", text, re.S).group(1)
    got = [int(v, 16) for v in re.findall(r"0x([0-9a-f]{8})u", body)]
    order = [int(v) for v in re.findall(r"j == (\d+)", body)]
    assert order == list(range(11))
    assert got == P_LIMBS


def test_source_montgomery_word():
    """lh::kN0 = -p^-1 mod 2^32, REDC's per-row quotient multiplier."""
    text = (CSRC / "fp.cuh").read_text()
    assert int(re.search(r"kN0 = 0x([0-9a-f]{8})u;", text).group(1), 16) == N0
