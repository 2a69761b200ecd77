"""Kernel K7 (csrc/fp_pow.cu: the Fp inverse fused.fp_inv and the
public-exponent powers fused.fp_pow / fp2_pow, which limbs.inv,
limbs.pow_fixed and tower.fp2_pow_fixed are) on the CPU, where it cannot
run:

- the plain versions against the JAX package's ops/bm/limbs.inv and
  pow_fixed and ops/bm/tower.fp2_pow_fixed (jitted on the CPU, one compile
  each) and against Python-integer powers, as integers mod p (tolerance
  0), with 0, 1, p - 1, R mod p and 2 among the values and exponents 0, 1,
  15, 16, 17 and the paths' own;
- the powers' chains replayed in Python integers in the kernel's order
  (the table with a^2 as a product; an Fp2 element on four lanes, each
  lane's layout, operands, table word, product, REDC and the part sums
  across lanes), every bound asserted, against the powers; the inverse's
  binary GCD is replayed in tests/test_torch_fp_inv.py;
- the digit buffer the kernel reads replayed against the exponent, and the
  launch arguments' addressing of the operand;
- the source's constants and the table's banks;
- that the inverse and the paths' powers route to the K7 wrappers, the
  wrappers' checks, and that a CPU tensor runs the plain version and
  launches nothing.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lighthouse_tpu.ops.bm import limbs as bl
from lighthouse_tpu.ops.bm import tower as bt
from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch.crypto.bls import fields as ff
from lighthouse_tpu_torch.crypto.bls.constants import P
from lighthouse_tpu_torch.ops import fused
from lighthouse_tpu_torch.ops import limbs as lb
from lighthouse_tpu_torch.ops import tower as tw

CSRC = Path(fused.__file__).parent / "csrc"
R = 1 << 384
INV_EXP = P - 2
SQRT_EXP = tw._SQRT_RATIO_EXP
SHORT = (0, 1, 15, 16, 17)
NEG_PINV = -pow(P, -1, R) % R        # REDC's quotient factor, -p^-1 mod 2^384


def _id(exponent):
    return {INV_EXP: "p-2", SQRT_EXP: "sqrt_ratio", P: "p",
            17 * P + 5: "17p+5"}.get(exponent, str(exponent))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain kernel versions run many small ops; one intra-op thread
    is faster for them and leaves the other cores to other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


EDGES = (0, 1, P - 1, R % P, 2)


def _values(seed, count):
    """0, 1, p - 1, R mod p, 2, then seeded random values below p."""
    rng = np.random.default_rng(seed)
    rand = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(count - len(EDGES))]
    return list(EDGES) + rand


def _pairs(seed, count):
    """(0, 0), (1, 0), (0, 1), (p - 1, p - 1), then seeded random pairs."""
    vals = _values(seed, 2 * count + len(EDGES))[len(EDGES):]
    return [(0, 0), (1, 0), (0, 1), (P - 1, P - 1)] + list(zip(vals[0::2], vals[1::2]))[:count - 4]


def _fp2_ints(t):
    """(2, 12, n) -> [(c0, c1), ...]."""
    vals = lb.limbs_to_ints(t)
    n = t.shape[-1]
    return list(zip(vals[:n], vals[n:]))


# --- The plain versions against the JAX package and integers ------------------


@pytest.fixture(scope="module")
def fp_case():
    xs = _values(41, 8)
    digits = bl.ints_to_bm_np(xs)                          # (48, n), plain values
    return xs, digits, convert.from_jax_limbs(digits)


@pytest.fixture(scope="module")
def jax_inv(fp_case):
    """bm.limbs.inv (its scan) on fp_case, jitted once, in halves of 4
    columns: the shape tests/test_torch_limbs.py compiles it at, so a
    process that runs both compiles it once."""
    fn = jax.jit(bl.inv)
    digits = fp_case[1]
    return [v for c in range(0, digits.shape[1], 4)
            for v in bl.bm_to_ints(fn(jnp.asarray(digits[:, c:c + 4])))]


@pytest.mark.parametrize("jax_fn, exponent", [("inv", INV_EXP), ("pow_fixed", 15)],
                         ids=["inv", "pow_fixed_15"])
def test_plain_fp_pow_matches_jax(fp_case, request, jax_fn, exponent):
    """limbs.pow_fixed at p - 2 against bm.limbs.inv (its scan) and below 16
    against bm.limbs.pow_fixed (JAX's square-and-multiply path); each JAX
    compile costs 1-4 s, so the other exponents go against integers."""
    xs, digits, t = fp_case
    got = lb.pow_fixed(t, exponent)
    if jax_fn == "inv":
        ref = request.getfixturevalue("jax_inv")
    else:
        ref = bl.bm_to_ints(jax.jit(lambda a: bl.pow_fixed(a, exponent))(jnp.asarray(digits)))
    assert convert.to_ints(got) == ref == [pow(x, exponent, P) for x in xs]


def test_plain_fp_inv_matches_jax(fp_case, jax_inv):
    """limbs.inv (fused.fp_inv's plain version on a CPU tensor) against
    bm.limbs.inv, through the same compile: 0 to 0, and a^(p-2) else."""
    xs, _, t = fp_case
    fused.reset_launches()
    assert convert.to_ints(lb.inv(t)) == jax_inv == [pow(x, P - 2, P) for x in xs]
    assert all(v == 0 for v in fused.launches.values())        # a CPU tensor: no launch
    assert fused.PLAIN["fp_inv"] is fused.fp_inv_plain


@pytest.mark.parametrize("exponent", SHORT + (255, 2**70 + 3), ids=_id)
def test_plain_fp_pow_matches_integers(fp_case, exponent):
    xs, _, t = fp_case
    assert convert.to_ints(lb.pow_fixed(t, exponent)) == [pow(x, exponent, P) for x in xs]


@pytest.fixture(scope="module")
def fp2_case():
    pairs = _pairs(43, 5)
    d = np.stack([bl.ints_to_bm_np([c0 for c0, _ in pairs]),
                  bl.ints_to_bm_np([c1 for _, c1 in pairs])])    # (2, 48, n)
    return pairs, d, convert.from_jax_limbs(d)


def test_plain_fp2_pow_matches_jax(fp2_case):
    """tower.fp2_pow_fixed against bm.tower.fp2_pow_fixed at a short
    exponent (15: JAX's square-and-multiply path; a scan's compile costs
    3-4 s, and the scan's semantics are bm.limbs.inv's, held above)."""
    pairs, d, t = fp2_case
    got = _fp2_ints(tw.fp2_pow_fixed(t, 15))
    out = jax.jit(lambda a: bt.fp2_pow_fixed(a, 15))(jnp.asarray(d))
    c0, c1 = bl.bm_to_ints(out[0]), bl.bm_to_ints(out[1])
    assert got == list(zip(c0, c1)) == [ff.fp2_pow(a, 15) for a in pairs]


@pytest.mark.parametrize("exponent", SHORT + (SQRT_EXP,), ids=_id)
def test_plain_fp2_pow_matches_integers(fp2_case, exponent):
    """Each short exponent and the path's (p^2 - 9) / 16 against
    Python-integer Fp2 powers."""
    pairs, _, t = fp2_case
    assert _fp2_ints(tw.fp2_pow_fixed(t, exponent)) == [ff.fp2_pow(a, exponent) for a in pairs]


# --- The kernel's chain, replayed -------------------------------------------------


def _redc(t):
    """lh::redc_lane on one lane: T 2^-384 mod p, canonical, for
    0 <= T < p 2^384; the quotient m < 2^384 (twelve words of
    t_i (-p^-1) mod 2^32), u = (T + m p) / 2^384 < 2p, one subtraction."""
    assert 0 <= t < P * R
    m = t * NEG_PINV % R
    assert (t + m * P) % R == 0 and t + m * P < R * R        # the final carry is 0
    u = (t + m * P) // R
    assert u < 2 * P
    return u - P if u >= P else u


def _prod(x, y):
    """lh::rows<12>: 12-limb operands (below 2^384), the exact product."""
    assert 0 <= x < R and 0 <= y < R
    return x * y


def _fp_chain(a, exponent):
    """fp_pow_kernel on one lane, Montgomery forms in and out."""
    def mont_mul(x, y):
        return _redc(_prod(x, y))

    table = [R % P, a]
    for _ in range(14):
        table.append(mont_mul(table[-1], a))
    digits = fused.pow_digits(exponent)
    acc = table[digits[0]]
    for d in digits[1:]:
        for _ in range(4):
            acc = mont_mul(acc, acc)
        if d:
            acc = mont_mul(acc, table[d])
    return acc


def _held(k, layout):
    """The component lane k of an element holds: layout A (0) k >> 1, B (1)
    (k >> 1) ^ (k & 1)."""
    return (k >> 1) ^ (k & layout & 1)


def _fp2_chain(a, exponent):
    """fp2_pow_kernel on an element's four lanes: lane k holds one
    component (own) and reads word j = k & 1 of a table entry (b0, b1,
    p - b1). The exponent split at p (fused.fp2_pow_digits): per window
    four squares, a product by a^dB and one by conj(a^dA)."""
    def put(own, layout):
        """fp2_put: the entry's words from the lanes that write them."""
        words = {}
        for k in range(4):
            j, h = k & 1, _held(k, layout)
            if h or not j:
                assert (h + j) not in words
                words[h + j] = P - own[k] if h and j else own[k]
        assert sorted(words) == [0, 1, 2] and all(0 <= w <= P for w in words.values())
        return words

    def mul(own, entry, layout, conj):
        """fp2_mul_lanes: a row a lane, its REDC, the parts of a component
        summed across lanes k and k ^ (1 in B, 3 in A)."""
        parts = []
        for k in range(4):
            j, h = k & 1, _held(k, layout)
            t = _prod(own[k], entry[1 + (h ^ conj) if j else 0])
            assert t < P * P
            parts.append(_redc(t))
        partner = 1 if layout else 3
        out = []
        for k in range(4):
            assert _held(k ^ partner, layout) ^ (k & 1 ^ 1) == _held(k, layout) ^ (k & 1)
            total = parts[k] + parts[k ^ partner]
            assert total < 2 * P
            out.append(total - P if total >= P else total)
        return out, layout ^ 1

    def sqr(own, layout):
        """fp2_sqr_lanes: the other component from lane k ^ 2, then h = 0
        (a0 + a1)(a0 + (p - a1)), h = 1 (a1 + a1) a0."""
        out = []
        for k in range(4):
            h, o = _held(k, layout), own[k ^ 2]
            assert _held(k ^ 2, layout) == 1 - h
            x = own[k] + (own[k] if h else o)
            y = o if h else own[k] + (P - o)
            assert x < 2 * P and y < 2 * P
            t = _prod(x, y)
            assert t < 4 * P * P
            out.append(_redc(t))
        return out

    def value(own, layout):
        """The element the lanes hold: each component on two lanes, equal."""
        comps = {}
        for k in range(4):
            assert comps.setdefault(_held(k, layout), own[k]) == own[k]
        return comps[0], comps[1]

    layout = 0
    own = [a[_held(k, layout)] for k in range(4)]
    table = [{0: R % P, 1: 0, 2: 0}, put(own, layout)]
    for _ in range(14):
        own, layout = mul(own, table[1], layout, False)
        table.append(put(own, layout))
    digits = fused.fp2_pow_digits(exponent)
    layout = 0
    own = [table[digits[0] & 15][_held(k, layout)] for k in range(4)]
    for w, d in enumerate(digits):
        if w:
            for _ in range(4):
                own = sqr(own, layout)
            if d & 15:
                own, layout = mul(own, table[d & 15], layout, False)
        if d >> 4:
            own, layout = mul(own, table[d >> 4], layout, True)
    stored = {_held(k, layout): own[k] for k in range(4) if not k & 1}   # lanes j = 0 store
    assert stored == dict(enumerate(value(own, layout)))
    return value(own, layout)


@pytest.mark.parametrize("exponent", (INV_EXP,) + SHORT, ids=_id)
def test_replay_fp_chain(exponent):
    for x in _values(47, 6):
        assert _fp_chain(x * R % P, exponent) == pow(x, exponent, P) * R % P


@pytest.mark.parametrize("exponent", (SQRT_EXP,) + SHORT + (P, 17 * P + 5), ids=_id)
def test_replay_fp2_chain(exponent):
    for a in _pairs(53, 6):
        mont = tuple(c * R % P for c in a)
        got = _fp2_chain(mont, exponent)
        assert tuple(c * pow(R, -1, P) % P for c in got) == ff.fp2_pow(a, exponent)


# --- Digits, launch arguments, source ------------------------------------------


@pytest.mark.parametrize("exponent", (0, 1, 15, 16, 17, 255, 256, INV_EXP, P, SQRT_EXP), ids=_id)
@pytest.mark.parametrize("name", ("fp_pow", "fp2_pow"))
def test_digit_buffer_replays_exponent(name, exponent):
    """Fp: the exponent's 4-bit digits. Fp2: a byte a window, B's digit in
    the low nibble and A's in the high one, exponent = A p + B, B < p; both
    most significant first, one window at least, no leading zero window."""
    a = lb.ints_to_limbs([3, 5], "cpu")
    if name == "fp2_pow":
        a = torch.stack([a, a])
    out, digits, args = fused._k7_args(name, a, exponent)
    assert digits.dtype == torch.uint8 and digits.is_contiguous()
    assert args[2] == digits.data_ptr() and args[3] == digits.numel() >= 1
    hi = lo = 0
    for d in digits.tolist():
        assert 0 <= d < (16 if name == "fp_pow" else 256)
        hi, lo = 16 * hi + (d >> 4), 16 * lo + (d & 15)
    assert lo < P or name == "fp_pow"
    assert hi * P + lo == exponent if name == "fp2_pow" else (hi, lo) == (0, exponent)
    assert digits.numel() == 1 or digits[0] != 0
    assert fused._k7_args(name, a, exponent)[1] is digits       # kept, not rebuilt


@pytest.mark.parametrize("name, shape", [("fp_pow", (12, 1)), ("fp_pow", (3, 12, 5)),
                                         ("fp2_pow", (2, 2, 12, 64)), ("fp2_pow", (2, 12, 3))])
def test_launch_arguments_address_the_operand(name, shape):
    """The kernel's reads replayed from the arguments: element g of rows x n
    at row r = g / n, limb l (component c) at r * W n + c * 12 n + l n + g % n,
    W = 12 (Fp) or 24 (Fp2)."""
    a = torch.arange(int(np.prod(shape)), dtype=torch.int32).reshape(shape)
    out, digits, args = fused._k7_args(name, a, INV_EXP)
    assert out.shape == a.shape and out.is_contiguous() and args[0] == out.data_ptr()
    assert args[1] == a.data_ptr()
    rows, n = args[4], args[5]
    comps = 1 if name == "fp_pow" else 2
    assert rows * comps * 12 * n == a.numel() and n == shape[-1]
    flat = a.reshape(-1)
    g = torch.arange(rows * n)
    r, j = g // n, g % n
    idx = (r * comps * 12 * n + j)[:, None, None] + (torch.arange(comps) * 12 * n)[None, :, None] \
        + (torch.arange(12) * n)[None, None, :]
    got = flat[idx]                                          # (rows n, comps, 12)
    want = a.reshape(rows, comps, 12, n).permute(0, 3, 1, 2).reshape(rows * n, comps, 12)
    assert torch.equal(got, want)


def test_source_constants_and_banks():
    src = (CSRC / "fp_pow.cu").read_text()
    body = src[src.index("constexpr uint32_t one_limb"):]
    imms = [int(h, 16) for h in re.findall(r"0x([0-9a-f]{8})u", body[:body.index("}")])]
    assert imms == [((R % P) >> (32 * i)) & 0xFFFFFFFF for i in range(12)]
    lanes = int(re.search(r"kFp2Lanes = (\d+);", src).group(1))
    assert re.search(r"kFp2Elems = 32 / kFp2Lanes;", src) and lanes == 4
    elems = 32 // lanes
    pad = int(re.search(r"kFp2Comp = lh::NL \* kFp2Elems \+ (\d+);", src).group(1))
    comp = 12 * elems + pad
    assert re.search(r"kFp2Entry = 3 \* kFp2Comp;", src)
    assert int(re.search(r"kFpElems = (\d+);", src).group(1)) == 32
    # A warp's 8 elements read (a product) or write (fp_put) words b0, b1
    # and p - b1 of one entry at once, lanes of one word alike: 24 words on
    # 24 distinct banks, at every limb.
    for l in range(12):
        banks = {(c * comp + l * elems + e) % 32 for e in range(elems) for c in range(3)}
        assert len(banks) == 3 * elems
    for entry in ("lh_fp_inv", "lh_fp_pow", "lh_fp2_pow", "lh_fp_inv_empty", "lh_fp_pow_empty",
                  "lh_fp2_pow_empty"):
        assert f'extern "C" int {entry}(' in src
        assert entry in fused._build.ENTRY_POINTS["fp_pow"]
    assert "fp_pow" in fused._build.SOURCES


# --- Routing and the wrappers ----------------------------------------------------


def test_powers_route_to_k7(monkeypatch):
    """limbs.inv (and so tower.fp2_inv, the final exponentiation's) reaches
    fused.fp_inv, no power; pow_fixed and fp2_pow_fixed reach the powers.
    (The inverse's spy returns its operand: test_plain_fp_inv_matches_jax
    runs the real one.)"""
    calls = []
    for name in ("fp_inv", "fp_pow", "fp2_pow"):
        real = getattr(fused, name)

        def spy(a, *exponent, _name=name, _real=real):
            calls.append((_name, tuple(a.shape)) + exponent)
            return _real(a, *exponent) if exponent else a

        monkeypatch.setattr(fused, name, spy)
    a = lb.ints_to_limbs([2, 3], "cpu")
    b = tw.fp2_from_int_pairs([(2, 3)], "cpu")
    fused.reset_launches()
    lb.inv(a)
    lb.pow_fixed(a, 17)
    tw.fp2_pow_fixed(b, 5)
    tw.fp2_inv(b)
    assert calls == [("fp_inv", (12, 2)), ("fp_pow", (12, 2), 17),
                     ("fp2_pow", (2, 12, 1), 5), ("fp_inv", (12, 1))]
    assert all(v == 0 for v in fused.launches.values())        # the plain versions
    assert [fused.WRAPPERS[k].__name__ for k in ("fp_inv", "fp_pow", "fp2_pow")] == \
        ["fp_inv", "fp_pow", "fp2_pow"]
    assert fused.PLAIN["fp_pow"] is fused.fp_pow_plain
    assert fused.PLAIN["fp2_pow"] is fused.fp2_pow_plain


def test_wrapper_checks():
    fp = lb.ints_to_limbs([1, 2], "cpu")
    fp2 = tw.fp2_from_int_pairs([(1, 2)], "cpu")
    for name, x, other in (("fp_pow", fp, fp2[..., :11, :]), ("fp2_pow", fp2, fp)):
        fn = fused.WRAPPERS[name]
        with pytest.raises(TypeError):
            fn(x.to(torch.int64), 3)
        with pytest.raises(ValueError):
            fn(other, 3)                                       # shape
        with pytest.raises(ValueError, match="contiguous"):
            fn(torch.cat([x, x], dim=-1)[..., ::2], 3)
        with pytest.raises(ValueError, match="no kernel for device"):
            fn(torch.empty(x.shape, dtype=torch.int32, device="meta"), 3)
        for bad in (-1, 2.0, 1 << fused.POW_EXPONENT_BITS):
            with pytest.raises(ValueError, match="exponent"):
                fn(x, bad)
        fused.reset_launches()
        assert torch.equal(fn(x, 0), fused.PLAIN[name](x, 0))
        assert fused.launches[name] == 0 and name in fused.PLAIN


def test_fp_inv_wrapper_checks():
    """fused.fp_inv takes contiguous int32 (..., 12, n) on the CPU (its
    plain version, test_plain_fp_inv_matches_jax) or a CUDA device, and
    raises otherwise."""
    x = lb.ints_to_limbs([1, 2], "cpu")
    with pytest.raises(TypeError):
        fused.fp_inv(x.to(torch.int64))
    with pytest.raises(ValueError):
        fused.fp_inv(x[:11])                                   # shape
    with pytest.raises(ValueError, match="contiguous"):
        fused.fp_inv(torch.cat([x, x], dim=-1)[..., ::2])
    with pytest.raises(ValueError, match="no kernel for device"):
        fused.fp_inv(torch.empty(x.shape, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        fused.fp_inv(x[0])                                     # no limb axis
    assert fused.WRAPPERS["fp_inv"] is fused.fp_inv and "fp_inv" in fused.launches
