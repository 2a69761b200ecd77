"""Kernel K4's signed linear combinations (ops/fused.py fp_lincomb,
csrc/fp_add.cu lh_fp_lincomb) on the CPU.

- The plain version (fp_lincomb_plain) against the JAX package's
  batch-minor add / sub / neg composed row by row and then canonicalized,
  and against Python integers mod p, on seeded and edge values, with
  tolerance zero.
- The kernel's one-pass arithmetic (csrc/fp.cuh sum_mod) replayed in
  Python integers on the plan words the wrapper packs, every bound it
  relies on asserted: the largest sum of |c|, every term p - 1, negative
  coefficients, the quotient estimate floor(v / p) or one less.
- The launch arguments (plan, operand pointers, geometry) replayed as the
  kernel reads memory, on strided, broadcast and several operands; the
  wrapper's refusals past the kernel's bounds.
- The functions rerouted through it against lighthouse_tpu/ops/bm/tower.py
  and h2c.py, jitted on the CPU.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lighthouse_tpu.crypto.bls.constants import P
from lighthouse_tpu.ops.bm import h2c as bh
from lighthouse_tpu.ops.bm import limbs as bl
from lighthouse_tpu.ops.bm import tower as bt
from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch.ops import curves, fused, h2c
from lighthouse_tpu_torch.ops import tower as tt
from test_torch_fp_add import EDGE_PAIRS, MASK, P_LIMBS, _limbs, _raw, _raw_ints, _value


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's test modules pin torch to one intra-op thread, leaving
    the other cores to other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


CSRC = Path(fused.__file__).parent / "csrc"
MAXC, MAXS = fused.LINCOMB_MAX_COEFF, fused.LINCOMB_MAX_SUM
# Plans past the paths': small multiples and a row of zeros, and the
# bounds' worst rows (every |c| and their sum at the limits, both signs).
EXTRA = {
    "small_multiples": ((3, -2, 0, 5), (0, 0, 0, 0), (-7, 1, 1, -1)),
    "worst": ((MAXC,) * 4 + (3,), (-MAXC,) * 4 + (-3,), (MAXC, -MAXC, MAXC, -MAXC, 3)),
}


def _plans():
    """The paths' plans (registered by tower, h2c and curves) and EXTRA."""
    return {**fused.LINCOMB_PLANS, **EXTRA}


def _term_values(rng, j, n):
    """Stored values (below p) of j terms over n columns: column c holds
    edge pair c's first value in even terms and its second in odd ones."""
    vals = [[int.from_bytes(rng.bytes(48), "little") % P for _ in range(n)] for _ in range(j)]
    for c, pair in enumerate(EDGE_PAIRS[:n]):
        for t in range(j):
            vals[t][c] = pair[t % 2]
    return vals


def _terms_tensor(vals):
    """[[value per column] per term] -> (J, 12, n) stored limbs."""
    return torch.stack([_raw(v) for v in vals])


# --- The plain version --------------------------------------------------------


PLAIN_N = 16


@pytest.fixture(scope="module")
def plain_cases():
    """Per plan: (operand, plain output) at PLAIN_N columns."""
    rng = np.random.default_rng(20261018)
    out = {}
    for name, coeffs in _plans().items():
        x = _terms_tensor(_term_values(rng, len(coeffs[0]), PLAIN_N))
        out[name] = (x, fused.fp_lincomb_plain(x, coeffs))
    return out


def test_plain_matches_ints(plain_cases):
    for name, coeffs in _plans().items():
        x, got = plain_cases[name]
        terms = [_raw_ints(x[j]) for j in range(x.shape[0])]
        assert got.shape == (len(coeffs), 12, PLAIN_N) and got.dtype == torch.int32
        for r, row in enumerate(coeffs):
            want = [sum(c * t[i] for c, t in zip(row, terms)) % P for i in range(PLAIN_N)]
            assert _raw_ints(got[r]) == want, (name, r)


def test_plain_matches_bm_composition(plain_cases):
    """Each row composed of JAX's bm add / sub / neg (a multiple by repeated
    adds) over the standard forms, canonicalized in one jitted call, and
    compared as integers mod p."""
    names = [k for k, c in _plans().items() if max(abs(v) for row in c for v in row) <= 7]
    outs, want = [], []
    for name in names:
        x, got = plain_cases[name]
        # bl.add / sub / neg are digit-wise array sums: on the host digits.
        terms = [bl.ints_to_bm_np(convert.to_ints(x[j])) for j in range(x.shape[0])]
        for r, row in enumerate(_plans()[name]):
            acc = bl.ints_to_bm_np([0] * PLAIN_N)
            for c, t in zip(row, terms):
                for _ in range(abs(c)):
                    acc = bl.sub(acc, t) if c < 0 else bl.add(acc, t)
            outs.append(acc)
            want += convert.to_ints(got[r])
    canon = jax.jit(bl.canonicalize)(jnp.asarray(np.concatenate(outs, axis=-1), dtype=bl.DTYPE))
    assert bl.bm_to_ints(canon) == want


def test_plain_broadcast_and_operands():
    """Several operands, a broadcast lead axis and a broadcast column (a
    constant) give what one dense operand gives."""
    rng = np.random.default_rng(5)
    a = _terms_tensor(_term_values(rng, 6, 14)).reshape(3, 2, 12, 14)
    one = _raw([1, 2])[:, :1].reshape(1, 1, 12, 1).expand(1, 2, 12, 1)
    b = _terms_tensor(_term_values(rng, 2, 14))
    coeffs = ((1, 0, -1, 0, 2, 0), (0, 1, 0, 1, 0, -1))
    got = fused.fp_lincomb((a, one, b), coeffs)
    dense = torch.cat([a, one.expand(3, 2, 12, 14), b.expand(3, 2, 12, 14)], dim=1)
    assert got.shape == (3, 2, 12, 14)
    assert torch.equal(got, fused.fp_lincomb_plain(dense, coeffs))


# --- csrc/fp_add.cu and fp.cuh sum_mod replayed ---------------------------------


def plan_rows(coeffs, terms):
    """The packed plan (fused._lincomb_plan) decoded: per row its words as
    (operand, term, coefficient), checked against the matrix."""
    arr = list(fused._lincomb_plan(coeffs, terms))
    rows = arr[0]
    start, words = arr[1:2 + rows], arr[2 + rows:]
    assert start[0] == 0 and start[-1] == len(words) <= fused.LINCOMB_MAX_WORDS
    where = [(o, j) for o, t in enumerate(terms) for j in range(t)]
    out = []
    for r in range(rows):
        row = []
        for w in words[start[r]:start[r + 1]]:
            c = w >> 8
            c = c - (1 << 24) if c >= 1 << 23 else c          # (int)w >> 8
            row.append(((w >> 6) & 3, w & 63, c))
        assert [c for (o, j), c in zip(where, coeffs[r]) if c] == [c for _, _, c in row]
        assert [where.index((o, j)) for o, j, _ in row] == [
            i for i, c in enumerate(coeffs[r]) if c]
        out.append(row)
    return out


def sum_mod(terms, coeffs):
    """One output of csrc/fp_add.cu: the terms' signed 64-bit column sums,
    then fp.cuh sum_mod: + m p in the carry pass (an arithmetic shift), the
    estimate q = trunc(v_hi * kInvHi) in IEEE doubles, v - q p by a signed
    borrow chain and one conditional subtraction; every bound asserted.
    terms: stored values below p; coeffs: their coefficients."""
    col, m = [0] * 12, 0
    for c, x in zip(coeffs, terms):
        assert 0 <= x < P and 0 < abs(c) <= MAXC
        for l, w in enumerate(_limbs(x)):
            col[l] += c * w
            assert abs(col[l]) < 1 << 51
        m += -c if c < 0 else 0
    assert sum(map(abs, coeffs)) <= MAXS
    carry, v = 0, []
    for l in range(12):
        carry += col[l] + m * P_LIMBS[l]
        assert abs(carry) < 1 << 53
        v.append(carry & MASK)
        carry >>= 32
    assert 0 <= carry < 1 << 15
    value = _value(v) + (carry << 384)
    assert value == sum(c * x for c, x in zip(coeffs, terms)) + m * P
    assert 0 <= value < (MAXS + 1) * P
    hi = (carry << 32) | v[11]
    assert hi < 1 << 47
    q = int(float(hi) * fused.K5_INV_HI)                  # (long long)((double)hi * kInvHi)
    assert q in (value // P, value // P - 1)
    br, d = 0, []
    for l in range(12):
        br += v[l] - q * P_LIMBS[l]
        assert abs(br) < 1 << 63
        d.append(br & MASK)
        br >>= 32
    r = _value(d)
    assert r == value - q * P and 0 <= r < 2 * P
    return r - P if r >= P else r                          # lh::canonical


def replay(coeffs, term_vals):
    """Every output of a one-operand launch, from the packed plan's words."""
    out = []
    for row in plan_rows(coeffs, (len(term_vals),)):
        out.append(sum_mod([term_vals[j] for _, j, _ in row], [c for _, _, c in row])
                   if row else 0)
    return out


def test_replay_path_plans_on_edge_pairs():
    for name, coeffs in _plans().items():
        j = len(coeffs[0])
        for pair in EDGE_PAIRS:
            vals = [pair[t % 2] for t in range(j)]
            want = [sum(c * v for c, v in zip(row, vals)) % P for row in coeffs]
            assert replay(coeffs, vals) == want, name


@pytest.mark.parametrize("fill", [P - 1, 0, 1, "mixed"])
def test_replay_worst_rows(fill):
    """The bounds' worst rows: sum |c| = 2^18 - 1 of |c| = 2^16 - 1, both
    signs, every term p - 1 (the largest v and hi), 0, 1 or mixed."""
    coeffs = EXTRA["worst"]
    vals = [P - 1, 0, P - 1, 1, P - 2] if fill == "mixed" else [fill] * 5
    want = [sum(c * v for c, v in zip(row, vals)) % P for row in coeffs]
    assert replay(coeffs, vals) == want
    assert sum(map(abs, coeffs[0])) == MAXS


def test_replay_random_plans():
    rng = np.random.default_rng(11)
    for _ in range(40):
        j = int(rng.integers(1, 9))
        coeffs = tuple(tuple(int(c) for c in rng.integers(-MAXC, MAXC + 1, j) // (1 << int(
            rng.integers(0, 17)))) for _ in range(int(rng.integers(1, 5))))
        if any(sum(map(abs, row)) > MAXS for row in coeffs):
            continue
        vals = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(j)]
        want = [sum(c * v for c, v in zip(row, vals)) % P for row in coeffs]
        assert replay(coeffs, vals) == want


def test_kernel_source_bounds():
    """csrc/fp_add.cu's bounds are the wrapper's, its word layout the
    packer's; the header's quotient constant is fused.K5_INV_HI."""
    src = (CSRC / "fp_add.cu").read_text()
    consts = dict(re.findall(r"constexpr (?:int|long long) (k\w+) = ([^;]+);", src))
    assert eval(consts["kMaxOps"]) == fused.LINCOMB_MAX_OPS
    assert eval(consts["kMaxTerms"]) == fused.LINCOMB_MAX_TERMS
    assert eval(consts["kMaxRows"]) == fused.LINCOMB_MAX_ROWS
    assert eval(consts["kMaxWords"]) == fused.LINCOMB_MAX_WORDS
    assert eval(consts["kMaxCoeff"]) == MAXC == fused.MUL_SMALL_MAX - 1
    assert eval(consts["kMaxSum"]) == MAXS == (1 << 18) - 1
    assert (MAXS + 1) * P < 1 << 399                       # v_hi < 2^47
    assert "(w >> 6) & 3u" in src and "(w & 63u)" in src and "(int)w >> 8" in src
    assert f"kInvHi = {fused.K5_INV_HI.hex()};" in (CSRC / "fp.cuh").read_text()
    assert 'extern "C" int lh_fp_lincomb(' in src and 'extern "C" int lh_fp_add_empty(' in src


# --- The launch arguments, read as the kernel reads memory -------------------


def kernel_reads(out, inputs, args):
    """Each operand's terms as the kernel reads them from the wrapper's
    arguments (out, xs, nops, rows, n, plan, geom): output Fp t = (row, r),
    row = (r1, r0), term j of operand o, limb l, column i at ptr_o + r1 s1
    + r0 s0 + j sj + l sl + i sn -> per operand (rows, J_o, 12, n)."""
    out_ptr, ptrs, nops, rows, n, plan, geom = args
    assert out_ptr == out.data_ptr() and out.is_contiguous() and nops == len(inputs)
    vals = list(geom)
    assert len(vals) == 1 + 6 * nops
    r0 = vals[0]
    assert rows % r0 == 0 and out.numel() == rows * plan[0] * 12 * n
    row = torch.arange(rows)
    r1, rr0 = row // r0, row % r0
    views = []
    for o, x in enumerate(inputs):
        jo, s1, s0, sj, sl, sn = vals[1 + 6 * o:7 + 6 * o]
        assert jo == x.shape[-3] and list(ptrs)[o] == x.data_ptr()
        flat = torch.as_strided(x, (x.untyped_storage().nbytes() // 4,), (1,), 0)
        base = (x.data_ptr() - x.untyped_storage().data_ptr()) // 4
        idx = (base + (r1 * s1 + rr0 * s0)[:, None, None, None]
               + (torch.arange(jo) * sj)[None, :, None, None]
               + (torch.arange(12) * sl)[None, None, :, None]
               + (torch.arange(n) * sn)[None, None, None, :])
        views.append(flat[idx])
    return views


def _lincomb_layouts():
    g = torch.Generator().manual_seed(9)

    def rand(*shape):
        return torch.randint(-2**31, 2**31, shape, generator=g, dtype=torch.int32)

    base = rand(2, 3, 4, 12, 7)
    other = rand(2, 3, 2, 12, 7)
    const = rand(2, 12, 1)
    return {
        "one operand": (base,),
        "term slice": (base[:, :, 1:3],),
        "middle select": (base[:, 1],),
        "several, broadcast column": (base, const, other),
        "broadcast lead": (base, other[:1]),
        "column slices": (base[..., 2:6], other[..., 1:5]),
        "three levels": (base[:, ::2, :, :, :], other[:, 1:]),
        "transposed": (base.transpose(0, 1), other.transpose(0, 1)),
    }


@pytest.mark.parametrize("layout", list(_lincomb_layouts()))
def test_launch_arguments_address_each_term(layout):
    xs = _lincomb_layouts()[layout]
    lead, n = fused._lincomb_shape(xs)
    coeffs = (tuple([1] * sum(x.shape[-3] for x in xs)),)
    out, inputs, args = fused._lincomb_args(xs, coeffs)
    assert out.shape == lead + (1, 12, n)
    for got, x in zip(kernel_reads(out, inputs, args), xs):
        want = x.expand(lead + x.shape[-3:-1] + (n,)).reshape((-1,) + x.shape[-3:-1] + (n,))
        assert torch.equal(got, want)


def test_wrapper_refuses_past_the_bounds():
    x = _raw(list(range(8))).reshape(12, 8).expand(5, 12, 8).contiguous()
    bad = {
        "rows": ((1, 0, 0, 0, 0),) * (fused.LINCOMB_MAX_ROWS + 1),
        "coefficient": ((MAXC + 1, 0, 0, 0, 0),),
        "sum": ((MAXC,) * 4 + (4,),),
        "row length": ((1, 1),),
        "float": ((1.0, 0, 0, 0, 0),),
    }
    for what, coeffs in bad.items():
        with pytest.raises(ValueError):
            fused.fp_lincomb(x, coeffs)
    fused.fp_lincomb(x, EXTRA["worst"])                              # at the bounds
    wide = torch.zeros((fused.LINCOMB_MAX_TERMS + 1, 12, 1), dtype=torch.int32)
    with pytest.raises(ValueError):
        fused.fp_lincomb(wide, ((1,) * (fused.LINCOMB_MAX_TERMS + 1),))
    many = torch.zeros((fused.LINCOMB_MAX_WORDS // 32 + 1, 32, 12, 1), dtype=torch.int32)
    with pytest.raises(ValueError):
        fused.fp_lincomb(tuple(many), ((1,) * (32 * many.shape[0]),))   # > 4 operands
    x64 = torch.zeros((33, 12, 1), dtype=torch.int32)
    with pytest.raises(ValueError):
        fused.fp_lincomb((x64, x64, x64, x64), ((1,) * 132,))          # > 128 words
    row = ((1, 0, 0, 0, 0),)
    with pytest.raises(TypeError):
        fused.fp_lincomb(x.to(torch.int64), row)
    with pytest.raises(ValueError):
        fused.fp_lincomb(x[:, :11], row)
    meta = torch.empty((5, 12, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="operands on"):
        fused.fp_lincomb((x, meta), ((1,) + (0,) * 9,))
    fused.reset_launches()
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fused.fp_lincomb(meta, row)
    assert all(v == 0 for v in fused.launches.values())


def test_routing_and_registry():
    """The rerouted functions call fp_lincomb; the CPU takes its plain
    version and counts no launch; every registered plan is within bounds."""
    assert fused.WRAPPERS["fp_lincomb"] is fused.fp_lincomb
    assert fused.PLAIN["fp_lincomb"] is fused.fp_lincomb_plain
    assert fused._KERNELS["fp_lincomb"][:2] == ("fp_add", "lh_fp_lincomb")
    assert {"fp6_mul", "fp6_inv_c", "fp2_inv", "fp12_conj", "iso_map_sums", "sswu_tv2",
            "g2_neg", "g1_neg"} <= set(fused.LINCOMB_PLANS)
    for coeffs in fused.LINCOMB_PLANS.values():
        fused._check_coeffs(coeffs, (len(coeffs[0]),))
    calls = []
    run = fused._run_lincomb
    fused._run_lincomb = lambda xs, c: calls.append(c) or run(xs, c)
    fused.reset_launches()
    try:
        a = tt.fp2_from_int_pairs([(1, 2), (3, 4)], "cpu")
        tt.fp2_conj(a)
        tt.fp2_mul_by_xi(a)
        curves.G2.neg(torch.stack([a, a, a]))
    finally:
        fused._run_lincomb = run
    assert calls == [tt._CONJ, tt._XI, curves._NEG_Y[2]]
    assert all(v == 0 for v in fused.launches.values())


# --- The rerouted functions against the JAX package ---------------------------


def _bm_digits(rng, lead, n, zero=None):
    """Canonical bm digits (*lead, 48, n) of random values; `zero`: lead
    indices whose values are 0."""
    count = int(np.prod(lead)) * n
    ints = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(count)]
    d = np.moveaxis(bl.ints_to_bm_np(ints).reshape(48, *lead, n), 0, -2).copy()
    for idx in zero or ():
        d[idx] = 0
    return d


@pytest.mark.parametrize("op", ["fp2_conj", "fp2_mul_by_xi", "fp6_mul"])
def test_tower_matches_bm(op):
    rng = np.random.default_rng(31)
    lead = (2,) if op.startswith("fp2") else (3, 2)
    xs = [_bm_digits(rng, lead, 5) for _ in range(2 if op == "fp6_mul" else 1)]
    ref = jax.jit(getattr(bt, op))(*map(jnp.asarray, xs))
    got = getattr(tt, op)(*map(convert.from_jax_limbs, xs))
    assert convert.to_ints(got) == bl.bm_to_ints(ref)


def _host_inv(a):
    """bl.inv's value, x^(p - 2) per element, computed on the host through
    jax.pure_callback: JAX's own inverse is a 95-step lax.scan whose
    compile takes 5-7 s here (tests/test_torch_fp_pow.py holds the port's
    inverse against it)."""
    def inv(x):
        x = np.asarray(x)
        d = bl.ints_to_bm_np([pow(v, P - 2, P) for v in bl.bm_to_ints(x)])
        return np.moveaxis(d.reshape(x.shape[-2], *x.shape[:-2], x.shape[-1]), 0, -2).astype(
            x.dtype)

    return jax.pure_callback(inv, jax.ShapeDtypeStruct(a.shape, a.dtype), a)


def test_fp6_inv_and_fp2_inv_match_bm(monkeypatch):
    """One jitted bt.fp6_inv (its Fp inverse _host_inv) over five columns:
    0-2 random, 3-4 (a0, 0, 0) (column 4's a0 also 0), whose inverse is
    (a0^-1, 0, 0) through JAX's fp2_inv, the reference for the port's
    fp2_inv of a0 there."""
    monkeypatch.setattr(bl, "inv", _host_inv)
    rng = np.random.default_rng(32)
    a = _bm_digits(rng, (3, 2), 5)
    a[1:, :, :, 3:] = 0
    a[0, :, :, 4] = 0
    ref = jax.jit(bt.fp6_inv)(jnp.asarray(a))
    ta = convert.from_jax_limbs(a)
    assert convert.to_ints(tt.fp6_inv(ta)) == bl.bm_to_ints(ref)
    got = tt.fp2_inv(ta[0, :, :, 3:])
    assert convert.to_ints(got) == bl.bm_to_ints(np.asarray(ref)[0, :, :, 3:])


def test_iso_map_homogeneous_matches_bm():
    rng = np.random.default_rng(33)
    xn, xd, y = (_bm_digits(rng, (2,), 3) for _ in range(3))
    ref = jax.jit(bh.iso_map_homogeneous)(*map(jnp.asarray, (xn, xd, y)))
    got = h2c.iso_map_homogeneous(*map(convert.from_jax_limbs, (xn, xd, y)))
    assert convert.to_ints(got) == bl.bm_to_ints(ref)


@pytest.mark.parametrize("group", ["G1", "G2"])
def test_point_negation_and_curve_equation(group):
    """G1 / G2 neg (one launch writing the whole point) and on_curve (its
    sum one launch) against the oracle, on the generator, its double and a
    point off the curve."""
    from lighthouse_tpu.crypto.bls import curves as oc

    gen = getattr(oc, f"{group}_GEN")
    mul, neg = getattr(oc, f"{group.lower()}_mul"), getattr(oc, f"{group.lower()}_neg")
    pts = [gen, mul(gen, 2)]
    t = getattr(curves, f"{group.lower()}_from_affine")(pts, "cpu")
    g = getattr(curves, group)
    assert curves.to_affine_ints(g.neg(t), group) == [neg(p) for p in pts]
    off = t.clone()
    off[0] = g.neg(t)[1]                                  # X := -Y
    assert g.on_curve(t).tolist() == [True, True]
    assert g.on_curve(off).tolist() == [False, False]
