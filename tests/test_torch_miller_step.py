"""Kernel K6 (csrc/curve_op.cu: a Miller loop's whole T chain in one launch,
fused.miller_chain, and its one-step calls fused.miller_dbl / miller_add)
on the CPU, where it cannot run:

- the two step schedules' words (fused.k5_plan_words, written into the
  generated header curve_plan.h) replayed in Python integers in the
  kernel's order, two levels a step, for both of its layouts (the replay
  of tests/test_torch_curve_op.py: each operand's combination, the
  product's rows, the column sums, the carry pass and REDC, one lane a
  unit and a pair of lanes a unit), with every bound asserted, over the
  chain's slots: T, Q and P loaded once into slots 0-14, level 0's
  reductions into slots that are neither Q's nor P's, level 1's point back
  into T's slots and its line out, step after step;
- the replay and K6's plain versions (pairing._dbl_step_plain /
  _add_step_plain, and fused.miller_chain_plain over them) against the
  JAX package's ops/bm/pairing._dbl_step / _add_step, jitted on the CPU,
  as integers mod p (JAX's limbs are only loose-canonical): each step on
  seeded random values, on curve points (2T and T + Q also against the
  oracle) and on columns of 0, 1 and p - 1; the chain's first 9 steps
  (doublings and additions in the Miller loop's order) step for step;
- the chain's plain version over all 68 steps against a loop of the
  per-step plain versions, T and every line, and pairing._miller_loop
  (one chain, then the f chain over its lines) against the per-step loop;
- the header's counts and words;
- the plain versions on strided (p_proj.select), broadcast and leading-axis
  operands against the contiguous call, and the kernel's addressing of them
  from fused._k6_args, the steps it is given;
- the wrappers' checks, and that a CPU tensor runs the plain version and
  launches nothing.
"""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lighthouse_tpu.ops.bm import limbs as bl
from lighthouse_tpu.ops.bm import pairing as bp
from lighthouse_tpu_torch.crypto.bls import curves as oc
from lighthouse_tpu_torch.crypto.bls import fields as ff
from lighthouse_tpu_torch.crypto.bls.constants import P
from lighthouse_tpu_torch.ops import fused
from lighthouse_tpu_torch.ops import limbs as lb
from lighthouse_tpu_torch.ops import pairing as tp
from lighthouse_tpu_torch.ops import tower as tw
from test_torch_curve_op import _products, _reduce

R = 1 << 384
R_INV = pow(R, -1, P)
N = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain kernel versions run many small ops; one intra-op thread
    is faster for them and leaves the other cores to other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# --- The kernel's schedule, replayed ------------------------------------------


@functools.lru_cache(maxsize=None)
def _plan(op):
    return fused.k5_plan_words(op), fused.k5_schedule(op)[1]


def _replay(steps, inputs):
    """The kernel on one pair, in both layouts (replay helpers of
    test_torch_curve_op): the input Fp values in the load's order (T, Q,
    px, py, pz; Montgomery forms) and the steps (0 a doubling, 1 an
    addition) -> (the last T's six Fp values, each step's line, six Fp
    values l0, l1, l2 by component)."""
    slots, lines = list(inputs), []
    prod_words, red_words = 2 * fused.K5_LIN, 1 + fused.K5_RED
    for add in steps:
        op = fused.K6_OPS[add]
        words, levels = _plan(op)
        out, pos = {}, 0
        for level, (products, reds) in enumerate(levels):
            wide = [_products(words[pos + prod_words * k:pos + prod_words * (k + 1)], slots, level)
                    for k in range(len(products))]
            pos += prod_words * len(products)
            new = {}
            for k in range(len(reds)):
                rec = words[pos + red_words * k:pos + red_words * (k + 1)]
                dest = (rec[0] >> 8) & 0xFF
                target = out if level else new
                assert dest not in target
                target[dest] = _reduce(rec, wide)
            pos += red_words * len(reds)
            for dest, v in new.items():                 # after every product of the level
                assert dest not in fused.K6_KEPT        # Q's and P's slots stay
                slots += [None] * (dest + 1 - len(slots))
                slots[dest] = v
        assert pos == len(words) and sorted(out) == list(range(12))
        assert len(slots) <= max(fused.k5_counts(o)["slots"] for o in fused.K6_OPS)
        slots[:6] = [out[i] for i in range(6)]          # the next step's T
        lines.append([out[i] for i in range(6, 12)])
    return slots[:6], lines


# --- Inputs -------------------------------------------------------------------


def _mont(x: int) -> int:
    return x * R % P


def _g2_proj(pt, z):
    return (ff.fp2_mul(pt[0], z), ff.fp2_mul(pt[1], z), z)


def _g1_proj(pt, z):
    return (pt[0] * z % P, pt[1] * z % P, z)


def _columns(case):
    """N columns of (T, Q, P) as integers mod p (the tensors hold their
    Montgomery forms): T and Q 6 values each (coordinate major, component
    minor), P 3. "stored_edges": the values whose Montgomery forms are 1,
    p - 1 and p - 2."""
    if case == "random":
        rng = np.random.default_rng(14)
        return [[int.from_bytes(rng.bytes(48), "little") % P for _ in range(15)]
                for _ in range(N)]
    if case == "edges":
        return [[v] * 15 for v in (0, 1, P - 1)]
    if case == "stored_edges":
        return [[v * R_INV % P] * 15 for v in (1, P - 1, P - 2)]
    g2 = [oc.g2_mul(oc.G2_GEN, k) for k in (1, 2, 3, 7)]
    g1 = [oc.g1_mul(oc.G1_GEN, k) for k in (5, 11, 13)]
    pairs = [(_g2_proj(g2[2], (5, 9)), _g2_proj(g2[0], (1, 0)), _g1_proj(g1[0], 7)),
             (_g2_proj(g2[3], (1, 0)), _g2_proj(g2[1], (2, 3)), _g1_proj(g1[1], 1)),
             (_g2_proj(g2[1], (4, P - 1)), _g2_proj(g2[3], (6, 0)), _g1_proj(g1[2], P - 2))]
    return [[c for pt in (t, q) for co in pt for c in co] + list(p) for t, q, p in pairs]


def _tensors(cols):
    """The columns as the port's tensors: T, Q (3, 2, 12, N), px, py, pz
    (12, N), P's coordinates p.select(-3, i) of one (3, 12, N) tensor."""
    def fp(i):
        return lb.ints_to_limbs([c[i] for c in cols], "cpu")

    t, q = (torch.stack([torch.stack([fp(b + 2 * k + c) for c in range(2)])
                         for k in range(3)]) for b in (0, 6))
    p = torch.stack([fp(12 + k) for k in range(3)])
    return t, q, *p.unbind(0)


def _bm(cols, first, shape):
    ints = [c[first + i] for i in range(int(np.prod(shape))) for c in cols]
    return jnp.asarray(np.moveaxis(bl.ints_to_bm_np(ints).reshape((48,) + shape + (N,)), 0, -2))


@functools.lru_cache(maxsize=None)
def _jax_step(op):
    return jax.jit(bp._dbl_step if op == "miller_dbl" else bp._add_step)


def _jax_ints(xs):
    """JAX's outputs -> their Fp values as lists of N ints mod p."""
    vals = [v % P for x in xs for v in bl.bm_to_ints(x)]
    return [vals[N * i:N * (i + 1)] for i in range(len(vals) // N)]


def _jax(steps, cols):
    """JAX's steps, one after another from T on the columns -> per step the
    twelve outputs (the point, then the line) as lists of N ints."""
    t, q = _bm(cols, 0, (3, 2)), _bm(cols, 6, (3, 2))
    ps = [_bm(cols, 12 + k, ()) for k in range(3)]
    got = []
    for add in steps:
        t, line = (_jax_step("miller_add")(t, q, *ps) if add
                   else _jax_step("miller_dbl")(t, *ps))
        got.append(_jax_ints((t,) + tuple(line)))
    return got


def _port(t, line):
    vals = lb.limbs_to_ints(t) + lb.limbs_to_ints(line)
    return [vals[N * i:N * (i + 1)] for i in range(len(vals) // N)]


def _replayed(steps, cols):
    """_replay on each column -> per step the twelve outputs as lists of N
    ints (read times R^-1)."""
    runs = [_replay(steps, tuple(_mont(v) for v in c)) for c in cols]
    got = []
    for s in range(len(steps)):
        vals = [[v * R_INV % P for v in (t if s == len(steps) - 1 else [0] * 6) + lines[s]]
                for t, lines in runs]
        got.append([[r[i] for r in vals] for i in range(12)])
    return got


def _affine(vals):
    x, y, z = (tuple(vals[2 * i:2 * i + 2]) for i in range(3))
    zi = ff.fp2_inv(z)
    return ff.fp2_mul(x, zi), ff.fp2_mul(y, zi)


@pytest.mark.parametrize("op", fused.K6_OPS)
@pytest.mark.parametrize("case", ["random", "curve", "edges", "stored_edges"])
def test_replay_and_plain_match_jax(op, case):
    """One step: the replay (one chain step from the loaded inputs) and the
    one-step call's plain version against JAX's step."""
    cols = _columns(case)
    t, q, px, py, pz = _tensors(cols)
    step = (fused.K6_OPS.index(op),)
    (replay,) = _replayed(step, cols)
    plain = _port(*(fused.miller_dbl(t, px, py, pz) if op == "miller_dbl"
                    else fused.miller_add(t, q, px, py, pz)))
    (want,) = _jax(step, cols)
    assert plain == want
    assert replay == want
    if case == "curve":                  # the point against the oracle, affine
        for j, c in enumerate(cols):
            tt, qq = _affine(c[:6]), _affine(c[6:12])
            got = _affine([want[i][j] for i in range(6)])
            assert got == (oc.g2_add(tt, tt) if op == "miller_dbl" else oc.g2_add(tt, qq))


FIRST = fused.MILLER_STEPS[:9]


def test_chain_first_steps_match_jax():
    """The chain's first 9 steps (doublings and additions in the loop's
    order, the last an addition) from curve points: the plain chain's T and lines, and the
    replay's lines and last T, against JAX's steps run one after another."""
    assert FIRST == (0, 1, 0, 0, 1, 0, 0, 0, 1)
    cols = _columns("curve")
    t, q, px, py, pz = _tensors(cols)
    t_last, lines = fused.miller_chain_plain(t, q, px, py, pz, FIRST)
    want = _jax(FIRST, cols)
    assert lines.shape == (9, 3, 2, 12, N)
    for s, w in enumerate(want):
        assert _port(t_last, lines[s])[6:] == w[6:], s
    assert _port(t_last, lines[-1])[:6] == want[-1][:6]
    replay = _replayed(FIRST, cols)
    assert [r[6:] for r in replay] == [w[6:] for w in want]
    assert replay[-1][:6] == want[-1][:6]


@pytest.fixture(scope="module")
def chain_columns():
    """Two pairs for the whole chain: curve points, as a Miller loop sees
    them (T = Q), with P's coordinates p_proj.select(-3, i); and the
    per-step loop over the plain versions: its T after each step and each
    step's line."""
    cols = [c[6:12] + c[6:12] + c[12:] for c in _columns("curve")[:2]]
    t, _, px, py, pz = _tensors(cols)
    cur, loop = t, []
    for add in fused.MILLER_STEPS:
        cur, line = (tp._add_step_plain(cur, t, px, py, pz) if add
                     else tp._dbl_step_plain(cur, px, py, pz))
        loop.append((cur, line))
    return cols, (t, px, py, pz), loop


def test_chain_plain_equals_step_loop(chain_columns):
    """All 68 steps: the chain (the wrapper on the CPU: its plain version)
    against a loop of the per-step plain versions, T and every line
    torch.equal."""
    _, (t, px, py, pz), loop = chain_columns
    fused.reset_launches()
    t_last, lines = fused.miller_chain(t, t, px, py, pz)
    assert all(v == 0 for v in fused.launches.values())       # the plain version
    assert lines.shape == (len(fused.MILLER_STEPS), 3, 2, 12, 2) and lines.is_contiguous()
    assert fused.MILLER_STEPS.count(0) == 63 and fused.MILLER_STEPS.count(1) == 5
    for s, (_, line) in enumerate(loop):
        assert torch.equal(lines[s], line), s
    assert torch.equal(t_last, loop[-1][0])


def test_miller_loop_runs_the_chain(chain_columns):
    """pairing._miller_loop (one chain, then K3's f chain over its lines)
    equals the per-step loop on the plain versions, bit for bit."""
    _, (t, px, py, pz), loop = chain_columns
    assert "miller_chain" in tp._miller_loop.__code__.co_names
    one = tw.consts("cpu").fp12_one
    acc = one.expand(px.shape[:-2] + one.shape[:-1] + px.shape[-1:]).contiguous()
    for add, (_, line) in zip(fused.MILLER_STEPS, loop):
        if not add:
            acc = tw.fp12_sqr(acc)
        acc = tw.fp12_mul_line(acc, line)
    assert torch.equal(tp._miller_loop(torch.stack([px, py, pz]), t), acc)


def test_steps_route_to_k6():
    assert tp._dbl_step.__code__.co_names.count("miller_dbl") == 1
    assert tp._add_step.__code__.co_names.count("miller_add") == 1
    assert fused.WRAPPERS["miller_dbl"] is fused.miller_dbl
    assert fused.WRAPPERS["miller_chain"] is fused.miller_chain
    t, q, px, py, pz = _tensors(_columns("random"))
    fused.reset_launches()
    got = tp._dbl_step(t, px, py, pz), tp._add_step(t, q, px, py, pz)
    assert all(v == 0 for v in fused.launches.values())       # the plain versions
    for (a, b), plain in zip(got, (tp._dbl_step_plain(t, px, py, pz),
                                   tp._add_step_plain(t, q, px, py, pz))):
        assert torch.equal(a, plain[0]) and torch.equal(b, plain[1])
        assert a.shape == b.shape == (3, 2, 12, N) and b.is_contiguous()


# --- The schedule and its header ----------------------------------------------


def test_header_counts_and_words():
    header = fused.k5_plan_header()
    for op in fused.K6_OPS:
        comps, levels = fused.k5_schedule(op)
        name = "".join(part.capitalize() for part in op.split("_"))
        block = header[header.index(f"struct K6{name} {{"):]
        counts = {k: int(v) for k, v in re.findall(r"(\w+) = (\d+)", block[:block.index("};")])}
        assert counts == fused.k5_counts(op)
        assert (counts["comps"], counts["inputs"], counts["fps"], len(levels)) == (2, 15, 3, 2)
        assert [(counts[f"np{i}"], counts[f"nr{i}"]) for i in range(2)] == [
            (len(p), len(r)) for p, r in levels]
        assert counts["warps"] >= counts["inputs"]      # one input Fp per unit
        body = block[block.index(f"kK6Plan{name}["):]
        got = [int(h, 16) for h in re.findall(r"0x([0-9a-f]{8})u", body[:body.index("};")])]
        assert got == fused.k5_plan_words(op)
        # Level 1 writes the point (0-5, also T's slots) and the line (6-11).
        assert [d for d, _, _ in levels[1][1]] == list(range(12))
        # P's products are level 0's: each one Fp by one of P's coordinates.
        by_p = [(x, y) for x, y in levels[0][0] if set(y) <= {12, 13, 14}]
        assert len(by_p) == 8 and all(len(y) == 1 and y[min(y)] == 1 for _, y in by_p)
        assert not any(k in (12, 13, 14) for x, y in levels[1][0] for k in (*x, *y))


def test_level_counts():
    """The products and reductions a level: the doubling's 5 Fp2 products
    (three squares) and 4 Fp2 x Fp, then K5's 4 Fp2 products and the line's
    4; the addition's K5 g2_add level 0, its 4 Fp2 products for n and d and
    4 Fp2 x Fp, then K5's and the line's 4 Fp2 products."""
    counts = {op: [(len(p), len(r)) for p, r in fused.k5_schedule(op)[1]]
              for op in fused.K6_OPS}
    assert counts["miller_dbl"] == [(20, 18), (24, 12)]
    assert counts["miller_add"] == [(38, 24), (30, 12)]


def test_slots_reuse_what_no_later_level_reads():
    """Level 0's reductions take T's slots (level 1 reads no input) and
    then the first past the inputs, never Q's or P's (6-14), which every
    step reads; level 1's go to the output indices, the point's also T's
    slots."""
    for op, last in (("miller_dbl", 26), ("miller_add", 32)):
        _, levels = fused.k5_schedule(op)
        assert [d for d, _, _ in levels[0][1]] == list(range(6)) + list(range(15, last + 1))
        assert not fused.K6_KEPT & {d for d, _, _ in levels[0][1]}
        reads = {k for x, y in levels[1][0] for k in (*x, *y)}
        assert reads <= {d for d, _, _ in levels[0][1]}        # level 0's values only
        assert fused.k5_counts(op)["slots"] == last + 1


def test_chain_steps_and_arguments():
    """The chain's steps (the bits of |x| after the leading one: a doubling
    a bit, an addition a set bit) as the launch passes them, a byte each;
    the one-step calls' one step; the line buffer's shape."""
    from lighthouse_tpu_torch.crypto.bls.constants import BLS_X_ABS
    bits = bin(BLS_X_ABS)[3:]
    assert len(fused.MILLER_STEPS) == len(bits) + bits.count("1") == 68
    assert list(fused._k6_steps("miller_chain")) == list(fused.MILLER_STEPS)
    assert list(fused._k6_steps("miller_dbl")) == [0] and list(fused._k6_steps("miller_add")) == [1]
    t, q, px, py, pz = _tensors(_columns("random"))
    for name, xs, steps in (("miller_chain", (t, q, px, py, pz), 68), ("miller_dbl", (t, px, py, pz), 1),
                            ("miller_add", (t, q, px, py, pz), 1)):
        (out, lines), ops, args = fused._k6_args(name, xs)
        assert out.shape == t.shape and lines.shape == (steps,) + t.shape
        assert len(ops) == 5 and (name != "miller_dbl" or ops[1] is ops[0])
        assert args[9] is fused._k6_steps(name) and args[10] == steps
    src = (Path(fused.__file__).parent / "csrc" / "curve_op.cu").read_text()
    assert f"constexpr int kMaxSteps = {fused.K6_MAX_STEPS};" in src
    assert re.search(r"#define LH_K6_PAIR_P ([124])\n", src)
    assert 'extern "C" int lh_miller_chain(' in src and "lh_miller_dbl" not in src


# --- Layouts and the kernel's addressing --------------------------------------


def _layouts():
    t, q, px, py, pz = _tensors(_columns("random"))
    lead = torch.stack([t, q])
    p_lead = torch.stack([torch.stack([px, py, pz])] * 2)            # (2, 3, 12, N)
    perm = t.movedim(-2, -1).contiguous().movedim(-1, -2)           # limb stride 1
    return {
        "p_proj.select": ((t, q), (px, py, pz)),
        "leading T, broadcast P": ((lead, q), (px, py, pz)),
        "leading P": ((t, q), tuple(p_lead.select(-3, i) for i in range(3))),
        "broadcast column": ((t[..., :1], q), (px, py[..., :1], pz)),
        "permuted strides": ((perm, q), (px, py, pz)),
        # Three lead axes that fold into no two levels: copied dense.
        "three lead levels": ((torch.stack([t, q] * 4).reshape((2, 2, 2) + t.shape)
                               .permute(2, 1, 0, 3, 4, 5, 6), q), (px, py, pz)),
    }


def _dense(op, xs):
    """xs broadcast to the launch's shape, each contiguous."""
    kinds = fused._KERNELS[op][2]
    shape = torch.broadcast_shapes(*(x.shape if k == "g2" else x.shape[:-2] + (1, 1) + x.shape[-2:]
                                     for x, k in zip(xs, kinds)))
    return [x.expand(shape if k == "g2" else shape[:-4] + shape[-2:]).contiguous()
            for x, k in zip(xs, kinds)]


@pytest.mark.parametrize("op", fused.K6_OPS)
def test_plain_layouts_equal_contiguous(op):
    for name, ((t, q), ps) in _layouts().items():
        xs = _wrapper_operands(op, t, q, ps)
        fn = fused.WRAPPERS[op]
        got, want = fn(*xs), fn(*_dense(op, xs))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), name


def _kernel_reads(name, xs):
    """The kernel's view of each operand from the wrapper's arguments: input
    Fp (coordinate c, component k) of operand o (T, Q, px, py, pz), limb l
    of pair (row, j), row = (r1, r0), at r1 s1 + r0 s0 + c sc + k sk + l sl
    + j sn from its pointer; P's coordinates have sc = sk = 0."""
    (out, lines), views, args = fused._k6_args(name, xs)
    kinds = ("g2", "g2", "fp", "fp", "fp")
    views = [v if k == "g2" else v[..., None, None, :, :] for v, k in zip(views, kinds)]
    m = len(views)
    ptrs = args[2:2 + m]
    rows, n, steps, count, geom = args[2 + m:]
    vals = list(geom)
    assert m == 5 and len(vals) == 1 + 6 * m and out.is_contiguous() and lines.is_contiguous()
    assert lines.shape == (count,) + out.shape and len(steps) == count
    r0, strides = vals[0], [vals[1 + 6 * i:7 + 6 * i] for i in range(m)]
    assert rows % r0 == 0 and out.numel() == rows * 6 * 12 * n
    e = torch.arange(rows * n)
    row, j = e // n, e % n
    r1, rr0 = row // r0, row % r0
    got = []
    for i, x in enumerate(views):
        s1, s0, sc, sk, sl, sn = strides[i]
        flat = torch.as_strided(x, (x.untyped_storage().nbytes() // 4,), (1,), 0)
        base = (ptrs[i] - x.untyped_storage().data_ptr()) // 4
        idx = (base + r1 * s1 + rr0 * s0 + j * sn)[None, None, None, :] \
            + (torch.arange(3) * sc)[:, None, None, None] \
            + (torch.arange(2) * sk)[None, :, None, None] \
            + (torch.arange(12) * sl)[None, None, :, None]
        got.append(flat[idx].reshape(3, 2, 12, rows, n).permute(3, 0, 1, 2, 4)
                   .reshape(out.shape))
    return out, got


K6_WRAPPERS = fused.K6_OPS + ("miller_chain",)


def _wrapper_operands(op, t, q, ps):
    return (t, *ps) if op == "miller_dbl" else (t, q, *ps)


@pytest.mark.parametrize("op", K6_WRAPPERS)
def test_launch_arguments_address_each_operand(op):
    for name, ((t, q), ps) in _layouts().items():
        xs = _wrapper_operands(op, t, q, ps)
        out, got = _kernel_reads(op, xs)
        launched = (t, t, *ps) if op == "miller_dbl" else xs     # a doubling: T in Q's place
        for x, kind, g in zip(launched, ("g2", "g2", "fp", "fp", "fp"), got):
            want = x if kind == "g2" else x[..., None, None, :, :]
            assert torch.equal(g, want.expand(out.shape)), (name, kind)


# --- The wrappers -------------------------------------------------------------


@pytest.mark.parametrize("op", K6_WRAPPERS)
def test_wrapper_checks(op):
    fn = fused.WRAPPERS[op]
    g2 = torch.zeros((3, 2, 12, 4), dtype=torch.int32)
    fp = torch.zeros((12, 4), dtype=torch.int32)
    pts = (g2,) if op == "miller_dbl" else (g2, g2)

    with pytest.raises(TypeError):
        fn(*(x.to(torch.int64) for x in pts), fp, fp, fp)
    with pytest.raises(ValueError):
        fn(*pts, fp[:11], fp, fp)
    with pytest.raises(ValueError):
        fn(g2[..., 0, :, :], *pts[1:], fp, fp, fp)
    with pytest.raises(ValueError, match="operands on"):
        fn(*pts, fp, fp, torch.empty(fp.shape, dtype=torch.int32, device="meta"))
    meta = [torch.empty(x.shape, dtype=torch.int32, device="meta") for x in pts + (fp,) * 3]
    with pytest.raises(ValueError, match="no kernel for device"):
        fn(*meta)
    assert fused.launches[op] == 0 and op in fused.PLAIN
