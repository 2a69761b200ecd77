"""Kernel K6 (csrc/curve_op.cu, the Miller loop's doubling and addition
steps, fused.miller_dbl / miller_add) on the CPU, where it cannot run:

- the schedule's words (fused.k5_plan_words, written into the generated
  header curve_plan.h) replayed in Python integers in the kernel's order,
  three levels, for both of its layouts (the replay of
  tests/test_torch_curve_op.py: each operand's combination, the product's
  rows, the column sums, the carry pass and REDC, one lane a unit and a pair
  of lanes a unit), with every bound asserted and each reduction sent to its
  slot or, the last level's and those flagged K5_OUT, to the output;
- the replay and K6's plain versions (pairing._dbl_step_plain /
  _add_step_plain) against the JAX package's ops/bm/pairing._dbl_step /
  _add_step, jitted on the CPU, as integers mod p (JAX's limbs are only
  loose-canonical), on seeded random values, on curve points (2T and T + Q
  also against the oracle) and on columns of 0, 1 and p - 1;
- the header's counts and words;
- the plain versions on strided (p_proj.select), broadcast and leading-axis
  operands against the contiguous call, and the kernel's addressing of them
  from fused._k6_args;
- the wrappers' checks, and that a CPU tensor runs the plain version and
  launches nothing.
"""

import functools
import re

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


def _replay(op, inputs):
    """The kernel on one pair, in both layouts (replay helpers of
    test_torch_curve_op): the input Fp values in the load's order (T, [Q,]
    px, py, pz; Montgomery forms) -> the twelve output Fp values, the point
    (coordinate * 2 + component), then the line (l0, l1, l2)."""
    words, levels = _plan(op)
    slots, out, pos = list(inputs), {}, 0
    prod_words, red_words = 2 * fused.K5_LIN, 1 + fused.K5_RED
    for level, (products, reds) in enumerate(levels):
        wide = [_products(words[pos + prod_words * k:pos + prod_words * (k + 1)], slots, level)
                for k in range(len(products))]
        pos += prod_words * len(products)
        new = {}
        for k in range(len(reds)):
            rec = words[pos + red_words * k:pos + red_words * (k + 1)]
            dest = (rec[0] >> 8) & 0xFF
            to_out = level == len(levels) - 1 or rec[0] & (fused.K5_OUT << 8)
            target = out if to_out else new
            assert dest not in target
            target[dest] = _reduce(rec, wide)
        pos += red_words * len(reds)
        for dest, v in new.items():                     # after every product of the level
            slots += [None] * (dest + 1 - len(slots))
            slots[dest] = v
    assert pos == len(words) and sorted(out) == list(range(12))
    assert len(slots) <= fused.k5_counts(op)["slots"]
    return [out[i] for i in range(12)]


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


def _jax(op, cols):
    """JAX's step on the columns -> the twelve outputs as lists of N ints."""
    t, q = _bm(cols, 0, (3, 2)), _bm(cols, 6, (3, 2))
    ps = [_bm(cols, 12 + k, ()) for k in range(3)]
    pt, (l0, l1, l2) = (_jax_step(op)(t, *ps) if op == "miller_dbl"
                        else _jax_step(op)(t, q, *ps))
    vals = bl.bm_to_ints(pt) + [v for x in (l0, l1, l2) for v in bl.bm_to_ints(x)]
    return [vals[N * i:N * (i + 1)] for i in range(12)]


def _port(out):
    t, line = out
    vals = lb.limbs_to_ints(t) + lb.limbs_to_ints(line)
    return [vals[N * i:N * (i + 1)] for i in range(12)]


def _affine(vals):
    x, y, z = (tuple(vals[2 * i:2 * i + 2]) for i in range(3))
    zi = ff.fp2_inv(z)
    return ff.fp2_mul(x, zi), ff.fp2_mul(y, zi)


@pytest.mark.parametrize("op", fused.K6_OPS)
@pytest.mark.parametrize("case", ["random", "curve", "edges", "stored_edges"])
def test_replay_and_plain_match_jax(op, case):
    cols = _columns(case)
    t, q, px, py, pz = _tensors(cols)
    loads = (lambda c: c) if op == "miller_add" else (lambda c: c[:6] + c[12:])
    replay = [[v * R_INV % P for v in _replay(op, tuple(_mont(v) for v in loads(c)))]
              for c in cols]
    plain = _port(fused.miller_dbl(t, px, py, pz) if op == "miller_dbl"
                  else fused.miller_add(t, q, px, py, pz))
    want = _jax(op, cols)
    assert plain == want
    assert [[r[i] for r in replay] for i in range(12)] == want
    if case == "curve":                  # the point against the oracle, affine
        for j, c in enumerate(cols):
            tt, qq = _affine(c[:6]), _affine(c[6:12])
            got = _affine([want[i][j] for i in range(6)])
            assert got == (oc.g2_add(tt, tt) if op == "miller_dbl" else oc.g2_add(tt, qq))


def test_steps_route_to_k6():
    assert tp._dbl_step.__code__.co_names.count("miller_dbl") == 1
    assert tp._add_step.__code__.co_names.count("miller_add") == 1
    assert fused.WRAPPERS["miller_dbl"] is fused.miller_dbl
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
        inputs = (15 if op == "miller_add" else 9)
        assert counts == fused.k5_counts(op)
        assert (counts["comps"], counts["inputs"], counts["fps"], counts["levels"]) == (2, inputs,
                                                                                        3, 3)
        assert [(counts[f"np{i}"], counts[f"nr{i}"]) for i in range(3)] == [
            (len(p), len(r)) for p, r in levels]
        assert counts["warps"] >= inputs                # one input Fp per unit
        body = block[block.index(f"kK6Plan{name}["):]
        got = [int(h, 16) for h in re.findall(r"0x([0-9a-f]{8})u", body[:body.index("};")])]
        assert got == fused.k5_plan_words(op)
        # The point leaves at level 1 (flagged), the line at level 2.
        flagged = [d & 0xFF for d, _, _ in levels[1][1] if d & fused.K5_OUT]
        assert flagged == list(range(6)) and [d for d, _, _ in levels[2][1]] == list(range(6, 12))
        # Level 2: six products, each one Fp by one of P's coordinates.
        assert all(set(y) <= {inputs - 3, inputs - 2, inputs - 1} for _, y in levels[2][0])


def test_level_counts():
    """The products and reductions a level: the doubling's 5 Fp2 products
    (three squares), 8 Fp2 products and 6 Fp products; the addition's K5
    g2_add levels plus the line's 4 and 4 Fp2 products, then 6 Fp
    products."""
    counts = {op: [(len(p), len(r)) for p, r in fused.k5_schedule(op)[1]]
              for op in fused.K6_OPS}
    assert counts["miller_dbl"] == [(12, 10), (24, 14), (6, 6)]
    assert counts["miller_add"] == [(30, 16), (30, 12), (6, 6)]


def test_slots_reuse_what_no_later_level_reads():
    """Level 0's reductions keep T's X and Z and P's coordinates (read by
    levels 1 and 2), level 1's keep P's coordinates only."""
    _, levels = fused.k5_schedule("miller_dbl")
    dests = [[d for d, _, _ in reds if not d & fused.K5_OUT] for _, reds in levels[:2]]
    assert dests[0] == [2, 3] + list(range(9, 17))
    assert dests[1] == [0, 1, 2, 3, 4, 5, 9, 10]


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
        xs = (t, *ps) if op == "miller_dbl" else (t, q, *ps)
        fn = fused.WRAPPERS[op]
        got, want = fn(*xs), fn(*_dense(op, xs))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), name


def _kernel_reads(name, xs):
    """The kernel's view of each operand from the wrapper's arguments: input
    Fp (coordinate c, component k) of operand o, limb l of pair (row, j),
    row = (r1, r0), at r1 s1 + r0 s0 + c sc + k sk + l sl + j sn from its
    pointer; P's coordinates have sc = sk = 0."""
    (out, line), views, args = fused._k6_args(name, xs)
    views = [v if k == "g2" else v[..., None, None, :, :] for v, k in zip(views, fused._KERNELS[name][2])]
    m = len(views)
    ptrs = args[2:2 + m]
    rows, n, geom = args[2 + m:]
    vals = list(geom)
    assert len(vals) == 1 + 6 * m and out.shape == line.shape and out.is_contiguous()
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


@pytest.mark.parametrize("op", fused.K6_OPS)
def test_launch_arguments_address_each_operand(op):
    for name, ((t, q), ps) in _layouts().items():
        xs = (t, *ps) if op == "miller_dbl" else (t, q, *ps)
        out, got = _kernel_reads(op, xs)
        kinds = fused._KERNELS[op][2]
        for x, kind, g in zip(xs, kinds, got):
            want = x if kind == "g2" else x[..., None, None, :, :]
            assert torch.equal(g, want.expand(out.shape)), (name, kind)


# --- The wrappers -------------------------------------------------------------


@pytest.mark.parametrize("op", fused.K6_OPS)
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
