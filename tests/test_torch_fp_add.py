"""Kernel K4, the port's Fp additive layer (ops/fused.py fp_add / fp_sub /
fp_neg / fp_mul_small, one-row plans of csrc/fp_add.cu's linear
combinations: tests/test_torch_fp_lincomb.py), on the CPU.

- The plain versions against the JAX package's batch-minor add / sub / neg
  followed by canonicalize, and against Python integers mod p, with
  tolerance zero, on seeded inputs and on edge values.
- csrc/fp.cuh's modular chains (lh::add_mod, sub_mod, neg_mod, which K5's
  operands of unit coefficients take) replayed in Python integers (32-bit
  carries, the trial subtraction of p and the select, the borrow-masked
  add of p), and mul_small's one-row plan through the kernel's one-pass
  sum, every bound asserted, on every pair of edge values.
- The launch arguments the wrapper hands the kernel (each operand a term,
  two row levels of element strides), replayed as the kernel reads memory.
- The wrapper's checks, and its routing: lb.add and its callers reach it.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lighthouse_tpu.crypto.bls.constants import P
from lighthouse_tpu.ops.bm import limbs as bl
from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch.ops import curves, fused, tower
from lighthouse_tpu_torch.ops import limbs as lb


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's test modules pin torch to one intra-op thread, leaving
    the other cores to other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


MASK = (1 << 32) - 1
P_LIMBS = [(P >> (32 * i)) & MASK for i in range(12)]
X = (1 << 352) - 1                          # limbs 0-10 all ones: a carry through 11 limbs
Y = (P_LIMBS[11] - 1) << 352 | X            # every limb all ones but the top, below p
EDGES = [0, 1, 2, P - 1, P - 2, X, X + 1, Y, Y + 1, (P - 1) // 2, (P + 1) // 2]
EDGE_PAIRS = [(a, b) for a in EDGES for b in EDGES] + [(1, P - 1), (1, P - 2), (P - 1, 1)]
KS = list(range(1, 17)) + [65535]
SHAPES = [(12, 1), (2, 12, 5), (3, 2, 12, 7)]


def _raw(vals, shape=None) -> torch.Tensor:
    """Stored limbs (the Montgomery form, read as raw integers below p) of
    `vals` -> (12, m) int32, or `shape` (..., 12, n) with the elements in
    order, trailing axis fastest."""
    arr = np.array([[(v >> (32 * i)) & MASK for i in range(12)] for v in vals], dtype=np.uint32)
    t = torch.from_numpy(arr.view(np.int32))            # (m, 12)
    if shape is None:
        return t.T.contiguous()
    return t.reshape(shape[:-2] + (shape[-1], 12)).transpose(-1, -2).contiguous()


def _raw_ints(t) -> list:
    """(..., 12, n) limbs -> the stored integers, trailing axis fastest."""
    arr = np.moveaxis(t.numpy().astype("<i4"), -2, -1)
    return [int.from_bytes(r.tobytes(), "little")
            for r in np.ascontiguousarray(arr).reshape(-1, 12)]


def _random(rng, shape):
    """Random stored values below p at `shape`, the edge values first."""
    m = int(np.prod(shape)) // 12
    vals = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(m)]
    vals[:min(m, len(EDGES))] = EDGES[:m]
    return _raw(vals, shape)


def _cases():
    """(name, a, b) operand pairs: each shape of SHAPES at random values,
    a broadcast pair, and every edge pair at (12, len(EDGE_PAIRS))."""
    rng = np.random.default_rng(20261017)
    out = [(f"{shape}", _random(rng, shape), _random(rng, shape)) for shape in SHAPES]
    out.append(("broadcast", _random(rng, (3, 2, 12, 7)), _random(rng, (2, 12, 1))))
    a, b = zip(*EDGE_PAIRS)
    out.append(("edges", _raw(a), _raw(b)))
    return out


CASES = _cases()
CASE_IDS = [name for name, _, _ in CASES]


@pytest.fixture(scope="module")
def jax_results():
    """JAX's bm add / sub / neg, each followed by canonicalize, on every case
    at once: {case: {op: ints}}."""
    def flat(t):
        return convert.to_ints(t)

    cols_a, cols_b, spans = [], [], {}
    for name, a, b in CASES:
        a, b = torch.broadcast_tensors(a, b)
        va, vb = flat(a), flat(b)
        spans[name] = (len(cols_a), len(cols_a) + len(va))
        cols_a += va
        cols_b += vb

    x, y = jnp.asarray(bl.ints_to_bm_np(cols_a)), jnp.asarray(bl.ints_to_bm_np(cols_b))
    canonicalize = jax.jit(bl.canonicalize)              # one compile, three calls
    outs = {"add": bl.add(x, y), "sub": bl.sub(x, y), "neg": bl.neg(x)}
    ints = {op: bl.bm_to_ints(canonicalize(o)) for op, o in outs.items()}
    return {name: {op: v[lo:hi] for op, v in ints.items()} for name, (lo, hi) in spans.items()}


@pytest.mark.parametrize("op", ["add", "sub", "neg"])
@pytest.mark.parametrize("case", CASE_IDS)
def test_plain_matches_bm_and_ints(op, case, jax_results):
    _, a, b = CASES[CASE_IDS.index(case)]
    va, vb = (convert.to_ints(t) for t in torch.broadcast_tensors(a, b))
    if op == "add":
        got, want = fused.fp_add_plain(a, b), [(x + y) % P for x, y in zip(va, vb)]
    elif op == "sub":
        got, want = fused.fp_sub_plain(a, b), [(x - y) % P for x, y in zip(va, vb)]
    else:
        a = torch.broadcast_tensors(a, b)[0]
        got, want = fused.fp_neg_plain(a), [-x % P for x in va]
    assert got.dtype == torch.int32 and got.shape == torch.broadcast_shapes(a.shape, b.shape)
    assert convert.to_ints(got) == jax_results[case][op] == want
    assert all(v < P for v in _raw_ints(got))           # canonical limbs


@pytest.mark.parametrize("k", KS)
def test_plain_mul_small_matches_ints(k):
    a = CASES[-1][1]                                    # every edge value as `a`
    got = fused.fp_mul_small_plain(a, k)
    assert _raw_ints(got) == [k * v % P for v in _raw_ints(a)]


# --- csrc/fp_add.cu replayed ------------------------------------------------


def _limbs(v):
    return [(v >> (32 * i)) & MASK for i in range(12)]


def _value(limbs):
    return sum(v << (32 * i) for i, v in enumerate(limbs))


def add_mod(a, b):
    """add_mod: the sum with a 64-bit carry, then s - p by a signed borrow
    chain (an arithmetic shift), s kept iff that chain borrowed."""
    s, c = [], 0
    for j in range(12):
        c += a[j] + b[j]
        assert c < 1 << 33
        s.append(c & MASK)
        c >>= 32
    assert c == 0                                       # a + b < 2p < 2^382
    d, br = [], 0
    for j in range(12):
        br += s[j] - P_LIMBS[j]
        d.append(br & MASK)
        br >>= 32
    assert br in (0, -1)
    return s if br < 0 else d


def sub_mod(a, b):
    """sub_mod: a - b by a signed borrow chain, then + (p & the borrow's
    mask) with the carry out of limb 11 dropped."""
    d, br = [], 0
    for j in range(12):
        br += a[j] - b[j]
        d.append(br & MASK)
        br >>= 32
    assert br in (0, -1)
    mask = br & MASK
    out, c = [], 0
    for j in range(12):
        c += d[j] + (P_LIMBS[j] & mask)
        out.append(c & MASK)
        c >>= 32
    assert c == (1 if mask else 0)                      # the wrap of a - b + 2^384 + p
    return out


def neg_mod(a):
    """neg_mod: (p & the nonzero mask) - a."""
    mask = MASK if any(a) else 0
    out, br = [], 0
    for j in range(12):
        br += (P_LIMBS[j] & mask) - a[j]
        out.append(br & MASK)
        br >>= 32
    assert br == 0
    return out


def mul_small_mod(a, k):
    """fp_mul_small's one-row plan ((k,),) through csrc/fp_add.cu: the
    plan's word, then fp.cuh sum_mod's one pass on it."""
    from test_torch_fp_lincomb import plan_rows, sum_mod

    assert 1 <= k < 1 << 16
    ((word,),) = plan_rows(((k,),), (1,))
    assert word == (0, 0, k)
    return _limbs(sum_mod([_value(a)], [k]))


def test_replay_add_sub_on_edge_pairs():
    for x, y in EDGE_PAIRS:
        a, b = _limbs(x), _limbs(y)
        assert _value(add_mod(a, b)) == (x + y) % P
        assert _value(sub_mod(a, b)) == (x - y) % P
        assert _value(sub_mod(a, a)) == 0


def test_replay_neg_on_edges():
    for x in EDGES:
        assert _value(neg_mod(_limbs(x))) == -x % P


@pytest.mark.parametrize("k", KS + [3 * 4, 65534, 32768])
def test_replay_mul_small_on_edges(k):
    for x in EDGES:
        assert _value(mul_small_mod(_limbs(x), k)) == k * x % P


def test_kernel_source_constants():
    """p's immediates in fp.cuh (lh::p_limb, which the chains and the
    one-pass sum read), and the range of k the launcher accepts (a plan's
    coefficient)."""
    csrc = Path(fused.__file__).parent / "csrc"
    src = (csrc / "fp_add.cu").read_text()
    header = (csrc / "fp.cuh").read_text()
    body = header[header.index("constexpr uint32_t p_limb"):]
    imms = [int(h, 16) for h in re.findall(r"0x([0-9a-f]{8})u", body[:body.index("}")])]
    assert imms == P_LIMBS
    assert "kMaxCoeff = (1 << 16) - 1;" in src
    assert fused.MUL_SMALL_MAX == 1 << 16 == fused.LINCOMB_MAX_COEFF + 1


# --- The launch arguments, read as the kernel reads memory -------------------


def _kernel_reads(name, xs, k=0):
    """The kernel's view of each input from the wrapper's arguments (one
    term an operand, test_torch_fp_lincomb.kernel_reads), in the output's
    shape; the one-row plan's word is the entry's coefficient."""
    from test_torch_fp_lincomb import kernel_reads, plan_rows

    out, inputs, args = fused._k4_args(name, xs, k)
    ((_, _, c), *rest), = plan_rows(((k,),) if name == "fp_mul_small" else
                                    fused._ONE_ROW[name], (1,) * len(inputs))
    assert c == {"fp_add": 1, "fp_sub": 1, "fp_neg": -1, "fp_mul_small": k}[name]
    assert [w[2] for w in rest] == ([-1] if name == "fp_sub" else [1] if name == "fp_add"
                                    else [])
    out = out.squeeze(-3)
    views = [v.reshape(out.shape) for v in kernel_reads(out.unsqueeze(-3), inputs, args)]
    return out, views


def _layouts():
    g = torch.Generator().manual_seed(7)
    base = torch.randint(-2**31, 2**31, (2, 3, 2, 12, 9), generator=g, dtype=torch.int32)
    other = torch.randint(-2**31, 2**31, (2, 3, 2, 12, 9), generator=g, dtype=torch.int32)
    one = other[0, 0, 0, :, :1]
    return {
        "contiguous": (base, other),
        "fp2 coordinates": (base[..., 0, :, :], other[..., 1, :, :]),
        "middle select": (base[:, 1], other[:, 2]),
        "broadcast (12, 1)": (base, one),
        "broadcast first": (one, base),
        "broadcast lead": (base, other[:1, :, :, :, :1]),
        "column slices": (base[..., 2:7], other[..., 1:6]),
        "three levels": (base[:, ::2], other[:, 1:]),
        "transposed": (base.transpose(0, 1), other.transpose(0, 1)),
    }


@pytest.mark.parametrize("layout", list(_layouts()))
def test_launch_arguments_address_each_operand(layout):
    xs = _layouts()[layout]
    shape = torch.broadcast_shapes(*(x.shape for x in xs))
    for name, ops in (("fp_add", xs), ("fp_neg", xs[:1]), ("fp_mul_small", xs[:1])):
        out, views = _kernel_reads(name, ops, 12)
        want = [x.expand(shape if len(ops) == 2 else x.shape) for x in ops]
        assert len(views) == len(ops)
        for got, ref in zip(views, want):
            assert torch.equal(got, ref)


# --- The wrapper --------------------------------------------------------------


def test_routing():
    assert lb.add is fused.fp_add and lb.sub is fused.fp_sub
    assert lb.neg is fused.fp_neg and lb.mul_small is fused.fp_mul_small
    assert tower.add is fused.fp_add and tower.sub is fused.fp_sub and tower.neg is fused.fp_neg
    assert curves.FP.add is fused.fp_add and curves.FP2.mul_small is fused.fp_mul_small
    assert fused.WRAPPERS["fp_add"] is fused.fp_add and fused.PLAIN["fp_add"] is fused.fp_add_plain


def test_wrapper_checks_and_cpu_counts():
    a = _raw([3, 5])
    fused.reset_launches()
    assert _raw_ints(lb.add(a, a)) == [6, 10]
    assert _raw_ints(lb.sub(a, a[:, :1])) == [0, 2]
    assert _raw_ints(lb.neg(a)) == [P - 3, P - 5]
    assert _raw_ints(lb.mul_small(a, 4)) == [12, 20]
    assert all(v == 0 for v in fused.launches.values())  # the plain versions launch nothing
    with pytest.raises(TypeError):
        lb.add(a.to(torch.int64), a)
    with pytest.raises(TypeError):
        lb.neg(np.zeros((12, 1), dtype=np.int32))
    with pytest.raises(ValueError):
        lb.add(a[:11], a[:11])                           # limb axis is not 12
    with pytest.raises(ValueError):
        lb.sub(a[0], a[0])                               # no limb axis
    meta = torch.empty((12, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="operands on"):
        lb.add(a, meta)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        lb.add(meta, meta)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        lb.neg(meta)
    for k in (0, -1, 1 << 16, 2.0, None):
        with pytest.raises(ValueError):
            lb.mul_small(a, k)
    assert all(v == 0 for v in fused.launches.values())
