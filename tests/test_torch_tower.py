"""The port's tower (lighthouse_tpu_torch.ops.tower; kernels K2 and K3
through their plain versions on the CPU) against the JAX package's towers
and the pure-Python oracle, as integers mod p with tolerance zero."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lighthouse_tpu.crypto.bls import fields as of
from lighthouse_tpu.crypto.bls.constants import P
from lighthouse_tpu.ops import fused as jfused
from lighthouse_tpu.ops import limbs as ml
from lighthouse_tpu.ops import tower as mt
from lighthouse_tpu.ops.bm import limbs as bl
from lighthouse_tpu.ops.bm import tower as bt
from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch.ops import fused
from lighthouse_tpu_torch.ops import tower as tt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain kernel versions run many small ops; one intra-op thread
    is faster for them and leaves the other cores to other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

N = 3


def _rand_ints(rng, count):
    return [int.from_bytes(rng.bytes(48), "little") % P for _ in range(count)]


def _bm_digits(rng, lead, n=N, fill=None):
    """Canonical digits (*lead, 48, n) of random (or `fill`) values."""
    count = int(np.prod(lead)) * n
    ints = [fill] * count if fill is not None else _rand_ints(rng, count)
    d = bl.ints_to_bm_np(ints)                          # (48, count)
    return np.moveaxis(d.reshape(48, *lead, n), 0, -2).copy()


def _major_to_port_order(ints, n, tail):
    """Flat ints of a (n, *tail) JAX array -> the port's (*tail, n) order."""
    return np.asarray(ints, dtype=object).reshape(n, -1).T.reshape(-1).tolist()


@pytest.mark.parametrize("op", ["mul", "sqr"])
def test_fp2_matches_major_tower(op):
    rng = np.random.default_rng(21)
    a = np.moveaxis(_bm_digits(rng, (2,), n=5), -1, 0).copy()      # (n, 2, 48)
    b = np.moveaxis(_bm_digits(rng, (2,), n=5), -1, 0).copy()
    ta, tb = convert.from_jax_limbs(a, "major"), convert.from_jax_limbs(b, "major")
    if op == "mul":
        ref = jax.jit(mt.fp2_mul)(jnp.asarray(a), jnp.asarray(b))
        got = tt.fp2_mul(ta, tb)
    else:
        ref = jax.jit(mt.fp2_sqr)(jnp.asarray(a))
        got = tt.fp2_sqr(ta)
    assert convert.to_ints(got) == _major_to_port_order(ml.mont_to_ints(ref), 5, (2,))


@pytest.mark.parametrize("kind", ["sqr", "mul", "line"])
def test_fp12_matches_bm_tower(kind):
    rng = np.random.default_rng(22)
    a = _bm_digits(rng, (2, 3, 2))
    ta = convert.from_jax_limbs(a)
    if kind == "sqr":
        ref = jax.jit(bt.fp12_sqr)(jnp.asarray(a))
        got = tt.fp12_sqr(ta)
    elif kind == "mul":
        b = _bm_digits(rng, (2, 3, 2))
        ref = jax.jit(bt.fp12_mul)(jnp.asarray(a), jnp.asarray(b))
        got = tt.fp12_mul(ta, convert.from_jax_limbs(b))
    else:
        ls = [_bm_digits(rng, (2,)) for _ in range(3)]
        ref = jax.jit(bt.fp12_mul_sparse_line)(jnp.asarray(a), *map(jnp.asarray, ls))
        got = tt.fp12_mul_sparse_line(ta, *map(convert.from_jax_limbs, ls))
    assert convert.to_ints(got) == bl.bm_to_ints(ref)


def test_fp12_sqr_matches_pallas_interpret():
    """The JAX whole-op kernel fused.fp12_op("sqr") through the Pallas
    interpreter."""
    rng = np.random.default_rng(23)
    a = np.moveaxis(_bm_digits(rng, (2, 3, 2)), -1, 0).copy()     # (n, 2, 3, 2, 48)
    prev = jfused._MODE
    jfused._MODE = "interpret"
    try:
        ref = jfused.fp12_op("sqr", jnp.asarray(a))
    finally:
        jfused._MODE = prev
    got = tt.fp12_sqr(convert.from_jax_limbs(a, "major"))
    assert convert.to_ints(got) == _major_to_port_order(ml.mont_to_ints(ref), N, (2, 3, 2))


def _oracle12(rng, n=N):
    return [tuple(tuple((a, b) for a, b in zip(*[iter(_rand_ints(rng, 6))] * 2))
                  for _ in range(2)) for _ in range(n)]


def test_fp12_inv_frob_match_oracle():
    rng = np.random.default_rng(24)
    vals = _oracle12(rng)
    t = convert.fp12_from_tuples(vals)
    assert convert.fp12_to_tuples(tt.fp12_inv(t)) == [of.fp12_inv(v) for v in vals]
    assert convert.fp12_to_tuples(tt.fp12_frob(t)) == [of.fp12_frob(v) for v in vals]
    assert convert.fp12_to_tuples(tt.fp12_frob_n(t, 3)) == [of.fp12_frob_n(v, 3) for v in vals]
    assert convert.fp12_to_tuples(tt.fp12_conj(t)) == [of.fp12_conj(v) for v in vals]
    assert tt.fp12_is_one(convert.fp12_from_tuples([of.FP12_ONE, vals[0]])).tolist() == [True, False]


def test_k2_bound_all_p_minus_1():
    """K2's accumulator bound (csrc/fp2_mul.cu): offset p^2 plus two
    products, minus one, of canonical inputs. All inputs at p - 1 (the
    loosest input the tower feeds: every port value is canonical) and a
    zero imaginary part."""
    edge = [(P - 1, P - 1), (0, P - 1), (P - 1, 0), (1, P - 1)]
    a = tt.fp2_from_int_pairs(edge, "cpu")
    b = tt.fp2_from_int_pairs([(P - 1, P - 1)] * 4, "cpu")

    def ints(t):
        flat = convert.to_ints(t)
        return list(zip(flat[:4], flat[4:]))

    assert ints(tt.fp2_mul(a, b)) == [of.fp2_mul(x, (P - 1, P - 1)) for x in edge]
    assert ints(tt.fp2_sqr(a)) == [of.fp2_sqr(x) for x in edge]
    # The lazy tables never exceed the kernels' stated budgets.
    assert max(sum(1 for _, d in fused._K2_TABLE.pos if d == acc) for acc in (0, 1)) <= 2
    assert max(sum(1 for _, d in fused._K2_TABLE.neg if d == acc) for acc in (0, 1)) <= 1


@pytest.mark.parametrize("kind", ["sqr", "mul", "line"])
def test_k3_bound_all_p_minus_1(kind):
    """K3's accumulator bound (csrc/fp12_op.cu): 16 p^2 plus at most 17
    products, minus at most 16, all inputs at p - 1."""
    full = tuple(tuple((P - 1, P - 1) for _ in range(3)) for _ in range(2))
    t = convert.fp12_from_tuples([full, full])
    z = (0, 0)
    line = ((full[0][0], z, z), (z, full[1][1], full[1][2]))
    if kind == "sqr":
        got, want = tt.fp12_sqr(t), of.fp12_sqr(full)
    elif kind == "mul":
        got, want = tt.fp12_mul(t, t), of.fp12_mul(full, full)
    else:
        l0 = tt.fp2_from_int_pairs([(P - 1, P - 1)] * 2, "cpu")
        got, want = tt.fp12_mul_sparse_line(t, l0, l0, l0), of.fp12_mul(full, line)
    assert convert.fp12_to_tuples(got) == [want, want]
    table = fused._K3_TABLES[kind]
    for lst, cap in ((table.pos, 17), (table.neg, 16)):
        assert max(sum(1 for _, d in lst if d == acc) for acc in range(12)) <= cap
