"""The port's Fp layer (lighthouse_tpu_torch.ops.limbs, kernel K1 through
its plain version on the CPU) against the JAX package's Fp layers on the
same numpy digits, compared as integers mod p with tolerance zero."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lighthouse_tpu.crypto.bls.constants import P
from lighthouse_tpu.ops import fused as jfused
from lighthouse_tpu.ops import limbs as ml
from lighthouse_tpu.ops.bm import limbs as bl
from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch.ops import fused
from lighthouse_tpu_torch.ops import limbs as tl


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain kernel versions run many small ops; one intra-op thread
    is faster for them and leaves the other cores to other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

N = 8


def _digits_bm(rng, n=N, lazy=True):
    """(48, n) f32 digits: canonical values, p - 1, zero, and lazy signed
    digits at the contract edge |digit| <= 2^20 (value well inside
    |v| < 2^392)."""
    d = np.zeros((48, n), dtype=np.float32)
    for i in range(n):
        if i == 0:
            v = P - 1
            d[:, i] = [(v >> (8 * k)) & 255 for k in range(48)]
        elif i == 1:
            pass                                         # zero
        elif lazy and i % 2 == 0:
            d[:44, i] = rng.integers(-2**20, 2**20 + 1, size=44)
            d[0, i] = 2**20 if i % 4 == 0 else -2**20
        else:
            v = int(rng.integers(0, 2**62)) ** 6 % P
            d[:, i] = [(v >> (8 * k)) & 255 for k in range(48)]
    return d


def _ints(d):
    return convert._digits_to_ints(np.moveaxis(d, -2, -1).reshape(-1, 48))


@pytest.mark.parametrize("op", ["mul", "sqr"])
def test_mul_sqr_match_bm_limbs(op):
    rng = np.random.default_rng(11)
    a, b = _digits_bm(rng), _digits_bm(rng)
    ta, tb = convert.from_jax_limbs(a), convert.from_jax_limbs(b)
    if op == "mul":
        ref = bl.bm_to_ints(jax.jit(bl.mul)(jnp.asarray(a), jnp.asarray(b)))
        got = convert.to_ints(tl.mul(ta, tb))
        want = [x * y % P for x, y in zip(_ints(a), _ints(b))]
    else:
        ref = bl.bm_to_ints(jax.jit(bl.sqr)(jnp.asarray(a)))
        got = convert.to_ints(tl.sqr(ta))
        want = [x * x % P for x in _ints(a)]
    assert got == ref == want


def test_mul_matches_major_limbs():
    rng = np.random.default_rng(12)
    a = np.ascontiguousarray(_digits_bm(rng).T)             # (n, 48) batch-major
    b = np.ascontiguousarray(_digits_bm(rng).T)
    ref = ml.mont_to_ints(jax.jit(ml.mul)(jnp.asarray(a), jnp.asarray(b)))
    got = convert.to_ints(tl.mul(convert.from_jax_limbs(a, "major"),
                                 convert.from_jax_limbs(b, "major")))
    assert got == ref


def test_mul_matches_pallas_interpret():
    """The JAX product through the Pallas kernels squeeze_fwd / inv_out,
    run by the Pallas interpreter, on lazy signed digits."""
    rng = np.random.default_rng(13)
    a = np.ascontiguousarray(_digits_bm(rng).T)
    b = np.ascontiguousarray(_digits_bm(rng).T)
    prev = jfused._MODE
    jfused._MODE = "interpret"
    try:
        ref = ml.mont_to_ints(jax.jit(lambda x, y: ml.mul(x, y))(jnp.asarray(a), jnp.asarray(b)))
    finally:
        jfused._MODE = prev
    got = convert.to_ints(tl.mul(convert.from_jax_limbs(a, "major"),
                                 convert.from_jax_limbs(b, "major")))
    assert got == ref


def test_add_sub_neg_canonicalize_match_bm():
    rng = np.random.default_rng(14)
    a, b = _digits_bm(rng, lazy=False), _digits_bm(rng, lazy=False)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = convert.from_jax_limbs(a), convert.from_jax_limbs(b)
    assert convert.to_ints(tl.add(ta, tb)) == bl.bm_to_ints(bl.add(ja, jb))
    assert convert.to_ints(tl.sub(ta, tb)) == bl.bm_to_ints(bl.sub(ja, jb))
    assert convert.to_ints(tl.neg(ta)) == bl.bm_to_ints(bl.neg(ja))
    # canonicalize returns the value's own digits in [0, p): read the
    # port's limbs as a plain integer, not a Montgomery form.
    canon = jax.jit(bl.canonicalize)(jnp.asarray(_digits_bm(rng)))
    raw = tl.canonicalize(convert.from_jax_limbs(np.asarray(canon)))
    raw_ints = [int.from_bytes(r.tobytes(), "little")
                for r in np.ascontiguousarray(raw.numpy().T).astype("<i4")]
    assert raw_ints == [sum(int(d) << (8 * k) for k, d in enumerate(col))
                        for col in np.asarray(canon).T]
    assert all(0 <= v < P for v in raw_ints)


def test_inv_matches_bm_limbs():
    rng = np.random.default_rng(15)
    a = _digits_bm(rng, n=4, lazy=False)
    a[:, 1] = 0
    a[0, 1] = 3                                          # a nonzero small value
    ref = bl.bm_to_ints(jax.jit(bl.inv)(jnp.asarray(a)))
    got = convert.to_ints(tl.inv(convert.from_jax_limbs(a)))
    assert got == ref == [pow(x, P - 2, P) for x in _ints(a)]


def test_eq_is_zero_select_tree_reduce():
    xs = [0, 1, P - 1, 5, 5, 7]
    t = tl.ints_to_limbs(xs, "cpu")
    u = tl.ints_to_limbs([0, 2, P - 1, 5, 6, 7], "cpu")
    assert tl.is_zero(t).tolist() == [True] + [False] * 5
    assert tl.eq(t, u).tolist() == [True, False, True, True, False, True]
    mask = torch.tensor([True, False] * 3)
    assert convert.to_ints(tl.select(mask, t, u)) == [0, 2, P - 1, 5, 5, 7]
    total = tl.tree_reduce_minor(t, tl.add, tl.zero("cpu"), 6)
    assert convert.to_ints(total) == [sum(xs) % P]
    stacked = torch.stack([t[:, i:i + 1] for i in range(1, 6)])   # (5, 12, 1)
    prod = tl.tree_reduce(stacked, tl.mul, tl.one("cpu"), 5)
    assert convert.to_ints(prod) == [(P - 1) * 5 * 5 * 7 % P]
    assert convert.to_ints(tl.mul_small(t, 12)) == [x * 12 % P for x in xs]
    assert convert.to_ints(tl.pow_fixed(t, 2**70 + 3)) == [pow(x, 2**70 + 3, P) for x in xs]


def test_wrapper_checks_operands():
    a = tl.ints_to_limbs([1, 2], "cpu")
    with pytest.raises(TypeError):
        fused.fp_mul(a.to(torch.int64), a)
    with pytest.raises(ValueError):
        fused.fp_mul(a, tl.ints_to_limbs([1, 2, 3], "cpu"))
    with pytest.raises(ValueError):
        fused.fp2_mul(a, a)
    with pytest.raises(ValueError):
        fused.fp_mul(a.T.contiguous().T, a)              # not contiguous
    with pytest.raises(ValueError):
        fused.fp_mul(a.to("meta"), a.to("meta"))         # no kernel there
    before = dict(fused.launches)
    fused.fp_mul(a, a)
    assert fused.launches == before                      # the plain path launches nothing
