"""The port's G1/G2 layer and hash to G2 (lighthouse_tpu_torch.ops.curves,
ops.h2c) against the JAX batch-minor curves and the pure-Python oracle:
projective coordinates compared as integers mod p (both sides run the same
complete formulas), affine points compared with the oracle."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lighthouse_tpu.crypto.bls import curves as oc
from lighthouse_tpu.crypto.bls import fields as of
from lighthouse_tpu.crypto.bls import hash_to_curve as oh2c
from lighthouse_tpu.crypto.bls.constants import B2
from lighthouse_tpu.ops.bm import curves as bc
from lighthouse_tpu.ops.bm import limbs as bl
from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch.ops import curves as tc
from lighthouse_tpu_torch.ops import h2c as th2c


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain kernel versions run many small ops; one intra-op thread
    is faster for them and leaves the other cores to other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

# Points: multiples of the generators, infinity, and a repeat (so add sees P + P).
G1_PTS = [oc.g1_mul(oc.G1_GEN, k) for k in (3, 5, 7)] + [None]
G2_PTS = [oc.g2_mul(oc.G2_GEN, k) for k in (3, 5, 7)] + [None]


def _pair(group):
    if group == "G1":
        p, q = G1_PTS, [G1_PTS[0], G1_PTS[1], None, G1_PTS[2]]
        jfrom, tfrom = bc.g1_from_affine_np, tc.g1_from_affine
    else:
        p, q = G2_PTS, [G2_PTS[0], G2_PTS[1], None, G2_PTS[2]]
        jfrom, tfrom = bc.g2_from_affine_np, tc.g2_from_affine
    return (jnp.asarray(jfrom(p)), jnp.asarray(jfrom(q)),
            tfrom(p, "cpu"), tfrom(q, "cpu"))


@pytest.mark.parametrize("group", ["G1", "G2"])
def test_add_double_match_bm_curves(group):
    jp, jq, tp, tq = _pair(group)
    jg, tg = getattr(bc, group), getattr(tc, group)
    assert convert.to_ints(tg.add(tp, tq)) == bl.bm_to_ints(jax.jit(jg.add)(jp, jq))
    assert convert.to_ints(tg.double(tp)) == bl.bm_to_ints(jax.jit(jg.double)(jp))
    # P + P through the complete add equals the doubling, affinely.
    pts = G1_PTS if group == "G1" else G2_PTS
    dbl = oc.g1_add if group == "G1" else oc.g2_add
    assert tc.to_affine_ints(tg.add(tp, tp), group) == [dbl(x, x) for x in pts]
    assert tg.is_infinity(tp).tolist() == [False, False, False, True]


@pytest.mark.parametrize("group", ["G1", "G2"])
def test_mul_var_scalar_matches_bm_curves(group):
    jp, _, tp, _ = _pair(group)
    ks = np.array([0, 1, 2**64 - 1, 0xD201000000010000], dtype=np.uint64)
    jg, tg = getattr(bc, group), getattr(tc, group)
    ref = jax.jit(jg.mul_var_scalar)(jp, jnp.asarray(ks))
    got = tg.mul_var_scalar(tp, torch.from_numpy(ks.view(np.int64)))
    assert convert.to_ints(got) == bl.bm_to_ints(ref)


def _off_subgroup_g2():
    """A point on E2 outside G2: the first x = (i, 1) with a square
    x^3 + 4(1 + u)."""
    for i in range(1, 100):
        x = (i, 1)
        y = of.fp2_sqrt(of.fp2_add(of.fp2_mul(of.fp2_sqr(x), x), B2))
        if y is not None and not oc.g2_in_subgroup((x, y)):
            return (x, y)
    raise AssertionError("no off-subgroup point found")


def test_g2_in_subgroup():
    pts = [G2_PTS[1], _off_subgroup_g2()]
    t = tc.g2_from_affine(pts, "cpu")
    assert tc.g2_in_subgroup(t).tolist() == [True, False]
    assert tc.G2.on_curve(t).tolist() == [True, True]


def test_hash_to_g2_matches_oracle():
    msgs = [b"", b"\x5a" * 32]
    got = tc.to_affine_ints(th2c.hash_to_g2(msgs, device="cpu"), "G2")
    assert got == [oh2c.hash_to_g2(m) for m in msgs]
