"""The port's multi-pairing (lighthouse_tpu_torch.ops.pairing, kernel K3
through its plain version on the CPU) against the oracle pairing of the JAX
package: both final-exponentiated, so the Fp12 values are unique and are
compared exactly."""

import pytest
import torch

from lighthouse_tpu.crypto.bls import curves as oc
from lighthouse_tpu.crypto.bls import fields as of
from lighthouse_tpu.crypto.bls import pairing as opr
from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch.ops import curves as tc
from lighthouse_tpu_torch.ops import limbs as tl
from lighthouse_tpu_torch.ops import pairing as tp
from lighthouse_tpu_torch.ops import tower as tt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain kernel versions run many small ops; one intra-op thread
    is faster for them and leaves the other cores to other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_multi_pairing_product_matches_oracle():
    ps = [oc.g1_mul(oc.G1_GEN, k) for k in (2, 3, 5)]
    qs = [oc.g2_mul(oc.G2_GEN, k) for k in (7, 11, 13)]
    p = tc.g1_from_affine(ps, "cpu")
    q = tc.g2_from_affine(qs, "cpu")
    # Rescale the first P projectively (X : Y : Z) -> (5X : 5Y : 5Z): the
    # homogenized lines must not see the factor after the final exponentiation.
    five = tl.ints_to_limbs([5], "cpu")
    p[:, :, :1] = tl.mul(p[:, :, :1], five)
    mask = torch.tensor([True, False, True])             # the middle pair is masked
    prod = tp.multi_pairing_product_proj(p, q, mask)
    want = of.fp12_mul(opr.pairing(ps[0], qs[0]), opr.pairing(ps[2], qs[2]))
    assert convert.fp12_to_tuples(prod) == [want]
    assert tt.fp12_is_one(prod).tolist() == [False]
