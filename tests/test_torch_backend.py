"""The port's batch verification end to end (lighthouse_tpu_torch backend
"gpu", run on the CPU through the kernels' plain versions) against the JAX
package's oracle backend: the same accept/reject verdicts on valid,
poisoned and degenerate batches. Sets are made with the JAX package's API
and cross as wire bytes."""

import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto.bls import api as japi
from lighthouse_tpu.crypto.bls import curves as oc
from lighthouse_tpu.crypto.bls import fields as of
from lighthouse_tpu.crypto.bls.constants import B2
from lighthouse_tpu.ops import backend as jbackend
from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch.crypto.bls import api
from lighthouse_tpu_torch.ops import backend


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain kernel versions run many small ops; one intra-op thread
    is faster for them and leaves the other cores to other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _set(keys, msg, checked=True):
    sks = [japi.SecretKey(k) for k in keys]
    agg = japi.AggregateSignature.aggregate([sk.sign(msg) for sk in sks])
    return japi.SignatureSet(
        signature=japi.Signature(point=agg.point, subgroup_checked=checked),
        signing_keys=[sk.public_key() for sk in sks], message=msg)


@pytest.fixture(scope="module")
def jax_sets():
    m1, m2 = b"\x11" * 32, b"\x22" * 32
    # Sets 0 and 2 share a message; set 1's signature is not yet
    # subgroup-checked, so the device checks it.
    return [_set([101, 102], m1), _set([103], m2, checked=False), _set([104, 105], m1)]


def _port(sets):
    return [convert.from_jax_signature_set(s) for s in sets]


@pytest.fixture(scope="module")
def bucket():
    """The bucket graphs that both batches below reach: 3 sets (n_bucket
    4) of at most 2 keys over 2 messages (m_bucket 4), one signature
    unchecked."""
    return backend.graph_core(4, 2, 4, False, torch.device("cpu"))


def test_valid_batch_matches_oracle(jax_sets, bucket):
    calls = bucket.prepare.calls
    assert japi.verify_signature_sets(jax_sets, backend="oracle") is True
    assert api.verify_signature_sets(_port(jax_sets), device="cpu") is True
    assert bucket.prepare.calls == calls + 1


def test_poisoned_shared_message_batch_matches_oracle(jax_sets, bucket):
    # Set 2 carries set 0's signature: same message, wrong keys.
    bad = list(jax_sets)
    bad[2] = japi.SignatureSet(jax_sets[0].signature, jax_sets[2].signing_keys,
                               jax_sets[2].message)
    calls, scalars = bucket.prepare.calls, bucket.prepare.inputs[4].clone()
    # The stage-1 and stage-3 graphs are shared per m with other buckets
    # (a sharded verify runs the m = 4 pairing graph beside a narrower
    # h2g2), so their counts are compared as increments.
    h2g2_calls, pairing_calls = bucket.h2g2.calls, bucket.pairing.calls
    assert japi.verify_signature_sets(bad, backend="oracle") is False
    assert api.verify_signature_sets(_port(bad), device="cpu") is False
    # The valid batch's bucket, with this batch's own scalars in its inputs
    # (3 fresh nonzero draws, then the padding's 1).
    assert backend.graph_core(4, 2, 4, False, torch.device("cpu")) is bucket
    assert bucket.prepare.calls == calls + 1
    assert bucket.h2g2.calls == h2g2_calls + 1 and bucket.pairing.calls == pairing_calls + 1
    fresh = bucket.prepare.inputs[4]
    assert not torch.equal(fresh, scalars)
    assert fresh[3] == 1 and bool((fresh[:3] != 0).all())


def _off_subgroup_signature():
    for i in range(1, 100):
        x = (i, 1)
        y = of.fp2_sqrt(of.fp2_add(of.fp2_mul(of.fp2_sqr(x), x), B2))
        if y is not None and not oc.g2_in_subgroup((x, y)):
            return japi.Signature(point=(x, y), subgroup_checked=False)
    raise AssertionError("no off-subgroup point found")


def test_find_invalid_sets_names_unchecked_off_subgroup_signature(jax_sets):
    """An unchecked signature outside G2: rejected by the oracle and by the
    port, and bisection names it."""
    culprit = japi.SignatureSet(_off_subgroup_signature(), jax_sets[1].signing_keys,
                                jax_sets[1].message)
    assert japi.verify_signature_sets([culprit], backend="oracle") is False
    assert api.find_invalid_sets(_port([jax_sets[0], culprit]), device="cpu") == [1]


def test_degenerate_batches_early_out(jax_sets):
    port = _port(jax_sets)
    no_keys = api.SignatureSet(port[0].signature, [], port[0].message)
    inf_sig = api.SignatureSet(api.Signature.infinity(), port[0].signing_keys,
                               port[0].message)
    assert api.verify_signature_sets([], device="cpu") is False
    assert api.verify_signature_sets([port[0], no_keys], device="cpu") is False
    assert api.verify_signature_sets([inf_sig, port[1]], device="cpu") is False
    j_inf = japi.SignatureSet(japi.Signature.infinity(), jax_sets[0].signing_keys,
                              jax_sets[0].message)
    assert japi.verify_signature_sets([j_inf], backend="oracle") is False
    assert japi.verify_signature_sets([], backend="oracle") is False


def test_staging_matches_jax_buckets(jax_sets):
    assert backend.M_BUCKET_SHIFTS == jbackend.M_BUCKET_SHIFTS
    for n in (1, 4, 64, 4096):
        for uniq in sorted({1, max(1, n // 64), n // 4 or 1, n}):
            assert backend._m_bucket_for(n, uniq) == jbackend._m_bucket_for(n, uniq)
    port = _port(jax_sets)
    scalars = np.array([3, 5, 7, 1], dtype=np.uint64)
    args, m_bucket, all_checked = backend.stage(port, "cpu", scalars=scalars)
    u, inv_idx, row_mask, pk, sig, sig_checked, set_mask, k = args
    assert m_bucket == 4 and not all_checked
    assert inv_idx.tolist() == [0, 1, 0, 0] and row_mask.tolist() == [True, True, False, False]
    assert tuple(pk.shape) == (2, 3, 12, 4) and tuple(sig.shape) == (3, 2, 12, 4)
    assert sig_checked.tolist() == [True, False, True, True]
    assert set_mask.tolist() == [True, True, True, False]
    assert k.tolist() == [3, 5, 7, 1]


def test_entry_point_defaults_to_the_card(jax_sets, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.verify_signature_sets(_port(jax_sets[:1]))
