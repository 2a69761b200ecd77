"""Batches past 4096 sets in the port (lighthouse_tpu_torch ops/backend.py,
beacon_processor/warming.py) against the JAX package on the CPU: the
prepare stage's chunk width rule, the chunked prepare bit for bit against
the monolithic one (on the scenario of tests/test_ops_bm.py's chunked
test, whose JAX side is not run here: it compiles for minutes), the cap
and the warm grid. The prepare stage runs through the kernels' plain
versions; its outputs are computed once per scenario."""

import functools

import numpy as np
import pytest
import torch

from lighthouse_tpu.beacon_processor import warming as jwarming
from lighthouse_tpu.crypto.bls import api as japi
from lighthouse_tpu.crypto.bls import curves as oc
from lighthouse_tpu.ops import backend as jbackend
from lighthouse_tpu.ops.bm import backend as jbm
from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch.beacon_processor import processor, warming
from lighthouse_tpu_torch.ops import backend
from lighthouse_tpu_torch.ops import curves as cv

CPU = torch.device("cpu")
ENV = "LIGHTHOUSE_TPU_PREP_CHUNK"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain kernel versions run many small ops; one intra-op thread
    is faster for them and leaves the other cores to other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


NS = (1, 64, 2048, 4096, 8192, 16384, 32768, 12288)


@pytest.mark.parametrize("override", [None, "0", "junk", "2048"])
@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
def test_prep_chunk_width_matches_jax(override, n_devices, monkeypatch):
    """JAX's rule at JAX's default width, 4096 (the port's default is
    held by the next test)."""
    if override is None:
        monkeypatch.delenv(ENV, raising=False)
    else:
        monkeypatch.setenv(ENV, override)
    monkeypatch.setattr(backend, "DEFAULT_PREP_CHUNK", jbm.DEFAULT_PREP_CHUNK)
    for n_bucket in NS:
        assert backend.prep_chunk_width(n_bucket, n_devices) == \
            jbm.prep_chunk_width(n_bucket, n_devices), n_bucket


@pytest.mark.parametrize("override", [None, "junk"])
def test_default_is_monolithic(override, monkeypatch):
    """By design the port's default width is 0, where JAX's is 4096: the
    card runs every bucket up to the cap in one pass."""
    if override is None:
        monkeypatch.delenv(ENV, raising=False)
    else:
        monkeypatch.setenv(ENV, override)
    assert backend.DEFAULT_PREP_CHUNK == 0 and jbm.DEFAULT_PREP_CHUNK == 4096
    assert [backend.prep_chunk_width(n, d) for n in NS for d in (1, 4)] == [0] * 2 * len(NS)


@functools.lru_cache(maxsize=None)
def _signed():
    sks = [japi.SecretKey(2000 + i) for i in range(4)]
    sets = []
    for i, m in enumerate((0, 1, 2, 3, 3, 4)):
        msg = bytes([m]) * 32
        keys = [sks[(i + j) % len(sks)] for j in range(2)]
        agg = japi.AggregateSignature.aggregate([sk.sign(msg) for sk in keys])
        sets.append(japi.SignatureSet(signature=japi.Signature.from_bytes(agg.to_bytes()),
                                      signing_keys=[sk.public_key() for sk in keys],
                                      message=msg))
    return tuple(sets)


def _scenario(poison):
    """tests/test_ops_bm.py:163-210: messages 0 1 2 3 3 4, two keys a set,
    so that sets 3 and 4 share message 3 across the chunk boundary of
    chunk 4 in an 8-bucket; poisoned, the straddler (set 4) carries a
    signature over message 0."""
    sets = list(_signed())
    if poison:
        sets[4] = japi.SignatureSet(signature=sets[0].signature,
                                    signing_keys=sets[4].signing_keys, message=sets[4].message)
    return sets


@pytest.fixture(scope="module")
def chunked_runs():
    """Per scenario: the sets, the fixed scalars, the port's staged batch,
    and its prepare outputs monolithic and chunked at 4."""
    scalars = np.arange(3, 3 + 8, dtype=np.uint64)
    runs = {}
    for poison in (False, True):
        jsets = _scenario(poison)
        host, m_bucket, checked = backend.stage_host(
            [convert.from_jax_signature_set(s) for s in jsets], scalars)
        args = backend.to_device(host, CPU)
        u, inv_idx, row_mask, pk, sig, sig_checked, set_mask, sc = args
        outs = {chunk: backend._prepare(pk, sig, sig_checked, set_mask, sc, inv_idx,
                                        m_bucket, checked, chunk) for chunk in (0, 4)}
        runs[poison] = dict(sets=jsets, scalars=[int(r) for r in scalars], args=args,
                            m_bucket=m_bucket, checked=checked, outs=outs)
    return runs


@pytest.mark.parametrize("poison", [False, True])
def test_chunked_prepare_is_bit_exact(chunked_runs, poison):
    """torch.equal outputs, and both equal to the host oracle's sums: each
    message's row sum_i r_i agg_pk_i (message 3's two sets, one on each
    side of the chunk boundary, in one row), the last row -g1, and the
    signature sum sum_i r_i sig_i."""
    run = chunked_runs[poison]
    assert (run["m_bucket"], run["args"][3].shape[-1], run["checked"]) == (8, 8, True)
    mono, chunked = run["outs"][0], run["outs"][4]
    for a, b in zip(mono, chunked):
        assert a.dtype == b.dtype and torch.equal(a, b)
    rows, sig = [None] * 5, None
    for s, r in zip(run["sets"], run["scalars"]):
        m = s.message[0]
        rows[m] = oc.g1_add(rows[m], oc.g1_mul(s.aggregate_pubkey(), r))
        sig = oc.g2_add(sig, oc.g2_mul(s.signature.point, r))
    p_proj, s_proj, valid = mono
    assert cv.to_affine_ints(p_proj[..., [0, 1, 2, 3, 4, 8]], "G1") == rows + [oc.g1_neg(oc.G1_GEN)]
    assert cv.to_affine_ints(s_proj, "G2") == [sig]
    assert bool(valid)


def test_chunk_width_keys_the_prepare_graph(monkeypatch):
    monkeypatch.setenv(ENV, "4096")
    assert backend.graph_core(8192, 4, 128, True, CPU).prepare.name.endswith("chunk=4096")
    assert backend.graph_core(4096, 4, 64, True, CPU).prepare.name.endswith("chunk=0")
    monkeypatch.delenv(ENV)
    mono = backend.graph_core(8192, 4, 128, True, CPU)
    assert mono.prepare.name.endswith("chunk=0")
    assert mono.prepare is not backend.graph_core(8192, 4, 128, True, CPU, 4096).prepare
    assert mono.h2g2 is backend.graph_core(8192, 4, 128, True, CPU, 4096).h2g2


def test_cap_and_grid_match_jax(monkeypatch):
    monkeypatch.delenv(ENV, raising=False)
    assert backend.max_n_bucket() == jbackend.max_n_bucket() == 16384
    assert warming.DEFAULT_SHAPE_GRID == jwarming.DEFAULT_SHAPE_GRID
    assert processor.AdaptiveBatchPolicy().max_bucket == 16384
    host, m_bucket, _ = backend.stage_host(
        [convert.from_jax_signature_set(s) for s in _scenario(False)[:1]] * 8193)
    assert (host[4].shape[-1], m_bucket) == (16384, 64)


def test_warmer_skips_rungs_above_the_cap(monkeypatch):
    """As JAX's warmer skips 8192 and 16384 when its cap is 4096
    (warming.py:270-276): a rung above max_n_bucket is neither warmed nor
    failed, and the batch policy never hears of it."""
    done = []
    monkeypatch.setattr(backend, "max_n_bucket", lambda: 4096)
    monkeypatch.setattr(warming.ShapeWarmer, "warm_one",
                        lambda self, n, k: done.append((n, k)))
    policy = processor.AdaptiveBatchPolicy(max_bucket=16384)
    w = warming.ShapeWarmer(policy=policy, shapes=((4096, 4), (8192, 4), (16384, 4)),
                            device="cpu").start()
    w.join(timeout=10)
    assert not w._thread.is_alive()
    assert done == w.warmed == [(4096, 4)] and not w.failed
    assert policy.batch_limit(1 << 20) == 8192      # twice the largest bucket run
