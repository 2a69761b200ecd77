"""The port's multi-device verify (lighthouse_tpu_torch parallel/mesh.py,
the sharded path of ops/backend.py and of the warmer) against the JAX
package on the CPU: the batch-axis split against JAX's shard_batch_minor
on the 8 virtual CPU devices, the staging floors against JAX's stage_bm,
the lead's stage-2 outputs over 4 "cpu" shards against the unsharded
prepare (as affine points: the cross-shard sums give other projective
coordinates), and sharded verdicts against JAX's oracle. JAX's own sharded
verify is not run here (it compiles for minutes); the stages run through
the kernels' plain versions, each once a module."""

import contextlib
import functools

import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto.bls import api as japi
from lighthouse_tpu.ops import backend as jbackend
from lighthouse_tpu.parallel import mesh as jmesh
from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch.beacon_processor import warming
from lighthouse_tpu_torch.common import metrics
from lighthouse_tpu_torch.crypto.bls import api
from lighthouse_tpu_torch.ops import backend
from lighthouse_tpu_torch.ops import curves as cv
from lighthouse_tpu_torch.parallel import mesh as pm
from lighthouse_tpu_torch.serving.router import CostModelRouter

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain kernel versions run many small ops; one intra-op thread
    is faster for them and leaves the other cores to other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _make_sets(n, keys_per_set, poison_idx=None):
    """tests/test_sharded_bm.py's sets: set i signs bytes([i]) * 32 with
    keys 3000 + 10 i + j; poisoned, its keys signed another message."""
    sets = []
    for i in range(n):
        sks = [japi.SecretKey(3000 + i * 10 + j) for j in range(keys_per_set)]
        msg = bytes([i]) * 32
        signed = b"\xee" * 32 if i == poison_idx else msg
        agg = japi.AggregateSignature.aggregate([sk.sign(signed) for sk in sks])
        sets.append(japi.SignatureSet(signature=japi.Signature(point=agg.point,
                                                               subgroup_checked=True),
                                      signing_keys=[sk.public_key() for sk in sks],
                                      message=msg))
    return tuple(sets)


def _mixed(poison_idx=None):
    """13 sets in a 16-bucket: 7 with 4 keys (messages 0-6), then 6 with
    one (messages 0-5). Over 4 shards of 4 sets, messages 0-5 have sets in
    two shards, and message 6 in shard 1 alone: its row in shards 0, 2 and
    3 has no member and must add nothing."""
    return _make_sets(7, 4, poison_idx) + _make_sets(6, 1)


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_shard_minor_matches_jax_shards(d):
    rng = np.random.default_rng(d)
    mesh = jmesh.get_mesh(d)
    for shape in ((2, 2, 12, 16), (4, 3, 12, 16), (16,)):
        x = rng.integers(-2**31, 2**31, size=shape, dtype=np.int64).astype(np.int32)
        shards = sorted(jmesh.shard_batch_minor(x, mesh).addressable_shards,
                        key=lambda s: s.device.id)
        got = pm.shard_minor(torch.from_numpy(x), pm.get_mesh(devices=["cpu"] * d))
        assert len(got) == len(shards) == d
        for g, s in zip(got, shards):
            assert g.device == CPU and g.is_contiguous()
            assert np.array_equal(g.numpy(), np.asarray(s.data))
    with pytest.raises(AssertionError):
        pm.shard_minor(torch.zeros((3, 6)), pm.get_mesh(devices=["cpu"] * 4))
    x = torch.arange(6).reshape(2, 3)
    copies = pm.replicated(x, pm.get_mesh(devices=["cpu"] * d))
    assert len(copies) == d and all(torch.equal(c, x) for c in copies)


def test_mesh_devices(monkeypatch):
    assert pm.get_mesh(devices=["cpu"] * 4) == (CPU,) * 4
    assert pm.get_mesh(2, devices=["cpu", "meta", "cpu"]) == (CPU, torch.device("meta"))
    with pytest.raises(ValueError):
        pm.get_mesh(3, devices=["cpu"] * 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm.get_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert pm.get_mesh() == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert pm.BATCH_AXIS == jmesh.BATCH_AXIS


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_staging_floors_match_jax(d):
    """n_bucket floored at d and m_bucket at the next power of two >= d, as
    JAX's _verify_bm_impl stages for a mesh of d (stage_bm(m_floor=...))."""
    for jsets in (_mixed(), _make_sets(3, 1)):
        n = len(jsets)
        n_bucket = jbackend._next_pow2(n, floor=d)
        k_bucket = jbackend._next_pow2(max(len(s.signing_keys) for s in jsets))
        scalars = np.arange(1, n_bucket + 1, dtype=np.uint64)
        (ju, jinv, jrow, _, _, jchk, jmask, jsc), jm = jbackend.stage_bm(
            jsets, n, n_bucket, k_bucket, scalars=scalars,
            m_floor=jbackend._next_pow2(d))
        host, m_bucket, _ = backend.stage_host([convert.from_jax_signature_set(s)
                                                for s in jsets], scalars, n_floor=d, m_floor=d)
        u, inv, row, pk, sig, chk, mask, sc = host
        assert (m_bucket, pk.shape, u.shape[-1]) == (jm, (k_bucket, 3, 12, n_bucket), jm)
        assert m_bucket % d == 0 and n_bucket % d == 0
        for mine, theirs in ((inv, jinv), (row, jrow), (chk, jchk), (mask, jmask)):
            assert np.array_equal(mine, np.asarray(theirs))
        assert np.array_equal(sc.view(np.uint64), np.asarray(jsc))


def test_sharded_none_is_one_device_unless_several_cards(monkeypatch):
    assert backend.resolve_mesh() is None                 # no card here
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert backend.resolve_mesh() is None
    assert backend.resolve_mesh(mesh=["cpu"] * 2) == (CPU, CPU)
    assert backend.resolve_mesh(sharded=False, mesh=["cpu"] * 2) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert backend.resolve_mesh() == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert backend.resolve_mesh(device="cpu") is None
    assert backend.resolve_mesh(sharded=True, mesh=["cpu"]) == (CPU,)


@pytest.fixture(scope="module")
def stage2():
    """The mixed batch staged for 4 shards with fixed scalars: the
    unsharded prepare on the whole batch, and each shard's partial prepare
    joined on the lead."""
    mesh = pm.get_mesh(devices=["cpu"] * 4)
    sets = [convert.from_jax_signature_set(s) for s in _mixed()]
    host, m_bucket, checked = backend.stage_host(sets, np.arange(7, 23, dtype=np.uint64),
                                                 n_floor=4, m_floor=4)
    u, inv_idx, row_mask, pk, sig, sig_checked, set_mask, scalars = backend.to_device(host, CPU)
    whole = backend._prepare(pk, sig, sig_checked, set_mask, scalars, inv_idx, m_bucket, checked)
    shards, lead_mask = backend.shard_staged(host, mesh)
    parts = [backend._partial_prepare(*sh[2:], sh[1], m_bucket, checked) for sh in shards]
    return dict(host=host, m_bucket=m_bucket, whole=whole, parts=parts, shards=shards,
                row_mask=row_mask, lead_mask=lead_mask)


def test_sharded_stage2_is_affine_equal(stage2):
    m = stage2["m_bucket"]
    assert m == 16 and torch.equal(stage2["lead_mask"], stage2["row_mask"])
    p_whole, s_whole, valid_whole = stage2["whole"]
    h = [torch.zeros((3, 2, 12, m // 4), dtype=torch.int32)] * 4
    p, h_joined, s, valid = backend._join_shards(
        [(hi, *part) for hi, part in zip(h, stage2["parts"])])
    assert h_joined.shape == (3, 2, 12, m)
    rows = stage2["row_mask"].nonzero().flatten().tolist() + [m]
    assert rows == [0, 1, 2, 3, 4, 5, 6, 16]
    assert cv.to_affine_ints(p[..., rows], "G1") == cv.to_affine_ints(p_whole[..., rows], "G1")
    assert cv.to_affine_ints(s, "G2") == cv.to_affine_ints(s_whole, "G2")
    assert bool(valid) is bool(valid_whole) is True
    # Message 6's sets sit in shard 1 alone: the other shards' row 6 is
    # infinity, and so is every shard's padding row 7.
    for i, (a, _, _) in enumerate(stage2["parts"]):
        row6, row7 = cv.to_affine_ints(a[..., [6, 7]], "G1")
        assert row7 is None and (row6 is not None) == (i == 1)


@contextlib.contextmanager
def memoized_stage1(graph):
    """A stage-1 graph's function (h2g2, a pure function of u) memoized on
    its input while the block runs: batches that hash the same messages
    reuse the first one's h2g2 instead of computing it again through the
    plain versions (1-1.5 s a call on the CPU). Yields the memo."""
    fn, memo = graph.fn, {}

    def memoized(u):
        key = u.numpy().tobytes()
        if key not in memo:
            memo[key] = fn(u)
        return memo[key]

    graph.fn = memoized
    try:
        yield memo
    finally:
        graph.fn = fn


@pytest.fixture(scope="module")
def shard_h2g2():
    """The verdict tests' stage-1 graph (m = 4 over 2 shards: m/d = 2 on
    the CPU), memoized: both batches hash the same messages."""
    graph = backend._stage1_graph(2, CPU)
    with memoized_stage1(graph) as memo:
        yield graph, memo


@pytest.mark.parametrize("poison", [None, 1])
def test_sharded_verdicts_match_oracle(poison, shard_h2g2):
    """Two shards through the API (each shard's stage graphs, the join, the
    lead's stage 3) against JAX's oracle, valid and with set 1 poisoned:
    sets over messages 0 1 0 2, so that message 0 has a set in each shard
    and messages 1 and 2 a row without a member in the other shard."""
    graph, memo = shard_h2g2
    calls = graph.calls
    base = _make_sets(3, 2, poison)
    jsets = [base[0], base[1], base[0], base[2]]
    want = japi.verify_signature_sets(jsets, backend="oracle")
    assert want is (poison is None)
    sets = [convert.from_jax_signature_set(s) for s in jsets]
    assert api.verify_signature_sets(sets, mesh=["cpu"] * 2) is want
    assert graph.calls == calls + 2 and len(memo) == 2      # one call a shard


def test_router_passes_the_mesh_to_the_device_route(monkeypatch):
    seen = []
    monkeypatch.setitem(api._BACKENDS, "fake_mesh",
                        lambda sets, device=None, **opts: seen.append(opts) or True)
    monkeypatch.setitem(api._BACKENDS, "fake_host",
                        lambda sets, device=None: seen.append("host") or True)
    router = CostModelRouter(cpu_backend="fake_host", device_backend="fake_mesh",
                             small_batch_max=1, registry=metrics.Registry(),
                             mesh=["cpu"] * 2)
    assert router.verify(["a", "b"]) == (True, "device")
    assert router.verify(["a"]) == (True, "cpu")
    assert router.find_invalid(["a", "b"], "device") == []
    assert seen == [{"mesh": ["cpu"] * 2}, "host", {"mesh": ["cpu"] * 2}]
    assert CostModelRouter(registry=metrics.Registry()).device_options == {}


def test_sharded_warmer_walks_the_floored_menu(monkeypatch):
    """JAX's _warm_one_bm over a mesh of 4: n floored at 4, every m of the
    menu floored at 4, each key's shards staged and dispatched."""
    keys = []

    class Core:
        graphs = ()

        def __init__(self, *key):
            keys.append(key)

        def __call__(self, shards, row_mask):
            assert len(shards) == 4 and row_mask.shape == (keys[-1][2],)
            assert shards[0][3].shape == (3, 2, 12, keys[-1][0] // 4)
            return True

    monkeypatch.setattr(backend, "sharded_core", Core)
    mesh = pm.get_mesh(devices=["cpu"] * 4)
    w = warming.ShapeWarmer(shapes=((2, 1), (64, 4)), sharded=True, mesh=["cpu"] * 4).start()
    w.join(timeout=30)
    assert not w._thread.is_alive() and w.warmed == [(2, 1), (64, 4)] and not w.failed
    jax_menu = sorted({max(jbackend._m_bucket_for(64, max(1, 64 >> s)), 4)
                       for s in jbackend.M_BUCKET_SHIFTS})
    assert keys == [(4, 1, 4, True, mesh)] + [(64, 4, m, True, mesh) for m in jax_menu]
    assert w.device == CPU and jax_menu == [4, 16, 64]
