"""The port's bucket graphs (lighthouse_tpu_torch ops/graphs.py, the graph
builders of ops/backend.py and ops/kzg.py) and its shape warmer
(beacon_processor/warming.py) on the CPU, where a StaticGraph runs its
function on its static inputs uncaptured: the warm grid and m menu against
the JAX warmer's, the static inputs' copy-in, the builders' caching and
sharing, and their per-key lock. No test here runs a pairing: the chain
runs end to end in tests/test_torch_backend.py."""

import sys
import threading
import time

import pytest
import torch

from lighthouse_tpu.beacon_processor import warming as jwarming
from lighthouse_tpu.ops.backend import M_BUCKET_SHIFTS, _m_bucket_for, _next_pow2
from lighthouse_tpu_torch.beacon_processor import warming
from lighthouse_tpu_torch.ops import backend, graphs
from lighthouse_tpu_torch.ops import curves as cv
from lighthouse_tpu_torch.ops import kzg as okzg

CPU = torch.device("cpu")


def _jax_menu(n_bucket):
    """The m buckets lighthouse_tpu's _warm_one_bm walks on one device."""
    m_low = _next_pow2(1)
    return sorted({max(_m_bucket_for(n_bucket, max(1, n_bucket >> s)), m_low)
                   for s in M_BUCKET_SHIFTS})


def test_warm_grid_and_menu_match_jax():
    jax_grid = jwarming.DEFAULT_SHAPE_GRID
    assert warming.DEFAULT_SHAPE_GRID == jax_grid
    assert max(n for n, _ in jax_grid) == 16384 == backend.max_n_bucket()
    for n, _ in jax_grid:
        assert warming.m_menu(n) == _jax_menu(n)
    prepare = [(n, k, m) for n, k in jax_grid for m in warming.m_menu(n)]
    stages = {m for _, _, m in prepare}
    assert (len(prepare), len(stages)) == (53, 14)
    assert stages == {1, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384}


def _stub(x, mask):
    return x * 2, mask.sum()


def _stub_graph():
    return graphs.StaticGraph(_stub, [((2, 5), torch.int64), ((5,), torch.bool)], CPU, "stub")


def test_copy_in_overwrites_every_position():
    g = _stub_graph()
    big = torch.arange(1, 11).reshape(2, 5)
    out, count = g(big, torch.ones(5, dtype=torch.bool))
    assert torch.equal(out, big * 2) and int(count) == 5
    # A smaller batch in the same bucket: two live columns, the rest padding.
    small = torch.zeros((2, 5), dtype=torch.int64)
    small[:, :2] = torch.tensor([[7, 8], [9, 10]])
    mask = torch.tensor([True, True, False, False, False])
    out, count = g(small, mask)
    assert torch.equal(g.inputs[0], small) and torch.equal(g.inputs[1], mask)
    assert torch.equal(out, small * 2) and int(count) == 2
    assert g.calls == 2 and g.graph is None and g.stats is None


@pytest.mark.parametrize("bad", [
    (torch.zeros((2, 4), dtype=torch.int64), torch.ones(5, dtype=torch.bool)),
    (torch.zeros((2, 5), dtype=torch.int32), torch.ones(5, dtype=torch.bool)),
    (torch.zeros((2, 5), dtype=torch.int64), torch.ones(5, dtype=torch.int64)),
    (torch.zeros((2, 5), dtype=torch.int64), [True] * 5),
])
def test_wrong_input_raises_and_copies_nothing(bad):
    g = _stub_graph()
    good = (torch.arange(10).reshape(2, 5), torch.ones(5, dtype=torch.bool))
    g(*good)
    with pytest.raises(ValueError, match="stub: input"):
        g(*bad)
    with pytest.raises(TypeError, match="1 arguments for 2 inputs"):
        g(good[0])
    assert torch.equal(g.inputs[0], good[0]) and g.calls == 1


def test_builders_cache_and_share():
    core = backend.graph_core(64, 1, 4, True, CPU)
    assert backend.graph_core(64, 1, 4, True, CPU) is core
    assert core.graphs == (core.h2g2, core.prepare, core.pairing)
    other_m = backend.graph_core(64, 1, 16, True, CPU)
    assert other_m.prepare is not core.prepare and other_m.h2g2 is not core.h2g2
    assert other_m.lock is not core.lock
    # Stage 1 and 3 are per m, shared across (n, k); stage 2 is per key.
    other_nk = backend.graph_core(256, 4, 4, True, CPU)
    assert other_nk.h2g2 is core.h2g2 and other_nk.pairing is core.pairing
    assert other_nk.prepare is not core.prepare
    assert backend.graph_core(64, 1, 4, False, CPU).prepare is not core.prepare
    assert core.lock is core.prepare.lock is core.pairing.lock is other_nk.lock
    assert [tuple(x.shape) for x in core.pairing.inputs] == [
        (3, 12, 5), (3, 2, 12, 4), (3, 2, 12, 1), (4,), ()]
    assert [tuple(x.shape) for x in core.prepare.inputs] == [
        (1, 3, 12, 64), (3, 2, 12, 64), (64,), (64,), (64,), (64,)]
    assert okzg._graphed(8, 256, CPU) is okzg._graphed(8, 256, CPU)
    assert okzg._graphed(8, 256, CPU) is not okzg._graphed(8, 64, CPU)


def test_one_build_per_key_across_threads():
    """Threads asking for one key at once build it once and share it; a
    second key builds on its own."""
    built = []

    @graphs.cached
    def build(key):
        built.append(key)
        time.sleep(0.02)
        return object()

    got = []
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=lambda i=i: got.append((i % 2, build(i % 2))))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    assert sorted(built) == [0, 1] and len(got) == 16
    for key in (0, 1):
        assert len({id(obj) for k, obj in got if k == key}) == 1


def test_cuda_without_index_is_the_current_device(monkeypatch):
    """The warmer names the card "cuda", staged tensors "cuda:0": one key."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    built = []

    @graphs.cached
    def build(m, device):
        built.append(device)
        return object()

    assert build(4, torch.device("cuda")) is build(4, torch.device("cuda", 0))
    assert built == [torch.device("cuda", 0)]
    assert build(4, CPU) is not build(4, torch.device("cuda"))


def test_warmer_records_failures_and_goes_on(monkeypatch):
    done = []

    def warm_one(self, n_bucket, k_bucket):
        if n_bucket == 256:
            raise RuntimeError("capture failed")
        done.append((n_bucket, k_bucket))

    monkeypatch.setattr(warming.ShapeWarmer, "warm_one", warm_one)
    w = warming.ShapeWarmer(shapes=((64, 1), (256, 1), (1024, 4)), device="cpu").start()
    w.join(timeout=10)
    assert w._thread is not None and not w._thread.is_alive()
    assert w.warmed == done == [(64, 1), (1024, 4)]
    assert [rung for rung, _ in w.failed] == [(256, 1)]
    assert "capture failed" in w.failed[0][1]
    w.stop()


def test_warmer_synthetic_batch_is_all_padding():
    u, inv_idx, row_mask, pk, sig, sig_checked, set_mask, scalars = warming.synthetic_batch(
        8, 2, 4, "cpu")
    assert torch.equal(pk, cv.G1.infinity(CPU).expand(2, 3, 12, 8))
    assert torch.equal(sig, cv.G2.infinity(CPU).expand(3, 2, 12, 8))
    assert not u.any() and not row_mask.any() and not set_mask.any()
    assert sig_checked.all() and (scalars == 1).all()
    assert inv_idx.tolist() == [0, 1, 2, 3, 0, 1, 2, 3]
    core = backend.graph_core(8, 2, 4, True, CPU)
    assert [(x.shape, x.dtype) for x in core.prepare.inputs] == [
        (x.shape, x.dtype) for x in (pk, sig, sig_checked, set_mask, scalars, inv_idx)]
    assert (u.shape, u.dtype) == (core.h2g2.inputs[0].shape, core.h2g2.inputs[0].dtype)
