"""The two routes the port's serving router picks between, on the CPU.

The native route: the port's backend "cpu" (lighthouse_tpu_torch
crypto/bls/cpu_backend.py, its copy of native/src/blscpu.cpp built by
native.load) against the JAX package's "cpu" backend and oracle on the same
sets: valid and poisoned batches, the early-outs, a signature outside G2,
infinity public keys and odd messages (which both hand to their oracle),
the native hash to G2 against the port's hash_to_curve, and the
batch_verify vectors. The device route's async dispatch
(ops/backend.verify_signature_sets_gpu_async) run on the CPU: two batches
in flight read their own verdicts, and the three stages are timed under
engine="gpu".

The native library is built once (about 16 s of g++), in a thread started
with the module's first test, so that the device-route tests, which run
first, overlap it.
"""

import concurrent.futures
import json
from pathlib import Path

import pytest
import torch

from lighthouse_tpu.crypto.bls import api as japi
from lighthouse_tpu.crypto.bls import cpu_backend as jcpu
from lighthouse_tpu.crypto.bls import curves as jcurves
from lighthouse_tpu.crypto.bls import fields as jf
from lighthouse_tpu_torch import native
from lighthouse_tpu_torch.crypto.bls import api
from lighthouse_tpu_torch.crypto.bls import cpu_backend
from lighthouse_tpu_torch.crypto.bls import hash_to_curve as h2c
from lighthouse_tpu_torch.observability import stages
from lighthouse_tpu_torch.ops import backend
from test_torch_multi import memoized_stage1

VECTORS = Path(__file__).parent / "vectors" / "general" / "phase0" / "bls" / "batch_verify"
M1, M2, M3 = b"\x11" * 32, b"\x22" * 32, b"\x33" * 32


@pytest.fixture(scope="module")
def native_build():
    """The port's native verifier, building in a thread of its own."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield pool.submit(native.load, "blscpu")


@pytest.fixture(autouse=True)
def _build_started(native_build):
    """Every test starts the build: the first one starts it."""


@pytest.fixture(scope="module")
def _one_torch_thread():
    """The plain kernel versions run many small ops; one intra-op thread is
    faster for them and leaves a core to the build."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _both(sig_point, checked, key_points, msg):
    """One set in the JAX package's API and in the port's, from points."""
    return (japi.SignatureSet(signature=japi.Signature(point=sig_point, subgroup_checked=checked),
                              signing_keys=[japi.PublicKey(point=p) for p in key_points],
                              message=msg),
            api.SignatureSet(signature=api.Signature(point=sig_point, subgroup_checked=checked),
                             signing_keys=[api.PublicKey(point=p) for p in key_points],
                             message=msg))


def _signed(keys, msg, checked=True):
    sks = [api.SecretKey(k) for k in keys]
    sig = api.AggregateSignature.aggregate([sk.sign(msg) for sk in sks]).point
    return _both(sig, checked, [sk.public_key().point for sk in sks], msg)


@pytest.fixture(scope="module")
def sets():
    """Four sets: shared and distinct messages, one and two keys, one
    signature not yet subgroup-checked."""
    return [_signed([101, 102], M1), _signed([103], M2, checked=False),
            _signed([104, 105], M1), _signed([106], M3)]


def _poison(pairs):
    """Set 2 carries set 0's signature: same message, other keys."""
    bad = list(pairs)
    (j0, p0), (j2, p2) = pairs[0], pairs[2]
    bad[2] = (japi.SignatureSet(j0.signature, j2.signing_keys, j2.message),
              api.SignatureSet(p0.signature, p2.signing_keys, p2.message))
    return bad


# --- the device route's async dispatch, on the CPU ---------------------------


def test_async_batches_in_flight_read_their_own_verdicts(sets, _one_torch_thread):
    valid = [sets[0][1], sets[3][1]]              # n 2, k 1, m 2, all checked
    bad = [valid[0], api.SignatureSet(valid[0].signature, valid[1].signing_keys, M3)]
    hist = stages.stage_seconds()
    before = {s: hist.get_count(engine="gpu", stage=s) for s in ("h2g2", "prepare", "pairing")}
    stages.force_timing(True)
    # Both batches hash M1 and M3: the second reuses the first's h2g2
    # (test_torch_multi.memoized_stage1); the stage still runs and is timed.
    try:
        with memoized_stage1(backend._stage1_graph(2, torch.device("cpu"))):
            good = backend.verify_signature_sets_gpu_async(valid, device="cpu")
            poisoned = backend.verify_signature_sets_gpu_async(bad, device="cpu")
    finally:
        stages.force_timing(False)
    assert isinstance(good, backend.PendingVerdict)
    # Read in the other order: each holds its own copy of its verdict (the
    # native tests below hold batches made so against the oracle).
    assert bool(poisoned) is False and bool(good) is True
    after = {s: hist.get_count(engine="gpu", stage=s) for s in before}
    assert after == {s: c + 2 for s, c in before.items()}
    assert not stages._PENDING


def test_async_early_outs_are_the_blocking_calls(sets):
    port = [p for _, p in sets]
    no_keys = [port[0], api.SignatureSet(port[1].signature, [], M2)]
    inf_sig = [port[0], api.SignatureSet(api.Signature.infinity(), port[1].signing_keys, M2)]
    for batch in ([], no_keys, inf_sig):
        got = backend.verify_signature_sets_gpu_async(batch, device="cpu")
        assert got is False
        assert backend.verify_signature_sets_gpu(batch, device="cpu") is False


# --- the native route ----------------------------------------------------------


def _routes(pairs, oracle: bool):
    """(port cpu, JAX cpu[, JAX oracle]) verdicts on the same sets."""
    jsets, psets = [j for j, _ in pairs], [p for _, p in pairs]
    got = [api.verify_signature_sets(psets, backend="cpu"), jcpu.verify_signature_sets_cpu(jsets)]
    if oracle:
        got.append(japi.verify_signature_sets_oracle(jsets))
    return got


def test_native_valid_and_poisoned_batches(sets, native_build):
    native_build.result()
    assert _routes(sets, oracle=True) == [True] * 3
    assert _routes(_poison(sets), oracle=True) == [False] * 3
    assert _routes(sets[1:2], oracle=False) == [True, True]


def test_native_early_outs(sets, native_build):
    native_build.result()
    j1, p1 = sets[1]
    no_keys = (japi.SignatureSet(j1.signature, [], M2), api.SignatureSet(p1.signature, [], M2))
    inf_sig = _both(None, True, [k.point for k in p1.signing_keys], M2)
    for bad in (no_keys, inf_sig):
        assert _routes([sets[0], bad], oracle=True) == [False] * 3
    assert api.verify_signature_sets([], backend="cpu") is False
    assert jcpu.verify_signature_sets_cpu([]) is False


def _off_subgroup_point():
    """A point on E2' outside G2 (its cofactor not cleared)."""
    x = 5
    while True:
        y = jf.fp2_sqrt(jf.fp2_add(jf.fp2_mul(jf.fp2_sqr((x, 0)), (x, 0)), (4, 4)))
        if y is not None and not jcurves.g2_in_subgroup(((x, 0), y)):
            return (x, 0), y
        x += 1


def test_native_rejects_a_signature_outside_g2(sets, native_build):
    native_build.result()
    key = sets[1][1].signing_keys[0].point
    assert _routes([_both(_off_subgroup_point(), False, [key], M2)], oracle=True) == [False] * 3


def test_infinity_keys_and_odd_messages_go_to_the_oracle(sets, native_build, monkeypatch):
    native_build.result()
    calls = []
    oracle = api.verify_signature_sets_oracle
    monkeypatch.setattr(api, "verify_signature_sets_oracle",
                        lambda s: calls.append(len(s)) or oracle(s))
    _, p3 = sets[3]
    key = p3.signing_keys[0].point
    only_inf = _both(p3.signature.point, True, [None], M3)
    assert _routes([only_inf], oracle=True) == [False] * 3
    # An infinity key beside the real one: the aggregate is the real key.
    with_inf = _both(p3.signature.point, True, [key, None], M3)
    assert _routes([with_inf], oracle=False) == [True, True]       # JAX's: its oracle
    long_msg = _signed([107], b"m" * 40)
    assert _routes([long_msg], oracle=False) == [True, True]
    assert calls == [1, 1, 1]


@pytest.mark.parametrize("msg", [b"", b"abc", b"\x11" * 32, b"q" * 200])
def test_native_hash_to_g2_is_hash_to_curve(msg, native_build):
    native_build.result()
    assert cpu_backend.hash_to_g2_native(msg) == h2c.hash_to_g2(msg)
    assert cpu_backend.hash_to_g2_native(msg) == jcpu.hash_to_g2_native(msg)


def _h(s: str) -> bytes:
    return bytes.fromhex(s[2:] if s.startswith("0x") else s)


@pytest.mark.parametrize("case", sorted(p.parent.name for p in VECTORS.glob("small/*/meta.json")))
def test_batch_verify_vectors(case, native_build):
    native_build.result()
    meta = json.loads((VECTORS / "small" / case / "meta.json").read_text())
    try:
        sets = [api.SignatureSet(signature=api.Signature.from_bytes(_h(s["signature"]),
                                                                    subgroup_check=False),
                                 signing_keys=[api.PublicKey.from_bytes(_h(k))
                                               for k in s["pubkeys"]],
                                 message=_h(s["message"])) for s in meta["input"]["sets"]]
    except api.BlsError:
        sets = None
    got = False if sets is None else api.verify_signature_sets(sets, backend="cpu")
    assert got is meta["output"]


def test_backend_selection(native_build):
    native_build.result()
    assert api.get_backend() == "gpu"
    api.set_backend("cpu")
    try:
        assert api.get_backend() == "cpu"
        assert api._resolve(api.get_backend()) is cpu_backend.verify_signature_sets_cpu
    finally:
        api.set_backend("gpu")
    with pytest.raises(api.BlsError, match="unknown BLS backend"):
        api.set_backend("tpu")
    assert api.get_backend() == "gpu"
    assert native.library_path("blscpu").startswith(str(Path(native.__file__).parent / "build"))
