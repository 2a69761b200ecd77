"""The port's single verifications on the CPU against the JAX package's host
oracle: ``verify``, ``fast_aggregate_verify`` and ``aggregate_verify``
(lighthouse_tpu_torch/crypto/bls/api.py, the product of pairings through
the batch path's stage graphs, ops/backend.verify_pairs_gpu) and
``Kzg.verify_kzg_proof`` / ``Kzg.verify_blob_kzg_proof`` (crypto/kzg.py,
the batch KZG check at n = 1), run with device="cpu" through the kernels'
plain versions. Same verdicts as lighthouse_tpu's on keys, messages and
blobs from a numpy seed: valid, a wrong message, every host early-out,
an unchecked signature outside G2, aggregate_verify at k = 3 (a padded
row masked), a blob proof; the committed verify_kzg_proof vectors (a
valid proof, a wrong y, a malformed proof) against the port, JAX and
their outputs; the
backend registry ("oracle", "fake", "gpu" the default); and, without a
card, device=None raises. The blob case uses a 16-element dev setup
carried across with convert.from_jax_kzg, the vectors the production
[tau]G2. No JAX pairing or KZG graph is
compiled. Each device verdict is computed once (a plain single verify
costs seconds on the CPU)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto import kzg as jkzg
from lighthouse_tpu.crypto.bls import api as japi
from lighthouse_tpu.crypto.bls import curves as jcurves
from lighthouse_tpu.crypto.bls import fields as jf
from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch.crypto import kzg as tkzg
from lighthouse_tpu_torch.crypto.bls import api
from lighthouse_tpu_torch.crypto.bls import curves as tcurves
from lighthouse_tpu_torch.crypto.bls.constants import P
from lighthouse_tpu_torch.ops import backend
from lighthouse_tpu_torch.ops import kzg as okzg

SEED = 1111
N = 16                                  # the dev KZG domain
ROOT = Path(__file__).resolve().parent.parent
KZG_VECTORS = ROOT / "tests/vectors/general/deneb/kzg/verify_kzg_proof/small"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def bls():
    """Secret keys and messages from the seed, their port and JAX keys,
    and the signatures: one signer, three signers of one message, three
    signers of a message each."""
    rng = np.random.default_rng(SEED)
    ks = [int(x) for x in rng.integers(1, 2**62, size=4)]
    msgs = [rng.bytes(32) for _ in range(3)]
    sks = [api.SecretKey(k) for k in ks]
    pks = [sk.public_key() for sk in sks]
    one = sks[0].sign(msgs[0])
    same = api.AggregateSignature.aggregate([sk.sign(msgs[1]) for sk in sks[1:]])
    each = api.AggregateSignature.aggregate([sk.sign(m) for sk, m in zip(sks[1:], msgs)])
    return {"msgs": msgs, "pks": pks, "jpks": [japi.PublicKey(point=pk.point) for pk in pks],
            "one": one.point, "same": same.point, "each": each.point}


def _sigs(point, checked=True):
    return (api.Signature(point=point, subgroup_checked=checked),
            japi.Signature(point=point, subgroup_checked=checked))


def _both(fn_name, keys_of, args_of, sig):
    """(port verdict on the CPU, JAX oracle verdict) of one API function."""
    b_sig, j_sig = sig
    port = getattr(api, fn_name)(*keys_of("pks"), *args_of, b_sig, device="cpu")
    jax = getattr(japi, fn_name)(*keys_of("jpks"), *args_of, j_sig)
    return port, jax


@pytest.fixture(scope="module")
def device_verdicts(bls):
    """Every BLS case that reaches the device, run once: {case: (port, jax)}."""
    msgs = bls["msgs"]
    out = {}
    for case, msg in (("verify_valid", msgs[0]), ("verify_wrong_message", msgs[1])):
        out[case] = _both("verify", lambda k: [bls[k][0]], [msg], _sigs(bls["one"]))
    out["fast_aggregate_valid"] = _both("fast_aggregate_verify", lambda k: [bls[k][1:]],
                                        [msgs[1]], _sigs(bls["same"]))
    assert backend.single_m_bucket(3) == 4       # one padded row, masked
    out["aggregate_k3_valid"] = _both("aggregate_verify", lambda k: [bls[k][1:]],
                                      [msgs], _sigs(bls["each"], checked=False))
    return out


@pytest.mark.parametrize("case,want", [("verify_valid", True), ("verify_wrong_message", False),
                                       ("fast_aggregate_valid", True),
                                       ("aggregate_k3_valid", True)])
def test_device_verdicts_match_jax(device_verdicts, case, want):
    assert device_verdicts[case] == (want, want)


def _off_subgroup_point():
    """A point on E2' outside G2 (its cofactor not cleared)."""
    x = 5
    while True:
        y = jf.fp2_sqrt(jf.fp2_add(jf.fp2_mul(jf.fp2_sqr((x, 0)), (x, 0)), (4, 4)))
        if y is not None and not jcurves.g2_in_subgroup(((x, 0), y)):
            return (x, 0), y
        x += 1


def _early_outs(bls):
    """(function, key selector, other args, signatures) of every host
    early-out: each must answer False without reaching the device."""
    msgs, pk0 = bls["msgs"], bls["pks"][0]
    neg = (pk0.point[0], (-pk0.point[1]) % P)
    inf, off = _sigs(None), _sigs(_off_subgroup_point(), checked=False)
    cancel = {"pks": [pk0, api.PublicKey(point=neg)],
              "jpks": [bls["jpks"][0], japi.PublicKey(point=neg)]}
    return {
        "verify_infinity_signature": ("verify", lambda k: [bls[k][0]], [msgs[0]], inf),
        "verify_off_subgroup": ("verify", lambda k: [bls[k][0]], [msgs[0]], off),
        "fast_aggregate_no_keys": ("fast_aggregate_verify", lambda k: [[]], [msgs[0]],
                                   _sigs(bls["one"])),
        "fast_aggregate_to_infinity": ("fast_aggregate_verify", lambda k: [cancel[k]],
                                       [msgs[0]], _sigs(bls["one"])),
        "fast_aggregate_infinity_signature": ("fast_aggregate_verify",
                                              lambda k: [bls[k][1:]], [msgs[1]], inf),
        "aggregate_no_keys": ("aggregate_verify", lambda k: [[]], [[]], _sigs(bls["each"])),
        "aggregate_length_mismatch": ("aggregate_verify", lambda k: [bls[k][1:]], [msgs[:2]],
                                      _sigs(bls["each"])),
        "aggregate_infinity_signature": ("aggregate_verify", lambda k: [bls[k][1:]], [msgs],
                                         inf),
        "aggregate_off_subgroup": ("aggregate_verify", lambda k: [bls[k][1:]], [msgs], off),
    }


EARLY_OUTS = ("verify_infinity_signature", "verify_off_subgroup", "fast_aggregate_no_keys",
              "fast_aggregate_to_infinity", "fast_aggregate_infinity_signature",
              "aggregate_no_keys", "aggregate_length_mismatch", "aggregate_infinity_signature",
              "aggregate_off_subgroup")


@pytest.mark.parametrize("case", EARLY_OUTS)
def test_host_early_outs_match_jax(bls, case, monkeypatch):
    def no_device(*a, **k):
        raise AssertionError("an early-out reached the device")

    monkeypatch.setattr(backend, "verify_pairs_gpu", no_device)
    fn, keys_of, args, sig = _early_outs(bls)[case]
    assert _both(fn, keys_of, args, sig) == (False, False)


# --- KZG ---------------------------------------------------------------------


def test_blob_proof_matches_jax():
    """A blob of the dev setup, its commitment and proof by the JAX host
    oracle: verify_blob_kzg_proof (challenge and evaluation on the host,
    then verify_kzg_proof) on the port and in JAX. The wrong-y case is the
    wrong_y vector below (each port KZG verify costs about 5 s here)."""
    j = jkzg.Kzg.insecure_dev_setup(N)
    p = convert.from_jax_kzg(j)
    rng = np.random.default_rng(SEED + 1)
    raw = rng.integers(0, 256, size=(N, 32), dtype=np.uint8)
    raw[:, 0] &= 0x3F
    blob = raw.tobytes()
    c = j.blob_to_kzg_commitment(blob)
    proof = j.compute_blob_kzg_proof(blob, c)
    assert p.verify_blob_kzg_proof(blob, c, proof, device="cpu") is True
    assert j.verify_blob_kzg_proof(blob, c, proof) is True


def test_single_proof_is_the_batch_check_at_one():
    """n_bucket 1: staging pads nothing and the graph key is (1, 256)."""
    g1 = tcurves.g1_mul(tcurves.G1_GEN, 5)
    staged = okzg.stage([g1], [3], [4], [g1], 1, tcurves.G2_GEN, "cpu")
    assert [t.shape[-1] for t in staged] == [1, 1, 1, 1, 1, 1]
    assert staged[-1].tolist() == [[1], [0], [0], [0]]          # r^0 = 1
    assert okzg._graphed(1, 256, torch.device("cpu")).inputs[0].shape == (3, 12, 1)


def _production_g2_tau(mod, curves):
    with open(mod.Kzg.PRODUCTION_SETUP_PATH) as f:
        g2 = json.load(f)["g2_monomial"][1]
    return curves.g2_from_compressed(bytes.fromhex(g2[2:]))


def _vector(mod, curves, case, device):
    """One verify_kzg_proof vector through `mod`'s Kzg with the production
    [tau]G2; a proof or commitment that fails to decompress is False."""
    inp = json.loads((KZG_VECTORS / case / "meta.json").read_text())["input"]
    kzg = mod.Kzg([], _production_g2_tau(mod, curves), [])
    try:
        c = curves.g1_from_compressed(bytes.fromhex(inp["commitment"][2:]))
        w = curves.g1_from_compressed(bytes.fromhex(inp["proof"][2:]))
    except ValueError:
        return False
    z, y = (int(inp[k], 16) for k in ("z", "y"))
    return kzg.verify_kzg_proof(c, z, y, w, **device)


@pytest.mark.parametrize("case", ["malformed_proof", "valid", "wrong_y"])
def test_verify_kzg_proof_vectors(case):
    want = json.loads((KZG_VECTORS / case / "meta.json").read_text())["output"]
    got = _vector(tkzg, tcurves, case, {"device": "cpu"})
    assert got is want
    assert _vector(jkzg, jcurves, case, {}) is want


# --- registry and the card ---------------------------------------------------


def test_registry_oracle_fake_and_default(bls):
    pks, msgs = bls["pks"], bls["msgs"]
    sets = [(bls["one"], [0], msgs[0]), (bls["same"], [1, 2, 3], msgs[1])]
    assert set(api._BACKENDS) >= {"oracle", "fake"}
    port = [api.SignatureSet(api.Signature(point=s, subgroup_checked=True),
                             [pks[i] for i in ix], m) for s, ix, m in sets]
    jax = [japi.SignatureSet(japi.Signature(point=s, subgroup_checked=True),
                             [bls["jpks"][i] for i in ix], m) for s, ix, m in sets]
    poisoned_port = [port[0], api.SignatureSet(port[1].signature, port[1].signing_keys, msgs[2])]
    poisoned_jax = [jax[0], japi.SignatureSet(jax[1].signature, jax[1].signing_keys, msgs[2])]
    assert api.get_backend() == "gpu"
    assert api._resolve("oracle") is api._BACKENDS["oracle"]
    assert api.verify_signature_sets(port, backend="oracle") is True
    assert japi.verify_signature_sets(jax, backend="oracle") is True
    assert api.verify_signature_sets(poisoned_port, backend="oracle") is False
    assert japi.verify_signature_sets(poisoned_jax, backend="oracle") is False
    assert api.verify_signature_sets(poisoned_port, backend="fake") is True
    assert japi.verify_signature_sets(poisoned_jax, backend="fake") is True


def test_without_a_card_all_five_raise(bls, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pks, msgs = bls["pks"], bls["msgs"]
    sig = api.Signature(point=bls["one"], subgroup_checked=True)
    kzg = tkzg.Kzg([], tcurves.G2_GEN, [])
    blob_kzg = tkzg.Kzg.insecure_dev_setup(4)
    calls = [lambda: api.verify(pks[0], msgs[0], sig),
             lambda: api.fast_aggregate_verify(pks[:1], msgs[0], sig),
             lambda: api.aggregate_verify(pks[:1], msgs[:1], sig),
             lambda: kzg.verify_kzg_proof(tcurves.G1_GEN, 1, 1, tcurves.G1_GEN),
             lambda: blob_kzg.verify_blob_kzg_proof(bytes(128), None, None)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
