"""The port's KZG blob batch verification (lighthouse_tpu_torch
crypto/kzg.py and ops/kzg.py, run on the CPU through the kernels' plain
versions) against the JAX package: the host parts as integers, the trusted
setup, the wide G1 ladder, the combination's two G1 sums, and the verdicts
of the whole slice against the JAX host path (``device=False``). Inputs are
made from a numpy seed; setups cross with ``convert.from_jax_kzg``. The JAX
device graph (ops/kzg.py) is not compiled here: its CPU compile takes
minutes, so the JAX host path is the yardstick at the verify level."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto import kzg as jkzg
from lighthouse_tpu.crypto.bls import curves as oc
from lighthouse_tpu.crypto.bls.constants import R
from lighthouse_tpu.ops import kzg as jops_kzg
from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch.crypto import kzg as tkzg
from lighthouse_tpu_torch.ops import curves as cv
from lighthouse_tpu_torch.ops import kzg as okzg

N = 16                                  # the dev domain of tests/test_kzg.py
SEED = 4844
VECTORS = "tests/vectors/general/deneb/kzg/verify_blob_kzg_proof_batch/small"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain kernel versions run many small ops; one intra-op thread
    is faster for them and leaves the other cores to other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rand_blob(rng, n):
    """n random canonical field elements (each below 2^254)."""
    raw = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    raw[:, 0] &= 0x3F
    return raw.tobytes()


@pytest.fixture(scope="module")
def dev():
    """(JAX dev setup, the port's copy of it)."""
    j = jkzg.Kzg.insecure_dev_setup(N)
    return j, convert.from_jax_kzg(j)


def _domain_kzgs(n):
    """JAX and port Kzg objects of domain size n with no Lagrange points
    (the challenges and evaluations never read them)."""
    bits = n.bit_length() - 1
    out = []
    for mod in (jkzg, tkzg):
        w = mod._root_of_unity(n)
        domain = [pow(w, mod._bit_reverse(i, bits), R) for i in range(n)]
        out.append(mod.Kzg([None] * n, oc.G2_GEN, domain))
    return out


# --- host parts, as integers ------------------------------------------------


@pytest.mark.parametrize("n", [N, 4096])
def test_host_parts_match_jax(n):
    jk, tk = _domain_kzgs(n)
    assert tkzg._root_of_unity(n) == jkzg._root_of_unity(n)
    assert tk.domain == jk.domain
    rng = np.random.default_rng(SEED + n)
    blobs = [_rand_blob(rng, n) for _ in range(3)]
    commitments = [oc.g1_mul(oc.G1_GEN, 1000 + i) for i in range(2)] + [None]
    proofs = [None, oc.g1_mul(oc.G1_GEN, 77), oc.g1_mul(oc.G1_GEN, 78)]
    zs = [tk._challenge(b, c) for b, c in zip(blobs, commitments)]
    assert zs == [jk._challenge(b, c) for b, c in zip(blobs, commitments)]
    evals = tk.blob_to_field_elements(blobs[0])
    assert evals == jk.blob_to_field_elements(blobs[0])
    for z in (zs[0], tk.domain[3]):                   # off and on the domain
        assert tk.evaluate_polynomial(evals, z) == jk.evaluate_polynomial(evals, z)
    assert tk.evaluate_polynomial(evals, tk.domain[3]) == evals[3]
    ys = [tk.evaluate_polynomial(tk.blob_to_field_elements(b), z) for b, z in zip(blobs, zs)]
    assert tk._batch_challenge(commitments, zs, ys, proofs) == \
        jk._batch_challenge(commitments, zs, ys, proofs)
    assert tk.batch_inputs(blobs, commitments, proofs) == (
        zs, ys, jk._batch_challenge(commitments, zs, ys, proofs))
    bad = R.to_bytes(32, "big") + blobs[0][32:]
    with pytest.raises(tkzg.KzgError, match="not canonical"):
        tk.blob_to_field_elements(bad)
    with pytest.raises(tkzg.KzgError, match="expected"):
        tk.evaluate_polynomial(evals[:-1], zs[0])


def test_scalars_to_words_match_jax():
    xs = [0, 1, R - 1, 1 << 63, (1 << 64) - 1, (1 << 255) + 1, 0xDEADBEEF << 130]
    got = okzg._scalars_to_words(xs)
    assert got.dtype == np.int64 and got.shape == (4, len(xs))
    np.testing.assert_array_equal(got.view(np.uint64), jops_kzg._scalars_to_words(xs).T)


# --- the trusted setup ---------------------------------------------------------


@pytest.fixture(scope="module")
def prod():
    """The port's production setup, validated (its anchors checked)."""
    return tkzg.Kzg.load_trusted_setup()


def test_setup_file_is_the_jax_copy(prod):
    """The same ceremony bytes, and the port's validated load gives the
    [tau]G2 and bit-reversed domain that the JAX package's load derives from
    them (its oracle's decompression, its root of unity)."""
    def read(path):
        with open(path, "rb") as f:
            return f.read()

    raw = read(jkzg.Kzg.PRODUCTION_SETUP_PATH)
    assert hashlib.sha256(read(tkzg.Kzg.PRODUCTION_SETUP_PATH)).digest() == \
        hashlib.sha256(raw).digest()
    g2_hex = json.loads(raw)["g2_monomial"][1]
    assert prod.n == 4096
    assert prod.g2_tau == oc.g2_from_compressed(bytes.fromhex(g2_hex[2:]))
    w = jkzg._root_of_unity(4096)
    assert prod.domain == [pow(w, jkzg._bit_reverse(i, 12), R) for i in range(4096)]
    assert tkzg.Kzg.load_trusted_setup() is prod          # the validated load is cached


# --- the device graph's parts ------------------------------------------------


def test_mul_var_scalar_wide_matches_oracle():
    rng = np.random.default_rng(SEED)
    rand = [int.from_bytes(rng.bytes(32), "big") % R for _ in range(2)]
    ks = [0, 1, R - 1, 1 << 63, (1 << 64) - 1, (1 << 255) + 1] + rand
    pts = [oc.g1_mul(oc.G1_GEN, 5 + 11 * i) for i in range(len(ks))]
    words = torch.from_numpy(okzg._scalars_to_words(ks))
    got = cv.G1.mul_var_scalar_wide(cv.g1_from_affine(pts, "cpu"), words, nbits=256)
    assert cv.to_affine_ints(got, "G1") == [oc.g1_mul(p, k) for p, k in zip(pts, ks)]


# The JAX suite's 64-bit instance (tests/test_kzg.py): with a known tau,
# C_i = [y_i + w_i (tau - z_i)]G1 and W_i = [w_i]G1 satisfy the identity.
_TAU = 40961
_WS, _ZS, _YS = [7, 1009], [11, 257], [5, 65535]
_R64 = (1 << 30) + 12345


def _instance64():
    proofs = [oc.g1_mul(oc.G1_GEN, w) for w in _WS]
    commitments = [oc.g1_mul(oc.G1_GEN, (y + w * (_TAU - z)) % R)
                   for w, z, y in zip(_WS, _ZS, _YS)]
    return commitments, proofs, oc.g2_mul(oc.G2_GEN, _TAU)


def test_combine_sums_match_host_formula():
    """Stages A and B against the JAX host path's sums (crypto/kzg.py
    verify_blob_kzg_proof_batch) in Python integers, on the 64-bit instance
    with a third entry at infinity (a zero blob's) and one padding lane."""
    commitments, proofs, g2_tau = _instance64()
    commitments, proofs = commitments + [None], proofs + [None]
    zs, ys = _ZS + [99], _YS + [0]
    staged = okzg.stage(commitments, zs, ys, proofs, _R64, g2_tau, "cpu")
    commit, proof, _, y_words, z_words, r_words = staged
    assert commit.shape[-1] == 4
    sums = okzg._stage_b(okzg._stage_a(commit, proof, y_words, z_words, nbits=64),
                         proof, r_words, nbits=64)
    lhs, w_acc = None, None
    for i, (c, z, y, w) in enumerate(zip(commitments, zs, ys, proofs)):
        ri = pow(_R64, i, R)
        term = oc.g1_add(oc.g1_add(c, oc.g1_neg(oc.g1_mul(oc.G1_GEN, y))), oc.g1_mul(w, z))
        lhs = oc.g1_add(lhs, oc.g1_mul(term, ri))
        w_acc = oc.g1_add(w_acc, oc.g1_mul(w, ri))
    assert cv.to_affine_ints(sums, "G1") == [lhs, w_acc]


@pytest.mark.parametrize("case,want", [("valid", True), ("swapped", False), ("bad_y", False)])
def test_jax_suite_64bit_instance(case, want):
    commitments, proofs, g2_tau = _instance64()
    ys = list(_YS)
    if case == "swapped":
        proofs = proofs[::-1]
    elif case == "bad_y":
        ys[0] += 1
    got = okzg.verify_kzg_batch_gpu(commitments, _ZS, ys, proofs, _R64, g2_tau,
                                    nbits=64, device="cpu")
    assert got is want


# --- the slice as a whole ----------------------------------------------------


@pytest.fixture(scope="module")
def cases(dev):
    """Batches on the dev setup, committed and proven by the JAX package:
    name -> (blobs, commitments, proofs)."""
    jk, _ = dev
    rng = np.random.default_rng(SEED)
    zero = bytes(32 * N)
    blobs = [_rand_blob(rng, N) for _ in range(3)] + [zero]
    commitments = [jk.blob_to_kzg_commitment(b) for b in blobs]
    proofs = [jk.compute_blob_kzg_proof(b, c) for b, c in zip(blobs, commitments)]

    def pick(idx, order=None):
        order = order or idx
        return ([blobs[i] for i in idx], [commitments[i] for i in idx],
                [proofs[i] for i in order])

    return {"valid": pick([0, 1, 2]), "swapped": pick([0, 1, 2], [1, 0, 2]),
            "all_zero": pick([3, 3]), "zero_beside_valid": pick([0, 3, 1]),
            "empty": pick([])}


@pytest.mark.parametrize("name,want", [
    ("valid", True), ("swapped", False), ("all_zero", True),
    ("zero_beside_valid", True), ("empty", True)])
def test_batch_verify_matches_jax_host_path(dev, cases, name, want):
    jk, tk = dev
    blobs, commitments, proofs = cases[name]
    assert jk.verify_blob_kzg_proof_batch(blobs, commitments, proofs, device=False) is want
    assert tk.verify_blob_kzg_proof_batch(blobs, commitments, proofs, device="cpu") is want


def test_deneb_vector_valid_pair_at_256_bits(prod):
    case = Path(__file__).resolve().parent.parent / VECTORS / "valid_pair"
    meta = json.loads((case / "meta.json").read_text())
    blobs = [(case / f"blob_{i}.bin").read_bytes() for i in range(meta["count"])]
    cs = [oc.g1_from_compressed(bytes.fromhex(h[2:])) for h in meta["input"]["commitments"]]
    ps = [oc.g1_from_compressed(bytes.fromhex(h[2:])) for h in meta["input"]["proofs"]]
    assert meta["output"] is True
    assert prod.verify_blob_kzg_proof_batch(blobs, cs, ps, device="cpu") is True


def test_entry_points_default_to_the_card(dev, cases, monkeypatch):
    _, tk = dev
    blobs, commitments, proofs = cases["zero_beside_valid"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tk.verify_blob_kzg_proof_batch(blobs, commitments, proofs)
    commitments, proofs, g2_tau = _instance64()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        okzg.verify_kzg_batch_gpu(commitments, _ZS, _YS, proofs, _R64, g2_tau)
