"""Batch KZG blob-proof verification on the card: the device half of
Deneb's ``verify_blob_kzg_proof_batch``.

Counterpart: ``lighthouse_tpu/ops/kzg.py`` (``_consts``,
``_scalars_to_words``, ``_combine``, ``verify_kzg_batch_device``), followed
function for function on the batch-minor engine. The host computes the
challenges z_i, the evaluations y_i and the batch challenge r
(``crypto/kzg.py``); the device checks the random linear combination of
the n proofs as ONE 2-pair pairing product,

    e(sum r^i (C_i - [y_i]G1 + [z_i]W_i), -G2) * e(sum r^i W_i, [tau]G2) == 1,

in three stages, every tensor on one device and nothing leaving it
between them:

    A  [y_i]G1 and [z_i]W_i in one 2n-lane 256-bit ladder, then the term
       C_i - [y_i]G1 + [z_i]W_i
    B  the r^i weighting of the term and of W_i in one 2n-lane ladder, then
       both sums over the minor axis at once
    pairing  the two sums against -G2 and [tau]G2, projective; a sum at
       infinity is masked out (it contributes the identity, as the oracle
       skips it), so a batch of zero blobs verifies

The ladders run on K1 (``mul_many``), the pairing on K2 and K3. Batches
pad to a power-of-two n_bucket with infinity points and zero scalars. The
three stages are one CUDA graph per (n_bucket, nbits) (``_graphed``, the
counterpart of ``_jitted``), with [tau]G2 among its inputs.
"""

from functools import lru_cache, partial

import numpy as np
import torch

from ..crypto.bls import curves as _oc
from ..crypto.bls.constants import R as _R
from . import curves as cv
from . import graphs
from . import limbs as lb
from . import pairing as pr
from .backend import _next_pow2

_WORDS = 4                      # 64-bit words of an Fr scalar
_M64 = (1 << 64) - 1


@lru_cache(maxsize=None)
def _consts(device):
    """(-G2 (3, 2, 12, 1), the G1 generator (3, 12, 1)), projective."""
    device = torch.device(device)
    return (cv.g2_from_affine([_oc.g2_neg(_oc.G2_GEN)], device),
            cv.g1_from_affine([_oc.G1_GEN], device))


def _scalars_to_words(xs) -> np.ndarray:
    """Fr scalars -> (4, n) int64: the bit patterns of their little-endian
    64-bit words."""
    out = np.zeros((_WORDS, len(xs)), dtype=np.uint64)
    for i, x in enumerate(xs):
        for w in range(_WORDS):
            out[w, i] = (x >> (64 * w)) & _M64
    return out.view(np.int64)


def stage(commitments, zs, ys, proofs, r: int, g2_tau_aff, device):
    """Oracle points and Fr scalars -> device tensors: commitments and
    proofs (3, 12, n_bucket), [tau]G2 (3, 2, 12, 1), and the words of y,
    z and r^i, each (4, n_bucket)."""
    n = len(commitments)
    pad = _next_pow2(n) - n
    commit = cv.g1_from_affine(list(commitments) + [None] * pad, device)
    proof = cv.g1_from_affine(list(proofs) + [None] * pad, device)
    r_pows = [pow(r, i, _R) for i in range(n)] + [0] * pad
    words = [torch.from_numpy(_scalars_to_words(list(xs) + [0] * pad)).to(device)
             for xs in (ys, zs)]
    r_words = torch.from_numpy(_scalars_to_words(r_pows)).to(device)
    return commit, proof, cv.g2_from_affine([g2_tau_aff], device), *words, r_words


def _stage_a(commit, proof, y_words, z_words, nbits: int = 256):
    """C_i - [y_i]G1 + [z_i]W_i, the two products in one 2n-lane ladder."""
    g1 = cv.G1
    n = commit.shape[-1]
    gen = _consts(commit.device)[1].expand_as(commit)
    a = g1.mul_var_scalar_wide(torch.cat([gen, proof], dim=-1),
                               torch.cat([y_words, z_words], dim=-1), nbits)
    return g1.add(g1.add(commit, g1.neg(a[..., :n])), a[..., n:])


def _stage_b(term, proof, r_words, nbits: int = 256):
    """sum r^i term_i and sum r^i W_i -> (3, 12, 2): the weighting in one
    2n-lane ladder, the two sums in one reduction over the minor axis."""
    g1 = cv.G1
    n = term.shape[-1]
    b = g1.mul_var_scalar_wide(torch.cat([term, proof], dim=-1),
                               torch.cat([r_words, r_words], dim=-1), nbits)
    sums = g1.msm_reduce_minor(torch.stack([b[..., :n], b[..., n:]]), n)
    return torch.movedim(sums[..., 0], 0, -1)


def _pairing_check(sums, g2_tau):
    """e(sums_0, -G2) * e(sums_1, [tau]G2) == 1 -> () bool tensor; a sum at
    infinity is masked out."""
    q = torch.cat([_consts(sums.device)[0], g2_tau], dim=-1)
    return pr.multi_pairing_check(sums, q, ~cv.G1.is_infinity(sums))


def _combine(commit, proof, g2_tau, y_words, z_words, r_words, nbits: int = 256):
    """The three stages on staged tensors -> (the terms (3, 12, n), the two
    sums (3, 12, 2), the () bool verdict)."""
    term = _stage_a(commit, proof, y_words, z_words, nbits)
    sums = _stage_b(term, proof, r_words, nbits)
    return term, sums, _pairing_check(sums, g2_tau)


@graphs.cached
def _graphed(n_bucket: int, nbits: int, device):
    pt, words = ((3, lb.L, n_bucket), lb.DTYPE), ((_WORDS, n_bucket), torch.int64)
    specs = [pt, pt, ((3, 2, lb.L, 1), lb.DTYPE), words, words, words]
    return graphs.StaticGraph(partial(_combine, nbits=nbits), specs, device,
                              f"kzg n={n_bucket} nbits={nbits}")


def verify_kzg_batch_gpu(commitments, zs, ys, proofs, r: int, g2_tau_aff,
                         nbits: int = 256, device=None) -> bool:
    """Batched e(C - yG1 + zW, -G2) e(W, tau G2) check on `device`
    (default: the card) through the batch's bucket graph. Points are oracle
    affine tuples (None is infinity), scalars Python ints in Fr; `nbits`
    below 256 is for instances whose scalars are that narrow."""
    device = lb.default_device(device)
    if not commitments:
        return True
    staged = stage(commitments, zs, ys, proofs, r, g2_tau_aff, device)
    graph = _graphed(staged[0].shape[-1], nbits, staged[0].device)
    with graph.lock:
        return bool(graph(*staged)[-1].item())
