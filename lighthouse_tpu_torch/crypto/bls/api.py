"""BLS signature API of the port: key and signature types, the backend
registry, batch verification and poisoned-set isolation.

Counterpart: ``lighthouse_tpu/crypto/bls/api.py`` (types; the single
verifications ``verify``, ``fast_aggregate_verify``, ``aggregate_verify``
:227-259; the oracle ``verify_signature_sets_oracle`` :262-300; registry
:303-341; ``find_invalid_sets`` :344). The types are copies. The registry
holds ``"gpu"`` (``lighthouse_tpu_torch.ops.backend``, the default) and
``"cpu"`` (the native verifier, ``cpu_backend``), each imported on first
use, and ``"oracle"`` (the host verifier below) and ``"fake"`` (always
True), which run on the host because the caller names them. The single
verifications keep the JAX package's host early-outs and run their
product of pairings on the card (``ops/backend.verify_pairs_gpu``), where
the JAX package runs it on its host oracle. Semantics match blst as the
reference drives it
(crypto/bls/src/impls/blst.rs:36-118): random nonzero 64-bit batch scalars
from the host CSPRNG (drawn in ops/backend.py), signatures subgroup-checked on use, infinity public
keys rejected, and a failed batch as the caller's cue to isolate culprits.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass
from typing import Optional, Sequence

from . import curves as c
from . import hash_to_curve as h2c
from . import pairing as pr
from .constants import RAND_BITS, R


class BlsError(Exception):
    pass


class SecretKey:
    """A scalar in [1, r)."""

    __slots__ = ("_k",)

    def __init__(self, k: int):
        if not 0 < k < R:
            raise BlsError("secret key out of range")
        self._k = k

    def public_key(self) -> "PublicKey":
        return PublicKey(point=c.g1_mul(c.G1_GEN, self._k))

    def sign(self, message: bytes) -> "Signature":
        """message is hashed to G2 and multiplied by the key (PoP scheme)."""
        h = h2c.hash_to_g2(message)
        return Signature(point=c.g2_mul(h, self._k), subgroup_checked=True)


@dataclass(frozen=True)
class PublicKey:
    """Decompressed G1 public key (affine (x, y)); infinity is rejected."""

    point: tuple

    @classmethod
    def from_bytes(cls, data: bytes) -> "PublicKey":
        try:
            pt = c.g1_from_compressed(data)
        except ValueError as e:
            raise BlsError(str(e))
        if pt is None:
            raise BlsError("infinity public key rejected")
        if not c.g1_in_subgroup(pt):
            raise BlsError("public key not in G1 subgroup")
        return cls(point=pt)


@dataclass(frozen=True)
class AggregatePublicKey:
    point: Optional[tuple]

    @classmethod
    def aggregate(cls, pubkeys: Sequence[PublicKey]) -> "AggregatePublicKey":
        if not pubkeys:
            raise BlsError("cannot aggregate zero public keys")
        acc = None
        for pk in pubkeys:
            acc = c.g1_add(acc, pk.point)
        return cls(point=acc)


@dataclass(frozen=True)
class Signature:
    """A G2 signature; ``point is None`` is the infinity signature.
    ``subgroup_checked`` records that the point already passed the G2
    subgroup check, so verification does not pay for it again."""

    point: Optional[tuple]
    subgroup_checked: bool = False

    @classmethod
    def from_bytes(cls, data: bytes, subgroup_check: bool = True) -> "Signature":
        try:
            pt = c.g2_from_compressed(data)
        except ValueError as e:
            raise BlsError(str(e))
        if subgroup_check and pt is not None and not c.g2_in_subgroup(pt):
            raise BlsError("signature not in G2 subgroup")
        return cls(point=pt, subgroup_checked=subgroup_check)

    @classmethod
    def infinity(cls) -> "Signature":
        return cls(point=None)


@dataclass(frozen=True)
class AggregateSignature:
    point: Optional[tuple]

    @classmethod
    def aggregate(cls, sigs: Sequence[Signature]) -> "AggregateSignature":
        acc = None
        for s in sigs:
            acc = c.g2_add(acc, s.point)
        return cls(point=acc)


@dataclass(frozen=True)
class SignatureSet:
    """Does `signature` sign `message` under the aggregate of
    `signing_keys`? (The reference's GenericSignatureSet.)"""

    signature: Signature
    signing_keys: Sequence[PublicKey]
    message: bytes

    def aggregate_pubkey(self) -> Optional[tuple]:
        if not self.signing_keys:
            return None
        return AggregatePublicKey.aggregate(self.signing_keys).point


# ---------------------------------------------------------------------------
# The oracle: host batch verification in Python integers
# ---------------------------------------------------------------------------


def _sig_in_subgroup(sig) -> bool:
    return getattr(sig, "subgroup_checked", False) or c.g2_in_subgroup(sig.point)


def _device(device):
    """`device` resolved as every entry point resolves it: None is the card,
    and raises without one, before any early-out."""
    from ...ops import limbs as _limbs

    return _limbs.default_device(device)


def _verify_pairs(pk_points, messages, sig_point, device) -> bool:
    from ...ops import backend as _gpu_backend

    return _gpu_backend.verify_pairs_gpu(pk_points, messages, sig_point, device=device)


def verify(pubkey: PublicKey, message: bytes, signature: Signature, device=None) -> bool:
    """Single verification, e(pk, H(m)) * e(-g1, sig) == 1, the product on
    `device` (default: the card)."""
    device = _device(device)
    if signature.point is None:
        return False
    if not _sig_in_subgroup(signature):
        return False
    return _verify_pairs([pubkey.point], [message], signature.point, device)


def fast_aggregate_verify(pubkeys: Sequence[PublicKey], message: bytes, signature: Signature,
                          device=None) -> bool:
    """All keys sign the same message: aggregated on the host, then verify."""
    device = _device(device)
    if not pubkeys:
        return False
    agg = AggregatePublicKey.aggregate(pubkeys)
    if agg.point is None:
        return False
    return verify(PublicKey(point=agg.point), message, signature, device=device)


def aggregate_verify(pubkeys: Sequence[PublicKey], messages: Sequence[bytes],
                     signature: Signature, device=None) -> bool:
    """A message per key: prod_i e(pk_i, H(m_i)) * e(-g1, sig) == 1, the
    product on `device` (default: the card)."""
    device = _device(device)
    if not pubkeys or len(pubkeys) != len(messages):
        return False
    if signature.point is None:
        return False
    if not _sig_in_subgroup(signature):
        return False
    return _verify_pairs([pk.point for pk in pubkeys], list(messages), signature.point, device)


def _random_batch_scalar() -> int:
    while True:
        k = secrets.randbits(RAND_BITS)
        if k:
            return k


def verify_signature_sets_oracle(sets: Sequence[SignatureSet]) -> bool:
    """Random-scalar batch verification (Vitalik's scheme), semantics of
    blst's verify_multiple_aggregate_signatures as driven by
    crypto/bls/src/impls/blst.rs:36-118:

        prod_i e(r_i * agg_pk_i, H(m_i)) * e(-g1, sum_i r_i * sig_i) == 1

    with r_i random nonzero 64-bit scalars. About 0.1 s a pairing: the
    native ``cpu`` backend hands it the sets its ABI does not carry.
    """
    if not sets:
        return False
    pairs = []
    sig_acc = None
    for s in sets:
        if not s.signing_keys:
            return False
        if s.signature.point is None:
            return False
        if not _sig_in_subgroup(s.signature):
            return False
        agg_pk = s.aggregate_pubkey()
        if agg_pk is None:
            return False
        r = _random_batch_scalar()
        pairs.append((c.g1_mul(agg_pk, r), h2c.hash_to_g2(s.message)))
        sig_acc = c.g2_add(sig_acc, c.g2_mul(s.signature.point, r))
    pairs.append((c.g1_neg(c.G1_GEN), sig_acc))
    return pr.pairings_product_is_one(pairs)


# ---------------------------------------------------------------------------
# Backend seam
# ---------------------------------------------------------------------------

def _oracle_backend(sets, device=None) -> bool:
    """Backend "oracle": the host verifier, whatever `device` says."""
    return verify_signature_sets_oracle(sets)


def _fake_backend(sets, device=None) -> bool:
    """Backend "fake": unconditional success (the reference's fake_crypto,
    crypto/bls/src/impls/fake_crypto.rs:29-33)."""
    return True


_BACKENDS: dict = {"oracle": _oracle_backend, "fake": _fake_backend}
_active_backend = "gpu"


def register_backend(name: str, fn) -> None:
    """fn(sets, device=None) -> bool."""
    _BACKENDS[name] = fn


def _resolve(name: str):
    if name == "gpu" and name not in _BACKENDS:
        from ...ops import backend as _gpu_backend  # noqa: F401
    if name == "cpu" and name not in _BACKENDS:
        # Lazy: the native verifier is built on its first verify.
        from . import cpu_backend as _cpu_backend  # noqa: F401
    if name not in _BACKENDS:
        raise BlsError(f"unknown BLS backend: {name}")
    return _BACKENDS[name]


def set_backend(name: str) -> None:
    """Make `name` the backend of calls that name none."""
    global _active_backend
    _resolve(name)
    _active_backend = name


def get_backend() -> str:
    return _active_backend


def verify_signature_sets(sets: Sequence[SignatureSet], backend: Optional[str] = None,
                          device=None) -> bool:
    """Batch-verify signature sets on `backend` (default: the active one,
    "gpu", on the card unless device says otherwise). On False, callers
    isolate the poisoned sets (find_invalid_sets)."""
    return bool(_resolve(backend or _active_backend)(list(sets), device=device))


def find_invalid_sets(sets: Sequence[SignatureSet], backend: Optional[str] = None,
                      device=None) -> list:
    """Indices of the invalid sets, by bisection: a failing range splits in
    two and each failing half recurses (~2 log2(n) k batch calls for k
    culprits)."""
    sets = list(sets)
    out: list = []

    def recurse(lo: int, hi: int) -> None:
        if verify_signature_sets(sets[lo:hi], backend=backend, device=device):
            return
        if hi - lo == 1:
            out.append(lo)
            return
        mid = (lo + hi) // 2
        recurse(lo, mid)
        recurse(mid, hi)

    if sets:
        recurse(0, len(sets))
    return out
