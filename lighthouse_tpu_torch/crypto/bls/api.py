"""BLS signature API of the port: key and signature types, the backend
registry, batch verification and poisoned-set isolation.

Counterpart: ``lighthouse_tpu/crypto/bls/api.py`` (types; registry
:303-341; ``find_invalid_sets`` :344). The types are copies; the registry
holds one backend, ``"gpu"`` (``lighthouse_tpu_torch.ops.backend``),
imported on first use. Semantics match blst as the reference drives it
(crypto/bls/src/impls/blst.rs:36-118): random nonzero 64-bit batch scalars
from the host CSPRNG (drawn in ops/backend.py), signatures subgroup-checked on use, infinity public
keys rejected, and a failed batch as the caller's cue to isolate culprits.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from . import curves as c
from . import hash_to_curve as h2c
from .constants import R


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


# ---------------------------------------------------------------------------
# Backend seam
# ---------------------------------------------------------------------------

_BACKENDS: dict = {}


def register_backend(name: str, fn) -> None:
    """fn(sets, device=None) -> bool."""
    _BACKENDS[name] = fn


def _resolve(name: str):
    if name == "gpu" and name not in _BACKENDS:
        from ...ops import backend as _gpu_backend  # noqa: F401
    if name not in _BACKENDS:
        raise BlsError(f"unknown BLS backend: {name}")
    return _BACKENDS[name]


def verify_signature_sets(sets: Sequence[SignatureSet], backend: str = "gpu",
                          device=None) -> bool:
    """Batch-verify signature sets (on the card unless device says
    otherwise). On False, callers isolate the poisoned sets
    (find_invalid_sets)."""
    return bool(_resolve(backend)(list(sets), device=device))


def find_invalid_sets(sets: Sequence[SignatureSet], backend: str = "gpu",
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
