"""KZG polynomial commitments over BLS12-381 (EIP-4844 / Deneb blobs): the
host side of the port's batch blob-proof verification.

Counterpart: ``lighthouse_tpu/crypto/kzg.py``, copied (the port imports
nothing of the JAX package): the trusted setup, the blob encoding, the
barycentric evaluation, the commitment and proof makers of the oracle, and
the Fiat-Shamir challenges byte for byte. ``verify_blob_kzg_proof_batch``
computes the challenges z_i, the evaluations y_i = p_i(z_i) and the batch
challenge r here, on the host, as the JAX package does, and hands the G1
combination and the 2-pair pairing check to the device
(``ops/kzg.verify_kzg_batch_gpu``): the card by default, the kernels'
plain versions with ``device="cpu"``. The single-proof verifies
(``verify_kzg_proof``, ``verify_blob_kzg_proof``, JAX ``kzg.py:248-266``)
are the same device check at n = 1, whose only weight is r^0 = 1, where
the JAX package runs them on its host oracle.

`Kzg.insecure_dev_setup(n)` derives a setup from a KNOWN tau, for tests
and local nets only.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import List, Optional, Sequence, Tuple

from ..ops import limbs as _limbs
from ..ops.kzg import verify_kzg_batch_gpu
from .bls import curves as cv
from .bls.constants import R

BYTES_PER_FIELD_ELEMENT = 32

# Primitive root of unity source: 7 generates the multiplicative group mod R
# up to the 2-adic part (R - 1 = 2^32 * odd).
_GEN = 7


class KzgError(Exception):
    pass


def _root_of_unity(order: int) -> int:
    if order & (order - 1):
        raise KzgError("domain size must be a power of two")
    exp = (R - 1) // order
    return pow(_GEN, exp, R)


def _batch_inverse(xs: List[int]) -> List[int]:
    """Montgomery batch inversion: one pow, 3(n-1) muls."""
    prefix = [1] * (len(xs) + 1)
    for i, x in enumerate(xs):
        prefix[i + 1] = prefix[i] * x % R
    inv_all = pow(prefix[-1], R - 2, R)
    out = [0] * len(xs)
    for i in range(len(xs) - 1, -1, -1):
        out[i] = prefix[i] * inv_all % R
        inv_all = inv_all * xs[i] % R
    return out


def _bit_reverse(n: int, bits: int) -> int:
    out = 0
    for _ in range(bits):
        out = (out << 1) | (n & 1)
        n >>= 1
    return out


class Kzg:
    def __init__(self, g1_lagrange: List[tuple], g2_tau: tuple, domain: List[int]):
        self.n = len(g1_lagrange)
        self.g1_lagrange = g1_lagrange  # setup in evaluation (Lagrange) basis
        self.g2_tau = g2_tau
        self.domain = domain            # bit-reversed roots of unity

    # ----------------------------------------------------------------- setup

    # The production ceremony file (the reference's
    # common/eth2_network_config/built_in_network_configs/trusted_setup.json),
    # shipped inside the package.
    PRODUCTION_SETUP_PATH = os.path.join(
        os.path.dirname(__file__), "data", "trusted_setup.json"
    )
    _production_cache = None

    @classmethod
    def load_trusted_setup(cls, path: Optional[str] = None,
                           validate: bool = True) -> "Kzg":
        """Load the PRODUCTION trusted setup: 4096 Lagrange-basis G1 points
        (file order is natural w^i order with the generator-7 root
        convention, bit-reversal permuted here to match this class's domain
        layout) plus g2_monomial[1] = [tau]G2.

        `validate` checks the structural anchors: sum of Lagrange points
        equals the G1 generator (sum_i L_i(X) = 1), and g2_monomial[0] is
        the G2 generator."""
        # Only a validated load of the default file is cached: an unvalidated
        # or path-overridden setup must never be handed to later callers.
        cacheable = path is None and validate
        if cacheable and cls._production_cache is not None:
            return cls._production_cache
        with open(path or cls.PRODUCTION_SETUP_PATH) as f:
            d = json.load(f)
        g1_nat = [
            cv.g1_from_compressed(bytes.fromhex(h[2:]))
            for h in d["g1_lagrange"]
        ]
        g2_points = d["g2_monomial"]
        g2_tau = cv.g2_from_compressed(bytes.fromhex(g2_points[1][2:]))
        n = len(g1_nat)
        if n & (n - 1):
            raise KzgError("setup size must be a power of two")
        if validate:
            acc = None
            for pt in g1_nat:
                acc = cv.g1_add(acc, pt)
            if acc != cv.G1_GEN:
                raise KzgError("setup anchor failed: sum(L_i) != G1 gen")
            if cv.g2_from_compressed(bytes.fromhex(g2_points[0][2:])) != \
                    cv.G2_GEN:
                raise KzgError("setup anchor failed: g2[0] != G2 gen")
        w = _root_of_unity(n)
        bits = n.bit_length() - 1
        domain = [pow(w, _bit_reverse(i, bits), R) for i in range(n)]
        g1_brp = [g1_nat[_bit_reverse(i, bits)] for i in range(n)]
        out = cls(g1_brp, g2_tau, domain)
        if cacheable:
            cls._production_cache = out
        return out

    @classmethod
    def insecure_dev_setup(cls, n: int, tau: int = 0x0BADD00D5EED) -> "Kzg":
        """Deterministic dev setup with KNOWN tau (never for production)."""
        w = _root_of_unity(n)
        bits = n.bit_length() - 1
        domain = [pow(w, _bit_reverse(i, bits), R) for i in range(n)]
        # Lagrange basis at tau: L_i(tau) = (tau^n - 1) * w_i / (n * (tau - w_i))
        tau_n = pow(tau, n, R)
        lag = []
        for wi in domain:
            num = (tau_n - 1) * wi % R
            den = n * (tau - wi) % R
            lag.append(num * pow(den, R - 2, R) % R)
        g1_lagrange = [cv.g1_mul(cv.G1_GEN, li) for li in lag]
        g2_tau = cv.g2_mul(cv.G2_GEN, tau)
        return cls(g1_lagrange, g2_tau, domain)

    # ------------------------------------------------------------- encoding

    @staticmethod
    def blob_to_field_elements(blob: bytes) -> List[int]:
        if len(blob) % BYTES_PER_FIELD_ELEMENT:
            raise KzgError("blob length not a multiple of 32")
        out = []
        for i in range(0, len(blob), BYTES_PER_FIELD_ELEMENT):
            fe = int.from_bytes(blob[i:i + 32], "big")
            if fe >= R:
                raise KzgError("blob element not canonical")
            out.append(fe)
        return out

    def _check_len(self, evals: Sequence[int]) -> None:
        if len(evals) != self.n:
            raise KzgError(f"expected {self.n} field elements, got {len(evals)}")

    # ----------------------------------------------------------- commitment

    def _msm(self, scalars: Sequence[int]) -> tuple:
        """MSM over the Lagrange setup (host oracle)."""
        acc = None
        for pt, s in zip(self.g1_lagrange, scalars):
            if s == 0:
                continue
            term = cv.g1_mul(pt, s)
            if term is None:
                continue
            acc = term if acc is None else cv.g1_add(acc, term)
        return acc

    def blob_to_kzg_commitment(self, blob: bytes) -> tuple:
        evals = self.blob_to_field_elements(blob)
        self._check_len(evals)
        return self._msm(evals)

    # ---------------------------------------------------------- evaluation

    def evaluate_polynomial(self, evals: Sequence[int], z: int) -> int:
        """Barycentric evaluation on the bit-reversed domain. The n per-term
        denominators invert in ONE modular inversion via Montgomery's batch
        trick (4096 Fermat inversions would dominate the whole verify)."""
        self._check_len(evals)
        for i, wi in enumerate(self.domain):
            if z == wi:
                return evals[i]
        zn = (pow(z, self.n, R) - 1) % R
        denoms = [(z - wi) % R for wi in self.domain]
        inv_denoms = _batch_inverse(denoms)
        total = 0
        for ev, wi, inv_d in zip(evals, self.domain, inv_denoms):
            total = (total + ev * wi % R * inv_d) % R
        return total * zn % R * pow(self.n, R - 2, R) % R

    # --------------------------------------------------------------- proofs

    def compute_kzg_proof(self, blob: bytes, z: int) -> Tuple[tuple, int]:
        """-> (proof_point, y = p(z)). Quotient in evaluation form:
        q_i = (p_i - y) / (w_i - z)."""
        evals = self.blob_to_field_elements(blob)
        self._check_len(evals)
        y = self.evaluate_polynomial(evals, z)
        q = []
        for ev, wi in zip(evals, self.domain):
            if wi == z:
                q.append(0)  # handled below via special-casing
                continue
            q.append((ev - y) * pow((wi - z) % R, R - 2, R) % R)
        if z in self.domain:
            # On-domain z: the c-kzg on-domain quotient formula.
            j = self.domain.index(z)
            qj = 0
            for i, (ev, wi) in enumerate(zip(evals, self.domain)):
                if i == j:
                    continue
                term = (ev - y) * wi % R
                term = term * pow((z * ((z - wi) % R)) % R, R - 2, R) % R
                qj = (qj + term) % R
            q[j] = qj
        return self._msm(q), y

    def compute_blob_kzg_proof(self, blob: bytes, commitment: tuple) -> tuple:
        z = self._challenge(blob, commitment)
        proof, _y = self.compute_kzg_proof(blob, z)
        return proof

    # --------------------------------------------------------------- verify

    def batch_inputs(self, blobs: Sequence[bytes], commitments: Sequence[tuple],
                     proofs: Sequence[tuple]) -> Tuple[List[int], List[int], int]:
        """The host half of the batch verify: each blob's challenge z_i, its
        evaluation y_i = p_i(z_i), and the batch challenge r."""
        zs, ys = [], []
        for blob, commitment in zip(blobs, commitments):
            z = self._challenge(blob, commitment)
            zs.append(z)
            ys.append(self.evaluate_polynomial(
                self.blob_to_field_elements(blob), z
            ))
        return zs, ys, self._batch_challenge(commitments, zs, ys, proofs)

    def verify_kzg_proof(self, commitment: tuple, z: int, y: int, proof: tuple,
                         device=None) -> bool:
        """e(C - yG1, -G2) * e(W, tau G2 - z G2) == 1, checked on `device`
        (default: the card) as the batch check at n = 1:
        e(C - yG1 + zW, -G2) * e(W, tau G2) == 1 is the same product."""
        return verify_kzg_batch_gpu([commitment], [z], [y], [proof], 1, self.g2_tau,
                                    device=device)

    def verify_blob_kzg_proof(self, blob: bytes, commitment: tuple, proof: tuple,
                              device=None) -> bool:
        """The blob's challenge z and evaluation y = p(z) on the host, then
        verify_kzg_proof on `device` (default: the card, resolved before
        the host work, so that it raises without one)."""
        device = _limbs.default_device(device)
        z = self._challenge(blob, commitment)
        evals = self.blob_to_field_elements(blob)
        y = self.evaluate_polynomial(evals, z)
        return self.verify_kzg_proof(commitment, z, y, proof, device=device)

    def verify_blob_kzg_proof_batch(
        self, blobs: Sequence[bytes], commitments: Sequence[tuple],
        proofs: Sequence[tuple], device=None,
    ) -> bool:
        """Random linear combination -> ONE pairing-product check
        (verify_blob_kzg_proof_batch, crypto/kzg/src/lib.rs:81). The G1
        combination and the pairing run on `device` (default: the card)."""
        if not (len(blobs) == len(commitments) == len(proofs)):
            raise KzgError("length mismatch")
        if not blobs:
            return True
        zs, ys, r = self.batch_inputs(blobs, commitments, proofs)
        return verify_kzg_batch_gpu(commitments, zs, ys, proofs, r, self.g2_tau,
                                    device=device)

    # ------------------------------------------------------------ challenges

    def _challenge(self, blob: bytes, commitment: tuple) -> int:
        """compute_challenge per the deneb KZG spec (c-kzg-4844): domain ||
        degree as a 16-byte big-endian int || blob || commitment, hashed to
        a field element."""
        h = hashlib.sha256()
        h.update(b"FSBLOBVERIFY_V1_")
        h.update((len(blob) // BYTES_PER_FIELD_ELEMENT).to_bytes(16, "big"))
        h.update(blob)
        h.update(cv.g1_to_compressed(commitment))
        return int.from_bytes(h.digest(), "big") % R

    def _batch_challenge(self, commitments, zs, ys, proofs) -> int:
        """compute_r_powers framing per the spec: domain ||
        FIELD_ELEMENTS_PER_BLOB (8 bytes) || n (8 bytes) || per-proof
        fields."""
        h = hashlib.sha256()
        h.update(b"RCKZGBATCH___V1_")
        h.update(len(self.domain).to_bytes(8, "big"))
        h.update(len(commitments).to_bytes(8, "big"))
        for c, z, y, w in zip(commitments, zs, ys, proofs):
            h.update(cv.g1_to_compressed(c))
            h.update(z.to_bytes(32, "big"))
            h.update(y.to_bytes(32, "big"))
            h.update(cv.g1_to_compressed(w))
        return int.from_bytes(h.digest(), "big") % R
