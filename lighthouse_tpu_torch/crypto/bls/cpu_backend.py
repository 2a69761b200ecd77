"""The native C++ batch verifier on the host: the port's backend "cpu".

Counterpart: ``lighthouse_tpu/crypto/bls/cpu_backend.py`` (:32-121). The
library is the port's copy of ``native/src/blscpu.cpp``, a C++ port of the
pure-Python oracle (the same tower, batch equation

    prod_i e([r_i] agg_pk_i, H(m_i)) * e(-g1, sum_i [r_i] sig_i) == 1

and RFC 9380 hash to curve) in 6x64-bit Montgomery arithmetic, built by
``native.load`` on its first use. A handful of gossip-latency sets should
not pay a device dispatch and bucket padding: the serving router
(``serving/router.py``) sends small and deadline-critical batches here.
The ``gpu`` backend never does.
"""

import ctypes
import secrets
from typing import Sequence

from ...native import load
from . import api
from .constants import RAND_BITS

_lib = None

_U8P = ctypes.POINTER(ctypes.c_uint8)


def get_lib():
    """Build (once per source) and load the native verifier."""
    global _lib
    if _lib is None:
        lib = load("blscpu")
        lib.blscpu_init.argtypes = []
        lib.blscpu_init.restype = ctypes.c_int
        lib.blscpu_verify_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint32), ctypes.c_char_p,
            _U8P, _U8P, ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint32]
        lib.blscpu_verify_batch.restype = ctypes.c_int
        lib.blscpu_hash_to_g2.argtypes = [ctypes.c_char_p, ctypes.c_uint32, _U8P]
        lib.blscpu_hash_to_g2.restype = ctypes.c_int
        lib.blscpu_g2_in_subgroup.argtypes = [ctypes.c_char_p, ctypes.c_uint8]
        lib.blscpu_g2_in_subgroup.restype = ctypes.c_int
        lib.blscpu_init()
        _lib = lib
    return _lib


def _enc48(x: int) -> bytes:
    return x.to_bytes(48, "big")


def _enc_g1(pt) -> bytes:
    return _enc48(pt[0]) + _enc48(pt[1])


def _enc_g2(pt) -> bytes:
    (x0, x1), (y0, y1) = pt
    return _enc48(x0) + _enc48(x1) + _enc48(y0) + _enc48(y1)


def verify_signature_sets_cpu(sets: Sequence["api.SignatureSet"], device=None) -> bool:
    """Batch verify on the native host path (`device` is not used: the
    host runs it). Host-side early-outs replicate the oracle's rejects
    (empty batch, empty signing_keys, infinity signature), like the gpu
    backend's."""
    sets = list(sets)
    if not sets:
        return False
    for s in sets:
        if not s.signing_keys:
            return False
        if s.signature.point is None:
            return False
        if any(pk.point is None for pk in s.signing_keys):
            # Infinity pubkey: the oracle aggregates it on the host; the
            # native ABI carries no per-key infinity flag.
            return api.verify_signature_sets_oracle(sets)

    if any(len(s.message) != 32 for s in sets):
        # Non-32-byte messages never occur on consensus paths; the ABI is
        # fixed-stride, so odd shapes go to the oracle (checked per set:
        # compensating lengths must not slip through as misaligned 32-byte
        # windows).
        return api.verify_signature_sets_oracle(sets)
    lib = get_lib()
    n = len(sets)
    msgs = b"".join(s.message for s in sets)
    pks = b"".join(b"".join(_enc_g1(pk.point) for pk in s.signing_keys) for s in sets)
    counts = (ctypes.c_uint32 * n)(*[len(s.signing_keys) for s in sets])
    sigs = b"".join(_enc_g2(s.signature.point) for s in sets)
    inf = (ctypes.c_uint8 * n)(*([0] * n))
    chk = (ctypes.c_uint8 * n)(*[1 if s.signature.subgroup_checked else 0 for s in sets])
    scalars = (ctypes.c_uint64 * n)()
    for i in range(n):
        r = 0
        while r == 0:
            r = secrets.randbits(RAND_BITS)
        scalars[i] = r
    res = lib.blscpu_verify_batch(msgs, pks, counts, sigs, inf, chk, scalars, n)
    if res < 0:
        raise api.BlsError("native verifier rejected point encoding")
    return res == 1


def hash_to_g2_native(msg: bytes):
    """Native hash_to_curve -> affine G2 point, or None at infinity."""
    lib = get_lib()
    out = (ctypes.c_uint8 * 192)()
    if lib.blscpu_hash_to_g2(msg, len(msg), out) == 0:
        return None
    b = bytes(out)
    return ((int.from_bytes(b[0:48], "big"), int.from_bytes(b[48:96], "big")),
            (int.from_bytes(b[96:144], "big"), int.from_bytes(b[144:192], "big")))


api.register_backend("cpu", verify_signature_sets_cpu)
