"""lighthouse_tpu_torch: the PyTorch/CUDA port of lighthouse_tpu for an
NVIDIA H100.

Slice 1 holds the main path, batch BLS12-381 signature-set verification:
``crypto.bls.api.verify_signature_sets`` with the backend ``"gpu"``
(``ops.backend``), built on the field, tower, curve, hash-to-curve and
pairing layers in ``ops/`` and the hand-written CUDA kernels of
``ops/csrc``. In front of it runs the serving path: the batch former
(``beacon_processor``), the continuous-batch scheduler and the cost-model
router (``serving``), which sends small batches to the native CPU verifier
(backend ``"cpu"``). A batch of up to 16384 sets may also be verified over
a mesh of devices (``parallel``). The package imports torch and never jax,
and nothing of lighthouse_tpu.
"""
