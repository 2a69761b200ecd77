"""lighthouse_tpu_torch: the PyTorch/CUDA port of lighthouse_tpu for an
NVIDIA H100.

Slice 1 holds the main path, batch BLS12-381 signature-set verification:
``crypto.bls.api.verify_signature_sets`` with the backend ``"gpu"``
(``ops.backend``), built on the field, tower, curve, hash-to-curve and
pairing layers in ``ops/`` and the hand-written CUDA kernels of
``ops/csrc``. The package imports torch and never jax, and nothing of
lighthouse_tpu.
"""
