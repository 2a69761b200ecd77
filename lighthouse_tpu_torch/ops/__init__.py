"""Device layers of the port, batch-minor throughout: limbs (Fp), tower
(Fp2/Fp6/Fp12), curves (G1/G2), h2c (hash to G2), pairing, backend (the
three-stage batch verify) and kzg, with the CUDA kernels of csrc/ behind
fused, and each bucket's stages replayed as CUDA graphs (graphs)."""
