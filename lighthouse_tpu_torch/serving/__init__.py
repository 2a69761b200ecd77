"""The serving path in front of the card: the continuous-batch scheduler
(``scheduler``), which closes a batch when its bucket fills or its
deadline comes, and the cost-model router (``router``), which sends small
or deadline-critical batches to the native CPU verifier and bulk to the
card. Counterparts of the JAX package's ``serving/scheduler.py`` and
``serving/router.py``; its AOT warm bundles (``serving/aot.py``) have no
port, since CUDA graphs do not serialize (ROADMAP A12)."""
