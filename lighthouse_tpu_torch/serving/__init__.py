"""The serving path in front of the card, counterparts of the JAX
package's ``serving/`` modules:

  * `scheduler` — the continuous-batch scheduler: accumulate against the
                  slot clock, close on bucket-full or deadline.
  * `router`    — the cost-model router: small or deadline-critical
                  batches to the native CPU verifier, bulk to the card.
  * `autotune`  — the online control loop re-picking the scheduler /
                  router / bucket-menu knobs from windowed metric
                  evidence, persisted into the bundle manifest.
  * `aot`       — that manifest's policy only: the JAX package's
                  ``jax.export`` warm bundles have no port, since CUDA
                  graphs do not serialize.

Submodules import lazily (PEP 562), as in the JAX package.
"""

_SUBMODULES = ("aot", "router", "scheduler", "autotune")

__all__ = [
    "aot", "router", "scheduler", "autotune",
    "ContinuousBatchScheduler", "VerifyJob",
    "CostModelRouter", "LatencyTable",
    "Autotuner", "apply_policy",
]

_EXPORTS = {
    "ContinuousBatchScheduler": ("scheduler", "ContinuousBatchScheduler"),
    "VerifyJob": ("scheduler", "VerifyJob"),
    "CostModelRouter": ("router", "CostModelRouter"),
    "LatencyTable": ("router", "LatencyTable"),
    "Autotuner": ("autotune", "Autotuner"),
    "apply_policy": ("autotune", "apply_policy"),
}


def __getattr__(name):
    import importlib

    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    if name in _EXPORTS:
        mod, attr = _EXPORTS[name]
        return getattr(importlib.import_module(f".{mod}", __name__), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
