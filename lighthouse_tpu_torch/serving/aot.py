"""The warm-bundle manifest, as far as the port has one: the persisted
autotune policy.

Counterpart: ``lighthouse_tpu/serving/aot.py`` :593-634 (``MANIFEST_NAME``,
``BUNDLE_VERSION``, ``_write_manifest``, ``save_policy``, ``load_policy``),
copied with its file format, so that a policy saved by either package is
read by the other:

    <dir>/manifest.json   {"bundle_version", "entries", "stages", "policy", ...}

The JAX package also writes ``jax.export`` stage artifacts into that
directory (its ``entries`` and ``stages``). The port has none: CUDA graphs
do not serialize. A restarted port node gets its kernels from the nvcc
library cache (``ops/_build.py``), its native verifier from the g++ build
cache (``native/``), and captures the grid its persisted policy asks for
(``beacon_processor/warming.tuned_shape_grid``). ``save_policy`` keeps any
entries a JAX producer wrote.
"""

from __future__ import annotations

import json
import os
from typing import Optional

BUNDLE_VERSION = 1
MANIFEST_NAME = "manifest.json"


def _write_manifest(path: str, manifest: dict) -> None:
    mpath = os.path.join(path, MANIFEST_NAME)
    tmp = mpath + f".tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    os.replace(tmp, mpath)


def _read_manifest(path: str) -> Optional[dict]:
    try:
        with open(os.path.join(path, MANIFEST_NAME), "rb") as f:
            return json.loads(f.read())
    except (OSError, ValueError):
        return None


def save_policy(path: str, policy: dict) -> None:
    """Store an autotune policy under `manifest["policy"]`, preserving any
    existing bundle entries/stages (the producer and the autotuner share
    one manifest). Writes a skeleton manifest when none exists yet — a
    node can persist its learned policy before it ever exports a stage."""
    os.makedirs(path, exist_ok=True)
    manifest = _read_manifest(path)
    if not isinstance(manifest, dict):
        manifest = {"bundle_version": BUNDLE_VERSION, "entries": {}, "stages": {}}
    manifest["policy"] = dict(policy)
    _write_manifest(path, manifest)


def load_policy(path: str) -> Optional[dict]:
    """Read back a persisted policy, or None. Not staleness-gated: the
    policy is measured fact about traffic and hardware, not compiled
    code."""
    manifest = _read_manifest(path)
    policy = manifest.get("policy") if isinstance(manifest, dict) else None
    return policy if isinstance(policy, dict) else None
