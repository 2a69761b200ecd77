"""The port stands alone: no file of lighthouse_tpu_torch, and not
chip_smoke.py, imports jax or lighthouse_tpu; importing the port loads
neither; and without a card its entry points raise instead of running on
the CPU."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "lighthouse_tpu_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "lighthouse_tpu")


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            bad += [a.value for a in node.args
                    if isinstance(a, ast.Constant) and isinstance(a.value, str) and _forbidden(a.value)]
    assert not bad, f"{path}: imports {bad}"


_PROBE = r"""
import importlib, json, pkgutil, sys
before = set(sys.modules)
import lighthouse_tpu_torch
names = ["lighthouse_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    lighthouse_tpu_torch.__path__, "lighthouse_tpu_torch.")]
for name in names:
    importlib.import_module(name)
new = sorted(set(sys.modules) - before)
print(json.dumps({"imported": names, "new": new}))
"""


def test_importing_the_port_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert "lighthouse_tpu_torch.ops.backend" in report["imported"]
    assert [m for m in report["new"] if _forbidden(m)] == []


def test_default_device_raises_without_a_card(monkeypatch):
    import torch

    from lighthouse_tpu_torch.ops import h2c, limbs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        limbs.default_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        h2c.hash_to_g2([b"m"])
    assert limbs.default_device("cpu") == torch.device("cpu")
