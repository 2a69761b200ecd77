"""One JSON result schema for every probe script.

Every consumer of a probe's output (CI greps, a restart probe's parent
process, humans diffing runs) parses one envelope. This module is the
single producer: `make()` builds the envelope, `emit()` prints it as one JSON
line (machine-parseable: the only stdout line starting with `{"schema"`),
and `finish()` stamps wall time + optional metric snapshots.

Envelope (`lighthouse_tpu.probe_report/v1`):
    schema        fixed version tag
    probe         script name ("probe_bm", ...)
    ok            overall pass/fail
    started_unix  epoch seconds at make()
    wall_seconds  stamped by finish()
    env           backend/device/layout facts (best-effort)
    params        the knobs this run used
    results       probe-specific payload (list or dict)
    trace_path    set when a Chrome trace was exported alongside

A copy of ``lighthouse_tpu/observability/report.py`` whose environment
facts come from torch instead of jax.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, Optional

# The JAX package's tag: the envelope's keys and their meaning are the
# same, so one consumer (`parse_lines`, a CI grep, a parent process) reads
# the reports of both packages; `env` says which produced a line (torch's
# facts here, jax's there).
SCHEMA = "lighthouse_tpu.probe_report/v1"


def _env_facts() -> Dict[str, Any]:
    """The device and toolchain facts: torch and CUDA versions, the CUDA
    device count and the first device's name (best-effort, never raises)."""
    facts: Dict[str, Any] = {}
    try:
        import torch

        facts["torch_version"] = torch.__version__
        facts["cuda_version"] = torch.version.cuda
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        facts["device_count"] = count
        if count:
            facts["device_name"] = torch.cuda.get_device_name(0)
    except Exception:
        pass
    return facts


def make(probe: str, params: Optional[Dict[str, Any]] = None,
         **extra) -> Dict[str, Any]:
    report: Dict[str, Any] = {
        "schema": SCHEMA,
        "probe": probe,
        "ok": True,
        "started_unix": round(time.time(), 3),
        "env": _env_facts(),
        "params": dict(params or {}),
        "results": {},
    }
    report.update(extra)
    return report


def finish(report: Dict[str, Any], ok: Optional[bool] = None,
           results: Any = None) -> Dict[str, Any]:
    if ok is not None:
        report["ok"] = bool(ok)
    if results is not None:
        report["results"] = results
    report["wall_seconds"] = round(
        time.time() - report["started_unix"], 3)
    return report


def emit(report: Dict[str, Any], stream=None) -> str:
    """Print the report as one JSON line and return it. Keys stay in
    insertion order so `schema` leads the line — consumers match on the
    `{"schema"` prefix."""
    line = json.dumps(report)
    print(line, file=stream or sys.stdout, flush=True)
    return line


def parse_lines(text: str) -> list:
    """All probe reports found in a blob of mixed stdout."""
    out = []
    for line in text.splitlines():
        line = line.strip()
        if line.startswith('{"schema"'):
            try:
                doc = json.loads(line)
            except ValueError:
                continue
            if doc.get("schema") == SCHEMA:
                out.append(doc)
    return out
