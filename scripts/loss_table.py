"""The loss table of a headline verify from one chip_smoke.py log.

    python3 scripts/loss_table.py chiprun_out/smoke.log

Loss is launches x (card ms - bound ms), summed over each operand shape the
headline's eager verify gave a kernel (the `verify` phase's
launches_by_shape). A shape's times come from the `kernels` phase: K7 and
the main-path shapes (K1_SHAPES ... K6_SHAPES) where timed at that exact
shape, else the kernel's time at the nearest n of NS, its bound scaled to
the shape's n. K4's fp_lincomb is timed per plan (`by_plan`), and the verify
records its launches by first operand shape only: a shape takes the mean
over the plans of their times and bounds at the nearest n. Prints one JSON
line a kernel, largest loss first, then the total. Reads the log only: it
runs anywhere.
"""

import ast
import json
import sys
from collections import defaultdict


def _load(path):
    phases = defaultdict(list)
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("{"):
                try:
                    d = json.loads(line)
                except json.JSONDecodeError:
                    continue
                phases[d.get("phase")].append(d)
    return phases


def loss_table(path):
    phases = _load(path)
    times = {}
    for d in phases["kernels"]:
        if "kernel" in d:
            t = times.setdefault(d["kernel"], {"by_n": {}, "by_shape": {}})
            for key in ("by_n", "by_shape"):
                t[key].update(d.get(key, {}))
            for n in d.get("ns", ()) if "by_plan" in d else ():
                at = [rows[str(n)] for rows in d["by_plan"].values() if str(n) in rows]
                if at:
                    t["by_n"][str(n)] = {k: sum(r[k] for r in at) / len(at)
                                         for k in ("ms", "bound_ms")}
    rows = defaultdict(lambda: {"launches": 0, "loss_ms": 0.0, "ms_at": {}})
    for name, shapes in phases["verify"][0]["headline"]["launches_by_shape"].items():
        for key, count in shapes.items():
            shape = ast.literal_eval(key)
            t = times[name]
            at = t["by_shape"].get(str(shape))
            if at is not None:
                ms, bound = at["ms"], at["bound_ms"]
            else:
                n = shape[-1]
                near = min(t["by_n"], key=lambda m: abs(int(m) - n))
                ms, bound = t["by_n"][near]["ms"], t["by_n"][near]["bound_ms"] * n / int(near)
            row = rows[name]
            row["launches"] += count
            row["loss_ms"] += count * (ms - bound)
            row["ms_at"][str(shape)] = ms
    return sorted(rows.items(), key=lambda kv: -kv[1]["loss_ms"])


def main(argv) -> int:
    if len(argv) != 2:
        print("usage: loss_table.py <chip_smoke log>", file=sys.stderr)
        return 2
    table = loss_table(argv[1])
    for name, row in table:
        top = sorted(row["ms_at"].items(), key=lambda kv: -kv[1])[:3]
        print(json.dumps({"kernel": name, "launches": row["launches"],
                          "loss_ms": round(row["loss_ms"], 4),
                          "ms_at_shapes": {k: round(v, 5) for k, v in top}}))
    print(json.dumps({"total_loss_ms": round(sum(r["loss_ms"] for _, r in table), 3)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
