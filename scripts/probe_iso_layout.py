"""Probe two layouts of the 3-isogeny's constant products (ops/h2c.py
iso_map_homogeneous) on one card, inside the h2g2 stage graph.

    python3 scripts/probe_iso_layout.py

"one": the four polynomials' 16 products in one K2 call (the constants
(4, 4, 2, 12, 1) and the basis broadcast to (..., 4, 4, 2, 12, m) and
copied dense), their sums in one K4 launch. "four": a K2 call per
polynomial (its 4 constants broadcast to the basis's (..., 4, 2, 12, m)),
the four products the four operands of one K4 launch with the same plan.
Both are written out here; the program runs one of them.

At each m of MS (the headline's 64, 4096 and the wide bucket's 16384) the
h2g2 stage (2, 2, 12, m) -> (3, 2, 12, m) is run eagerly in each layout on
one input, outputs equal bit for bit to each other and to the program's
stage, with its peak of allocated bytes and its wrappers' launches;
then captured as the program captures it (graphs.StaticGraph, a pool of
its own), with the capture's pool bytes and nodes; then each graph's
replay timed by CUDA events in turns (one, four, four, one). Prints JSON
lines, the card's name and power limit first. Needs a CUDA card and nvcc.
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from lighthouse_tpu_torch.ops import backend, fused, graphs, h2c  # noqa: E402
from lighthouse_tpu_torch.ops import limbs as lb  # noqa: E402
from lighthouse_tpu_torch.ops import tower as tw  # noqa: E402

MS = (64, 4096, 16384)
REPS = 20


def _basis(xn, xd):
    """The isogeny's homogeneous basis (..., 4, 2, 12, m): xd^3, xn xd^2,
    xn^2 xd, xn^3, as ops/h2c.py forms it."""
    sq = tw.fp2_sqr(torch.stack([xn, xd], dim=-4))
    xn2, xd2 = sq.select(-4, 0), sq.select(-4, 1)
    m = tw.fp2_mul(torch.stack([xn2, xd2, xn2], dim=-4),
                   torch.stack([xn, xd, xd], dim=-4))
    xn3, xd3, xn2xd = m.select(-4, 0), m.select(-4, 1), m.select(-4, 2)
    return torch.stack([xd3, tw.fp2_mul(xn, xd2), xn2xd, xn3], dim=-4)


def _finish(sums, y):
    """The projective point from the four polynomials (..., 4, 2, 12, m)."""
    xnum, xden, ynum, yden = sums.unbind(-4)
    m2 = tw.fp2_mul(torch.stack([xnum, ynum, xden], dim=-4),
                    torch.stack([yden, y, yden], dim=-4))
    X, yyn, Z = m2.select(-4, 0), m2.select(-4, 1), m2.select(-4, 2)
    return h2c.cv.G2.pack(X, tw.fp2_mul(yyn, xden), Z)


def _iso_one(xn, xd, y):
    """The 16 constant products in one K2 call."""
    c = h2c.consts(xn.device)
    prod = tw.fp2_mul(c.iso, _basis(xn, xd).unsqueeze(-5))
    return _finish(fused.fp_lincomb(tw._terms(prod, 2), h2c._ISO_SUMS).unflatten(-3, (4, 2)), y)


def _iso_four(xn, xd, y):
    """A K2 call per polynomial, the four products one K4 launch's operands."""
    c = h2c.consts(xn.device)
    basis = _basis(xn, xd)
    prods = tuple(tw._terms(tw.fp2_mul(k, basis), 1) for k in (c.xn, c.xd, c.yn, c.yd))
    return _finish(fused.fp_lincomb(prods, h2c._ISO_SUMS).unflatten(-3, (4, 2)), y)


LAYOUTS = {"one": _iso_one, "four": _iso_four}
PROGRAM = h2c.iso_map_homogeneous


def _stage(layout):
    def run(u):
        h2c.iso_map_homogeneous = LAYOUTS[layout]
        try:
            return backend._h2g2(u)
        finally:
            h2c.iso_map_homogeneous = PROGRAM
    return run


def _replay_ms(graph) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    graph.replay()
    start.record()
    for _ in range(REPS):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_iso_layout: no CUDA device", file=sys.stderr)
        return 1
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    for m in MS:
        u = cs._rand_fp((2, 2, lb.L, m), gen)
        row = {"m": m}
        outs = {}
        for layout in LAYOUTS:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            before = dict(fused.launches)
            outs[layout] = _stage(layout)(u)
            torch.cuda.synchronize()
            row[f"{layout}_eager_peak_bytes"] = torch.cuda.max_memory_allocated() - base
            row[f"{layout}_launches"] = {k: v - before.get(k, 0) for k, v in fused.launches.items()
                                         if v != before.get(k, 0)}
        if not (torch.equal(outs["one"], outs["four"])
                and torch.equal(outs["one"], backend._h2g2(u))):
            raise AssertionError(f"layouts differ at m = {m}")
        del outs
        staged = {}
        for layout in LAYOUTS:
            g = graphs.StaticGraph(_stage(layout), [((2, 2, lb.L, m), lb.DTYPE)], "cuda",
                                   f"h2g2 {layout} m={m}", pool=torch.cuda.graph_pool_handle())
            g(u)
            row[f"{layout}_pool_bytes"] = g.stats["pool_bytes"]
            row[f"{layout}_nodes"] = g.stats["nodes"]
            staged[layout] = g
        if not torch.equal(staged["one"].outputs, staged["four"].outputs):
            raise AssertionError(f"replayed layouts differ at m = {m}")
        ms = {layout: [] for layout in LAYOUTS}
        for layout in ("one", "four", "four", "one"):
            ms[layout].append(_replay_ms(staged[layout].graph))
        row["replay_ms"] = ms
        print(json.dumps(row), flush=True)
        del staged
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
