#!/usr/bin/env python3
"""A second witness for the check: where do the program and the plain
reference part?  One batch of the cell's timed shape goes through the
program's engine, every value of the layer list kept; then each layer of
the reference is run twice on each block of images:

- *local*: on the program's own values of what the layer reads, so that
  only this layer's arithmetic can differ;
- *chained*: on the reference's own values, as the check runs it.

For a value the program holds as an int8 grid the difference is counted
in grid steps (the share of elements off, and the largest step); for any
other value, as the largest difference over the largest magnitude.

    python3 gpubench/witness.py --workload <name> --seed <n> [--images 128]

prints one JSON line per layer and a summary line.  It is a diagnostic:
no run of the benchmark calls it."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
for _p in (BENCH_DIR.parent, BENCH_DIR):     # the program, the benchmark
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

BLOCK = 32


def _nchw(t):
    return (t.permute(0, 3, 1, 2) if t.dim() == 4 else t).float()


def compare_layers(cell, x, images: int):
    """Per-layer rows for the first ``images`` images of batch ``x``."""
    import torch

    import program
    from reference import _qnet

    layers = cell.layers
    names = [L["name"] for L in layers]
    port, port_scales = program.values(cell.engine, x, names)
    cell.engine = None
    amax = _qnet.calibrate(layers, cell.params, cell.calib)
    net = _qnet.Quantized(layers, cell.params, amax, 8,
                          cell.cfg["engine"]["compute_dtype"])
    stats = {n: {"n": 0, "local_off": 0, "local_max": 0.0,
                 "chain_off": 0, "chain_max": 0.0} for n in names}

    def as_ref(v, rows):
        """The program's value ``v`` as the reference holds it: a value the
        program keeps in a float type where the reference keeps a grid is
        put on the grid, as the program's readers quantize it."""
        t = port[v][rows]
        if v in net.grid and t.dtype != torch.int8:
            return net._quant(_nchw(t), net.grid[v])
        return _nchw(t)

    def diff(got, want, v):
        if v in net.grid:
            d = (got - want).abs()
            return int((d > 0).sum()), float(d.max())
        d = float((got - want).abs().max())
        return 0, d / max(float(want.abs().max()), 1e-30)

    with torch.inference_mode():
        for b in range(0, images, BLOCK):
            rows = slice(b, min(b + BLOCK, images))
            chain = {"data": _nchw(x[rows])}
            for L in layers:
                name = L["name"]
                local = {v: (chain["data"] if v == "data" else as_ref(v, rows))
                         for v in (L.get("srcs") or [L["src"]])}
                net.apply(L, local)
                net.apply(L, chain)
                want = as_ref(name, rows)
                s = stats[name]
                s["n"] += want.numel()
                off, mx = diff(local[name], want, name)
                s["local_off"] += off
                s["local_max"] = max(s["local_max"], mx)
                off, mx = diff(chain[name], want, name)
                s["chain_off"] += off
                s["chain_max"] = max(s["chain_max"], mx)
            del chain
    rows = []
    for L in layers:
        name, s = L["name"], stats[L["name"]]
        ps = port_scales.get(name)
        rows.append({
            "layer": name, "op": L["op"], "grid": name in net.grid,
            "program_dtype": str(port[name].dtype).replace("torch.", ""),
            "scale_rel_diff": (abs(ps / net.grid[name] - 1.0)
                               if ps and name in net.grid else None),
            "local_off_share": s["local_off"] / s["n"],
            "local_max": s["local_max"],
            "chain_off_share": s["chain_off"] / s["n"],
            "chain_max": s["chain_max"]})
    return rows


def summary(rows) -> dict:
    grid = [r for r in rows if r["grid"]]
    other = [r for r in rows if not r["grid"]]
    first = next((r["layer"] for r in grid if r["chain_off_share"] > 0), None)
    return {
        "grid_layers": len(grid),
        "grid_here_float_there": [r["layer"] for r in grid
                                  if r["program_dtype"] != "int8"],
        "local_max_steps": max(r["local_max"] for r in grid),
        "local_off_share_max": max(r["local_off_share"] for r in grid),
        "local_off_share_mean": sum(r["local_off_share"] for r in grid)
        / len(grid),
        "float_layers_local_rel_max": max((r["local_max"] for r in other),
                                          default=None),
        "first_chained_difference": first,
        "chain_off_share_last_grid": grid[-1]["chain_off_share"],
        "chain_max_steps": max(r["chain_max"] for r in grid),
        "scale_rel_diff_max": max((r["scale_rel_diff"] or 0.0)
                                  for r in grid)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--images", type=int, default=128)
    args = ap.parse_args(argv)
    import run
    run.set_cache_dirs(BENCH_DIR.parent)
    bench = json.loads((BENCH_DIR.parent / "BENCHMARK.json").read_text())
    cell, kind = run.build_cell(bench, args.workload, args.seed, 0.0, False,
                                "cuda:0")
    inputs, transfer = kind.inputs(cell)
    if transfer:
        raise SystemExit("the witness runs the engine on float batches")
    x = inputs[:cell.cfg["graph_batch"]]
    rows = compare_layers(cell, x, min(args.images, len(x)))
    for r in rows:
        print(json.dumps(r))
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "images": min(args.images, len(x)), **summary(rows)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
