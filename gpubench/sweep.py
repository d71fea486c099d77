#!/usr/bin/env python3
"""The sweep that finds a serving cell's knee: one engine, the cell's
traffic at each rate in turn, each with its own window, traced:

    python3 gpubench/sweep.py --config <config> --traffic <mix> --rates 1000,2000 --seconds 8

prints one JSON line per rate: the latency percentiles over every request
due in the window, the share answered by the window's close (half a
second of grace), the queue's depth at the close, the generator's
lateness, and the per-layer readings of the traced part.  The knee is the
highest rate with at least 99% served and a queue at the close no deeper
than one batch."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
for _p in (BENCH_DIR.parent, BENCH_DIR):     # the program, the benchmark
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    import run
    run.set_cache_dirs(BENCH_DIR.parent)
    from harness import idle_pct, load_json, percentile
    bench = json.loads((BENCH_DIR.parent / "BENCHMARK.json").read_text())
    name = f"{args.config}.{args.traffic}"
    bench["workloads"].append({"name": name, "config": args.config,
                               "traffic": args.traffic, "chips": 1})
    base = load_json(BENCH_DIR / "traffic" / f"{args.traffic}.json")
    cell, kind = run.build_cell(bench, name, args.seed, args.seconds, True,
                                "cuda:0", traffic=base)
    for rate in (float(r) for r in args.rates.split(",")):
        cell.traffic = dict(base, rate_per_s=rate)
        out = kind.run(cell)
        c, t = out.trace.counters, out.trace
        print(json.dumps({
            "rate_per_s": rate, **out.metrics,
            "attempted": out.attempted, "failed": out.failed,
            "served_pct": 100.0 * c["served_by_close"] / max(out.attempted, 1),
            "queue_depth_at_close": c["queue_depth_at_close"],
            "gen_late_ms_p99": percentile(t.late_s, 99) * 1e3,
            "batch_images": c["images"] / max(c["batches"], 1),
            "pad_pct": 100.0 * c["pad_images"] / max(
                c["images"] + c["pad_images"], 1),
            "device_idle_pct": idle_pct(t.profile)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
