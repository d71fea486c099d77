#!/usr/bin/env python3
"""The control of the check, and the faults it has to catch, at a cell's
own size:

    python3 gpubench/control.py --workload <name> --seeds 1,2,3
    python3 gpubench/control.py --workload <name> --seeds 1,2,3 --fault half_left_out --seconds 2

Without ``--fault``: the plain reference put in the program's place at
the nearest precision below the configuration's (int4 for its int8), on
the inputs a run of the cell compares, read as a run reads the program's
answers; no engine is built and nothing is timed.  With ``--fault``: a
whole run of the cell (``run.run_cell``) with that fault of ``faults.py``
planted in the timed path.  Prints one JSON line per seed with the
numbers compared and the cell's limits."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
for _p in (BENCH_DIR.parent, BENCH_DIR):     # the program, the benchmark
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def readings(bench: dict, workload: str, seed: int, device,
             bench_dir: Path = BENCH_DIR, bits: int = 4) -> dict:
    import torch

    import check
    import run

    cell, kind = run.build_cell(bench, workload, seed, 0.0, False, device,
                                bench_dir, engine=False)
    inputs, transfer = kind.inputs(cell)
    ref = check.reference_logits(cell, inputs, transfer)
    low = check.reference_logits(cell, inputs, transfer, bits=bits)
    served = torch.softmax(low, -1).to(torch.bfloat16).cpu()
    numbers = check.compare([(torch.arange(len(inputs)), served)], ref)
    return {"workload": workload, "seed": seed, "bits": bits, **numbers,
            "limits": check.limits(bench_dir, workload)}


def fault_readings(bench: dict, workload: str, seed: int, device,
                   fault: str, seconds: float,
                   bench_dir: Path = BENCH_DIR) -> dict:
    import faults
    import run

    r = run.run_cell(bench, workload, seed, seconds, False, device,
                     bench_dir, program=faults.broken_program(
                         faults.FAULTS[fault]))
    return {"workload": workload, "seed": seed, "fault": fault,
            "correct": r["correct"],
            **{k: v["value"] for k, v in r["checks"].items()},
            "limits": {k: v["limit"] for k, v in r["checks"].items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    import run
    run.set_cache_dirs(BENCH_DIR.parent)
    bench = json.loads((BENCH_DIR.parent / "BENCHMARK.json").read_text())
    for s in args.seeds.split(","):
        if args.fault:
            r = fault_readings(bench, args.workload, int(s), "cuda:0",
                               args.fault, args.seconds)
        else:
            r = readings(bench, args.workload, int(s), "cuda:0")
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
