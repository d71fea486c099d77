#!/usr/bin/env python3
"""One run of one cell of the benchmark of ``feathercnn_tpu_torch`` on
NVIDIA GPUs:

    python3 gpubench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  ``BENCHMARK.json`` names the cell's
configuration (``gpubench/configs/<config>.json``) and traffic mix
(``gpubench/traffic/<mix>.json``, whose ``kind`` names its generator,
``gpubench/traffic/<kind>.py``); the configuration's ``architecture``
names its plain reference (``gpubench/reference/<architecture>.py``), each
per-layer metric its reader (``gpubench/metrics/<name>.py``) and the cell
its limits (``gpubench/limits/<workload>.json``).

The run makes its weights and inputs from the seed, builds the program's
engine, warms every shape its traffic uses, measures for ``--seconds``,
then checks every answer due in the window against the reference.  The
last line of standard output is the result as one JSON object; the last
lines of standard error are the numbers compared, each beside its limit.
With ``--trace 1`` the metrics are the per-layer ones, read with part of
the window profiled.  The program's build directories are kept at
``<checkout>/.gpubench_build``; PyTorch's host ops run on one OpenMP
thread."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
for _p in (BENCH_DIR.parent, BENCH_DIR):     # the program, the benchmark
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))
FORBIDDEN = ("jax", "jaxlib", "flax", "feathercnn_tpu")


def set_cache_dirs(root: Path) -> None:
    """Every build and kernel cache of the program at one fixed path
    inside the checkout."""
    build = root / ".gpubench_build"
    os.environ["FEATHERCNN_TPU_CACHE"] = str(build)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


def forbidden_modules():
    """Loaded modules whose top-level name, whole, is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def applies(metric: dict, workload: str, reported=()) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return not reported or metric.get("moves") in reported


def build_cell(bench: dict, workload: str, seed: int, seconds: float,
               trace: bool, device, bench_dir: Path = BENCH_DIR,
               program=None, t_start: float = None, traffic: dict = None,
               engine: bool = True):
    """The cell's entries, its seeded weights and calibration batches, and
    (where ``engine``) the program's engine built from them; returns (cell,
    traffic kind)."""
    import torch

    from harness import Cell, entry, load_json, load_module, sub_seed
    from reference import _qnet

    if program is None:
        import program
    root = bench_dir.parent
    wl = entry(bench["workloads"], workload, "workload")
    cfg = load_json(root / entry(bench["configs"], wl["config"],
                                 "configuration")["file"])
    if traffic is None:
        traffic = load_json(bench_dir / "traffic" / f"{wl['traffic']}.json")
    kind = load_module(bench_dir / "traffic" / f"{traffic['kind']}.py")
    arch = load_module(bench_dir / "reference" / f"{cfg['architecture']}.py")
    device = torch.device(device)

    _qnet.no_tf32()
    layers = arch.layers(cfg)
    params = _qnet.init_weights(layers, sub_seed(seed, 1), device,
                                cfg["channels"], cfg["input_hw"], cfg["init"])
    cal = cfg["calibration"]
    cell = Cell(workload, cfg, traffic, seed, seconds, trace, device,
                T_START if t_start is None else t_start, layers, params,
                [], program)
    cell.calib = [cell.images(cal["batch"], 2 + i)
                  for i in range(cal["batches"])]
    if engine:
        cell.engine = program.build_engine(cfg, params, cell.calib, device)
    return cell, kind


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device, bench_dir: Path = BENCH_DIR,
             program=None, t_start: float = None) -> dict:
    """One run; returns the result's fields, ``checks`` last.  Refuses
    (``SystemExit``, naming them) where JAX or the JAX package is loaded
    once everything that reads the run, the reference and the per-layer
    readers among them, has run."""
    import torch

    import check
    import flops
    from harness import load_module

    cell, kind = build_cell(bench, workload, seed, seconds, trace, device,
                            bench_dir, program, t_start)
    device, layers, cfg = cell.device, cell.layers, cell.cfg
    limits = check.limits(bench_dir, workload)
    wl = next(w for w in bench["workloads"] if w["name"] == workload)
    out = kind.run(cell)
    setup_s = out.window_open - cell.t_start

    cell.engine = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = check.reference_logits(cell, out.inputs, out.transfer)
    numbers = check.compare(out.answers, ref)
    correct = (out.failed == 0 and bool(out.answers)
               and all(numbers[k] <= limits[k] for k in numbers))

    e2e = {"setup_s": setup_s, **out.metrics}
    reported = [m["name"] for m in bench["end_to_end"]
                if applies(m, workload)]
    metrics = {}
    if not trace:
        for m in bench["end_to_end"]:
            if m["name"] in reported:
                v = e2e[m["name"]]
                metrics[m["name"]] = {
                    "value": v if math.isfinite(v) else None,
                    "unit": m["unit"]}
    else:
        out.trace.ops_per_image = flops.ops_per_image(layers, cfg)
        out.trace.least_s_per_image = flops.least_seconds_per_image(
            layers, cfg)
        for m in bench["per_layer"]:
            if applies(m, workload, reported):
                reader = load_module(bench_dir / "metrics" / f"{m['name']}.py")
                v = reader.read(out.trace)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": int(wl["chips"]),
           "memory_peak_bytes": int(out.memory_peak_bytes)}
    result = {"correct": correct, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": dev}
    prof = out.trace.profile
    if trace and prof is not None:
        from harness import breakdown, busy_us
        dev["busy_s"] = busy_us(prof) / 1e6
        dev["window_s"] = prof.seconds
        result["breakdown"] = breakdown(prof)
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                        for k in numbers}
    found = forbidden_modules()
    if found:
        raise SystemExit(f"loaded in the measuring process: {found}")
    return result


def power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = BENCH_DIR.parent
    bench_file = root / "BENCHMARK.json"
    if not bench_file.is_file():
        print(f"no {bench_file}", file=sys.stderr)
        return 2
    bench = json.loads(bench_file.read_text())
    chips = next((w["chips"] for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    set_cache_dirs(root)
    # PyTorch's host ops on one OpenMP thread, so that the thread feeding
    # the card shares the host's cores with no pool of the benchmark's own
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    smi = power_limit()
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda:0")
    print(f"card: {smi}", file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
