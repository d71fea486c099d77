#!/usr/bin/env python3
"""The port's recorder (``feathercnn_tpu_torch.utils.profiling.record``) on
the benchmark's offline cells, on the card.  Each run is a cell's traced
run as ``gpubench/run.py --trace 1`` makes it (the same build, window and
profiled batches; the answers are not checked), with the recorder entered
inside the profiler's block around the profiled batches ("on") or not
("off"), in the order on, off, off, on for each pair:

    python3 tools/trace_probe.py [--workloads A,B] [--seed N]
        [--seconds S] [--pairs P] [--out FILE]

For each run it prints the benchmark's per-layer readings; for each "on"
run also what the recording gives on the profile's clock
(``gpubench/spans.py``): syncs per batch, the node constants made and
reused per batch and the share reused (the recorder's ``Kept`` records;
None on a tree without them), host ms in sync calls per batch,
device us per image by node op (``Eltwise`` among them), the grouped
convs by the route each took (the recorder's ``Route`` records: convs,
q, device us per image of their nodes' kernels and those kernels'
names), the stem's own reading (the device us per image of the kernels
joined to the first conv's node, by kernel, and ``stem_conv_int8``'s
launches and fallbacks per batch over the profiled batches; None on a
tree without that kernel), the syncs and the sync calls by node, and the
longest idle gaps named by the program's spans.  It checks, and exits 1 where a check fails:

- at least 99% of the kernel launches that lie inside ``run`` spans lie
  inside a ``node`` span;
- the clock anchor's bracket is under 20 us;
- the sync counter equals the runtime sync calls inside ``run`` spans
  (each one without a partner is listed with its node);
- at least 99% of the sub-window's device time is joined to a node or to
  the harness's copy of the probabilities to the host.

GPU only.  With ``--out``, everything it prints also goes to that file
as JSON."""

import argparse
import gc
import json
import os
import statistics
import sys
from collections import Counter, defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH_DIR = ROOT / "gpubench"
for _p in (str(BENCH_DIR), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

LAUNCH_SHARE, BRACKET_US, JOINED_SHARE = 0.99, 20.0, 0.99


class Recorded:
    """The harness's profiler with ``record()`` entered inside its block;
    keeps the last block's profiler and recording in ``kept``."""

    def __init__(self, prof, kept):
        self.prof, self.kept = prof, kept

    def __enter__(self):
        from feathercnn_tpu_torch.utils import profiling
        self.prof.__enter__()
        self.rec_cm = profiling.record()
        self.kept["rec"] = self.rec_cm.__enter__()
        self.kept["prof"] = self.prof
        self.kept["stem_counts"] = [stem_counts()]
        return self

    def __exit__(self, *exc):
        self.kept["stem_counts"].append(stem_counts())
        self.rec_cm.__exit__(*exc)
        return self.prof.__exit__(*exc)

    def __getattr__(self, name):
        return getattr(self.prof, name)


def stem_counts():
    """``stem_conv_int8``'s (launches, fallbacks), or None where the
    program has no stem kernel."""
    try:
        from feathercnn_tpu_torch.kernels.stem import stem_conv_int8
    except ImportError:
        return None
    return stem_conv_int8.launches, stem_conv_int8.fallbacks


def traced_run(bench, workload, seed, seconds, record, device="cuda:0",
               bench_dir=BENCH_DIR):
    """One traced run: (the per-layer readings, the profile, the kept
    profiler and recording where ``record``)."""
    import torch

    import flops
    import harness
    import run
    from harness import load_module

    kept, real = {}, harness.profiler
    if record:
        harness.profiler = lambda device: Recorded(real(device), kept)
    try:   # the traffic kind binds the harness's profiler as it loads
        cell, kind = run.build_cell(bench, workload, seed, seconds, True,
                                    device, bench_dir)
        out = kind.run(cell)
    finally:
        harness.profiler = real
    kept["stem_node"] = next(n.name for n in cell.engine.graph.nodes
                             if n.op == "Convolution")
    tr = out.trace
    tr.ops_per_image = flops.ops_per_image(cell.layers, cell.cfg)
    tr.least_s_per_image = flops.least_seconds_per_image(cell.layers,
                                                         cell.cfg)
    reported = [m["name"] for m in bench["end_to_end"]
                if run.applies(m, workload)]
    metrics = {}
    for m in bench["per_layer"]:
        if run.applies(m, workload, reported):
            reader = load_module(bench_dir / "metrics" / f"{m['name']}.py")
            metrics[m["name"]] = reader.read(tr)
    metrics["images_per_s"] = out.metrics["images_per_s"]
    profile = tr.profile
    del cell, out
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return metrics, profile, kept


def match_syncs(al, events):
    """Each recorded sync (host time: when its call returned) paired with
    the runtime sync call that ended last before it; returns the calls and
    the syncs left without a partner."""
    events = sorted(events, key=lambda h: h[1])
    free = list(range(len(events)))
    lone_syncs = []
    for t, sync in sorted(al.syncs, key=lambda s: s[0]):
        ends = [i for i in free if events[i][1] <= t]
        if ends:
            free.remove(ends[-1])
        else:
            lone_syncs.append(sync)
    return [events[i] for i in free], lone_syncs


def node_label(span):
    if span is None:
        return "outside any span"
    return "run" if span.kind == "run" else f"{span.name} ({span.op})"


def grouped_by_route(routes, joined, images):
    """Per route of the recorded grouped convs: how many convs took it,
    their q (conv count by q), the device us per image of the kernels
    joined to their node spans, and those kernels' names (us per image)."""
    route_of = {r.node: r.route for r in routes}
    out = {}
    for route in sorted(set(route_of.values())):
        qs = Counter(q for _, q in {(r.node, r.q) for r in routes
                                      if r.route == route})
        out[route] = {"convs": sum(qs.values()),
                      "q": dict(sorted(qs.items())),
                      "device_us_per_image": 0.0, "kernels": Counter()}
    for name, us, node, _ in joined:
        route = route_of.get(node.name) if node is not None else None
        if route is not None:
            out[route]["device_us_per_image"] += us / images
            out[route]["kernels"][name[:80]] += us / images
    for v in out.values():
        v["kernels"] = dict(v["kernels"].most_common(4))
    return out


def consts_reading(rec, batches):
    """The kept node constants (``LoweringCtx.kept``) looked up inside the
    recorded ``run`` spans: made and reused per batch, the share reused,
    and the first (node, key) pairs made; None where the recording has no
    ``consts`` (a tree before the record)."""
    from feathercnn_tpu_torch.utils import profiling
    if getattr(rec, "consts", None) is None:
        return None
    counts = [v for b, v in profiling.consts_by_batch(rec).items()
              if b is not None]
    made, reused = (sum(c[i] for c in counts) for i in (0, 1))
    return {"made_per_batch": made / batches,
            "reused_per_batch": reused / batches,
            "hit_share": reused / (made + reused) if counts else None,
            "made": [f"{k.node}: {k.key}" for k in rec.consts
                     if k.made and k.batch is not None][:20]}


def recording_readings(profile, kept):
    """What the recording gives on the profile's clock, and the checks."""
    import spans
    rec, prof = kept["rec"], kept["prof"]
    al = spans.aligned(rec, profile)
    if al is None:
        return {"error": "no clock anchor"}, {"anchor": False}
    batches = len(al.runs)
    joined = spans.joined_spans(profile, spans.correlated(prof), al)
    total_us = sum(us for _, us, _, _ in joined)
    by_op = defaultdict(float)
    for name, us, node, launch in joined:
        key = (node.op if node is not None else
               "copy-out" if spans.is_copy_out(name, launch, al) else
               "unjoined: " + (name if launch is None else
                               node_label(al.innermost(
                                   (launch[0] + launch[1]) / 2))))
        by_op[key] += us
    unjoined_us = sum(us for k, us in by_op.items()
                      if k.startswith("unjoined"))
    calls = spans.sync_events(profile, al)
    sync_ms_by_node = defaultdict(float)
    for a, b, name in calls:
        sync_ms_by_node[node_label(al.innermost((a + b) / 2))] += (
            b - a) / 1e3 / batches
    lone_calls, lone_syncs = match_syncs(al, calls)
    grouped = grouped_by_route(rec.routes, joined, profile.images)
    in_nodes, in_runs = spans.launch_share_in_nodes(profile, al)
    syncs_by_node = Counter(f"{s.node} ({s.op}) at {s.site}"
                            for s in rec.syncs)
    runs_ms = [(b - a) / 1e3 for a, b, _ in al.runs]
    stem_kernels = Counter()
    for name, us, node, _ in joined:
        if node is not None and node.name == kept["stem_node"]:
            stem_kernels[name[:80]] += us / profile.images
    c0, c1 = kept["stem_counts"]
    readings = {
        "batches": batches,
        "syncs_per_batch": spans.syncs_per_batch(al),
        "consts": consts_reading(rec, batches),
        "host_sync_ms": spans.host_sync_ms(profile, al),
        "eltwise_us_per_image": spans.op_us_per_image(
            joined, profile.images, "Eltwise"),
        "run_span_ms_mean": statistics.fmean(runs_ms),
        "device_us_per_image_by_node_op": {
            k: v / profile.images for k, v in sorted(
                by_op.items(), key=lambda kv: -kv[1])},
        "grouped_convs_by_route": grouped,
        "stem": {"node": kept["stem_node"],
                 "device_us_per_image": sum(stem_kernels.values()),
                 "kernels": dict(stem_kernels.most_common(8)),
                 "launches_per_batch": (None if c0 is None else
                                        (c1[0] - c0[0]) / batches),
                 "fallbacks_per_batch": (None if c0 is None else
                                         (c1[1] - c0[1]) / batches)},
        "syncs_per_batch_by_node": {
            k: v / batches for k, v in syncs_by_node.most_common()},
        "sync_call_ms_per_batch_by_node": dict(sorted(
            sync_ms_by_node.items(), key=lambda kv: -kv[1])[:20]),
        "sync_calls_by_name": Counter(c[2] for c in calls),
        "idle_gaps_named": spans.named_gaps(profile, al),
        "anchor_bracket_us": al.bracket_us,
        "launches_in_nodes": [in_nodes, in_runs],
        "device_us_joined_share": (1.0 - unjoined_us / total_us
                                   if total_us else None),
        "sync_calls_without_a_counted_sync": [
            [c[2], node_label(al.innermost((c[0] + c[1]) / 2))]
            for c in lone_calls],
        "counted_syncs_without_a_call": [
            [s.node, s.op] for s in lone_syncs],
    }
    checks = {
        "launches_in_nodes": (in_runs > 0
                              and in_nodes >= LAUNCH_SHARE * in_runs),
        "anchor_bracket": al.bracket_us < BRACKET_US,
        "syncs_reconciled": len(rec.syncs) == len(calls),
        "device_time_joined": (readings["device_us_joined_share"] or 0.0)
        >= JOINED_SHARE,
    }
    return readings, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workloads", default="")
    ap.add_argument("--seed", type=int, default=2 ** 31 + 21)
    ap.add_argument("--seconds", type=float, default=0.0,
                    help="the window (default: BENCHMARK.json's run_seconds)")
    ap.add_argument("--pairs", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import run
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    run.set_cache_dirs(ROOT)
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 3
    workloads = ([w for w in args.workloads.split(",") if w]
                 or [w["name"] for w in bench["workloads"]])
    seconds = args.seconds or bench["run_seconds"]
    result = {"card": run.power_limit(), "torch": torch.__version__,
              "cuda": torch.version.cuda, "seconds": seconds, "cells": {}}
    print(json.dumps({k: result[k] for k in ("card", "torch", "cuda")}),
          flush=True)
    ok, seed = True, args.seed
    for wl in workloads:
        cell = result["cells"][wl] = {"on": [], "off": [], "recorded": []}
        for _ in range(args.pairs):
            for record in (True, False, False, True):
                metrics, profile, kept = traced_run(bench, wl, seed, seconds,
                                                    record)
                row = {"seed": seed, **metrics}
                cell["on" if record else "off"].append(row)
                print(json.dumps({"cell": wl, "recorder": record, **row}),
                      flush=True)
                if record:
                    readings, checks = recording_readings(profile, kept)
                    ok = ok and all(checks.values())
                    cell["recorded"].append({"seed": seed, "checks": checks,
                                             **readings})
                    print(json.dumps({"cell": wl, "checks": checks,
                                      **readings}), flush=True)
                del profile, kept
                seed += 1
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps({"ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
