"""The benchmark's own tests: on the CPU, at small sizes, the harness end
to end with the program's CPU path; the tests marked ``card`` need a GPU
and skip without one."""

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
for p in (str(ROOT), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """Skips the test unless a CUDA device is present."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda:0"


@pytest.fixture(scope="session")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def shrink(bench_dir: Path) -> None:
    """The copy's configurations at 64x64 and batch 4, its traffic at a
    CPU's scale; widths, depths and everything else as they are."""
    for f in (bench_dir / "configs").glob("*.json"):
        cfg = json.loads(f.read_text())
        cfg.update(input_hw=[64, 64], graph_batch=4)
        f.write_text(json.dumps(cfg))
    for f in (bench_dir / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        if t["kind"] == "offline":
            t.update(pool_batches=2, profile_batches=2)
        else:
            t.update(rate_per_s=30, pool_images=12, client_threads=16,
                     lead_in_s=0.2, profile_s=0.2, drain_s=30,
                     server={"batch_size": 4, "batch_slots": [2, 4]})
            if t["kind"] == "burst":
                t["burst_images"] = 6
        f.write_text(json.dumps(t))


SERVE = ("serve_poisson", "serve_burst")


@pytest.fixture
def with_serve(bench, small):
    """The benchmark with ResNet-50 cells of the serving mixes added, which
    it leaves out on the card (PERF.md: the host paces them), limited as
    its offline cell is in the small copy."""
    b = json.loads(json.dumps(bench))
    lim = (small / "limits" / "resnet50_w8a8.offline.json").read_text()
    for mix in SERVE:
        name = f"resnet50_w8a8.{mix}"
        b["workloads"].append({"name": name, "config": "resnet50_w8a8",
                               "traffic": mix, "chips": 1, "why": "test"})
        (small / "limits" / f"{name}.json").write_text(lim)
    serve = [f"resnet50_w8a8.{mix}" for mix in SERVE]
    b["end_to_end"] += [
        {"name": n, "unit": "ms", "better": "lower", "bound": 0.1,
         "source": "host_clock", "workloads": serve}
        for n in ("latency_p95_ms", "latency_p50_ms")]
    b["per_layer"] += [
        {"name": n, "unit": u, "better": "lower", "source": "host_clock",
         "layer": "server", "moves": "latency_p95_ms", "workloads": serve}
        for n, u in (("gen_late_ms_p99", "ms"),
                     ("batch_images.serve", "images/batch"),
                     ("pad_pct.serve", "%"), ("device_idle_pct.serve", "%"))]
    return b


@pytest.fixture
def small(tmp_path):
    """A copy of the benchmark's folder at CPU sizes, under ``tmp_path``;
    returns its folder."""
    dst = tmp_path / "gpubench"
    shutil.copytree(BENCH_DIR, dst,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shrink(dst)
    return dst
