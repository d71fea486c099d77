"""A configuration, a traffic mix and a per-layer metric are found by their
names alone: new files and new entries, and no edit of ``run.py``."""

import copy
import json

import run


def test_new_files_are_found_by_name(small, bench):
    cfg = json.loads((small / "configs" / "mobilenet_v1_w8a8.json")
                     .read_text())
    cfg["graph_batch"] = 2
    (small / "configs" / "mobilenet_v1_w8a8_b2.json").write_text(
        json.dumps(cfg))
    (small / "traffic" / "offline_one.json").write_text(json.dumps(
        {"kind": "offline", "pool_batches": 1, "profile_batches": 1}))
    (small / "metrics" / "answers_per_s.py").write_text(
        "def read(trace):\n"
        "    return trace.images / trace.window_s\n")
    (small / "limits" / "mobilenet_v1_w8a8_b2.offline_one.json").write_text(
        json.dumps({"top1_gap": 100.0, "prob_l1_mean": 2.0}))
    b = copy.deepcopy(bench)
    b["configs"].append({"name": "mobilenet_v1_w8a8_b2", "source": "x",
                         "file": "gpubench/configs/mobilenet_v1_w8a8_b2.json",
                         "reduced": [], "why": "x"})
    name = "mobilenet_v1_w8a8_b2.offline_one"
    b["workloads"].append({"name": name, "config": "mobilenet_v1_w8a8_b2",
                           "traffic": "offline_one", "chips": 1, "why": "x"})
    b["end_to_end"][0]["workloads"].append(name)
    b["per_layer"].append({"name": "answers_per_s", "unit": "images/s",
                           "better": "higher", "source": "host_clock",
                           "layer": "engine", "moves": "images_per_s",
                           "workloads": [name]})
    r = run.run_cell(b, name, 3, 1.0, False, "cpu", bench_dir=small,
                     t_start=0.0)
    assert set(r["metrics"]) == {"images_per_s", "setup_s"}
    assert r["attempted"] % 2 == 0
    r = run.run_cell(b, name, 3, 1.0, True, "cpu", bench_dir=small,
                     t_start=0.0)
    # the new reader, and none of the metrics listed for other cells
    assert set(r["metrics"]) == {"answers_per_s"}
    assert list(r)[-1] == "checks"


def test_metric_without_workloads_follows_what_it_moves():
    m = {"name": "x", "moves": "latency_p95_ms"}
    assert run.applies(m, "a.serve", ["latency_p95_ms", "setup_s"])
    assert not run.applies(m, "a.offline", ["images_per_s", "setup_s"])
    assert run.applies({"name": "setup_s"}, "anything")
