"""The check catches a broken timed path.  The harness runs end to end on
the CPU (its look for a card skipped) at small sizes, with the engine
under it broken where it produces its answers; ``correct`` has to come
out false, and true for the program as it is."""

import pytest
import torch

import run
from faults import answer_altered, broken_program, half_left_out


CELLS = ["resnet50_w8a8.offline", "mobilenet_v1_w8a8.offline",
         "resnet50_w8a8.serve_poisson", "resnet50_w8a8.serve_burst"]


def test_cells_are_the_benchmarks(bench):
    assert {w["name"] for w in bench["workloads"]} <= set(CELLS)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", [half_left_out, answer_altered],
                         ids=lambda f: f.__name__)
def test_fault_is_not_correct(small, with_serve, workload, fault):
    torch.manual_seed(0)
    r = run.run_cell(with_serve, workload, 2 ** 31 + 9, 1.0, False, "cpu",
                     bench_dir=small, program=broken_program(fault),
                     t_start=0.0)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_program_is_correct(small, with_serve, workload):
    r = run.run_cell(with_serve, workload, 2 ** 31 + 9, 1.0, False, "cpu",
                     bench_dir=small, t_start=0.0)
    assert r["correct"] is True, r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0


@pytest.mark.parametrize("workload", CELLS[2:])
def test_serving_readers(small, with_serve, workload):
    # a window long enough for a CPU batch to finish in it on a busy host
    r = run.run_cell(with_serve, workload, 5, 3.0, True, "cpu",
                     bench_dir=small, t_start=0.0)
    assert {"gen_late_ms_p99", "batch_images.serve",
            "pad_pct.serve"} <= set(r["metrics"])
    assert 1.0 <= r["metrics"]["batch_images.serve"]["value"] <= 4.0
