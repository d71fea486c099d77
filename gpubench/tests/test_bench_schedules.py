"""The open loop's schedules, and how it times requests: from when each
was due, over all of them, a failure as infinitely late."""

import math
import threading
import time
import types

import numpy as np
import torch

import openloop
from conftest import BENCH_DIR
from harness import Cell, load_module, percentile

POISSON = load_module(BENCH_DIR / "traffic" / "poisson.py")
BURST = load_module(BENCH_DIR / "traffic" / "burst.py")


def sched(kind, traffic, seed, span=10.0):
    return kind.schedule(traffic, 0.0, span, np.random.default_rng(seed))


def gaps(t, span):
    """The sorted gaps between arrivals, the last one wrapping to the
    span's end."""
    return np.sort(np.append(np.diff(t), span - t[-1]))


def test_poisson_reproduces_from_seed():
    tr = {"rate_per_s": 300}
    a, b, c = (sched(POISSON, tr, s) for s in (5, 5, 6))
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    # every seed sends the same load: the same count, the same gaps
    assert len(a) == len(c) == 3000
    assert np.allclose(gaps(a, 10.0), gaps(c, 10.0))
    assert a[0] == 0.0 and a[-1] < 10.0 and np.all(np.diff(a) > 0)


def test_poisson_gaps_are_exponential():
    gaps = np.diff(sched(POISSON, {"rate_per_s": 1000}, 1))
    assert abs(gaps.mean() - 1e-3) < 2e-5
    assert abs(np.median(gaps) - math.log(2) * 1e-3) < 3e-5


def test_burst_reproduces_from_seed():
    tr = {"rate_per_s": 1280, "burst_images": 256, "burst_spread_s": 1e-3}
    a, b, c = (sched(BURST, tr, s) for s in (7, 7, 8))
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert len(a) == len(c) == 50 * 256
    starts = a[::256]
    assert np.all(np.ptp(a.reshape(50, 256), axis=1) < 1e-3)
    assert np.allclose(gaps(starts, 10.0), gaps(c[::256], 10.0), atol=1e-5)


class FakeServer:
    """Answers after ``delay_s``, one request at a time; returns None for
    the requests whose first pixel is negative (a timed-out request)."""

    def __init__(self, delay_s):
        self.delay_s = delay_s
        self.lock = threading.Lock()
        self.metrics = {"batches": 0, "images": 0, "pad_images": 0,
                        "faults": 0}
        self.queue = types.SimpleNamespace(depth=lambda: 0)

    def start(self):
        pass

    def stop(self):
        pass

    def infer(self, image, timeout_s):
        with self.lock:
            time.sleep(self.delay_s)
            self.metrics["batches"] += 1
            self.metrics["images"] += 1
        if image.flat[0] < 0:
            return None
        return np.full(3, 1 / 3, np.float32)


def fake_cell(delay_s, threads, rate, seconds=1.0):
    traffic = {"kind": "poisson", "rate_per_s": rate, "pool_images": 8,
               "client_threads": threads, "lead_in_s": 0.0, "drain_s": 10.0,
               "profile_s": 0.1, "server": {}}
    program = types.SimpleNamespace(
        make_server=lambda engine, cfg: FakeServer(delay_s))
    cfg = {"input_hw": [2, 2], "channels": 1}
    return Cell("fake", cfg, traffic, 3, seconds, False, torch.device("cpu"),
                0.0, [], {}, [], program)


def test_lateness_counts_from_due():
    # 40 requests due over 1 s, served one at a time in 50 ms each: the
    # queue grows, so the last requests are ~1 s late
    out = openloop.run(fake_cell(0.05, 64, 40), POISSON.schedule)
    assert out.attempted == 40
    assert out.metrics["latency_p95_ms"] > 600
    # the generator itself kept up: the threads were free
    assert percentile(out.trace.late_s, 99) < 0.05


def test_lateness_when_threads_are_busy():
    # one client thread: the requests wait for it, and the wait shows as
    # generator lateness and in the latency
    out = openloop.run(fake_cell(0.05, 1, 40), POISSON.schedule)
    assert percentile(out.trace.late_s, 99) > 0.5
    assert out.metrics["latency_p50_ms"] > 300


def test_percentile_over_all_requests():
    lat = [1.0] * 90 + [math.inf] * 10
    assert percentile(lat, 50) == 1.0
    assert percentile(lat, 90) == 1.0
    assert percentile(lat, 95) == math.inf
    assert percentile(list(range(1, 101)), 95) == 95


def test_failed_requests_count_as_missing(monkeypatch):
    cell = fake_cell(0.001, 8, 50)
    real_images = Cell.images

    def images(self, n, stream):
        x = real_images(self, n, stream).abs()
        x[: n // 2, 0, 0, 0] = -1.0          # half the pool never answers
        return x
    monkeypatch.setattr(Cell, "images", images)
    out = openloop.run(cell, POISSON.schedule)
    assert out.failed > 0
    assert out.failed + sum(len(r) for r, _ in out.answers) == out.attempted
    assert 0 < out.failed < out.attempted
    if out.failed / out.attempted > 0.05:
        assert out.metrics["latency_p95_ms"] == math.inf
