"""Serving under an open loop: single images sent through
``InferenceServer.infer`` on a schedule of due times, whether or not
earlier requests have come back, by a pool of client threads that take
the next due request as soon as they are free.

A request is timed from when it was due to when its answer reached the
client; one that fails or never comes back counts as infinitely late.
The window holds the requests due in ``[0, seconds)``; a lead-in of the
same traffic runs before it, so the window opens on a server in its
steady state.  The traced run profiles ``profile_s`` seconds from the
middle of the window; its sub-window runs from the first device operation
in them to the end of the last.

Parameters (the mix's file): ``pool_images`` seeded images, made on the
device and kept on the host, each request one of them; ``client_threads``;
``lead_in_s``; ``drain_s``, how long past the window's close an answer
is waited for; ``profile_s``; ``server``: the ``InferenceServer``'s
``batch_size`` and ``batch_slots``; and the kind's own schedule
parameters."""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from harness import (Outcome, Trace, percentile, profiler, read_profile,
                     sleep_until, sub_seed)

STREAM_POOL, STREAM_SCHEDULE = 21, 22
# an answer within this long of the window's close counts as served by it
SERVED_GRACE_S = 0.5


def fixed_gaps(n: int, mean: float, rng) -> np.ndarray:
    """``n`` gaps of an exponential distribution of mean ``mean``, taken
    at its quantiles and shuffled: every seed sends the same gaps in
    another order, so seeds differ in arrivals and not in load."""
    u = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-u)
    gaps *= mean * n / gaps.sum()
    return rng.permutation(gaps)


def arrivals(n: int, span: float, rng) -> np.ndarray:
    """``n`` Poisson-like arrival times in ``[0, span)``, the first at 0."""
    if n <= 0:
        return np.zeros(0)
    gaps = fixed_gaps(n, span / n, rng)
    return np.concatenate([[0.0], np.cumsum(gaps[:-1])])


def inputs(cell):
    """The images requests are drawn from, and whether they go through the
    server's int8 ingest (they do)."""
    return cell.images(cell.traffic["pool_images"], STREAM_POOL), True


def run(cell, schedule) -> Outcome:
    """``schedule(traffic, start, span, rng)`` gives the due times (s,
    sorted, in ``[start, start + span)``)."""
    tr = cell.traffic
    server = cell.program.make_server(cell.engine, tr["server"])
    images, transfer = inputs(cell)
    pool = images.cpu().numpy()
    rng = np.random.default_rng(sub_seed(cell.seed, STREAM_SCHEDULE))
    lead = schedule(tr, -tr["lead_in_s"], tr["lead_in_s"], rng)
    due = np.concatenate([lead, schedule(tr, 0.0, cell.seconds, rng)])
    which = rng.integers(0, len(pool), size=len(due))
    n = len(due)
    sent = np.full(n, np.nan)
    done = np.full(n, np.inf)
    answers = [None] * n
    counter = iter(range(n))
    take = threading.Lock()

    server.start()
    if cell.trace:
        with profiler(cell.device):   # start the profiler's machinery now
            server.infer(pool[0], timeout_s=tr["drain_s"])
    prof = None
    t_open = time.perf_counter() + tr["lead_in_s"] + 0.2

    def client():
        while True:
            with take:
                i = next(counter, None)
            if i is None:
                return
            sleep_until(t_open + due[i])
            sent[i] = time.perf_counter()
            try:
                out = server.infer(pool[which[i]], timeout_s=tr["drain_s"])
            except Exception:       # InferenceFailed: counted as missing
                out = None
            if out is not None:
                done[i] = time.perf_counter()
                answers[i] = out
    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(tr["client_threads"])]
    try:
        for t in threads:
            t.start()
        sleep_until(t_open)
        before = dict(server.metrics)
        if cell.trace:
            sleep_until(t_open + (cell.seconds - tr["profile_s"]) / 2)
            prof = profiler(cell.device)
            with prof:
                time.sleep(tr["profile_s"])
        sleep_until(t_open + cell.seconds)
        after = dict(server.metrics)
        depth = server.queue.depth()
        deadline = t_open + cell.seconds + tr["drain_s"]
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.perf_counter()))
        peak = (torch.cuda.max_memory_allocated()
                if cell.device.type == "cuda" else 0)
    finally:
        server.stop()
        for t in threads:
            t.join(timeout=5.0)

    win = due >= 0.0
    lat = (done - (t_open + due))[win]
    late = (sent - (t_open + due))[win]
    got = [i for i in np.flatnonzero(win) if answers[i] is not None]
    counters = {k: after[k] - before[k]
                for k in ("batches", "images", "pad_images", "faults")}
    counters["queue_depth_at_close"] = depth
    counters["served_by_close"] = int(np.sum(
        done[win] <= t_open + cell.seconds + SERVED_GRACE_S))
    trace = Trace(window_s=cell.seconds, images=int(counters["images"]),
                  counters=counters,
                  late_s=[x for x in late if np.isfinite(x)],
                  profile=read_profile(prof) if prof is not None else None)
    lat_ms = [x * 1e3 for x in lat]
    rows = torch.as_tensor(which[got])
    probs = torch.from_numpy(np.stack([answers[i] for i in got])) \
        if got else torch.zeros((0, 1))
    return Outcome(
        metrics={"latency_p95_ms": percentile(lat_ms, 95),
                 "latency_p50_ms": percentile(lat_ms, 50)},
        window_open=t_open, attempted=int(win.sum()),
        failed=int(win.sum()) - len(got), inputs=torch.from_numpy(pool),
        answers=[(rows, probs)], transfer=transfer, trace=trace,
        memory_peak_bytes=peak)

