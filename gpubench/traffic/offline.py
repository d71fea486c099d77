"""Offline batches: a closed loop over ``Engine.run`` on a pool of seeded
batches already on the device, batch k+1 dispatched before the host reads
batch k's probabilities, so at most two are in flight.  Each batch's
probabilities are copied out as soon as its kernels are queued, into one
of two pinned buffers, so the copy is a DMA after that batch and not
after the next one; the host waits for batch k's copy alone, then keeps
the probabilities in its own memory.

Parameters (the mix's file): ``pool_batches`` distinct batches of the
configuration's ``graph_batch`` images, cycled; ``profile_batches``, the
batches the traced run profiles from the middle of its window.  The
profiled batches start on an idle device and end with a fetch, so that
the profile holds their kernels whole: its sub-window runs from their
first device operation to their last."""

from __future__ import annotations

import time

import torch

from harness import Outcome, Trace, profiler, read_profile

STREAM_POOL = 11


def inputs(cell):
    """The images the window's answers are of, and whether they go through
    the server's int8 ingest: the pool of batches, as they are."""
    n = cell.traffic["pool_batches"] * cell.cfg["graph_batch"]
    return cell.images(n, STREAM_POOL), False


def run(cell) -> Outcome:
    eng, tr = cell.engine, cell.traffic
    batch = cell.cfg["graph_batch"]
    n_pool = tr["pool_batches"]
    pool, transfer = inputs(cell)
    xs = [pool[i * batch:(i + 1) * batch] for i in range(n_pool)]
    for x in xs:                     # every shape and constant, once
        probs = eng(x).cpu()
    if cell.trace:
        with profiler(cell.device):   # start the profiler's machinery now
            eng(xs[0]).cpu()
    _sync(cell.device)

    cuda = cell.device.type == "cuda"
    ring = [torch.empty(probs.shape, dtype=probs.dtype, pin_memory=cuda)
            for _ in range(2)]
    enqueue, answers = [], []
    state = {"k": 0, "prev": None, "done": 0}
    t_open = time.perf_counter()
    t_end = t_open + cell.seconds

    def step():
        """Dispatch the next batch and queue its copy out, then fetch the
        one before it."""
        k = state["k"]
        t = time.perf_counter()
        out = eng(xs[k % n_pool])
        enqueue.append(time.perf_counter() - t)
        buf = ring[k % 2]
        buf.copy_(out, non_blocking=cuda)
        done = torch.cuda.Event() if cuda else None
        if cuda:
            done.record()
        fetch()
        state["prev"], state["k"] = (k % n_pool, buf, done), k + 1

    def fetch():
        prev = state["prev"]
        if prev is not None:
            if prev[2] is not None:
                prev[2].synchronize()
            host = torch.empty(prev[1].shape, dtype=prev[1].dtype)
            host.copy_(prev[1])
            if time.perf_counter() <= t_end:
                state["done"] += batch
            answers.append((prev[0], host))
            state["prev"] = None

    prof = None
    while time.perf_counter() < t_end:
        if (cell.trace and prof is None
                and time.perf_counter() >= t_open + cell.seconds / 2):
            fetch()
            _sync(cell.device)
            prof = profiler(cell.device)
            with prof:
                for _ in range(tr["profile_batches"]):
                    step()
                fetch()
            continue
        step()
    fetch()
    peak = (torch.cuda.max_memory_allocated()
            if cell.device.type == "cuda" else 0)
    trace = Trace(window_s=cell.seconds, images=state["done"],
                  spans={"enqueue": enqueue})
    if prof is not None:
        trace.profile = read_profile(prof, tr["profile_batches"] * batch)
    rows = torch.arange(n_pool * batch).view(n_pool, batch)
    return Outcome(metrics={"images_per_s": state["done"] / cell.seconds},
                   window_open=t_open, attempted=state["k"] * batch,
                   failed=0, inputs=pool,
                   answers=[(rows[i], out) for i, out in answers],
                   transfer=transfer, trace=trace, memory_peak_bytes=peak)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()

