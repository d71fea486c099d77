"""Start ``n`` ranks on one host and hand their results back.

    from feathercnn_tpu_torch.parallel.launch import spawn, engine_rank
    outs = spawn(engine_rank, 4, args=("m.ftpu", config, x, (), "cpu"))

Each rank is a process started with ``torch.multiprocessing``'s "spawn"
method: it sets the FEATHERCNN_* env triple (the coordinator at
``tcp://127.0.0.1:<free port>``; a numeric address, since the host may have
no name service) and joins the group through
``dist.maybe_initialize_distributed``, as a rank of the serve CLI does,
then calls ``fn(rank, world_size, *args)``.  Whatever ``fn`` returns comes
back as numpy (tensors, also in dicts, lists and tuples; bfloat16 as
float32), one entry per rank.  A rank that raises has its traceback raised
in the caller; at ``timeout`` seconds every rank still running is killed
and the call raises.  The process group's own timeout is shorter, so a
collective that one rank skips fails inside the ranks first.

The rank functions of the port's tests live here, so that a spawned child
imports the port and nothing of a test module.
"""

from __future__ import annotations

import datetime
import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, Sequence

import numpy as np
import torch

__all__ = ["spawn", "free_port", "engine_rank", "collectives_rank",
           "ops_rank", "plan_rank", "to_numpy"]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def to_numpy(v):
    """Tensors (in dicts, lists and tuples too) as numpy arrays."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    if isinstance(v, dict):
        return {k: to_numpy(u) for k, u in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(to_numpy(u) for u in v)
    return v


def _rank_main(fn, rank, world_size, port, backend, threads, args, results,
               collective_timeout):
    os.environ.update({
        "FEATHERCNN_COORDINATOR": f"tcp://127.0.0.1:{port}",
        "FEATHERCNN_NUM_PROCESSES": str(world_size),
        "FEATHERCNN_PROCESS_ID": str(rank),
        "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)})
    torch.set_num_threads(threads)
    import torch.distributed as dist
    from .dist import maybe_initialize_distributed
    try:
        maybe_initialize_distributed(backend, datetime.timedelta(
            seconds=collective_timeout))
        results.put((rank, True, to_numpy(fn(rank, world_size, *args))))
    except BaseException:
        # handed to the caller, which raises it
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, args: Sequence[Any] = (),
          backend: str = "gloo", timeout: float = 60.0,
          threads: int = 1) -> list:
    """Run ``fn(rank, nprocs, *args)`` on ``nprocs`` ranks joined in one
    process group on ``backend``; returns their results in rank order.
    ``fn`` must be importable by name (a module's top-level function)."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        fn, r, nprocs, port, backend, threads, tuple(args), results,
        max(timeout / 2, 5.0))) for r in range(nprocs)]
    for p in procs:
        p.start()
    done, failed = {}, {}
    deadline = time.monotonic() + timeout
    try:
        while len(done) + len(failed) < nprocs:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"{fn.__name__} on {nprocs} ranks: ranks "
                    f"{sorted(set(range(nprocs)) - set(done) - set(failed))}"
                    f" gave no result within {timeout:.0f} s; killed")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                lost = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)
                        and r not in done and r not in failed]
                if lost:
                    raise RuntimeError(
                        f"{fn.__name__}: ranks {lost} exited with codes "
                        f"{[procs[r].exitcode for r in lost]} and no result")
                continue
            (done if ok else failed)[rank] = payload
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if failed:
        raise RuntimeError("\n".join(f"rank {r} of {fn.__name__} failed:\n"
                                     f"{tb}" for r, tb in sorted(
                                         failed.items())))
    return [done[r] for r in range(nprocs)]


# ----------------------------------------------------------------------
# rank functions
# ----------------------------------------------------------------------

def engine_rank(rank, world_size, source, config, inputs, extract=(),
                device=None):
    """One rank of a sharded ``Engine`` over ``source`` (a ``.ftpu`` path
    or a graph): the global outputs and ``extract`` values of ``inputs``.
    ``device`` as ``Engine``'s: the rank's current CUDA device unless the
    caller passes ``"cpu"`` (raises where there is no GPU)."""
    from ..engine import Engine
    if isinstance(source, str):
        eng = Engine.from_path(source, config, device=device)
    else:
        eng = Engine(source, config, device=device)
    return eng.run(inputs, extract=extract)


def collectives_rank(rank, world_size, source, config, inputs,
                     device=None):
    """``engine_rank``'s outputs, and how many channel all-gathers
    (``ops.lowering.gather_channels``) and ring collective matmuls
    (``parallel.overlap.allgather_matmul``) its forward ran on this rank:
    (outputs, {function name: calls})."""
    from ..ops import lowering
    from . import overlap
    calls = {}

    def counted(module, name):
        fn = getattr(module, name)
        calls[name] = 0

        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        setattr(module, name, call)

    counted(lowering, "gather_channels")
    counted(overlap, "allgather_matmul")
    return engine_rank(rank, world_size, source, config, inputs,
                       device=device), calls


def plan_rank(rank, world_size, source, config, inputs, device=None):
    """The serving layer's batch-plan agreement (``broadcast_plan``: rank
    0 offers 17, the others 3), then one rank of a sharded ``Engine``
    forward on ``device`` (``engine_rank``'s): (the agreed plan, the
    global outputs)."""
    from ..serve.server import broadcast_plan
    plan = broadcast_plan(17 if rank == 0 else 3)
    return plan, engine_rank(rank, world_size, source, config, inputs,
                             device=device)


def _ops():
    from .overlap import allgather_matmul, matmul_reducescatter
    from .spatial import halo_exchange, spatial_conv2d
    from .tp import column_parallel_conv, row_parallel_conv, tp_conv_pair
    return {f.__name__: f for f in (
        column_parallel_conv, row_parallel_conv, tp_conv_pair,
        halo_exchange, spatial_conv2d, allgather_matmul,
        matmul_reducescatter)}


def ops_rank(rank, world_size, cases):
    """Each case ``(function name, args, kwargs, split)`` of ``parallel``'s
    tp, spatial and overlap functions on the world group: each numpy arg
    split into ``world_size`` equal pieces along ``split[i]`` (this rank
    takes its own), or passed whole where that is None.  Returns each
    case's result on this rank."""
    import torch.distributed as dist
    fns = _ops()
    outs = []
    for name, args, kwargs, split in cases:
        mine = []
        for a, d in zip(args, split):
            if isinstance(a, np.ndarray):
                if d is not None:
                    a = np.split(a, world_size, axis=d)[rank]
                a = torch.from_numpy(np.ascontiguousarray(a))
            mine.append(a)
        if name == "halo_exchange":     # (x, group, halo_lo, halo_hi)
            outs.append(fns[name](mine[0], dist.group.WORLD, *mine[1:],
                                  **kwargs))
        else:
            outs.append(fns[name](dist.group.WORLD, *mine, **kwargs))
    return outs
