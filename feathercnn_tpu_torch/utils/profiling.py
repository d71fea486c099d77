"""Tracing and per-layer timing — counterpart of
``feathercnn_tpu/utils/profiling.py``.

- ``trace(logdir)``: a ``torch.profiler`` context whose trace (host ops,
  CUDA kernels, and the engine's one ``record_function`` range per graph
  node) lands in ``logdir`` as a ``*.pt.trace.json`` file that
  TensorBoard's profiler plugin and ``chrome://tracing`` read.
- ``layer_timings(engine, x)``: ms per node of the optimized graph.  The
  reference times growing prefixes of the graph (O(n^2) compiles, because
  XLA fuses across nodes); the port runs each node eagerly, so each node is
  timed directly on its own inputs: CUDA events around ``iters`` calls of
  its lowering on the card, ``time.perf_counter`` on the CPU.
- ``log``: the package's logger.
"""

from __future__ import annotations

import contextlib
import logging
import os
import statistics
import tempfile
import time
from typing import Dict, Optional

import torch

log = logging.getLogger("feathercnn_tpu_torch")

__all__ = ["trace", "layer_timings", "log"]


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """Profile the block (CPU and, where there is one, CUDA activity) and
    write its trace into ``logdir`` (default: ``feathercnn_tpu_torch_trace``
    in the temporary directory) when it ends; yields ``logdir``."""
    logdir = logdir or os.path.join(tempfile.gettempdir(),
                                    "feathercnn_tpu_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield logdir


@torch.inference_mode()
def layer_timings(engine, x, iters: int = 5) -> Dict[str, float]:
    """{node name: ms} for every node of ``engine``'s optimized graph: the
    median over ``iters`` calls of the node's lowering on the inputs one
    forward of ``x`` (an array, or name -> array) gives it, after one
    warm-up call, on the engine's device.  The plain engine (no
    ``sharding``) only."""
    from ..ops.lowering import lower_node

    if engine._mesh is not None:
        raise ValueError("layer_timings times the plain engine; this one is "
                         "sharded")
    if not isinstance(x, dict):
        (name,) = engine.graph.inputs
        x = {name: x}
    cdtype = getattr(torch, engine.config.compute_dtype)
    env = {}
    for name, v in x.items():
        t = torch.as_tensor(v).to(engine.device)
        env[name] = t.to(cdtype) if (t.dtype.is_floating_point
                                     and t.dim() == 4) else t
    params = engine._prepare_params()
    cuda = engine.device.type == "cuda"
    out: Dict[str, float] = {}
    for node in engine.graph.nodes:
        ins = [env[i] for i in node.inputs]
        ps = [params[p] for p in node.params]

        def run():
            return lower_node(node, ins, ps, engine._ctx)

        vals = run()
        times = []
        for _ in range(iters):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                run()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                run()
                times.append((time.perf_counter() - t0) * 1e3)
        out[node.name] = statistics.median(times) if times else 0.0
        for name, val in zip(node.outputs, vals):
            env[name] = val
    return out
