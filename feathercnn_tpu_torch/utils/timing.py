"""Timing utilities — counterpart of ``feathercnn_tpu/utils/timing.py``.

The reference times N forwards inside one jitted ``lax.fori_loop`` and
takes the slope ``T(warm + iters) - T(warm)``, which cancels its constant
dispatch and fetch cost.  The port runs eagerly: a loop is ``n`` forwards
issued from Python on the engine's device, each on an input perturbed by
its iteration (as the reference's, so that no two forwards see one input),
their outputs summed into one carry on the device.  On a CUDA device the
two loop lengths are timed with CUDA events, on the CPU with
``time.perf_counter``; the slope cancels the events' and the final sync's
constant cost.  The device comes from the engine or the tensors given.
All return seconds per iteration, as the reference's do.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import numpy as np
import torch

__all__ = ["default_extra_inputs", "device_bench", "engine_loop",
           "slope_time"]


def default_extra_inputs(graph):
    """name -> array for every graph input AFTER the first: ``im_info``
    gets [h, w, 1] rows from the first (image) input's spec, anything
    else zeros."""
    names = list(graph.inputs)
    spec0 = graph.inputs[names[0]]
    out = {}
    for nm in names[1:]:
        sp = graph.inputs[nm]
        if nm == "im_info" and len(spec0.shape) == 4:
            out[nm] = np.tile(np.asarray(
                [[spec0.shape[1], spec0.shape[2], 1.0]], np.float32),
                (sp.shape[0], 1))
        else:
            out[nm] = np.zeros(sp.shape, np.float32)
    return out


def _perturbed(x: torch.Tensor, i: int, step) -> torch.Tensor:
    """``x`` changed by iteration ``i``: an integer tensor at its first
    element (``+ i``), a float one everywhere (``+ i * step``)."""
    if not x.dtype.is_floating_point:
        xi = x.clone()
        xi.view(-1)[0] += i
        return xi
    return x + i * step


def _leaves(out):
    """The tensors of a (nested) dict, tuple or list of outputs."""
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        return [t for v in out for t in _leaves(v)]
    return [out]


def _elapsed(fn, device: torch.device) -> float:
    """Seconds ``fn()`` takes on ``device``: CUDA events around it on a
    CUDA device (``fn`` returns a device value, read after the end event),
    ``time.perf_counter`` on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        float(out)
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    float(fn())
    return time.perf_counter() - t0


def engine_loop(eng, x=None, extras=None, reduce_all=False):
    """The whole-model timing loop of an Engine: ``(loop, params,
    x_device)``, where ``loop(params, x, n)`` runs ``n`` forwards on the
    engine's device, the first graph input perturbed by the iteration,
    and returns the sum of the first output (of every output with
    ``reduce_all``) over them as a 0-d f32 tensor on the device, not
    synchronized.  The other inputs come from ``extras`` (name -> array)
    or ``default_extra_inputs``.  ``params`` is the engine's device
    weights, which its forward reads itself."""
    names = list(eng.graph.inputs)
    in_name, first_out = names[0], eng.graph.outputs[0]
    spec0 = eng.graph.inputs[in_name]
    if x is None:
        x = np.random.default_rng(0).normal(
            size=spec0.shape).astype(np.float32)
    defaults = default_extra_inputs(eng.graph)
    fixed = {nm: torch.as_tensor(
        np.asarray(extras[nm], np.float32) if extras and nm in extras
        else defaults[nm]).to(eng.device) for nm in names[1:]}
    params = eng._prepare_params()
    wanted = (list(eng.graph.outputs) if reduce_all else [first_out])

    @torch.inference_mode()
    def loop(params, x, n):
        carry = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(int(n)):
            out = eng.run({in_name: _perturbed(x, i, 1e-6), **fixed})
            for w in wanted:
                carry = carry + out[w].float().sum()
        return carry

    return loop, params, torch.as_tensor(x).to(eng.device)


def slope_time(loop, params, xd, warm: int = 5, iters: int = 20) -> float:
    """Seconds per iteration from one ``T(warm + iters) - T(warm)`` pair
    of ``engine_loop``'s loop on ``xd``'s device.  Callers interleave and
    repeat and take medians: single pairs drift."""
    t_short = _elapsed(lambda: loop(params, xd, warm), xd.device)
    t_long = _elapsed(lambda: loop(params, xd, warm + iters), xd.device)
    return max(t_long - t_short, 1e-9) / iters


def device_bench(fn: Callable, args: Sequence, iters: int = 50,
                 warmup: int = 5) -> float:
    """Seconds per call of ``fn(*args)`` on the device of ``args[0]`` (a
    tensor; an array is taken to the CPU), from the slope between loops
    of ``warmup`` and ``warmup + iters`` calls after ``warmup`` more.
    Each call's ``args[0]`` is perturbed by ``i % 3`` (timing only), and
    every output of every call is summed into one carry."""
    args = [torch.as_tensor(a) if a is not None and not torch.is_tensor(a)
            else a for a in args]
    a0 = args[0]
    step = torch.ones((), dtype=a0.dtype, device=a0.device)
    shifted = [a0 + (i % 3) * step for i in range(3)]

    @torch.inference_mode()
    def loop(n):
        carry = torch.zeros((), dtype=torch.float32, device=a0.device)
        for i in range(n):
            out = fn(shifted[i % 3], *args[1:])
            for v in _leaves(out):
                carry = carry + v.float().sum()
        return carry

    n_short = max(1, warmup)
    n_long = n_short + iters
    float(loop(n_short))                 # warm-up, synchronized
    t_short = _elapsed(lambda: loop(n_short), a0.device)
    t_long = _elapsed(lambda: loop(n_long), a0.device)
    return max(t_long - t_short, 1e-9) / (n_long - n_short)
