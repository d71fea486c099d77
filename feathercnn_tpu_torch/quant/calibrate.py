"""Activation-scale calibration for full-INT8 inference — counterpart of
``feathercnn_tpu/quant/calibrate.py`` over the port's own ``Engine`` and
``extract``.

Runs the FP engine over a calibration set and records, for every conv/FC
layer, a per-tensor scale of its *input* activation — by abs-max,
percentile, or MSE-optimal clipping (SURVEY.md §2.6; the reference has no
quantization, so this subsystem is new).  Results land in
``graph.meta["act_scales"]`` keyed by layer name, which quant/rewrite.py
reads and the serving artifact (model_format.py) persists so restarts skip
recalibration.
"""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch

from .qscheme import quantize_tensor_scale

__all__ = ["calibrate"]


def _mse_optimal_amax(samples: np.ndarray, amax: float, steps: int = 40
                      ) -> float:
    """Grid-search the clip threshold minimizing int8 quantization MSE."""
    best, best_err = amax, np.inf
    for frac in np.linspace(0.3, 1.0, steps):
        cand = amax * frac
        scale = cand / 127.0
        q = np.clip(np.round(samples / scale), -127, 127) * scale
        err = float(np.mean((q - samples) ** 2))
        if err < best_err:
            best, best_err = cand, err
    return best


def calibrate(graph, batches: Iterable, method: str = "percentile",
              percentile: float = 99.99, config=None,
              sample_cap: int = 1 << 18, device=None) -> Dict[str, float]:
    """Populate graph.meta['act_scales'].  ``batches`` yields input arrays
    (or dicts) shaped like the graph input.  ``device``: as for
    ``Engine`` (the first CUDA device unless "cpu" is passed)."""
    from ..config import EngineConfig
    from ..engine import Engine

    eng = Engine(graph, config or EngineConfig(), device=device)
    targets = {n.name: n.inputs[0] for n in eng.graph.nodes
               if n.op in ("Convolution", "InnerProduct")}
    # Also calibrate Eltwise/Concat operand values and Scale inputs so
    # residual adds, requantizing concats, and int8 affines can run on
    # int8 edges (quant/rewrite.py eltwise_int8 / concat_int8 /
    # requant_int8).
    extra_values = [i for n in eng.graph.nodes
                    if n.op in ("Eltwise", "Concat", "Scale", "LRN")
                    for i in n.inputs]
    # Windowed AVE pool inputs: the requantizing pool (requant_int8)
    # needs its input's value scale.
    extra_values += [n.inputs[0] for n in eng.graph.nodes
                     if n.op == "Pooling"
                     and n.attrs.get("pool", "MAX") == "AVE"
                     and not n.attrs.get("global_pooling", False)]
    # Axpy's two big operands (x, y) — the gate (inputs[0]) stays float
    # (quant/rewrite.py axpy_int8).
    extra_values += [i for n in eng.graph.nodes if n.op == "Axpy"
                     for i in n.inputs[1:]]
    all_values = set(targets.values()) | set(extra_values)
    # Graph inputs aren't extractable outputs; their scale comes from data.
    names = sorted(all_values - set(eng.graph.inputs))

    amax: Dict[str, float] = {}
    samples: Dict[str, list] = {v: [] for v in all_values}
    rng = np.random.default_rng(0)

    for batch in batches:
        outs = eng.run(batch, extract=names)
        if not isinstance(batch, dict):
            batch = {next(iter(eng.graph.inputs)): batch}
        for v in all_values:
            val = torch.as_tensor(outs[v] if v in outs else batch[v])
            val = val.float().abs()
            # the max reduces on the device; only sampling needs the host
            amax[v] = max(amax.get(v, 0.0), float(val.max()))
            if method in ("percentile", "mse"):
                arr = val.cpu().numpy().ravel()
                k = min(arr.size, sample_cap // 8)
                # with-replacement sampling: percentile estimation doesn't
                # need uniqueness, and choice(replace=False) materializes
                # a full permutation of multi-GB activations
                samples[v].append(rng.choice(arr, size=k)
                                  if arr.size > k else arr)

    value_amax: Dict[str, float] = {}
    for v, mx in amax.items():
        if method == "max":
            value_amax[v] = mx
        else:
            s = np.concatenate(samples[v])
            if method == "percentile":
                value_amax[v] = float(np.percentile(s, percentile))
            elif method == "mse":
                value_amax[v] = _mse_optimal_amax(s, mx)
            else:
                raise ValueError(f"unknown calibration method {method!r}")

    value_scales = {v: quantize_tensor_scale(mx)
                    for v, mx in value_amax.items()}
    scales = {layer: value_scales[v]
              for layer, v in targets.items() if v in value_scales}
    graph.meta.setdefault("act_scales", {}).update(scales)
    # Value-keyed scales let producers requantize in their epilogue and
    # consumers take int8 edges directly (quant/rewrite.py).
    graph.meta.setdefault("value_scales", {}).update(value_scales)
    return scales
