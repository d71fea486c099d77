"""The system under test, ``feathercnn_tpu_torch``, as the cells drive it:
the zoo's graph of the configuration's architecture, its weights replaced
by the benchmark's own by parameter name, calibrated by the port
(``quant.calibrate``) and built into an ``Engine`` with the
configuration's ``EngineConfig`` (plus the zoo's baked overrides), and
the ``InferenceServer`` in front of it.  This is the only module of the
benchmark that imports the program."""

from __future__ import annotations

import numpy as np


def build_engine(cfg: dict, params: dict, calib_batches, device):
    """The calibrated engine of configuration ``cfg`` over ``params``
    (name -> tensor, the benchmark's weights)."""
    from feathercnn_tpu_torch import Engine, EngineConfig, TensorSpec
    from feathercnn_tpu_torch.models.zoo import build_model
    from feathercnn_tpu_torch.quant import calibrate

    g = build_model(cfg["architecture"], batch=cfg["graph_batch"])
    (name,) = g.inputs
    g.inputs[name] = TensorSpec((cfg["graph_batch"], *cfg["input_hw"],
                                 cfg["channels"]))
    want = {n: tuple(v.shape) for n, v in g.params.items()}
    have = {n: tuple(t.shape) for n, t in params.items()}
    if want != have:
        diff = sorted(set(want.items()) ^ set(have.items()))[:6]
        raise SystemExit(f"the program's {cfg['architecture']} and the "
                         f"benchmark's layer list differ: {diff}")
    for n, t in params.items():
        g.params[n] = t.detach().float().cpu().numpy().astype(np.float32)
    cal = cfg["calibration"]
    calibrate(g, list(calib_batches), method=cal["method"], device=device)
    return Engine(g, EngineConfig(**cfg["engine"]), device=device)


def make_server(engine, server_cfg: dict):
    """An ``InferenceServer`` with the cell's batch size and slots and the
    program's defaults for everything else."""
    from feathercnn_tpu_torch.serve import InferenceServer
    return InferenceServer(engine, batch_size=server_cfg["batch_size"],
                           batch_slots=list(server_cfg["batch_slots"]))


def output_name(engine) -> str:
    return engine.graph.outputs[0]


def values(engine, x, names):
    """The engine's values ``names`` (NHWC; int8 where it holds a value as
    a grid) of one forward of ``x``, and the scale of each grid it holds,
    by value name: its producer's output scale (``y_scale``), which is the
    value's calibrated scale unless a reader takes it at its own (a max
    pool, a concat that passes its operands through)."""
    out = engine.run(x, extract=list(names))
    q = engine.graph.meta.get("quant") or {}
    return out, {o: float(q[n.name]["y_scale"]) for n in engine.graph.nodes
                 if "y_scale" in (q.get(n.name) or {}) for o in n.outputs}
