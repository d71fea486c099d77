"""The port's tools (``feathercnn_tpu_torch/tools/``, ``examples/``) on the
CPU, against the reference's (``tools/``) where both decide something:

- ``validate``: the synthetic SqueezeNet caffemodel on 4 ``.npy`` images
  at batch 2 gives the reference's fp and int8 predictions and gate
  fields;
- the CLIs (``run_model``, ``summarize``, ``diff_blobs``, ``verify_gpu``,
  ``examples/classify``) exit 0 with ``--device cpu`` on SqueezeNet at
  batch 1; ``verify_gpu`` fails on a wrong candidate;
- ``tune``, ``tune_regions`` and ``tune_flags`` decide as the reference's
  do for the same measurements (both timing functions replaced by one
  fixed sequence of numbers, as tests/test_tools.py does), the TPU flags
  left out;
- the autotune CLI bakes its choices into a ``.ftpu`` that
  ``Engine.from_path`` reloads with them taken.

Few test items per file: see tests/test_torch_kernels.py.
"""

import itertools
import os
import sys

import numpy as np
import torch

from feathercnn_tpu import Engine as JEngine
from feathercnn_tpu import EngineConfig as JConfig
from feathercnn_tpu.models.builder import GraphBuilder as JBuilder
from feathercnn_tpu.quant import calibrate as jcalibrate
from feathercnn_tpu_torch.config import EngineConfig
from feathercnn_tpu_torch.engine import Engine
from feathercnn_tpu_torch.examples import classify
from feathercnn_tpu_torch.model_format import save_ftpu
from feathercnn_tpu_torch.tools import (autotune, diff_blobs, run_model,
                                        summarize, validate_real,
                                        verify_gpu)
from feathercnn_tpu_torch.tools.synth_caffemodel import write_synth
from feathercnn_tpu_torch.weights import graph_from_reference

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))
DEPLOYS = os.path.join(ROOT, "tools", "deploys")

import tools.autotune as jautotune  # noqa: E402


def test_validate_matches_the_reference(tmp_path):
    """The reference's predictions and gate fields, labels given (the fp
    predictions, so the int8 leg's drop is the disagreement rate)."""
    from validate_real import validate as jvalidate
    deploy = os.path.join(DEPLOYS, "squeezenet_v11_deploy.prototxt")
    model = str(tmp_path / "s.caffemodel")
    write_synth(deploy, model, seed=0)
    rng = np.random.default_rng(3)
    paths = []
    for i in range(4):
        paths.append(str(tmp_path / f"im{i}.npy"))
        np.save(paths[-1], rng.normal(0, 40, size=(227, 227, 3)).astype(
            np.float32))
    kw = dict(batch=2, calib_n=2)
    ref = jvalidate(deploy, model, paths, **kw)
    labels = {os.path.basename(p): int(v)
              for p, v in zip(paths, ref["fp_top1_pred"])}
    ref = jvalidate(deploy, model, paths, labels=labels, **kw)
    mine = validate_real.validate(deploy, model, paths, labels=labels,
                                  device="cpu", **kw)
    assert mine == ref, (mine, ref)
    assert set(mine) >= {"fp_top1_pred", "int8_top1_pred", "top1_drop",
                         "gate", "gate_pass"}


def test_clis_run_on_the_cpu(tmp_path, capsys, monkeypatch):
    """Each CLI exits 0 on SqueezeNet v1.1 at batch 1 with ``--device
    cpu``; ``verify_gpu`` fails when its candidate is wrong."""
    from feathercnn_tpu_torch.utils import cache
    monkeypatch.setattr(cache, "_root", None)   # classify sets the root
    cpu = ["--device", "cpu"]
    assert run_model.main(["squeezenet_v11", "--loops", "2", "--dump",
                           "pool10", "--dump-dir", str(tmp_path)] + cpu) == 0
    assert (tmp_path / "pool10.npy").exists()
    assert summarize.main(["--model", "squeezenet_v11", "--top", "3"]
                          + cpu) == 0
    assert diff_blobs.main(["--model", "squeezenet_v11", "--batch", "1"]
                           + cpu) == 0
    assert verify_gpu.main(["--model", "squeezenet_v11", "--batch", "1"]
                           + cpu) == 0
    assert classify.main(["--model", "squeezenet_v11", "--quant", "w8a8"]
                         + cpu) == 0
    out = capsys.readouterr().out
    assert "timing loop" in out and "top1-agreement=1.000" in out
    assert "first divergence" in out and out.count("class ") >= 5

    class Wrong(Engine):
        def run(self, inputs, extract=()):
            res = super().run(inputs, extract)
            return {k: v.flip(-1) for k, v in res.items()}

    assert not verify_gpu.verify(
        "squeezenet_v11", 1, device="cpu",
        make_candidate=lambda g, c, d: Wrong(g, c, device=d))


def _blocks_graph():
    """Two chain signatures: three identity bottlenecks at C = 32 (8x8),
    then a stride-2 projection and two at C = 64 (4x4); a 3x3 conv beside
    it of a signature a later one shares."""
    b = JBuilder("blocks", seed=4)
    x = b.input("data", (1, 8, 8, 3))
    x = b.conv("stem", x, 32, 3, pad=1, relu=True)
    x = b.conv("stem2", x, 32, 3, pad=1, relu=True)
    for stage, (c, n) in enumerate(((32, 3), (64, 2))):
        if stage:
            x = b.conv("proj", x, c, 1, stride=2, relu=True)
        for i in range(n):
            y = b.conv(f"b{stage}{i}a", x, c // 4, 1, relu=True)
            y = b.conv(f"b{stage}{i}b", y, c // 4, 3, pad=1, relu=True)
            y = b.conv(f"b{stage}{i}c", y, c, 1)
            x = b.relu(f"b{stage}{i}r", b.eltwise(f"b{stage}{i}", [x, y]))
    x = b.pool("gap", x, 0, mode="AVE", global_pooling=True)
    g = b.finish([b.fc("fc", x, 10)])
    jcalibrate(g, [np.random.default_rng(5).normal(size=(1, 8, 8, 3))
                   .astype(np.float32)], method="max")
    return g


def _fixed_times(monkeypatch, name, values):
    """Replace ``name`` (a timing function) with one returning ``values``
    in turn, cycling."""
    it = itertools.cycle(values)
    monkeypatch.setattr(name, lambda *a, **k: next(it))


def test_tune_and_regions_decide_as_the_reference(monkeypatch):
    monkeypatch.setattr("feathercnn_tpu.utils.cache.enable_persistent_cache",
                        lambda *a, **k: "")
    times = [2e-3 * (1 + (7 * k) % 5) for k in range(11)]
    g = _blocks_graph()
    for dtype, quant in (("float32", None), ("bfloat16", "w8a8")):
        jeng = JEngine(g, JConfig(compute_dtype=dtype, quant=quant))
        teng = Engine(graph_from_reference(g), EngineConfig(
            compute_dtype=dtype, quant=quant, backend="cuda"), device="cpu")
        _fixed_times(monkeypatch, "feathercnn_tpu.utils.timing.device_bench",
                     times)
        ref, ref_rows = jautotune.tune(jeng.graph, dtype, quant, iters=15)
        _fixed_times(monkeypatch,
                     "feathercnn_tpu_torch.utils.timing.device_bench", times)
        mine, rows = autotune.tune(teng.graph, dtype, quant, iters=15,
                                   device="cpu")
        assert mine == ref and mine, (dtype, mine, ref)
        assert [r.get("measured_ms") for r in rows] == \
            [r.get("measured_ms") for r in ref_rows]
        assert all(set(r["kernels"].values()) == {"plain"}
                   for r in rows if "kernels" in r)
    times = [3e-3, 2e-3, 1e-3, 4e-3]
    _fixed_times(monkeypatch, "feathercnn_tpu.utils.timing.device_bench",
                 times)
    ref = jautotune.tune_regions(g, "bfloat16", "w8a8", iters=2)
    _fixed_times(monkeypatch, "feathercnn_tpu_torch.utils.timing.device_bench",
                 times)
    mine = autotune.tune_regions(graph_from_reference(g), "bfloat16", "w8a8",
                                 iters=2, device="cpu")
    assert mine == ref == {"8x8x32x8": False, "4x4x64x16": True}, (mine, ref)


def _concat_graph():
    """tests/test_tools.py::test_tune_flags_numerics_gate's graph."""
    b = JBuilder("gate", seed=11)
    x = b.input("data", (1, 8, 8, 4))
    y = b.conv("stem", x, 8, 3, pad=1, relu=True)
    for i in range(3):
        z = b.conv(f"l{i}", y, 8, 1, relu=True)
        y = b.concat(f"cat{i}", [y, z])
    y = b.pool("gap", y, 0, mode="AVE", global_pooling=True)
    g = b.finish([b.fc("fc", y, 10)])
    jcalibrate(g, [np.random.default_rng(2).normal(size=(1, 8, 8, 4))
                   .astype(np.float32)], method="max", config=JConfig())
    return g


def _fake_loops(monkeypatch, package):
    monkeypatch.setattr(f"{package}.utils.timing.engine_loop",
                        lambda eng, *a, **k: (lambda p, x, n: 0.0, None,
                                              None))


def test_tune_flags_decides_as_the_reference(monkeypatch, capsys):
    """The same round-robin of slope times (base, then each flag's flip,
    per round): the same flips land; the TPU formulation flags are left
    out and said to be."""
    monkeypatch.setattr("feathercnn_tpu.utils.cache.enable_persistent_cache",
                        lambda *a, **k: "")
    g = _concat_graph()
    # base, merge_siblings, merge_concats, int8_grouped, int8_requant_ops,
    # concat_dus, fold_scale_chains: the graph has no op of the other
    # flags, so the reference measures these seven too
    rounds = [1.0, 0.9, 1.2, 0.95, 1.0, 0.5, 1.05]
    _fake_loops(monkeypatch, "feathercnn_tpu")
    _fixed_times(monkeypatch, "feathercnn_tpu.utils.timing.slope_time",
                 rounds)
    ref = jautotune.tune_flags(g, "float32", "w8a8", rounds=2, iters=1,
                               interpret=True)
    _fake_loops(monkeypatch, "feathercnn_tpu_torch")
    _fixed_times(monkeypatch, "feathercnn_tpu_torch.utils.timing.slope_time",
                 rounds)
    mine = autotune.tune_flags(graph_from_reference(g), "float32", "w8a8",
                               rounds=2, iters=1, device="cpu")
    assert mine == ref == {"merge_siblings": False, "int8_grouped": False,
                           "concat_dus": True}, (mine, ref)
    err = capsys.readouterr().err
    assert "left out" in err and all(f in err for f in (
        "nms_blocked", "roipool_table", "lrn_band", "shuffle_matmul",
        "topk_radix"))


def test_autotune_bakes_a_ftpu_that_reloads_with_its_choices(tmp_path,
                                                             monkeypatch):
    """``--regions`` (chain regions and algo overrides) and ``--flags``
    (config overrides) baked into the file; ``Engine.from_path`` takes all
    three, and its output equals an engine built with the same choices."""
    path = str(tmp_path / "m.ftpu")
    save_ftpu(graph_from_reference(_blocks_graph()), path)
    _fixed_times(monkeypatch, "feathercnn_tpu_torch.utils.timing.device_bench",
                 [1e-3, 2e-3, 3e-3, 0.5e-3, 4e-3])
    base = ["--ftpu", path, "--quant", "w8a8", "--iters", "2", "--device",
            "cpu"]
    assert autotune.main(base + ["--regions"]) == 0
    _fake_loops(monkeypatch, "feathercnn_tpu_torch")
    _fixed_times(monkeypatch, "feathercnn_tpu_torch.utils.timing.slope_time",
                 [1.0, 0.5, 1.0, 1.0, 1.0, 1.0])
    assert autotune.main(base + ["--flags"]) == 0
    from feathercnn_tpu_torch.model_format import load_ftpu
    meta = load_ftpu(path).meta
    assert meta["config_overrides"] == {"merge_siblings": False}
    assert meta["chain_regions"] and meta["algo_overrides"]
    cfg = EngineConfig(compute_dtype="bfloat16", quant="w8a8",
                       backend="cuda", fuse_chains=True)
    eng = Engine.from_path(path, cfg, device="cpu")
    assert dict(eng.config.algo_overrides) == meta["algo_overrides"]
    assert eng.config.merge_siblings is False
    fused = [n for n in eng.graph.nodes
             if n.op in ("FusedChain", "FusedBottleneck")]
    assert len(fused) == sum(meta["chain_regions"].values())
    direct = Engine(load_ftpu(path), cfg.replace(
        algo_overrides=tuple(meta["algo_overrides"].items()),
        merge_siblings=False), device="cpu")
    x = np.random.default_rng(6).normal(size=(1, 8, 8, 3)).astype(np.float32)
    assert torch.equal(eng(x), direct(x))
