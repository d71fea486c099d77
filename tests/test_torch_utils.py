"""The port's timing, profiling and cache utilities
(``feathercnn_tpu_torch/utils/{timing,profiling,cache}.py``) on the CPU:

- ``layer_timings`` gives the reference's keys (every node of the
  optimized graph) on the same small graph, each a time >= 0;
- ``device_bench``, ``engine_loop`` + ``slope_time`` return positive
  seconds per iteration, and the loop's carry is the sum of the outputs
  of its perturbed forwards;
- ``trace`` writes a trace file;
- ``compilation_cache_dir`` / ``enable_persistent_cache`` /
  ``FEATHERCNN_TPU_CACHE`` name the directory both the CUDA kernels and
  the native runtime build into (no ``nvcc`` here: the paths, not the
  build).

Few test items per file: see tests/test_torch_kernels.py.
"""

import os
from pathlib import Path

import numpy as np
import torch

from feathercnn_tpu import Engine as JEngine
from feathercnn_tpu.models.builder import GraphBuilder as JBuilder
from feathercnn_tpu.utils.profiling import layer_timings as jlayer_timings
from feathercnn_tpu_torch import native
from feathercnn_tpu_torch.config import EngineConfig
from feathercnn_tpu_torch.engine import Engine
from feathercnn_tpu_torch.kernels import build
from feathercnn_tpu_torch.utils import cache, profiling, timing
from feathercnn_tpu_torch.weights import graph_from_reference


def _net():
    """tests/test_tools.py's graph, with a pool and an FC after it."""
    b = JBuilder("t", seed=9)
    x = b.input("data", (1, 8, 8, 4))
    y = b.conv("c1", x, 8, 3, pad=1, relu=True)
    y = b.conv("c2", y, 8, 1, relu=True)
    y = b.pool("p", y, 2, 2)
    return b.finish([b.fc("fc", y, 5)])


def test_layer_timings_has_the_references_keys():
    g = _net()
    x = np.random.default_rng(0).normal(size=(1, 8, 8, 4)).astype(
        np.float32)
    ref = jlayer_timings(JEngine(g), x, iters=2)
    eng = Engine(graph_from_reference(g), EngineConfig(backend="cuda"),
                 device="cpu")
    mine = profiling.layer_timings(eng, x, iters=3)
    assert list(mine) == [n.name for n in eng.graph.nodes]
    assert set(mine) == set(ref)
    assert all(v >= 0 for v in mine.values())


def test_timing_loops_return_positive_seconds():
    eng = Engine(graph_from_reference(_net()), EngineConfig(backend="cuda"),
                 device="cpu")
    x = np.random.default_rng(1).normal(size=(1, 8, 8, 4)).astype(
        np.float32)
    loop, params, xd = timing.engine_loop(eng, x)
    assert xd.device.type == "cpu" and params is eng._prepare_params()
    want = sum(float(eng(torch.from_numpy(x) + i * 1e-6).sum())
               for i in range(3))
    assert abs(float(loop(params, xd, 3)) - want) <= 1e-4 * abs(want) + 1e-5
    assert timing.slope_time(loop, params, xd, warm=1, iters=2) > 0
    a = torch.randn(64, 64)
    assert timing.device_bench(lambda u, v: u @ v, [a, a], iters=3,
                               warmup=1) > 0
    t = timing.device_bench(lambda u: {"y": u * 2, "z": [u + 1]},
                            [np.ones((4, 4), np.float32)], iters=2)
    assert t > 0


def test_trace_writes_a_trace(tmp_path):
    eng = Engine(graph_from_reference(_net()), device="cpu")
    x = np.zeros((1, 8, 8, 4), np.float32)
    with profiling.trace(str(tmp_path / "tb")) as logdir:
        eng(x)
    files = [f for f in os.listdir(logdir) if f.endswith(".pt.trace.json")]
    assert len(files) == 1 and os.path.getsize(
        os.path.join(logdir, files[0])) > 0
    assert profiling.log.name == "feathercnn_tpu_torch"


def test_build_directory_follows_the_cache_setting(tmp_path, monkeypatch):
    """The argument first, then ``FEATHERCNN_TPU_CACHE``, then the
    package's ``_build/``; both libraries' directories under it, and
    ``EngineConfig(compilation_cache_dir=...)`` sets it."""
    default = Path(build.__file__).resolve().parent.parent / "_build"
    monkeypatch.delenv("FEATHERCNN_TPU_CACHE", raising=False)
    monkeypatch.setattr(cache, "_root", None)
    try:
        assert cache.build_root() == default
        assert build.library_dir().parent == default
        monkeypatch.setenv("FEATHERCNN_TPU_CACHE", str(tmp_path / "env"))
        assert build.library_dir().parent == tmp_path / "env"
        assert cache.enable_persistent_cache() == str(
            (tmp_path / "env").resolve())
        assert (tmp_path / "env").is_dir()
        arg = tmp_path / "arg"
        assert cache.enable_persistent_cache(str(arg)) == str(arg.resolve())
        assert build.library_dir().parent == arg.resolve()
        assert native.library_path().parent.parent == arg.resolve()
        assert native.library_path().parent.name.startswith("native-")
        cfg_dir = tmp_path / "cfg"
        Engine(graph_from_reference(_net()),
               EngineConfig(compilation_cache_dir=str(cfg_dir)),
               device="cpu")
        assert cfg_dir.is_dir()
        assert build.library_dir().parent == cfg_dir.resolve()
        assert build.build_log() == ""        # nothing built there
    finally:
        cache._root = None
    monkeypatch.delenv("FEATHERCNN_TPU_CACHE")
    assert build.library_dir().parent == default
