"""The PyTorch port's native runtime (``feathercnn_tpu_torch/native.py``
over its own C++ copy in ``native_csrc/``) against the JAX package's
(``feathercnn_tpu/native.py`` over ``native/``), on the CPU.

- The mmap loader: on a calibrated small model written by ``save_ftpu``,
  ``load_ftpu_native`` gives the graph and the bit-equal params of the
  port's ``load_ftpu`` and of the reference's; ``Engine.from_path`` (which
  loads through it by default) gives the built engine's output.
- The C++ queue behaves as the Python queue, call for call, and serves
  several threads.
- ``serve.preprocess``: the port's numpy path equals the reference's bit for
  bit, its C++ path equals the reference's C++ path bit for bit (the same
  source and flags; the reference builds its library with its own
  ``make -C native``, as its tests do), and the numpy path within the
  reference's stated limits (``tests/test_serving.py``: f32 within
  rtol 1e-5, atol 2e-5 at its 37x53 case; fewer than 1% of the int8
  values 1 LSB apart).
- A compiler that fails raises with its output, and no Python queue
  stands in.

Few test items per file: see tests/test_torch_kernels.py.
"""

import threading

import numpy as np
import pytest
import torch

from feathercnn_tpu.model_format import load_ftpu as jload_ftpu
from feathercnn_tpu.models.builder import GraphBuilder as JBuilder
from feathercnn_tpu.quant import calibrate as jcalibrate
from feathercnn_tpu.serve import native_available as jnative_available
from feathercnn_tpu.serve import preprocess as jpreprocess
from feathercnn_tpu_torch import native
from feathercnn_tpu_torch.config import EngineConfig
from feathercnn_tpu_torch.engine import Engine
from feathercnn_tpu_torch.model_format import load_ftpu, save_ftpu
from feathercnn_tpu_torch.serve import PyBatchQueue, make_queue, preprocess
from feathercnn_tpu_torch.weights import graph_from_reference
from test_torch_classic_zoo import _nodes


def _model():
    b = JBuilder("nat", seed=11)
    x = b.input("data", (2, 12, 12, 3))
    x = b.conv("c1", x, 16, 3, pad=1, relu=True)
    x = b.pool("pool", x, 3, 2)
    x = b.conv("c2", x, 16, 1, relu=True)
    x = b.pool("gap", x, 0, mode="AVE", global_pooling=True)
    g = b.finish([b.softmax("prob", b.fc("fc", x, 5))])
    x = np.random.default_rng(11).normal(size=(2, 12, 12, 3)).astype(
        np.float32)
    jcalibrate(g, [x], method="max")
    return graph_from_reference(g), x


def test_native_loader_matches_both_loaders(tmp_path):
    g, x = _model()
    path = str(tmp_path / "nat.ftpu")
    save_ftpu(g, path)
    mine = native.load_ftpu_native(path)
    assert native.available()
    for other in (load_ftpu(path), jload_ftpu(path)):
        assert _nodes(mine) == _nodes(other)
        assert mine.name == other.name and mine.outputs == other.outputs
        assert {k: (s.shape, s.dtype) for k, s in mine.inputs.items()} == \
            {k: (tuple(s.shape), s.dtype) for k, s in other.inputs.items()}
        assert mine.params.keys() == other.params.keys()
        for k, v in other.params.items():
            assert mine.params[k].dtype == v.dtype, k
            np.testing.assert_array_equal(mine.params[k], v, err_msg=k)
        assert (mine.meta["act_scales"] == other.meta["act_scales"])
    cfg = EngineConfig(backend="cuda", quant="w8a8",
                       compute_dtype="bfloat16")
    built = Engine(g, cfg, device="cpu")(x)
    loaded = Engine.from_path(path, cfg, device="cpu")
    assert torch.equal(loaded(x), built)
    assert torch.equal(Engine.from_path(path, cfg, prefer_native=False,
                                        device="cpu")(x), built)


def test_native_queue_behaves_as_the_python_queue():
    """submit, collect (full, partial after its timeout, empty when
    closed), post, wait, depth, stats and close: the same answers from
    both queues; then 4 threads of 8 requests each, every answer its own."""
    queues = [make_queue((3,), np.float32, (2,), np.float32),
              make_queue((3,), np.float32, (2,), np.float32,
                         prefer_native=False)]
    assert [type(q) for q in queues] == [native.NativeBatchQueue,
                                         PyBatchQueue]
    seen = []
    for q in queues:
        tickets = [q.submit(np.full(3, i, np.float32)) for i in range(5)]
        depth = q.depth()
        batch, got = q.collect(max_batch=3, timeout_us=1000)
        q.post_results(got, np.stack([batch[:, 0], -batch[:, 0]], axis=1))
        r = q.wait_result(got[1])
        batch2, got2 = q.collect(max_batch=3, timeout_us=2000)
        missing = q.wait_result(got2[0], timeout_us=1000)
        stats = q.stats()
        q.close()
        after = q.submit(np.zeros(3, np.float32))
        seen.append((tickets, depth, batch.tolist(), got, r.tolist(),
                     batch2.tolist(), got2, missing, stats, after))
    assert seen[0] == seen[1], seen
    assert seen[0][1] == 5 and seen[0][8]["batches"] == 2

    q = queues[0].__class__((3,), np.float32, (2,), np.float32)
    answers = {}

    def server():
        done = 0
        while done < 32:
            batch, got = q.collect(max_batch=8, timeout_us=2000)
            q.post_results(got, np.stack([batch[:, 0], batch[:, 1] * 2],
                                         axis=1))
            done += len(got)

    def client(t):
        for i in range(8):
            v = float(t * 100 + i)
            ticket = q.submit(np.asarray([v, v + 1, 0], np.float32))
            answers[(t, i)] = (v, q.wait_result(ticket, 10_000_000))

    threads = [threading.Thread(target=server)] + [
        threading.Thread(target=client, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert len(answers) == 32
    for v, r in answers.values():
        assert r is not None and r.tolist() == [v, 2 * (v + 1)]
    assert q.stats()["completed"] == 32
    q.close()


def test_preprocess_matches_the_reference():
    """At the reference's own case (37x53 -> 24x24) and at chip_smoke.py's
    (240x320 -> 224x224).  The reference's f32 limit against the numpy
    path holds at its case; at the other, both packages' C++ paths (bit
    equal) compute the source coordinates in f32 and move a value by up
    to ~1.2e-4 after the normalization, so there the int8 limit alone is
    held."""
    rng = np.random.default_rng(7)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    for src, dst in (((37, 53), (24, 24)), ((240, 320), (224, 224))):
        img = rng.integers(0, 256, size=src + (3,), dtype=np.uint8)
        for kw in ({}, {"quant_scale": 0.02}):
            np_mine = preprocess(img, dst, mean, std, prefer_native=False,
                                 **kw)
            np_ref = jpreprocess(img, dst, mean, std, prefer_native=False,
                                 **kw)
            assert np_mine.dtype == np_ref.dtype
            assert np.array_equal(np_mine, np_ref), (src, kw)
            cc_mine = preprocess(img, dst, mean, std, **kw)
            assert jnative_available(), \
                "the reference's C++ path did not build"
            cc_ref = jpreprocess(img, dst, mean, std, **kw)
            assert cc_mine.dtype == cc_ref.dtype
            assert np.array_equal(cc_mine, cc_ref), (src, kw)
            if kw:
                assert (cc_mine != np_mine).mean() < 0.01, src
                assert np.abs(cc_mine.astype(int) - np_mine).max() <= 1
            elif src == (37, 53):
                np.testing.assert_allclose(cc_mine, np_mine, rtol=1e-5,
                                           atol=2e-5)
    same = preprocess(img, src, (0, 0, 0), (1, 1, 1))
    np.testing.assert_allclose(same, img.astype(np.float32) / 255.0,
                               atol=1e-6)


def test_failed_build_raises_with_its_log(monkeypatch):
    monkeypatch.setenv("CXX", "false")
    assert not native.available()
    with pytest.raises(RuntimeError, match="build failed") as e:
        native.load_library()
    assert "false -O2" in str(e.value)
    with pytest.raises(RuntimeError, match="build failed"):
        make_queue((3,), np.float32, (2,), np.float32)
    monkeypatch.setenv("CXX", "no-such-compiler-here")
    with pytest.raises(RuntimeError, match="could not start"):
        native.load_library()
