"""The PyTorch port's InferenceServer over a CPU engine, against the JAX
package's.

The serving graph is built with the JAX ``GraphBuilder``, calibrated with
the JAX ``calibrate`` and carried across with ``graph_from_reference``, so
both servers hold the same weights and scales.  The int8-transfer test
serves the same images through both servers: the transferred int8 batches
are equal, every edge of the engine fed that int8 batch is equal (the stem
dequantizes the int8 input through its calibrated input scale), and the
answers agree within 1e-6, the tolerance of tests/test_torch_engine.py.
The other tests hold the port's server against its own engine: the choice
of batch slot with padding, pipelined results equal to synchronous ones,
and fault isolation.  Few test items per file (see
tests/test_torch_kernels.py for why).
"""

import threading

import numpy as np
import pytest
import torch

from feathercnn_tpu import Engine as JEngine
from feathercnn_tpu import EngineConfig as JConfig
from feathercnn_tpu.models.builder import GraphBuilder as JBuilder
from feathercnn_tpu.quant import calibrate as jcalibrate
from feathercnn_tpu.serve import InferenceServer as JServer
from feathercnn_tpu_torch.config import EngineConfig
from feathercnn_tpu_torch.engine import Engine
from feathercnn_tpu_torch.serve import InferenceServer
from feathercnn_tpu_torch.serve.batcher import make_queue
from feathercnn_tpu_torch.serve.server import InferenceFailed
from feathercnn_tpu_torch.weights import graph_from_reference

SHAPE = (17, 17, 3)


def _graph(batch=4):
    """A stem, a ceil-mode MAX pool, one projection bottleneck (merged
    sibling convs), a global AVE pool and the FC, built by the JAX
    package."""
    b = JBuilder("srv", seed=5)
    x = b.input("data", (batch,) + SHAPE)

    def conv_bn(name, x, ch, k, stride=1, pad=0, relu=True):
        x = b.conv(name, x, ch, k, stride, pad, bias=False)
        x = b.bn_scale("bn" + name, x)
        return b.relu(name + "_relu", x) if relu else x

    x = conv_bn("conv1", x, 16, 3, 2, 1)
    x = b.pool("pool1", x, 3, 2)
    s = conv_bn("p_b1", x, 32, 1, relu=False)
    y = conv_bn("p_b2a", x, 16, 1)
    y = conv_bn("p_b2b", y, 16, 3, pad=1)
    y = conv_bn("p_b2c", y, 32, 1, relu=False)
    x = b.relu("p_relu", b.eltwise("p", [s, y]))
    x = b.pool("pool5", x, 0, mode="AVE", global_pooling=True)
    return b.finish([b.fc("fc", x, 6)])


def _images(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=SHAPE).astype(np.float32) for _ in range(n)]


@pytest.fixture(scope="module")
def ref_graph():
    """The serving graph, calibrated by the JAX package."""
    g = _graph()
    jcalibrate(g, [np.stack(_images(0, 4))], method="max")
    return g


@pytest.fixture(scope="module")
def int8_engine(ref_graph):
    return Engine(graph_from_reference(ref_graph),
                  EngineConfig(backend="cuda", quant="w8a8",
                               compute_dtype="bfloat16"), device="cpu")


@pytest.fixture(scope="module")
def fp_engine():
    return Engine(graph_from_reference(_graph()), device="cpu")


def _serve(srv, imgs):
    """Send every image from its own client thread; results in order."""
    results = [None] * len(imgs)

    def client(i):
        results[i] = srv.infer(imgs[i], timeout_s=60)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(imgs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=90)
    assert all(r is not None for r in results)
    return results


def test_int8_transfer_matches_reference_server(ref_graph, int8_engine):
    """A full-int8 engine takes int8 transfer, quantized on ingest with the
    stem's calibrated input scale.  The port's server and the JAX
    package's (its Pallas kernels in interpret mode) quantize the same
    images to the same int8 batch, their engines agree on every edge of
    that batch, and the two servers answer the same."""
    jeng = JEngine(ref_graph, JConfig(backend="pallas", quant="w8a8",
                                      compute_dtype="bfloat16",
                                      interpret=True))
    jsrv = JServer(jeng, batch_size=4, batch_timeout_us=1000,
                   prefer_native_queue=False)
    srv = InferenceServer(int8_engine, batch_size=4, batch_timeout_us=1000,
                          prefer_native_queue=False)
    assert srv._queue_dtype == np.int8 and jsrv._queue_dtype == np.int8
    assert srv._transfer_scale == jsrv._transfer_scale
    imgs = _images(1, 4)
    pre = srv._to_transfer(np.stack(imgs))
    np.testing.assert_array_equal(pre, jsrv._to_transfer(np.stack(imgs)))

    names = [o for n in jeng.graph.nodes for o in n.outputs]
    assert names == [o for n in int8_engine.graph.nodes for o in n.outputs]
    want = jeng.run(pre, extract=names)
    got = int8_engine.extract(pre, names)
    for name in names:
        ref, t = np.asarray(want[name]), got[name]
        if ref.dtype == np.int8:
            assert t.dtype == torch.int8, (name, t.dtype)
            diff = int((t.numpy().astype(np.int32) != ref).sum())
            assert diff == 0, f"{name}: {diff} of {ref.size} values differ"
        else:
            np.testing.assert_allclose(t.float().numpy(),
                                       ref.astype(np.float32), rtol=0,
                                       atol=1e-6, err_msg=name)

    answers = {}
    for key, server in (("jax", jsrv), ("port", srv)):
        server.start()
        try:
            answers[key] = _serve(server, imgs)
            # a pre-quantized submission skips the cast and answers the same
            again = server.infer(pre[2], timeout_s=30)
            np.testing.assert_array_equal(again, answers[key][2])
            assert server.metrics["faults"] == 0 and server.healthy()
        finally:
            server.stop()
    for i, (a, b) in enumerate(zip(answers["port"], answers["jax"])):
        assert a.shape == b.shape == (6,), (a.shape, b.shape)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6,
                                   err_msg=f"image {i}")
    # and the port's answer is its engine's direct run on the int8 batch
    direct = int8_engine(pre).float().numpy().reshape(4, -1)
    np.testing.assert_array_equal(np.stack(answers["port"]), direct)


def test_slot_choice_pads_to_the_smallest_fitting_slot(fp_engine):
    srv = InferenceServer(fp_engine, batch_size=8, batch_slots=[2, 8],
                          batch_timeout_us=1000, prefer_native_queue=False)
    assert srv.batch_slots == [2, 8]
    assert [srv.select_slot(n) for n in (1, 2, 3, 8)] == [2, 2, 8, 8]
    srv.start()
    try:
        img = _images(2, 1)[0]
        out = srv.infer(img, timeout_s=30)
        assert out.shape == (6,)
        assert srv.metrics["pad_images"] == 1     # slot 2, not 8
        want = fp_engine(img[None]).numpy()[0]
        np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)
    finally:
        srv.stop()


def test_pipelined_matches_sync(fp_engine, int8_engine):
    imgs = _images(3, 11)
    for eng in (fp_engine, int8_engine):
        got = {}
        for depth in (1, 2):
            srv = InferenceServer(eng, batch_size=4, batch_timeout_us=2000,
                                  prefer_native_queue=False,
                                  pipeline_depth=depth)
            srv.start()
            try:
                got[depth] = _serve(srv, imgs)
                assert srv.gauges()["images"] == len(imgs)
            finally:
                srv.stop()
        for a, b in zip(got[1], got[2]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_fault_raises_inference_failed(fp_engine):
    srv = InferenceServer(fp_engine, batch_size=4, batch_timeout_us=1000,
                          max_retries=0, prefer_native_queue=False)

    def boom(batch):
        raise RuntimeError("injected fault")

    srv._run_batch = boom
    srv._dispatch_batch = boom
    srv.start()
    try:
        with pytest.raises(InferenceFailed):
            srv.infer(_images(4, 1)[0], timeout_s=30)
        assert srv.metrics["faults"] >= 1
    finally:
        srv.stop()


def test_queue_batching_and_gauges(fp_engine):
    """Both queues, the C++ one (``make_queue``'s default) and the Python
    one, batch alike."""
    from feathercnn_tpu_torch.native import NativeBatchQueue
    from feathercnn_tpu_torch.serve import PyBatchQueue
    for native, kind in ((True, NativeBatchQueue), (False, PyBatchQueue)):
        q = make_queue((3,), np.float32, (2,), np.float32,
                       **({} if native else {"prefer_native": False}))
        assert type(q) is kind
        tickets = [q.submit(np.full(3, i, np.float32)) for i in range(5)]
        assert len(tickets) == 5 and q.depth() == 5
        batch, got = q.collect(max_batch=3, timeout_us=1000)
        assert len(got) == 3 and batch.shape == (3, 3)
        q.post_results(got, np.stack([batch[:, 0], -batch[:, 0]], axis=1))
        r = q.wait_result(got[1])
        assert r[0] == 1.0 and r[1] == -1.0
        _, got2 = q.collect(max_batch=3, timeout_us=1000)
        assert len(got2) == 2
        q.close()
    text = InferenceServer(fp_engine, batch_size=2).prometheus_text()
    assert "feathercnn_batches 0" in text and "feathercnn_healthy" in text
