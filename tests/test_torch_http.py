"""The PyTorch port's HTTP serving (``serve/http.py``, ``serve/__main__.py``,
``serve/postprocess.py``) against the JAX package's, on the CPU.

- ``HttpFrontend`` over a small fp32 engine of the port: its ``.npy`` and
  JSON answers equal the port engine's direct run of the same image
  (rtol 1e-5, atol 1e-6: the server runs the image in a padded batch of 4,
  the direct run alone, and a conv sums in another order at another
  batch), and the reference's ``HttpFrontend`` over the JAX engine on the
  same graph answers within rtol 1e-4, atol 1e-5 (the two frameworks' f32
  convs, as tests/test_serving.py holds the reference's answers to its
  engine).
- The routes and codes: ``/healthz`` 200 and 503, ``/metrics``, 404, 400 on
  a bad body and on a bad shape, 413 past ``max_body_bytes``, 500 when the
  batch failed, 503 when the server stopped.
- A two-stage engine (Faster R-CNN at tests/test_torch_detection.py's CI
  size, fp32): ``.npz`` and JSON answers equal the server's in-process
  answer (``infer_outputs``) bit for bit and the engine's direct run within
  rtol 1e-4, atol 1e-5 (on the CPU, a conv run in the server's thread may
  sum in another order than the same conv run in the caller's: conv1_2
  moved by 4e-6 at this seed; on the card the chip run holds them equal),
  and the port's ``decode_detections`` equals the reference's on them bit
  for bit.
- ``python -m feathercnn_tpu_torch.serve --device cpu --port 0`` in a
  subprocess: it prints ``serving on HOST:PORT``, answers a POST, and
  rejects ``--im-info`` on a graph without ``im_info``.

Few test items per file: see tests/test_torch_kernels.py.
"""

import io
import json
import os
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch

from feathercnn_tpu import Engine as JEngine
from feathercnn_tpu.models.builder import GraphBuilder as JBuilder
from feathercnn_tpu.serve import HttpFrontend as JHttp
from feathercnn_tpu.serve import InferenceServer as JServer
from feathercnn_tpu.serve import decode_detections as jdecode
from feathercnn_tpu_torch.engine import Engine
from feathercnn_tpu_torch.model_format import save_ftpu
from feathercnn_tpu_torch.serve import (HttpFrontend, InferenceServer,
                                        decode_detections)
from feathercnn_tpu_torch.weights import graph_from_reference

ROOT = Path(__file__).resolve().parent.parent
SHAPE = (10, 10, 3)


def _graph(batch=4):
    b = JBuilder("http", seed=21)
    x = b.input("data", (batch,) + SHAPE)
    x = b.conv("c1", x, 8, 3, pad=1, relu=True)
    x = b.pool("pool", x, 3, 2)
    x = b.conv("c2", x, 8, 1, relu=True)
    x = b.pool("gap", x, 0, mode="AVE", global_pooling=True)
    return b.finish([b.softmax("prob", b.fc("fc", x, 6))])


def _post(base, body, ctype, path="/infer"):
    """(status, content type, body bytes) of a POST."""
    req = urllib.request.Request(base + path, data=body,
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def _get(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _npy(a):
    buf = io.BytesIO()
    np.save(buf, a)
    return buf.getvalue()


def _ask(base, img):
    """The .npy and the JSON answer to ``img``."""
    code, ctype, body = _post(base, _npy(img), "application/x-npy")
    assert (code, ctype) == (200, "application/x-npy"), (code, body)
    as_npy = np.load(io.BytesIO(body))
    body = json.dumps({"data": img.tolist()}).encode()
    code, ctype, body = _post(base, body, "application/json")
    assert (code, ctype) == (200, "application/json"), (code, body)
    return as_npy, json.loads(body)["result"]


def test_http_answers_equal_the_engine_and_the_reference():
    jg = _graph()
    imgs = np.random.default_rng(21).normal(size=(3,) + SHAPE).astype(
        np.float32)
    eng = Engine(graph_from_reference(jg), device="cpu")
    answers = {}
    for name, srv, front in (
            ("port", lambda: InferenceServer(eng, batch_size=4),
             HttpFrontend),
            ("reference", lambda: JServer(JEngine(jg), batch_size=4,
                                          prefer_native_queue=False),
             JHttp)):
        s = srv()
        s.start()
        f = front(s, host="127.0.0.1", port=0)
        f.start()
        try:
            answers[name] = [_ask(f"http://127.0.0.1:{f.port}", im)
                             for im in imgs]
        finally:
            f.stop()
            s.stop()
    for i, im in enumerate(imgs):
        direct = eng(im[None])[0].numpy()
        got_npy, got_json = answers["port"][i]
        assert got_npy.dtype == np.float32 and got_npy.shape == direct.shape
        np.testing.assert_allclose(got_npy, direct, rtol=1e-5, atol=1e-6)
        assert np.asarray(got_json, np.float32).tolist() == got_npy.tolist()
        ref_npy, ref_json = answers["reference"][i]
        np.testing.assert_allclose(got_npy, ref_npy, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(np.asarray(got_json), ref_json,
                                   rtol=1e-4, atol=1e-5)


def test_http_routes_and_codes():
    eng = Engine(graph_from_reference(_graph()), device="cpu")
    srv = InferenceServer(eng, batch_size=4, max_retries=0)
    srv.start()
    front = HttpFrontend(srv, host="127.0.0.1", port=0, timeout_s=30,
                         max_body_bytes=4096)
    front.start()
    base = f"http://127.0.0.1:{front.port}"
    img = np.zeros(SHAPE, np.float32)
    try:
        assert _get(base, "/healthz") == (200, "ok\n")
        assert _get(base, "/nope")[0] == 404
        assert _post(base, _npy(img), "application/x-npy", "/nope")[0] == 404
        code, _, body = _post(base, b"not an array", "application/x-npy")
        assert code == 400 and body.startswith(b"bad request"), body
        code, _, body = _post(base, b"{", "application/json")
        assert code == 400 and body.startswith(b"bad request"), body
        code, _, body = _post(base, _npy(np.zeros((4, 4, 3), np.float32)),
                              "application/x-npy")
        assert code == 400 and body.startswith(b"bad shape"), body
        code, _, _ = _post(base, _npy(np.zeros((40, 40, 3), np.float32)),
                           "application/x-npy")
        assert code == 413
        assert _post(base, _npy(img), "application/x-npy")[0] == 200
        status, text = _get(base, "/metrics")
        assert status == 200 and "feathercnn_images 1" in text \
            and "feathercnn_faults 0" in text, text

        def boom(batch):
            raise RuntimeError("injected fault")

        srv._run_batch = srv._dispatch_batch = boom
        assert _post(base, _npy(img), "application/x-npy")[0] == 500
        srv._healthy.clear()
        assert _get(base, "/healthz") == (503, "unhealthy\n")
        assert "feathercnn_faults 1" in _get(base, "/metrics")[1]
        srv.stop()
        code, _, body = _post(base, _npy(img), "application/x-npy")
        assert code == 503 and b"closed or timed out" in body
    finally:
        front.stop()
        srv.stop()


def test_two_stage_npz_json_and_decode():
    from feathercnn_tpu.models import faster_rcnn_vgg16
    jg = faster_rcnn_vgg16(size=(96, 128), pre_nms_top_n=200,
                           post_nms_top_n=32)
    eng = Engine(graph_from_reference(jg), device="cpu")
    info = np.asarray([[96.0, 128.0, 1.0]], np.float32)
    img = np.random.default_rng(5).normal(size=(96, 128, 3)).astype(
        np.float32)
    direct = {k: v.numpy() for k, v in eng.run(
        {"data": img[None], "im_info": info}).items()}
    srv = InferenceServer(eng, batch_size=1, extra_inputs={"im_info": info})
    srv.start()
    front = HttpFrontend(srv, host="127.0.0.1", port=0)
    front.start()
    base = f"http://127.0.0.1:{front.port}"
    try:
        code, ctype, body = _post(base, _npy(img), "application/x-npy")
        assert (code, ctype) == (200, "application/x-npz")
        arch = np.load(io.BytesIO(body))
        assert sorted(arch.files) == sorted(eng.graph.outputs)
        code, ctype, body = _post(
            base, json.dumps({"data": img.tolist()}).encode(),
            "application/json")
        assert (code, ctype) == (200, "application/json")
        as_json = json.loads(body)["result"]
        in_process = srv.infer_outputs(img)
    finally:
        front.stop()
        srv.stop()
    for k, v in direct.items():
        assert torch.equal(torch.from_numpy(arch[k]),
                           torch.from_numpy(in_process[k])), k
        assert np.asarray(as_json[k], np.float32).tolist() == arch[k].tolist()
        np.testing.assert_allclose(arch[k], v.reshape(arch[k].shape),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    mine = decode_detections(arch["cls_prob"], arch["bbox_pred"],
                             arch["proposal"], (96, 128), score_thresh=0.0)
    ref = jdecode(arch["cls_prob"], arch["bbox_pred"], arch["proposal"],
                  (96, 128), score_thresh=0.0)
    assert mine.keys() == ref.keys() and len(mine) > 0
    for c in ref:
        assert mine[c].dtype == ref[c].dtype
        assert np.array_equal(mine[c], ref[c]), c


def test_cli_serves_over_http(tmp_path):
    g = graph_from_reference(_graph())
    path = str(tmp_path / "small.ftpu")
    save_ftpu(g, path)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    cmd = [sys.executable, "-m", "feathercnn_tpu_torch.serve", "--model",
           path, "--device", "cpu", "--dtype", "float32", "--host",
           "127.0.0.1", "--port", "0", "--batch-size", "4"]
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stderr=subprocess.PIPE,
                            text=True)
    try:
        lines = []
        for line in proc.stderr:
            lines.append(line)
            if line.startswith("serving on "):
                break
        assert lines and lines[-1].startswith("serving on 127.0.0.1:"), lines
        port = int(lines[-1].split()[2].rsplit(":", 1)[1])
        img = np.random.default_rng(2).normal(size=SHAPE).astype(np.float32)
        got, _ = _ask(f"http://127.0.0.1:{port}", img)
        want = Engine(g, device="cpu")(img[None])[0].numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        assert _get(f"http://127.0.0.1:{port}", "/healthz")[0] == 200
    finally:
        proc.terminate()
        assert proc.wait(timeout=60) == 0
    r = subprocess.run(cmd + ["--im-info", "10,10,1"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 2 and "no im_info input" in r.stderr, r.stderr
