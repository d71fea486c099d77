"""The port's Caffe converter and its helpers
(``feathercnn_tpu_torch/tools/{caffe_pb,prototxt,synth_caffemodel,
convert_caffe}.py``, own copies that import nothing of the JAX package)
against the reference's (``tools/``), on the CPU:

- the seeded synthetic caffemodel of each committed deploy is the
  reference's byte for byte, and the wire codec encodes and parses alike;
- the two deploys and the converter fixtures of tests/test_converter.py
  (copied here: a conv/BN/Scale/FC net through the wire, V1 layers,
  Interp, Deconvolution + Crop, ShuffleChannel + Threshold, a negative
  axis) convert to the reference's graph node for node, attributes, specs
  and meta equal, every weight bit for bit;
- a ``.ftpu`` that either package's converter CLI writes loads in the
  other package to the same graph.

Few test items per file: see tests/test_torch_kernels.py.
"""

import os
import sys

import numpy as np

from feathercnn_tpu import model_format as jformat
from feathercnn_tpu_torch import model_format
from feathercnn_tpu_torch.tools import caffe_pb, convert_caffe, prototxt
from feathercnn_tpu_torch.tools.synth_caffemodel import synth_net
from test_torch_classic_zoo import _same_graph

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)
DEPLOYS = os.path.join(ROOT, "tools", "deploys")
DEPLOY_FILES = ("squeezenet_v11_deploy.prototxt", "resnet50_deploy.prototxt")

from tools import caffe_pb as jpb  # noqa: E402
from tools import convert_caffe as jconvert  # noqa: E402
from tools.prototxt import parse_prototxt as jparse  # noqa: E402
from tools.synth_caffemodel import synth_net as jsynth  # noqa: E402


def _blob(arr):
    arr = np.asarray(arr, np.float32)
    return {"shape": {"dim": list(arr.shape)}, "data": arr.ravel()}


def _fixtures(rng):
    """name -> (deploy dict or prototxt text, weights through the wire or
    None): tests/test_converter.py's nets."""
    C1, C2, FC = 5, 8, 4
    synth = {"name": "synth", "input": ["data"], "input_dim": [1, 3, 16, 16],
             "layer": [
        {"name": "conv1", "type": "Convolution", "bottom": ["data"],
         "top": ["conv1"],
         "convolution_param": {"num_output": C1, "kernel_size": [3],
                               "pad": [1], "stride": [2]},
         "blobs": [_blob(rng.normal(size=(C1, 3, 3, 3))),
                   _blob(rng.normal(size=(C1,)))]},
        {"name": "relu1", "type": "ReLU", "bottom": ["conv1"],
         "top": ["conv1"]},
        {"name": "pool1", "type": "Pooling", "bottom": ["conv1"],
         "top": ["pool1"],
         "pooling_param": {"pool": 0, "kernel_size": 3, "stride": 2}},
        {"name": "conv2", "type": "Convolution", "bottom": ["pool1"],
         "top": ["conv2"],
         "convolution_param": {"num_output": C2, "kernel_size": [1],
                               "bias_term": False},
         "blobs": [_blob(rng.normal(size=(C2, C1, 1, 1)))]},
        {"name": "bn2", "type": "BatchNorm", "bottom": ["conv2"],
         "top": ["conv2"], "batch_norm_param": {"eps": 1e-5},
         "blobs": [_blob(rng.normal(size=(C2,)) * 2),
                   _blob(np.abs(rng.normal(1, 0.1, size=(C2,))) * 2),
                   _blob([2.0])]},
        {"name": "scale2", "type": "Scale", "bottom": ["conv2"],
         "top": ["conv2"], "scale_param": {"bias_term": True},
         "blobs": [_blob(rng.normal(1, 0.2, size=(C2,))),
                   _blob(rng.normal(size=(C2,)))]},
        {"name": "relu2", "type": "ReLU", "bottom": ["conv2"],
         "top": ["conv2"]},
        {"name": "fc", "type": "InnerProduct", "bottom": ["conv2"],
         "top": ["fc"], "inner_product_param": {"num_output": FC},
         "blobs": [_blob(rng.normal(size=(FC, C2 * 4 * 4))),
                   _blob(rng.normal(size=(FC,)))]},
        {"name": "prob", "type": "Softmax", "bottom": ["fc"],
         "top": ["prob"]}]}
    v1 = {"name": "old", "input": ["data"], "input_dim": [1, 3, 4, 4],
          "layers": [{"name": "conv1", "type": 4, "bottom": ["data"],
                      "top": ["conv1"],
                      "convolution_param": {"num_output": 2,
                                            "kernel_size": [1]},
                      "blobs": [_blob(rng.normal(size=(2, 3, 1, 1)))]}]}
    interp = {"name": "interpmini", "input": ["data"],
              "input_dim": [1, 3, 10, 10], "layer": [
        {"name": "up", "type": "Interp", "bottom": ["data"], "top": ["up"],
         "interp_param": {"zoom_factor": 4, "pad_beg": -1 + 2 ** 64,
                          "pad_end": -1 + 2 ** 64}}]}
    deconv = {"name": "fcnmini", "input": ["data"],
              "input_dim": [1, 6, 8, 8], "layer": [
        {"name": "up", "type": "Deconvolution", "bottom": ["data"],
         "top": ["up"],
         "convolution_param": {"num_output": 6, "kernel_size": [4],
                               "stride": [2], "pad": [1], "group": 2},
         "blobs": [_blob(rng.normal(size=(6, 3, 4, 4))),
                   _blob(rng.normal(size=(6,)))]},
        {"name": "crop", "type": "Crop", "bottom": ["up", "data"],
         "top": ["crop"], "crop_param": {"axis": 2, "offset": [1]}}]}
    shuffle = '''
    name: "shuf"
    input: "data"
    input_dim: 1 input_dim: 6 input_dim: 4 input_dim: 4
    layer { name: "shuffle" type: "ShuffleChannel"
            bottom: "data" top: "shuffle" shuffle_channel_param { group: 3 } }
    layer { name: "thr" type: "Threshold" bottom: "shuffle" top: "thr"
            threshold_param { threshold: 0.1 } }
    '''
    negax = {"name": "negax", "input": ["data"], "input_dim": [1, 3, 2, 2],
             "layer": [
        {"name": "fc", "type": "InnerProduct", "bottom": ["data"],
         "top": ["fc"],
         "inner_product_param": {"num_output": 4, "bias_term": False},
         "blobs": [_blob(rng.normal(size=(4, 12)))]},
        {"name": "tile", "type": "Tile", "bottom": ["fc"], "top": ["tile"],
         "tile_param": {"axis": -1, "tiles": 2}},
        {"name": "red", "type": "Reduction", "bottom": ["tile"],
         "top": ["red"],
         "reduction_param": {"operation": 1, "axis": -1}}]}
    return {"synth": (synth, True), "v1": (v1, True),
            "interp": (interp, True), "deconv": (deconv, True),
            "shuffle": (shuffle, False), "negax": (negax, False)}


def test_synthetic_caffemodel_and_codec_are_the_references():
    """The seeded caffemodel of each deploy (seeds 0 and 1) is the
    reference's byte for byte; a net encodes to the same bytes and parses
    to the same dict through both codecs; the text parser gives the same
    dict."""
    for fn in DEPLOY_FILES:
        with open(os.path.join(DEPLOYS, fn)) as f:
            text = f.read()
        assert prototxt.parse_prototxt(text) == jparse(text), fn
        for seed in (0, 1):
            assert synth_net(text, seed) == jsynth(text, seed), (fn, seed)
    net = _fixtures(np.random.default_rng(0))["synth"][0]
    raw = caffe_pb.encode(net, caffe_pb.NET_PARAMETER)
    assert raw == jpb.encode(net, jpb.NET_PARAMETER)
    mine, ref = caffe_pb.parse_net(raw), jpb.parse_net(raw)
    assert mine.keys() == ref.keys()
    for a, b in zip(mine["layer"], ref["layer"]):
        assert {k: v for k, v in a.items() if k != "blobs"} == \
            {k: v for k, v in b.items() if k != "blobs"}
        for x, y in zip(a.get("blobs", []), b.get("blobs", [])):
            np.testing.assert_array_equal(x["data"], y["data"])


def test_deploys_convert_to_the_references_graph(tmp_path):
    """ResNet-50 and SqueezeNet v1.1 with their seeded caffemodels, at the
    deploy's batch and at batch 2: the reference's graph, node for node and
    bit for bit."""
    for fn in DEPLOY_FILES:
        deploy = os.path.join(DEPLOYS, fn)
        with open(deploy) as f:
            model = str(tmp_path / (fn + ".caffemodel"))
            with open(model, "wb") as out:
                out.write(synth_net(f.read(), seed=0))
        for batch in (None, 2):
            _same_graph(jconvert.convert(deploy, model, batch=batch),
                        convert_caffe.convert(deploy, model, batch=batch),
                        (fn, batch))


def test_converter_fixtures_convert_to_the_references_graph():
    """tests/test_converter.py's nets, through the wire where the
    reference's tests send them: the same graph from both converters."""
    for name, (net, wire) in _fixtures(np.random.default_rng(1)).items():
        if isinstance(net, str):
            mine = convert_caffe.Converter(prototxt.parse_prototxt(net))
            ref = jconvert.Converter(jparse(net))
        elif wire:
            raw = jpb.encode(net, jpb.NET_PARAMETER)
            parsed, jparsed = caffe_pb.parse_net(raw), jpb.parse_net(raw)
            mine = convert_caffe.Converter(parsed, parsed)
            ref = jconvert.Converter(jparsed, jparsed)
        else:
            mine, ref = convert_caffe.Converter(net), jconvert.Converter(net)
        _same_graph(ref.convert(), mine.convert(), name)


def test_ftpu_files_load_in_the_other_package(tmp_path, capsys):
    """The converter CLIs: each package's ``.ftpu`` of the SqueezeNet
    deploy loads in the other package to the same graph, and the two files
    are byte-identical."""
    deploy = os.path.join(DEPLOYS, "squeezenet_v11_deploy.prototxt")
    model = str(tmp_path / "s.caffemodel")
    with open(deploy) as f, open(model, "wb") as out:
        out.write(jsynth(f.read(), seed=2))
    mine, ref = str(tmp_path / "mine.ftpu"), str(tmp_path / "ref.ftpu")
    assert convert_caffe.main([deploy, model, mine, "--batch", "3"]) == 0
    assert "wrote" in capsys.readouterr().out
    jformat.save_ftpu(jconvert.convert(deploy, model, batch=3), ref)
    with open(mine, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    _same_graph(jformat.load_ftpu(mine), model_format.load_ftpu(ref), "x")
    _same_graph(jformat.load_ftpu(ref), model_format.load_ftpu(mine), "y")
