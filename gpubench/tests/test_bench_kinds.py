"""The reference's layer kinds on hand-made tensors: the windowed AVE pool
against Caffe's loop, a concat on its output's grid, and a conv with no
BatchNorm."""

import torch

import flops
from reference import _qnet

INIT = {"batch": 4, "logit_std": 4.0, "beta_mean": 0.0, "residual_gamma": 1.0}


def caffe_ave(x, k, s, p, oh, ow):
    """Caffe's PoolingLayer AVE loop over NCHW ``x``."""
    n, c, h, w = x.shape
    y = torch.zeros(n, c, oh, ow, dtype=torch.float64)
    for i in range(oh):
        for j in range(ow):
            hs, ws = i * s - p, j * s - p
            he, we = min(hs + k, h + p), min(ws + k, w + p)
            size = (he - hs) * (we - ws)
            hs, ws, he, we = max(hs, 0), max(ws, 0), min(he, h), min(we, w)
            y[:, :, i, j] = x[:, :, hs:he, ws:we].double().sum((2, 3)) / size
    return y


def test_windowed_avgpool_clips_its_denominators():
    """3x3/2 pad 1 over 6x7: the ceil rule gives 4x4, whose first window
    reaches into the padding (3 of which 2 are real) and whose last is
    clipped at the padded extent (2, of which 1 is real)."""
    L = {"op": "avgpool", "name": "p", "src": "data", "k": 3, "stride": 2,
         "pad": 1}
    ones = _qnet._avgpool(torch.ones(1, 1, 6, 7), L)
    assert ones.shape == (1, 1, 4, 4)
    rows = torch.tensor([2 / 3, 1.0, 1.0, 1 / 2])
    cols = torch.tensor([2 / 3, 1.0, 1.0, 2 / 3])
    assert torch.allclose(ones[0, 0], torch.outer(rows, cols))
    x = torch.randn(2, 5, 6, 7, generator=torch.Generator().manual_seed(0))
    y = _qnet._avgpool(x, L)
    assert torch.allclose(y.double(), caffe_ave(x, 3, 2, 1, 4, 4), atol=1e-6)
    sh = flops.shapes([L], {"input_hw": [6, 7], "channels": 5})
    assert sh["p"] == (4, 4, 5) == tuple(y.shape[2:]) + (5,)
    # without k the pool stays global
    g = _qnet._avgpool(x, {"op": "avgpool", "name": "g", "src": "data"})
    assert torch.equal(g, x.mean(dim=(2, 3), keepdim=True))


def tiny():
    """A stem, two convs of no pair, their concat and its reader."""
    def conv(name, src, cout, k, bn=None):
        return {"op": "conv", "name": name, "src": src, "cout": cout, "k": k,
                "stride": 1, "pad": k // 2, "group": 1, "bn": bn,
                "relu": bn is not None}
    layers = [conv("s", "data", 8, 3, bn="s"),
              {"op": "bn", "name": "s/scale", "src": "s", "bn": "pre",
               "relu": True},
              conv("a", "s/scale", 4, 1), conv("b", "a", 4, 3),
              {"op": "concat", "name": "c", "srcs": ["a", "b"]},
              conv("d", "c", 6, 1, bn="d"),
              {"op": "avgpool", "name": "g", "src": "d"},
              {"op": "fc", "name": "f", "src": "g", "cout": 5}]
    P = _qnet.init_weights(layers, 3, "cpu", 3, (8, 8), INIT)
    x = torch.randn(4, 8, 8, 3, generator=torch.Generator().manual_seed(1))
    return layers, P, x, _qnet.calibrate(layers, P, [x])


def test_concat_on_its_grid_passes_its_operands_through():
    """Where both operands are held on the concat's grid (``a`` calibrated
    at the concat's scale), the concat is their grids side by side, bit
    for bit; where one is not, it requantizes each operand from its own
    scale."""
    layers, P, x, amax = tiny()
    assert amax.keys() >= {"data", "s", "s/scale", "a", "b", "c", "g"}
    amax["a"] = amax["b"] = amax["c"] = max(amax[v] for v in "abc")
    net = _qnet.Quantized(layers, P, amax)
    assert net.grid["a"] == net.grid["b"] == net.grid["c"]
    assert not net.requantizing
    env = {"data": _qnet._nchw(x)}
    for L in layers:
        net.apply(L, env)
    assert torch.equal(env["c"], torch.cat([env["a"], env["b"]], 1))

    amax["a"] = amax["c"] / 2          # a read by b at its own scale
    net = _qnet.Quantized(layers, P, amax)
    assert net.requantizing == {"c"}
    assert net.grid["a"] == net.x_scale["a"] != net.grid["c"]
    env = {"data": _qnet._nchw(x)}
    for L in layers:
        net.apply(L, env)
    both = torch.cat([env["a"] * net.grid["a"], env["b"] * net.grid["b"]], 1)
    assert torch.equal(env["c"], net._quant(both, net.grid["c"]))


def test_conv_without_batchnorm_adds_no_parameters():
    layers, P, x, amax = tiny()
    specs = dict((n, s) for n, s, _ in _qnet.param_specs(layers))
    assert [n for n in specs if n.startswith(("a/", "b/"))] == ["a/w", "b/w"]
    assert specs["b/w"] == (3, 3, 4, 4)
    assert set(P) == set(specs)
    net = _qnet.Quantized(layers, P, amax)
    assert net.w["a"][2] is None and net.w["b"][2] is None
    # the float forward is the plain conv of the weight as drawn
    env = {"data": _qnet._nchw(x)}
    for L in layers[:3]:
        env[L["name"]] = _qnet.KINDS[L["op"]].forward(L, env, P)
    assert torch.equal(env["a"], torch.nn.functional.conv2d(
        env["s/scale"], _qnet._oihw(P["a/w"])))
    assert net.logits(x).shape == (4, 5)
