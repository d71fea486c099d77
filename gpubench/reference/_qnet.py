"""The plain reference: a layer list run in PyTorch, in float32 or with
its products at a stated integer width.

An architecture module of this folder gives its layers as a list of dicts
(NHWC values, named after the layer that makes them; the graph input is
``"data"``):

    {"op": "conv", "name", "src", "cout", "k", "stride", "pad", "group",
     "bn": <prefix of the BatchNorm + Scale pair>, "relu"}
    {"op": "maxpool", "name", "src", "k", "stride", "pad"}   (Caffe's ceil rule)
    {"op": "avgpool", "name", "src"}                          (global)
    {"op": "add", "name", "srcs", "relu"}                     (Eltwise SUM)
    {"op": "fc", "name", "src", "cout"}

and the network's output is the softmax of the last layer.  Parameter
names are Caffe's: ``<conv>/w`` (HWIO), ``<bn>/bn/mean``, ``<bn>/bn/var``
(eps 1e-5), ``<bn>/scale/gamma``, ``<bn>/scale/beta``, ``<fc>/w`` (in, out),
``<fc>/b``.

The quantized forward follows the w8a8 scheme as the configuration states
it: BatchNorm folded into the conv in float64; weights symmetric per
output channel, ``amax / qmax``; every conv and FC input but the stem's
quantized per tensor at ``amax / qmax``, ``amax`` the largest magnitude
of that value in the float32 forward over the calibration batches; the
products summed exactly (integer grids in float32, TF32 off) and scaled
by ``w_scale * x_scale`` in float32, then bias and ReLU.  The stem (a
conv on the 3-channel input) keeps float input in the compute dtype with
its weight dequantized to it.  Values between layers travel as grids or
in the compute dtype as :class:`Quantized` says.  ``qmax`` is 127 at 8
bits and 7 at 4, the control's width.

It imports nothing of the program under test.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

EPS = 1e-5
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def no_tf32() -> None:
    """Full float32 products and convolutions on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def param_specs(layers: List[dict], channels: int = 3) -> List[tuple]:
    """``(name, shape, kind)`` of every parameter, in layer order; kind is
    ``weight``, ``mean``, ``var``, ``gamma``, ``beta`` or ``bias``."""
    ch = {"data": channels}
    out = []
    for L in layers:
        op = L["op"]
        if op == "conv":
            cin = ch[L["src"]]
            out.append((L["name"] + "/w",
                        (L["k"], L["k"], cin // L["group"], L["cout"]),
                        "weight"))
            bn = L["bn"]
            out += [(bn + "/bn/mean", (L["cout"],), "mean"),
                    (bn + "/bn/var", (L["cout"],), "var"),
                    (bn + "/scale/gamma", (L["cout"],), "gamma"),
                    (bn + "/scale/beta", (L["cout"],), "beta")]
            ch[L["name"]] = L["cout"]
        elif op == "fc":
            out += [(L["name"] + "/w", (ch[L["src"]], L["cout"]), "weight"),
                    (L["name"] + "/b", (L["cout"],), "bias")]
            ch[L["name"]] = L["cout"]
        elif op == "add":
            ch[L["name"]] = ch[L["srcs"][0]]
        else:
            ch[L["name"]] = ch[L["src"]]
    return out


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _oihw(w):
    return w.permute(3, 2, 0, 1)


def _maxpool(x, L):
    """Caffe's MAX pooling: ceil mode, the last window starting inside
    the (left-padded) input."""
    return F.max_pool2d(x, L["k"], L["stride"], L["pad"], ceil_mode=True)


def _conv_f32(x, w, b, L):
    y = F.conv2d(x, _oihw(w), None, L["stride"], L["pad"], 1, L["group"])
    if b is not None:
        y = y + b.view(1, -1, 1, 1)
    return y


def bn_affine(P: Dict[str, torch.Tensor], bn: str):
    """(scale, shift) of a BatchNorm + Scale pair, in float64."""
    inv = 1.0 / torch.sqrt(P[bn + "/bn/var"].double() + EPS)
    g = P[bn + "/scale/gamma"].double() * inv
    return g, P[bn + "/scale/beta"].double() - P[bn + "/bn/mean"].double() * g


def run_float(layers, P, x, record=None):
    """The float32 forward of NHWC ``x``; returns the logits (N, classes).
    ``record(value_name, tensor)`` sees every input of a conv, an FC and a
    residual add."""
    env = {"data": _nchw(x.float())}
    for L in layers:
        op = L["op"]
        if op in ("conv", "fc", "add") and record is not None:
            for v in L.get("srcs") or [L["src"]]:
                record(v, env[v])
        if op == "conv":
            g, s = bn_affine(P, L["bn"])
            w = (P[L["name"] + "/w"].double() * g).float()
            y = _conv_f32(env[L["src"]], w, s.float(), L)
            env[L["name"]] = torch.relu(y) if L["relu"] else y
        elif op == "maxpool":
            env[L["name"]] = _maxpool(env[L["src"]], L)
        elif op == "avgpool":
            env[L["name"]] = env[L["src"]].mean(dim=(2, 3), keepdim=True)
        elif op == "add":
            y = env[L["srcs"][0]] + env[L["srcs"][1]]
            env[L["name"]] = torch.relu(y) if L["relu"] else y
        elif op == "fc":
            f = env[L["src"]].flatten(1)
            env[L["name"]] = f @ P[L["name"] + "/w"].float() \
                + P[L["name"] + "/b"].float()
    return env[layers[-1]["name"]]


def calibrate(layers, P, batches) -> Dict[str, float]:
    """``amax`` of every value a conv, an FC or a residual add reads
    (``"data"`` among them), over the float32 forwards of ``batches``."""
    amax: Dict[str, float] = {}

    def record(name, t):
        amax[name] = max(amax.get(name, 0.0), float(t.abs().max()))

    for b in batches:
        run_float(layers, P, b, record)
    return amax


class Quantized:
    """The network with its weights folded and quantized once, at
    ``bits`` (8: the configuration; 4: the control).

    Which values travel as integer grids follows the scheme: a value is
    a grid at one scale when every reader takes it so (a conv or FC other
    than the stem at the value's own scale, a residual add whose output
    is a grid at the value's own scale, a max pool whose output is a grid
    at the pool output's scale); the network's input and output and a
    global pool's output never are.  A grid-valued add sums its dequantized operands in float32,
    applies its ReLU and quantizes again.  Every other value is held in
    the compute dtype, rounded once where it is made.  Sibling convs (two
    or more reading one value) share the largest of their output scales,
    as one merged conv has one.  ``amax`` must hold every value a conv
    reads and the output of each sibling conv."""

    def __init__(self, layers, P, amax: Dict[str, float], bits: int = 8,
                 compute_dtype: str = "bfloat16"):
        self.layers, self.bits = layers, bits
        self.qmax = float(2 ** (bits - 1) - 1)
        self.cdtype = DTYPES[compute_dtype]
        self.x_scale = {k: max(v, 1e-12) / self.qmax for k, v in amax.items()}
        siblings: Dict[str, list] = {}
        for L in layers:
            if L["op"] == "conv" and L["src"] != "data":
                siblings.setdefault(L["src"], []).append(L["name"])
        for sibs in siblings.values():
            if len(sibs) < 2:
                continue
            shared = max(self.x_scale[n] for n in sibs)
            for n in sibs:
                self.x_scale[n] = shared
        self.grid = self._grid_scales()
        self.w = {}
        for L in layers:
            if L["op"] == "conv":
                g, s = bn_affine(P, L["bn"])
                w = (P[L["name"] + "/w"].double() * g).float()
                self.w[L["name"]] = self._quant_w(w) + (s.float(),)
            elif L["op"] == "fc":
                self.w[L["name"]] = (self._quant_w(P[L["name"] + "/w"].float())
                                     + (P[L["name"] + "/b"].float(),))

    def _grid_scales(self) -> Dict[str, float]:
        """value -> the scale of its grid, for the values held as grids."""
        readers: Dict[str, list] = {}
        for L in self.layers:
            for v in L.get("srcs") or [L["src"]]:
                readers.setdefault(v, []).append(L)
        grid: Dict[str, float] = {}
        for L in reversed(self.layers):
            v = L["name"]
            if L["op"] == "avgpool":
                continue
            scales = set()
            for r in readers.get(v, []):
                if r["op"] in ("conv", "fc") or (r["op"] == "add"
                                                  and r["name"] in grid):
                    scales.add(self.x_scale.get(v))
                elif r["op"] == "maxpool" and r["name"] in grid:
                    scales.add(grid[r["name"]])
                else:
                    scales.add(None)
            if len(scales) == 1 and None not in scales:
                grid[v] = scales.pop()
        return grid

    def _quant_w(self, w):
        scale = w.reshape(-1, w.shape[-1]).abs().amax(0) / self.qmax
        scale = torch.clamp_min(scale, 1e-12)
        return torch.clamp(torch.round(w / scale), -self.qmax,
                           self.qmax), scale

    def _quant(self, x, scale: float):
        s = torch.tensor(scale, dtype=torch.float32, device=x.device)
        return torch.clamp(torch.round(x.float() / s), -self.qmax, self.qmax)

    def _out(self, y, name):
        """A made value as it is held: its grid, or the compute dtype."""
        if name in self.grid:
            return self._quant(y, self.grid[name])
        return y.to(self.cdtype).float()

    def transfer(self, x):
        """An image as the server's ingest quantizes it: the input's grid
        at its calibrated scale, back to float."""
        return self._quant(x, self.x_scale["data"]) * self.x_scale["data"]

    def logits(self, x):
        """Logits (float32) of NHWC ``x``: the float image, or what
        :meth:`transfer` made of it."""
        env = {"data": _nchw(x.float())}
        for L in self.layers:
            self.apply(L, env)
        return env[self.layers[-1]["name"]]

    def value(self, env, v):
        """A reader's view of value ``v`` of ``env`` in float32."""
        return env[v] * self.grid[v] if v in self.grid else env[v]

    def apply(self, L, env) -> None:
        """Layer ``L``: its value, as it is held, into ``env`` (NCHW,
        name -> grid or float32) from the values it reads there."""
        op, name = L["op"], L["name"]
        if op in ("conv", "fc"):
            wq, ws, bias = self.w[name]
            src = L["src"]
            if src == "data":      # the stem: float input
                xin = env[src].to(self.cdtype).float()
                w = (wq * ws).to(self.cdtype).float()
                y = _conv_f32(xin, w, bias, L)
            else:
                xs = self.x_scale[src]
                xq = env[src] if src in self.grid else self._quant(
                    env[src], xs)
                xs = torch.tensor(xs, dtype=torch.float32, device=xq.device)
                if op == "conv":
                    acc = _conv_f32(xq, wq, None, L)
                    y = acc * ws.view(1, -1, 1, 1) * xs + bias.view(
                        1, -1, 1, 1)
                else:
                    y = (xq.flatten(1) @ wq) * ws * xs + bias
            if op == "conv" and L["relu"]:
                y = torch.relu(y)
            env[name] = self._out(y, name)
        elif op == "maxpool":
            env[name] = _maxpool(env[L["src"]], L)
            if name in self.grid and L["src"] not in self.grid:
                env[name] = self._quant(env[name], self.grid[name])
        elif op == "avgpool":
            env[name] = self._out(self.value(env, L["src"]).mean(
                dim=(2, 3), keepdim=True), name)
        elif op == "add":
            a, b = (self.value(env, v) for v in L["srcs"])
            if name in self.grid:
                y = a + b
            else:
                y = (a.to(self.cdtype) + b.to(self.cdtype)).float()
            env[name] = self._out(torch.relu(y) if L["relu"] else y, name)


def init_weights(layers, seed: int, device, channels: int, hw,
                 init: dict):
    """Seeded weights on ``device``, from one ``torch.Generator`` in a few
    large draws: He-normal conv and FC weights, Scale gamma |N(1, 0.1)|
    and beta N(0, 0.1); each BatchNorm's mean and variance are the
    statistics of its conv's output on a seeded batch of ``init_batch``
    images, as a trained network's are of its data, so every layer sees
    activations of the range a deployment sees; the FC's weight is scaled
    so that its logits have the standard deviation ``init["logit_std"]``
    across that batch's images, and its bias, N(0, 0.1), less the mean
    logit over the batch, so that the classes an image scores high on are
    its own and not the batch's.  ``init["beta_mean"]`` shifts every
    beta, and the gamma of a conv marked ``"residual"`` (the last of a
    residual branch) is scaled by ``init["residual_gamma"]``: a random
    network at unit gains amplifies a small error from layer to layer,
    as a trained one does not, and these two choices keep it stable
    (an input perturbed by 1e-4 moves the logits by about 4e-4 in
    ResNet-50 and 6e-4 in MobileNet-v1)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (2 ** 63))
    specs = param_specs(layers, channels)
    gain = {L["bn"] + "/scale/gamma": init["residual_gamma"]
            for L in layers if L.get("residual")}
    weights = [(n, s) for n, s, k in specs if k == "weight"]
    total = sum(math.prod(s) for _, s in weights)
    flat = torch.randn(total, generator=gen, device=device)
    P, off = {}, 0
    for n, s in weights:
        k = math.prod(s)
        fan_in = math.prod(s[:-1])
        P[n] = flat[off:off + k].view(s) * math.sqrt(2.0 / fan_in)
        off += k
    small = [(n, s, k) for n, s, k in specs if k != "weight"]
    flat = torch.randn(sum(s[0] for _, s, _ in small), generator=gen,
                       device=device)
    off = 0
    for n, s, k in small:
        v = flat[off:off + s[0]]
        off += s[0]
        P[n] = ((1.0 + 0.1 * v).abs() * gain.get(n, 1.0) if k == "gamma"
                else init["beta_mean"] + 0.1 * v if k == "beta" else 0.1 * v)
    x = torch.randn((init["batch"],) + tuple(hw) + (channels,), generator=gen,
                    device=device)
    env = {"data": _nchw(x)}
    for L in layers:
        op, name = L["op"], L["name"]
        if op == "conv":
            z = _conv_f32(env[L["src"]], P[name + "/w"], None, L)
            bn = L["bn"]
            P[bn + "/bn/mean"] = z.mean(dim=(0, 2, 3))
            P[bn + "/bn/var"] = z.var(dim=(0, 2, 3))
            g, s = bn_affine(P, bn)
            y = z * g.float().view(1, -1, 1, 1) + s.float().view(1, -1, 1, 1)
            env[name] = torch.relu(y) if L["relu"] else y
        elif op == "maxpool":
            env[name] = _maxpool(env[L["src"]], L)
        elif op == "avgpool":
            env[name] = env[L["src"]].mean(dim=(2, 3), keepdim=True)
        elif op == "add":
            y = env[L["srcs"][0]] + env[L["srcs"][1]]
            env[name] = torch.relu(y) if L["relu"] else y
        elif op == "fc":
            f = env[L["src"]].flatten(1)
            z = f @ P[name + "/w"]
            w = P[name + "/w"] * (init["logit_std"] / (z - z.mean(0)).std())
            P[name + "/w"] = w
            P[name + "/b"] = P[name + "/b"] - f.mean(0) @ w
            env[name] = f @ w + P[name + "/b"]
    return {n: P[n].contiguous() for n, _, _ in specs}
