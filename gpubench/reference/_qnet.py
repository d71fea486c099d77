"""The plain reference: a layer list run in PyTorch, in float32 or with
its products at a stated integer width.

An architecture module of this folder gives its layers as a list of dicts
(NHWC values, named after the layer that makes them; the graph input is
``"data"``):

    {"op": "conv", "name", "src", "cout", "k", "stride", "pad", "group",
     "bn": <prefix of the BatchNorm + Scale pair after it, or None>,
     "relu"}
    {"op": "bn", "name", "src", "bn", "relu"}    (a pair standing alone)
    {"op": "maxpool", "name", "src", "k", "stride", "pad"}   (Caffe's ceil rule)
    {"op": "avgpool", "name", "src"}                          (global)
    {"op": "avgpool", "name", "src", "k", "stride", "pad"}    (windowed)
    {"op": "add", "name", "srcs", "relu"}                     (Eltwise SUM)
    {"op": "concat", "name", "srcs"}                          (channels)
    {"op": "fc", "name", "src", "cout"}

and the network's output is the softmax of the last layer.  Parameter
names are Caffe's: ``<conv>/w`` (HWIO), ``<bn>/bn/mean``, ``<bn>/bn/var``
(eps 1e-5), ``<bn>/scale/gamma``, ``<bn>/scale/beta``, ``<fc>/w`` (in, out),
``<fc>/b``.  A conv whose ``bn`` is None has neither a pair nor a bias.
A windowed AVE pool follows Caffe: its output size by the ceil rule, each
window's sum over the window clipped to the padded extent (padding counts
as zeros) and divided by that clipped window's size.

Each kind is one class of ``KINDS``: its parameters, channels, float
forward, seeded set-up, quantized forward and the scale at which it reads
a value as a grid; every walk of the list below asks the layer's kind.

The quantized forward follows the w8a8 scheme as the configuration states
it: BatchNorm folded into the conv in float64; weights symmetric per
output channel, ``amax / qmax``; every conv and FC input but the stem's
quantized per tensor at ``amax / qmax``, ``amax`` the largest magnitude
of that value in the float32 forward over the calibration batches; the
products summed exactly (integer grids in float32, TF32 off) and scaled
by ``w_scale * x_scale`` in float32, then bias and ReLU.  The stem (a
conv on the 3-channel input) keeps float input in the compute dtype with
its weight dequantized to it.  A standalone pair, an add, a concat and a
windowed AVE pool compute in float32 from their operands dequantized (a
float operand as it is held) and are rounded once where their value is
made.  Values between layers travel as grids or in the compute dtype as
:class:`Quantized` says.  ``qmax`` is 127 at 8 bits and 7 at 4, the
control's width.

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


def reads(L) -> List[str]:
    """The values layer ``L`` reads, in order."""
    return L.get("srcs") or [L["src"]]


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _oihw(w):
    return w.permute(3, 2, 0, 1)


def _relu(y, L):
    return torch.relu(y) if L["relu"] else y


def _maxpool(x, L):
    """Caffe's MAX pooling: ceil mode, the last window starting inside
    the (left-padded) input."""
    return F.max_pool2d(x, L["k"], L["stride"], L["pad"], ceil_mode=True)


def _window_sizes(n: int, L, out: int) -> torch.Tensor:
    """Caffe's AVE denominators along one axis of ``n``: each window from
    ``o * stride - pad`` to that plus ``k``, clipped at ``n + pad``."""
    start = torch.arange(out, dtype=torch.float32) * L["stride"] - L["pad"]
    return torch.clamp_max(start + L["k"], n + L["pad"]) - start


def _avgpool(x, L):
    """AVE pooling: global without ``k``; else Caffe's windows (the MAX
    pool's output size, zeros in the padding, clipped denominators)."""
    if "k" not in L:
        return x.mean(dim=(2, 3), keepdim=True)
    sums = F.avg_pool2d(x, L["k"], L["stride"], L["pad"], ceil_mode=True,
                        divisor_override=1)
    (h, w), (oh, ow) = x.shape[2:], sums.shape[2:]
    size = torch.outer(_window_sizes(h, L, oh), _window_sizes(w, L, ow))
    return sums / size.to(x.device)


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


def _pair_specs(bn: str, c: int) -> List[tuple]:
    return [(bn + "/bn/mean", (c,), "mean"), (bn + "/bn/var", (c,), "var"),
            (bn + "/scale/gamma", (c,), "gamma"),
            (bn + "/scale/beta", (c,), "beta")]


def _pair(P, bn: str, z):
    """The pair ``bn`` over ``z`` (NCHW float32), its affine in float32."""
    g, s = bn_affine(P, bn)
    return z * g.float().view(1, -1, 1, 1) + s.float().view(1, -1, 1, 1)


def _settle_pair(P, bn: str, z):
    """The pair over ``z`` with its mean and variance those of ``z``, as a
    trained network's are of its data."""
    P[bn + "/bn/mean"] = z.mean(dim=(0, 2, 3))
    P[bn + "/bn/var"] = z.var(dim=(0, 2, 3))
    return _pair(P, bn, z)


class Kind:
    """A layer kind.  The defaults are those of a layer of one input with
    no parameters, which keeps the channels it reads and reads no value
    as a grid."""

    def params(self, L, ch) -> List[tuple]:
        """``(name, shape, kind)`` of its parameters; ``ch`` maps each
        value made so far to its channels."""
        return []

    def channels(self, L, ch) -> int:
        return ch[L["src"]]

    def records(self, L) -> bool:
        """Whether ``calibrate`` records the values it reads."""
        return False

    def holds_grid(self, L) -> bool:
        """Whether its value may be held as a grid."""
        return True

    def forward(self, L, env, P):
        """Its float32 value (NCHW) from the values in ``env``."""
        raise NotImplementedError

    def settle(self, L, env, P, init):
        """Its value in ``init_weights``' seeded forward, where it may set
        parameters in ``P`` from what it reads."""
        return self.forward(L, env, P)

    def prepare(self, net, L, P):
        """What :class:`Quantized` keeps of its parameters, or None."""
        return None

    def wants(self, net, L, v, grid):
        """The scale at which it reads value ``v`` as a grid, or None.
        ``grid`` holds the values after it in the list."""
        return None

    def apply(self, net, L, env):
        """Its value as :class:`Quantized` holds it."""
        raise NotImplementedError


class _Requant(Kind):
    """A layer that reads each value as a grid at the value's own
    calibrated scale when its own value is a grid, computes in float32
    from its operands dequantized and rounds once where its value is
    made."""

    def records(self, L):
        return True

    def wants(self, net, L, v, grid):
        return net.x_scale.get(v) if L["name"] in grid else None

    def apply(self, net, L, env):
        return net._out(self.compute(net, L, [net.value(env, v)
                                              for v in reads(L)]),
                        L["name"])


class _Weighted(Kind):
    """A conv or an FC: weights per output channel at ``bits``, its input
    at its own calibrated scale."""

    def records(self, L):
        return True

    def wants(self, net, L, v, grid):
        return net.x_scale.get(v)

    def apply(self, net, L, env):
        op, name = L["op"], L["name"]
        wq, ws, bias = net.w[name]
        src = L["src"]
        if src == "data":      # the stem: float input
            xin = env[src].to(net.cdtype).float()
            w = (wq * ws).to(net.cdtype).float()
            y = _conv_f32(xin, w, bias, L)
        else:
            xs = net.x_scale[src]
            xq = env[src] if src in net.grid else net._quant(env[src], xs)
            xs = torch.tensor(xs, dtype=torch.float32, device=xq.device)
            if op == "conv":
                acc = _conv_f32(xq, wq, None, L)
                y = acc * ws.view(1, -1, 1, 1) * xs
                if bias is not None:
                    y = y + bias.view(1, -1, 1, 1)
            else:
                y = (xq.flatten(1) @ wq) * ws * xs + bias
        if op == "conv" and L["relu"]:
            y = torch.relu(y)
        return net._out(y, name)


class Conv(_Weighted):
    def params(self, L, ch):
        out = [(L["name"] + "/w",
                (L["k"], L["k"], ch[L["src"]] // L["group"], L["cout"]),
                "weight")]
        return out + (_pair_specs(L["bn"], L["cout"]) if L["bn"] else [])

    def channels(self, L, ch):
        return L["cout"]

    def forward(self, L, env, P):
        w = P[L["name"] + "/w"]
        if L["bn"]:
            g, s = bn_affine(P, L["bn"])
            y = _conv_f32(env[L["src"]], (w.double() * g).float(), s.float(),
                          L)
        else:
            y = _conv_f32(env[L["src"]], w.float(), None, L)
        return _relu(y, L)

    def settle(self, L, env, P, init):
        z = _conv_f32(env[L["src"]], P[L["name"] + "/w"], None, L)
        return _relu(_settle_pair(P, L["bn"], z) if L["bn"] else z, L)

    def prepare(self, net, L, P):
        w = P[L["name"] + "/w"]
        if not L["bn"]:
            return net._quant_w(w.float()) + (None,)
        g, s = bn_affine(P, L["bn"])
        return net._quant_w((w.double() * g).float()) + (s.float(),)


class FC(_Weighted):
    def params(self, L, ch):
        return [(L["name"] + "/w", (ch[L["src"]], L["cout"]), "weight"),
                (L["name"] + "/b", (L["cout"],), "bias")]

    def channels(self, L, ch):
        return L["cout"]

    def forward(self, L, env, P):
        return env[L["src"]].flatten(1) @ P[L["name"] + "/w"].float() \
            + P[L["name"] + "/b"].float()

    def settle(self, L, env, P, init):
        """Weights scaled to logits of standard deviation
        ``init["logit_std"]`` across the batch's images, the bias less the
        batch's mean logit."""
        name = L["name"]
        f = env[L["src"]].flatten(1)
        z = f @ P[name + "/w"]
        w = P[name + "/w"] * (init["logit_std"] / (z - z.mean(0)).std())
        P[name + "/w"] = w
        P[name + "/b"] = P[name + "/b"] - f.mean(0) @ w
        return f @ w + P[name + "/b"]

    def prepare(self, net, L, P):
        return (net._quant_w(P[L["name"] + "/w"].float())
                + (P[L["name"] + "/b"].float(),))


class Pair(_Requant):
    """A BatchNorm + Scale pair standing alone (a pre-activation), its
    affine in float32 and an optional ReLU."""

    def params(self, L, ch):
        return _pair_specs(L["bn"], ch[L["src"]])

    def forward(self, L, env, P):
        return _relu(_pair(P, L["bn"], env[L["src"]]), L)

    def settle(self, L, env, P, init):
        return _relu(_settle_pair(P, L["bn"], env[L["src"]]), L)

    def prepare(self, net, L, P):
        g, s = bn_affine(P, L["bn"])
        return g.float().view(1, -1, 1, 1), s.float().view(1, -1, 1, 1)

    def compute(self, net, L, xs):
        g, s = net.w[L["name"]]
        return _relu(xs[0] * g + s, L)


class MaxPool(Kind):
    """Reads its input as a grid at its own output's scale: MAX commutes
    with the rounding."""

    def forward(self, L, env, P):
        return _maxpool(env[L["src"]], L)

    def wants(self, net, L, v, grid):
        return grid.get(L["name"])

    def apply(self, net, L, env):
        y = _maxpool(env[L["src"]], L)
        if L["name"] in net.grid and L["src"] not in net.grid:
            y = net._quant(y, net.grid[L["name"]])
        return y


class AvgPool(_Requant):
    """A global pool's value is never a grid, nor is its input read as
    one; a windowed pool's is as :class:`_Requant` says."""

    def records(self, L):
        return "k" in L

    def holds_grid(self, L):
        return "k" in L

    def forward(self, L, env, P):
        return _avgpool(env[L["src"]], L)

    def compute(self, net, L, xs):
        return _avgpool(xs[0], L)


class Add(_Requant):
    def channels(self, L, ch):
        return ch[L["srcs"][0]]

    def forward(self, L, env, P):
        return _relu(env[L["srcs"][0]] + env[L["srcs"][1]], L)

    def apply(self, net, L, env):
        a, b = (net.value(env, v) for v in L["srcs"])
        if L["name"] in net.grid:
            y = a + b
        else:
            y = (a.to(net.cdtype) + b.to(net.cdtype)).float()
        return net._out(_relu(y, L), L["name"])


class Concat(_Requant):
    """Along the channels, in order.  Whose value is a grid, it reads its
    operands at that grid (passing them through) where every operand is
    held on it, and else each at the operand's own scale (requantizing):
    see :meth:`Quantized._grid_scales`."""

    def channels(self, L, ch):
        return sum(ch[v] for v in L["srcs"])

    def forward(self, L, env, P):
        return torch.cat([env[v] for v in L["srcs"]], dim=1)

    def wants(self, net, L, v, grid):
        if L["name"] in net.requantizing:
            return super().wants(net, L, v, grid)
        return grid.get(L["name"])

    def compute(self, net, L, xs):
        return torch.cat(xs, dim=1)


KINDS = {"conv": Conv(), "fc": FC(), "bn": Pair(), "maxpool": MaxPool(),
         "avgpool": AvgPool(), "add": Add(), "concat": Concat()}


def param_specs(layers: List[dict], channels: int = 3) -> List[tuple]:
    """``(name, shape, kind)`` of every parameter, in layer order; kind is
    ``weight``, ``mean``, ``var``, ``gamma``, ``beta`` or ``bias``."""
    ch = {"data": channels}
    out = []
    for L in layers:
        kind = KINDS[L["op"]]
        out += kind.params(L, ch)
        ch[L["name"]] = kind.channels(L, ch)
    return out


def run_float(layers, P, x, record=None):
    """The float32 forward of NHWC ``x``; returns the logits (N, classes).
    ``record(value_name, tensor)`` sees every value a layer may read as a
    grid at that value's own scale (a conv, an FC, a standalone pair, an
    add, a concat, a windowed AVE pool)."""
    env = {"data": _nchw(x.float())}
    for L in layers:
        kind = KINDS[L["op"]]
        if record is not None and kind.records(L):
            for v in reads(L):
                record(v, env[v])
        env[L["name"]] = kind.forward(L, env, P)
    return env[layers[-1]["name"]]


def calibrate(layers, P, batches) -> Dict[str, float]:
    """``amax`` of every value ``run_float`` records (``"data"`` among
    them), over the float32 forwards of ``batches``."""
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
    than the stem at the value's own scale; a standalone pair, a residual
    add, a windowed AVE pool or a requantizing concat whose output is a
    grid, at the value's own scale; a max pool or a passing concat whose
    output is a grid, at that output's scale); the network's input and
    output and a global pool's output never are.  A concat passes its
    operands through unless one of them is not held on its grid, and
    then requantizes each (:meth:`_grid_scales`).  Every other value is
    held in the compute dtype, rounded once where it is made.  Sibling
    convs (two or more reading one value) share the largest of their
    output scales, as one merged conv has one.  ``amax`` must hold every
    value ``calibrate`` records and the output of each sibling conv."""

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
            kept = KINDS[L["op"]].prepare(self, L, P)
            if kept is not None:
                self.w[L["name"]] = kept

    def _grid_scales(self) -> Dict[str, float]:
        """value -> the scale of its grid, for the values held as grids.

        One pass from the last layer to the first, with every concat
        passing its operands through; a concat of a grid that some operand
        is then not held on requantizes from the next pass on (its
        operands read at their own scales), until none is left."""
        readers: Dict[str, list] = {}
        for L in self.layers:
            for v in reads(L):
                readers.setdefault(v, []).append(L)
        self.requantizing = set()
        while True:
            grid: Dict[str, float] = {}
            for L in reversed(self.layers):
                v = L["name"]
                if not KINDS[L["op"]].holds_grid(L):
                    continue
                scales = {KINDS[r["op"]].wants(self, r, v, grid)
                          for r in readers.get(v, [])}
                if len(scales) == 1 and None not in scales:
                    grid[v] = scales.pop()
            apart = {L["name"] for L in self.layers
                     if L["op"] == "concat" and L["name"] in grid
                     and L["name"] not in self.requantizing
                     and len(L["srcs"]) > 1
                     and any(grid.get(v) != grid[L["name"]]
                             for v in L["srcs"])}
            if not apart:
                return grid
            self.requantizing |= apart

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
        env[L["name"]] = KINDS[L["op"]].apply(self, L, env)


def init_weights(layers, seed: int, device, channels: int, hw,
                 init: dict):
    """Seeded weights on ``device``, from one ``torch.Generator`` in a few
    large draws: He-normal conv and FC weights, Scale gamma |N(1, 0.1)|
    and beta N(0, 0.1); each BatchNorm's mean and variance are the
    statistics of the value it normalizes (its conv's output, or what a
    standalone pair reads) on a seeded batch of ``init_batch`` images, as
    a trained network's are of its data, so every layer sees activations
    of the range a deployment sees; the FC's weight is scaled so that its
    logits have the standard deviation ``init["logit_std"]`` across that
    batch's images, and its bias, N(0, 0.1), less the mean logit over the
    batch, so that the classes an image scores high on are its own and
    not the batch's.  ``init["beta_mean"]`` shifts every beta, and the
    gamma of a conv marked ``"residual"`` (the last of a residual branch)
    is scaled by ``init["residual_gamma"]``: a random network at unit
    gains amplifies a small error from layer to layer, as a trained one
    does not, and these two choices keep it stable (an input perturbed by
    1e-4 moves the logits by about 4e-4 in ResNet-50 and 6e-4 in
    MobileNet-v1)."""
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
        env[L["name"]] = KINDS[L["op"]].settle(L, env, P, init)
    return {n: P[n].contiguous() for n, _, _ in specs}
