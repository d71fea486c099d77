"""Kernels: ResNeXt-50's grouped 3x3 convs against their roofline.  The
frozen least time an image of the configuration's layers with ``group`` >
1 (``flops.py``: each the larger of its operations at the int8 peak and
its bytes at the memory's bandwidth), over the device time an image in
the super-group kernel's launches (``hgemm_kernel`` in the name), in
percent.  None where that kernel did not run (as on the CPU).  The
reader is handed the trace alone, so it reads the layer list from
``configs/resnext50_w8a8.json`` and its reference beside this folder."""

import json
from pathlib import Path

import flops
from harness import device_spans, load_module

BENCH_DIR = Path(__file__).resolve().parents[1]
CONFIG = "resnext50_w8a8"
KERNEL = "hgemm_kernel"


def grouped_least_s_per_image() -> float:
    cfg = json.loads((BENCH_DIR / "configs" / f"{CONFIG}.json").read_text())
    arch = load_module(BENCH_DIR / "reference" / f"{cfg['architecture']}.py")
    layers = arch.layers(cfg)
    grouped = {L["name"] for L in layers
               if L["op"] == "conv" and L["group"] > 1}
    return sum(max(2.0 * r["macs"] / flops.PEAK_INT8_OPS,
                   r["bytes"] / flops.PEAK_HBM_BYTES)
               for r in flops.layer_costs(layers, cfg)
               if r["name"] in grouped)


def read(trace):
    p = trace.profile
    if p is None or not p.images:
        return None
    us = sum(t for k, t in device_spans(p) if KERNEL in k)
    if us <= 0:
        return None
    return 100.0 * grouped_least_s_per_image() * 1e6 / (us / p.images)
