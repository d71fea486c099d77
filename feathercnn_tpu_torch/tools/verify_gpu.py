"""On-card numerics check — the port's counterpart of
``tools/verify_tpu.py``: run a zoo model (or a ``.ftpu`` file) on the GPU
and the same model, with the same weights, calibration and input, through
the port on the CPU (the kernels' plain versions), in one process (the
card's machine has no JAX), and hold the two to the reference's gates:

    python -m feathercnn_tpu_torch.tools.verify_gpu [--model resnet50]
        [--ftpu model.ftpu] [--batch 4] [--quant w8a8] [--dtype bfloat16]

A classifier passes at output cosine >= ``--min-cosine`` (0.995) and
top-1 agreement >= ``--min-top1`` (1.0).  A detector is held on its
pre-NMS tensors, the first two inputs of its DetectionOutput or Proposal
(with near-tied random-weight scores the greedy NMS reorders its rows
chaotically on any numeric difference; the SSD row match is printed as
information).  Both engines run the "cuda" backend: on the card the
hand-written kernels, on the CPU their plain versions.  ``--device cpu``
runs the candidate on the CPU too.  Exits 1 when a gate fails.
"""

from __future__ import annotations

import argparse
import inspect
import sys

import numpy as np

from .diff_blobs import cosine

__all__ = ["verify", "main"]


def _graph(model: str, ftpu, batch: int):
    """(graph, batch): the zoo model at ``batch`` (a two-stage deploy that
    takes batch 1 only at 1), or the ``.ftpu`` file at its own batch."""
    if ftpu:
        from ..model_format import load_ftpu
        g = load_ftpu(ftpu, mmap_weights=False)
        return g, next(iter(g.inputs.values())).shape[0]
    from ..models import MODEL_BUILDERS
    builder = MODEL_BUILDERS[model]
    kw = {"with_softmax": False} if "with_softmax" in \
        inspect.signature(builder).parameters else {}
    try:
        return builder(batch=batch, **kw), batch
    except ValueError as e:   # batch-1-only two-stage deploys
        if "batch 1" not in str(e):
            raise
        return builder(**kw), 1


def verify(model: str = "resnet50", batch: int = 4, quant="w8a8",
           dtype: str = "bfloat16", min_cosine: float = 0.995,
           min_top1: float = 1.0, ftpu=None, device=None,
           make_candidate=None, log=print) -> bool:
    """The check of the module docstring; returns whether it passed.
    ``make_candidate(graph, config, device)`` builds the engine held
    against the CPU (``Engine`` unless given)."""
    import torch

    from ..config import EngineConfig
    from ..engine import Engine, resolve_device
    from ..quant import calibrate
    from ..utils.timing import default_extra_inputs

    dev = resolve_device(device)
    g, batch = _graph(model, ftpu, batch)
    name = ftpu or model
    spec = next(iter(g.inputs.values()))
    x = np.random.default_rng(0).normal(size=spec.shape).astype(np.float32)
    inp = {next(iter(g.inputs)): x, **default_extra_inputs(g)}
    if quant == "w8a8" and "act_scales" not in g.meta:
        calibrate(g, [inp], method="max", device="cpu")
    cfg = EngineConfig(compute_dtype=dtype, backend="cuda", quant=quant)
    det = next((n for n in g.nodes
                if n.op in ("DetectionOutput", "Proposal")), None)
    extract = list(det.inputs[:2]) if det is not None else []
    ref_eng = Engine(g, cfg, device="cpu")
    refs = {k: v.float().numpy() for k, v in
            ref_eng.run(inp, extract=extract).items()}
    del ref_eng
    eng = (make_candidate(g, cfg, dev) if make_candidate
           else Engine(g, cfg, device=dev))
    log(f"device: {eng.device}"
        + (f" ({torch.cuda.get_device_name(eng.device)})"
           if eng.device.type == "cuda" else ""))
    res = {k: v.float().cpu().numpy() for k, v in
           eng.run(inp, extract=extract).items()}
    out, ref = res[g.outputs[0]], refs[g.outputs[0]]
    where = f"{eng.device.type}-vs-CPU"

    if det is not None:
        cos_min = 1.0
        for blob in extract:
            c = cosine(res[blob], refs[blob])
            log(f"  {blob}: cosine={c:.6f}")
            cos_min = min(cos_min, c)
        info = ""
        if det.op == "DetectionOutput":
            matched = total = 0
            for n in range(batch):
                va = out[n][out[n][:, 1] >= 0]
                vb = ref[n][ref[n][:, 1] >= 0]
                k = min(len(va), len(vb))
                total += max(len(va), len(vb))
                for ra, rb in zip(va[:k], vb[:k]):
                    lt = np.maximum(ra[3:5], rb[3:5])
                    rbr = np.minimum(ra[5:7], rb[5:7])
                    inter = np.prod(np.maximum(rbr - lt, 0))
                    ua = np.prod(np.maximum(ra[5:7] - ra[3:5], 0)) \
                        + np.prod(np.maximum(rb[5:7] - rb[3:5], 0)) - inter
                    if ra[1] == rb[1] and inter / max(ua, 1e-10) > 0.8:
                        matched += 1
            info = (f"  (info: detection row match "
                    f"{matched / max(total, 1):.3f}, {matched}/{total})")
        what = "rpn" if det.op == "Proposal" else "loc/conf"
        log(f"{name} {quant} b{batch}: {where} {what} "
            f"cosine={cos_min:.6f}{info}")
        return cos_min >= min_cosine

    cos = cosine(out, ref)
    top1 = float((out.reshape(batch, -1).argmax(-1)
                  == ref.reshape(batch, -1).argmax(-1)).mean())
    log(f"{name} {quant} b{batch}: {where} cosine={cos:.6f} "
        f"top1-agreement={top1:.3f}")
    return cos >= min_cosine and top1 >= min_top1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="resnet50")
    ap.add_argument("--ftpu", default=None,
                    help="a .ftpu file in place of a zoo model")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--quant", default="w8a8")
    ap.add_argument("--min-cosine", type=float, default=0.995)
    ap.add_argument("--min-top1", type=float, default=1.0,
                    help="top-1 agreement gate; relax below 1.0 for "
                         "models whose random-weight logit gaps sit under "
                         "the int8 rounding noise")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the candidate on the CPU too "
                         "(default: the GPU)")
    args = ap.parse_args(argv)
    ok = verify(args.model, args.batch,
                None if args.quant in ("none", "None") else args.quant,
                args.dtype, args.min_cosine, args.min_top1, args.ftpu,
                args.device)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
