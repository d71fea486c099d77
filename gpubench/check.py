"""The comparison that decides ``correct``.

Every answer due in the window is judged against the plain reference
(``reference/``) run on the same input: the configuration's weights and
calibration batches, the same image (through the server's int8 ingest
where the cell serves), at the configuration's precision.  Two numbers:

- ``top1_gap``: the widest gap, over the answers, by which the reference's
  logit of the answer's top class lies below the reference's best logit;
- ``prob_l1_mean``: the mean, over the answers, of the L1 distance between
  the answer's probabilities and the softmax of the reference's logits.

Each is held to its cell's limit (``limits/<workload>.json``).  The
reference runs after the window, in blocks of ``BLOCK`` images."""

from __future__ import annotations

from typing import Dict

import torch

from harness import load_json
from reference import _qnet

BLOCK = 64


def reference_logits(cell, inputs, transfer: bool, bits: int = 8):
    """The reference's logits (float32, on the device) of every image of
    ``inputs``: calibrated on the cell's calibration batches, at ``bits``
    (the control: 4)."""
    _qnet.no_tf32()
    amax = _qnet.calibrate(cell.layers, cell.params, cell.calib)
    net = _qnet.Quantized(cell.layers, cell.params, amax, bits,
                          cell.cfg["engine"]["compute_dtype"])
    out = []
    with torch.inference_mode():
        for i in range(0, len(inputs), BLOCK):
            x = inputs[i:i + BLOCK].to(cell.device)
            out.append(net.logits(net.transfer(x) if transfer else x))
    return torch.cat(out)


def compare(answers, ref_logits) -> Dict[str, float]:
    """The two numbers over ``answers``: (rows of the inputs, their
    probabilities) pairs."""
    ref_logits = ref_logits.float().cpu()
    ref_prob = torch.softmax(ref_logits, -1)
    best = ref_logits.max(-1).values
    gap, l1_sum, n = 0.0, 0.0, 0
    for rows, probs in answers:
        if not len(rows):
            continue
        p = probs.float().reshape(len(rows), -1)
        top = p.argmax(-1)
        g = best[rows] - ref_logits[rows, top]
        gap = max(gap, float(g.max()))
        l1_sum += float((p - ref_prob[rows]).abs().sum())
        n += len(rows)
    return {"top1_gap": gap, "prob_l1_mean": l1_sum / max(n, 1)}


def limits(bench_dir, workload: str) -> Dict[str, float]:
    return load_json(bench_dir / "limits" / f"{workload}.json")
