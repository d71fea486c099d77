"""Timing utilities — from ``feathercnn_tpu/utils/timing.py``, only
``default_extra_inputs`` so far (the serving CLI's fixed extra inputs);
the device timing loops are not ported yet."""

from __future__ import annotations

import numpy as np

__all__ = ["default_extra_inputs"]


def default_extra_inputs(graph):
    """name -> array for every graph input AFTER the first: ``im_info``
    gets [h, w, 1] rows from the first (image) input's spec, anything
    else zeros."""
    names = list(graph.inputs)
    spec0 = graph.inputs[names[0]]
    out = {}
    for nm in names[1:]:
        sp = graph.inputs[nm]
        if nm == "im_info" and len(spec0.shape) == 4:
            out[nm] = np.tile(np.asarray(
                [[spec0.shape[1], spec0.shape[2], 1.0]], np.float32),
                (sp.shape[0], 1))
        else:
            out[nm] = np.zeros(sp.shape, np.float32)
    return out
