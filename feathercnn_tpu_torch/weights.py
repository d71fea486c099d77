"""Carry a model across from the JAX package without importing it.

``graph_from_reference(g)`` takes any object shaped like the reference's
``Graph`` — ``name``, ``inputs`` (name -> spec with ``shape``/``dtype``),
``nodes`` (each with ``op``, ``name``, ``inputs``, ``outputs``, ``params``,
``attrs``), ``params`` (name -> numpy array), ``outputs`` and ``meta`` —
and builds the port's ``Graph`` with copies of the same weights.  The
calibrated ``act_scales`` and ``value_scales`` in ``meta`` come across as
they are, so both engines quantize onto the same grids.
"""

from __future__ import annotations

import copy

import numpy as np

from .ir import Graph, Node, TensorSpec, infer_shapes

__all__ = ["graph_from_reference"]


def graph_from_reference(g) -> Graph:
    inputs = {name: TensorSpec(tuple(int(d) for d in spec.shape),
                               str(spec.dtype))
              for name, spec in g.inputs.items()}
    nodes = [Node(name=n.name, op=n.op, inputs=list(n.inputs),
                  outputs=list(n.outputs), attrs=copy.deepcopy(dict(n.attrs)),
                  params=list(n.params))
             for n in g.nodes]
    params = {k: np.array(v, copy=True) for k, v in g.params.items()}
    meta = copy.deepcopy(dict(g.meta))
    graph = Graph(name=g.name, inputs=inputs, outputs=list(g.outputs),
                  nodes=nodes, params=params, meta=meta)
    infer_shapes(graph)
    graph.validate()
    return graph
