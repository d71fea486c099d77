"""The .ftpu model container — a copy of ``feathercnn_tpu/model_format.py``
(numpy only), so that both engines read and write one file format.

    bytes 0..4    magic  b"FTPU"
    bytes 4..8    u32 version (=1)
    bytes 8..16   u64 header_len (JSON bytes)
    16..16+h      JSON header: graph structure (inputs/outputs/nodes),
                  meta (incl. pre-baked quant scales, so a restart needs
                  no recalibration), and a tensor index {name: {offset,
                  dtype, shape}} with offsets relative to the data section
    pad to 64
    data section  raw little-endian tensor bytes, each 64-byte aligned

Write with ``save_ftpu``; read with ``load_ftpu`` (numpy memmap: weights
page in lazily).  A file either package writes loads in the other to the
same graph and the same weights.
"""

from __future__ import annotations

import json
import mmap
import struct
from typing import Any, Dict

import numpy as np

from .ir import Graph, Node, TensorSpec

__all__ = ["save_ftpu", "load_ftpu", "MAGIC", "VERSION"]

MAGIC = b"FTPU"
VERSION = 1
_ALIGN = 64


def _align(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def save_ftpu(graph: Graph, path: str) -> None:
    tensors: Dict[str, Dict[str, Any]] = {}
    offset = 0
    order = []
    for name, arr in graph.params.items():
        arr = np.ascontiguousarray(arr)
        tensors[name] = {"offset": offset, "dtype": str(arr.dtype),
                         "shape": list(arr.shape)}
        order.append((offset, name, arr))
        offset = _align(offset + arr.nbytes)

    header = {
        "format_version": VERSION,
        "name": graph.name,
        "inputs": {k: {"shape": list(v.shape), "dtype": v.dtype}
                   for k, v in graph.inputs.items()},
        "outputs": list(graph.outputs),
        "nodes": [{"name": n.name, "op": n.op, "inputs": n.inputs,
                   "outputs": n.outputs, "attrs": n.attrs,
                   "params": n.params} for n in graph.nodes],
        "meta": _json_safe(graph.meta),
        "tensors": tensors,
    }
    hjson = json.dumps(header).encode("utf-8")

    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", VERSION))
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        data_start = _align(16 + len(hjson))
        f.write(b"\0" * (data_start - 16 - len(hjson)))
        pos = 0
        for off, name, arr in order:
            if off > pos:
                f.write(b"\0" * (off - pos))
                pos = off
            f.write(arr.tobytes())
            pos += arr.nbytes


def _json_safe(obj):
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return {"__ndarray__": obj.tolist(), "dtype": str(obj.dtype)}
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    return obj


def _json_restore(obj):
    if isinstance(obj, dict):
        if "__ndarray__" in obj:
            return np.asarray(obj["__ndarray__"], dtype=obj["dtype"])
        return {k: _json_restore(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_json_restore(v) for v in obj]
    return obj


def load_ftpu(path: str, mmap_weights: bool = True) -> Graph:
    with open(path, "rb") as f:
        head = f.read(16)
        if head[:4] != MAGIC:
            raise ValueError(f"{path}: not a .ftpu file")
        version, = struct.unpack("<I", head[4:8])
        if version != VERSION:
            raise ValueError(f"{path}: unsupported version {version}")
        hlen, = struct.unpack("<Q", head[8:16])
        header = json.loads(f.read(hlen).decode("utf-8"))
    data_start = _align(16 + hlen)

    if mmap_weights:
        raw = np.memmap(path, dtype=np.uint8, mode="r")
    else:
        with open(path, "rb") as f:
            raw = np.frombuffer(f.read(), np.uint8)

    params = {}
    for name, t in header["tensors"].items():
        start = data_start + t["offset"]
        dt = np.dtype(t["dtype"])
        count = int(np.prod(t["shape"])) if t["shape"] else 1
        arr = raw[start:start + count * dt.itemsize].view(dt)
        params[name] = arr.reshape(t["shape"])

    graph = Graph(
        name=header["name"],
        inputs={k: TensorSpec(tuple(v["shape"]), v["dtype"])
                for k, v in header["inputs"].items()},
        outputs=list(header["outputs"]),
        nodes=[Node(name=n["name"], op=n["op"], inputs=list(n["inputs"]),
                    outputs=list(n["outputs"]), attrs=dict(n["attrs"]),
                    params=list(n["params"])) for n in header["nodes"]],
        params=params,
        meta=_json_restore(header.get("meta", {})),
    )
    return graph
