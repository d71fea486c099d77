"""The rank mesh and the sharding rules — counterpart of
``feathercnn_tpu/parallel/mesh.py``.

The reference places arrays on a ``jax.sharding.Mesh`` and lets GSPMD
insert the collectives.  Here a mesh of shape ``(data, model)`` spans
``data * model`` ranks of the process group, one process each: rank ``r``
sits at ``(r // model, r % model)``.  The ranks of one row (one data
coordinate) form its model group, those of one column its data group;
every rank creates every group, in one fixed order.  A mesh of one rank
needs no process group and runs no collective.

- **DP** (``shard_batch``): each rank runs its slice of the batch where
  the data axis divides it; the outputs are all-gathered on dim 0.
- **TP** (``shard_weights``, model > 1, not spatial): each Convolution and
  InnerProduct whose weight's last axis divides the model axis computes
  its output-channel slice on each rank (``param_shardings``' rule;
  grouped convs that are not depthwise replicate), and the slice is
  all-gathered on channels before any reader (``parallel/tp.py``).
- **Spatial** (``shard_spatial``): a rank-4 value's H is split over the
  model axis where it divides (``value_pspec``'s rule; the lowering's
  halo and gather rule is in ``ops/lowering.py``).

A layout is a tuple with one entry per dimension: the axis name a
dimension is split over, or None (the reference's ``PartitionSpec``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .dist import all_gather, group_timeout, world

__all__ = ["ShardingConfig", "Mesh", "build_mesh", "param_shardings",
           "input_shardings", "output_shardings", "value_pspec",
           "local_shard", "gather_shards"]


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    """Mesh shape, axis names and what to shard; the reference's fields and
    defaults.  ``mesh_shape`` is ``(data, model)``; a dim of 1 disables
    that axis."""

    mesh_shape: Tuple[int, ...] = (1, 1)
    axis_names: Tuple[str, ...] = ("data", "model")
    shard_weights: bool = True   # channel TP on conv/FC weights
    shard_batch: bool = True     # DP on the batch dim
    # H of the activations over the model axis instead of channel TP
    # (halo exchanges; weights replicate in this mode).
    shard_spatial: bool = False
    # TP InnerProducts and 1x1 convs of the "torch" backend through the
    # ring collective matmul (parallel/overlap.py allgather_matmul).
    ring_overlap: bool = False

    @property
    def data_axis(self) -> str:
        return self.axis_names[0]

    @property
    def model_axis(self) -> str:
        return self.axis_names[1]


@dataclasses.dataclass
class Mesh:
    """This rank's place on a ``(data, model)`` mesh.  ``shape`` maps each
    axis name to its size, as the reference's ``Mesh.shape`` does;
    ``groups`` maps it to the process group of this rank's line along that
    axis (None where the axis has one rank)."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, Optional[object]]

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))


def build_mesh(cfg: ShardingConfig) -> Mesh:
    """The mesh of ``cfg`` over the ranks of the default process group (or
    the one process, without a group).  Its groups take the default
    group's timeout (``dist.group_timeout``).  Raises when the mesh needs
    more ranks than exist, and on a rank outside the mesh (after creating
    the groups, so that the ranks inside it go on)."""
    if len(cfg.mesh_shape) != 2 or len(cfg.axis_names) != 2:
        raise ValueError(f"mesh {cfg.mesh_shape} over {cfg.axis_names}: "
                         "the port's mesh is (data, model)")
    data, model = (int(d) for d in cfg.mesh_shape)
    n = data * model
    rank, size = world()
    if n > size:
        raise ValueError(f"mesh {cfg.mesh_shape} needs {n} ranks, have "
                         f"{size}")
    shape = {cfg.data_axis: data, cfg.model_axis: model}
    groups: Dict[str, Optional[object]] = {cfg.data_axis: None,
                                           cfg.model_axis: None}
    if model > 1:
        for d in range(data):
            g = dist.new_group([d * model + m for m in range(model)],
                               timeout=group_timeout())
            if rank // model == d:
                groups[cfg.model_axis] = g
    if data > 1:
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)],
                               timeout=group_timeout())
            if rank % model == m:
                groups[cfg.data_axis] = g
    if rank >= n:
        raise ValueError(f"rank {rank} is outside mesh {cfg.mesh_shape} "
                         f"(ranks 0..{n - 1})")
    coords = {cfg.data_axis: rank // model, cfg.model_axis: rank % model}
    return Mesh(shape, coords, groups)


def _divisible(dim: int, parts: int) -> bool:
    return parts > 0 and dim % parts == 0


def param_shardings(graph, mesh: Mesh, cfg: ShardingConfig
                    ) -> Dict[str, Tuple[Optional[str], ...]]:
    """Per-param layout: conv/FC weights and biases split on their trailing
    output-channel axis over the model axis where it divides; everything
    else replicates.  Grouped convs that are not depthwise (Cin/g > 1)
    replicate, as the reference's rule (its GSPMD workaround)."""
    model_parts = mesh.shape[cfg.model_axis]
    tp_params = set()
    if cfg.shard_weights and model_parts > 1 and not cfg.shard_spatial:
        for n in graph.nodes:
            if n.op not in ("Convolution", "InnerProduct"):
                continue
            if n.op == "Convolution" and n.attrs.get("group", 1) > 1:
                w = np.asarray(graph.params[n.params[0]])
                if w.ndim == 4 and w.shape[-2] != 1:
                    continue
            tp_params.update(n.params)
    out = {}
    for name, arr in graph.params.items():
        a = np.asarray(arr)
        if (name in tp_params and a.ndim >= 1
                and _divisible(a.shape[-1], model_parts)):
            out[name] = (None,) * (a.ndim - 1) + (cfg.model_axis,)
        else:
            out[name] = (None,) * a.ndim
    return out


def value_pspec(cfg: ShardingConfig, mesh: Mesh, shape
                ) -> Tuple[Optional[str], ...]:
    """A value's layout: batch over the data axis; in spatial mode H
    (rank 4 only) over the model axis; each where it divides."""
    data_parts = mesh.shape[cfg.data_axis]
    model_parts = mesh.shape[cfg.model_axis]
    spec = [None] * len(shape)
    if (cfg.shard_batch and data_parts > 1 and len(shape) >= 1
            and _divisible(shape[0], data_parts)):
        spec[0] = cfg.data_axis
    if (cfg.shard_spatial and model_parts > 1 and len(shape) == 4
            and _divisible(shape[1], model_parts)):
        spec[1] = cfg.model_axis
    return tuple(spec)


def input_shardings(graph, mesh: Mesh, cfg: ShardingConfig):
    return {name: value_pspec(cfg, mesh, spec.shape)
            for name, spec in graph.inputs.items()}


def output_shardings(graph, mesh: Mesh, cfg: ShardingConfig,
                     names: Sequence[str]):
    """The layout each output has before the engine gathers it (every
    rank gets the global output back)."""
    return {name: value_pspec(cfg, mesh, graph.specs[name].shape)
            for name in names}


def local_shard(x: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """This rank's piece of the global ``x`` under layout ``spec``."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n, i = mesh.shape[axis], mesh.coords[axis]
        step = x.shape[dim] // n
        x = x.narrow(dim, i * step, step)
    return x


def gather_shards(x: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """The global value of this rank's piece ``x`` under layout ``spec``:
    all-gathered along each split dimension (H before the batch)."""
    for dim in reversed(range(len(spec))):
        axis = spec[dim]
        if axis is not None and mesh.groups[axis] is not None:
            x = all_gather(x.contiguous(), dim, mesh.groups[axis])
    return x
