"""Pipeline parallelism: stage-partitioned inference across devices —
counterpart of ``feathercnn_tpu/parallel/pipeline.py``.

The topologically ordered node list is cut into S contiguous stages with
balanced conv/FC FLOPs (``partition_stages``, a copy of the reference's
with the same cuts); each stage's params live on its own device, and each
stage has a ``LoweringCtx`` of its own on that device (the port's context
keeps device copies of per-node constants).  ``run`` drives micro-batches
through the stages in wavefront order, each crossing value copied to the
next stage's device.  CUDA launches return before the card finishes, so
while stage s runs micro-batch m on its device, the host already queues
stage s-1's work for micro-batch m+1 on its own.  One process; no
collective.

Each device holds only its stage's weights: the trade against DP x TP is
batch latency for weight memory.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import EngineConfig, apply_baked_overrides
from ..engine import resolve_device
from ..ir import Graph, infer_shapes
from ..ops.lowering import LoweringCtx, lower_node

__all__ = ["PipelineEngine", "partition_stages", "Stage"]


def _node_flops(graph: Graph, node) -> float:
    """MAC*2 cost of conv/FC nodes; cheap ops count epsilon so empty
    stages cannot occur."""
    if node.op not in ("Convolution", "InnerProduct"):
        return 1e3
    out = graph.specs[node.outputs[0]]
    if node.op == "InnerProduct":
        w = graph.params[node.params[0]]
        return 2.0 * float(np.prod(w.shape))
    kh = node.attrs.get("kernel_h", node.attrs.get("kernel_size", 1))
    kw = node.attrs.get("kernel_w", node.attrs.get("kernel_size", 1))
    group = node.attrs.get("group", 1)
    cin = graph.specs[node.inputs[0]].shape[-1]
    _, oh, ow, co = out.shape
    return 2.0 * oh * ow * co * kh * kw * (cin / group)


@dataclasses.dataclass
class Stage:
    index: int
    nodes: List[Any]
    live_in: List[str]          # values read from earlier stages/inputs
    live_out: List[str]         # values later stages/outputs need


def partition_stages(graph: Graph, num_stages: int) -> List[Stage]:
    """Contiguous FLOP-balanced partition of the topo-ordered node list."""
    if num_stages < 1:
        raise ValueError("num_stages must be >= 1")
    costs = [_node_flops(graph, n) for n in graph.nodes]
    total = sum(costs)
    target = total / num_stages
    cuts, acc, k = [], 0.0, 1
    for i, c in enumerate(costs):
        acc += c
        if k < num_stages and acc >= k * target \
                and len(graph.nodes) - (i + 1) >= num_stages - k:
            cuts.append(i + 1)
            k += 1
    bounds = [0] + cuts + [len(graph.nodes)]

    produced_by_stage: Dict[str, int] = {}
    stages: List[Stage] = []
    for s in range(len(bounds) - 1):
        nodes = graph.nodes[bounds[s]:bounds[s + 1]]
        for n in nodes:
            for o in n.outputs:
                produced_by_stage[o] = s
        stages.append(Stage(s, nodes, [], []))

    # live-in: any value consumed in stage s but produced earlier (or a
    # graph input) crosses the s-1 -> s edge
    for s, st in enumerate(stages):
        seen_in = set()
        for n in st.nodes:
            for v in n.inputs:
                src = produced_by_stage.get(v)
                if (src is None or src < s) and v not in seen_in:
                    st.live_in.append(v)
                    seen_in.add(v)
    # live-out: a later stage consumes it, or it is a graph output
    for s, st in enumerate(stages):
        outs = set()
        for later in stages[s + 1:]:
            outs.update(later.live_in)
        for n in st.nodes:
            for o in n.outputs:
                if o in outs or o in graph.outputs:
                    st.live_out.append(o)
    return stages


def _default_devices() -> List[torch.device]:
    resolve_device(None)        # raises without a GPU
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class PipelineEngine:
    """Stage-pipelined inference engine.

    ``devices`` defaults to the visible CUDA devices and may name one
    device more than once (``["cuda:0", "cuda:0"]``, or ``["cpu"] * 2``);
    ``num_stages`` defaults to their count.  ``micro_batches`` splits the
    batch so the pipeline fills.  The graph passes are the reference
    pipeline's: baked overrides, ``optimize``, ``quantize_graph``."""

    def __init__(self, graph: Graph, config: Optional[EngineConfig] = None,
                 num_stages: Optional[int] = None,
                 devices: Optional[Sequence[Any]] = None,
                 optimize_graph: bool = True):
        from ..passes import optimize

        self.config = config or EngineConfig()
        self.graph = copy.deepcopy(graph)
        self.config = apply_baked_overrides(self.config, self.graph.meta)
        self.config.check_supported()
        if self.config.sharding is not None:
            raise ValueError("PipelineEngine runs in one process: "
                             "EngineConfig.sharding must be None")
        if optimize_graph:
            optimize(self.graph,
                     merge_siblings=self.config.merge_siblings)
        if self.config.quant:
            from ..quant.rewrite import quantize_graph
            quantize_graph(self.graph, self.config.quant,
                           int8_grouped=self.config.int8_grouped,
                           requant_ops=self.config.int8_requant_ops,
                           fp_act_layers=self.config.fp_act_layers)
        infer_shapes(self.graph)
        self.devices = ([resolve_device(d) for d in devices]
                        if devices is not None else _default_devices())
        self.num_stages = num_stages or len(self.devices)
        if self.num_stages > len(self.devices):
            raise ValueError(
                f"{self.num_stages} stages > {len(self.devices)} devices")
        self.stages = partition_stages(self.graph, self.num_stages)
        cdtype = getattr(torch, self.config.compute_dtype)
        self._ctxs: List[LoweringCtx] = []
        self._stage_params: List[Dict[str, torch.Tensor]] = []
        for st in self.stages:
            dev = self.devices[st.index]
            self._ctxs.append(LoweringCtx(self.graph, self.config, dev))
            params: Dict[str, torch.Tensor] = {}
            for n in st.nodes:
                for p in n.params:
                    t = torch.from_numpy(np.require(
                        self.graph.params[p], requirements=("C", "W")))
                    if (n.op in ("Convolution", "InnerProduct")
                            and p == n.params[0]
                            and t.dtype == torch.float32
                            and cdtype != torch.float32):
                        t = t.to(cdtype)
                    params[p] = t.to(dev)
            self._stage_params.append(params)

    def _run_stage(self, s: int, env: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        st, ctx, params = self.stages[s], self._ctxs[s], self._stage_params[s]
        cdtype = getattr(torch, self.config.compute_dtype)
        env = dict(env)
        for name in list(env):
            # rank-4 float graph inputs take the compute dtype, as the
            # engine's (im_info keeps full precision)
            x = env[name]
            if (name in self.graph.inputs and x.dtype.is_floating_point
                    and x.dim() == 4):
                env[name] = x.to(cdtype)
        for node in st.nodes:
            outs = lower_node(node, [env[i] for i in node.inputs],
                              [params[p] for p in node.params], ctx)
            for name, val in zip(node.outputs, outs):
                env[name] = val
        return {v: env[v] for v in st.live_out}

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def run(self, x, micro_batches: int = 1) -> Dict[str, torch.Tensor]:
        if not isinstance(x, dict):
            (name,) = self.graph.inputs
            x = {name: x}
        x = {k: torch.as_tensor(v) for k, v in x.items()}
        batch = next(iter(x.values())).shape[0]
        m = max(1, min(micro_batches, batch))
        if batch % m:
            raise ValueError(f"batch {batch} not divisible by {m} "
                             "micro-batches")
        mb = batch // m
        shards = [{k: v[i * mb:(i + 1) * mb] for k, v in x.items()}
                  for i in range(m)]
        # Wavefront: stage s of micro-batch i is queued as soon as its
        # predecessor's values exist; the devices run them asynchronously.
        results: List[Dict[str, torch.Tensor]] = []
        for i in range(m):
            env = dict(shards[i])
            carry: Dict[str, torch.Tensor] = {}
            for s, st in enumerate(self.stages):
                dev = self.devices[s]
                stage_in = {v: (env[v] if v in env else carry[v]).to(dev)
                            for v in st.live_in}
                carry.update(self._run_stage(s, stage_in))
            results.append({k: carry[k] for k in self.graph.outputs})
        return {k: torch.cat([r[k] for r in results], dim=0)
                for k in self.graph.outputs}

    def __call__(self, x, micro_batches: int = 1) -> torch.Tensor:
        return self.run(x, micro_batches)[self.graph.outputs[0]]
