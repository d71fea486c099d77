"""The inference engine: graph -> optimization passes -> an eager walk of
the lowered ops.

Counterpart of ``feathercnn_tpu/engine.py``.  Init runs the reference's
steps in the reference's order (baked overrides -> ``optimize`` ->
``quantize_graph`` -> the concat-ladder pass under ``concat_dus`` -> the
region-fusion passes under ``fuse_blocks`` / ``fuse_chains`` -> the
space-to-depth stem under ``s2d_stem`` -> ``infer_shapes``); the weights
move to the device once; a forward walks the node list, lowering each
node to PyTorch ops (and, on the "cuda" backend, to the hand-written
kernels).  There is no
trace or compile step: PyTorch runs eagerly.  Each ``run`` call asks
``utils.profiling.run_scope()`` once for its spans: inside
``profiling.record()`` the call is one ``run`` span, and each input's
cast to the compute dtype and each node's lowering one ``node`` span in
it; under ``torch.profiler`` that node span opens a ``record_function``
range named after the node, so a profile gives device time per graph
node; with neither, the nodes are lowered bare.  ``compile(batch)``
is the reference's ahead-of-time step here: one forward at the declared
shapes, which moves the weights to the device and makes each node's kept
constants.

Under ``EngineConfig(sharding=ShardingConfig(...))`` the engine is one
rank of a ``(data, model)`` mesh of processes (``parallel/mesh.py``): every
rank calls it with the same global input and gets the global output back,
as ``np.asarray`` of the reference's sharded output gives it.  Each rank
runs its slice of the batch (DP), its output-channel slice of each TP node
on a rank-local copy of the graph made once here (``parallel/tp.py``), or
its rows of H (spatial), through ``ops.lowering.lower_sharded``; a mesh of
one rank runs the plain path and no collective.

A model comes from a builder of ``models/``, from ``Engine.from_path`` (a
``.ftpu`` file, read by the C++ loader of ``native.py`` or by
``model_format.py``), or, already optimized and
quantized, through ``Engine.from_optimized``, which runs no pass.

The engine runs on the first CUDA device unless the caller passes
``device="cpu"``; it never falls back to the CPU on its own.  Float32
convolutions on the card follow ``torch.backends.cudnn.allow_tf32``, which
is True by default: a caller holding float32 results to tight tolerances
sets it (and ``torch.backends.cuda.matmul.allow_tf32``) to False.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from .config import EngineConfig, apply_baked_overrides
from .ir import Graph, infer_shapes
from .ops.lowering import LoweringCtx, lower_node, lower_sharded
from .passes import optimize
from .utils import profiling

__all__ = ["Engine", "resolve_device"]


class _Input(NamedTuple):
    """A graph input as its span names it (Caffe's ``Input`` layer)."""
    name: str
    op: str = "Input"


def _cast_input(inp: _Input, x: torch.Tensor, cdtype) -> torch.Tensor:
    # Only rank-4 feature maps take the compute dtype; metadata inputs
    # (im_info's [h, w, scale]) keep full precision — bf16 rounds 599 to
    # 600 and corrupts clip bounds.
    return x.to(cdtype) if (x.dtype.is_floating_point
                            and x.dim() == 4) else x


def resolve_device(device=None) -> torch.device:
    """``None`` means the first CUDA device; raises when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: the port runs on the GPU by "
                "default; pass device='cpu' to run it on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device "
                           "is available")
    return dev


class Engine:
    def __init__(self, graph: Graph, config: Optional[EngineConfig] = None,
                 optimize_graph: bool = True, device=None):
        self.config = config or EngineConfig()
        self.device = resolve_device(device)
        self.graph = copy.deepcopy(graph)
        # Auto-tuned per-layer algo choices baked into the model artifact
        # apply unless the config overrides them.
        baked = self.graph.meta.get("algo_overrides")
        if baked and not self.config.algo_overrides:
            self.config = self.config.replace(
                algo_overrides=tuple(baked.items()))
        # Per-model measured config defaults.
        self.config = apply_baked_overrides(self.config, self.graph.meta)
        self.config.check_supported()
        if self.config.compilation_cache_dir:
            from .utils.cache import enable_persistent_cache
            enable_persistent_cache(self.config.compilation_cache_dir)
        if self.config.interpret and self.device.type != "cpu":
            raise ValueError("interpret=True means the CPU in the port (CPU "
                             "tensors take the kernels' plain versions): "
                             "pass device='cpu'")
        if optimize_graph:
            optimize(self.graph,
                     merge_siblings=self.config.merge_siblings,
                     merge_concats=self.config.merge_concats,
                     fold_scale_chains=self.config.fold_scale_chains,
                     nested_pools=self.config.nested_pools)
            if self.config.psroi_fuse_ave:
                from .passes import fuse_psroi_ave
                fuse_psroi_ave(self.graph)
        if self.config.quant:
            from .quant.rewrite import quantize_graph
            quantize_graph(self.graph, self.config.quant,
                           int8_grouped=self.config.int8_grouped,
                           requant_ops=self.config.int8_requant_ops,
                           int8_axpy=self.config.int8_axpy,
                           fp_act_layers=self.config.fp_act_layers,
                           quant_overrides=dict(
                               self.config.quant_overrides))
        if self.config.concat_dus:
            # after the quant rewrite: the ladder pass reads the concat
            # int8 marks to unify the chain onto one buffer scale
            from .passes_ladder import dus_concat_ladders
            dus_concat_ladders(self.graph)
        if self.config.fuse_blocks or self.config.fuse_chains:
            from .passes_fusion import fuse_bottlenecks, fuse_chains
            infer_shapes(self.graph)  # fresh specs for the region gate
            act_item = torch.empty(
                (), dtype=getattr(torch, self.config.compute_dtype)
            ).element_size()
            fuse_bottlenecks(self.graph, act_itemsize=act_item)
            if self.config.fuse_chains:
                fuse_chains(self.graph, act_itemsize=act_item)
        if self.config.s2d_stem:
            from .passes_stem import space_to_depth_stem
            infer_shapes(self.graph)
            space_to_depth_stem(self.graph)
        infer_shapes(self.graph)
        self.graph.validate()
        self._init_lowering()

    def _init_lowering(self) -> None:
        """The mesh (``config.sharding``), the rank-local graph (TP slices,
        made once) and the lowering context over it."""
        self._device_params: Optional[Dict[str, torch.Tensor]] = None
        self._mesh, self._local, tp = None, self.graph, {}
        if self.config.sharding is not None:
            from .parallel.mesh import build_mesh
            from .parallel.tp import shard_graph
            mesh = build_mesh(self.config.sharding)
            if mesh.size > 1:
                self._mesh = mesh
                self._local, tp = shard_graph(self.graph, mesh,
                                              self.config.sharding)
        self._ctx = LoweringCtx(self._local, self.config, self.device,
                                mesh=self._mesh, tp=tp)

    # ------------------------------------------------------------------
    @classmethod
    def from_optimized(cls, graph: Graph,
                       config: Optional[EngineConfig] = None,
                       device=None) -> "Engine":
        """Engine over an already optimized and quantized graph, running no
        pass (a second int8 rewrite would corrupt the scales): shapes are
        re-inferred, nothing else changes."""
        self = object.__new__(cls)
        self.config = config or EngineConfig()
        self.config.check_supported()
        self.device = resolve_device(device)
        self.graph = copy.deepcopy(graph)
        infer_shapes(self.graph)
        self.graph.validate()
        self._init_lowering()
        return self

    @classmethod
    def from_path(cls, path: str, config: Optional[EngineConfig] = None,
                  prefer_native: bool = True, **kw) -> "Engine":
        """Load a ``.ftpu`` model and build the engine (``kw`` goes to the
        constructor: ``optimize_graph``, ``device``).  ``prefer_native``
        loads through the C++ mmap loader (``native.load_ftpu_native``,
        built at first use; a failed build raises), ``False`` through
        ``model_format.load_ftpu``."""
        if prefer_native:
            from .native import load_ftpu_native
            graph = load_ftpu_native(path)
        else:
            from .model_format import load_ftpu
            graph = load_ftpu(path)
        return cls(graph, config, **kw)

    # ------------------------------------------------------------------
    @property
    def input_names(self) -> List[str]:
        return list(self.graph.inputs)

    @property
    def output_names(self) -> List[str]:
        return list(self.graph.outputs)

    def blob_shape(self, name: str):
        return self.graph.specs[name].shape

    def summary(self, top: Optional[int] = None) -> str:
        """Per-layer table of the optimized graph: output shape, params,
        FLOPs/img, activation MB/img (1 byte under w8a8, else the compute
        dtype's size); ``top`` keeps the N layers with the most FLOPs."""
        from .utils.summary import summarize
        act_bytes = 1 if self.config.quant == "w8a8" else torch.empty(
            (), dtype=getattr(torch, self.config.compute_dtype)).element_size()
        return summarize(self.graph, act_bytes=act_bytes, top=top)

    # ------------------------------------------------------------------
    def _prepare_params(self) -> Dict[str, torch.Tensor]:
        """Move weights to the device once, pre-cast to the compute dtype:
        float conv/FC weights go to the compute dtype, int8 weights stay
        int8, biases and scales stay f32 for the epilogue."""
        if self._device_params is not None:
            return self._device_params
        cdtype = getattr(torch, self.config.compute_dtype)
        weight_names = set()
        for n in self._local.nodes:
            if n.op in ("Convolution", "InnerProduct") and n.params:
                weight_names.add(n.params[0])
        out: Dict[str, torch.Tensor] = {}
        for k, v in self._local.params.items():
            # a loaded model's weights are read-only memmaps: copied here
            t = torch.from_numpy(np.require(v, requirements=("C", "W")))
            if (k in weight_names and t.dtype == torch.float32
                    and cdtype != torch.float32):
                t = t.to(cdtype)
            out[k] = t.to(self.device)
        self._device_params = out
        return out

    # ------------------------------------------------------------------
    def _forward(self, params: Dict[str, torch.Tensor],
                 inputs: Dict[str, torch.Tensor],
                 wanted: Sequence[str], layout, scope
                 ) -> Dict[str, torch.Tensor]:
        """The node walk; ``scope`` (``profiling.run_scope()``) puts each
        input's cast and each node's lowering in its span."""
        cdtype = getattr(torch, self.config.compute_dtype)
        cast = scope.wrap(_cast_input)
        env = {name: cast(_Input(name), inputs[name], cdtype)
               for name in self.graph.inputs}
        if self._mesh is not None:
            return self._forward_sharded(params, env, wanted, scope, layout)
        lower = scope.wrap(lower_node)
        for node in self.graph.nodes:
            ins = [env[i] for i in node.inputs]
            ps = [params[p] for p in node.params]
            outs = lower(node, ins, ps, self._ctx)
            for name, val in zip(node.outputs, outs):
                env[name] = val
        return {w: env[w] for w in wanted}

    def _forward_sharded(self, params, env, wanted, scope, layout):
        """The forward of one rank: ``env`` holds this rank's pieces of the
        inputs, split by ``layout`` (``_split_inputs``); returns the global
        values of ``wanted``.  A TP node's channel slice is all-gathered
        once, before its first reader that does not take it through the
        ring (``takes_ring``); an output is gathered on channels, then on
        H in the model group, then on the batch in the data group."""
        from .ops.lowering import gather_channels, takes_ring
        from .parallel.mesh import gather_shards
        scfg, mesh, ctx = self.config.sharding, self._mesh, self._ctx
        lay = {name: "rows" if layout[name][1:2] == (scfg.model_axis,)
               else None for name in env}
        lower = scope.wrap(lower_sharded)
        for node in self._local.nodes:
            for i, name in enumerate(node.inputs):
                if lay[name] == "chans" and not (
                        i == 0 and takes_ring(node, env[name], ctx)):
                    env[name], lay[name] = gather_channels(env[name],
                                                           ctx), None
            ins = [env[i] for i in node.inputs]
            ps = [params[p] for p in node.params]
            outs, lays = lower(node, ins, ps, ctx,
                               [lay[i] for i in node.inputs])
            for name, val, value_layout in zip(node.outputs, outs, lays):
                env[name], lay[name] = val, value_layout
        batch = any(spec[:1] == (scfg.data_axis,)
                    for spec in layout.values())
        out = {}
        for w in wanted:
            v = gather_channels(env[w], ctx) if lay[w] == "chans" else env[w]
            spec = (scfg.data_axis if batch else None,
                    scfg.model_axis if lay[w] == "rows" else None,
                    None, None)
            out[w] = gather_shards(v, spec[:v.dim()], mesh)
        return out

    def _split_inputs(self, tensors: Dict[str, torch.Tensor]):
        """(this rank's piece of each global input, the layouts they were
        split by: ``value_pspec`` at each input's runtime shape)."""
        from .parallel.mesh import local_shard, value_pspec
        layout = {k: value_pspec(self.config.sharding, self._mesh,
                                 tuple(t.shape))
                  for k, t in tensors.items()}
        return ({k: local_shard(t, layout[k], self._mesh)
                 for k, t in tensors.items()}, layout)

    @torch.inference_mode()
    def run(self, inputs: Union[np.ndarray, torch.Tensor, Dict[str, Any]],
            extract: Sequence[str] = ()) -> Dict[str, torch.Tensor]:
        """Forward pass.  ``inputs`` is an array (single-input nets) or a
        name->array dict.  Returns name->tensor (on the engine's device)
        for every graph output plus anything in ``extract``."""
        scope = profiling.run_scope()
        with scope:
            return self._run(inputs, extract, scope)

    def _run(self, inputs, extract, scope):
        if not isinstance(inputs, dict):
            (name,) = self.graph.inputs
            inputs = {name: inputs}
        wanted = list(dict.fromkeys(list(self.graph.outputs) + list(extract)))
        for w in wanted:
            if w not in self.graph.specs:
                raise KeyError(f"unknown blob {w!r}")
        tensors = {}
        for name, x in inputs.items():
            spec = self.graph.inputs.get(name)
            if spec is None:
                raise KeyError(f"unknown graph input {name!r}")
            x = torch.as_tensor(x)
            # Batch and spatial dims may differ from the declared spec;
            # rank and channel count must match.
            if x.dim() != len(spec.shape) or (
                    x.dim() == 4 and x.shape[-1] != spec.shape[-1]):
                raise ValueError(
                    f"input {name!r} has shape {tuple(x.shape)}, expected "
                    f"{spec.shape} (batch/spatial may vary, channels/rank "
                    f"may not)")
            tensors[name] = x.to(self.device)
        layout = None
        if self._mesh is not None:
            tensors, layout = self._split_inputs(tensors)
        return self._forward(self._prepare_params(), tensors, wanted, layout,
                             scope)

    def compile(self, batch: Optional[int] = None) -> None:
        """The reference's ahead-of-time step: one forward on zeros at the
        declared input shapes (``batch`` replacing the batch), so that the
        first ``run`` finds the weights on the device and every node's
        constants made."""
        inputs = {}
        for name, spec in self.graph.inputs.items():
            shape = list(spec.shape)
            if batch is not None:
                shape[0] = batch
            inputs[name] = torch.zeros(shape, dtype=getattr(torch, spec.dtype))
        self.run(inputs)

    def __call__(self, x) -> torch.Tensor:
        """Forward returning the primary output."""
        return self.run(x)[self.graph.outputs[0]]

    def extract(self, x, names: Sequence[str]) -> Dict[str, torch.Tensor]:
        """Fetch named intermediate values.  Values consumed by fusion
        (folded BN outputs etc.) no longer exist."""
        return self.run(x, extract=names)
