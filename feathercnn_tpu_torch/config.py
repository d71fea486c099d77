"""Engine configuration — a copy of ``feathercnn_tpu/config.py``.

The fields and their defaults are the reference's, so a config means the
same thing to both engines.  What differs:

- ``backend`` is ``"torch"`` (the plain float oracle, the role of the
  reference's ``"xla"``) or ``"cuda"`` (the hand-written kernels through
  ``kernels/dispatch.py``, the role of ``"pallas"``).
- ``compilation_cache_dir`` names the directory the port builds its CUDA
  kernels and native runtime into and loads them from
  (``utils.cache.enable_persistent_cache``), the port's counterpart of
  JAX's compilation cache.  ``sharding`` takes a
  ``parallel.mesh.ShardingConfig`` (the engines of ``parallel/`` on
  ``torch.distributed``).  ``fuse_blocks`` and ``fuse_chains`` run the
  region-fusion passes, ``concat_dus`` the concat-ladder pass and
  ``s2d_stem`` the space-to-depth stem pass, as in the reference.
- The TPU formulation flags (``lrn_band``, ``shuffle_matmul``,
  ``avepool_*``, ``maxpool_shift``, ``topk_radix``, ``det_*``,
  ``roipool_*``, ``proposal_sort_payload``, ``nms_blocked``) pick among
  exact forms of one function on the TPU; the port computes one exact form
  of each and accepts every value.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

__all__ = ["EngineConfig", "apply_baked_overrides"]

def apply_baked_overrides(config: "EngineConfig",
                          meta: Dict[str, Any]) -> "EngineConfig":
    """Apply a graph's measured per-model config bakes
    (``meta['config_overrides']``) to ``config`` for every field the
    caller left at its dataclass default.

    An explicit NON-default user value always wins; a value equal to the
    default is indistinguishable from "unset", so to counter a bake pass
    a non-default value or clear the meta entry (bench/batch_sweep.py
    strips the meta when A/B-ing a baked flag for exactly this reason).
    """
    baked = meta.get("config_overrides")
    if not baked:
        return config
    defaults = {f.name: f.default for f in dataclasses.fields(EngineConfig)}
    apply = {k: v for k, v in baked.items()
             if k in defaults and getattr(config, k) == defaults[k]}
    return config.replace(**apply) if apply else config


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The reference's fields and defaults; ``feathercnn_tpu/config.py``
    documents each one.  Passes and lowerings read them as the reference
    does."""

    # Activation compute dtype: "float32" or "bfloat16" (f32 accumulation).
    compute_dtype: str = "float32"
    # "torch": plain PyTorch lowering (the oracle; runs anywhere).
    # "cuda": the hand-written CUDA kernels (plain versions on CPU tensors).
    backend: str = "torch"
    # None | "w8" (weight-only int8) | "w8a8" (full int8, int8 edges).
    quant: Optional[str] = None
    # Per-layer conv algorithm override: ((name or "*", algo), ...).
    algo_overrides: Tuple[Tuple[str, str], ...] = ()
    # Parallelism: None (one process) or a ShardingConfig (parallel/mesh.py).
    sharding: Optional[Any] = None
    # Pallas interpreter mode in the reference.  In the port a CPU tensor
    # always takes a kernel's plain version, so the flag only means "on
    # the CPU": the engine refuses it on a CUDA device.
    interpret: bool = False
    # Graph passes, run as in the reference (passes.py).
    merge_siblings: bool = True
    fold_scale_chains: bool = True
    merge_concats: bool = False
    # Quantization rewrite controls (quant/rewrite.py).
    fp_act_layers: Tuple[str, ...] = ()
    quant_overrides: Tuple[Tuple[str, str], ...] = ()
    int8_requant_ops: bool = True
    int8_grouped: bool = True
    int8_axpy: bool = True
    # TPU formulation flags: exact alternative forms of one function; the
    # port computes one exact form and accepts every value.
    nms_blocked: bool = True
    det_take_gather: bool = False
    avepool_dwconv: bool = False
    avepool_reshape: bool = False
    avepool_matmul: bool = False
    nested_pools: bool = False          # a graph pass: run as the reference
    maxpool_shift: bool = False
    topk_radix: bool = True
    det_thresh_first: int = 0
    psroi_fuse_ave: bool = False        # a graph pass: run as the reference
    proposal_sort_payload: bool = True
    roipool_full_pyramid: bool = False
    roipool_table: bool = True
    lrn_band: bool = True
    shuffle_matmul: bool = False
    concat_dus: bool = False            # a graph pass: run as the reference
    # The build directory of the kernels and the native runtime
    # (utils/cache.py); None: FEATHERCNN_TPU_CACHE, else the package's.
    compilation_cache_dir: Optional[str] = None
    # Region fusion (passes_fusion.py): identity bottlenecks as
    # FusedBottleneck nodes; fuse_chains also merges same-shape runs into
    # FusedChain nodes, and implies fuse_blocks.
    fuse_blocks: bool = False
    s2d_stem: bool = False              # a graph pass: run as the reference
    fuse_chains: bool = False

    def check_supported(self) -> None:
        """Raise ``ValueError`` for an unknown backend and ``TypeError`` for
        a ``sharding`` that is not a ``ShardingConfig``."""
        if self.backend not in ("torch", "cuda"):
            raise ValueError(f"unknown backend {self.backend!r}: the port "
                             "has 'torch' (oracle) and 'cuda' (kernels)")
        from .parallel.mesh import ShardingConfig
        if self.sharding is not None and not isinstance(self.sharding,
                                                        ShardingConfig):
            raise TypeError(f"EngineConfig.sharding={self.sharding!r}: "
                            "expected a parallel.mesh.ShardingConfig")

    def algo_for(self, layer_name: str) -> Optional[str]:
        d = dict(self.algo_overrides)
        return d.get(layer_name, d.get("*"))

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)

    # -- JSON round trip (SURVEY.md §5 config system: one dataclass,
    # loadable from JSON/CLI; the reference's analog is CMake options +
    # Net(num_threads)) ---------------------------------------------------
    @classmethod
    def from_json(cls, src) -> "EngineConfig":
        """Build from a dict, JSON string, or path to a JSON file.
        ``algo_overrides`` may be given as a mapping; ``sharding`` as a
        dict of ShardingConfig fields."""
        import json
        import os
        if isinstance(src, (str, bytes)) and os.path.exists(src):
            with open(src) as f:
                src = json.load(f)
        elif isinstance(src, (str, bytes)):
            src = json.loads(src)
        d = dict(src)
        if "fp_act_layers" in d:
            v = d["fp_act_layers"]
            if isinstance(v, str):
                v = (v,)
            d["fp_act_layers"] = tuple(v or ())
        for fld in ("algo_overrides", "quant_overrides"):
            if isinstance(d.get(fld), dict):
                d[fld] = tuple(d[fld].items())
            elif d.get(fld):
                d[fld] = tuple(tuple(kv) for kv in d[fld])
        if isinstance(d.get("sharding"), dict):
            from .parallel.mesh import ShardingConfig
            s = dict(d["sharding"])
            for k in ("mesh_shape", "axis_names"):
                if k in s:
                    s[k] = tuple(s[k])
            d["sharding"] = ShardingConfig(**s)
        return cls(**d)

    def to_json(self) -> str:
        import dataclasses as dc
        import json
        d = dc.asdict(self)
        d["algo_overrides"] = dict(self.algo_overrides)
        d["quant_overrides"] = dict(self.quant_overrides)
        return json.dumps(d, indent=1)
