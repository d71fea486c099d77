"""Sharded and pipelined inference on ``torch.distributed`` — counterpart
of ``feathercnn_tpu/parallel``: the rank mesh and sharding rules
(``mesh``), the collectives and multi-process start (``dist``,
``launch``), explicit tensor and spatial parallelism (``tp``,
``spatial``), ring collective matmuls (``overlap``) and the pipeline
engine (``pipeline``)."""

from .dist import maybe_initialize_distributed
from .mesh import (ShardingConfig, build_mesh, input_shardings,
                   output_shardings, param_shardings)
from .overlap import allgather_matmul, matmul_reducescatter
from .pipeline import PipelineEngine, partition_stages

__all__ = ["ShardingConfig", "build_mesh", "input_shardings",
           "output_shardings", "param_shardings", "allgather_matmul",
           "matmul_reducescatter", "PipelineEngine", "partition_stages",
           "maybe_initialize_distributed"]
