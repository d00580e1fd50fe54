"""Parallelism for the port (port of spatialvla_tpu/parallel): the named mesh
and the multi-process bootstrap, the partitioning rules with the fsdp cut and
the model cut they drive (``TrainShards`` for training, ``TensorShards``
for tensor-parallel serving), the model axis' autograd collectives, ring
attention over ``sp`` and the GPipe pipeline over ``pipe``. Imports torch
and torch.distributed, no jax."""
from .mesh import (AXES, LocalMesh, Mesh, MeshConfig, ShardCopy, ShardGather, ShardSum,
                   batch_sharding, form_global_batch, initialize_distributed, join_ranks,
                   local_rows, make_mesh, mesh_shape, model_group_batches, process_count,
                   process_index, replicated, spawn_ranks, start_ranks, sum_shards)
from .partitioning import (DEFAULT_RULES, FsdpShards, TensorShards, TrainShards, param_pspecs,
                           shard_params, spec_for)
from .pipeline import pipeline_apply
from .ring_attention import ring_flash_attention

__all__ = [
    "AXES",
    "DEFAULT_RULES",
    "FsdpShards",
    "LocalMesh",
    "Mesh",
    "MeshConfig",
    "ShardCopy",
    "ShardGather",
    "ShardSum",
    "TensorShards",
    "TrainShards",
    "batch_sharding",
    "form_global_batch",
    "initialize_distributed",
    "join_ranks",
    "local_rows",
    "make_mesh",
    "mesh_shape",
    "model_group_batches",
    "param_pspecs",
    "pipeline_apply",
    "process_count",
    "process_index",
    "replicated",
    "ring_flash_attention",
    "shard_params",
    "spawn_ranks",
    "spec_for",
    "start_ranks",
    "sum_shards",
]
