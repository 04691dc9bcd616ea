"""Tensor parallelism in one process: the rank mesh and its collectives,
the Megatron layout of a state dict, the TP model and the ring collective
matmul (the counterpart of ``protoquant_tpu.parallel``; context and
pipeline parallelism are not ported yet)."""

from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, RankGroup, init_multihost, make_mesh
from .shardings import param_shard_dim, params_shard_dims, shard_params
from .tp import (TPCache, TPModel, build_cp_score, build_tp_score, build_tp_step,
                 make_tp_caches, tp_model)

__all__ = [
    "make_mesh",
    "init_multihost",
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "RankGroup",
    "param_shard_dim",
    "params_shard_dims",
    "shard_params",
    "tp_model",
    "TPModel",
    "TPCache",
    "build_tp_step",
    "build_tp_score",
    "build_cp_score",
    "make_tp_caches",
]
