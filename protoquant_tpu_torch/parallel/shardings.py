"""Megatron tensor-parallel layout of a ``LlamaModel`` state dict, the
rules of ``protoquant_tpu/parallel/shardings.py`` on the port's names:

  * column-parallel (q/k/v/gate/up/lm_head): the int8 payload and its
    per-output-channel scale (and bias) split on the output channel, the
    port's dim 0 of [N, K];
  * row-parallel (o_proj/down_proj): the payload split on the contraction,
    dim 1 of [N, K]; its per-output-channel scales and bias replicated
    (the bias is added after the reduction);
  * norms and the embedding: replicated.

``shard_params`` returns one state dict per rank of the mesh's model axis,
each tensor a contiguous copy on its rank's device: the kernels take
contiguous, 16-byte-aligned operands, and so does a chunk of rows of a
row-parallel weight in the ring. MoE experts (expert parallelism), MLA and
LoRA leaves, and group-wise int4 weights, are not ported under tensor
parallelism yet.
"""

from __future__ import annotations

import torch

from .mesh import MODEL_AXIS

COLUMN_PARALLEL = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj", "lm_head")
ROW_PARALLEL = ("o_proj", "down_proj")
_NOT_PORTED = ("block_sparse_moe", "q_b_proj", "kv_b_proj", "q_a_proj",
               "kv_a_proj_with_mqa", "lora_a", "lora_b")


def param_shard_dim(name: str, tensor: torch.Tensor) -> int | None:
    """The dim along which ``name`` splits over the model axis, or None when
    it is replicated."""
    parts = name.split(".")
    blocked = [p for p in parts if p in _NOT_PORTED]
    if blocked:
        raise NotImplementedError(f"{name}: {blocked[0]} under tensor parallelism is not "
                                  "ported yet")
    leaf = parts[-1]
    if leaf == "qscale" and tensor.ndim == 2:
        raise NotImplementedError(f"{name}: int4 weights under tensor parallelism are not "
                                  "ported yet")
    if any(p in COLUMN_PARALLEL for p in parts):
        return 0  # weight / qweight [N, K], qscale [N], bias [N]
    if any(p in ROW_PARALLEL for p in parts):
        return 1 if leaf in ("weight", "qweight") else None
    return None


def params_shard_dims(params: dict) -> dict:
    """{name: dim or None} for a ``LlamaModel`` state dict (the port's
    ``params_pspecs``)."""
    return {name: param_shard_dim(name, t) for name, t in params.items()}


def shard_params(params: dict, mesh) -> list:
    """Per-rank state dicts of a full ``LlamaModel`` state dict, rank r's
    on ``mesh.devices[r]``."""
    tp = mesh.shape[MODEL_AXIS]
    shards = [{} for _ in range(tp)]
    for name, t in params.items():
        dim = param_shard_dim(name, t)
        if dim is not None and t.shape[dim] % tp:
            raise ValueError(f"{name}: dim {dim} of {tuple(t.shape)} does not split "
                             f"over tp={tp}")
        for r, dev in enumerate(mesh.devices):
            piece = t if dim is None else t.narrow(dim, r * (t.shape[dim] // tp),
                                                   t.shape[dim] // tp)
            shards[r][name] = piece.to(dev).clone(memory_format=torch.contiguous_format)
    return shards
