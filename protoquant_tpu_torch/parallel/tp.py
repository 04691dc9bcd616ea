"""Tensor-parallel model execution, the counterpart of
``protoquant_tpu/parallel/tp.py``.

The JAX package runs the whole step inside one ``shard_map`` over the mesh:
every device runs its kernels on its weight shard, and the model places
the collectives itself (``QLinear.psum_axis``, the lm_head's all_gather).
Here ``TPModel`` holds one ``LlamaModel`` shard per rank and runs them
through ``Mesh.run``, each rank in its own thread; the shards place the same
collectives through the mesh's rank group. Its ``forward`` takes and
returns what ``LlamaModel``'s does (rank 0's gathered logits), so the
engine drives it as it drives one model. A layer's KV cache under tensor
parallelism is a ``TPCache``: one cache per rank, KV/tp heads each.
"""

from __future__ import annotations

import torch
from torch import nn

from ..models.llama import LlamaModel, init_cache
from ..utils.config import ModelConfig
from .mesh import MODEL_AXIS


class TPModel(nn.Module):
    """A tensor-parallel ``LlamaModel``: ``shards[r]`` is rank r's, on
    ``mesh.devices[r]``. Load weights with ``load_shards(shard_params(
    state_dict, mesh))``."""

    def __init__(self, cfg: ModelConfig, mode: str, mesh, dtype=torch.bfloat16,
                 collective: bool = False):
        super().__init__()
        self.cfg, self.mode, self.mesh, self.dtype = cfg, mode, mesh, dtype
        self.device = mesh.devices[0]
        self.shards = nn.ModuleList(
            LlamaModel(cfg, mode, dtype, device=dev, tp_group=mesh.group,
                       collective=collective)
            for dev in mesh.devices)

    def load_shards(self, shards: list) -> "TPModel":
        """Load one state dict per rank (``shard_params``)."""
        if len(shards) != len(self.shards):
            raise ValueError(f"{len(shards)} shards for {len(self.shards)} ranks")
        for model, sd in zip(self.shards, shards):
            model.load_state_dict(sd, strict=True)
        return self

    @torch.no_grad()
    def forward(self, tokens, positions=None, caches=None, advance=None):
        """As ``LlamaModel.forward``, with ``caches`` a list of ``TPCache``;
        returns rank 0's logits [B, T, V] (every rank holds the same)."""
        def rank(r: int):
            dev = self.mesh.devices[r]
            to = lambda t: None if t is None else t.to(dev)
            return self.shards[r](to(tokens), to(positions),
                                  None if caches is None else [c.shards[r] for c in caches],
                                  to(advance))

        return self.mesh.run(rank)[0]


class TPCache:
    """One layer's KV cache under tensor parallelism: ``shards[r]`` holds
    rank r's KV/tp heads. The engine's slot handling reaches every rank;
    the lengths are rank 0's (all ranks advance alike)."""

    def __init__(self, shards: list):
        self.shards = list(shards)

    @property
    def lengths(self) -> torch.Tensor:
        return self.shards[0].lengths

    def slot_view(self, slot: int) -> "TPCache":
        return TPCache([c.slot_view(slot) for c in self.shards])

    def merge_slot(self, small: "TPCache", slot: int) -> "TPCache":
        for c, s in zip(self.shards, small.shards):
            c.merge_slot(s, slot)
        return self

    def reset_slot(self, slot: int) -> "TPCache":
        for c in self.shards:
            c.reset_slot(slot)
        return self


def tp_model(cfg: ModelConfig, mode: str, mesh, dtype=None,
             collective: bool = False) -> TPModel:
    """The TP model for ``mesh``: head and feature dims divided by tp.
    ``collective`` routes the row-parallel reductions through the ring
    collective matmul (``parallel.collective``) instead of a bare psum."""
    return TPModel(cfg, mode, mesh, dtype or torch.bfloat16, collective)


def make_tp_caches(cfg: ModelConfig, mesh, batch: int, max_seq: int,
                   kv_dtype=torch.bfloat16) -> list:
    """Per layer a ``TPCache`` of the ranks' caches (``init_cache(...,
    tp=tp)`` on each rank's device): the dense bf16 and int8 caches."""
    tp = mesh.shape[MODEL_AXIS]
    per_rank = [init_cache(cfg, batch, max_seq, dev, kv_dtype, tp=tp) for dev in mesh.devices]
    return [TPCache(layer) for layer in zip(*per_rank)]


def build_tp_step(model: TPModel, mesh):
    """fn(tokens, positions, caches, advance) -> logits, updating the
    ``make_tp_caches`` caches in place (the JAX step returns them)."""
    if model.mesh is not mesh:
        raise ValueError("the model was built for another mesh")
    return lambda tokens, positions, caches, advance=None: model(tokens, positions, caches,
                                                                 advance)


def build_tp_score(model: TPModel, mesh):
    """Cache-free scoring: fn(tokens) -> logits."""
    if model.mesh is not mesh:
        raise ValueError("the model was built for another mesh")
    return lambda tokens: model(tokens)


def build_cp_score(*args, **kwargs):
    """Context-parallel scoring (ring attention over a sequence axis) is not
    ported yet."""
    raise NotImplementedError("context parallelism (parallel/context.py) is not ported yet")
