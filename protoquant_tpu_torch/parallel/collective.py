"""Collective qmatmul: the row-parallel reduction of tensor parallelism as
a ring of chunk matmuls, the counterpart of
``protoquant_tpu/parallel/collective.py``.

Every function runs inside ``Mesh.run``, on each rank of ``group`` (the
mesh's ``RankGroup``; the JAX functions take its axis name and size). A
row-parallel weight is the rank's K/tp rows in the port's [N, K/tp] layout,
so a chunk of output columns is a contiguous block of rows.

Ring schedule (tp ranks, chunk e ends at rank e): the partial for chunk e
starts at rank (e + 1) % tp and hops +1 each step; rank d at step s holds
the partial for chunk (d - 1 - s) mod tp and adds its own product of that
chunk before forwarding it. After tp - 1 hops chunk d is home at rank d.

``RING_BACKEND`` picks the tier, as in the JAX package:
  "ppermute" — each chunk through ``ops.qmatmul``, each hop a
               ``group.ppermute``;
  "dma"      — one kernel runs the whole ring (``ops.qmatmul_reduce_scatter_dma``,
               the port of the explicit-DMA Pallas kernel);
  "auto"     — resolves to "ppermute", the JAX package's default.
Read from env ``PQ_RING_BACKEND`` at import, and at call time from the
module attribute.
"""

from __future__ import annotations

import os
from typing import Callable

import torch

from .. import ops

RING_BACKEND = os.environ.get("PQ_RING_BACKEND", "auto")


def resolve_ring_backend() -> str:
    return "ppermute" if RING_BACKEND == "auto" else RING_BACKEND


def _ring_perm(tp: int) -> list:
    return [(i, (i + 1) % tp) for i in range(tp)]


def collective_matmul_reduce_scatter(chunk_matmul: Callable, group) -> torch.Tensor:
    """Generic ring reduce-scatter matmul: ``chunk_matmul(c)`` returns this
    rank's product for output chunk c; the result is this rank's chunk of
    the sum over ranks, added in ring order."""
    tp, d = group.size, group.axis_index()
    acc = chunk_matmul((d - 1) % tp)
    for s in range(1, tp):
        acc = group.ppermute(acc, _ring_perm(tp))
        acc = acc + chunk_matmul((d - 1 - s) % tp)
    return acc


def _chunk_matmul(xq, s_x, wq, s_w, tp: int) -> Callable:
    nc = wq.shape[0] // tp

    def chunk(c):
        rows = slice(c * nc, (c + 1) * nc)
        return ops.qmatmul(xq, wq[rows], s_x, s_w[rows], out_dtype=torch.float32)

    return chunk


def qmatmul_reduce_scatter(x: torch.Tensor, wq: torch.Tensor, s_w: torch.Tensor, group,
                           out_dtype=torch.bfloat16) -> torch.Tensor:
    """Row-parallel dynamic-int8 linear with the ring reduce-scatter fused
    in (the ppermute tier). x [..., K/tp]; wq int8 [N, K/tp]; s_w f32 [N].
    Returns this rank's chunk [..., N/tp]: psum of the ranks' products,
    chunk-selected, each rank's activations quantized against its own K
    rows."""
    xq, s_x = ops.rowquant(x)
    out = collective_matmul_reduce_scatter(_chunk_matmul(xq, s_x, wq, s_w, group.size), group)
    return out.to(out_dtype)


def dynamic_qlinear_collective(x: torch.Tensor, wq: torch.Tensor, s_w: torch.Tensor, group,
                               *, scatter_tokens: bool = False,
                               out_dtype=torch.float32) -> torch.Tensor:
    """The row-parallel dynamic-int8 linear of ``QLinear(collective=True)``:
    per-rank rowquant, the ring reduce-scatter of ``RING_BACKEND``, then an
    all_gather of the chunks, which equals the psum of the ranks' products.
    x [B, T, K/tp] (or [M, K/tp]); wq int8 [N, K/tp]; s_w f32 [N]; returns
    [B, T, N]. ``scatter_tokens`` (sequence parallelism) is not ported
    yet."""
    if scatter_tokens:
        raise NotImplementedError("sequence parallelism (scatter_tokens) is not ported yet")
    xq, s_x = ops.rowquant(x)
    if resolve_ring_backend() == "dma":
        k = xq.shape[-1]
        part = ops.qmatmul_reduce_scatter_dma(
            xq.reshape(-1, k), s_x.reshape(-1), wq, s_w, group
        ).reshape(*x.shape[:-1], -1)
    else:
        part = collective_matmul_reduce_scatter(_chunk_matmul(xq, s_x, wq, s_w, group.size),
                                                group)
    out = group.all_gather(part, axis=part.ndim - 1, tiled=True)
    return out.to(out_dtype)


def weight_only_qlinear_collective(*args, **kwargs):
    """The weight-only ring (JAX ``weight_only_qlinear_collective``) is not
    ported yet."""
    raise NotImplementedError("the weight_only collective is not ported yet")


def qmatmul_allreduce_overlapped(x: torch.Tensor, wq: torch.Tensor, s_w: torch.Tensor, group,
                                 out_dtype=torch.bfloat16) -> torch.Tensor:
    """Reduce-scatter matmul + all_gather: the overlapped all-reduce matmul,
    the full [..., N] product on every rank."""
    chunk = qmatmul_reduce_scatter(x, wq, s_w, group, out_dtype=torch.float32)
    return group.all_gather(chunk, axis=chunk.ndim - 1, tiled=True).to(out_dtype)
