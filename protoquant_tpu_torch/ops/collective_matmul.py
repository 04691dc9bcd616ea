"""Ring reduce-scatter int8 matmul: kernel and plain version.

The kernel (``csrc/collective_matmul.cu``) replaces the Pallas kernel
``protoquant_tpu/ops/collective_matmul.py:_ring_kernel``: the row-parallel
reduction of tensor parallelism as one ring of chunk GEMMs, each rank's
partial hopping to its right neighbour while the next chunk multiplies.

Rank d of a ring of tp holds ``xq`` int8 [M, K/tp] (its slice of the
activations), ``s_x`` f32 [M], ``wq`` int8 [N, K/tp] (its K rows of the
weight, in the port's [N, K] layout; the JAX package's is [K/tp, N]) and
``s_w`` f32 [N], and ends with chunk d of the reduced product, f32 [M,
N/tp]. Chunk e is ``((A_{e+1} + A_{e+2}) + ...) + A_e`` over ranks mod tp,
where ``A_d = (f32(xq_d . wq_d[chunk e]^T) * s_x_d) * s_w[chunk e]``: the
ring of ``parallel/collective.py:collective_matmul_reduce_scatter``, whose
partial for chunk e starts at rank e + 1 and hops +1.

``qmatmul_reduce_scatter_dma`` is the per-rank call, inside ``Mesh.run``;
its rendezvous hands every rank's operands to
``qmatmul_reduce_scatter_dma_all``, which computes all ranks' chunks: one
launch for the ranks that share a card (``blockIdx.z`` is the rank), or the
plain version for tensors on the CPU. Ranks on different cards are not
ported yet (they need peer memory). The kernel reads the flags of a
persistent set kept per (card, tp, N) and tagged by a per-call epoch; a
call may not be captured in a CUDA graph, whose replays would repeat the
epoch (the kernel then traps rather than hangs).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..core import numerics
from . import _build

_RING_MAX = 8  # csrc/collective_matmul.cu RING_MAX
_TILE = 64  # columns of a chunk per block


def qmatmul_reduce_scatter_dma_all_ref(xqs, sxs, wqs, sws) -> list:
    """Plain version over every rank's operands (lists in rank order):
    each rank's reduced chunk [M, N/tp] f32, in the ring's order."""
    tp = len(xqs)
    nc = wqs[0].shape[0] // tp

    def part(d, e):  # rank d's product for chunk e
        rows = slice(e * nc, (e + 1) * nc)
        return numerics.qmatmul_ref(xqs[d], wqs[d][rows], sxs[d], sws[d][rows])

    outs = []
    for e in range(tp):
        acc = part((e + 1) % tp, e)
        for hop in range(2, tp + 1):
            acc = acc + part((e + hop) % tp, e)
        outs.append(acc)
    return outs


class _RingState:
    """Flags, receive slots and epoch of the ring on one card for one
    (tp, N): the flags are never reset, each call's epoch tags them."""

    def __init__(self, dev: torch.device, tp: int, tiles: int):
        self.data = torch.zeros(tp, 2, tiles, dtype=torch.int32, device=dev)
        self.credit = torch.zeros(tp, 2, tiles, dtype=torch.int32, device=dev)
        self.comm = torch.empty(0, dtype=torch.float32, device=dev)
        self.epoch = 0

    def slots(self, tp: int, M: int, nc: int) -> torch.Tensor:
        if self.comm.numel() < tp * 2 * M * nc:
            self.comm = torch.empty(tp * 2 * M * nc, dtype=torch.float32,
                                    device=self.comm.device)
        return self.comm[:tp * 2 * M * nc].view(tp, 2, M, nc)

    def next_epoch(self) -> int:
        self.epoch = self.epoch % 0xFFFFFFFF + 1  # 1, 2, ..., never 0
        return self.epoch


_states: dict = {}
_states_lock = threading.Lock()


def _ptrs(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def qmatmul_reduce_scatter_dma_all(xqs, sxs, wqs, sws) -> list:
    """Every rank's reduced chunk from every rank's operands (lists in rank
    order, as ``qmatmul_reduce_scatter_dma`` takes them): one kernel launch
    for ranks on one card, the plain version on the CPU."""
    tp = len(xqs)
    if not (len(sxs) == len(wqs) == len(sws) == tp):
        raise ValueError("qmatmul_reduce_scatter_dma: one operand of each kind per rank")
    if xqs[0].device.type == "cpu":
        return qmatmul_reduce_scatter_dma_all_ref(xqs, sxs, wqs, sws)
    M, K = xqs[0].shape
    N = wqs[0].shape[0]
    for xq, sx, wq, sw in zip(xqs, sxs, wqs, sws):
        if xq.shape != (M, K) or sx.shape != (M,) or wq.shape != (N, K) or sw.shape != (N,):
            raise ValueError(f"qmatmul_reduce_scatter_dma: shapes xq {tuple(xq.shape)}, "
                             f"s_x {tuple(sx.shape)}, wq {tuple(wq.shape)}, "
                             f"s_w {tuple(sw.shape)}")
        if xq.dtype != torch.int8 or wq.dtype != torch.int8:
            raise TypeError("qmatmul_reduce_scatter_dma: xq and wq must be int8")
        if sx.dtype != torch.float32 or sw.dtype != torch.float32:
            raise TypeError("qmatmul_reduce_scatter_dma: scales must be float32")
    if any(t.device != xqs[0].device for t in (*xqs, *sxs, *wqs, *sws)):
        raise NotImplementedError("qmatmul_reduce_scatter_dma: ranks on different cards "
                                  "(peer memory) are not ported yet")
    dev = _build.same_device_contiguous("qmatmul_reduce_scatter_dma",
                                        *xqs, *sxs, *wqs, *sws)
    if tp > _RING_MAX:
        raise ValueError(f"qmatmul_reduce_scatter_dma: tp={tp} above {_RING_MAX}")
    if N % tp:
        raise ValueError(f"qmatmul_reduce_scatter_dma: N={N} not divisible by tp={tp}")
    if K % 16:
        raise ValueError(f"qmatmul_reduce_scatter_dma: K={K} must be a multiple of 16")
    if any(t.data_ptr() % 16 for t in (*xqs, *wqs)):
        raise ValueError("qmatmul_reduce_scatter_dma: int8 operands must be 16-byte aligned")
    nc = N // tp
    out = torch.empty(tp, M, nc, dtype=torch.float32, device=dev)
    if M == 0:
        return list(out.unbind(0))
    key = (dev, tp, N)
    with _states_lock:
        state = _states.get(key)
        if state is None:
            state = _states[key] = _RingState(dev, tp, -(-nc // _TILE))
        comm = state.slots(tp, M, nc)
        epoch = state.next_epoch()
        err = _build.lib().pq_ring_qmatmul_rs(
            _ptrs(xqs), _ptrs(sxs), _ptrs(wqs), _ptrs(sws), _ptrs(out.unbind(0)),
            _ptrs(comm.unbind(0)), _ptrs(state.data.unbind(0)),
            _ptrs(state.credit.unbind(0)), tp, 0, tp, M, N, K, epoch,
            _build.stream_ptr(dev))
    _build.check(err, "pq_ring_qmatmul_rs")
    qmatmul_reduce_scatter_dma.launches += 1
    return list(out.unbind(0))


def qmatmul_reduce_scatter_dma(xq: torch.Tensor, s_x: torch.Tensor, wq: torch.Tensor,
                               s_w: torch.Tensor, group) -> torch.Tensor:
    """This rank's reduced chunk [M, N/tp] f32 of the row-parallel product
    (call inside ``Mesh.run``, every rank of ``group`` at once): xq int8
    [M, K/tp], s_x f32 [M], wq int8 [N, K/tp], s_w f32 [N]."""
    return group.collective(
        (xq, s_x, wq, s_w),
        lambda operands: qmatmul_reduce_scatter_dma_all(*map(list, zip(*operands))),
        "qmatmul_reduce_scatter_dma")


qmatmul_reduce_scatter_dma.launches = 0


def qmatmul_reduce_scatter_dma_ref(xq, s_x, wq, s_w, group) -> torch.Tensor:
    """Plain version of the per-rank call, on any device."""
    return group.collective(
        (xq, s_x, wq, s_w),
        lambda operands: qmatmul_reduce_scatter_dma_all_ref(*map(list, zip(*operands))),
        "qmatmul_reduce_scatter_dma")
