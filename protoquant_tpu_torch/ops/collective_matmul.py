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

Each ring step's product is split over K between the blocks of a thread
block cluster, their int32 partials summed over distributed shared memory,
as ``gemm_plan.ring_plan`` says. :func:`ring_fragments` picks the kernel
instance and so the route (this module owns the threshold; the C entry
launches the instance it is given and refuses an M that does not fit it):
M <= ``RING_DECODE_MAX_M`` the decode route (a step's tokens read from
global memory), larger M the prefill route (64 token rows at a time, staged
in shared memory). The wrapper counts the route it launched in
``.routes``.
:func:`qmatmul_reduce_scatter_dma_splitk_ref` spells the split out in plain
PyTorch, for the tests.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..core import numerics
from . import _build
from .gemm_plan import DECODE_ROWS, RING_BLOCKS_PER_SM, held_clusters, ring_plan
from .qmatmul import DECODE_STEP, _sm_count, qmatmul_splitk_ref

_RING_MAX = 8  # csrc/collective_matmul.cu RING_MAX
# The largest M the decode route takes (1, 2 or 4 fragments of 8 tokens;
# above it the prefill instance's 8, 64 token rows at a time).
RING_DECODE_MAX_M = 32
RING_PREFILL_MF = 8  # csrc/collective_matmul.cu RING_PREFILL_MF


def _ring(tp: int, part) -> list:
    """Each rank's reduced chunk from ``part(d, e)``, rank d's product for
    chunk e: chunk e adds rank e + 1's first and rank e's last."""
    outs = []
    for e in range(tp):
        acc = part((e + 1) % tp, e)
        for hop in range(2, tp + 1):
            acc = acc + part((e + hop) % tp, e)
        outs.append(acc)
    return outs


def qmatmul_reduce_scatter_dma_all_ref(xqs, sxs, wqs, sws) -> list:
    """Plain version over every rank's operands (lists in rank order):
    each rank's reduced chunk [M, N/tp] f32, in the ring's order."""
    tp = len(xqs)
    nc = wqs[0].shape[0] // tp

    def part(d, e):
        rows = slice(e * nc, (e + 1) * nc)
        return numerics.qmatmul_ref(xqs[d], wqs[d][rows], sxs[d], sws[d][rows])

    return _ring(tp, part)


def qmatmul_reduce_scatter_dma_splitk_ref(xqs, sxs, wqs, sws, splits: int = 1) -> list:
    """The kernel's order in plain PyTorch: each rank's product of each
    chunk as the exact int32 partials of ``splits`` K slices (whole 64-byte
    steps, ``qmatmul.k_slices``) summed, then the epilogue (acc * s_x) *
    s_w, then the ring's adds. Equal to the plain version bit for bit at
    any ``splits``."""
    tp = len(xqs)
    nc = wqs[0].shape[0] // tp

    def part(d, e):
        rows = slice(e * nc, (e + 1) * nc)
        return qmatmul_splitk_ref(xqs[d], wqs[d][rows], sxs[d], sws[d][rows],
                                  k_splits=splits, step=DECODE_STEP)

    return _ring(tp, part)


def ring_fragments(m: int) -> int:
    """The kernel instance for ``m`` token rows, named by its fragments of 8
    tokens a unit: 1, 2 or 4 (the decode route, a step one unit) up to
    ``RING_DECODE_MAX_M`` rows, ``RING_PREFILL_MF`` (the prefill route)
    above. The C entry launches the instance it is given."""
    if m > RING_DECODE_MAX_M:
        return RING_PREFILL_MF
    return 1 if m <= 8 else 2 if m <= 16 else 4


def fragments_route(mf: int) -> str:
    """The route of the kernel instance of ``mf`` fragments."""
    return "prefill" if mf == RING_PREFILL_MF else "decode"


def ring_route(m: int) -> str:
    """The kernel's route for ``m`` token rows."""
    return fragments_route(ring_fragments(m))


def ring_held(dev, mf: int, tp: int) -> dict:
    """{splits: clusters of that many blocks the card holds at once} of the
    kernel instance of ``mf`` fragments for a ring of ``tp``
    (``gemm_plan.held_clusters``)."""
    return held_clusters("pq_ring_qmatmul_rs", dev, mf, tp)


def ring_tiles(nc: int) -> int:
    """Tiles of a chunk of ``nc`` columns: the clusters of a rank, each with
    its data and credit flags."""
    return -(-nc // DECODE_ROWS)


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
        """The next call's epoch (1, 2, ..., never 0), kept only once that
        call has launched: a refused launch moves no flag."""
        return self.epoch % 0xFFFFFFFF + 1


_states: dict = {}
_states_lock = threading.Lock()


def _ptrs(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _check(xqs, sxs, wqs, sws):
    """Check every rank's operands for the kernel; returns (M, N, K, device)."""
    tp = len(xqs)
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
    return M, N, K, dev


def ring_plan_of(xqs, wqs, mf: int | None = None) -> int | None:
    """``gemm_plan.ring_plan``'s K splits for these CUDA operands on the
    instance of ``mf`` fragments (None: :func:`ring_fragments`'s; one
    cluster a tile a rank), or None where the launch cannot be resident."""
    tp = len(xqs)
    (M, K), N, dev = xqs[0].shape, wqs[0].shape[0], xqs[0].device
    mf = ring_fragments(M) if mf is None else mf
    return ring_plan(ring_tiles(N // tp) * tp, -(-K // DECODE_STEP), ring_held(dev, mf, tp),
                     _sm_count(dev), RING_BLOCKS_PER_SM[fragments_route(mf)])


def ring_launch(xqs, sxs, wqs, sws, k_splits: int | None = None,
                mf: int | None = None) -> list:
    """Launch the kernel instance of ``mf`` fragments (None:
    :func:`ring_fragments`'s) on every rank's CUDA operands with
    ``k_splits`` blocks a cluster (None: :func:`ring_plan_of`'s); returns
    each rank's chunk. Counts nothing (:func:`qmatmul_reduce_scatter_dma_all`
    routes and counts). Raises before launch where the plan finds no grid
    that the card holds whole; CUDA refuses a forced one, and a decode
    instance too small for M."""
    tp = len(xqs)
    M, N, K, dev = _check(xqs, sxs, wqs, sws)
    nc = N // tp
    out = torch.empty(tp, M, nc, dtype=torch.float32, device=dev)
    if M == 0:
        return list(out.unbind(0))
    mf = ring_fragments(M) if mf is None else mf
    if k_splits is None:
        k_splits = ring_plan_of(xqs, wqs, mf)
        if k_splits is None:
            raise ValueError(f"qmatmul_reduce_scatter_dma: {ring_tiles(nc) * tp} clusters "
                             f"(tp={tp}, N={N}, M={M}) cannot all be resident on the card")
    key = (dev, tp, N)
    with _states_lock:
        state = _states.get(key)
        if state is None:
            state = _states[key] = _RingState(dev, tp, ring_tiles(nc))
        comm = state.slots(tp, M, nc)
        epoch = state.next_epoch()
        err = _build.lib().pq_ring_qmatmul_rs(
            _ptrs(xqs), _ptrs(sxs), _ptrs(wqs), _ptrs(sws), _ptrs(out.unbind(0)),
            _ptrs(comm.unbind(0)), _ptrs(state.data.unbind(0)),
            _ptrs(state.credit.unbind(0)), tp, 0, tp, M, N, K, mf, k_splits, epoch,
            _build.stream_ptr(dev))
        if err == 0:
            state.epoch = epoch
    _build.check(err, "pq_ring_qmatmul_rs")
    return list(out.unbind(0))


def qmatmul_reduce_scatter_dma_all(xqs, sxs, wqs, sws) -> list:
    """Every rank's reduced chunk from every rank's operands (lists in rank
    order, as ``qmatmul_reduce_scatter_dma`` takes them): one kernel launch
    for ranks on one card, on the instance :func:`ring_fragments` picks for
    its M (counted by its route), the plain version on the CPU."""
    tp = len(xqs)
    if not (len(sxs) == len(wqs) == len(sws) == tp):
        raise ValueError("qmatmul_reduce_scatter_dma: one operand of each kind per rank")
    if xqs[0].device.type == "cpu":
        return qmatmul_reduce_scatter_dma_all_ref(xqs, sxs, wqs, sws)
    mf = ring_fragments(xqs[0].shape[0])
    outs = ring_launch(xqs, sxs, wqs, sws, mf=mf)
    if xqs[0].shape[0]:
        qmatmul_reduce_scatter_dma.launches += 1
        qmatmul_reduce_scatter_dma.routes[fragments_route(mf)] += 1
    return outs


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
# launches by route, as launched (the instance ring_fragments gave the C
# entry): "decode" (M <= RING_DECODE_MAX_M), "prefill"
qmatmul_reduce_scatter_dma.routes = {"decode": 0, "prefill": 0}


def qmatmul_reduce_scatter_dma_ref(xq, s_x, wq, s_w, group) -> torch.Tensor:
    """Plain version of the per-rank call, on any device."""
    return group.collective(
        (xq, s_x, wq, s_w),
        lambda operands: qmatmul_reduce_scatter_dma_all_ref(*map(list, zip(*operands))),
        "qmatmul_reduce_scatter_dma")
