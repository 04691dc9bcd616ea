"""Dynamic per-row int8 quantization: kernel, plan and plain versions.

The kernel (``csrc/rowquant.cu`` on ``csrc/row_quant.cuh``) replaces the
Pallas kernel ``protoquant_tpu/ops/rowquant.py:_rowquant_kernel``: each row
is held in registers, read once by 16-byte loads, and its codes are written
from registers. :func:`rowquant_plan` cuts each row over the blocks of a
thread block cluster where rows are few (route "cluster": decode steps,
whose few rows would otherwise stream through a few SMs), else gives a row
one block (route "rows": prefill chunks, expert batches), and more blocks
where a row is wider than a block's registers hold. The SwiGLU producer
(``ops.swiglu_quant``) takes the same plan. ``rowquant.routes`` counts each
route. A CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.

A maximum does not depend on order and every code is elementwise, so any
cut of a row gives the plain version's bits: :func:`rowquant_parts_ref`
spells the cut out (each slice's maximum, the maximum of those, each slice
quantized), for the tests.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..core import numerics
from . import _build

# The kernel's geometry (csrc/row_quant.cuh): the 16-byte vectors a thread
# may hold, the most threads a block for each (the register budget), the
# most blocks a row (a cluster of the portable size).
VECTORS = (1, 2, 4)
MAX_THREADS = {1: 1024, 2: 768, 4: 512}
MAX_BLOCKS = 8
# The most vectors one block holds (512 threads of 4: 32 KB).
BLOCK_VECTORS = 2048
# The widest row every dtype's plan holds (f32: 4 values a vector).
MAX_K = MAX_BLOCKS * BLOCK_VECTORS * 4
# The plan's rule (tools/rowquant_timing.py --sweep on an H100, PERF.md):
# a thread holds as few 16-byte vectors as its block's threads allow (one
# up to 1024 vectors a block, two up to 1536). Few rows (m <= CLUSTER_MAX_M: decode
# steps, a decode step's experts) are latency-bound: a row of more than
# CLUSTER_MIN_VECTORS vectors is split over a cluster of blocks of about
# CLUSTER_SHARE vectors each (at most MAX_BLOCKS). Otherwise a row takes
# one block, or the fewest that hold it.
CLUSTER_MAX_M = 64
CLUSTER_MIN_VECTORS = 512
CLUSTER_SHARE = 128


class RowPlan(NamedTuple):
    route: str  # "cluster" or "rows"
    blocks: int  # blocks a row (a cluster where > 1)
    threads: int  # threads a block
    vectors: int  # 16-byte vectors a thread


def block_shape(share: int) -> tuple:
    """(threads, vectors) of a block that takes ``share`` vectors (at most
    BLOCK_VECTORS): the fewest vectors a thread its threads' budget allows,
    the threads a multiple of 32."""
    r = next(r for r in VECTORS if -(-share // r) <= MAX_THREADS[r])
    return max(32, -(-share // (32 * r)) * 32), r


@functools.lru_cache(maxsize=None)
def rowquant_plan(m: int, k: int, itemsize: int) -> RowPlan:
    """The plan of an [m, k] row quantization of ``itemsize``-byte values
    (rowquant's, and swiglu_quant's of its gate and up): the route, the
    blocks a row, the threads a block and the 16-byte vectors a thread.
    Cached per shape and dtype."""
    nvec = k // (16 // itemsize)  # a row's whole vectors at most
    if m <= CLUSTER_MAX_M and nvec > CLUSTER_MIN_VECTORS:
        blocks = min(MAX_BLOCKS, -(-nvec // CLUSTER_SHARE))
        return RowPlan("cluster", blocks, *block_shape(-(-nvec // blocks)))
    blocks = max(1, -(-nvec // BLOCK_VECTORS))  # wider than a block's registers hold
    return RowPlan("rows", blocks, *block_shape(-(-nvec // blocks)))


def row_slices(k: int, blocks: int, itemsize: int, head: int = 0) -> list:
    """The element ranges [k0, k1) of a row's ``blocks`` slices, as the
    kernel cuts a row whose first ``head`` elements lie before its first
    16-byte boundary: the whole 16-byte vectors after them shared out as
    [r n / blocks, (r + 1) n / blocks), slice 0 also holding the head and
    the last slice the tail."""
    v = 16 // itemsize
    head = min(head, k)
    nvec = (k - head) // v
    cuts = [head + v * (r * nvec // blocks) for r in range(blocks + 1)]
    cuts[0], cuts[-1] = 0, k
    return list(zip(cuts[:-1], cuts[1:]))


def part_maxima(x: torch.Tensor, slices: list) -> torch.Tensor:
    """Each slice's absolute maximum in f32: [..., len(slices)] (0 for an
    empty slice, as a block that holds no element)."""
    xf = x.float()
    zero = xf.new_zeros(x.shape[:-1])
    return torch.stack([xf[..., a:b].abs().amax(-1) if b > a else zero for a, b in slices], -1)


def quantize_parts(x: torch.Tensor, maxima: torch.Tensor, slices: list):
    """The rowquant contract from the slices' maxima: s = max(max of
    ``maxima`` / 127, 1e-12), each slice's codes rint(x / s) clamped to
    +-127. Returns (xq int8, s f32)."""
    amax = maxima.amax(-1)
    s = torch.clamp_min(amax / amax.new_full((), float(numerics.QMAX)), numerics.SCALE_EPS)
    xf = x.float()
    q = torch.cat([numerics.quantize(xf[..., a:b], s, dim=-1) for a, b in slices], -1)
    return q, s


def rowquant_parts_ref(x: torch.Tensor, plan: RowPlan, head: int = 0):
    """The kernel's cut of each row in plain PyTorch (:func:`row_slices` of
    ``plan.blocks`` and ``head``): equal to :func:`rowquant_ref` bit for
    bit at any plan."""
    slices = row_slices(x.shape[-1], plan.blocks, x.element_size(), head)
    return quantize_parts(x, part_maxima(x, slices), slices)


def rowquant_ref(x: torch.Tensor):
    """Plain version: x[..., K] -> (xq int8 [..., K], s_x f32 [...])."""
    return numerics.quantize_rowwise(x)


def check_width(name: str, k: int) -> None:
    if not 0 < k <= MAX_K:
        raise ValueError(f"{name}: K={k} outside (0, {MAX_K}]")


def rowquant_launch(x: torch.Tensor, plan: RowPlan | None = None):
    """Launch the kernel on a CUDA tensor with ``plan`` (None: the plan's);
    returns (xq, s_x, plan). Counts nothing (:func:`rowquant` counts)."""
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"rowquant: unsupported dtype {x.dtype}")
    k = x.shape[-1]
    check_width("rowquant", k)
    x = x.contiguous()
    dev = x.device
    m = x.numel() // k
    xq = torch.empty(x.shape, dtype=torch.int8, device=dev)
    sx = torch.empty(x.shape[:-1], dtype=torch.float32, device=dev)
    if m == 0:
        return xq, sx, None
    plan = plan or rowquant_plan(m, k, x.element_size())
    err = _build.lib().pq_rowquant(
        x.data_ptr(), _build.DTYPE_CODES[x.dtype], xq.data_ptr(), sx.data_ptr(), m, k,
        plan.blocks, plan.threads, plan.vectors, _build.stream_ptr(dev))
    _build.check(err, "pq_rowquant")
    return xq, sx, plan


def rowquant(x: torch.Tensor):
    """Per-token quantization x[..., K] -> (xq int8 [..., K], s_x f32 [...]),
    bit-identical to ``core.numerics.quantize_rowwise``."""
    if x.device.type == "cpu":
        return rowquant_ref(x)
    xq, sx, plan = rowquant_launch(x)
    if plan is not None:
        rowquant.launches += 1
        rowquant.routes[plan.route] += 1
    return xq, sx


rowquant.launches = 0
# launches by route: "cluster" (a row over a cluster), "rows" (a block a row)
rowquant.routes = {"cluster": 0, "rows": 0}
