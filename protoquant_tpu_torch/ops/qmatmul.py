"""int8 GEMM with the fused f32 epilogue: kernels and plain versions.

Two kernels replace the Pallas kernel
``protoquant_tpu/ops/qmatmul.py:_qmatmul_kernel``, chosen by the number of
token rows M before launch: M <= ``DECODE_MAX_M`` (every decode step, a
decoding MoE expert's few tokens) takes the split-K decode kernel
(``csrc/qmatmul_decode.cu``: weight rows on the MMA's 16-row side, K split
across the blocks of a thread block cluster as :func:`qmatmul_decode_plan`
says, the int32 partials reduced in shared memory), larger M (prefill
chunks, MoE prefill) the tile kernel (``csrc/qmatmul.cu``: TMA and wgmma,
128- or 256-row tiles of 128 columns, K split over a cluster where the
tiles are fewer than the SMs, as :func:`qmatmul_tile_plan` says).
Weights are [N, K] int8 (the ``nn.Linear`` layout, K contiguous) with
per-output-channel scales [N]. A CPU tensor takes the plain version; a CUDA
tensor launches a kernel or raises. :func:`qmatmul_splitk_ref` spells
either kernel's split out in plain PyTorch, for the tests.
"""

from __future__ import annotations

import math

import torch

from ..core import numerics
from . import _build
from .rowquant import rowquant

# The largest M the decode kernel takes (above it the tile kernel is the
# faster at the 7B, Gemma-2 and GPT-OSS widths) and the blocks an SM its plan
# aims for (both from the sweeps in PERF.md, tools/gemm_timing.py --sweep),
# and its geometry (csrc/qmatmul_decode.cu, which takes up to 64 rows):
# weight rows a block, K bytes a step, the most blocks a cluster splits K
# over.
DECODE_MAX_M = 32
DECODE_BLOCKS_PER_SM = 2.25
DECODE_ROWS = 64
DECODE_STEP = 64
DECODE_MAX_SPLITS = 8
# The tile kernel's geometry (csrc/qmatmul.cu): output columns a tile, K
# bytes a step, the most blocks a cluster splits K over, the fewest steps a
# split keeps (the ring's depth), and the clusters of 4 that an H100 holds at
# once (cudaOccupancyMaxActiveClusters: 30, not 132 / 4, as its GPCs' SM
# counts are not all multiples of 4).
TILE_N = 128
TILE_STEP = 128
TILE_MAX_SPLITS = 4
TILE_MIN_STEPS = 4
TILE_QUAD_CLUSTERS = 30

_sms: dict = {}


def qmatmul_ref(xq, wq, s_x, s_w, bias=None, out_dtype=torch.float32):
    """Plain version: (xq @ wq^T) * s_x[:, None] * s_w[None, :] + bias."""
    return numerics.qmatmul_ref(xq, wq, s_x, s_w, bias, out_dtype)


def qmatmul_decode_plan(m: int, n: int, k: int, sms: int):
    """The decode kernel's K splits (1, 2, 4 or 8: the blocks of a cluster)
    for an [m, k] x [n, k]^T product on a card of ``sms`` SMs, or None
    where the tile kernel takes it (m > ``DECODE_MAX_M``): of the splits
    that leave each at least two 64-byte steps of K, the one whose blocks
    of 64 weight rows come nearest ``DECODE_BLOCKS_PER_SM`` an SM (the
    fewer on a tie)."""
    if m > DECODE_MAX_M:
        return None
    tiles, steps = -(-n // DECODE_ROWS), -(-k // DECODE_STEP)
    target = DECODE_BLOCKS_PER_SM * sms
    best, splits = 1, 2
    while splits <= DECODE_MAX_SPLITS and 2 * splits <= steps:
        if abs(math.log2(tiles * splits / target)) < abs(math.log2(tiles * best / target)):
            best = splits
        splits *= 2
    return best


def qmatmul_tile_plan(m: int, n: int, k: int, sms: int):
    """The tile kernel's (rows a tile, K splits) for an [m, k] x [n, k]^T
    product on a card of ``sms`` SMs (from the plan sweep in PERF.md): of
    the tiles of 128 rows (and of 256 where m > 128) and the splits of K
    over 1, 2 or 4 blocks of a cluster that leave each split at least
    ``TILE_MIN_STEPS`` 128-byte steps, the plan with the most blocks that
    still run in one wave (one block an SM; clusters of 4 at most
    ``TILE_QUAD_CLUSTERS``), the taller tile and then the fewer splits on a
    tie; where none fits one wave, the tallest tile unsplit."""
    steps = -(-k // TILE_STEP)
    heights = (256, 128) if m > 128 else (128,)
    best, most = (heights[0], 1), 0
    for bm in heights:
        tiles = -(-m // bm) * -(-n // TILE_N)
        splits = 1
        while splits <= TILE_MAX_SPLITS and (splits == 1 or steps >= splits * TILE_MIN_STEPS):
            wave = 4 * min(sms // 4, TILE_QUAD_CLUSTERS) if splits == 4 else sms
            if most < tiles * splits <= wave:
                best, most = (bm, splits), tiles * splits
            splits *= 2
    return best


def k_slices(k: int, k_splits: int, step: int = DECODE_STEP) -> list:
    """The K ranges [k0, k1) of a kernel's splits, as its blocks take them:
    split r holds the ``step``-byte steps [r steps / k_splits, (r + 1)
    steps / k_splits) of the ceil(k / step), the last cut at k (``step``:
    64 for the decode kernel, ``TILE_STEP`` for the tile kernel)."""
    steps = -(-k // step)
    ends = [min(k, step * (r * steps // k_splits)) for r in range(k_splits + 1)]
    return list(zip(ends[:-1], ends[1:]))


def qmatmul_splitk_ref(xq, wq, s_x, s_w, bias=None, out_dtype=torch.float32, k_splits=1,
                       step=DECODE_STEP):
    """A kernel's K split in plain PyTorch: the exact int32 product of each
    K slice (:func:`k_slices` with ``step``), the slices' partials summed,
    then the epilogue (acc * s_x) * s_w + bias, cast to ``out_dtype``.
    Equal to :func:`qmatmul_ref` bit for bit at any ``k_splits``."""
    k = xq.shape[-1]
    x2 = xq.reshape(-1, k)
    acc = torch.zeros(x2.shape[0], wq.shape[0], dtype=torch.int32, device=xq.device)
    for k0, k1 in k_slices(k, k_splits, step):
        acc += numerics.int_matmul_nk(x2[:, k0:k1], wq[:, k0:k1])
    y = acc.float() * s_x.reshape(-1, 1).float() * s_w.float()[None, :]
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype).reshape(*xq.shape[:-1], wq.shape[0])


def _check(xq, wq, s_x, s_w, bias, out_dtype):
    """Check the operands for either kernel; returns (xq, s_x, bias, device)
    made contiguous."""
    n, k = wq.shape
    if xq.shape[-1] != k or s_w.shape != (n,) or s_x.shape != xq.shape[:-1]:
        raise ValueError(f"qmatmul: shapes xq {tuple(xq.shape)}, wq "
                         f"{tuple(wq.shape)}, s_x {tuple(s_x.shape)}, "
                         f"s_w {tuple(s_w.shape)}")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError("qmatmul: xq and wq must be int8")
    if s_x.dtype != torch.float32 or s_w.dtype != torch.float32:
        raise TypeError("qmatmul: scales must be float32")
    if out_dtype not in _build.DTYPE_CODES:
        raise TypeError(f"qmatmul: unsupported out_dtype {out_dtype}")
    if k % 16:
        raise ValueError(f"qmatmul: K={k} must be a multiple of 16")
    if bias is not None:
        if bias.shape != (n,):
            raise ValueError(f"qmatmul: bias shape {tuple(bias.shape)}")
        bias = bias.float().contiguous()
    xq, s_x = xq.contiguous(), s_x.contiguous()
    tensors = [xq, wq, s_x, s_w] + ([bias] if bias is not None else [])
    dev = _build.same_device_contiguous("qmatmul", *tensors)
    if xq.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError("qmatmul: int8 operands must be 16-byte aligned")
    return xq, s_x, bias, dev


def _sm_count(dev) -> int:
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sms[index]


def qmatmul_launch(xq, wq, s_x, s_w, bias=None, out_dtype=torch.float32, k_splits=None,
                   tile=None):
    """Launch one kernel on CUDA operands: the decode kernel with
    ``k_splits`` (1, 2, 4 or 8) K splits, or for None the tile kernel with
    ``tile`` = (rows a tile, K splits) (None: :func:`qmatmul_tile_plan`'s).
    Returns the output; counts nothing (:func:`qmatmul` routes and counts)."""
    xq, s_x, bias, dev = _check(xq, wq, s_x, s_w, bias, out_dtype)
    n, k = wq.shape
    m = xq.numel() // k
    out = torch.empty(*xq.shape[:-1], n, dtype=out_dtype, device=dev)
    head = (xq.data_ptr(), wq.data_ptr(), s_x.data_ptr(), s_w.data_ptr(),
            bias.data_ptr() if bias is not None else None, out.data_ptr(),
            _build.DTYPE_CODES[out_dtype], m, n, k)
    if k_splits is None:
        bm, splits = tile or qmatmul_tile_plan(m, n, k, _sm_count(dev))
        err = _build.lib().pq_qmatmul(*head, bm, splits, _build.stream_ptr(dev))
        name = "pq_qmatmul"
    else:
        err = _build.lib().pq_qmatmul_decode(*head, k_splits, _build.stream_ptr(dev))
        name = "pq_qmatmul_decode"
    _build.check(err, name)
    return out


def qmatmul(xq: torch.Tensor, wq: torch.Tensor, s_x: torch.Tensor,
            s_w: torch.Tensor, bias: torch.Tensor | None = None,
            out_dtype=torch.float32) -> torch.Tensor:
    """y = (xq @ wq^T) * s_x * s_w + bias, cast to ``out_dtype``.

    xq int8 [..., K]; wq int8 [N, K]; s_x f32 [...]; s_w f32 [N]; bias f32
    [N] or None. The int32 sums are exact and the epilogue matches
    ``core.numerics.qmatmul_ref`` bit for bit. M = xq.numel() / K up to
    ``DECODE_MAX_M`` takes the decode kernel, larger M the tile kernel.
    """
    if xq.device.type == "cpu":
        return qmatmul_ref(xq, wq, s_x, s_w, bias, out_dtype)
    n, k = wq.shape
    m = xq.numel() // k if k else 0
    splits = qmatmul_decode_plan(m, n, k, _sm_count(xq.device))
    out = qmatmul_launch(xq, wq, s_x, s_w, bias, out_dtype, splits)
    qmatmul.launches += 1
    qmatmul.routes["tile" if splits is None else "decode"] += 1
    return out


qmatmul.launches = 0
# launches by kernel: "decode" (qmatmul_decode.cu), "tile" (qmatmul.cu)
qmatmul.routes = {"decode": 0, "tile": 0}


def dynamic_qlinear(x: torch.Tensor, wq: torch.Tensor, s_w: torch.Tensor,
                    bias: torch.Tensor | None = None, out_dtype=None) -> torch.Tensor:
    """rowquant(x) -> fused qmatmul: the full dynamic-activation linear."""
    xq, s_x = rowquant(x)
    return qmatmul(xq, wq, s_x, s_w, bias, out_dtype or x.dtype)
