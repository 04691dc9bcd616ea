"""Weight-only int8 matmul: bf16 activations times int8 weights, with the
per-output-channel scale in the f32 epilogue. Kernels and plain versions.

Two kernels replace the Pallas kernel
``protoquant_tpu/ops/wo_matmul.py:_wo_kernel``, chosen by the number of
token rows M before launch: M <= ``WO_DECODE_MAX_M`` (every decode step)
takes the split-K decode kernel (``csrc/wo_decode.cu``: weight rows on the
MMA's 16-row side, the int8 weight loaded straight into registers and
converted to bf16 there, K split over the blocks of a thread block cluster as
:func:`wo_decode_plan` says, the partials summed in split order in shared
memory), larger M (prefill chunks) the tile kernel (``csrc/wo_tile.cu`` on
``csrc/int4_tile_sm90.cuh``: TMA and wgmma, 128 weight rows as wgmma's
register A operand by 64, 128 or 256 tokens a block, K split over a cluster
as :func:`wo_tile_plan` says). Both compute what the JAX model computes on
every backend (``weight_only_matmul_xla``): x is rounded to bf16, each
product bf16 x int8 is exact in f32 and summed in f32, then ``y = acc * s_w
+ b`` (f32, a separate multiply and add), cast to ``out_dtype``. The int8
weight is [N, K] (the ``nn.Linear`` layout). The kernels take bf16 x only;
a CPU tensor takes the plain version, a CUDA tensor launches a kernel or
raises. ``weight_only_matmul.routes`` counts each kernel.
:func:`weight_only_splitk_ref` spells the decode kernel's sum order out,
:func:`weight_only_tile_ref` the tile kernel's.
"""

from __future__ import annotations

import torch

from . import _build
from .gemm_plan import decode_held, decode_plan, tile_blocks, tile_plan
from .qmatmul import _sm_count, k_slices

# The largest M the decode kernel takes (its crossover with the tile kernel
# in the sweep in PERF.md, tools/gemm_timing.py --wo --sweep; the kernel
# takes up to 32 rows) and codes of a weight row a step (csrc/wo_decode.cu;
# the rest of its geometry in gemm_plan).
WO_DECODE_MAX_M = 16
WO_DECODE_STEP = 64
# The tile kernel (csrc/int4_tile_sm90.cuh, body WO8): codes of a weight row
# a stage (the unit a K split takes), the fewest stages a split keeps, and
# its plan's cost model (gemm_plan.tile_plan), fitted to the plan sweep in
# PERF.md: a block's stage costs WO_TILE_STAGE_US[tokens] microseconds with
# every SM busy, WO_TILE_SHARE of it however few a wave fills (a wave on
# fewer SMs runs each faster), a block f0 + f1 x splits more, (f0, f1) =
# WO_TILE_FIXED_US.
WO_TILE_STEP = 64
WO_TILE_MIN_STAGES = 4
WO_TILE_STAGE_US = {64: 0.398, 128: 0.585, 256: 0.934}
WO_TILE_SHARE = 0.8
WO_TILE_FIXED_US = (6.890, -0.120)


def weight_only_tolerance(x, wq, s_w, y):
    """How far two correct versions of the product may differ at each
    output ``y``: the products are exact, so only the order of the f32 sum
    differs, by at most ``K * 2**-24 * sum_k |x * w| * s_w``; then the cast
    to ``y.dtype`` may round the two sums one ulp apart."""
    k = x.shape[-1]
    mag = (x.reshape(-1, k).to(torch.bfloat16).float().abs()
           @ wq.float().abs().t()) * s_w.float()[None, :]
    sum_bound = (k * 2.0**-24) * mag.reshape(y.shape)
    _, exp = torch.frexp(y.float().abs() + sum_bound)
    ulp = torch.finfo(y.dtype).eps * torch.pow(2.0, (exp - 1).float())
    return sum_bound + ulp


def _epilogue(acc, x, wq, s_w, bias, out_dtype):
    """``acc * s_w + bias`` in f32 (a separate multiply and add), cast to
    ``out_dtype`` (default x.dtype) in x's leading shape."""
    y = acc * s_w.float()[None, :]
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype or x.dtype).reshape(*x.shape[:-1], wq.shape[0])


def weight_only_matmul_ref(x, wq, s_w, bias=None, out_dtype=None):
    """Plain version (same contract as :func:`weight_only_matmul`)."""
    k = x.shape[-1]
    acc = x.reshape(-1, k).to(torch.bfloat16).float() @ wq.float().t()
    return _epilogue(acc, x, wq, s_w, bias, out_dtype)


def weight_only_splitk_ref(x, wq, s_w, bias=None, out_dtype=None, k_splits=1):
    """The decode kernel's sum order in plain PyTorch: x rounded to bf16;
    each K slice (``qmatmul.k_slices`` of 64-code steps) sums its products
    in f32, the slices' sums are added in split order, then ``acc * s_w +
    b``; cast to ``out_dtype`` (default x.dtype). Within
    :func:`weight_only_tolerance` of the plain version at any
    ``k_splits``."""
    k = x.shape[-1]
    xs = x.reshape(-1, k).to(torch.bfloat16).float()
    w = wq.float()
    acc = torch.zeros(xs.shape[0], wq.shape[0], dtype=torch.float32, device=x.device)
    for k0, k1 in k_slices(k, k_splits, WO_DECODE_STEP):
        acc = acc + xs[:, k0:k1] @ w[:, k0:k1].t()
    return _epilogue(acc, x, wq, s_w, bias, out_dtype)


def wo_tile_blocks(m: int, n: int, k: int, plan) -> list:
    """The (tokens, weight rows, K range) of each block of a tile launch of
    ``plan`` = (tokens a tile, K splits) (``gemm_plan.tile_blocks``), each
    split over K in whole stages (``qmatmul.k_slices`` of ``WO_TILE_STEP``
    codes)."""
    tokens, splits = plan
    return tile_blocks(m, n, tokens, k_slices(k, splits, WO_TILE_STEP))


def weight_only_tile_ref(x, wq, s_w, bias=None, out_dtype=None, plan=(128, 1)):
    """The tile kernel's sum order in plain PyTorch: x rounded to bf16; each
    block of :func:`wo_tile_blocks` sums its products over its K slice in
    f32, a tile's slices are added in split order, then ``acc * s_w + b``;
    cast to ``out_dtype`` (default x.dtype). Within
    :func:`weight_only_tolerance` of the plain version."""
    k = x.shape[-1]
    xs = x.reshape(-1, k).to(torch.bfloat16).float()
    w = wq.float()
    acc = torch.zeros(xs.shape[0], wq.shape[0], dtype=torch.float32, device=x.device)
    for (m0, m1), (n0, n1), (k0, k1) in wo_tile_blocks(xs.shape[0], wq.shape[0], k, plan):
        part = xs[m0:m1, k0:k1] @ w[n0:n1, k0:k1].t()
        acc[m0:m1, n0:n1] = part if k0 == 0 else acc[m0:m1, n0:n1] + part
    return _epilogue(acc, x, wq, s_w, bias, out_dtype)


def wo_decode_plan(m: int, n: int, k: int, held: dict):
    """The decode kernel's K splits (1 to 8: the blocks of a cluster) for an
    [m, k] x [n, k]^T product, or None where the tile kernel takes it (m >
    ``WO_DECODE_MAX_M``): ``gemm_plan.decode_plan`` over steps of
    ``WO_DECODE_STEP`` codes (``held``: :func:`wo_decode_held`)."""
    if m > WO_DECODE_MAX_M:
        return None
    return decode_plan(n, -(-k // WO_DECODE_STEP), held)


def wo_decode_held(dev, m: int) -> dict:
    """{splits: clusters of that many blocks the card holds at once} of the
    decode kernel instance for ``m`` rows (``gemm_plan.decode_held``)."""
    return decode_held("pq_weight_only_decode", dev, m)


def wo_tile_plan(m: int, n: int, k: int, sms: int):
    """The tile kernel's (tokens a tile, K splits) for an [m, k] x [n, k]^T
    product on a card of ``sms`` SMs: ``gemm_plan.tile_plan`` over stages
    of ``WO_TILE_STEP`` codes with this body's cost model."""
    stages = -(-k // WO_TILE_STEP)
    return tile_plan(m, n, stages, stages, sms, WO_TILE_STAGE_US, WO_TILE_FIXED_US,
                     WO_TILE_MIN_STAGES, WO_TILE_SHARE)


def weight_only_launch(x, wq, s_w, bias=None, out_dtype=None, k_splits=None, tile=None):
    """Launch one kernel on CUDA operands: the decode kernel with
    ``k_splits`` (1 to 8) K splits, or for None the tile kernel with
    ``tile`` = (tokens a tile, K splits) (None: :func:`wo_tile_plan`'s).
    Returns the output; counts nothing (:func:`weight_only_matmul` routes
    and counts)."""
    out_dtype = out_dtype or x.dtype
    n, k = wq.shape
    if x.shape[-1] != k or s_w.shape != (n,):
        raise ValueError(f"weight_only_matmul: shapes x {tuple(x.shape)}, wq "
                         f"{tuple(wq.shape)}, s_w {tuple(s_w.shape)}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"weight_only_matmul: x must be bfloat16, got {x.dtype}")
    if wq.dtype != torch.int8 or s_w.dtype != torch.float32:
        raise TypeError("weight_only_matmul: wq must be int8 and s_w float32")
    if out_dtype not in _build.DTYPE_CODES:
        raise TypeError(f"weight_only_matmul: unsupported out_dtype {out_dtype}")
    if k % 16:
        raise ValueError(f"weight_only_matmul: K={k} must be a multiple of 16")
    if bias is not None:
        if bias.shape != (n,):
            raise ValueError(f"weight_only_matmul: bias shape {tuple(bias.shape)}")
        bias = bias.float().contiguous()
    x = x.contiguous()
    tensors = [x, wq, s_w] + ([bias] if bias is not None else [])
    dev = _build.same_device_contiguous("weight_only_matmul", *tensors)
    if dev.type != "cuda":
        raise ValueError(f"weight_only_matmul: launches on CUDA tensors only, got {dev}")
    if x.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError("weight_only_matmul: x and wq must be 16-byte aligned")
    m = x.numel() // k
    out = torch.empty(*x.shape[:-1], n, dtype=out_dtype, device=dev)
    head = (x.data_ptr(), wq.data_ptr(), s_w.data_ptr(),
            bias.data_ptr() if bias is not None else None, out.data_ptr(),
            _build.DTYPE_CODES[out_dtype], m, n, k)
    if k_splits is None:
        name, tail = "pq_weight_only_tile", list(tile or wo_tile_plan(m, n, k, _sm_count(dev)))
    else:
        name, tail = "pq_weight_only_decode", [k_splits]
    _build.check(getattr(_build.lib(), name)(*head, *tail, _build.stream_ptr(dev)), name)
    return out


def weight_only_matmul(x: torch.Tensor, wq: torch.Tensor, s_w: torch.Tensor,
                       bias: torch.Tensor | None = None, out_dtype=None) -> torch.Tensor:
    """y = (bf16(x) @ wq^T) * s_w + bias with an f32 sum, cast to
    ``out_dtype`` (default x.dtype).

    x [..., K] (bf16 on CUDA); wq int8 [N, K]; s_w f32 [N]; bias f32 [N] or
    None. K must be a multiple of 16 on CUDA. M = x.numel() / K up to
    ``WO_DECODE_MAX_M`` takes the decode kernel, larger M the tile kernel.
    """
    if x.device.type == "cpu":
        return weight_only_matmul_ref(x, wq, s_w, bias, out_dtype)
    k = x.shape[-1]
    m = x.numel() // k if k else 0
    splits = (wo_decode_plan(m, wq.shape[0], k, wo_decode_held(x.device, m))
              if m <= WO_DECODE_MAX_M else None)
    out = weight_only_launch(x, wq, s_w, bias, out_dtype, splits)
    weight_only_matmul.launches += 1
    weight_only_matmul.routes["tile" if splits is None else "decode"] += 1
    return out


weight_only_matmul.launches = 0
# launches by kernel: "decode" (wo_decode.cu), "tile" (wo_tile.cu)
weight_only_matmul.routes = {"decode": 0, "tile": 0}
