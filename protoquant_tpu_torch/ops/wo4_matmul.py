"""Weight-only int4 matmul: activations times group-wise int4 weights.
Kernels and plain versions.

The kernels replace the two bodies of the Pallas kernel
``protoquant_tpu/ops/wo4_matmul.py``:

* ``split`` (``_wo4_split_kernel``, the default): x is rounded to bf16;
  for each K-group g, ``p = x_g . q_g`` (exact products bf16 x nibble,
  summed in f32), then ``acc = acc + p * s[n, g]`` over the groups in
  ascending order, each a separate f32 multiply and add; ``y = acc + b``.
* ``legacy`` (``_wo4_kernel``): ``w = q * s`` in f32, x in f32 (not
  rounded to bf16), one f32 dot, ``y = acc + b``.

The weight is the port's [N, K] layout packed along K: ``packed`` int8
[N, K/2] (``core.numerics.pack_int4``), ``scales`` f32 [N, K/group]. A CPU
tensor takes the plain version; a CUDA tensor launches the body's kernel or
raises. Each body counts its own launches (``wo4_split.launches``,
``wo4_legacy.launches``).

``split`` takes one of two kernels, chosen by the number of token rows M
before launch, as ``w4a8_matmul``'s two-level body does: M <=
``SPLIT_DECODE_MAX_M`` (every decode step of up to 16 slots) the split-K
decode kernel
(``csrc/wo4_decode.cu``: weight rows on the MMA's 16-row side, K split at
group boundaries over the blocks of a thread block cluster as
:func:`int4_decode_plan` says, the partials summed in split order in
shared memory), larger M the tile kernel (``csrc/wo4_tile.cu`` on
``csrc/int4_tile_sm90.cuh``: TMA and wgmma, 128 weight rows by 64 or 128
tokens a block, K split over a cluster as :func:`int4_tile_plan` says).
``legacy`` has one kernel (``csrc/wo4_matmul.cu``). ``wo4_split.routes``
counts each route.
:func:`wo4_split_splitk_ref` spells the decode kernel's split out,
:func:`wo4_split_tile_ref` the tile kernel's blocks.
"""

from __future__ import annotations

import torch

from ..core import numerics
from . import _build
from .gemm_plan import (DECODE_ROWS, TILE_SPLITS, decode_held, decode_plan, tile_blocks,
                        tile_plan)

FORMULATIONS = ("split", "legacy")
# Groups the CUDA kernels take (pick_int4_group gives 128 for every
# Llama-2-7B projection).
CUDA_GROUPS = (32, 64, 128, 256)
# The int4 decode kernels (csrc/int4_decode.cuh, the W4A8 two-level and the
# split bodies; the rest of their geometry in gemm_plan): the largest M each
# body routes to them, its crossover with the tile kernel in the sweep in
# PERF.md (tools/gemm_timing.py --int4 --sweep; 32 is also the kernels'
# limit); packed bytes of a weight row a step.
INT4_DECODE_MAX_M = 32
SPLIT_DECODE_MAX_M = 16
INT4_DECODE_STEP = 64
# The int4 tile kernels (csrc/int4_tile_sm90.cuh; their geometry in
# gemm_plan): the token tiles each body takes (split and W4A8 group hold two
# accumulators, so at most 128), the K splits each takes (group 1: its f32
# chain runs over the groups in order), the fewest units (of
# int4_decode_units) a split keeps, and the plan's cost model, fitted to the
# plan sweep in PERF.md: a block's K stage of 128 codes costs
# INT4_TILE_STAGE_US[body][tokens] microseconds, a block f0 + f1 x splits
# more, (f0, f1) = INT4_TILE_FIXED_US[body] (a block of a larger cluster
# stores a smaller share of its tile).
INT4_TILE_TOKENS = {"split": (64, 128), "two_level": (64, 128, 256), "group": (64, 128)}
INT4_TILE_SPLITS = {"split": TILE_SPLITS, "two_level": TILE_SPLITS, "group": (1,)}
INT4_TILE_MIN_UNITS = 4
INT4_TILE_STAGE_US = {"split": {64: 0.679, 128: 1.228},
                      "two_level": {64: 0.534, 128: 0.803, 256: 1.386},
                      "group": {64: 0.661, 128: 0.888}}
INT4_TILE_FIXED_US = {"split": (5.936, -0.076), "two_level": (6.367, -0.102),
                      "group": (5.306, 0.0)}


def int4_decode_units(k: int, group: int) -> tuple:
    """(units, codes a unit) of K for the int4 decode kernels: a unit is
    max(64, group / 2) packed bytes, whole steps and whole groups; the last
    may be cut at K."""
    unit = 2 * max(INT4_DECODE_STEP, group // 2)
    return -(-k // unit), unit


def int4_decode_plan(m: int, n: int, k: int, group: int, held: dict,
                     max_m: int = INT4_DECODE_MAX_M):
    """The int4 decode kernels' K splits (1 to 8: the blocks of a cluster)
    for an [m, k] x [n, k]^T product of group ``group``, or None where the
    tile kernel takes it (m > ``max_m``, the body's threshold):
    ``gemm_plan.decode_plan`` over the units of :func:`int4_decode_units`
    (``held``: :func:`int4_decode_held`)."""
    if m > max_m:
        return None
    return decode_plan(n, int4_decode_units(k, group)[0], held)


def int4_decode_held(entry: str, dev, m: int, group: int) -> dict:
    """{splits: clusters of that many blocks the card holds at once} of the
    decode kernel instance that ``entry`` (``"pq_wo4_split_decode"`` or
    ``"pq_w4a8_two_level_decode"``) launches for ``m`` rows of group
    ``group`` (``gemm_plan.decode_held``)."""
    return decode_held(entry, dev, m, group)


def decodes(x: torch.Tensor, m: int, group: int, max_m: int = INT4_DECODE_MAX_M) -> bool:
    """Whether a call of ``m`` token rows on ``x``'s device takes a decode
    kernel (up to the body's threshold ``max_m``); a group the kernels lack
    takes the tile route, whose checks raise."""
    return x.is_cuda and m <= max_m and group in CUDA_GROUPS


def int4_k_slices(k: int, group: int, k_splits: int) -> list:
    """The K ranges [k0, k1) of the decode kernels' splits, as their blocks
    take them: split r holds the units [r units / k_splits, (r + 1) units /
    k_splits) (:func:`int4_decode_units`), whole groups, the last cut at
    k."""
    units, unit = int4_decode_units(k, group)
    ends = [min(k, unit * (r * units // k_splits)) for r in range(k_splits + 1)]
    return list(zip(ends[:-1], ends[1:]))


def int4_tile_plan(m: int, n: int, k: int, group: int, sms: int, formulation: str = "split"):
    """The tile kernel's (tokens a tile, K splits) for an [m, k] x [n, k]^T
    product of group ``group`` on a card of ``sms`` SMs: of the token tiles
    of ``formulation``'s body (``"split"``, ``"two_level"`` or the W4A8
    ``"group"``) and the splits of K it takes over the blocks of a cluster
    (``INT4_TILE_SPLITS``) that leave each split at least
    ``INT4_TILE_MIN_UNITS`` units, the plan of least cost,
    ``gemm_plan.tile_plan`` with the body's ``INT4_TILE_STAGE_US`` and
    ``INT4_TILE_FIXED_US``."""
    units, _ = int4_decode_units(k, group)
    return tile_plan(m, n, -(-k // (2 * INT4_DECODE_STEP)), units, sms,
                     INT4_TILE_STAGE_US[formulation], INT4_TILE_FIXED_US[formulation],
                     INT4_TILE_MIN_UNITS, splits_taken=INT4_TILE_SPLITS[formulation])


def int4_tile_blocks(m: int, n: int, k: int, group: int, plan) -> list:
    """The (tokens, weight rows, K range) of each block of a tile launch of
    ``plan`` = (tokens a tile, K splits) (``gemm_plan.tile_blocks``), each
    split over K as :func:`int4_k_slices` says."""
    tokens, splits = plan
    return tile_blocks(m, n, tokens, int4_k_slices(k, group, splits))


def int4_decode_blocks(n: int, k: int, group: int, k_splits: int) -> list:
    """The (weight rows, K range) of each block of a decode launch, in grid
    order: 64-row tiles of [0, n), each split over k_splits K slices."""
    return [((r0, min(n, r0 + DECODE_ROWS)), ks)
            for r0 in range(0, n, DECODE_ROWS) for ks in int4_k_slices(k, group, k_splits)]


def check_int4_weight(name: str, k: int, packed: torch.Tensor, scales: torch.Tensor,
                      group: int, bias: torch.Tensor | None):
    """Validate an int4 weight for the CUDA kernels; return (N, bias f32)."""
    n = packed.shape[0]
    if k % group:
        raise ValueError(f"{name}: K={k} not divisible by group={group}")
    if group not in CUDA_GROUPS:
        raise ValueError(f"{name}: group={group} must be one of {CUDA_GROUPS} on CUDA "
                         "(the kernels are built for each)")
    if packed.shape != (n, k // 2) or scales.shape != (n, k // group):
        raise ValueError(f"{name}: shapes packed {tuple(packed.shape)}, scales "
                         f"{tuple(scales.shape)} for K={k}, group={group}")
    if packed.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"{name}: packed must be int8 and scales float32")
    if bias is not None:
        if bias.shape != (n,):
            raise ValueError(f"{name}: bias shape {tuple(bias.shape)}")
        bias = bias.float().contiguous()
    return n, bias


def weight_only_int4_tolerance(x, packed, scales, group, y, formulation="split",
                               w_rel: float = 0.0):
    """How far two correct versions of the product may differ at each
    output ``y``. Every version sums the same products (x rounded to bf16
    for ``split``, f32 for ``legacy``) in its own order; each lies within
    ``K * 2**-24 * sum_k |x * q * s|`` of the exact sum (first order: the
    f32 additions, and for ``legacy`` the rounding of each product), so two
    differ by at most twice that. ``w_rel``: add ``w_rel * sum_k |x * q * s|``
    for a version that rounds each weight ``q * s`` by a relative ``w_rel``
    (2**-8 for a bf16 copy of the weight). Then the cast to ``y.dtype`` may
    round the two sums one ulp apart."""
    k = x.shape[-1]
    xs = x.reshape(-1, k)
    xs = xs.to(torch.bfloat16).float() if formulation == "split" else xs.float()
    mag = xs.abs() @ numerics.dequantize_int4(packed, scales, group).abs().t()
    bound = ((2 * k * 2.0**-24 + w_rel) * mag).reshape(y.shape)
    _, exp = torch.frexp(y.float().abs() + bound)
    ulp = torch.finfo(y.dtype).eps * torch.pow(2.0, (exp - 1).float())
    return bound + ulp


def weight_only_int4_matmul_ref(x, packed, scales, group=128, bias=None, out_dtype=None,
                                formulation="split"):
    """Plain version (same contract as :func:`weight_only_int4_matmul`),
    in the TPU kernel's order of operations across groups."""
    if formulation not in FORMULATIONS:
        raise ValueError(f"unknown wo4 formulation {formulation!r}")
    out_dtype = out_dtype or x.dtype
    k = x.shape[-1]
    n = packed.shape[0]
    xs = x.reshape(-1, k)
    if formulation == "legacy":
        y = xs.float() @ numerics.dequantize_int4(packed, scales, group).t()
    else:
        m, ng = xs.shape[0], k // group
        q = numerics.unpack_int4(packed, group).float()
        p = torch.einsum("gmk,gkn->gmn",
                         xs.to(torch.bfloat16).float().reshape(m, ng, group).transpose(0, 1),
                         q.reshape(n, ng, group).permute(1, 2, 0))  # [G, M, N]
        y = torch.zeros(m, n, dtype=torch.float32, device=x.device)
        for gi in range(ng):
            y = y + p[gi] * scales[:, gi]
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype).reshape(*x.shape[:-1], n)


def wo4_split_splitk_ref(x, packed, scales, group=128, bias=None, out_dtype=None,
                         k_splits=1):
    """The decode kernel's split in plain PyTorch: x rounded to bf16; each
    K slice (:func:`int4_k_slices`) sums its groups' ``p * s`` in f32 in
    ascending order from 0, the slices' sums are added in split order, then
    the bias; cast to ``out_dtype`` (default x.dtype). Within
    :func:`weight_only_int4_tolerance` of the plain version at any
    ``k_splits``."""
    out_dtype = out_dtype or x.dtype
    k = x.shape[-1]
    n = packed.shape[0]
    xs = x.reshape(-1, k).to(torch.bfloat16).float()
    q = numerics.unpack_int4(packed, group).float()
    y = torch.zeros(xs.shape[0], n, dtype=torch.float32, device=x.device)
    for k0, k1 in int4_k_slices(k, group, k_splits):
        part = torch.zeros_like(y)
        for g0 in range(k0, k1, group):
            p = xs[:, g0:g0 + group] @ q[:, g0:g0 + group].t()
            part = part + p * scales[:, g0 // group]
        y = y + part
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype).reshape(*x.shape[:-1], n)


def wo4_split_tile_ref(x, packed, scales, group=128, bias=None, out_dtype=None,
                       plan=(128, 1)):
    """The tile kernel's blocks in plain PyTorch: x rounded to bf16; each
    block of :func:`int4_tile_blocks` sums its groups' ``p * s`` in f32 in
    ascending order from 0 over its K slice; a tile's slices are added in
    split order, then the bias; cast to ``out_dtype`` (default x.dtype).
    Within :func:`weight_only_int4_tolerance` of the plain version."""
    out_dtype = out_dtype or x.dtype
    k = x.shape[-1]
    n = packed.shape[0]
    xs = x.reshape(-1, k).to(torch.bfloat16).float()
    q = numerics.unpack_int4(packed, group).float()
    y = torch.zeros(xs.shape[0], n, dtype=torch.float32, device=x.device)
    for (m0, m1), (n0, n1), (k0, k1) in int4_tile_blocks(xs.shape[0], n, k, group, plan):
        part = torch.zeros(m1 - m0, n1 - n0, dtype=torch.float32, device=x.device)
        for g0 in range(k0, k1, group):
            p = xs[m0:m1, g0:g0 + group] @ q[n0:n1, g0:g0 + group].t()
            part = part + p * scales[n0:n1, g0 // group]
        y[m0:m1, n0:n1] = part if k0 == 0 else y[m0:m1, n0:n1] + part
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype).reshape(*x.shape[:-1], n)


def tile_args(tile, formulation: str, group: int):
    """The tile entries' last arguments, (tokens a tile, K splits), as a
    ``tail`` of the launchers: ``tile``, or :func:`int4_tile_plan`'s for the
    card's SMs."""
    from .qmatmul import _sm_count

    return lambda m, n, k, dev: list(tile or int4_tile_plan(m, n, k, group, _sm_count(dev),
                                                            formulation))


def _launch(fn_name: str, x, packed, scales, group, bias, out_dtype, tail=None):
    """Check the operands and launch ``fn_name``; ``tail(m, n, k, dev)``
    gives the arguments after ``group`` (a decode kernel's K splits, a tile
    kernel's plan)."""
    out_dtype = out_dtype or x.dtype
    k = x.shape[-1]
    n, bias = check_int4_weight(fn_name, k, packed, scales, group, bias)
    if out_dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{fn_name}: unsupported out_dtype {out_dtype}")
    x = x.contiguous()
    tensors = [x, packed, scales] + ([bias] if bias is not None else [])
    dev = _build.same_device_contiguous(fn_name, *tensors)
    if dev.type != "cuda":
        raise ValueError(f"{fn_name}: launches on CUDA tensors only, got {dev}")
    if x.data_ptr() % 16 or packed.data_ptr() % 16:
        raise ValueError(f"{fn_name}: x and packed must be 16-byte aligned")
    m = x.numel() // k
    out = torch.empty(*x.shape[:-1], n, dtype=out_dtype, device=dev)
    args = [x.data_ptr(), packed.data_ptr(), scales.data_ptr(),
            bias.data_ptr() if bias is not None else None, out.data_ptr(),
            _build.DTYPE_CODES[out_dtype], m, n, k, group]
    if tail is not None:
        args += tail(m, n, k, dev)
    err = getattr(_build.lib(), fn_name)(*args, _build.stream_ptr(dev))
    _build.check(err, fn_name)
    return out


def wo4_split_launch(x, packed, scales, group, bias=None, out_dtype=None, k_splits=None,
                     tile=None):
    """Launch one split kernel on CUDA operands: the decode kernel with
    ``k_splits`` (1 to 8) K splits, or for None the tile kernel with
    ``tile`` = (tokens a tile, K splits) (None: :func:`int4_tile_plan`'s).
    Returns the output; counts nothing (:func:`wo4_split` routes and
    counts)."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"wo4 split: x must be bfloat16, got {x.dtype}")
    if k_splits is not None:
        return _launch("pq_wo4_split_decode", x, packed, scales, group, bias, out_dtype,
                       lambda *_: [k_splits])
    return _launch("pq_wo4_split", x, packed, scales, group, bias, out_dtype,
                   tile_args(tile, "split", group))


def wo4_split(x, packed, scales, group, bias=None, out_dtype=None):
    """Launch the split body on CUDA tensors; x must be bfloat16. M up to
    ``SPLIT_DECODE_MAX_M`` takes the decode kernel, larger M the tile
    kernel."""
    k = x.shape[-1]
    m = x.numel() // k if k else 0
    splits = (int4_decode_plan(m, packed.shape[0], k, group,
                               int4_decode_held("pq_wo4_split_decode", x.device, m, group),
                               SPLIT_DECODE_MAX_M)
              if decodes(x, m, group, SPLIT_DECODE_MAX_M) else None)
    out = wo4_split_launch(x, packed, scales, group, bias, out_dtype, splits)
    wo4_split.launches += 1
    wo4_split.routes["tile" if splits is None else "decode"] += 1
    return out


def wo4_legacy(x, packed, scales, group, bias=None, out_dtype=None):
    """Launch the legacy body on CUDA tensors; x of any float type is
    widened to f32 (exactly) first."""
    if not x.is_floating_point():
        raise TypeError(f"wo4 legacy: x must be floating point, got {x.dtype}")
    out = _launch("pq_wo4_legacy", x.float(), packed, scales, group, bias,
                  out_dtype or x.dtype)
    wo4_legacy.launches += 1
    return out


wo4_split.launches = 0
# launches by kernel: "decode" (wo4_decode.cu), "tile" (wo4_tile.cu)
wo4_split.routes = {"decode": 0, "tile": 0}
wo4_legacy.launches = 0


def weight_only_int4_matmul(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                            group: int = 128, bias: torch.Tensor | None = None,
                            out_dtype=None, formulation: str = "split") -> torch.Tensor:
    """y = x @ dequant_int4(packed, scales)^T + bias, cast to ``out_dtype``
    (default x.dtype).

    x [..., K] (bf16 on CUDA for ``split``); packed int8 [N, K/2]; scales f32
    [N, K/group]; bias f32 [N] or None. On CUDA, group is one of
    ``CUDA_GROUPS``.
    """
    if formulation not in FORMULATIONS:
        raise ValueError(f"unknown wo4 formulation {formulation!r}")
    if x.device.type == "cpu":
        return weight_only_int4_matmul_ref(x, packed, scales, group, bias, out_dtype,
                                           formulation)
    launch = wo4_split if formulation == "split" else wo4_legacy
    return launch(x, packed, scales, group, bias, out_dtype)
