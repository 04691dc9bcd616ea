"""Kernels of the main path, each beside its plain PyTorch version.

Every wrapper dispatches by the device of its tensors: a CPU tensor takes
the plain version, a CUDA tensor launches the hand-written kernel from
``csrc/`` (built on first use by ``_build``) or raises. There is no
fallback and no switch beyond the formulation arguments and knobs the JAX
package itself has. Each kernel body counts its launches in ``.launches``;
a wrapper that routes between two kernels by shape before launch (qmatmul,
weight_only_matmul, wo4_split, w4a8_two_level and w4a8_group: the decode or
the tile kernel, by M;
paged_int8_attention: the split or the
walk, by the split plan; int8_kv_attention, mixed_kv_attention and the
two KIVI attentions: the split decode or the prefill kernel, by the split
plan; the two KIVI updates: one kernel on route decode or prefill, by the
new rows a slot; rowquant and swiglu_quant: one kernel on route cluster or
rows, by the row plan) counts every call in
``.launches`` and each kernel's in ``.routes`` (:data:`ROUTED`,
:func:`route_counts`).
"""

import os as _os

from .attention import (int4_kv_attention, int4_kv_attention_ref, int8_kv_attention,
                        int8_kv_attention_ref, k4v8_attention, k4v8_attention_ref,
                        mixed_kv_attention, mixed_kv_attention_ref)
from .collective_matmul import (qmatmul_reduce_scatter_dma, qmatmul_reduce_scatter_dma_all,
                                qmatmul_reduce_scatter_dma_all_ref, qmatmul_reduce_scatter_dma_ref,
                                qmatmul_reduce_scatter_dma_splitk_ref)
from .dequant import dequant, dequant_ref
from .fused_quant import (rms_norm_quant, rms_norm_quant_ref, swiglu_quant,
                          swiglu_quant_parts_ref, swiglu_quant_ref)
from .kv_scatter import (k4v8_decode_update, k4v8_decode_update_ref, kivi4_decode_update,
                         kivi4_decode_update_ref, kivi_prefill_update_ref,
                         kv_mixed_scatter_decode,
                         kv_mixed_scatter_decode_ref, kv_scatter_decode, kv_scatter_decode_ref,
                         paged_kv_scatter_decode, paged_kv_scatter_decode_ref)
from .paged_attention import paged_int8_attention, paged_int8_attention_ref
from .qmatmul import dynamic_qlinear, qmatmul, qmatmul_ref, qmatmul_splitk_ref
from .rowquant import rowquant, rowquant_parts_ref, rowquant_ref
from .w4a8_matmul import (two_level_scales, w4a8_group, w4a8_group_splitk_ref,
                          w4a8_group_tile_ref, w4a8_matmul, w4a8_matmul_ref, w4a8_two_level,
                          w4a8_two_level_splitk_ref, w4a8_two_level_tile_ref)
from .wo4_matmul import (weight_only_int4_matmul, weight_only_int4_matmul_ref,
                         weight_only_int4_tolerance, wo4_legacy, wo4_split,
                         wo4_split_splitk_ref, wo4_split_tile_ref)
from .wo_matmul import (weight_only_matmul, weight_only_matmul_ref, weight_only_splitk_ref,
                        weight_only_tile_ref, weight_only_tolerance)

# The kernel bodies whose launches a run can read and reset (an op with two
# formulations has one entry per body).
KERNELS = {
    "rowquant": rowquant,
    "qmatmul": qmatmul,
    "kv_scatter_decode": kv_scatter_decode,
    "int8_kv_attention": int8_kv_attention,
    "weight_only_matmul": weight_only_matmul,
    "paged_kv_scatter_decode": paged_kv_scatter_decode,
    "paged_int8_attention": paged_int8_attention,
    "wo4_split": wo4_split,
    "wo4_legacy": wo4_legacy,
    "w4a8_two_level": w4a8_two_level,
    "w4a8_group": w4a8_group,
    "rms_norm_quant": rms_norm_quant,
    "swiglu_quant": swiglu_quant,
    "dequant": dequant,
    "k4v8_decode_update": k4v8_decode_update,
    "k4v8_attention": k4v8_attention,
    "kivi4_decode_update": kivi4_decode_update,
    "int4_kv_attention": int4_kv_attention,
    "kv_mixed_scatter_decode": kv_mixed_scatter_decode,
    "mixed_kv_attention": mixed_kv_attention,
    "qmatmul_reduce_scatter_dma": qmatmul_reduce_scatter_dma,
}

# W4A8 (dynamic_int4) formulation, as the JAX package resolves it
# (protoquant_tpu/ops/__init__.py): "two_level" (default) or "group", from
# the W4A8_FORMULATION environment variable at import.
W4A8_FORMULATION = _os.environ.get("W4A8_FORMULATION", "two_level")


def resolve_w4a8_formulation() -> str:
    return W4A8_FORMULATION


# Producer-fused quantization (ops/fused_quant.py), as the JAX package
# resolves it (protoquant_tpu/ops/__init__.py): with "on", a mode="dynamic"
# decoder makes its int8 activations straight from both RMSNorms of each
# layer and from the SwiGLU gate. "auto", the default, resolves off, as in
# the JAX package; which default suits the H100 is an open question
# (PERF.md). Read at call time, so the module knob flips it too.
FUSED_QUANT = _os.environ.get("FUSED_QUANT", "auto")


def resolve_fused_quant() -> bool:
    return FUSED_QUANT == "on"


def shared_rowquant(x):
    """Per-token quantization shared by sibling projections (q/k/v,
    gate/up): x[..., K] -> (int8, f32 scales), through the kernel on CUDA."""
    return rowquant(x)


# The kernels of a wrapper that routes by shape: name -> (wrapper, route).
# The wrapper's count in KERNELS is the sum of its routes'.
ROUTED = {
    "rowquant_cluster": (rowquant, "cluster"),
    "rowquant_rows": (rowquant, "rows"),
    "swiglu_quant_cluster": (swiglu_quant, "cluster"),
    "swiglu_quant_rows": (swiglu_quant, "rows"),
    "qmatmul_decode": (qmatmul, "decode"),
    "qmatmul_tile": (qmatmul, "tile"),
    "weight_only_matmul_decode": (weight_only_matmul, "decode"),
    "weight_only_matmul_tile": (weight_only_matmul, "tile"),
    "wo4_split_decode": (wo4_split, "decode"),
    "wo4_split_tile": (wo4_split, "tile"),
    "w4a8_two_level_decode": (w4a8_two_level, "decode"),
    "w4a8_two_level_tile": (w4a8_two_level, "tile"),
    "w4a8_group_decode": (w4a8_group, "decode"),
    "w4a8_group_tile": (w4a8_group, "tile"),
    "paged_int8_attention_split": (paged_int8_attention, "split"),
    "paged_int8_attention_walk": (paged_int8_attention, "walk"),
    "int8_kv_attention_split": (int8_kv_attention, "split"),
    "int8_kv_attention_prefill": (int8_kv_attention, "prefill"),
    "mixed_kv_attention_split": (mixed_kv_attention, "split"),
    "mixed_kv_attention_prefill": (mixed_kv_attention, "prefill"),
    "k4v8_attention_split": (k4v8_attention, "split"),
    "k4v8_attention_prefill": (k4v8_attention, "prefill"),
    "int4_kv_attention_split": (int4_kv_attention, "split"),
    "int4_kv_attention_prefill": (int4_kv_attention, "prefill"),
    "k4v8_decode_update_decode": (k4v8_decode_update, "decode"),
    "k4v8_decode_update_prefill": (k4v8_decode_update, "prefill"),
    "kivi4_decode_update_decode": (kivi4_decode_update, "decode"),
    "kivi4_decode_update_prefill": (kivi4_decode_update, "prefill"),
    "qmatmul_reduce_scatter_dma_decode": (qmatmul_reduce_scatter_dma, "decode"),
    "qmatmul_reduce_scatter_dma_prefill": (qmatmul_reduce_scatter_dma, "prefill"),
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def route_counts() -> dict:
    return {name: fn.routes[route] for name, (fn, route) in ROUTED.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    for fn, route in ROUTED.values():
        fn.routes[route] = 0


__all__ = [
    "FUSED_QUANT", "KERNELS", "ROUTED", "W4A8_FORMULATION", "dequant", "dequant_ref",
    "dynamic_qlinear", "int4_kv_attention", "int4_kv_attention_ref", "int8_kv_attention",
    "int8_kv_attention_ref", "k4v8_attention", "k4v8_attention_ref", "k4v8_decode_update",
    "k4v8_decode_update_ref", "kivi4_decode_update", "kivi4_decode_update_ref",
    "kivi_prefill_update_ref",
    "kv_mixed_scatter_decode", "kv_mixed_scatter_decode_ref", "kv_scatter_decode",
    "kv_scatter_decode_ref", "launch_counts", "mixed_kv_attention", "mixed_kv_attention_ref",
    "paged_int8_attention",
    "paged_int8_attention_ref", "paged_kv_scatter_decode", "paged_kv_scatter_decode_ref",
    "qmatmul", "qmatmul_reduce_scatter_dma", "qmatmul_reduce_scatter_dma_all",
    "qmatmul_reduce_scatter_dma_all_ref", "qmatmul_reduce_scatter_dma_ref",
    "qmatmul_reduce_scatter_dma_splitk_ref", "qmatmul_ref",
    "qmatmul_splitk_ref", "reset_launch_counts", "route_counts", "resolve_fused_quant",
    "resolve_w4a8_formulation", "rms_norm_quant", "rms_norm_quant_ref", "rowquant",
    "rowquant_parts_ref", "rowquant_ref", "shared_rowquant", "swiglu_quant",
    "swiglu_quant_parts_ref", "swiglu_quant_ref",
    "two_level_scales", "w4a8_group", "w4a8_group_splitk_ref", "w4a8_group_tile_ref",
    "w4a8_matmul", "w4a8_matmul_ref", "w4a8_two_level",
    "w4a8_two_level_splitk_ref", "w4a8_two_level_tile_ref",
    "weight_only_int4_matmul", "weight_only_int4_matmul_ref", "weight_only_int4_tolerance",
    "weight_only_matmul", "weight_only_matmul_ref", "weight_only_splitk_ref",
    "weight_only_tile_ref", "weight_only_tolerance", "wo4_legacy",
    "wo4_split", "wo4_split_splitk_ref", "wo4_split_tile_ref",
]
