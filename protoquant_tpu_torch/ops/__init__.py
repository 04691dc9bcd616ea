"""Kernels of the main path, each beside its plain PyTorch version.

Every wrapper dispatches by the device of its tensors: a CPU tensor takes
the plain version, a CUDA tensor launches the hand-written kernel from
``csrc/`` (built on first use by ``_build``) or raises. There is no
fallback and no switch. Each wrapper counts its launches in ``.launches``.
"""

from .attention import int8_kv_attention, int8_kv_attention_ref
from .kv_scatter import (kv_scatter_decode, kv_scatter_decode_ref,
                         paged_kv_scatter_decode, paged_kv_scatter_decode_ref)
from .paged_attention import paged_int8_attention, paged_int8_attention_ref
from .qmatmul import dynamic_qlinear, qmatmul, qmatmul_ref
from .rowquant import rowquant, rowquant_ref
from .wo_matmul import weight_only_matmul, weight_only_matmul_ref, weight_only_tolerance

# The wrappers whose launches a run can read and reset.
KERNELS = {
    "rowquant": rowquant,
    "qmatmul": qmatmul,
    "kv_scatter_decode": kv_scatter_decode,
    "int8_kv_attention": int8_kv_attention,
    "weight_only_matmul": weight_only_matmul,
    "paged_kv_scatter_decode": paged_kv_scatter_decode,
    "paged_int8_attention": paged_int8_attention,
}


def shared_rowquant(x):
    """Per-token quantization shared by sibling projections (q/k/v,
    gate/up): x[..., K] -> (int8, f32 scales), through the kernel on CUDA."""
    return rowquant(x)


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = [
    "KERNELS", "dynamic_qlinear", "int8_kv_attention", "int8_kv_attention_ref",
    "kv_scatter_decode", "kv_scatter_decode_ref", "launch_counts",
    "paged_int8_attention", "paged_int8_attention_ref", "paged_kv_scatter_decode",
    "paged_kv_scatter_decode_ref", "qmatmul", "qmatmul_ref", "reset_launch_counts",
    "rowquant", "rowquant_ref", "shared_rowquant", "weight_only_matmul",
    "weight_only_matmul_ref", "weight_only_tolerance",
]
