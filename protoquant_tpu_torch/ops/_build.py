"""Lazy ``nvcc`` build of ``csrc/*.cu`` into one shared library, loaded with
``ctypes``.

Nothing happens at import. The first CUDA launch calls :func:`lib`, which
compiles each source with its own ``nvcc`` process (all started together),
links the objects into ``_build/libpq_kernels_<hash>.so`` beside the package
and loads it. The hash covers the sources and the flags, so an edited source
rebuilds. Each C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on anything but 0.

The flags never include ``--use_fast_math``: the quantizers rely on IEEE
division (``div.rn``) and ``rintf`` to reproduce the plain versions bit for
bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
NVCC_FLAGS = [ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_PP = ctypes.POINTER(ctypes.c_void_p)
# C signatures of the entry points in csrc/*.cu (every one returns an int,
# a cudaError_t, and takes the stream last, but the split plans).
SIGNATURES = {
    # x, x_dtype, xq, sx, M, K, the plan (blocks a row, threads a block,
    # vectors a thread), stream
    "pq_rowquant": [_P, _I, _P, _P] + [_I] * 5 + [_P],
    # xq, wq, sx, sw, bias, out, out_dtype, M, N, K, tile rows, k_splits, stream
    "pq_qmatmul": [_P] * 6 + [_I] * 6 + [_P],
    # kq, ks, vq, vs, lengths, k8, ks_new, v8, vs_new, B, KV, S, Dh, stream
    "pq_kv_scatter_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _P],
    # kq, ks, vq, vs, lengths, k8, ks_new, v4, vs_new, B, KV, S, Dh, stream
    "pq_kv_mixed_scatter_decode": [_P] * 9 + [_I] * 4 + [_P],
    # q, q_dtype, kq, ks, vq, vs, lengths, kpos, alibi, sink, out, B, T, H,
    # KV, S, Dh, sm, window, softcap, sinks, stream (kpos, alibi and the
    # learned sinks may be null)
    "pq_int8_kv_attention": [_P, _I] + [_P] * 9 + [_I] * 6 + [_F, _I, _F, _I, _P],
    # q, q_dtype, kq, ks, vq, vs, lengths, out, B, T, H, KV, S, Dh, sm, stream
    "pq_mixed_kv_attention": [_P, _I] + [_P] * 6 + [_I] * 6 + [_F, _P],
    # the weight-only int8 kernels: x, wq, sw, bias, out, out_dtype, M, N, K,
    # then k_splits (decode) or tokens a tile and k_splits (tile), stream
    "pq_weight_only_decode": [_P] * 5 + [_I] * 5 + [_P],
    "pq_weight_only_tile": [_P] * 5 + [_I] * 6 + [_P],
    # M, k_splits, out clusters; launches nothing and takes no stream
    "pq_weight_only_decode_clusters": [_I, _I, ctypes.POINTER(ctypes.c_int)],
    # kq, ks, vq, vs, page_table, lengths, k8, ks_new, v8, vs_new,
    # B, maxP, P, KV, ps, Dh, stream
    "pq_paged_kv_scatter_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                   _I, _I, _I, _I, _I, _I, _P],
    # q, q_dtype, kq, ks, vq, vs, page_table, lengths, alibi (or null), out,
    # B, H, KV, maxP, ps, Dh, sm, stream
    "pq_paged_int8_attention": [_P, _I] + [_P] * 8 + [_I] * 6 + [_F, _P],
    # x, packed, scales, bias, out, out_dtype, M, N, K, group, stream
    "pq_wo4_legacy": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # the tile kernels: x, packed, scales, bias, out, out_dtype, M, N, K,
    # group, tokens a tile, k_splits, stream; xq, sx, packed, r16, scol, bias,
    # out, out_dtype, M, N, K, group, tokens a tile, k_splits, stream
    "pq_wo4_split": [_P] * 5 + [_I] * 7 + [_P],
    "pq_w4a8_two_level": [_P] * 7 + [_I] * 7 + [_P],
    # k_splits, out clusters; launches nothing and takes no stream
    "pq_int4_tile_clusters": [_I, ctypes.POINTER(ctypes.c_int)],
    # the decode kernels: as above, with k_splits before the stream
    "pq_wo4_split_decode": [_P] * 5 + [_I] * 6 + [_P],
    "pq_w4a8_two_level_decode": [_P] * 7 + [_I] * 6 + [_P],
    # M, group, k_splits, out clusters; launches nothing and takes no stream
    "pq_wo4_split_decode_clusters": [_I] * 3 + [ctypes.POINTER(ctypes.c_int)],
    "pq_w4a8_two_level_decode_clusters": [_I] * 3 + [ctypes.POINTER(ctypes.c_int)],
    # W4A8 group: xq, sx, packed, scales, bias, out, out_dtype, M, N, K,
    # group, then k_splits (decode) or tokens a tile and k_splits (tile), stream
    "pq_w4a8_group_decode": [_P] * 6 + [_I] * 6 + [_P],
    "pq_w4a8_group_tile": [_P] * 6 + [_I] * 7 + [_P],
    # M, K, group, k_splits, out clusters; launches nothing and takes no stream
    "pq_w4a8_group_decode_clusters": [_I] * 4 + [ctypes.POINTER(ctypes.c_int)],
    # x, x_dtype, w, xq, sx, M, K, eps, cast_dtype, stream
    "pq_rms_norm_quant": [_P, _I, _P, _P, _P, _I, _I, _F, _I, _P],
    # gate, up, dtype, hq, sh, M, K, the plan (as pq_rowquant's), act,
    # cast_dtype, stream
    "pq_swiglu_quant": [_P, _P, _I, _P, _P] + [_I] * 7 + [_P],
    # q, scale, out, out_dtype, M, N, scale_on_last, stream
    "pq_dequant": [_P, _P, _P, _I, _I, _I, _I, _P],
    # kq, kchs, vq, vs, ktail, kts, vtail, vts, lengths, adv, k8, ks_new, v8,
    # vs_new, B, KV, S, Dh, G, T, the new rows' strides (b, h, t), their
    # scales' (b, h, t), prefill (0: the decode route), stream
    "pq_k4v8_decode_update": [_P] * 14 + [_I] * 13 + [_P],
    "pq_kivi4_decode_update": [_P] * 14 + [_I] * 13 + [_P],
    # xs, nx, out mismatch count (u64), stream: the KIVI update's division
    # against IEEE division (a check for the card tests)
    "pq_kivi_div_check": [_P, _I, _P, _P],
    # q, q_dtype, kq, kchs, vq, vs, ktail, kts, vtail, vts, lengths,
    # new_lengths, alibi (or null), sink (or null), out, B, T, H, KV, S, Dh,
    # G, sm, window, softcap, stream
    "pq_k4v8_attention": [_P, _I] + [_P] * 13 + [_I] * 7 + [_F, _I, _F, _P],
    "pq_int4_kv_attention": [_P, _I] + [_P] * 13 + [_I] * 7 + [_F, _I, _F, _P],
    # the split-S decode: as above, with the partials' workspace (acc, (m, l))
    # after out and its n_split before the stream
    "pq_k4v8_attention_split": [_P, _I] + [_P] * 15 + [_I] * 7 + [_F, _I, _F, _I, _P],
    "pq_int4_kv_attention_split": [_P, _I] + [_P] * 15 + [_I] * 7 + [_F, _I, _F, _I, _P],
    # T, H, KV, S, Dh, G, out span; returns n_split (0: the prefill kernel),
    # launches nothing and takes no stream
    "pq_kivi_split_plan": [_I] * 6 + [ctypes.POINTER(ctypes.c_int)],
    # the split-S int8 and K8V4 decode: as their prefill entries, with the
    # partials' workspace (acc, (m, l)) after out and n_split before the stream
    "pq_int8_kv_attention_split": [_P, _I] + [_P] * 11 + [_I] * 6 + [_F, _I, _F, _I, _I, _P],
    "pq_mixed_kv_attention_split": [_P, _I] + [_P] * 8 + [_I] * 6 + [_F, _I, _P],
    # T, H, KV, S, Dh, window, sinks, ring (0 or 1), out span; as
    # pq_kivi_split_plan
    "pq_attn_split_plan": [_I] * 8 + [ctypes.POINTER(ctypes.c_int)],
    # H, KV, maxP, ps, Dh, out span; as pq_attn_split_plan
    "pq_paged_split_plan": [_I] * 5 + [ctypes.POINTER(ctypes.c_int)],
    # the split-S paged decode: as pq_paged_int8_attention, with the partials'
    # workspace (acc, (m, l)) after out and n_split before the stream
    "pq_paged_int8_attention_split": [_P, _I] + [_P] * 10 + [_I] * 6 + [_F, _I, _P],
    # xq, wq, sx, sw, bias, out, out_dtype, M, N, K, k_splits, stream
    "pq_qmatmul_decode": [_P] * 6 + [_I] * 5 + [_P],
    # pointer arrays xq, sx, wq, sw, out (by local rank), comm, data, credit
    # (by ring rank); tp, rank_base, tp_local, M, N, K, k_splits, epoch, stream
    "pq_ring_qmatmul_rs": [_PP] * 8 + [_I] * 8 + [ctypes.c_uint, _P],
    # M, tp, k_splits, out clusters; launches nothing and takes no stream
    "pq_ring_qmatmul_rs_clusters": [_I] * 3 + [ctypes.POINTER(ctypes.c_int)],
}

# dtype codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_lock = threading.Lock()
_lib = None
build_seconds: float | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile and link the kernels if the library for these sources is
    missing; return its path."""
    global build_seconds
    out = BUILD_DIR / f"libpq_kernels_{_digest()}.so"
    if out.exists():
        return out
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []
    procs = []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}_{out.stem[-16:]}.o"
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-I", str(CSRC), "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    objs, errors = [], []
    for src, obj, proc in procs:
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            errors.append(f"{src.name}:\n{log}")
        elif verbose and log.strip():
            print(f"[nvcc {src.name}]\n{log}", flush=True)
        objs.append(str(obj))
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, ARCH, "-shared", "-o", str(tmp), *objs, "-ldl"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n"
                           + link.stdout.decode(errors="replace"))
    os.replace(tmp, out)
    for o in objs:
        Path(o).unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    return out


def lib(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build(verbose)))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def same_device_contiguous(name: str, *tensors: torch.Tensor) -> torch.device:
    """Check that the tensors are contiguous and on one device; return it."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} "
                             "is not contiguous")
    return dev
