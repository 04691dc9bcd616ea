// The weight-only int8 body (B5) at prefill sizes: the tile kernel of
// int4_tile_sm90.cuh (WO8) with bf16 activations and the int8 weight [N, K]
// converted to bf16 in the consumers' registers. Replaces
// protoquant_tpu/ops/wo_matmul.py:_wo_kernel for M > WO_DECODE_MAX_M.

#include "int4_tile_sm90.cuh"

// bt: tokens a tile, 64, 128 or 256; k_splits: the cluster size, 1 to 8 and
// at most the stages of K (ops/wo_matmul.py: wo_tile_plan).
PQ_EXPORT int pq_weight_only_tile(const void* x, const void* wq, const void* sw,
                                  const void* bias, void* out, int out_dtype, int M, int N,
                                  int K, int bt, int k_splits, void* stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  if (K <= 0 || K % 16 != 0 || k_splits < 1 || k_splits > I4T_MAX_SPLITS ||
      k_splits > (K + I4T_SB - 1) / I4T_SB || (uintptr_t)x % 16 != 0 || (uintptr_t)wq % 16 != 0 ||
      out_dtype < PQ_F32 || out_dtype > PQ_F16)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // group: not read by this body (128 keeps its unused arithmetic defined)
  if (bt == 64)
    return i4t_launch<I4T_WO8, 64, 2>(x, wq, nullptr, nullptr, sw, bias, out, out_dtype, M, N,
                                      K, 128, k_splits, s);
  if (bt == 128)
    return i4t_launch<I4T_WO8, 128, 2>(x, wq, nullptr, nullptr, sw, bias, out, out_dtype, M, N,
                                       K, 128, k_splits, s);
  if (bt == 256)
    return i4t_launch<I4T_WO8, 256, 2>(x, wq, nullptr, nullptr, sw, bias, out, out_dtype, M, N,
                                       K, 128, k_splits, s);
  return cudaErrorInvalidValue;
}
