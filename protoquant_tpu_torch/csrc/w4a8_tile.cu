// The W4A8 "two_level" body (B12) at prefill sizes: the tile kernel of
// int4_tile_sm90.cuh with int8 activations and every code requantized.
// Replaces protoquant_tpu/ops/w4a8_matmul.py:_w4a8_2l_kernel for M >
// INT4_DECODE_MAX_M. r16 [N, G] and scol [N] come from the wrapper
// (ops.two_level_scales, made once per weight).

#include "int4_tile_sm90.cuh"

// bt: tokens a tile, 64, 128 or 256; k_splits: the cluster size, 1 to 8
// (ops/wo4_matmul.py: int4_tile_plan).
PQ_EXPORT int pq_w4a8_two_level(const void* xq, const void* sx, const void* packed,
                                const void* r16, const void* scol, const void* bias, void* out,
                                int out_dtype, int M, int N, int K, int group, int bt,
                                int k_splits, void* stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  if (!i4t_args_ok(xq, packed, out_dtype, K, group, k_splits)) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bt == 64)
    return i4t_launch_g<I4T_TWO_LEVEL, 64>(xq, packed, r16, sx, scol, bias, out,
                                            out_dtype, M, N, K, group, k_splits, s);
  if (bt == 128)
    return i4t_launch_g<I4T_TWO_LEVEL, 128>(xq, packed, r16, sx, scol, bias, out,
                                             out_dtype, M, N, K, group, k_splits, s);
  if (bt == 256)
    return i4t_launch_g<I4T_TWO_LEVEL, 256>(xq, packed, r16, sx, scol, bias, out,
                                             out_dtype, M, N, K, group, k_splits, s);
  return cudaErrorInvalidValue;
}
