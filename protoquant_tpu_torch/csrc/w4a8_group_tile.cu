// The W4A8 "group" body (B12) at prefill sizes: the tile kernel of
// int4_tile_sm90.cuh with int8 activations, the codes by the biased-nibble
// subtract and a group epilogue. Replaces
// protoquant_tpu/ops/w4a8_matmul.py:_w4a8_kernel for M > GROUP_DECODE_MAX_M,
// bit for bit.

#include "int4_tile_sm90.cuh"

// bt: tokens a tile, 64 or 128; k_splits: 1 (ops/wo4_matmul.py:
// int4_tile_plan), the one split that keeps the group chain's order.
PQ_EXPORT int pq_w4a8_group_tile(const void* xq, const void* sx, const void* packed,
                                 const void* scales, const void* bias, void* out, int out_dtype,
                                 int M, int N, int K, int group, int bt, int k_splits,
                                 void* stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  if (!i4t_args_ok(xq, packed, out_dtype, K, group, k_splits) || k_splits != 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bt == 64)
    return i4t_launch_g<I4T_GROUP, 64>(xq, packed, scales, sx, nullptr, bias, out, out_dtype,
                                        M, N, K, group, 1, s);
  if (bt == 128)
    return i4t_launch_g<I4T_GROUP, 128>(xq, packed, scales, sx, nullptr, bias, out, out_dtype,
                                         M, N, K, group, 1, s);
  return cudaErrorInvalidValue;
}
