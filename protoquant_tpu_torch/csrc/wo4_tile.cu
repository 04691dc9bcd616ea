// The weight-only int4 "split" body (B11) at prefill sizes: the tile kernel of
// int4_tile_sm90.cuh with bf16 activations. Replaces
// protoquant_tpu/ops/wo4_matmul.py:_wo4_split_kernel for M > SPLIT_DECODE_MAX_M.

#include "int4_tile_sm90.cuh"

// bt: tokens a tile, 64 or 128; k_splits: the cluster size, 1 to 8
// (ops/wo4_matmul.py: int4_tile_plan).
PQ_EXPORT int pq_wo4_split(const void* x, const void* packed, const void* scales,
                           const void* bias, void* out, int out_dtype, int M, int N, int K,
                           int group, int bt, int k_splits, void* stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  if (!i4t_args_ok(x, packed, out_dtype, K, group, k_splits)) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bt == 64)
    return i4t_launch_g<I4T_SPLIT, 64>(x, packed, scales, nullptr, nullptr, bias, out,
                                        out_dtype, M, N, K, group, k_splits, s);
  if (bt == 128)
    return i4t_launch_g<I4T_SPLIT, 128>(x, packed, scales, nullptr, nullptr, bias, out,
                                         out_dtype, M, N, K, group, k_splits, s);
  return cudaErrorInvalidValue;
}

// The clusters of ``k_splits`` blocks the card holds at once
// (cudaOccupancyMaxActiveClusters) for the tile kernels, every instance of
// which takes a whole SM: what the plan's INT4_TILE_CLUSTERS is read from.
PQ_EXPORT int pq_int4_tile_clusters(int k_splits, int* clusters) {
  using S = I4tShape<I4T_SPLIT, 64>;
  auto kernel = int4_tile_kernel<I4T_SPLIT, 64, 2>;
  static bool smem_set = false;
  cudaError_t err = pq_allow_smem(kernel, S::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(k_splits * 64));
  cfg.blockDim = dim3(I4T_THREADS);
  cfg.dynamicSmemBytes = S::SMEM;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = k_splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(clusters, reinterpret_cast<const void*>(kernel), &cfg);
}
