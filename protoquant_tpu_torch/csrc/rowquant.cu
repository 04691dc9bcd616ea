// Dynamic per-row int8 quantization.
//
// Replaces protoquant_tpu/ops/rowquant.py:_rowquant_kernel (Pallas).
// Bound on the H100: bytes. It reads M*K input values once and writes M*K
// int8 codes and M f32 scales, about no arithmetic per byte.
// Design: one block per row. The row is converted to f32 into shared
// memory while the block reduces its absolute maximum, so device memory is
// read once; the second pass (divide, round, clamp: pq_quantize_row in
// common.cuh, shared with the producer-fused kernels) runs out of shared
// memory.

#include "common.cuh"

constexpr int RQ_THREADS = 256;
constexpr int RQ_MAX_SMEM = 226 * 1024;  // dynamic shared memory (227 KB less the static part)

template <typename T>
__global__ void __launch_bounds__(RQ_THREADS)
rowquant_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                float* __restrict__ sx, int K) {
  extern __shared__ float row[];
  __shared__ float warp_max[RQ_THREADS / 32];
  const size_t base = (size_t)blockIdx.x * K;
  const T* xr = x + base;

  float amax = 0.0f;
  for (int i = threadIdx.x; i < K; i += RQ_THREADS) {
    float v = pq_to_float(xr[i]);
    row[i] = v;
    amax = fmaxf(amax, fabsf(v));
  }
  pq_quantize_row<RQ_THREADS>(row, K, amax, warp_max, xq + base, sx + blockIdx.x);
}

template <typename T>
static cudaError_t launch(const void* x, void* xq, void* sx, int M, int K,
                          cudaStream_t stream) {
  static bool configured = false;
  cudaError_t err = pq_allow_smem(rowquant_kernel<T>, RQ_MAX_SMEM, configured);
  if (err != cudaSuccess) return err;
  const size_t smem = (size_t)K * sizeof(float);
  if (smem > (size_t)RQ_MAX_SMEM) return cudaErrorInvalidValue;
  rowquant_kernel<T><<<M, RQ_THREADS, smem, stream>>>(
      (const T*)x, (int8_t*)xq, (float*)sx, K);
  return cudaGetLastError();
}

PQ_EXPORT int pq_rowquant(const void* x, int x_dtype, void* xq, void* sx,
                          int M, int K, void* stream) {
  if (M == 0) return cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (x_dtype) {
    case PQ_F32: return launch<float>(x, xq, sx, M, K, s);
    case PQ_BF16: return launch<__nv_bfloat16>(x, xq, sx, M, K, s);
    case PQ_F16: return launch<__half>(x, xq, sx, M, K, s);
    default: return cudaErrorInvalidValue;
  }
}
