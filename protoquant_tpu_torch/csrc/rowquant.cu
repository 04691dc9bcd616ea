// Dynamic per-row int8 quantization.
//
// Replaces protoquant_tpu/ops/rowquant.py:_rowquant_kernel (Pallas).
// Bound on the H100: bytes. It reads M*K input values once and writes M*K
// int8 codes and M f32 scales, about no arithmetic per byte; at decode (M of
// a few rows) the time is the launch and one trip to device memory.
// Design: row_quant.cuh with the identity producer: each row held in
// registers, read once by 16-byte loads, its absolute maximum reduced by
// shuffles, the codes written from registers. ops/rowquant.py's plan splits
// a row over a thread block cluster where rows are few (route "cluster":
// the row's bytes spread over the SMs, the maxima joined over distributed
// shared memory), else one block a row (route "rows"; wider rows than a
// block's registers hold take more blocks).

#include "row_quant.cuh"

template <typename T, int R>
__global__ void __launch_bounds__(RQ_MAX_THREADS(R), RQ_MIN_BLOCKS(R))
rowquant_kernel(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx,
                int K, int C) {
  rq_row<T, R, 1>(x, nullptr, xq, sx, K, C, RqIdentity());
}

template <typename T, int R>
static cudaError_t launch(const void* x, void* xq, void* sx, int M, int K, int blocks,
                          int threads, cudaStream_t stream) {
  return rq_launch(rowquant_kernel<T, R>, M, blocks, threads, stream, (const T*)x, (int8_t*)xq,
                   (float*)sx, K, blocks);
}

template <typename T>
static cudaError_t dispatch(const void* x, void* xq, void* sx, int M, int K, int blocks,
                            int threads, int vectors, cudaStream_t s) {
  if (!rq_plan_ok(K, 16 / (int)sizeof(T), blocks, threads, vectors)) return cudaErrorInvalidValue;
  switch (vectors) {
    case 1: return launch<T, 1>(x, xq, sx, M, K, blocks, threads, s);
    case 2: return launch<T, 2>(x, xq, sx, M, K, blocks, threads, s);
    default: return launch<T, 4>(x, xq, sx, M, K, blocks, threads, s);
  }
}

// blocks, threads, vectors: the plan (ops/rowquant.py rowquant_plan): the
// blocks a row (a cluster where > 1), the threads a block, the 16-byte
// vectors a thread.
PQ_EXPORT int pq_rowquant(const void* x, int x_dtype, void* xq, void* sx, int M, int K,
                          int blocks, int threads, int vectors, void* stream) {
  if (M == 0) return cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (x_dtype) {
    case PQ_F32: return dispatch<float>(x, xq, sx, M, K, blocks, threads, vectors, s);
    case PQ_BF16: return dispatch<__nv_bfloat16>(x, xq, sx, M, K, blocks, threads, vectors, s);
    case PQ_F16: return dispatch<__half>(x, xq, sx, M, K, blocks, threads, vectors, s);
    default: return cudaErrorInvalidValue;
  }
}
