// Shared helpers for the protoquant kernels (sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes, kept in step with ops/_build.py DTYPE_CODES
enum PqDtype { PQ_F32 = 0, PQ_BF16 = 1, PQ_F16 = 2 };

// int8 symmetric range and scale floor: core/numerics.py QMAX, SCALE_EPS
#define PQ_QMAX 127.0f
#define PQ_SCALE_EPS 1e-12f

__device__ __forceinline__ float pq_to_float(float v) { return v; }
__device__ __forceinline__ float pq_to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float pq_to_float(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T pq_from_float(float v);
template <> __device__ __forceinline__ float pq_from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 pq_from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half pq_from_float<__half>(float v) {
  return __float2half_rn(v);
}

__device__ __forceinline__ float pq_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float pq_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// v rounded to the dtype ``code`` (PqDtype) and back to f32, to nearest even.
__device__ __forceinline__ float pq_round_to(float v, int code) {
  if (code == PQ_BF16) return __bfloat162float(__float2bfloat16_rn(v));
  if (code == PQ_F16) return __half2float(__float2half_rn(v));
  return v;
}

// Block-wide maximum and sum of one value per thread over a block of
// THREADS threads; every thread gets the result. ``scratch`` holds
// THREADS / 32 floats in shared memory. Give each reduction of a kernel its
// own scratch: the result is read from scratch[0] after the barrier, and a
// second reduction into the same array could overwrite it first.
template <int THREADS>
__device__ __forceinline__ float pq_block_max(float v, float* scratch) {
  v = pq_warp_max(v);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    float m = threadIdx.x < THREADS / 32 ? scratch[threadIdx.x] : 0.0f;
    m = pq_warp_max(m);
    if (threadIdx.x == 0) scratch[0] = m;
  }
  __syncthreads();
  return scratch[0];
}

template <int THREADS>
__device__ __forceinline__ float pq_block_sum(float v, float* scratch) {
  v = pq_warp_sum(v);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    float m = threadIdx.x < THREADS / 32 ? scratch[threadIdx.x] : 0.0f;
    m = pq_warp_sum(m);
    if (threadIdx.x == 0) scratch[0] = m;
  }
  __syncthreads();
  return scratch[0];
}

// The rowquant contract on one f32 row of K values in shared memory, whose
// absolute maximum over this thread's elements is ``amax``:
// s = max(amax / 127, 1e-12) by IEEE division, q = rint(v / s) (half to
// even) clamped to +-127. Division is spelled __fdiv_rn so no compiler flag
// can turn it into a reciprocal multiply. Writes K codes to ``q`` and s to
// ``*s_out``. Every thread of the block calls it (it holds a barrier), after
// writing its elements of ``row``.
template <int THREADS>
__device__ __forceinline__ void pq_quantize_row(const float* row, int K, float amax,
                                                float* scratch, int8_t* __restrict__ q,
                                                float* __restrict__ s_out) {
  const float s = fmaxf(__fdiv_rn(pq_block_max<THREADS>(amax, scratch), PQ_QMAX),
                        PQ_SCALE_EPS);
  for (int i = threadIdx.x; i < K; i += THREADS) {
    float v = rintf(__fdiv_rn(row[i], s));
    v = fminf(fmaxf(v, -PQ_QMAX), PQ_QMAX);
    q[i] = (int8_t)(int)v;
  }
  if (threadIdx.x == 0) *s_out = s;
}

// Two int8 codes of ``w`` as a bf16 pair, exactly: ``sel`` 0x4140 takes
// bytes 0 and 1 (byte 0 in the low half), 0x4342 bytes 2 and 3. The byte
// permute puts each code under 0x43 (0x43cc); with the code's sign bit
// cleared that is the bf16 128 + (code & 127), with only the sign bit kept
// 128 or 256, and their difference is the code (a bf16x2 subtract of small
// integers, exact). A prmt and two ANDs a pair, and one subtract.
__device__ __forceinline__ uint32_t pq_int8_pair_bf16(uint32_t w, uint32_t sel) {
  const uint32_t p = __byte_perm(w, 0x43u, sel);
  uint32_t x = p & 0xFF7FFF7Fu, y = p & 0xFF80FF80u;
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&x),
                             *reinterpret_cast<__nv_bfloat162*>(&y));
  return *reinterpret_cast<uint32_t*>(&r);
}

// cp.async from global into shared memory: 16 bytes through L2 alone
// (.cg) or 4 bytes through L1 (.ca); with ``pred`` false the copy reads
// nothing and zero-fills its bytes (src-size 0; ``src`` must still be a
// valid address). commit closes the thread's group of copies issued so far;
// wait<N> returns once at most N of its groups are in flight.
__device__ __forceinline__ void pq_cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void pq_cp_async16(void* dst, const void* src, bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void pq_cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void pq_cp_async4(void* dst, const void* src, bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void pq_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void pq_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Let ``kernel`` take up to ``bytes`` of dynamic shared memory. Called once
// per kernel at its first launch (not per launch, so launches can be
// captured in a CUDA graph); ``done`` is that kernel's own flag.
template <typename Kernel>
static cudaError_t pq_allow_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done = true;
  return err;
}

#define PQ_EXPORT extern "C" __attribute__((visibility("default")))
