// int8 x int8 -> int32 GEMM with the fused f32 epilogue.
//
// Replaces protoquant_tpu/ops/qmatmul.py:_qmatmul_kernel (Pallas).
//   out[m, n] = cast((float(acc[m, n]) * s_x[m]) * s_w[n] + bias[n])
//   acc[m, n] = sum_k xq[m, k] * wq[n, k]            (exact int32)
// A = xq is [M, K] row-major; B = wq is [N, K] row-major (the nn.Linear
// layout, K contiguous), which is the "col" operand of mma.sync.
// Bound on the H100: at decode (M = 4) bytes, the weight stream N*K; at
// prefill (M = 256) still bytes for these widths (the int8 tensor-core rate
// needs M in the thousands). Design: a 64 x 64 output tile per block of 4
// warps (int8_mma.cuh: each warp 32 x 32 through mma.sync.m16n8k32, 64-deep
// K tiles double buffered through shared memory with cp.async, ragged edges
// zero-filled). The int32 accumulator lives in registers and never reaches
// device memory.
// The epilogue multiplies and adds with __fmul_rn / __fadd_rn so it is
// never contracted into an FMA and matches the plain version bit for bit.
// A later version moves to wgmma and TMA, and splits K at decode to put
// more than N/64 blocks on the card.

#include "int8_mma.cuh"

template <typename OutT>
__global__ void __launch_bounds__(QM_THREADS)
qmatmul_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
               const float* __restrict__ sx, const float* __restrict__ sw,
               const float* __restrict__ bias, OutT* __restrict__ out,
               int M, int N, int K) {
  __shared__ __align__(16) int8_t As[2][BM][LDS];
  __shared__ __align__(16) int8_t Bs[2][BN][LDS];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int g = lane >> 2, t = lane & 3;

  int acc[2][4][4];
  int8_tile_mma(acc, As, Bs, A, B, M, N, K, m0, n0);

  // Epilogue: c0,c1 at (row g, cols 2t, 2t+1); c2,c3 at row g + 8.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + i * 16 + g + 8 * h;
      if (row >= M) continue;
      const float sxr = sx[row];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn + j * 8 + 2 * t + e;
          if (col >= N) continue;
          float y = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h + e]), sxr), sw[col]);
          if (bias != nullptr) y = __fadd_rn(y, bias[col]);
          out[(size_t)row * N + col] = pq_from_float<OutT>(y);
        }
      }
    }
  }
}

template <typename OutT>
static cudaError_t launch(const void* xq, const void* wq, const void* sx, const void* sw,
                          const void* bias, void* out, int M, int N, int K,
                          cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  qmatmul_kernel<OutT><<<grid, QM_THREADS, 0, stream>>>(
      (const int8_t*)xq, (const int8_t*)wq, (const float*)sx, (const float*)sw,
      (const float*)bias, (OutT*)out, M, N, K);
  return cudaGetLastError();
}

PQ_EXPORT int pq_qmatmul(const void* xq, const void* wq, const void* sx, const void* sw,
                         const void* bias, void* out, int out_dtype, int M, int N, int K,
                         void* stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  if (K % 16 != 0) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (out_dtype) {
    case PQ_F32: return launch<float>(xq, wq, sx, sw, bias, out, M, N, K, s);
    case PQ_BF16: return launch<__nv_bfloat16>(xq, wq, sx, sw, bias, out, M, N, K, s);
    case PQ_F16: return launch<__half>(xq, wq, sx, sw, bias, out, M, N, K, s);
    default: return cudaErrorInvalidValue;
  }
}
