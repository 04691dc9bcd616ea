// Weight-only int4 matmul: x times a group-wise int4 weight, the "legacy"
// body (the "split" body runs on wo4_decode.cu and wo4_tile.cu).
//
// Replaces protoquant_tpu/ops/wo4_matmul.py:_wo4_kernel (Pallas): w = q *
// s[n, g] in f32, x in f32, one f32 dot, out = cast(acc + bias). The weight
// is packed [N, K/2] int8 (see int4_tile.cuh for the layout), scales f32
// [N, K/g].
// Bound on the H100: bytes at decode (M = 4), the packed weight and its
// scales read once, K * N / 2 + 4 * N * K / 128 bytes (2.66 us at
// K = N = 4096). Legacy runs on the CUDA cores (it is off the serving path):
// a warp per output column walks its packed row 128 bytes at a time,
// coalesced, with FMAs into 4 rows of x, then a warp sum.

#include "common.cuh"

constexpr int WL_WARPS = 4;  // output columns per block
constexpr int WL_ROWS = 4;   // rows of x per warp

template <typename OutT>
__global__ void __launch_bounds__(32 * WL_WARPS)
wo4_legacy_kernel(const float* __restrict__ x, const int8_t* __restrict__ packed,
                  const float* __restrict__ scales, const float* __restrict__ bias,
                  OutT* __restrict__ out, int M, int N, int K, int group) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * WL_WARPS + (threadIdx.x >> 5);
  const int m0 = blockIdx.y * WL_ROWS;
  if (n >= N) return;
  const int half = group / 2, KB = K / 2, G = K / group;
  const int8_t* wrow = packed + (size_t)n * KB;
  const float* srow = scales + (size_t)n * G;
  float acc[WL_ROWS];
#pragma unroll
  for (int r = 0; r < WL_ROWS; ++r) acc[r] = 0.0f;
  for (int b = 4 * lane; b < KB; b += 128) {
    // 4 bytes inside one half group: low codes at k .. k + 3, high at
    // k + half .. k + half + 3
    const uint32_t w = *(const uint32_t*)(wrow + b);
    const int gi = b / half;
    const int k = gi * group + (b - gi * half);
    const float s = srow[gi];
    float wl[4], wh[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      wl[i] = __fmul_rn((float)((int)(w << (28 - 8 * i)) >> 28), s);
      wh[i] = __fmul_rn((float)((int)(w << (24 - 8 * i)) >> 28), s);
    }
#pragma unroll
    for (int r = 0; r < WL_ROWS; ++r) {
      if (m0 + r >= M) break;
      const float4 xl = *(const float4*)(x + (size_t)(m0 + r) * K + k);
      const float4 xh = *(const float4*)(x + (size_t)(m0 + r) * K + k + half);
      float a = acc[r];
      a = fmaf(xl.x, wl[0], a); a = fmaf(xl.y, wl[1], a);
      a = fmaf(xl.z, wl[2], a); a = fmaf(xl.w, wl[3], a);
      a = fmaf(xh.x, wh[0], a); a = fmaf(xh.y, wh[1], a);
      a = fmaf(xh.z, wh[2], a); a = fmaf(xh.w, wh[3], a);
      acc[r] = a;
    }
  }
#pragma unroll
  for (int r = 0; r < WL_ROWS; ++r) {
    const float v = pq_warp_sum(acc[r]);
    if (lane == 0 && m0 + r < M) {
      const float y = bias != nullptr ? __fadd_rn(v, bias[n]) : v;
      out[(size_t)(m0 + r) * N + n] = pq_from_float<OutT>(y);
    }
  }
}

template <typename OutT>
static cudaError_t legacy_t(const void* x, const void* packed, const void* scales,
                            const void* bias, void* out, int M, int N, int K, int group,
                            cudaStream_t stream) {
  dim3 grid((N + WL_WARPS - 1) / WL_WARPS, (M + WL_ROWS - 1) / WL_ROWS);
  wo4_legacy_kernel<OutT><<<grid, 32 * WL_WARPS, 0, stream>>>(
      (const float*)x, (const int8_t*)packed, (const float*)scales, (const float*)bias,
      (OutT*)out, M, N, K, group);
  return cudaGetLastError();
}

static bool wo4_shape_ok(int K, int group) {
  return (group == 32 || group == 64 || group == 128 || group == 256) && K % group == 0;
}

PQ_EXPORT int pq_wo4_legacy(const void* x, const void* packed, const void* scales,
                            const void* bias, void* out, int out_dtype, int M, int N, int K,
                            int group, void* stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  if (!wo4_shape_ok(K, group)) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (out_dtype) {
    case PQ_F32: return legacy_t<float>(x, packed, scales, bias, out, M, N, K, group, s);
    case PQ_BF16: return legacy_t<__nv_bfloat16>(x, packed, scales, bias, out, M, N, K, group, s);
    case PQ_F16: return legacy_t<__half>(x, packed, scales, bias, out, M, N, K, group, s);
    default: return cudaErrorInvalidValue;
  }
}
