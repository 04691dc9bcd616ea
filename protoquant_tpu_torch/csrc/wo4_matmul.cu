// Weight-only int4 matmul: x times a group-wise int4 weight, two bodies.
//
// Replaces protoquant_tpu/ops/wo4_matmul.py (Pallas):
//   split  (_wo4_split_kernel): x rounded to bf16; for each K-group g in
//          ascending order p = x_g . q_g (bf16 x code products, exact in f32,
//          summed in f32), acc = acc + p * s[n, g]; out = cast(acc + bias).
//   legacy (_wo4_kernel): w = q * s[n, g] in f32, x in f32, one f32 dot,
//          out = cast(acc + bias).
// The weight is packed [N, K/2] int8 (see int4_tile.cuh for the layout),
// scales f32 [N, K/g].
// Bound on the H100: bytes at decode (M = 4), the packed weight and its
// scales read once, K * N / 2 + 4 * N * K / 128 bytes (2.66 us at
// K = N = 4096). Design of split: the packed tile comes in by cp.async and
// each 4 bytes of a row become two bf16 pairs of low-nibble codes and two of
// high-nibble codes in registers (a byte permute and one bf16x2 subtract,
// exact), right before mma.sync m16n8k16 with f32 accumulators; no bf16 or
// int8 copy of W reaches device memory. The group's partial sum p stays in
// registers; at the group's last chunk each thread multiplies it by its
// column's scale from the shared-memory table and adds it to acc with
// __fmul_rn / __fadd_rn, never contracted into an FMA, so only the order of
// the f32 sum inside a group differs from the plain version. Tiles as in
// wo_matmul.cu: BM = 16, BN = 32 at decode (128 blocks at N = 4096), stages
// of 128 bytes per weight row, 3 in flight; BM = 64, BN = 64 above 16 rows,
// stages of 64 bytes; one instance per group size (32, 64, 128, 256), so the
// group arithmetic is constant. No split of K: the groups of a column are
// summed in order by one thread.
// Legacy runs on the CUDA cores (it is off the serving path): a warp per
// output column walks its packed row 128 bytes at a time, coalesced, with
// FMAs into 4 rows of x, then a warp sum.

#include "int4_tile.cuh"

template <int MT, int NT, int BB, int STAGES, int HALF, typename OutT>
__global__ void __launch_bounds__(W4_THREADS)
wo4_split_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ packed,
                 const float* __restrict__ scales, const float* __restrict__ bias,
                 OutT* __restrict__ out, int M, int N, int K) {
  using T = W4Tile<2, MT, NT, BB, STAGES, HALF>;
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wn = warp * 8 * NT;  // this warp's first column in the tile

  float acc[MT][NT][4], p[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = p[i][j][e] = 0.0f;

  w4_mainloop<T, 2, HALF, STAGES>(
      reinterpret_cast<const unsigned char*>(x), packed, scales, M, N, K, m0, n0,
      [&](const unsigned char* As, const unsigned char* Bs, const float* Ts, int c, int slot,
          bool group_end) {
        uint32_t alo[MT][4], ahi[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const unsigned char* r0 = As + (i * 16 + g) * T::AS + 2 * (16 * c + 4 * t);
          const unsigned char* r8 = r0 + 8 * T::AS;
          const uint2 l0 = *(const uint2*)r0, l8 = *(const uint2*)r8;
          const uint2 h0 = *(const uint2*)(r0 + 2 * BB), h8 = *(const uint2*)(r8 + 2 * BB);
          alo[i][0] = l0.x; alo[i][1] = l8.x; alo[i][2] = l0.y; alo[i][3] = l8.y;
          ahi[i][0] = h0.x; ahi[i][1] = h8.x; ahi[i][2] = h0.y; ahi[i][3] = h8.y;
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint32_t w = *(const uint32_t*)(Bs + (wn + j * 8 + g) * T::BS + 16 * c + 4 * t);
          uint32_t ulo, uhi, blo[2], bhi[2];
          w4_biased_nibbles(w, ulo, uhi);
          w4_codes_bf16(ulo, blo);
          w4_codes_bf16(uhi, bhi);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            w4_mma_bf16(p[i][j], alo[i], blo);
            w4_mma_bf16(p[i][j], ahi[i], bhi);
          }
        }
        if (group_end) {
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const float s0 = Ts[slot * T::BN + wn + j * 8 + 2 * t];
            const float s1 = Ts[slot * T::BN + wn + j * 8 + 2 * t + 1];
#pragma unroll
            for (int i = 0; i < MT; ++i)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                acc[i][j][e] = __fadd_rn(acc[i][j][e], __fmul_rn(p[i][j][e], (e & 1) ? s1 : s0));
                p[i][j][e] = 0.0f;
              }
          }
        }
      });

  // Epilogue: c0, c1 at (row g, cols 2t, 2t+1); c2, c3 at row g + 8.
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + i * 16 + g + 8 * hh;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn + j * 8 + 2 * t + e;
          if (col >= N) continue;
          float y = acc[i][j][2 * hh + e];
          if (bias != nullptr) y = __fadd_rn(y, bias[col]);
          out[(size_t)row * N + col] = pq_from_float<OutT>(y);
        }
    }
}

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

template <int MT, int NT, int BB, int STAGES, int HALF, typename OutT>
static cudaError_t split_t(const void* x, const void* packed, const void* scales,
                           const void* bias, void* out, int M, int N, int K,
                           cudaStream_t stream) {
  static bool smem_set = false;
  return w4_launch<W4Tile<2, MT, NT, BB, STAGES, HALF>>(
      wo4_split_kernel<MT, NT, BB, STAGES, HALF, OutT>, smem_set, M, N, stream,
      (const __nv_bfloat16*)x, (const int8_t*)packed, (const float*)scales,
      (const float*)bias, (OutT*)out, M, N, K);
}

template <int HALF, typename OutT>
static cudaError_t split_m(const void* x, const void* packed, const void* scales,
                           const void* bias, void* out, int M, int N, int K,
                           cudaStream_t stream) {
  if (M <= 16)
    return split_t<1, 1, 128, 4, HALF, OutT>(x, packed, scales, bias, out, M, N, K, stream);
  return split_t<4, 2, 64, 4, HALF, OutT>(x, packed, scales, bias, out, M, N, K, stream);
}

template <typename OutT>
static cudaError_t split_g(const void* x, const void* packed, const void* scales,
                           const void* bias, void* out, int M, int N, int K, int group,
                           cudaStream_t stream) {
  switch (group) {
    case 32: return split_m<16, OutT>(x, packed, scales, bias, out, M, N, K, stream);
    case 64: return split_m<32, OutT>(x, packed, scales, bias, out, M, N, K, stream);
    case 128: return split_m<64, OutT>(x, packed, scales, bias, out, M, N, K, stream);
    case 256: return split_m<128, OutT>(x, packed, scales, bias, out, M, N, K, stream);
    default: return cudaErrorInvalidValue;
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

PQ_EXPORT int pq_wo4_split(const void* x, const void* packed, const void* scales,
                           const void* bias, void* out, int out_dtype, int M, int N, int K,
                           int group, void* stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  if (!wo4_shape_ok(K, group)) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (out_dtype) {
    case PQ_F32: return split_g<float>(x, packed, scales, bias, out, M, N, K, group, s);
    case PQ_BF16: return split_g<__nv_bfloat16>(x, packed, scales, bias, out, M, N, K, group, s);
    case PQ_F16: return split_g<__half>(x, packed, scales, bias, out, M, N, K, group, s);
    default: return cudaErrorInvalidValue;
  }
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
