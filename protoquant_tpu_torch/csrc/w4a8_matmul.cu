// W4A8: int8 activations times a group-wise int4 weight on the int8 tensor
// cores, the "group" body (the "two_level" body runs on w4a8_decode.cu and
// w4a8_tile.cu).
//
// Replaces protoquant_tpu/ops/w4a8_matmul.py:_w4a8_kernel (Pallas): an exact
// int32 dot per K-group, acc = acc + f32(p) * s[n, g] over the groups in
// ascending order; out = cast(acc * s_x + bias). It equals its plain version
// bit for bit: the integer sums are exact, and every epilogue multiply and
// add is __fmul_rn / __fadd_rn, never contracted into an FMA.
// Bound on the H100: bytes at decode (M = 4), the packed weight and its
// scales read once, K * N / 2 + 4 * N * K / 128 bytes (2.66 us at
// K = N = 4096). Design: the tiles of int4_tile.cuh, with mma.sync m16n8k32
// s8: the 4 bytes a thread reads from a weight row hold the 4 low-nibble
// codes of its B fragment's first register and the 4 high-nibble codes of
// its second, and its A registers read the same offsets of the lo and hi
// activation segments, so one 16-byte chunk of a weight row is one k32 step;
// nibbles become int8 codes by a per-byte subtract. One instance per group
// size (32, 64, 128, 256).

#include "int4_tile.cuh"

// A fragments of one k32 step at chunk c: lo offsets in a[0..1] of the
// m16n8k32 layout's k 0..15 half, hi offsets in its k 16..31 half.
template <typename T, int MT>
__device__ __forceinline__ void w4a8_a_frags(const unsigned char* As, int c, int g, int t,
                                             uint32_t (*a)[4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const unsigned char* r0 = As + (i * 16 + g) * T::AS + 16 * c + 4 * t;
    const unsigned char* r8 = r0 + 8 * T::AS;
    a[i][0] = *(const uint32_t*)r0;             // row g,     lo
    a[i][1] = *(const uint32_t*)r8;             // row g + 8, lo
    a[i][2] = *(const uint32_t*)(r0 + T::BB);   // row g,     hi
    a[i][3] = *(const uint32_t*)(r8 + T::BB);   // row g + 8, hi
  }
}

template <int MT, int NT, int BB, int STAGES, int HALF, typename OutT>
__global__ void __launch_bounds__(W4_THREADS)
w4a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
            const int8_t* __restrict__ packed, const float* __restrict__ table,
            const float* __restrict__ bias,
            OutT* __restrict__ out, int M, int N, int K) {
  using T = W4Tile<1, MT, NT, BB, STAGES, HALF>;
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wn = warp * 8 * NT;

  int p[MT][NT][4];      // the group's sum
  float acc[MT][NT][4];  // the scaled sum over groups
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[i][j][e] = 0;
        acc[i][j][e] = 0.0f;
      }

  w4_mainloop<T, 1, HALF, STAGES>(
      reinterpret_cast<const unsigned char*>(xq), packed, table, M, N, K, m0, n0,
      [&](const unsigned char* As, const unsigned char* Bs, const float* Ts, int c, int slot,
          bool group_end) {
        uint32_t a[MT][4];
        w4a8_a_frags<T, MT>(As, c, g, t, a);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int col = wn + j * 8 + g;  // this thread's B column in the tile
          const uint32_t w = *(const uint32_t*)(Bs + col * T::BS + 16 * c + 4 * t);
          uint32_t ulo, uhi, b[2];
          w4_biased_nibbles(w, ulo, uhi);
          b[0] = w4_codes_s8(ulo);
          b[1] = w4_codes_s8(uhi);
#pragma unroll
          for (int i = 0; i < MT; ++i) w4_mma_s8(p[i][j], a[i], b);
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
                acc[i][j][e] = __fadd_rn(acc[i][j][e],
                                         __fmul_rn(__int2float_rn(p[i][j][e]), (e & 1) ? s1 : s0));
                p[i][j][e] = 0;
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
      const float sxr = sx[row];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn + j * 8 + 2 * t + e;
          if (col >= N) continue;
          float y = __fmul_rn(acc[i][j][2 * hh + e], sxr);
          if (bias != nullptr) y = __fadd_rn(y, bias[col]);
          out[(size_t)row * N + col] = pq_from_float<OutT>(y);
        }
    }
}

template <int MT, int NT, int BB, int STAGES, int HALF, typename OutT>
static cudaError_t launch_t(const void* xq, const void* sx, const void* packed,
                            const void* scales, const void* bias, void* out, int M, int N, int K,
                            cudaStream_t stream) {
  static bool smem_set = false;
  return w4_launch<W4Tile<1, MT, NT, BB, STAGES, HALF>>(
      w4a8_kernel<MT, NT, BB, STAGES, HALF, OutT>, smem_set, M, N, stream, (const int8_t*)xq,
      (const float*)sx, (const int8_t*)packed, (const float*)scales, (const float*)bias,
      (OutT*)out, M, N, K);
}

template <int HALF, typename OutT>
static cudaError_t launch_m(const void* xq, const void* sx, const void* packed,
                            const void* scales, const void* bias, void* out, int M, int N, int K,
                            cudaStream_t stream) {
  if (M <= 16)
    return launch_t<1, 1, 128, 4, HALF, OutT>(xq, sx, packed, scales, bias, out, M, N, K, stream);
  return launch_t<4, 2, 64, 4, HALF, OutT>(xq, sx, packed, scales, bias, out, M, N, K, stream);
}

template <typename OutT>
static cudaError_t launch_g(const void* xq, const void* sx, const void* packed,
                            const void* scales, const void* bias, void* out, int M, int N, int K,
                            int group, cudaStream_t stream) {
  switch (group) {
    case 32: return launch_m<16, OutT>(xq, sx, packed, scales, bias, out, M, N, K, stream);
    case 64: return launch_m<32, OutT>(xq, sx, packed, scales, bias, out, M, N, K, stream);
    case 128: return launch_m<64, OutT>(xq, sx, packed, scales, bias, out, M, N, K, stream);
    case 256: return launch_m<128, OutT>(xq, sx, packed, scales, bias, out, M, N, K, stream);
    default: return cudaErrorInvalidValue;
  }
}

PQ_EXPORT int pq_w4a8_group(const void* xq, const void* sx, const void* packed,
                            const void* scales, const void* bias, void* out, int out_dtype,
                            int M, int N, int K, int group, void* stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  if (K % group != 0) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (out_dtype) {
    case PQ_F32:
      return launch_g<float>(xq, sx, packed, scales, bias, out, M, N, K, group, s);
    case PQ_BF16:
      return launch_g<__nv_bfloat16>(xq, sx, packed, scales, bias, out, M, N, K, group, s);
    case PQ_F16:
      return launch_g<__half>(xq, sx, packed, scales, bias, out, M, N, K, group, s);
    default: return cudaErrorInvalidValue;
  }
}
