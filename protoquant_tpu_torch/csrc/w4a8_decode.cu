// W4A8 two_level at decode sizes: the split-K kernel that
// ops/w4a8_matmul.py routes every two-level product of at most
// ops.wo4_matmul.INT4_DECODE_MAX_M token rows to; larger M (prefill chunks)
// takes w4a8_tile.cu's tile kernel.
//
// Replaces protoquant_tpu/ops/w4a8_matmul.py:_w4a8_2l_kernel (Pallas) at
// decode M, with w4a8_tile.cu's contract, bit for bit:
//   w8[n, k] = rint(code * r16[n, g])     (f32 multiply, half to even)
//   acc[m, n] = sum_k xq[m, k] * w8[n, k] (one exact int32 sum over K)
//   out = cast((f32(acc) * (s_x[m] * 0.0625)) * scol[n] + bias[n])
// int32 sums are exact in any order, so the split of K changes no bit; the
// epilogue runs once, on the full sum.
// Bound on the H100: bytes, the packed weight K N / 2 and r16's 4 N K / g
// read once beside a few KB of tokens and outputs (7.2 us at K 4096, N
// 11008, g 128). The tile kernel puts its 16 tokens on the MMA's 16-row
// side (12 of 16 rows idle at M = 4), runs N / 32 blocks (128 at N 4096),
// each walking all of K, and requantizes every code (a float add, multiply
// and add and four integer operations a code: ~12 us of integer issue at K
// 4096, N 11008, above the bytes).
// Design (int4_decode.cuh for the geometry, the split and the reduction):
// - Operands swapped: out^T = W x^T through mma.sync.m16n8k32 s8, the
//   weight's rows on the 16-row side, the tokens on the 8-column side.
// - The requant by table: for each (weight row, group) the 16 values
//   rint(c * r16), c = -8..7, with the arithmetic above, held as 16 bytes
//   in 4 registers (c = -8..-5, -4..-1, 0..3, 4..7). The threads of a quad
//   that share a group build a quarter or a half of it each and gather the
//   rest by shuffles (16 requants per group and row, not one per code).
//   Nibbles become int8 codes by prmt: the raw nibble n selects T[n] among
//   the entries of c >= 0 (n < 8), n ^ 8 selects among those of c < 0, and
//   a third prmt replicates bit 3 of each nibble into a byte mask that picks
//   one of the two (bit 3 of a prmt selector is its sign-replicate flag, not
//   an index: a 16-entry table takes two 8-entry lookups and a select).
// - The MMA's k slots are a permutation of K: a prmt over the low 16 bits
//   of a weight word yields the codes of its bytes' nibbles in the order
//   lo0, hi0, lo1, hi1 (k = j, j + g/2, j + 1, j + 1 + g/2), over the high
//   16 bits lo2, hi2, lo3, hi3; two prmt of the token words at the lo and
//   hi offsets give the tokens the same order.
// - Weight straight to registers: thread (g, t) loads 16 bytes of weight
//   rows g and g + 8 at byte 16 t of each 64-byte step (ld.global.cs),
//   their r16 entries, and 16 bytes of each token fragment's row at the lo
//   and the hi k of those bytes (ld.global.nc).
// One instance per group size (32, 64, 128, 256) and fragment count.

#include "int4_decode.cuh"

// Compile-time variants for ablations (tools/gemm_timing.py --ablate builds
// them apart; the library is built with 0): 1 requantizes every code as the
// tile kernel does (no table), 2 feeds the packed bytes to the MMA as they
// are (no table, no lookup), 3 also leaves the MMA out (loads alone).
#ifndef PQ_I4D_ABLATE
#define PQ_I4D_ABLATE 0
#endif

// The quarter (or half, or whole) of a (row, group)'s table that this
// thread builds, gathered across the threads of its quad that share the
// group: T[q] holds the entries c = 4q - 8 .. 4q - 5, one byte each.
template <int HALF>
__device__ __forceinline__ void w4d_table(float r, int t, int lane, uint32_t (&T)[4]) {
  constexpr int S = HALF >= 64 ? 4 : HALF / 16;  // threads of a quad sharing a group
  constexpr int W = 4 / S;                        // words each builds
  const int p = t & (S - 1), base = lane & ~(S - 1);
  uint32_t mine[W];
#pragma unroll
  for (int v = 0; v < W; ++v) {
    const int c0 = 4 * (p * W + v) - 8;
    uint32_t y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)  // rint(c * r) in the low byte, as int4_tile_sm90.cuh's i4t_requant
      y[e] = __float_as_uint(__fadd_rn(__fmul_rn(__int2float_rn(c0 + e), r), 12582912.0f));
    mine[v] = i4d_prmt(i4d_prmt(y[0], y[1], 0x0040), i4d_prmt(y[2], y[3], 0x0040), 0x5410);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
    T[q] = S == 1 ? mine[q % W] : __shfl_sync(I4D_FULL, mine[q % W], base + q / W);
}

// One weight word (4 bytes: 8 codes) -> its codes rint(c * r16) as int8:
// lo = [lo0, hi0, lo1, hi1], hi = [lo2, hi2, lo3, hi3].
__device__ __forceinline__ void w4d_lookup(const uint32_t (&T)[4], uint32_t w, uint32_t& lo,
                                           uint32_t& hi) {
  const uint32_t wx = w ^ 0x88888888u, sh = w << 4;
  const uint32_t pos0 = i4d_prmt(T[2], T[3], w), neg0 = i4d_prmt(T[0], T[1], wx);
  const uint32_t m0 = i4d_prmt(sh, w, 0xD9C8);  // bit 3 of nibbles 0-3 as byte masks
  lo = (pos0 & ~m0) | (neg0 & m0);
  const uint32_t pos1 = i4d_prmt(T[2], T[3], w >> 16), neg1 = i4d_prmt(T[0], T[1], wx >> 16);
  const uint32_t m1 = i4d_prmt(sh, w, 0xFBEA);  // nibbles 4-7
  hi = (pos1 & ~m1) | (neg1 & m1);
}

#if PQ_I4D_ABLATE == 1
// Four biased nibbles (code + 8) -> four int8 bytes rint(code * r), per code.
__device__ __forceinline__ uint32_t w4d_requant(uint32_t u, float r) {
  uint32_t w8 = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float code =
        __fadd_rn(__int_as_float(0x4B000000 | ((u >> (8 * i)) & 0xFFu)), -8388616.0f);
    const float y = __fadd_rn(__fmul_rn(code, r), 12582912.0f);
    w8 |= ((uint32_t)__float_as_int(y) & 0xFFu) << (8 * i);
  }
  return w8;
}
#endif

template <int MF, int U, int HALF>
__global__ void __launch_bounds__(I4D_THREADS)
w4a8_decode_kernel(const int8_t* __restrict__ X, const float* __restrict__ sx,
                   const int8_t* __restrict__ P, const float* __restrict__ R16,
                   const float* __restrict__ scol, const float* __restrict__ bias,
                   void* __restrict__ out, int out_dtype, int M, int N, int K) {
  __shared__ int Part[8 * MF][I4D_ROWS];  // the block's int32 partial [token][weight row]
  i4d_cg::cluster_group cluster = i4d_cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / cs;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int KB = K / 2, G = K / (2 * HALF);
  int s_lo, s_hi;
  i4d_slice<(HALF > I4D_STEP ? HALF / I4D_STEP : 1)>(KB, rank, cs, s_lo, s_hi);

  // the thread's two weight rows (and their r16 rows) and MF token rows
  const int r0 = tile * I4D_ROWS + warp * 16 + g, r1 = r0 + 8;
  const bool ok0 = r0 < N, ok1 = r1 < N;
  const int8_t* w0 = P + (size_t)(ok0 ? r0 : 0) * KB + 16 * t;
  const int8_t* w1 = P + (size_t)(ok1 ? r1 : 0) * KB + 16 * t;
  const float* q0 = R16 + (size_t)(ok0 ? r0 : 0) * G;
  const float* q1 = R16 + (size_t)(ok1 ? r1 : 0) * G;
  const int8_t* xr[MF];
  bool okx[MF];
#pragma unroll
  for (int f = 0; f < MF; ++f) {
    okx[f] = 8 * f + g < M;
    xr[f] = X + (size_t)(okx[f] ? 8 * f + g : 0) * K;
  }
  int acc[MF][4];
#pragma unroll
  for (int f = 0; f < MF; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[f][e] = 0;

  int4 wa[2][U], wb[2][U], xl[2][U][MF], xh[2][U][MF];
  float ra[2][U], rb[2][U];
  auto load = [&](int buf, int s0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = s0 + u, b = s * I4D_STEP + 16 * t;  // the thread's first packed byte
      const bool in = s < s_hi && b < KB;
      const int gi = b / HALF, klo = gi * 2 * HALF + b % HALF;  // its group and low k
      wa[buf][u] = i4d_load_w16(w0 + (size_t)s * I4D_STEP, ok0 && in);
      wb[buf][u] = i4d_load_w16(w1 + (size_t)s * I4D_STEP, ok1 && in);
      ra[buf][u] = ok0 && in ? __ldg(q0 + gi) : 0.0f;
      rb[buf][u] = ok1 && in ? __ldg(q1 + gi) : 0.0f;
#pragma unroll
      for (int f = 0; f < MF; ++f) {
        xl[buf][u][f] = i4d_load_x16(xr[f] + klo, okx[f] && in);
        xh[buf][u][f] = i4d_load_x16(xr[f] + klo + HALF, okx[f] && in);
      }
    }
  };
  auto compute = [&](int buf, int) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
#if PQ_I4D_ABLATE == 0
      uint32_t T0[4], T1[4];
      w4d_table<HALF>(ra[buf][u], t, lane, T0);
      w4d_table<HALF>(rb[buf][u], t, lane, T1);
#endif
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t w = (uint32_t)i4d_word(wa[buf][u], i);
        const uint32_t v = (uint32_t)i4d_word(wb[buf][u], i);
        uint32_t a[4];
#if PQ_I4D_ABLATE == 0
        w4d_lookup(T0, w, a[0], a[2]);
        w4d_lookup(T1, v, a[1], a[3]);
#elif PQ_I4D_ABLATE == 1
        uint32_t ulo, uhi;
        w4_biased_nibbles(w, ulo, uhi);
        a[0] = w4d_requant(ulo, ra[buf][u]);
        a[2] = w4d_requant(uhi, ra[buf][u]);
        w4_biased_nibbles(v, ulo, uhi);
        a[1] = w4d_requant(ulo, rb[buf][u]);
        a[3] = w4d_requant(uhi, rb[buf][u]);
#else
        a[0] = w; a[1] = v; a[2] = w >> 4; a[3] = v >> 4;
#endif
#pragma unroll
        for (int f = 0; f < MF; ++f) {
          const uint32_t xlo = (uint32_t)i4d_word(xl[buf][u][f], i);
          const uint32_t xhi = (uint32_t)i4d_word(xh[buf][u][f], i);
#if PQ_I4D_ABLATE == 0
          const uint32_t b[2] = {i4d_prmt(xlo, xhi, 0x5140), i4d_prmt(xlo, xhi, 0x7362)};
#else  // the tile kernel's order: low codes, then high codes
          const uint32_t b[2] = {xlo, xhi};
#endif
#if PQ_I4D_ABLATE == 3
          acc[f][0] ^= (int)(a[0] ^ a[1] ^ a[2] ^ a[3] ^ b[0] ^ b[1]);
#else
          w4_mma_s8(acc[f], a, b);
#endif
        }
      }
    }
  };
  i4d_walk<U>(s_lo, s_hi, load, compute);

  // c0, c1 at (weight row g, tokens 2t, 2t + 1); c2, c3 at weight row g + 8
  const int nl = warp * 16 + g;
#pragma unroll
  for (int f = 0; f < MF; ++f) {
    Part[8 * f + 2 * t][nl] = acc[f][0];
    Part[8 * f + 2 * t + 1][nl] = acc[f][1];
    Part[8 * f + 2 * t][nl + 8] = acc[f][2];
    Part[8 * f + 2 * t + 1][nl + 8] = acc[f][3];
  }
  i4d_reduce<MF>(Part, tile, M, N, [&](int m, int n, int sum) {
    float y = __fmul_rn(__fmul_rn(__int2float_rn(sum), __fmul_rn(sx[m], 0.0625f)), scol[n]);
    if (bias != nullptr) y = __fadd_rn(y, bias[n]);
    i4d_store(out, (size_t)m * N + n, y, out_dtype);
  });
}

// Steps a load group: two groups' loads in registers at once.
template <int MF>
constexpr int w4d_steps() { return MF <= 2 ? 2 : 1; }

template <int HALF>
static cudaError_t w4d_launch(const void* xq, const void* sx, const void* packed,
                              const void* r16, const void* scol, const void* bias, void* out,
                              int out_dtype, int M, int N, int K, int splits,
                              cudaStream_t st) {
  auto go = [&](auto kernel) {
    return i4d_launch(kernel, N, splits, st, (const int8_t*)xq, (const float*)sx,
                      (const int8_t*)packed, (const float*)r16, (const float*)scol,
                      (const float*)bias, out, out_dtype, M, N, K);
  };
  if (M <= 8) return go(&w4a8_decode_kernel<1, w4d_steps<1>(), HALF>);
  if (M <= 16) return go(&w4a8_decode_kernel<2, w4d_steps<2>(), HALF>);
  return go(&w4a8_decode_kernel<4, w4d_steps<4>(), HALF>);
}

// k_splits: the cluster size, 1 to 8 and at most the units of K
// (ops/wo4_matmul.py: int4_decode_plan).
PQ_EXPORT int pq_w4a8_two_level_decode(const void* xq, const void* sx, const void* packed,
                                       const void* r16, const void* scol, const void* bias,
                                       void* out, int out_dtype, int M, int N, int K, int group,
                                       int k_splits, void* stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  if (!i4d_args_ok(M, K, group, k_splits) || out_dtype < PQ_F32 || out_dtype > PQ_F16)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (group) {
    case 32: return w4d_launch<16>(xq, sx, packed, r16, scol, bias, out, out_dtype, M, N, K,
                                   k_splits, s);
    case 64: return w4d_launch<32>(xq, sx, packed, r16, scol, bias, out, out_dtype, M, N, K,
                                   k_splits, s);
    case 128: return w4d_launch<64>(xq, sx, packed, r16, scol, bias, out, out_dtype, M, N, K,
                                    k_splits, s);
    default: return w4d_launch<128>(xq, sx, packed, r16, scol, bias, out, out_dtype, M, N, K,
                                    k_splits, s);
  }
}

// The clusters of k_splits blocks of the instance for (M, group) that the
// card holds at once; launches nothing.
PQ_EXPORT int pq_w4a8_two_level_decode_clusters(int M, int group, int k_splits,
                                                int* clusters) {
  if (!i4d_args_ok(M, I4D_MAX_SPLITS * 2 * I4D_STEP * group, group, k_splits))
    return cudaErrorInvalidValue;
  auto ask = [&](auto kernel) { return i4d_max_clusters(kernel, k_splits, clusters); };
  const int mf = M <= 8 ? 1 : M <= 16 ? 2 : 4;
#define W4D_ASK(H)                                                          \
  return mf == 1   ? ask(&w4a8_decode_kernel<1, w4d_steps<1>(), H>)          \
         : mf == 2 ? ask(&w4a8_decode_kernel<2, w4d_steps<2>(), H>)          \
                   : ask(&w4a8_decode_kernel<4, w4d_steps<4>(), H>)
  switch (group) {
    case 32: W4D_ASK(16);
    case 64: W4D_ASK(32);
    case 128: W4D_ASK(64);
    default: W4D_ASK(128);
  }
#undef W4D_ASK
}
