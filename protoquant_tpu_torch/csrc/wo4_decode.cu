// Weight-only int4 split at decode sizes: the split-K kernel that
// ops/wo4_matmul.py routes every split product of at most SPLIT_DECODE_MAX_M
// token rows to; larger M (prefill chunks) takes wo4_tile.cu's tile
// kernel.
//
// Replaces protoquant_tpu/ops/wo4_matmul.py:_wo4_split_kernel (Pallas) at
// decode M, with wo4_tile.cu's contract: x rounded to bf16; for each
// K-group g, p = x_g . q_g, summed in f32 from products exact in f32, then
// acc = acc + p * s[n, g] (__fmul_rn, __fadd_rn) over the groups in
// ascending order; out = cast(acc + bias). Here each split of K sums its
// groups so, and the splits' sums are added in split order: only the order
// of the same f32 sums moves, which ops.weight_only_int4_tolerance allows.
// Two calls give the same bits.
// Bound on the H100: bytes, the packed weight K N / 2 and the scales' 4 N K
// / g read once beside a few KB of tokens and outputs (7.2 us at K 4096, N
// 11008, g 128). The tile kernel puts its 16 tokens on the MMA's 16-row
// side (12 of 16 rows idle at M = 4) and runs N / 32 blocks (128 at N 4096),
// each walking all of K.
// Design (int4_decode.cuh for the geometry, the split and the reduction):
// - Operands swapped: out^T = W x^T through mma.sync.m16n8k16 bf16 with f32
//   accumulators, the weight's rows on the 16-row side, the tokens on the
//   8-column side; the two accumulators of a thread's weight row share its
//   scale s[n, g].
// - A group's sum needs every k slot of an MMA in one group: at g >= 128 a
//   64-byte step lies in one group and thread (g, t) loads 16 bytes at byte
//   16 t; at g = 64 (32 bytes a group) it loads 8 bytes at 8 t of each of
//   the step's two groups, at g = 32 4 bytes at 4 t of each of four. So a
//   thread's 4 words come in pieces, each inside one group, and the MMAs of
//   a piece sum one group (ld.global.cs, whole sectors a quad).
// - Codes as in int4_tile.cuh: a word's low and high nibbles become
//   two bf16 pairs each by a byte permute and one bf16x2 subtract, exact;
//   its low codes make one MMA with the tokens at the lo offsets, its high
//   codes another with the hi offsets (ld.global.nc).
// - One f32 group sum p a accumulator; at the group's end acc +=
//   __fmul_rn(p, s) by __fadd_rn, then p = 0; the splits' f32 partials are
//   summed in rank order through distributed shared memory, bias last.
// One instance per group size (32, 64, 128, 256) and fragment count.

#include "int4_decode.cuh"

// Compile-time variants for ablations (tools/gemm_timing.py --ablate builds
// them apart; the library is built with 0): 2 feeds the packed bytes to the
// MMA as they are (no conversion), 3 also leaves the MMA out (loads alone).
#ifndef PQ_I4D_ABLATE
#define PQ_I4D_ABLATE 0
#endif

// At one or two token fragments and g >= 128 the registers are capped so
// that 4 blocks fit an SM (a lm_head's 500 blocks in one wave).
template <int MF, int U, int HALF>
__global__ void __launch_bounds__(I4D_THREADS, MF <= 2 && HALF >= I4D_STEP ? 4 : 1)
wo4_decode_kernel(const __nv_bfloat16* __restrict__ X, const int8_t* __restrict__ P,
                  const float* __restrict__ S, const float* __restrict__ bias,
                  void* __restrict__ out, int out_dtype, int M, int N, int K) {
  constexpr int HL = HALF < I4D_STEP ? HALF : I4D_STEP;  // bytes of a group inside a step
  constexpr int GPS = I4D_STEP / HL;                      // pieces (groups) a step: 1, 2, 4
  constexpr int PB = 16 / GPS;                            // bytes a thread loads a piece
  constexpr int WPP = PB / 4;                             // its words a piece
  __shared__ float Part[8 * MF][I4D_ROWS];  // the block's f32 partial [token][weight row]
  i4d_cg::cluster_group cluster = i4d_cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / cs;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int KB = K / 2, G = K / (2 * HALF);
  int s_lo, s_hi;
  i4d_slice<(HALF > I4D_STEP ? HALF / I4D_STEP : 1)>(KB, rank, cs, s_lo, s_hi);

  const int r0 = tile * I4D_ROWS + warp * 16 + g, r1 = r0 + 8;
  const bool ok0 = r0 < N, ok1 = r1 < N;
  const int8_t* w0 = P + (size_t)(ok0 ? r0 : 0) * KB + PB * t;
  const int8_t* w1 = P + (size_t)(ok1 ? r1 : 0) * KB + PB * t;
  const float* q0 = S + (size_t)(ok0 ? r0 : 0) * G;
  const float* q1 = S + (size_t)(ok1 ? r1 : 0) * G;
  const __nv_bfloat16* xr[MF];
  bool okx[MF];
#pragma unroll
  for (int f = 0; f < MF; ++f) {
    okx[f] = 8 * f + g < M;
    xr[f] = X + (size_t)(okx[f] ? 8 * f + g : 0) * K;
  }
  float acc[MF][4], p[MF][4];
#pragma unroll
  for (int f = 0; f < MF; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[f][e] = p[f][e] = 0.0f;

  // a step's weight words (word i in piece i / WPP), its pieces' scales, and
  // each fragment's tokens at the words' lo and hi k (words 2i, 2i + 1 for
  // weight word i)
  uint32_t wa[2][U][4], wb[2][U][4], xl[2][U][MF][8], xh[2][U][MF][8];
  float sa[2][U][GPS], sb[2][U][GPS];
  auto load = [&](int buf, int s0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = s0 + u;
#pragma unroll
      for (int j = 0; j < GPS; ++j) {
        const int b = s * I4D_STEP + j * HL;  // the piece's first byte in its group's row
        const bool in = s < s_hi && b < KB;
        const int gi = b / HALF, klo = gi * 2 * HALF + b % HALF + PB * t;
        const size_t off = (size_t)s * I4D_STEP + j * HL;
        if constexpr (PB == 16) {
          const int4 v0 = i4d_load_w16(w0 + off, ok0 && in), v1 = i4d_load_w16(w1 + off, ok1 && in);
          wa[buf][u][0] = v0.x; wa[buf][u][1] = v0.y; wa[buf][u][2] = v0.z; wa[buf][u][3] = v0.w;
          wb[buf][u][0] = v1.x; wb[buf][u][1] = v1.y; wb[buf][u][2] = v1.z; wb[buf][u][3] = v1.w;
        } else if constexpr (PB == 8) {
          const int2 v0 = i4d_load_w8(w0 + off, ok0 && in), v1 = i4d_load_w8(w1 + off, ok1 && in);
          wa[buf][u][2 * j] = v0.x; wa[buf][u][2 * j + 1] = v0.y;
          wb[buf][u][2 * j] = v1.x; wb[buf][u][2 * j + 1] = v1.y;
        } else {
          wa[buf][u][j] = i4d_load_w4(w0 + off, ok0 && in);
          wb[buf][u][j] = i4d_load_w4(w1 + off, ok1 && in);
        }
        sa[buf][u][j] = ok0 && in ? __ldg(q0 + gi) : 0.0f;
        sb[buf][u][j] = ok1 && in ? __ldg(q1 + gi) : 0.0f;
        // the piece's PB low codes' tokens: 2 PB bytes of bf16 at klo, the
        // high codes' at klo + HALF
        auto tokens = [&](uint32_t (&dst)[8], const __nv_bfloat16* src, bool ox) {
          if constexpr (PB == 4) {
            const int2 v = i4d_load_x8(src, ox);
            dst[2 * j] = v.x; dst[2 * j + 1] = v.y;
          } else {
#pragma unroll
            for (int c = 0; c < PB / 8; ++c) {
              const int4 v = i4d_load_x16(src + 8 * c, ox);
              const int q = 4 * (j * (PB / 8) + c);
              dst[q] = v.x; dst[q + 1] = v.y; dst[q + 2] = v.z; dst[q + 3] = v.w;
            }
          }
        };
#pragma unroll
        for (int f = 0; f < MF; ++f) {
          tokens(xl[buf][u][f], xr[f] + klo, okx[f] && in);
          tokens(xh[buf][u][f], xr[f] + klo + HALF, okx[f] && in);
        }
      }
    }
  };
  auto compute = [&](int buf, int s0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t w = wa[buf][u][i], v = wb[buf][u][i];
        uint32_t alo[4], ahi[4];
#if PQ_I4D_ABLATE == 0
        uint32_t ulo, uhi, lo0[2], hi0[2], lo1[2], hi1[2];
        w4_biased_nibbles(w, ulo, uhi);
        w4_codes_bf16(ulo, lo0);
        w4_codes_bf16(uhi, hi0);
        w4_biased_nibbles(v, ulo, uhi);
        w4_codes_bf16(ulo, lo1);
        w4_codes_bf16(uhi, hi1);
        alo[0] = lo0[0]; alo[1] = lo1[0]; alo[2] = lo0[1]; alo[3] = lo1[1];
        ahi[0] = hi0[0]; ahi[1] = hi1[0]; ahi[2] = hi0[1]; ahi[3] = hi1[1];
#else
        alo[0] = w; alo[1] = v; alo[2] = w >> 8; alo[3] = v >> 8;
        ahi[0] = w >> 4; ahi[1] = v >> 4; ahi[2] = w >> 12; ahi[3] = v >> 12;
#endif
#pragma unroll
        for (int f = 0; f < MF; ++f) {
          const uint32_t blo[2] = {xl[buf][u][f][2 * i], xl[buf][u][f][2 * i + 1]};
          const uint32_t bhi[2] = {xh[buf][u][f][2 * i], xh[buf][u][f][2 * i + 1]};
#if PQ_I4D_ABLATE == 3
          p[f][0] += __uint_as_float((alo[0] ^ alo[1] ^ ahi[2] ^ ahi[3] ^ blo[0] ^ bhi[1]) &
                                     0x3F000000u);
#else
          w4_mma_bf16(p[f], alo, blo);
          w4_mma_bf16(p[f], ahi, bhi);
#endif
        }
        // a piece's last word ends its group, but at g = 256, whose group
        // spans two steps, only on the odd step
        const int j = i / WPP;
        if (i % WPP == WPP - 1 && (HALF <= I4D_STEP || ((s0 + u) & 1))) {
#pragma unroll
          for (int f = 0; f < MF; ++f)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[f][e] = __fadd_rn(acc[f][e],
                                    __fmul_rn(p[f][e], e < 2 ? sa[buf][u][j] : sb[buf][u][j]));
              p[f][e] = 0.0f;
            }
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
  i4d_reduce<MF>(Part, tile, M, N, [&](int m, int n, float sum) {
    const float y = bias != nullptr ? __fadd_rn(sum, bias[n]) : sum;
    i4d_store(out, (size_t)m * N + n, y, out_dtype);
  });
}

// Steps a load group: two groups' loads in registers at once.
template <int MF>
constexpr int wo4d_steps() { return MF == 1 ? 2 : 1; }

template <int HALF>
static cudaError_t wo4d_launch(const void* x, const void* packed, const void* scales,
                               const void* bias, void* out, int out_dtype, int M, int N, int K,
                               int splits, cudaStream_t st) {
  auto go = [&](auto kernel) {
    return i4d_launch(kernel, N, splits, st, (const __nv_bfloat16*)x, (const int8_t*)packed,
                      (const float*)scales, (const float*)bias, out, out_dtype, M, N, K);
  };
  if (M <= 8) return go(&wo4_decode_kernel<1, wo4d_steps<1>(), HALF>);
  if (M <= 16) return go(&wo4_decode_kernel<2, wo4d_steps<2>(), HALF>);
  return go(&wo4_decode_kernel<4, wo4d_steps<4>(), HALF>);
}

// k_splits: the cluster size, 1 to 8 and at most the units of K
// (ops/wo4_matmul.py: int4_decode_plan).
PQ_EXPORT int pq_wo4_split_decode(const void* x, const void* packed, const void* scales,
                                  const void* bias, void* out, int out_dtype, int M, int N,
                                  int K, int group, int k_splits, void* stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  if (!i4d_args_ok(M, K, group, k_splits) || out_dtype < PQ_F32 || out_dtype > PQ_F16)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (group) {
    case 32: return wo4d_launch<16>(x, packed, scales, bias, out, out_dtype, M, N, K, k_splits, s);
    case 64: return wo4d_launch<32>(x, packed, scales, bias, out, out_dtype, M, N, K, k_splits, s);
    case 128:
      return wo4d_launch<64>(x, packed, scales, bias, out, out_dtype, M, N, K, k_splits, s);
    default:
      return wo4d_launch<128>(x, packed, scales, bias, out, out_dtype, M, N, K, k_splits, s);
  }
}

// The clusters of k_splits blocks of the instance for (M, group) that the
// card holds at once; launches nothing.
PQ_EXPORT int pq_wo4_split_decode_clusters(int M, int group, int k_splits, int* clusters) {
  if (!i4d_args_ok(M, I4D_MAX_SPLITS * 2 * I4D_STEP * group, group, k_splits))
    return cudaErrorInvalidValue;
  auto ask = [&](auto kernel) { return i4d_max_clusters(kernel, k_splits, clusters); };
  const int mf = M <= 8 ? 1 : M <= 16 ? 2 : 4;
#define WO4D_ASK(H)                                                         \
  return mf == 1   ? ask(&wo4_decode_kernel<1, wo4d_steps<1>(), H>)          \
         : mf == 2 ? ask(&wo4_decode_kernel<2, wo4d_steps<2>(), H>)          \
                   : ask(&wo4_decode_kernel<4, wo4d_steps<4>(), H>)
  switch (group) {
    case 32: WO4D_ASK(16);
    case 64: WO4D_ASK(32);
    case 128: WO4D_ASK(64);
    default: WO4D_ASK(128);
  }
#undef WO4D_ASK
}
