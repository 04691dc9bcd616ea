// W4A8 group at decode sizes: the split-K kernel that ops/w4a8_matmul.py
// routes every group product of at most GROUP_DECODE_MAX_M token rows to;
// larger M (prefill chunks) takes w4a8_group_tile.cu's tile kernel.
//
// Replaces protoquant_tpu/ops/w4a8_matmul.py:_w4a8_kernel (Pallas) at decode
// M, bit for bit:
//   p[m, n, g] = sum over the group's k of xq[m, k] * code[n, k] (exact int32)
//   acc = acc + f32(p[m, n, g]) * s[n, g], over g = 0 .. G - 1 in order
//   out = cast(acc * s_x[m] + bias[n])
// every multiply and add __fmul_rn / __fadd_rn, never contracted into an FMA.
// The f32 chain runs over the groups in ascending order, so a K split whose
// f32 partials were summed afterwards would move bits; here the splits hand
// over each group's term f32(p) * s, rounded once as the plain version
// rounds it, and one chain of adds runs over all of them.
// Bound on the H100: bytes, the packed weight K N / 2 and the scales' 4 N K
// / g read once beside a few KB of tokens and outputs (7.2 us at K 4096, N
// 11008, g 128).
// Design (int4_decode.cuh for the geometry, the split and the launch):
// - Operands swapped: out^T = W x^T through mma.sync.m16n8k32 s8, the
//   weight's rows on the 16-row side, the tokens on the 8-column side.
// - An MMA sums one group: at g >= 128 a 64-byte step lies in one group
//   and thread (g, t) loads 16 bytes at byte 16 t; at g = 64 it loads 8
//   bytes at 8 t of each of the step's two groups, at g = 32 4 bytes at 4 t
//   of each of four (as wo4_decode.cu), so each weight word's MMA has all 32
//   k slots in one group (ld.global.cs).
// - Codes by the biased-nibble subtract of int4_tile.cuh (no table): a
//   word's low nibbles make the MMA's k slots 4t .. 4t + 3 beside the tokens
//   at the group's lo offset, its high nibbles k slots 16 + 4t .. beside the
//   tokens at the hi offset (ld.global.nc).
// - At a group's end each int32 accumulator becomes the group's term
//   __fmul_rn(f32(p), s[n, g]) (the thread's two scales loaded with its
//   weight bytes, a step ahead), which goes to the block's shared memory
//   [group][token][weight row]; the accumulators restart at 0. The block
//   keeps every group of its split, (units / splits) x (groups a unit) x 8
//   MF x 68 x 4 bytes (w4g_smem; the plan counts it, and the cluster query
//   asks for it).
// - After a cluster barrier block r takes its 1 / CS of the tile's outputs
//   (tokens [0, M) by 64 weight rows), a thread an output: the chain of
//   __fadd_rn over every group of K in order (the blocks in rank order,
//   each block's groups in order), reading each term from the block that
//   owns it through distributed shared memory (a warp reads 32 consecutive
//   weight rows of a group: one 128-byte row), 16 in flight; then the
//   epilogue. A second barrier keeps every block's terms alive until they
//   have been read. (Scales read in the chain, a warp's 32 rows 32 sectors
//   a read, made the chain a third of the kernel at M 4: PERF.md.)
// One instance per group size (32, 64, 128, 256) and fragment count.

#include "int4_decode.cuh"

// Compile-time variants for ablations (tools/gemm_timing.py --ablate builds
// them apart; the library is built with 0): 1 no group chain (one int32 sum
// over the block's split, as two_level's, times its last group's scale),
// 2 feeds the packed bytes to the MMA as they are (no conversion), 3 also
// leaves the MMA out (loads alone).
#ifndef PQ_I4D_ABLATE
#define PQ_I4D_ABLATE 0
#endif

constexpr int W4G_LDP = I4D_ROWS + 4;   // floats of a staged token row: no bank conflict
constexpr int W4G_SMEM = 227 * 1024;    // the most dynamic shared memory a block takes

// Groups a unit of K holds (int4_decode.cuh: max(64, g / 2) packed bytes).
__host__ __device__ constexpr int w4g_unit_groups(int half) {
  return half >= I4D_STEP ? 1 : I4D_STEP / half;
}

// Bytes of the group terms a block keeps: the most units a split of
// ``splits`` holds, times the groups a unit, times a group's terms (8 MF
// tokens by 64 weight rows, rows padded to W4G_LDP).
static int w4g_smem(int mf, int K, int group, int splits) {
  const int unit = group / 2 > I4D_STEP ? group / 2 : I4D_STEP;
  const int units = (K / 2 + unit - 1) / unit;
  return (units + splits - 1) / splits * w4g_unit_groups(group / 2) * 8 * mf * W4G_LDP * 4;
}

template <int MF, int U, int HALF>
__global__ void __launch_bounds__(I4D_THREADS)
w4a8_group_decode_kernel(const int8_t* __restrict__ X, const float* __restrict__ sx,
                         const int8_t* __restrict__ P, const float* __restrict__ S,
                         const float* __restrict__ bias, void* __restrict__ out, int out_dtype,
                         int M, int N, int K) {
  constexpr int HL = HALF < I4D_STEP ? HALF : I4D_STEP;  // bytes of a group inside a step
  constexpr int GPS = I4D_STEP / HL;                      // pieces (groups) a step: 1, 2, 4
  constexpr int PB = 16 / GPS;                            // bytes a thread loads a piece
  constexpr int WPP = PB / 4;                             // its words a piece
  constexpr int UNIT = HALF > I4D_STEP ? HALF / I4D_STEP : 1;  // steps a unit
  constexpr int SLAB = 8 * MF * W4G_LDP;                  // floats of one group's terms
  extern __shared__ __align__(16) float w4g_terms[];      // [group][token][weight row]
  i4d_cg::cluster_group cluster = i4d_cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / cs;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int KB = K / 2, G = K / (2 * HALF);
  int s_lo, s_hi;
  i4d_slice<UNIT>(KB, rank, cs, s_lo, s_hi);
  const int g_lo = s_lo * I4D_STEP / HALF;  // the block's groups [g_lo, g_hi)
  const int g_hi = min(G, s_hi * I4D_STEP / HALF);

  const int r0 = tile * I4D_ROWS + warp * 16 + g, r1 = r0 + 8;
  const bool ok0 = r0 < N, ok1 = r1 < N;
  const int8_t* w0 = P + (size_t)(ok0 ? r0 : 0) * KB + PB * t;
  const int8_t* w1 = P + (size_t)(ok1 ? r1 : 0) * KB + PB * t;
  const float* q0 = S + (size_t)(ok0 ? r0 : 0) * G;
  const float* q1 = S + (size_t)(ok1 ? r1 : 0) * G;
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

  // c0, c1 at (weight row g, tokens 2t, 2t + 1); c2, c3 at weight row g + 8
  const int nl = warp * 16 + g;
  // the accumulators as group ``slot``'s terms f32(p) * s, rows g and g + 8
  // scaled by s0 and s1
  auto stash = [&](int slot, float s0, float s1) {
    float* q = w4g_terms + slot * SLAB;
#pragma unroll
    for (int f = 0; f < MF; ++f) {
      q[(8 * f + 2 * t) * W4G_LDP + nl] = __fmul_rn(__int2float_rn(acc[f][0]), s0);
      q[(8 * f + 2 * t + 1) * W4G_LDP + nl] = __fmul_rn(__int2float_rn(acc[f][1]), s0);
      q[(8 * f + 2 * t) * W4G_LDP + nl + 8] = __fmul_rn(__int2float_rn(acc[f][2]), s1);
      q[(8 * f + 2 * t + 1) * W4G_LDP + nl + 8] = __fmul_rn(__int2float_rn(acc[f][3]), s1);
    }
  };

  // a step's weight words (word i in piece i / WPP), its pieces' scales,
  // and each fragment's tokens at the words' lo and hi k
  uint32_t wa[2][U][4], wb[2][U][4], xl[2][U][MF][4], xh[2][U][MF][4];
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
        // the piece's PB low codes' tokens: PB bytes at klo, the high codes'
        // at klo + HALF
        auto tokens = [&](uint32_t (&dst)[4], const int8_t* src, bool ox) {
          if constexpr (PB == 16) {
            const int4 v = i4d_load_x16(src, ox);
            dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
          } else if constexpr (PB == 8) {
            const int2 v = i4d_load_x8(src, ox);
            dst[2 * j] = v.x; dst[2 * j + 1] = v.y;
          } else {
            dst[j] = ox ? __ldg(reinterpret_cast<const unsigned*>(src)) : 0u;
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
      const int s = s0 + u;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t w = wa[buf][u][i], v = wb[buf][u][i];
        uint32_t a[4];
#if PQ_I4D_ABLATE == 2 || PQ_I4D_ABLATE == 3
        a[0] = w; a[1] = v; a[2] = w >> 4; a[3] = v >> 4;
#else
        uint32_t ulo, uhi;
        w4_biased_nibbles(w, ulo, uhi);
        a[0] = w4_codes_s8(ulo);
        a[2] = w4_codes_s8(uhi);
        w4_biased_nibbles(v, ulo, uhi);
        a[1] = w4_codes_s8(ulo);
        a[3] = w4_codes_s8(uhi);
#endif
#pragma unroll
        for (int f = 0; f < MF; ++f) {
          const uint32_t b[2] = {xl[buf][u][f][i], xh[buf][u][f][i]};
#if PQ_I4D_ABLATE == 3
          acc[f][0] ^= (int)(a[0] ^ a[1] ^ a[2] ^ a[3] ^ b[0] ^ b[1]);
#else
          w4_mma_s8(acc[f], a, b);
#endif
        }
#if PQ_I4D_ABLATE != 1
        // a piece's last word ends its group, but at g = 256, whose group
        // spans two steps, only on the odd step
        if (i % WPP == WPP - 1 && (HALF <= I4D_STEP || (s & 1))) {
          const int j = i / WPP, gi = (s * I4D_STEP + j * HL) / HALF;
          if (gi < g_hi) stash(gi - g_lo, sa[buf][u][j], sb[buf][u][j]);
#pragma unroll
          for (int f = 0; f < MF; ++f)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[f][e] = 0;
        }
#endif
      }
    }
  };
  i4d_walk<U>(s_lo, s_hi, load, compute);
#if PQ_I4D_ABLATE == 1
  stash(0, __ldg(q0 + g_hi - 1), __ldg(q1 + g_hi - 1));
#endif

  cluster.sync();  // every block's group terms written
  // Block r takes the outputs [r E / CS, (r + 1) E / CS) of the tile's E =
  // M x 64, a thread an output: the chain over every group of K in order.
  constexpr int BATCH = 16;  // terms in flight a thread
  const int units = ((KB + I4D_STEP - 1) / I4D_STEP + UNIT - 1) / UNIT;
  const int E = M * I4D_ROWS;
  const int e0 = rank * E / cs, e1 = (rank + 1) * E / cs;
  for (int e = e0 + threadIdx.x; e < e1; e += I4D_THREADS) {
    const int m = e / I4D_ROWS, el = e % I4D_ROWS, n = tile * I4D_ROWS + el;
    if (n >= N) continue;
    float y = 0.0f;
#if PQ_I4D_ABLATE == 1
    for (int q = 0; q < cs; ++q)
      y = __fadd_rn(y, cluster.map_shared_rank(w4g_terms, q)[m * W4G_LDP + el]);
#else
    for (int q = 0; q < cs; ++q) {
      // rank q's groups [ga, gb): its units [q units / cs, (q + 1) units / cs)
      const int ga = UNIT * (q * units / cs) * I4D_STEP / HALF;
      const int gb = min(G, UNIT * ((q + 1) * units / cs) * I4D_STEP / HALF);
      const float* src = cluster.map_shared_rank(w4g_terms, q) + m * W4G_LDP + el;
      for (int g0 = 0; g0 < gb - ga; g0 += BATCH) {
        float v[BATCH];
#pragma unroll
        for (int u = 0; u < BATCH; ++u)
          v[u] = g0 + u < gb - ga ? src[(g0 + u) * SLAB] : 0.0f;
#pragma unroll
        for (int u = 0; u < BATCH; ++u)
          if (g0 + u < gb - ga) y = __fadd_rn(y, v[u]);
      }
    }
#endif
    y = __fmul_rn(y, sx[m]);
    if (bias != nullptr) y = __fadd_rn(y, bias[n]);
    i4d_store(out, (size_t)m * N + n, y, out_dtype);
  }
  cluster.sync();  // no block leaves while another reads its terms
}

// Steps a load group: two groups' loads in registers at once.
template <int MF>
constexpr int w4g_steps() { return MF <= 2 ? 2 : 1; }

// Run ``fn(kernel)`` with the instance for (M, group) after letting it take
// up to W4G_SMEM bytes of dynamic shared memory (once per instance).
template <int MF, int HALF, typename Fn>
static cudaError_t w4g_with(Fn&& fn) {
  auto kernel = &w4a8_group_decode_kernel<MF, w4g_steps<MF>(), HALF>;
  static bool smem_set = false;
  const cudaError_t err = pq_allow_smem(kernel, W4G_SMEM, smem_set);
  return err != cudaSuccess ? err : fn(kernel);
}

template <typename Fn>
static cudaError_t w4g_dispatch(int M, int group, Fn&& fn) {
  const int mf = M <= 8 ? 1 : M <= 16 ? 2 : 4;
#define W4G_MF(H)                                              \
  return mf == 1 ? w4g_with<1, H>(fn) : mf == 2 ? w4g_with<2, H>(fn) : w4g_with<4, H>(fn)
  switch (group) {
    case 32: W4G_MF(16);
    case 64: W4G_MF(32);
    case 128: W4G_MF(64);
    default: W4G_MF(128);
  }
#undef W4G_MF
}

// k_splits: the cluster size, 1 to 8 and at most the units of K, whose group
// terms fit W4G_SMEM (ops/w4a8_matmul.py: group_decode_plan).
PQ_EXPORT int pq_w4a8_group_decode(const void* xq, const void* sx, const void* packed,
                                   const void* scales, const void* bias, void* out,
                                   int out_dtype, int M, int N, int K, int group, int k_splits,
                                   void* stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  if (!i4d_args_ok(M, K, group, k_splits) || out_dtype < PQ_F32 || out_dtype > PQ_F16)
    return cudaErrorInvalidValue;
  const int mf = M <= 8 ? 1 : M <= 16 ? 2 : 4;
  const int smem = w4g_smem(mf, K, group, k_splits);
  if (smem > W4G_SMEM) return cudaErrorInvalidValue;
  return w4g_dispatch(M, group, [&](auto kernel) {
    return i4d_launch_smem(kernel, N, k_splits, smem, (cudaStream_t)stream, (const int8_t*)xq,
                           (const float*)sx, (const int8_t*)packed, (const float*)scales,
                           (const float*)bias, out, out_dtype, M, N, K);
  });
}

// The clusters of k_splits blocks of the instance for (M, group), each with
// the group terms of K's splits in its shared memory, that the card holds at
// once; 0 where k_splits passes the units of K or the terms pass W4G_SMEM.
// Launches nothing.
PQ_EXPORT int pq_w4a8_group_decode_clusters(int M, int K, int group, int k_splits,
                                            int* clusters) {
  *clusters = 0;
  if (!i4d_args_ok(M, K, group, 1) || k_splits < 1 || k_splits > I4D_MAX_SPLITS)
    return cudaErrorInvalidValue;
  const int mf = M <= 8 ? 1 : M <= 16 ? 2 : 4;
  const int smem = w4g_smem(mf, K, group, k_splits);
  if (!i4d_args_ok(M, K, group, k_splits) || smem > W4G_SMEM) return cudaSuccess;
  return w4g_dispatch(M, group, [&](auto kernel) {
    return i4d_max_clusters(kernel, k_splits, clusters, smem);
  });
}
