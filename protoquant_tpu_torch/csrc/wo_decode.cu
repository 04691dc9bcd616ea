// Weight-only int8 GEMM at decode sizes: the split-K kernel that
// ops/wo_matmul.py routes every product of at most WO_DECODE_MAX_M token rows
// to; larger M (prefill chunks) takes wo_tile.cu's tile kernel.
//
// Replaces protoquant_tpu/ops/wo_matmul.py:_wo_kernel (Pallas) at decode M:
//   out[m, n] = cast((sum_k bf16(x)[m, k] * q[n, k]) * s_w[n] + bias[n])
// Every product of a bf16 and an int8 code is exact in f32 and summed in f32;
// the epilogue is a separate multiply and add (__fmul_rn, __fadd_rn, never an
// FMA). Here each split of K sums its own products, and the splits' sums are
// added in split order before the epilogue: only the order of the f32 sum
// moves, which ops.weight_only_tolerance allows. Two calls give the same bits.
// Bound on the H100: bytes, the int8 weight N K read once beside a few KB of
// tokens and outputs (13.5 us at K 4096, N 11008). The kernel this one
// replaced put one block of 4 warps on 32 output columns, each walking all
// of K with three 9 KB stages in flight: one block an SM at N 4096,
// latency-bound on its loads (3.7x the bound at K 11008).
// Design (int4_decode.cuh for the geometry, the walk and the reduction):
// - Operands swapped: out^T = W x^T through mma.sync.m16n8k16 bf16 with f32
//   accumulators, the weight's rows on the 16-row side, the tokens on the
//   8-column side in MF fragments of 8 (MF = 1, 2, 4 for M <= 8, 16, 32).
// - K in steps of 64 codes a weight row: thread (g, t) loads 16 bytes of
//   rows g and g + 8 at byte 16 t (ld.global.cs, whole sectors a quad) and
//   32 bytes of each fragment's token row g at the same k (ld.global.nc,
//   shared by the block's warps through L1), straight into registers; U
//   steps make a load group, the next group's loads issued before this
//   one's MMAs (two register buffers).
// - The MMA's k slots are a permutation of K: MMA j of a step takes the
//   thread's codes 16 t + 4 j .. 16 t + 4 j + 3, the first two in slots 2t,
//   2t + 1, the last two in 2t + 8, 2t + 9, on both operands (token words
//   2 j, 2 j + 1), so every product pairs the right k.
// - Each code becomes bf16 in registers (pq_int8_pair_bf16: a byte permute,
//   two ANDs and a bf16x2 subtract a pair, exact); no bf16 copy of W exists.
// - K split over a thread block cluster of 1 to 8 blocks (ops/wo_matmul.py
//   wo_decode_plan), whole steps a split; the f32 partials summed in rank
//   order through distributed shared memory, then s_w and the bias. One
//   launch, no workspace, capturable in a CUDA graph.
// Rows past N, tokens past M and steps past K or the split load zeros.

#include "int4_decode.cuh"

// Compile-time variants for ablations (tools/gemm_timing.py --wo --ablate
// builds them apart; the library is built with 0): 1 feeds the raw weight
// words to the MMA (no conversion), 2 also leaves the MMA out (loads alone),
// 3 loads nothing (the conversion and MMAs on zeros).
#ifndef PQ_WOD_ABLATE
#define PQ_WOD_ABLATE 0
#endif

template <int MF, int U>
__global__ void __launch_bounds__(I4D_THREADS)
wo_decode_kernel(const __nv_bfloat16* __restrict__ X, const int8_t* __restrict__ W,
                 const float* __restrict__ sw, const float* __restrict__ bias,
                 void* __restrict__ out, int out_dtype, int M, int N, int K) {
  __shared__ float Part[8 * MF][I4D_ROWS];  // the block's f32 partial [token][weight row]
  i4d_cg::cluster_group cluster = i4d_cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / cs;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  int s_lo, s_hi;
  i4d_slice<1>(K, rank, cs, s_lo, s_hi);  // steps of 64 codes (64 weight bytes)

  const int r0 = tile * I4D_ROWS + warp * 16 + g, r1 = r0 + 8;
  const bool ok0 = r0 < N, ok1 = r1 < N;
  const int8_t* w0 = W + (size_t)(ok0 ? r0 : 0) * K + 16 * t;
  const int8_t* w1 = W + (size_t)(ok1 ? r1 : 0) * K + 16 * t;
  const __nv_bfloat16* xr[MF];
  bool okx[MF];
#pragma unroll
  for (int f = 0; f < MF; ++f) {
    okx[f] = 8 * f + g < M;
    xr[f] = X + (size_t)(okx[f] ? 8 * f + g : 0) * K + 16 * t;
  }
  float acc[MF][4];
#pragma unroll
  for (int f = 0; f < MF; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[f][e] = 0.0f;

  // a step's 4 weight words of each row and 8 token words of each fragment
  uint32_t wa[2][U][4], wb[2][U][4], xs[2][U][MF][8];
  auto load = [&](int buf, int s0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = s0 + u;
      const size_t off = (size_t)s * I4D_STEP;
      // K % 16 == 0: the thread's 16 codes lie wholly before K or past it
      bool in = s < s_hi && s * I4D_STEP + 16 * t < K;
#if PQ_WOD_ABLATE == 3
      in = in && M < 0;  // never true, unknown to the compiler
#endif
      const int4 v0 = i4d_load_w16(w0 + off, ok0 && in), v1 = i4d_load_w16(w1 + off, ok1 && in);
      wa[buf][u][0] = v0.x; wa[buf][u][1] = v0.y; wa[buf][u][2] = v0.z; wa[buf][u][3] = v0.w;
      wb[buf][u][0] = v1.x; wb[buf][u][1] = v1.y; wb[buf][u][2] = v1.z; wb[buf][u][3] = v1.w;
#pragma unroll
      for (int f = 0; f < MF; ++f)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int4 v = i4d_load_x16(xr[f] + off + 8 * c, okx[f] && in);
          xs[buf][u][f][4 * c] = v.x; xs[buf][u][f][4 * c + 1] = v.y;
          xs[buf][u][f][4 * c + 2] = v.z; xs[buf][u][f][4 * c + 3] = v.w;
        }
    }
  };
  auto compute = [&](int buf, int) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t w = wa[buf][u][j], v = wb[buf][u][j];
        uint32_t a[4];
#if PQ_WOD_ABLATE == 1 || PQ_WOD_ABLATE == 2
        a[0] = w; a[1] = v; a[2] = w >> 16; a[3] = v >> 16;
#else
        a[0] = pq_int8_pair_bf16(w, 0x4140u);  // row g,     k 16t + 4j, + 1
        a[1] = pq_int8_pair_bf16(v, 0x4140u);  // row g + 8
        a[2] = pq_int8_pair_bf16(w, 0x4342u);  // row g,     k 16t + 4j + 2, + 3
        a[3] = pq_int8_pair_bf16(v, 0x4342u);  // row g + 8
#endif
#pragma unroll
        for (int f = 0; f < MF; ++f) {
          const uint32_t b[2] = {xs[buf][u][f][2 * j], xs[buf][u][f][2 * j + 1]};
#if PQ_WOD_ABLATE == 2
          acc[f][0] += __uint_as_float((a[0] ^ a[1] ^ a[2] ^ a[3] ^ b[0] ^ b[1]) & 0x3F000000u);
#else
          w4_mma_bf16(acc[f], a, b);
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
  i4d_reduce<MF>(Part, tile, M, N, [&](int m, int n, float sum) {
    float y = __fmul_rn(sum, sw[n]);
    if (bias != nullptr) y = __fadd_rn(y, bias[n]);
    i4d_store(out, (size_t)m * N + n, y, out_dtype);
  });
}

// Steps a load group: two groups' loads in registers at once.
template <int MF>
constexpr int wod_steps() { return MF == 1 ? 2 : 1; }

static bool wod_args_ok(int M, int K, int k_splits) {
  return K > 0 && K % 16 == 0 && M <= I4D_MAX_M && k_splits >= 1 &&
         k_splits <= I4D_MAX_SPLITS && k_splits <= (K + I4D_STEP - 1) / I4D_STEP;
}

// k_splits: the cluster size, 1 to 8 and at most the 64-code steps of K
// (ops/wo_matmul.py: wo_decode_plan).
PQ_EXPORT int pq_weight_only_decode(const void* x, const void* wq, const void* sw,
                                    const void* bias, void* out, int out_dtype, int M, int N,
                                    int K, int k_splits, void* stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  if (!wod_args_ok(M, K, k_splits) || out_dtype < PQ_F32 || out_dtype > PQ_F16 ||
      (uintptr_t)x % 16 != 0 || (uintptr_t)wq % 16 != 0)
    return cudaErrorInvalidValue;
  auto go = [&](auto kernel) {
    return i4d_launch(kernel, N, k_splits, (cudaStream_t)stream, (const __nv_bfloat16*)x,
                      (const int8_t*)wq, (const float*)sw, (const float*)bias, out, out_dtype,
                      M, N, K);
  };
  if (M <= 8) return go(&wo_decode_kernel<1, wod_steps<1>()>);
  if (M <= 16) return go(&wo_decode_kernel<2, wod_steps<2>()>);
  return go(&wo_decode_kernel<4, wod_steps<4>()>);
}

// The clusters of k_splits blocks of the instance for M that the card holds
// at once; launches nothing.
PQ_EXPORT int pq_weight_only_decode_clusters(int M, int k_splits, int* clusters) {
  if (!wod_args_ok(M, I4D_MAX_SPLITS * I4D_STEP, k_splits)) return cudaErrorInvalidValue;
  auto ask = [&](auto kernel) { return i4d_max_clusters(kernel, k_splits, clusters); };
  if (M <= 8) return ask(&wo_decode_kernel<1, wod_steps<1>()>);
  if (M <= 16) return ask(&wo_decode_kernel<2, wod_steps<2>()>);
  return ask(&wo_decode_kernel<4, wod_steps<4>()>);
}
