// int8 x int8 -> int32 GEMM with the fused f32 epilogue at decode sizes: the
// split-K kernel that ops/qmatmul.py routes every product of at most
// DECODE_MAX_M token rows to; larger M (prefill chunks, MoE prefill) keeps
// qmatmul.cu's 64 x 64 tile kernel.
//
// Replaces protoquant_tpu/ops/qmatmul.py:_qmatmul_kernel (Pallas) at decode
// M, with qmatmul.cu's contract:
//   out[m, n] = cast((float(acc[m, n]) * s_x[m]) * s_w[n] + bias[n])
//   acc[m, n] = sum_k xq[m, k] * wq[n, k]            (exact int32)
// Bound on the H100: bytes, the weight's N K read once beside a few KB of
// tokens and outputs (13.5 us at K 4096, N 11008). The tile kernel puts
// N / 64 blocks on the card (64 at N 4096 against 132 SMs), each walking all
// of K with 8 KB of weight in flight, and spends 60 of its 64 A rows on
// nothing at M = 4.
// Design:
// - Operands swapped: out^T = W x^T through mma.sync.m16n8k32, the weight's
//   rows on the 16-row side (A: wq [N, K] row-major, as it lies), the tokens
//   on the 8-column side (B "col": xq [M, K] row-major), MF fragments of 8
//   tokens (MF = 1, 2, 4, 8 for M <= 8, 16, 32, 64).
// - A warp owns 16 weight rows, a block of 4 warps 64 (a tile); a thread
//   block cluster of CS blocks (1, 2, 4 or 8; ops/qmatmul.py picks it so
//   that the grid holds about 2.25 blocks an SM) splits K into CS slices of
//   whole 64-byte steps: block r of the cluster takes the steps [r steps /
//   CS, (r + 1) steps / CS).
// - No shared memory on the way in. At each 64-byte step thread (g, t)
//   loads 16 bytes of weight rows g and g + 8 at byte 16 t (4 threads cover
//   a row's 64 bytes, whole sectors) straight into registers (ld.global.cs:
//   read once, evict first), and 16 bytes of each fragment's token row g at
//   the same bytes (ld.global.nc, through the L1 the block's warps share);
//   U steps make a group, whose loads are issued before the MMAs of the
//   group before it (two register buffers), so each warp keeps a group of
//   weight in flight all the time, and the card's warps tens of KB an SM.
//   The MMA's k slots are a permutation of K: thread t feeds the slots {4t..4t+3,
//   16+4t..16+4t+3} of both operands from bytes 16t..16t+7 of the step
//   (first MMA) and 16t+8..16t+15 (second), the same bytes on both sides,
//   so every product pairs the right k. K's ragged last step, rows past N
//   and tokens past M load zeros.
// - Reduction: each block writes its int32 partial tile to shared memory;
//   after a cluster barrier, block r sums the CS partials of its 1 / CS of
//   the tile in rank order through distributed shared memory and applies the
//   epilogue; a second barrier keeps every block's shared memory alive until
//   it has been read. int32 addition is associative, so the bits are those
//   of the plain version in any order; no workspace, no atomics, one launch,
//   nothing kept between calls (capturable).
// - Epilogue as qmatmul.cu: __fmul_rn / __fadd_rn in the order (acc s_x)
//   s_w + bias, never contracted into an FMA.

#include <cooperative_groups.h>

#include "int8_mma.cuh"

namespace cg = cooperative_groups;

constexpr int QD_THREADS = 128;
constexpr int QD_ROWS = 16 * (QD_THREADS / 32);  // weight rows (outputs n) of a block
constexpr int QD_STEP = 64;                      // K bytes of a step
constexpr int QD_MAX_SPLITS = 8;                 // the portable cluster size
constexpr int QD_MAX_M = 64;

// 16 bytes of weight at p, read once (zeros where !ok).
__device__ __forceinline__ int4 qd_load_w(const int8_t* p, bool ok) {
  return ok ? __ldcs(reinterpret_cast<const int4*>(p)) : make_int4(0, 0, 0, 0);
}

// 16 bytes of tokens at p, shared by the block's warps (zeros where !ok).
__device__ __forceinline__ int4 qd_load_x(const int8_t* p, bool ok) {
  return ok ? __ldg(reinterpret_cast<const int4*>(p)) : make_int4(0, 0, 0, 0);
}

// One 64-byte step: two MMAs, bytes 0-7 and 8-15 of the thread's 16.
__device__ __forceinline__ void qd_step(int (&c)[4], const int4& w0, const int4& w1,
                                        const int4& x) {
  const uint32_t a0[4] = {(uint32_t)w0.x, (uint32_t)w1.x, (uint32_t)w0.y, (uint32_t)w1.y};
  const uint32_t b0[2] = {(uint32_t)x.x, (uint32_t)x.y};
  mma_s8(c, a0, b0);
  const uint32_t a1[4] = {(uint32_t)w0.z, (uint32_t)w1.z, (uint32_t)w0.w, (uint32_t)w1.w};
  const uint32_t b1[2] = {(uint32_t)x.z, (uint32_t)x.w};
  mma_s8(c, a1, b1);
}

template <int MF, int U, typename OutT>
__global__ void __launch_bounds__(QD_THREADS)
qmatmul_decode_kernel(const int8_t* __restrict__ X, const int8_t* __restrict__ W,
                      const float* __restrict__ sx, const float* __restrict__ sw,
                      const float* __restrict__ bias, OutT* __restrict__ out, int M, int N,
                      int K) {
  __shared__ int Part[8 * MF][QD_ROWS];  // the block's int32 partial [token][weight row]
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / cs;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int steps = (K + QD_STEP - 1) / QD_STEP;
  const int s_lo = (int)((long long)rank * steps / cs);
  const int s_hi = (int)((long long)(rank + 1) * steps / cs);

  // the thread's two weight rows and MF token rows, at byte 16 t of a step
  const int r0 = tile * QD_ROWS + warp * 16 + g, r1 = r0 + 8;
  const bool ok0 = r0 < N, ok1 = r1 < N;
  const int8_t* w0 = W + (size_t)(ok0 ? r0 : 0) * K + 16 * t;
  const int8_t* w1 = W + (size_t)(ok1 ? r1 : 0) * K + 16 * t;
  const int8_t* xr[MF];
  bool okx[MF];
#pragma unroll
  for (int f = 0; f < MF; ++f) {
    okx[f] = 8 * f + g < M;
    xr[f] = X + (size_t)(okx[f] ? 8 * f + g : 0) * K + 16 * t;
  }
  int acc[MF][4];
#pragma unroll
  for (int f = 0; f < MF; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[f][e] = 0;

  // U steps of loads a group, the next group's in flight while this one's
  // MMAs run (steps past the slice load zeros)
  int4 wa[2][U], wb[2][U], xa[2][U][MF];
  auto load = [&](int buf, int s0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = s0 + u;
      const size_t off = (size_t)s * QD_STEP;
      const bool in = s < s_hi && s * QD_STEP + 16 * t < K;
      wa[buf][u] = qd_load_w(w0 + off, ok0 && in);
      wb[buf][u] = qd_load_w(w1 + off, ok1 && in);
#pragma unroll
      for (int f = 0; f < MF; ++f) xa[buf][u][f] = qd_load_x(xr[f] + off, okx[f] && in);
    }
  };
  auto mma = [&](int buf) {
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int f = 0; f < MF; ++f) qd_step(acc[f], wa[buf][u], wb[buf][u], xa[buf][u][f]);
  };
  const int groups = (s_hi - s_lo + U - 1) / U;
  if (groups > 0) load(0, s_lo);
  int gi = 0;
  for (; gi + 2 <= groups; gi += 2) {  // two groups an iteration: the buffers stay in registers
    load(1, s_lo + (gi + 1) * U);
    mma(0);
    if (gi + 2 < groups) load(0, s_lo + (gi + 2) * U);
    mma(1);
  }
  if (gi < groups) mma(0);

  // c0, c1 at (weight row g, tokens 2t, 2t + 1); c2, c3 at weight row g + 8
  const int nl = warp * 16 + g;
#pragma unroll
  for (int f = 0; f < MF; ++f) {
    Part[8 * f + 2 * t][nl] = acc[f][0];
    Part[8 * f + 2 * t + 1][nl] = acc[f][1];
    Part[8 * f + 2 * t][nl + 8] = acc[f][2];
    Part[8 * f + 2 * t + 1][nl + 8] = acc[f][3];
  }
  cluster.sync();  // every block's partial written

  // block r's share of the tile: the partials of the cluster summed in rank
  // order, then the epilogue (outputs consecutive in n: coalesced stores)
  constexpr int E = 8 * MF * QD_ROWS;
  const int e0 = rank * E / cs, e1 = (rank + 1) * E / cs;
  for (int e = e0 + threadIdx.x; e < e1; e += QD_THREADS) {
    const int m = e / QD_ROWS, n = tile * QD_ROWS + e % QD_ROWS;
    if (m >= M || n >= N) continue;
    int sum = 0;
    for (int q = 0; q < cs; ++q) sum += cluster.map_shared_rank(&Part[0][0], q)[e];
    float y = __fmul_rn(__fmul_rn(__int2float_rn(sum), sx[m]), sw[n]);
    if (bias != nullptr) y = __fadd_rn(y, bias[n]);
    out[(size_t)m * N + n] = pq_from_float<OutT>(y);
  }
  cluster.sync();  // no block leaves while another reads its partial
}

template <int MF, typename OutT>
static cudaError_t qd_launch(const void* xq, const void* wq, const void* sx, const void* sw,
                             const void* bias, void* out, int M, int N, int K, int splits,
                             cudaStream_t stream) {
  constexpr int U = MF <= 2 ? 4 : MF == 4 ? 2 : 1;  // steps a group: two in registers
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((N + QD_ROWS - 1) / QD_ROWS) * splits);
  cfg.blockDim = dim3(QD_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, qmatmul_decode_kernel<MF, U, OutT>,
                                       (const int8_t*)xq, (const int8_t*)wq, (const float*)sx,
                                       (const float*)sw, (const float*)bias, (OutT*)out, M, N,
                                       K);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename OutT>
static cudaError_t qd_dispatch(const void* xq, const void* wq, const void* sx, const void* sw,
                               const void* bias, void* out, int M, int N, int K, int splits,
                               cudaStream_t st) {
  if (M <= 8) return qd_launch<1, OutT>(xq, wq, sx, sw, bias, out, M, N, K, splits, st);
  if (M <= 16) return qd_launch<2, OutT>(xq, wq, sx, sw, bias, out, M, N, K, splits, st);
  if (M <= 32) return qd_launch<4, OutT>(xq, wq, sx, sw, bias, out, M, N, K, splits, st);
  return qd_launch<8, OutT>(xq, wq, sx, sw, bias, out, M, N, K, splits, st);
}

// k_splits: the cluster size, 1, 2, 4 or 8 and at most the K steps
// (ops/qmatmul.py: qmatmul_decode_plan).
PQ_EXPORT int pq_qmatmul_decode(const void* xq, const void* wq, const void* sx, const void* sw,
                                const void* bias, void* out, int out_dtype, int M, int N, int K,
                                int k_splits, void* stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  const int steps = (K + QD_STEP - 1) / QD_STEP;
  if (K % 16 != 0 || K == 0 || M > QD_MAX_M || k_splits < 1 || k_splits > QD_MAX_SPLITS ||
      (k_splits & (k_splits - 1)) != 0 || k_splits > steps)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (out_dtype) {
    case PQ_F32: return qd_dispatch<float>(xq, wq, sx, sw, bias, out, M, N, K, k_splits, s);
    case PQ_BF16:
      return qd_dispatch<__nv_bfloat16>(xq, wq, sx, sw, bias, out, M, N, K, k_splits, s);
    case PQ_F16: return qd_dispatch<__half>(xq, wq, sx, sw, bias, out, M, N, K, k_splits, s);
    default: return cudaErrorInvalidValue;
  }
}
