// int8 x int8 -> int32 GEMM with the fused f32 epilogue at decode sizes: the
// split-K kernel that ops/qmatmul.py routes every product of at most
// DECODE_MAX_M token rows to; larger M (prefill chunks, MoE prefill) takes
// qmatmul.cu's TMA + wgmma tile kernel.
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
// - No shared memory on the way in: int8_mma.cuh's QdStream loads the
//   weight straight into registers, U steps a group with the next group in
//   flight, so the card's warps keep tens of KB an SM of weight in flight.
// - Reduction (int8_mma.cuh: qd_partial, qd_sum_partials): each block
//   writes its int32 partial tile to shared memory; after a cluster barrier,
//   block r sums the CS partials of its 1 / CS of the tile in rank order, 16
//   bytes at a time through distributed shared memory, and applies the
//   epilogue; a second barrier keeps every block's shared memory alive until
//   it has been read. int32 addition is associative, so the bits are those
//   of the plain version in any order; no workspace, no atomics, one launch,
//   nothing kept between calls (capturable).
// - Epilogue as qmatmul.cu: __fmul_rn / __fadd_rn in the order (acc s_x)
//   s_w + bias, never contracted into an FMA.

#include <cooperative_groups.h>

#include "int8_mma.cuh"

namespace cg = cooperative_groups;

constexpr int QD_MAX_M = 64;

template <int MF, typename OutT>
__global__ void __launch_bounds__(QD_THREADS)
qmatmul_decode_kernel(const int8_t* __restrict__ X, const int8_t* __restrict__ W,
                      const float* __restrict__ sx, const float* __restrict__ sw,
                      const float* __restrict__ bias, OutT* __restrict__ out, int M, int N,
                      int K) {
  __shared__ __align__(16) int Part[8 * MF * QD_ROWS];  // the int32 partial [token][weight row]
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
  QdStream<MF> st;
  st.start(w0, w1, ok0, ok1, xr, okx, s_lo, s_hi, K);
  qd_partial<MF>(st, Part);
  cluster.sync();  // every block's partial written

  // block r's share of the tile, 4 outputs at a time: the partials of the
  // cluster summed in rank order, then the epilogue (consecutive threads,
  // consecutive outputs in n: coalesced stores)
  constexpr int V = 8 * MF * QD_ROWS / 4;
  const int v0 = rank * V / cs, v1 = (rank + 1) * V / cs;
  for (int v = v0 + threadIdx.x; v < v1; v += QD_THREADS) {
    const int m = 4 * v / QD_ROWS, n0 = tile * QD_ROWS + 4 * v % QD_ROWS;
    if (m >= M || n0 >= N) continue;
    const int4 q = qd_sum_partials(Part, v, cs);
    const int sum[4] = {q.x, q.y, q.z, q.w};
    const float sxm = sx[m];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + j;
      if (n >= N) break;
      float y = __fmul_rn(__fmul_rn(__int2float_rn(sum[j]), sxm), sw[n]);
      if (bias != nullptr) y = __fadd_rn(y, bias[n]);
      out[(size_t)m * N + n] = pq_from_float<OutT>(y);
    }
  }
  cluster.sync();  // no block leaves while another reads its partial
}

template <int MF, typename OutT>
static cudaError_t qd_launch(const void* xq, const void* wq, const void* sx, const void* sw,
                             const void* bias, void* out, int M, int N, int K, int splits,
                             cudaStream_t stream) {
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
  cudaError_t err = cudaLaunchKernelEx(&cfg, qmatmul_decode_kernel<MF, OutT>,
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
