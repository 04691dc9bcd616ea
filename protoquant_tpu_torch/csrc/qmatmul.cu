// int8 x int8 -> int32 GEMM with the fused f32 epilogue at prefill sizes:
// the tile kernel that ops/qmatmul.py routes every product of more than
// DECODE_MAX_M token rows to (prefill chunks, the MoE experts at prefill);
// fewer rows take qmatmul_decode.cu.
//
// Replaces protoquant_tpu/ops/qmatmul.py:_qmatmul_kernel (Pallas) at prefill
// M, with the contract of the plain version (core/numerics.py qmatmul_ref):
//   out[m, n] = cast((float(acc[m, n]) * s_x[m]) * s_w[n] + bias[n])
//   acc[m, n] = sum_k xq[m, k] * wq[n, k]            (exact int32)
// A = xq [M, K] and B = wq [N, K] are both row-major, K contiguous: the
// K-major operands 8-bit wgmma takes.
//
// Bound on the H100 (bytes M K + N K + 2 M N at 3.35 TB/s, or 2 M N K at
// 1979 TOP/s): bytes at M 80-256 (7B gate/up at M 256: 15.5 us, of which the
// products alone need 11.7 us), operations at M 512 (Gemma-2 gate/up: 26.6
// us). Either way the tensor cores must run near their rate, which only
// wgmma reaches, and each weight byte should leave device memory once.
// Design:
// - A block owns a BM x 128 output tile, BM = 128 or 256 rows (256 where
//   its tiles fill the card, so a 256-row chunk reads each weight byte once;
//   a chunk's row tiles sit side by side in the grid, so they read a weight
//   slab while it is in L2).
// - Warp specialised, 3 warp groups: a producer (one thread starts the
//   copies; setmaxnreg gives its registers away) and two consumers of
//   BM / 2 rows each. K runs in 128-byte steps: one TMA box of A (BM x 128)
//   and one of B (128 x 128) a step, with the 128-byte swizzle, into a ring
//   of 4 (BM 256) or 6 (BM 128) stages of dynamic shared memory guarded by
//   full and empty mbarriers. TMA fills the ragged M, N and K edges with
//   zeros, which add nothing to the sums.
// - A consumer runs wgmma m64n128k32 s8.s8 -> s32 from shared memory, 4 k32
//   steps a stage for each of its BM / 128 m64 tiles (accumulators: 64 or
//   128 registers a thread), keeps one group in flight and frees a stage
//   once the group that read it has completed. Every group multiplies at
//   every step, rows past M included (TMA's zeros): a branch around wgmma
//   makes ptxas serialise the products (C7518).
// - Where the tiles are fewer than one wave of blocks, the K steps are
//   split over the blocks of a thread block cluster (2 or 4, ops/qmatmul.py
//   qmatmul_tile_plan, which also picks the tile height: the plan with the
//   most blocks in one wave).
// - Epilogue: each consumer writes its fragments row-major into the drained
//   stage memory as the int32 tile (a warp storing straight from the
//   fragments writes 16-byte pieces of 8 rows); then block r of the cluster
//   sums the partials of the tile rows [r BM / CS, (r + 1) BM / CS) in rank
//   order through distributed shared memory, 16 bytes a load, and writes
//   them out a warp a row. A cluster barrier before and one after (no block
//   leaves while another reads its partial). The tile's s_x, s_w and bias
//   are staged in shared memory before the main loop, so the epilogue waits
//   on no global load (loading them per element cost 8 of 37 us at 7B
//   gate/up). int32 addition is associative, so any split gives the plain
//   version's bits; one launch, no workspace, nothing kept between calls
//   (capturable in a CUDA graph). The arithmetic is the plain version's:
//   __int2float_rn, __fmul_rn twice, __fadd_rn, never contracted into an FMA.

#include <cooperative_groups.h>

#include "sm90_gemm.cuh"

namespace cg = cooperative_groups;

constexpr int QT_BN = 128;       // output columns (weight rows) of a block
constexpr int QT_BK = 128;       // K bytes of a stage: one swizzle row
constexpr int QT_THREADS = 384;  // two consumer warp groups, then the producer
constexpr int QT_MAX_SPLITS = 4;
constexpr int QT_LDP = QT_BN + 8;  // int32 row stride of the staged tile: conflict-free

template <int MT>  // m64 tiles a consumer group: BM = 128 MT
struct QtShape {
  static constexpr int BM = 128 * MT;
  static constexpr int STAGES = MT == 2 ? 4 : 6;
  static constexpr int A_BYTES = BM * QT_BK;
  static constexpr int B_BYTES = QT_BN * QT_BK;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024;  // + room to align to 1024
  static_assert(BM * QT_LDP * 4 <= STAGES * STAGE_BYTES, "the int32 tile fits the stages");
};

__device__ __forceinline__ float qt_epilogue(int acc, float sxr, float swc, float bc,
                                             bool has_bias) {
  float y = __fmul_rn(__fmul_rn(__int2float_rn(acc), sxr), swc);
  if (has_bias) y = __fadd_rn(y, bc);
  return y;
}

// Columns col .. col + 3 of one output row (col a multiple of 4), as far as
// N goes: one aligned store where N % 4 == 0.
template <typename OutT>
__device__ __forceinline__ void qt_store4(OutT* __restrict__ out, int row, int col, int N,
                                          int4 a, float sxr, const float (&sw4)[4],
                                          const float (&b4)[4], bool has_bias) {
  const int acc[4] = {a.x, a.y, a.z, a.w};
  OutT* p = out + (size_t)row * N + col;
  if ((N & 3) == 0) {  // row * N + col a multiple of 4, and col + 3 < N
    struct alignas(4 * sizeof(OutT)) Quad { OutT v[4]; } q;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      q.v[e] = pq_from_float<OutT>(qt_epilogue(acc[e], sxr, sw4[e], b4[e], has_bias));
    *reinterpret_cast<Quad*>(p) = q;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (col + e < N)
        p[e] = pq_from_float<OutT>(qt_epilogue(acc[e], sxr, sw4[e], b4[e], has_bias));
  }
}

template <int MT, typename OutT>
__global__ void __launch_bounds__(QT_THREADS, 1)
qmatmul_tile_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b, const float* __restrict__ sx,
                    const float* __restrict__ sw, const float* __restrict__ bias,
                    OutT* __restrict__ out, int M, int N, int K) {
  using S = QtShape<MT>;
  extern __shared__ __align__(1024) uint8_t qt_smem_raw[];
  __shared__ __align__(8) uint64_t full[S::STAGES], empty[S::STAGES];
  __shared__ float sx_s[S::BM], sw_s[QT_BN], bias_s[QT_BN];  // the tile's scales and bias
  const uint32_t raw = sm90_smem_addr(qt_smem_raw);
  uint8_t* const smem = qt_smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint8_t* const As = smem;
  uint8_t* const Bs = smem + S::STAGES * S::A_BYTES;

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int m0 = (int)(blockIdx.x / cs) * S::BM, n0 = (int)blockIdx.y * QT_BN;
  const int steps = (K + QT_BK - 1) / QT_BK;
  const int k_lo = rank * steps / cs, k_hi = (rank + 1) * steps / cs;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival from each consumer group
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    // producer: one thread keeps the ring full
    regs_dealloc<40>();
    if (threadIdx.x == 256) {
      int s = 0;
      uint32_t ph = 0;
      for (int kt = k_lo; kt < k_hi; ++kt) {
        mbar_wait(&empty[s], ph ^ 1);
        mbar_arrive_expect_tx(&full[s], S::STAGE_BYTES);
        tma_load_2d(As + s * S::A_BYTES, &map_a, &full[s], kt * QT_BK, m0);
        tma_load_2d(Bs + s * S::B_BYTES, &map_b, &full[s], kt * QT_BK, n0);
        if (++s == S::STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    if (cs > 1) {  // the consumers' two cluster barriers
      cluster_barrier();
      cluster_barrier();
    }
  } else {
    // consumers: group wg owns rows [m0 + wg BM / 2, m0 + (wg + 1) BM / 2)
    regs_alloc<232>();
    const int t = threadIdx.x;
    // the tile's scales and bias, loaded now so the epilogue waits on none
    if (t < S::BM) sx_s[t] = m0 + t < M ? sx[m0 + t] : 0.0f;
    if (t < QT_BN) {
      sw_s[t] = n0 + t < N ? sw[n0 + t] : 0.0f;
      bias_s[t] = bias != nullptr && n0 + t < N ? bias[n0 + t] : 0.0f;
    }
    int acc[MT][64];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int r = 0; r < 64; ++r) acc[i][r] = 0;

    int s = 0, prev = 0;
    uint32_t ph = 0;
    for (int it = 0; it < k_hi - k_lo; ++it) {
      mbar_wait(&full[s], ph);
      const uint32_t a = sm90_smem_addr(As + s * S::A_BYTES + wg * MT * 64 * QT_BK);
      const uint32_t b = sm90_smem_addr(Bs + s * S::B_BYTES);
#pragma unroll
      for (int i = 0; i < MT; ++i) wgmma_fence_regs(acc[i]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < QT_BK / 32; ++kk)
#pragma unroll
        for (int i = 0; i < MT; ++i)
          wgmma_m64n128k32_s8(acc[i], wgmma_desc_sw128(a + i * 64 * QT_BK + kk * 32),
                              wgmma_desc_sw128(b + kk * 32));
      wgmma_commit();
      wgmma_wait<1>();  // the group before this one has read its stage
#pragma unroll
      for (int i = 0; i < MT; ++i) wgmma_fence_regs(acc[i]);
      if (it > 0 && (t & 127) == 0) mbar_arrive(&empty[prev]);
      prev = s;
      if (++s == S::STAGES) {
        s = 0;
        ph ^= 1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < MT; ++i) wgmma_fence_regs(acc[i]);

    // Thread (warp w of the group, lane l) holds acc[i][4 j + 2 h + e] of
    // tile row wg BM / 2 + 64 i + 16 w + l / 4 + 8 h, column 8 j + 2 (l % 4)
    // + e. The tile goes row-major into the drained stage memory, so the
    // output leaves in whole rows (the fragments alone would store 16-byte
    // pieces of 8 rows a warp).
    named_barrier(1, 256);  // both groups' products have drained the stages
    int* const part = reinterpret_cast<int*>(smem);
    const int w = (t >> 5) & 3, l = t & 31;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int* const prow = part + (wg * MT * 64 + 64 * i + 16 * w + (l >> 2) + 8 * h) * QT_LDP;
#pragma unroll
        for (int j = 0; j < QT_BN / 8; ++j)
          *reinterpret_cast<int2*>(prow + 8 * j + 2 * (l & 3)) =
              make_int2(acc[i][4 * j + 2 * h], acc[i][4 * j + 2 * h + 1]);
      }
    if (cs > 1)
      cluster_barrier();  // every block's partial written
    else
      named_barrier(1, 256);

    // Block r of the cluster sums the partials of the tile rows [r BM / cs,
    // (r + 1) BM / cs) in rank order and applies the epilogue, 4 columns a
    // thread, a warp a row.
    constexpr int CH = QT_BN / 4;
    const int lo = rank * (S::BM / cs) * CH, hi = (rank + 1) * (S::BM / cs) * CH;
    const int cl = (t % CH) * 4;  // the thread's columns, the same in every row it takes
    if (n0 + cl < N) {
      float sw4[4], b4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sw4[e] = sw_s[cl + e];
        b4[e] = bias_s[cl + e];
      }
#pragma unroll 4
      for (int idx = lo + t; idx < hi; idx += 256) {
        const int rl = idx / CH;
        if (m0 + rl >= M) break;
        int4 v;
        if (cs == 1) {
          v = *reinterpret_cast<const int4*>(part + rl * QT_LDP + cl);
        } else {
          v = make_int4(0, 0, 0, 0);
          for (int c = 0; c < cs; ++c) {
            const int4 q = *reinterpret_cast<const int4*>(cluster.map_shared_rank(part, c) +
                                                          rl * QT_LDP + cl);
            v.x += q.x;
            v.y += q.y;
            v.z += q.z;
            v.w += q.w;
          }
        }
        qt_store4(out, m0 + rl, n0 + cl, N, v, sx_s[rl], sw4, b4, bias != nullptr);
      }
    }
    if (cs > 1) cluster_barrier();  // no block leaves while another reads its partial
  }
}

template <int MT, typename OutT>
static cudaError_t qt_launch(const void* xq, const void* wq, const void* sx, const void* sw,
                             const void* bias, void* out, int M, int N, int K, int splits,
                             cudaStream_t stream) {
  using S = QtShape<MT>;
  CUtensorMap map_a, map_b;
  cudaError_t err = sm90_int8_map(&map_a, xq, M, K, S::BM);
  if (err == cudaSuccess) err = sm90_int8_map(&map_b, wq, N, K, QT_BN);
  auto kernel = qmatmul_tile_kernel<MT, OutT>;
  static bool smem_set = false;
  if (err == cudaSuccess) err = pq_allow_smem(kernel, S::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((M + S::BM - 1) / S::BM * splits),
                     (unsigned)((N + QT_BN - 1) / QT_BN));
  cfg.blockDim = dim3(QT_THREADS);
  cfg.dynamicSmemBytes = S::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, map_a, map_b, (const float*)sx, (const float*)sw,
                           (const float*)bias, (OutT*)out, M, N, K);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename OutT>
static cudaError_t qt_dispatch(const void* xq, const void* wq, const void* sx, const void* sw,
                               const void* bias, void* out, int M, int N, int K, int bm,
                               int splits, cudaStream_t st) {
  if (bm == 128) return qt_launch<1, OutT>(xq, wq, sx, sw, bias, out, M, N, K, splits, st);
  return qt_launch<2, OutT>(xq, wq, sx, sw, bias, out, M, N, K, splits, st);
}

// bm: the tile's rows, 128 or 256; k_splits: the cluster size, 1, 2 or 4
// and at most the 128-byte K steps (ops/qmatmul.py: qmatmul_tile_plan).
PQ_EXPORT int pq_qmatmul(const void* xq, const void* wq, const void* sx, const void* sw,
                         const void* bias, void* out, int out_dtype, int M, int N, int K, int bm,
                         int k_splits, void* stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  const int steps = (K + QT_BK - 1) / QT_BK;
  if (K <= 0 || K % 16 != 0 || (bm != 128 && bm != 256) || k_splits < 1 ||
      k_splits > QT_MAX_SPLITS || (k_splits & (k_splits - 1)) != 0 || k_splits > steps ||
      (uintptr_t)xq % 16 != 0 || (uintptr_t)wq % 16 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (out_dtype) {
    case PQ_F32: return qt_dispatch<float>(xq, wq, sx, sw, bias, out, M, N, K, bm, k_splits, s);
    case PQ_BF16:
      return qt_dispatch<__nv_bfloat16>(xq, wq, sx, sw, bias, out, M, N, K, bm, k_splits, s);
    case PQ_F16: return qt_dispatch<__half>(xq, wq, sx, sw, bias, out, M, N, K, bm, k_splits, s);
    default: return cudaErrorInvalidValue;
  }
}
