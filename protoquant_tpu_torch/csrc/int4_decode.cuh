// Shared machinery of the int4-weight decode GEMMs (w4a8_decode.cu,
// w4a8_group_decode.cu, wo4_decode.cu; wo_decode.cu takes its geometry):
// out^T = W x^T for M <= 32 token rows, the packed weight [N, K/2]
// (int4_tile.cuh's layout: within each group of g codes, byte j of the
// group's g/2 bytes holds k = j in its low nibble, k = j + g/2 in its high
// nibble) loaded straight into registers, K split over the blocks of a
// thread block cluster at group boundaries and the partials summed through
// distributed shared memory.
//
// Geometry: a warp owns 16 weight rows (the MMA's 16-row side), a block of
// 4 warps 64 (a tile); the tokens sit on the MMA's 8-column side in MF
// fragments of 8 (MF = 1, 2, 4 for M <= 8, 16, 32). K is walked in steps of
// 64 packed bytes a weight row (128 codes), 16 bytes a thread: thread
// (g, t) of a warp loads its 16 bytes of weight rows g and g + 8 (the split
// body at g 32 and 64 in 4- or 8-byte pieces, one group each). A block of
// rank r in a cluster of CS (1 to 8) takes the units [r units / CS, (r + 1)
// units / CS), a unit being max(64, g / 2) packed bytes: whole steps and
// whole groups, so every split starts on a group boundary. U steps make a load
// group; the next group's loads are issued before the MMAs of this one
// (two register buffers), as in qmatmul_decode.cu. Weight rows past N,
// tokens past M and bytes past K / 2 load zeros.
#pragma once

#include <cooperative_groups.h>

#include "int4_tile.cuh"  // w4_mma_s8, w4_mma_bf16, w4_biased_nibbles, w4_codes_bf16

namespace i4d_cg = cooperative_groups;

constexpr int I4D_THREADS = 128;
constexpr int I4D_ROWS = 16 * (I4D_THREADS / 32);  // weight rows (outputs n) of a block
constexpr int I4D_STEP = 64;                       // packed bytes of a weight row a step
constexpr int I4D_MAX_SPLITS = 8;                  // the portable cluster size
constexpr int I4D_MAX_M = 32;
constexpr unsigned I4D_FULL = 0xffffffffu;

// 16 / 8 / 4 bytes of weight at p, read once (zeros where !ok).
__device__ __forceinline__ int4 i4d_load_w16(const int8_t* p, bool ok) {
  return ok ? __ldcs(reinterpret_cast<const int4*>(p)) : make_int4(0, 0, 0, 0);
}
__device__ __forceinline__ int2 i4d_load_w8(const int8_t* p, bool ok) {
  return ok ? __ldcs(reinterpret_cast<const int2*>(p)) : make_int2(0, 0);
}
__device__ __forceinline__ int i4d_load_w4(const int8_t* p, bool ok) {
  return ok ? __ldcs(reinterpret_cast<const int*>(p)) : 0;
}

// 16 / 8 bytes of tokens at p, shared by the block's warps (zeros where !ok).
__device__ __forceinline__ int4 i4d_load_x16(const void* p, bool ok) {
  return ok ? __ldg(reinterpret_cast<const int4*>(p)) : make_int4(0, 0, 0, 0);
}
__device__ __forceinline__ int2 i4d_load_x8(const void* p, bool ok) {
  return ok ? __ldg(reinterpret_cast<const int2*>(p)) : make_int2(0, 0);
}

// PTX prmt in its default mode: byte i of the result is byte (s_i & 7) of
// {a, b} (a's bytes 0-3, b's 4-7), or, where bit 3 of s's nibble i is set,
// that byte's sign bit replicated over all 8 bits. Only s's low 16 bits are
// read. (Written out: CUDA's __byte_perm documents 3-bit selectors.)
__device__ __forceinline__ uint32_t i4d_prmt(uint32_t a, uint32_t b, uint32_t s) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(s));
  return d;
}

__device__ __forceinline__ int i4d_word(const int4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The K walk of a split: the steps [s_lo, s_hi) in load groups of U steps,
// load(buf, s0) issuing the loads of the U steps from s0 into register
// buffer buf (0 or 1, a constant after inlining) and compute(buf, s0)
// consuming them; the next group's loads go out before this group's
// compute.
template <int U, typename Load, typename Compute>
__device__ __forceinline__ void i4d_walk(int s_lo, int s_hi, Load&& load, Compute&& compute) {
  const int groups = (s_hi - s_lo + U - 1) / U;
  if (groups > 0) load(0, s_lo);
  int gi = 0;
  for (; gi + 2 <= groups; gi += 2) {  // two groups an iteration: the buffers stay in registers
    load(1, s_lo + (gi + 1) * U);
    compute(0, s_lo + gi * U);
    if (gi + 2 < groups) load(0, s_lo + (gi + 2) * U);
    compute(1, s_lo + (gi + 1) * U);
  }
  if (gi < groups) compute(0, s_lo + gi * U);
}

// Split and unit bounds of block ``rank`` of ``cs``: the steps [s_lo, s_hi)
// it walks. UNIT steps make a unit (1, or 2 for g = 256).
template <int UNIT>
__device__ __forceinline__ void i4d_slice(int KB, int rank, int cs, int& s_lo, int& s_hi) {
  const int steps = (KB + I4D_STEP - 1) / I4D_STEP;
  const int units = (steps + UNIT - 1) / UNIT;
  s_lo = UNIT * (int)((long long)rank * units / cs);
  s_hi = min(steps, UNIT * (int)((long long)(rank + 1) * units / cs));
}

__device__ __forceinline__ void i4d_store(void* out, size_t i, float y, int out_dtype) {
  if (out_dtype == PQ_F32)
    static_cast<float*>(out)[i] = y;
  else if (out_dtype == PQ_BF16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(y);
  else
    static_cast<__half*>(out)[i] = __float2half_rn(y);
}

// The cluster's reduction and the epilogue: each block has written its
// partial tile Part [8 MF][I4D_ROWS] (token, weight row); after a cluster
// barrier block r sums, for its 1 / CS of the tile's elements, the CS
// partials in rank order through distributed shared memory, and hands the
// sum to epi(m, n, sum) for the output element (m, n); a second barrier
// keeps every block's partial alive until it has been read.
template <int MF, typename T, typename Epi>
__device__ __forceinline__ void i4d_reduce(T (*Part)[I4D_ROWS], int tile, int M, int N,
                                           Epi&& epi) {
  i4d_cg::cluster_group cluster = i4d_cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  cluster.sync();  // every block's partial written
  constexpr int E = 8 * MF * I4D_ROWS;
  const int e0 = rank * E / cs, e1 = (rank + 1) * E / cs;
  for (int e = e0 + threadIdx.x; e < e1; e += I4D_THREADS) {
    const int m = e / I4D_ROWS, n = tile * I4D_ROWS + e % I4D_ROWS;
    if (m >= M || n >= N) continue;
    T sum = cluster.map_shared_rank(&Part[0][0], 0)[e];
    for (int q = 1; q < cs; ++q) sum = sum + cluster.map_shared_rank(&Part[0][0], q)[e];
    epi(m, n, sum);
  }
  cluster.sync();  // no block leaves while another reads its partial
}

// Launch ``kernel`` over ceil(N / 64) tiles times ``splits`` blocks, in
// clusters of ``splits``, with ``smem`` bytes of dynamic shared memory.
template <typename Kernel, typename... Args>
static cudaError_t i4d_launch_smem(Kernel kernel, int N, int splits, int smem,
                                   cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((N + I4D_ROWS - 1) / I4D_ROWS) * splits);
  cfg.blockDim = dim3(I4D_THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename Kernel, typename... Args>
static cudaError_t i4d_launch(Kernel kernel, int N, int splits, cudaStream_t stream,
                              Args... args) {
  return i4d_launch_smem(kernel, N, splits, 0, stream, args...);
}

// The clusters of ``splits`` blocks of ``kernel``, each with ``smem`` bytes
// of dynamic shared memory, that the card holds at once
// (cudaOccupancyMaxActiveClusters), for the plan's tools.
template <typename Kernel>
static cudaError_t i4d_max_clusters(Kernel kernel, int splits, int* clusters, int smem = 0) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(splits * 64));
  cfg.blockDim = dim3(I4D_THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(clusters, reinterpret_cast<const void*>(kernel), &cfg);
}

// Checks common to both entries; k_splits: 1 to 8, at most the units.
static bool i4d_args_ok(int M, int K, int group, int k_splits) {
  if (!(group == 32 || group == 64 || group == 128 || group == 256) || K % group != 0 ||
      K == 0 || M > I4D_MAX_M || k_splits < 1 || k_splits > I4D_MAX_SPLITS)
    return false;
  const int unit = group / 2 > I4D_STEP ? group / 2 : I4D_STEP;
  const int units = (K / 2 + unit - 1) / unit;
  return k_splits <= units;
}
