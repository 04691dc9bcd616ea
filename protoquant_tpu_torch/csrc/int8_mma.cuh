// The int8 split-K streaming product shared by qmatmul_decode.cu (B2 at
// decode M) and collective_matmul.cu (B19), and its reduction over a thread
// block cluster: int8 x int8 -> int32 through
// mma.sync.m16n8k32 (s8 x s8 -> s32) with the operands swapped, out^T =
// W x^T: 16 weight rows a warp on the MMA's 16-row side, MF fragments of 8
// tokens on its 8-column side.
// - At each 64-byte step of K thread (g, t) of a warp loads 16 bytes of its
//   weight rows g and g + 8 at byte 16 t (4 threads cover a row's 64 bytes,
//   whole sectors) straight into registers (ld.global.cs: read once, evict
//   first), and 16 bytes of each fragment's token row g at the same bytes
//   (ld.global.nc, through the L1 the block's warps share).
// - U steps make a group, whose loads are issued before the MMAs of the
//   group before it (two register buffers), so each warp keeps a group of
//   weight in flight all the time; QdStream lets a caller issue the first
//   group's loads early and work while they fly.
// - The MMA's k slots are a permutation of K: thread t feeds the slots
//   {4t..4t+3, 16+4t..16+4t+3} of both operands from bytes 16t..16t+7 of
//   the step (first MMA) and 16t+8..16t+15 (second), the same bytes on both
//   sides, so every product pairs the right k. K's ragged last step, rows
//   out of range and tokens past M load zeros, which add nothing.
// The accumulator of fragment f: c0, c1 at (weight row g, tokens 8f + 2t,
// 8f + 2t + 1), c2, c3 at weight row g + 8.
// - Reduction: each block of a cluster writes its int32 partial tile
//   [8 MF tokens][QD_ROWS weight rows] to shared memory (qd_partial); after
//   a cluster barrier each block sums a share of the tile over the
//   cluster's partials in rank order, 16 bytes at a time through
//   distributed shared memory (qd_sum_partials). int32 addition is exact,
//   so the sums do not depend on the split.
#pragma once

#include "common.cuh"

constexpr int QD_THREADS = 128;
constexpr int QD_ROWS = 16 * (QD_THREADS / 32);  // weight rows (outputs n) of a block
constexpr int QD_STEP = 64;                      // K bytes of a step
constexpr int QD_MAX_SPLITS = 8;                 // the portable cluster size

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

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

// The thread's share of the product over the 64-byte steps [s_lo, s_hi) of
// a K of k bytes, as a pipeline: start() takes w0, w1 (the thread's two
// weight rows) and xr[f] (fragment f's token row), each already at byte
// 16 t, and whether they exist, and issues the first group's loads;
// finish(acc) adds the product to acc (not zeroed here). A caller may work
// between the two while the loads fly. The row pointers move a group on
// with each group's loads (held as pointers, not rebuilt from the kernel's
// parameters at every load).
template <int MF>
struct QdStream {
  static constexpr int U = MF <= 2 ? 4 : MF == 4 ? 2 : 1;  // steps a group: two stay in registers
  int4 wa[2][U], wb[2][U], xa[2][U][MF];
  const int8_t *w0, *w1;  // at the next group's first step
  const int8_t* xr[MF];
  bool ok0, ok1, okx[MF];
  int s_lo, s_hi, k;

  // The group of steps s0.. (the group after the last one loaded).
  __device__ __forceinline__ void load(int buf, int s0) {
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = s0 + u;
      const bool in = s < s_hi && s * QD_STEP + 16 * t < k;
      wa[buf][u] = qd_load_w(w0 + u * QD_STEP, ok0 && in);
      wb[buf][u] = qd_load_w(w1 + u * QD_STEP, ok1 && in);
#pragma unroll
      for (int f = 0; f < MF; ++f) xa[buf][u][f] = qd_load_x(xr[f] + u * QD_STEP, okx[f] && in);
    }
    w0 += U * QD_STEP;
    w1 += U * QD_STEP;
#pragma unroll
    for (int f = 0; f < MF; ++f) xr[f] += U * QD_STEP;
  }

  __device__ __forceinline__ void mma(int (&acc)[MF][4], int buf) {
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int f = 0; f < MF; ++f) {
#ifdef PQ_QD_LOADS_ALONE  // an ablation: the loads kept live by an XOR, no MMA
        acc[f][0] ^= wa[buf][u].x ^ wb[buf][u].w ^ xa[buf][u][f].x ^ xa[buf][u][f].w;
#else
        qd_step(acc[f], wa[buf][u], wb[buf][u], xa[buf][u][f]);
#endif
      }
  }

  __device__ __forceinline__ void start(const int8_t* w0_, const int8_t* w1_, bool ok0_,
                                        bool ok1_, const int8_t* const (&xr_)[MF],
                                        const bool (&okx_)[MF], int s_lo_, int s_hi_, int k_) {
    const size_t off = (size_t)s_lo_ * QD_STEP;
    w0 = w0_ + off, w1 = w1_ + off, ok0 = ok0_, ok1 = ok1_;
    s_lo = s_lo_, s_hi = s_hi_, k = k_;
#pragma unroll
    for (int f = 0; f < MF; ++f) xr[f] = xr_[f] + off, okx[f] = okx_[f];
    if (s_lo < s_hi) load(0, s_lo);
  }

  __device__ __forceinline__ void finish(int (&acc)[MF][4]) {
    const int groups = (s_hi - s_lo + U - 1) / U;
    int gi = 0;
    for (; gi + 2 <= groups; gi += 2) {  // two groups an iteration: the buffers stay in registers
      load(1, s_lo + (gi + 1) * U);
      mma(acc, 0);
      if (gi + 2 < groups) load(0, s_lo + (gi + 2) * U);
      mma(acc, 1);
    }
    if (gi < groups) mma(acc, 0);
  }
};

// The block's int32 partial of `st`'s product (started, not finished) into
// part [8 MF tokens][QD_ROWS weight rows]. Every thread of the block calls
// it.
template <int MF, typename Stream>
__device__ __forceinline__ void qd_partial(Stream& st, int* part) {
  int acc[MF][4];
#pragma unroll
  for (int f = 0; f < MF; ++f)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[f][i] = 0;
  st.finish(acc);
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int nl = (threadIdx.x >> 5) * 16 + (lane >> 2);  // weight row g of the warp's 16
#pragma unroll
  for (int f = 0; f < MF; ++f) {
    part[(8 * f + 2 * t) * QD_ROWS + nl] = acc[f][0];
    part[(8 * f + 2 * t + 1) * QD_ROWS + nl] = acc[f][1];
    part[(8 * f + 2 * t) * QD_ROWS + nl + 8] = acc[f][2];
    part[(8 * f + 2 * t + 1) * QD_ROWS + nl + 8] = acc[f][3];
  }
}

// 16 bytes at `local` in the shared memory of cluster block `rank`.
__device__ __forceinline__ int4 ld_dsmem16(const int* local, unsigned rank) {
  unsigned a = (unsigned)__cvta_generic_to_shared(local), r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  int4 v;
  asm volatile("ld.shared::cluster.v4.s32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(r)
               : "memory");
  return v;
}

// Elements 4 v .. 4 v + 3 of the partial tile at `part` (16-byte aligned)
// summed over the cs blocks of the cluster in rank order, 16 bytes of every
// block's partial in flight at once. Call it after a cluster barrier that
// follows every block's qd_partial.
__device__ __forceinline__ int4 qd_sum_partials(const int* part, int v, int cs) {
  int4 pq[QD_MAX_SPLITS];
#pragma unroll
  for (int q = 0; q < QD_MAX_SPLITS; ++q)
    if (q < cs) pq[q] = ld_dsmem16(part + 4 * v, q);
  int4 sum = pq[0];
#pragma unroll
  for (int q = 1; q < QD_MAX_SPLITS; ++q)
    if (q < cs) {
      sum.x += pq[q].x;
      sum.y += pq[q].y;
      sum.z += pq[q].z;
      sum.w += pq[q].w;
    }
  return sum;
}
