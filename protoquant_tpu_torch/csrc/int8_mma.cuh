// The 64 x 64 int8 tile product shared by qmatmul.cu (B2) and
// collective_matmul.cu (B19): int8 x int8 -> int32 through
// mma.sync.m16n8k32 (s8 x s8 -> s32), a block of 4 warps each owning a
// 32 x 32 quarter, 64-deep K tiles staged in shared memory with cp.async and
// double buffered so the next tile loads while this one multiplies. Ragged
// M, N and K edges are zero-filled by cp.async (src-size 0), which adds
// nothing to the sums. The accumulator stays in registers.
#pragma once

#include "common.cuh"

constexpr int BM = 64, BN = 64, BK = 64;
constexpr int LDS = BK + 16;  // padded row stride (bytes): conflict-free fragment reads
constexpr int QM_THREADS = 128;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage one BM x BK tile of A and one BN x BK tile of B (16-byte chunks).
__device__ __forceinline__ void load_tile(int8_t (*As)[LDS], int8_t (*Bs)[LDS],
                                          const int8_t* A, const int8_t* B,
                                          int M, int N, int K, int m0, int n0, int k0) {
  constexpr int CHUNKS = BM * BK / 16;  // per operand; BM == BN
  for (int c = threadIdx.x; c < CHUNKS; c += QM_THREADS) {
    int r = c / (BK / 16), kc = (c % (BK / 16)) * 16;
    int k = k0 + kc;
    int gm = m0 + r, gn = n0 + r;
    bool pa = gm < M && k < K, pb = gn < N && k < K;
    // A clamped address keeps the pointer inside the tensor when pred is off
    cp_async16(&As[r][kc], A + (size_t)(pa ? gm : 0) * K + (pa ? k : 0), pa);
    cp_async16(&Bs[r][kc], B + (size_t)(pb ? gn : 0) * K + (pb ? k : 0), pb);
  }
}

// Thread (warp w, lane l) holds acc[i][j][2h + e] of row wm + 16i + g + 8h,
// column wn + 8j + 2t + e of the block's tile, with wm = (w >> 1) * 32,
// wn = (w & 1) * 32, g = l >> 2, t = l & 3 (the mma.sync fragment layout).
// acc = A[m0:m0+64, :] . B[n0:n0+64, :]^T over all of K; A is [M, K] and B
// is [N, K], both row-major. Every thread of the block calls it.
__device__ __forceinline__ void int8_tile_mma(int (&acc)[2][4][4], int8_t (*As)[BM][LDS],
                                              int8_t (*Bs)[BN][LDS], const int8_t* A,
                                              const int8_t* B, int M, int N, int K, int m0,
                                              int n0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int g = lane >> 2, t = lane & 3;

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int nk = (K + BK - 1) / BK;
  load_tile(As[0], Bs[0], A, B, M, N, K, m0, n0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      load_tile(As[cur ^ 1], Bs[cur ^ 1], A, B, M, N, K, m0, n0, (kt + 1) * BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm + i * 16 + g;
        af[i][0] = *(const uint32_t*)&As[cur][r][kk + 4 * t];
        af[i][1] = *(const uint32_t*)&As[cur][r + 8][kk + 4 * t];
        af[i][2] = *(const uint32_t*)&As[cur][r][kk + 16 + 4 * t];
        af[i][3] = *(const uint32_t*)&As[cur][r + 8][kk + 16 + 4 * t];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wn + j * 8 + g;
        bf[j][0] = *(const uint32_t*)&Bs[cur][c][kk + 4 * t];
        bf[j][1] = *(const uint32_t*)&Bs[cur][c][kk + 16 + 4 * t];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();
  }
}
