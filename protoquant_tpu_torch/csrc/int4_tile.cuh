// Shared tile machinery of the mma.sync int4-weight GEMMs (w4a8_matmul.cu's
// group body; int4_decode.cuh and int4_tile_sm90.cuh take its nibble and
// MMA helpers): activations A [M, K] (bf16 or int8, row-major) times a
// weight packed two codes per byte along K, B [N, K/2] int8, with one f32
// value per (output channel, K-group) in a table T [N, G] (the group scales,
// or the two-level r16).
//
// Packing (core/numerics.py pack_int4): within each group of g codes, byte j
// of the group's g/2 bytes holds k = j in its low nibble and k = j + g/2 in
// its high nibble. A stage covers BB consecutive packed bytes of each
// weight row, 2 * BB values of K: for each byte b the activation tile
// holds the element of its low k in segment "lo" and of its high k in
// segment "hi", at the same offset. So 4 bytes of a weight row give a
// thread the B fragments of two K steps (low nibbles, high nibbles), whose
// A fragments are the same 4 offsets of lo and hi: no shuffle of nibbles
// between threads. The half group HALF = g / 2 is a template parameter (g =
// 32, 64, 128 or 256, which the wrappers check), so the byte-to-k map, the
// table slot of each 16-byte chunk and the group ends fold to constants;
// any number of groups (86 at K = 11008) works. Nothing past M, N, K/2 or G
// is loaded: a stale activation row or weight row only reaches an output
// row or column that is not stored, and chunks past K/2 are not computed.
#pragma once

#include "common.cuh"

constexpr int W4_THREADS = 128;

__device__ __forceinline__ void w4_cp_async16(void* smem, const void* gmem) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void w4_cp_async4(void* smem, const void* gmem) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void w4_cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void w4_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// EA: bytes of one activation element (2 bf16, 1 int8). A block of 4 warps
// owns a BM x BN output tile; each warp owns BN / 4 columns over all BM rows.
// BB: packed bytes of a weight row per stage (64 or 128).
template <int EA, int MT, int NT, int BB_, int STAGES, int HALF>
struct W4Tile {
  static_assert(HALF % 16 == 0 && (HALF & (HALF - 1)) == 0, "half group: 16, 32, 64, 128");
  static_assert(BB_ == 64 || BB_ == 128, "stage depth: 64 or 128 bytes");
  static constexpr int BM = 16 * MT, BN = 32 * NT, BB = BB_;
  // activation row: lo | hi segments, padded so fragment reads are
  // conflict-free (bf16 288 or 544 bytes, int8 144 or 272)
  static constexpr int AS = 2 * BB * EA + (EA == 2 ? 32 : 16);
  static constexpr int BS = BB + 16;  // weight row stride (bytes)
  static constexpr int NGS = HALF < BB ? BB / HALF : 1;  // groups a stage touches
  static constexpr int A_BYTES = BM * AS, B_BYTES = BN * BS;
  static constexpr int T_BYTES = NGS * BN * 4;  // [slot][column] f32
  static constexpr int STAGE = A_BYTES + B_BYTES + T_BYTES;
  static constexpr int SMEM = STAGE * STAGES;
};

// Stage the packed bytes [b0, b0 + BB) of the tile's weight rows, the
// matching lo / hi activations, and the table entries of the groups the
// stage touches.
template <typename T, int EA, int HALF>
__device__ __forceinline__ void w4_load_stage(unsigned char* st, const unsigned char* a,
                                              const int8_t* packed, const float* table,
                                              int M, int N, int K, int G, int m0, int n0,
                                              int b0) {
  constexpr int EPC = 16 / EA;       // elements per 16-byte chunk
  constexpr int BB = T::BB;
  constexpr int CPS = BB / EPC;      // chunks per segment
  const int KB = K / 2;
  unsigned char* As = st;
  unsigned char* Bs = st + T::A_BYTES;
  unsigned char* Ts = Bs + T::B_BYTES;
#pragma unroll
  for (int c = threadIdx.x; c < T::BM * 2 * CPS; c += W4_THREADS) {
    const int r = c / (2 * CPS), rem = c % (2 * CPS);
    const int seg = rem / CPS, q = rem % CPS;
    const int b = b0 + q * EPC;
    if (m0 + r >= M || b >= KB) continue;
    const int k = (b / HALF) * 2 * HALF + b % HALF + seg * HALF;
    w4_cp_async16(As + r * T::AS + (seg * BB + q * EPC) * EA,
                  a + ((size_t)(m0 + r) * K + k) * EA);
  }
#pragma unroll
  for (int c = threadIdx.x; c < T::BN * (BB / 16); c += W4_THREADS) {
    const int r = c / (BB / 16), b = b0 + (c % (BB / 16)) * 16;
    if (n0 + r >= N || b >= KB) continue;
    w4_cp_async16(Bs + r * T::BS + (b - b0), packed + (size_t)(n0 + r) * KB + b);
  }
  const int gi0 = b0 / HALF;
#pragma unroll
  for (int c = threadIdx.x; c < T::NGS * T::BN; c += W4_THREADS) {
    const int s = c / T::BN, r = c % T::BN;
    if (n0 + r >= N || gi0 + s >= G) continue;
    w4_cp_async4(Ts + c * 4, table + (size_t)(n0 + r) * G + gi0 + s);
  }
}

// 4 bytes of a weight row -> each byte's low (lo) and high (hi) nibble as
// code + 8, one per byte (0 .. 15).
__device__ __forceinline__ void w4_biased_nibbles(uint32_t w, uint32_t& lo, uint32_t& hi) {
  lo = (w & 0x0F0F0F0Fu) ^ 0x08080808u;
  hi = ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
}

// Four biased nibbles -> their codes as int8 bytes (exact).
__device__ __forceinline__ uint32_t w4_codes_s8(uint32_t u) { return __vsub4(u, 0x08080808u); }

// Four biased nibbles -> two bf16 pairs of their codes (exact): the bf16 of
// bits 0x43 << 8 | u is 128 + u, and 128 + u - 136 is the code.
__device__ __forceinline__ void w4_codes_bf16(uint32_t u, uint32_t* b) {
  const __nv_bfloat162 off = __floats2bfloat162_rn(136.0f, 136.0f);
  uint32_t v0 = __byte_perm(u, 0x43u, 0x4140);  // bytes 0, 1
  uint32_t v1 = __byte_perm(u, 0x43u, 0x4342);  // bytes 2, 3
  __nv_bfloat162 r0 = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v0), off);
  __nv_bfloat162 r1 = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v1), off);
  b[0] = *reinterpret_cast<uint32_t*>(&r0);
  b[1] = *reinterpret_cast<uint32_t*>(&r1);
}

__device__ __forceinline__ void w4_mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void w4_mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The pipelined K loop of a tile: stages of T::BB packed bytes, STAGES - 1
// in flight through cp.async. For each 16-byte chunk c of a stage (inside
// K/2) it calls chunk(As, Bs, Ts, c, slot, group_end): As / Bs / Ts the
// stage's activation, weight and table tiles, slot the chunk's group in Ts,
// group_end true on the last chunk of a group. Groups come in ascending
// order, so a body that scales per group accumulates in the order of the
// plain version. A whole stage (all but at most the last) runs its chunks
// without bounds checks.
template <typename T, int EA, int HALF, int STAGES, typename Chunk>
__device__ __forceinline__ void w4_mainloop(const unsigned char* a, const int8_t* packed,
                                            const float* table, int M, int N, int K,
                                            int m0, int n0, Chunk&& chunk) {
  extern __shared__ __align__(16) unsigned char w4_smem[];
  constexpr int BB = T::BB;
  const int KB = K / 2, G = K / (2 * HALF);
  const int nk = (KB + BB - 1) / BB;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      w4_load_stage<T, EA, HALF>(w4_smem + s * T::STAGE, a, packed, table, M, N, K, G, m0, n0,
                                 s * BB);
    w4_cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    w4_cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed for all; stage kt - 1 consumed by all
    const int nxt = kt + STAGES - 1;
    if (nxt < nk)
      w4_load_stage<T, EA, HALF>(w4_smem + (nxt % STAGES) * T::STAGE, a, packed, table, M, N,
                                 K, G, m0, n0, nxt * BB);
    w4_cp_async_commit();
    const unsigned char* As = w4_smem + (kt % STAGES) * T::STAGE;
    const unsigned char* Bs = As + T::A_BYTES;
    const float* Ts = reinterpret_cast<const float*>(Bs + T::B_BYTES);
    const int b0 = kt * BB;
    // a group ends after chunk c when its last byte b0 + 16 c + 15 closes a
    // half group (b0 is a multiple of BB, so this is a constant when
    // HALF <= BB)
    auto group_end = [&](int c) {
      return HALF <= BB ? (16 * c + 16) % HALF == 0 : (b0 + 16 * c + 16) % HALF == 0;
    };
    auto slot = [](int c) { return HALF <= BB ? 16 * c / HALF : 0; };
    if (b0 + BB <= KB) {
#pragma unroll
      for (int c = 0; c < BB / 16; ++c) chunk(As, Bs, Ts, c, slot(c), group_end(c));
    } else {
#pragma unroll
      for (int c = 0; c < BB / 16; ++c) {
        if (b0 + 16 * c >= KB) break;
        chunk(As, Bs, Ts, c, slot(c), group_end(c));
      }
    }
  }
  w4_cp_async_wait<0>();
}

// Raise a kernel's dynamic shared memory cap once, then launch it with one
// block per BM x BN output tile.
template <typename Tile, typename Kernel, typename... Args>
static cudaError_t w4_launch(Kernel kernel, bool& smem_set, int M, int N, cudaStream_t stream,
                             Args... args) {
  cudaError_t e = pq_allow_smem(kernel, Tile::SMEM, smem_set);
  if (e != cudaSuccess) return e;
  dim3 grid((N + Tile::BN - 1) / Tile::BN, (M + Tile::BM - 1) / Tile::BM);
  kernel<<<grid, W4_THREADS, Tile::SMEM, stream>>>(args...);
  return cudaGetLastError();
}
