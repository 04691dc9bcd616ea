// Weight-only int8 matmul: bf16 x times int8 W, f32 sum, f32 epilogue.
//
// Replaces protoquant_tpu/ops/wo_matmul.py:_wo_kernel (Pallas).
//   out[m, n] = cast((sum_k x[m, k] * wq[n, k]) * s_w[n] + bias[n])
// x is [M, K] bf16 row-major; wq is [N, K] int8 row-major (the nn.Linear
// layout, K contiguous), the "col" operand of mma.sync. Every product of a
// bf16 and an int8 code (|q| <= 127, exact in bf16) is exact in f32; only
// the order of the f32 sum differs from the plain version.
// Bound on the H100: bytes at decode (M = 4), the int8 weight read once,
// N * K bytes (5.0 us at N = K = 4096). Design: the int8 tile is converted
// to bf16 in registers, right before the tensor-core product, so no bf16
// copy of W ever reaches device memory (it would double the bytes the mode
// exists to save). A block of 4 warps owns a BM x BN output tile (BM = 16,
// BN = 32 at decode: N / 32 = 128 blocks at N = 4096; BM = 64, BN = 64
// above 16 rows); each warp owns BN / 4 columns over all BM rows, through
// mma.sync.m16n8k16 bf16 with f32 accumulators in registers. K runs in
// 128-deep stages, 4 in flight through cp.async (zero-filled past M, N and
// K, which adds nothing). Inside each 16-deep step, thread t of a quad reads
// the 4 consecutive k at 4t (8 bytes of x, 4 bytes of W); the same
// permutation of k on both operands leaves the dot product unchanged, and
// spares the shuffles of the mma's own k order. Shared rows are padded so
// those reads are conflict-free. The epilogue multiplies and adds with
// __fmul_rn / __fadd_rn, never contracted into an FMA, as the plain version
// rounds. A later version moves to wgmma and TMA.

#include "common.cuh"

constexpr int WO_THREADS = 128;
constexpr int WO_BK = 128;             // K depth of one stage
constexpr int WO_STAGES = 4;
constexpr int WO_XS = 2 * WO_BK + 32;  // x row stride in shared memory (bytes)
constexpr int WO_WS = WO_BK + 16;      // W row stride in shared memory (bytes)

__device__ __forceinline__ void wo_cp_async16(void* smem, const void* gmem, bool pred) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void wo_cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void wo_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two int8 codes as a bf16 pair (exact), the lower k in the low half.
__device__ __forceinline__ uint32_t bf16x2_of_int8(int lo, int hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn((float)lo, (float)hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int MT, int NT>
struct WoTile {
  static constexpr int BM = 16 * MT, BN = 32 * NT;
  static constexpr int X_BYTES = BM * WO_XS, STAGE = X_BYTES + BN * WO_WS;
  static constexpr int SMEM = STAGE * WO_STAGES;
};

template <int MT, int NT>
__device__ __forceinline__ void wo_load_stage(unsigned char* st, const __nv_bfloat16* x,
                                              const int8_t* w, int M, int N, int K, int m0,
                                              int n0, int k0) {
  using T = WoTile<MT, NT>;
  unsigned char* Xs = st;
  unsigned char* Ws = st + T::X_BYTES;
  for (int c = threadIdx.x; c < T::BM * (WO_BK / 8); c += WO_THREADS) {
    const int r = c / (WO_BK / 8), k = k0 + (c % (WO_BK / 8)) * 8;
    const bool p = m0 + r < M && k < K;
    wo_cp_async16(Xs + r * WO_XS + (k - k0) * 2,
                  x + (p ? (size_t)(m0 + r) * K + k : 0), p);
  }
  for (int c = threadIdx.x; c < T::BN * (WO_BK / 16); c += WO_THREADS) {
    const int r = c / (WO_BK / 16), k = k0 + (c % (WO_BK / 16)) * 16;
    const bool p = n0 + r < N && k < K;
    wo_cp_async16(Ws + r * WO_WS + (k - k0), w + (p ? (size_t)(n0 + r) * K + k : 0), p);
  }
}

template <int MT, int NT, typename OutT>
__global__ void __launch_bounds__(WO_THREADS)
wo_matmul_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ sw, const float* __restrict__ bias,
                 OutT* __restrict__ out, int M, int N, int K) {
  using T = WoTile<MT, NT>;
  extern __shared__ __align__(16) unsigned char wo_smem[];
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wn = warp * 8 * NT;  // this warp's first column in the tile

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  const int nk = (K + WO_BK - 1) / WO_BK;
#pragma unroll
  for (int s = 0; s < WO_STAGES - 1; ++s) {
    if (s < nk) wo_load_stage<MT, NT>(wo_smem + s * T::STAGE, x, w, M, N, K, m0, n0, s * WO_BK);
    wo_cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    wo_cp_async_wait<WO_STAGES - 2>();
    __syncthreads();  // stage kt landed for all; stage kt - 1 consumed by all
    const int nxt = kt + WO_STAGES - 1;
    if (nxt < nk)
      wo_load_stage<MT, NT>(wo_smem + (nxt % WO_STAGES) * T::STAGE, x, w, M, N, K, m0, n0,
                            nxt * WO_BK);
    wo_cp_async_commit();
    const unsigned char* Xs = wo_smem + (kt % WO_STAGES) * T::STAGE;
    const unsigned char* Ws = Xs + T::X_BYTES;
#pragma unroll
    for (int kk = 0; kk < WO_BK; kk += 16) {
      uint32_t af[MT][4], bf[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const uint2 lo = *(const uint2*)(Xs + (i * 16 + g) * WO_XS + 2 * (kk + 4 * t));
        const uint2 hi = *(const uint2*)(Xs + (i * 16 + g + 8) * WO_XS + 2 * (kk + 4 * t));
        af[i][0] = lo.x;  // row g,     k 4t, 4t+1
        af[i][1] = hi.x;  // row g + 8, k 4t, 4t+1
        af[i][2] = lo.y;  // row g,     k 4t+2, 4t+3
        af[i][3] = hi.y;  // row g + 8, k 4t+2, 4t+3
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const char4 q4 = *(const char4*)(Ws + (wn + j * 8 + g) * WO_WS + kk + 4 * t);
        bf[j][0] = bf16x2_of_int8(q4.x, q4.y);
        bf[j][1] = bf16x2_of_int8(q4.z, q4.w);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], af[i], bf[j]);
    }
  }
  wo_cp_async_wait<0>();

  // Epilogue: c0, c1 at (row g, cols 2t, 2t+1); c2, c3 at row g + 8.
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + i * 16 + g + 8 * hh;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn + j * 8 + 2 * t + e;
          if (col >= N) continue;
          float y = __fmul_rn(acc[i][j][2 * hh + e], sw[col]);
          if (bias != nullptr) y = __fadd_rn(y, bias[col]);
          out[(size_t)row * N + col] = pq_from_float<OutT>(y);
        }
      }
    }
  }
}

template <int MT, int NT, typename OutT>
static cudaError_t launch_t(const void* x, const void* wq, const void* sw, const void* bias,
                            void* out, int M, int N, int K, cudaStream_t stream) {
  using T = WoTile<MT, NT>;
  static bool smem_set = false;
  cudaError_t e = pq_allow_smem(wo_matmul_kernel<MT, NT, OutT>, T::SMEM, smem_set);
  if (e != cudaSuccess) return e;
  dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM);
  wo_matmul_kernel<MT, NT, OutT><<<grid, WO_THREADS, T::SMEM, stream>>>(
      (const __nv_bfloat16*)x, (const int8_t*)wq, (const float*)sw, (const float*)bias,
      (OutT*)out, M, N, K);
  return cudaGetLastError();
}

template <typename OutT>
static cudaError_t launch_m(const void* x, const void* wq, const void* sw, const void* bias,
                            void* out, int M, int N, int K, cudaStream_t stream) {
  if (M <= 16) return launch_t<1, 1, OutT>(x, wq, sw, bias, out, M, N, K, stream);
  return launch_t<4, 2, OutT>(x, wq, sw, bias, out, M, N, K, stream);
}

PQ_EXPORT int pq_weight_only_matmul(const void* x, const void* wq, const void* sw,
                                    const void* bias, void* out, int out_dtype, int M, int N,
                                    int K, void* stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  if (K % 16 != 0) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (out_dtype) {
    case PQ_F32: return launch_m<float>(x, wq, sw, bias, out, M, N, K, s);
    case PQ_BF16: return launch_m<__nv_bfloat16>(x, wq, sw, bias, out, M, N, K, s);
    case PQ_F16: return launch_m<__half>(x, wq, sw, bias, out, M, N, K, s);
    default: return cudaErrorInvalidValue;
  }
}
