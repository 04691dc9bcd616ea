// Producer ops fused with dynamic per-row int8 quantization.
//
// Replace protoquant_tpu/ops/fused_quant.py:_rms_norm_quant_kernel and
// _swiglu_quant_kernel (Pallas).
//   rms_norm_quant: y = (x * rsqrt(mean(x^2) + eps)) * w, rounded to the
//                   cast dtype, then the rowquant contract.
//   swiglu_quant:   h = cast(cast(act(g)) * cast(u)), act SiLU or tanh GELU,
//                   then the rowquant contract.
// Bound on the H100: bytes. Each reads its inputs once (x, or gate and up)
// and writes int8 codes and one f32 scale per row; a few dozen operations
// per element, far below the ~300 per byte where arithmetic would bound it.
// Design:
// - rms_norm_quant: one block per row. The row is read once with 16-byte
//   vector loads, turned into the f32 normed row in shared memory while the
//   block sums its squares, and the quantizer tail (pq_quantize_row,
//   common.cuh) runs out of shared memory.
// - swiglu_quant: row_quant.cuh with the SwiGLU producer, as
//   csrc/rowquant.cu: gate and up read once by 16-byte loads, h made once
//   and held in registers (two to a register where the cast is bf16 or
//   f16), the row split over a thread block cluster where rows are few
//   (ops/rowquant.py's plan, routes "cluster" and "rows"); one instance for
//   each activation and cast, so no element branches on them.
// The arithmetic follows the JAX kernels' order; products are __fmul_rn, so
// no FMA forms where the plain version rounds twice. SiLU is g / (1 +
// exp(-g)) and GELU the tanh formula, both as PyTorch's CUDA kernels spell
// them, so the kernel and its plain version round the same way where they
// can.

#include <type_traits>

#include "row_quant.cuh"

constexpr int FQ_THREADS = 256;
constexpr int FQ_MAX_SMEM = 226 * 1024;  // rms_norm_quant's f32 row
constexpr int FQ_ACT_SILU = 0;
constexpr int FQ_ACT_GELU = 1;

// Four f32 values to shared memory as one 16-byte store per four.
template <int V>
__device__ __forceinline__ void fq_store_row(float* row, int chunk, const float (&f)[V]) {
  float4* dst = reinterpret_cast<float4*>(row + (size_t)chunk * V);
#pragma unroll
  for (int j = 0; j < V / 4; ++j)
    dst[j] = make_float4(f[4 * j], f[4 * j + 1], f[4 * j + 2], f[4 * j + 3]);
}

template <typename T>
__global__ void __launch_bounds__(FQ_THREADS)
rms_norm_quant_kernel(const T* __restrict__ x, const float* __restrict__ w,
                      int8_t* __restrict__ xq, float* __restrict__ sx, int K, float eps,
                      int cast) {
  extern __shared__ __align__(16) float row[];
  __shared__ float red_sum[FQ_THREADS / 32];
  __shared__ float red_max[FQ_THREADS / 32];
  constexpr int V = 16 / sizeof(T);
  const size_t base = (size_t)blockIdx.x * K;
  const T* xr = x + base;

  float ss = 0.0f;
  if (K % V == 0 && ((uintptr_t)xr & 15) == 0) {
    for (int c = threadIdx.x; c < K / V; c += FQ_THREADS) {
      const uint4 raw = reinterpret_cast<const uint4*>(xr)[c];
      const T* e = reinterpret_cast<const T*>(&raw);
      float f[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        f[j] = pq_to_float(e[j]);
        ss += f[j] * f[j];
      }
      fq_store_row<V>(row, c, f);
    }
  } else {
    for (int i = threadIdx.x; i < K; i += FQ_THREADS) {
      const float v = pq_to_float(xr[i]);
      row[i] = v;
      ss += v * v;
    }
  }
  const float var = __fdiv_rn(pq_block_sum<FQ_THREADS>(ss, red_sum), (float)K);
  const float r = rsqrtf(__fadd_rn(var, eps));

  float amax = 0.0f;
  for (int i = threadIdx.x; i < K; i += FQ_THREADS) {
    const float y = pq_round_to(__fmul_rn(__fmul_rn(row[i], r), w[i]), cast);
    row[i] = y;
    amax = fmaxf(amax, fabsf(y));
  }
  pq_quantize_row<FQ_THREADS>(row, K, amax, red_max, xq + base, sx + blockIdx.x);
}

// x rounded to CastT and back to f32, to nearest even (pq_round_to with
// the cast known at compile time).
template <typename CastT>
__device__ __forceinline__ float fq_round(float x) {
  return pq_to_float(pq_from_float<CastT>(x));
}

// The SwiGLU producer of row_quant.cuh, the activation and the cast known
// at compile time (no per-element branch on them): h of one gate and up
// element, kept between the maximum and the codes as a value of CastT, so
// two to a 32-bit word where the cast is bf16 or f16 (half the registers of
// f32: more blocks an SM at prefill).
template <int ACT, typename CastT>
struct FqSwiglu {
  static constexpr bool KEEP = true;
  static constexpr int PER = sizeof(CastT) == 2 ? 2 : 1;
  using Kept = typename std::conditional<PER == 2, uint32_t, float>::type;
  template <typename T>
  __device__ __forceinline__ float operator()(T gt, T ut) const {
    const float g = pq_to_float(gt);
    float a;
    if constexpr (ACT == FQ_ACT_SILU) {
      a = __fdiv_rn(g, 1.0f + expf(-g));
    } else {  // tanh approximation: 0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))
      const float inner = 0.7978845608028654f * (g + 0.044715f * (g * g * g));
      a = 0.5f * g * (1.0f + tanhf(inner));
    }
    return fq_round<CastT>(__fmul_rn(fq_round<CastT>(a), fq_round<CastT>(pq_to_float(ut))));
  }
  __device__ __forceinline__ Kept keep(const float (&y)[PER]) const {
    if constexpr (PER == 2) {
      const CastT lo = pq_from_float<CastT>(y[0]), hi = pq_from_float<CastT>(y[1]);
      return (uint32_t)*reinterpret_cast<const unsigned short*>(&lo) |
             (uint32_t)*reinterpret_cast<const unsigned short*>(&hi) << 16;
    } else {
      return y[0];
    }
  }
  __device__ __forceinline__ float restore(Kept w, int p) const {
    if constexpr (PER == 2) {
      const unsigned short bits = (unsigned short)(p ? w >> 16 : w & 0xffffu);
      return pq_to_float(*reinterpret_cast<const CastT*>(&bits));
    } else {
      return w;
    }
  }
};

template <typename T, int R, int ACT, typename CastT>
__global__ void __launch_bounds__(RQ_MAX_THREADS(R), RQ_MIN_BLOCKS(R))
swiglu_quant_kernel(const T* __restrict__ gate, const T* __restrict__ up,
                    int8_t* __restrict__ hq, float* __restrict__ sh, int K, int C) {
  rq_row<T, R, 2>(gate, up, hq, sh, K, C, FqSwiglu<ACT, CastT>{});
}

template <typename T>
static cudaError_t launch_norm(const void* x, const void* w, void* xq, void* sx, int M,
                               int K, float eps, int cast, cudaStream_t stream) {
  static bool configured = false;
  cudaError_t err = pq_allow_smem(rms_norm_quant_kernel<T>, FQ_MAX_SMEM, configured);
  if (err != cudaSuccess) return err;
  const size_t smem = (size_t)K * sizeof(float);
  if (smem > (size_t)FQ_MAX_SMEM) return cudaErrorInvalidValue;
  rms_norm_quant_kernel<T><<<M, FQ_THREADS, smem, stream>>>(
      (const T*)x, (const float*)w, (int8_t*)xq, (float*)sx, K, eps, cast);
  return cudaGetLastError();
}

template <typename T, int R, int ACT, typename CastT>
static cudaError_t launch_swiglu(const void* g, const void* u, void* hq, void* sh, int M,
                                 int K, int blocks, int threads, cudaStream_t stream) {
  return rq_launch(swiglu_quant_kernel<T, R, ACT, CastT>, M, blocks, threads, stream,
                   (const T*)g, (const T*)u, (int8_t*)hq, (float*)sh, K, blocks);
}

template <typename T, int R, int ACT>
static cudaError_t launch_swiglu(const void* g, const void* u, void* hq, void* sh, int M,
                                 int K, int blocks, int threads, int cast, cudaStream_t s) {
  switch (cast) {
    case PQ_F32: return launch_swiglu<T, R, ACT, float>(g, u, hq, sh, M, K, blocks, threads, s);
    case PQ_BF16:
      return launch_swiglu<T, R, ACT, __nv_bfloat16>(g, u, hq, sh, M, K, blocks, threads, s);
    default: return launch_swiglu<T, R, ACT, __half>(g, u, hq, sh, M, K, blocks, threads, s);
  }
}

template <typename T, int R>
static cudaError_t launch_swiglu(const void* g, const void* u, void* hq, void* sh, int M,
                                 int K, int blocks, int threads, int act, int cast,
                                 cudaStream_t s) {
  if (act == FQ_ACT_SILU)
    return launch_swiglu<T, R, FQ_ACT_SILU>(g, u, hq, sh, M, K, blocks, threads, cast, s);
  return launch_swiglu<T, R, FQ_ACT_GELU>(g, u, hq, sh, M, K, blocks, threads, cast, s);
}

template <typename T>
static cudaError_t dispatch_swiglu(const void* g, const void* u, void* hq, void* sh, int M,
                                   int K, int blocks, int threads, int vectors, int act,
                                   int cast, cudaStream_t s) {
  if (!rq_plan_ok(K, 16 / (int)sizeof(T), blocks, threads, vectors)) return cudaErrorInvalidValue;
  switch (vectors) {
    case 1: return launch_swiglu<T, 1>(g, u, hq, sh, M, K, blocks, threads, act, cast, s);
    case 2: return launch_swiglu<T, 2>(g, u, hq, sh, M, K, blocks, threads, act, cast, s);
    default: return launch_swiglu<T, 4>(g, u, hq, sh, M, K, blocks, threads, act, cast, s);
  }
}

static bool fq_valid_cast(int cast) {
  return cast == PQ_F32 || cast == PQ_BF16 || cast == PQ_F16;
}

PQ_EXPORT int pq_rms_norm_quant(const void* x, int x_dtype, const void* w, void* xq,
                                void* sx, int M, int K, float eps, int cast,
                                void* stream) {
  if (M == 0) return cudaSuccess;
  if (!fq_valid_cast(cast)) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (x_dtype) {
    case PQ_F32: return launch_norm<float>(x, w, xq, sx, M, K, eps, cast, s);
    case PQ_BF16: return launch_norm<__nv_bfloat16>(x, w, xq, sx, M, K, eps, cast, s);
    case PQ_F16: return launch_norm<__half>(x, w, xq, sx, M, K, eps, cast, s);
    default: return cudaErrorInvalidValue;
  }
}

// blocks, threads, vectors: the plan (ops/rowquant.py rowquant_plan with
// two inputs), as pq_rowquant takes it.
PQ_EXPORT int pq_swiglu_quant(const void* gate, const void* up, int dtype, void* hq,
                              void* sh, int M, int K, int blocks, int threads, int vectors,
                              int act, int cast, void* stream) {
  if (M == 0) return cudaSuccess;
  if (!fq_valid_cast(cast) || (act != FQ_ACT_SILU && act != FQ_ACT_GELU))
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int b = blocks, t = threads, v = vectors;
  switch (dtype) {
    case PQ_F32: return dispatch_swiglu<float>(gate, up, hq, sh, M, K, b, t, v, act, cast, s);
    case PQ_BF16:
      return dispatch_swiglu<__nv_bfloat16>(gate, up, hq, sh, M, K, b, t, v, act, cast, s);
    case PQ_F16: return dispatch_swiglu<__half>(gate, up, hq, sh, M, K, b, t, v, act, cast, s);
    default: return cudaErrorInvalidValue;
  }
}
