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
// Design: one block per row, as csrc/rowquant.cu. The row is read once with
// 16-byte vector loads, turned into the f32 producer output in shared
// memory while the block reduces what it needs (sum of squares, absolute
// maximum), and the quantizer tail (pq_quantize_row, common.cuh, shared
// with rowquant) runs out of shared memory: device memory is read once and
// the f32 intermediate never leaves the SM. The arithmetic follows the JAX
// kernels' order; products are __fmul_rn, so no FMA forms where the plain
// version rounds twice. SiLU is g / (1 + exp(-g)) and GELU the tanh
// formula, both as PyTorch's CUDA kernels spell them, so the kernel and its
// plain version round the same way where they can.

#include "common.cuh"

constexpr int FQ_THREADS = 256;
constexpr int FQ_MAX_SMEM = 226 * 1024;  // one f32 row, as rowquant
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

__device__ __forceinline__ float fq_swiglu(float g, float u, int act, int cast) {
  float a;
  if (act == FQ_ACT_SILU) {
    a = __fdiv_rn(g, 1.0f + expf(-g));
  } else {  // tanh approximation: 0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))
    const float inner = 0.7978845608028654f * (g + 0.044715f * (g * g * g));
    a = 0.5f * g * (1.0f + tanhf(inner));
  }
  return pq_round_to(__fmul_rn(pq_round_to(a, cast), pq_round_to(u, cast)), cast);
}

template <typename T>
__global__ void __launch_bounds__(FQ_THREADS)
swiglu_quant_kernel(const T* __restrict__ gate, const T* __restrict__ up,
                    int8_t* __restrict__ hq, float* __restrict__ sh, int K, int act,
                    int cast) {
  extern __shared__ __align__(16) float row[];
  __shared__ float red_max[FQ_THREADS / 32];
  constexpr int V = 16 / sizeof(T);
  const size_t base = (size_t)blockIdx.x * K;
  const T* gr = gate + base;
  const T* ur = up + base;

  float amax = 0.0f;
  if (K % V == 0 && (((uintptr_t)gr | (uintptr_t)ur) & 15) == 0) {
    for (int c = threadIdx.x; c < K / V; c += FQ_THREADS) {
      const uint4 graw = reinterpret_cast<const uint4*>(gr)[c];
      const uint4 uraw = reinterpret_cast<const uint4*>(ur)[c];
      const T* ge = reinterpret_cast<const T*>(&graw);
      const T* ue = reinterpret_cast<const T*>(&uraw);
      float f[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        f[j] = fq_swiglu(pq_to_float(ge[j]), pq_to_float(ue[j]), act, cast);
        amax = fmaxf(amax, fabsf(f[j]));
      }
      fq_store_row<V>(row, c, f);
    }
  } else {
    for (int i = threadIdx.x; i < K; i += FQ_THREADS) {
      const float h = fq_swiglu(pq_to_float(gr[i]), pq_to_float(ur[i]), act, cast);
      row[i] = h;
      amax = fmaxf(amax, fabsf(h));
    }
  }
  pq_quantize_row<FQ_THREADS>(row, K, amax, red_max, hq + base, sh + blockIdx.x);
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

template <typename T>
static cudaError_t launch_swiglu(const void* g, const void* u, void* hq, void* sh, int M,
                                 int K, int act, int cast, cudaStream_t stream) {
  static bool configured = false;
  cudaError_t err = pq_allow_smem(swiglu_quant_kernel<T>, FQ_MAX_SMEM, configured);
  if (err != cudaSuccess) return err;
  const size_t smem = (size_t)K * sizeof(float);
  if (smem > (size_t)FQ_MAX_SMEM) return cudaErrorInvalidValue;
  swiglu_quant_kernel<T><<<M, FQ_THREADS, smem, stream>>>(
      (const T*)g, (const T*)u, (int8_t*)hq, (float*)sh, K, act, cast);
  return cudaGetLastError();
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

PQ_EXPORT int pq_swiglu_quant(const void* gate, const void* up, int dtype, void* hq,
                              void* sh, int M, int K, int act, int cast, void* stream) {
  if (M == 0) return cudaSuccess;
  if (!fq_valid_cast(cast) || (act != FQ_ACT_SILU && act != FQ_ACT_GELU))
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case PQ_F32: return launch_swiglu<float>(gate, up, hq, sh, M, K, act, cast, s);
    case PQ_BF16: return launch_swiglu<__nv_bfloat16>(gate, up, hq, sh, M, K, act, cast, s);
    case PQ_F16: return launch_swiglu<__half>(gate, up, hq, sh, M, K, act, cast, s);
    default: return cudaErrorInvalidValue;
  }
}
