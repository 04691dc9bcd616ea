// The merge of the split-S decode attentions' partials (split_common.cuh
// says what it computes), shared by the KIVI (kivi_combine.cu) and the int8
// and K8V4 (attn_split.cu) entry points.

#include "split_common.cuh"

constexpr int SM_THREADS = 512;

template <typename QT>
__global__ void __launch_bounds__(SM_THREADS) split_merge_kernel(const SplitMergeArgs a) {
  extern __shared__ __align__(16) float cshm[];
  const int r = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int group = a.H / a.KV, R = a.T * group, DH = a.Dh, n = a.n_split;
  const int D4 = DH / 4, SG = SM_THREADS / D4;
  float* Red = cshm;                 // [SG][DH]
  float* Ms = Red + SM_THREADS * 4;  // [n]
  float* Ls = Ms + n;                // [n]
  float* Ws = Ls + n;                // [n]
  const size_t base = ((size_t)b * a.KV + h) * n * R + r;  // partial of split i: base + i R
  for (int i = threadIdx.x; i < n; i += SM_THREADS) {
    const float2 ml = a.part_ml[base + (size_t)i * R];
    Ms[i] = ml.x;
    Ls[i] = ml.y;
  }
  __syncthreads();
  const bool has_sink = a.sink != nullptr;
  const float sink = has_sink ? a.sink[h * group + r % group] : SP_NEG_INF;
  float M = sink;
  for (int i = 0; i < n; ++i)
    if (Ls[i] > 0.0f) M = fmaxf(M, Ms[i]);
  for (int i = threadIdx.x; i < n; i += SM_THREADS)
    Ws[i] = Ls[i] > 0.0f ? expf(Ms[i] - M) : 0.0f;
  __syncthreads();
  float L = has_sink ? expf(sink - M) : 0.0f;
  for (int i = 0; i < n; ++i) L += Ls[i] * Ws[i];

  const int g = threadIdx.x / D4, c = threadIdx.x % D4;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = g; i < n; i += SG) {
    const float w = Ws[i];
    if (w > 0.0f) {
      const float4 v =
          reinterpret_cast<const float4*>(a.part_acc + (base + (size_t)i * R) * DH)[c];
      acc.x += w * v.x;
      acc.y += w * v.y;
      acc.z += w * v.z;
      acc.w += w * v.w;
    }
  }
  reinterpret_cast<float4*>(Red + g * DH)[c] = acc;
  __syncthreads();
  const int t = r / group, gi = r % group;
  QT* o = static_cast<QT*>(a.out) + (((size_t)b * a.T + t) * a.H + h * group + gi) * DH;
  for (int d = threadIdx.x; d < DH; d += SM_THREADS) {
    float sum = 0.0f;
    for (int k = 0; k < SG; ++k) sum += Red[k * DH + d];
    o[d] = pq_from_float<QT>(sum / fmaxf(L, 1e-30f));
  }
}

template <typename QT>
static cudaError_t launch_merge(const SplitMergeArgs& a, cudaStream_t st) {
  // SG Dh sums, (m, l, w) per split: under the 48 KB a launch may take unasked
  const int smem = 4 * (SM_THREADS * 4 + 3 * a.n_split);
  dim3 grid(a.T * (a.H / a.KV), a.KV, a.B);
  split_merge_kernel<QT><<<grid, SM_THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

cudaError_t split_merge(const SplitMergeArgs& a, cudaStream_t st) {
  if (a.n_split <= 0 || a.n_split > SP_MAX_SPLITS) return cudaErrorInvalidValue;
  switch (a.q_dtype) {
    case PQ_F32: return launch_merge<float>(a, st);
    case PQ_BF16: return launch_merge<__nv_bfloat16>(a, st);
    case PQ_F16: return launch_merge<__half>(a, st);
    default: return cudaErrorInvalidValue;
  }
}
