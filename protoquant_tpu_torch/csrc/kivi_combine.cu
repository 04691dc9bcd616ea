// The split-S KIVI decode (csrc/kivi_split.cuh): the entry points, which
// launch the split kernel and then kivi_combine_kernel on one stream (two
// CUDA launches; the wrappers count the call once), and the plan.
//
// kivi_combine_kernel merges the partials of one query row, one block of
// KC_THREADS threads per (row, kv head, b): the splits' (m, l) are staged in
// shared memory; m = max(sink, the m of every split with l > 0); each split's
// weight w_i = e^(m_i - m) (0 where l_i = 0) is computed once; l = (sink ?
// e^(sink - m) : 0) + sum l_i w_i in split order by every thread; then
// thread (g, c) sums w_i acc_i over the splits i = g mod SG (SG =
// KC_THREADS / (Dh / 4)) in split order on its four dims, and the SG sums
// meet in shared memory in order g = 0, 1, ...: out = sum / max(l, 1e-30),
// cast to q's type. Bound: the live splits' partials, read once; the many
// threads keep several splits' loads in flight at once.

#include "kivi_split.cuh"

constexpr int KC_THREADS = 512;

template <typename QT>
__global__ void __launch_bounds__(KC_THREADS) kivi_combine_kernel(const KiviSplitArgs a) {
  extern __shared__ __align__(16) float cshm[];
  const int r = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int group = a.H / a.KV, R = a.T * group, DH = a.Dh, n = a.n_split;
  const int D4 = DH / 4, SG = KC_THREADS / D4;
  float* Red = cshm;                 // [SG][DH]
  float* Ms = Red + KC_THREADS * 4;  // [n]
  float* Ls = Ms + n;                // [n]
  float* Ws = Ls + n;                // [n]
  const size_t base = ((size_t)b * a.KV + h) * n * R + r;  // partial of split i: base + i R
  for (int i = threadIdx.x; i < n; i += KC_THREADS) {
    const float2 ml = a.part_ml[base + (size_t)i * R];
    Ms[i] = ml.x;
    Ls[i] = ml.y;
  }
  __syncthreads();
  const bool has_sink = a.sink != nullptr;
  const float sink = has_sink ? a.sink[h * group + r % group] : KS_NEG_INF;
  float M = sink;
  for (int i = 0; i < n; ++i)
    if (Ls[i] > 0.0f) M = fmaxf(M, Ms[i]);
  for (int i = threadIdx.x; i < n; i += KC_THREADS)
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
  for (int d = threadIdx.x; d < DH; d += KC_THREADS) {
    float sum = 0.0f;
    for (int k = 0; k < SG; ++k) sum += Red[k * DH + d];
    o[d] = pq_from_float<QT>(sum / fmaxf(L, 1e-30f));
  }
}

template <typename QT>
static cudaError_t launch_combine(const KiviSplitArgs& a, cudaStream_t st) {
  // SG Dh sums, (m, l, w) per split: under the 48 KB a launch may take unasked
  const int smem = 4 * (KC_THREADS * 4 + 3 * a.n_split);
  dim3 grid(a.T * (a.H / a.KV), a.KV, a.B);
  kivi_combine_kernel<QT><<<grid, KC_THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

static int split_entry(bool v4, const void* q, int q_dtype, const void* kq, const void* kchs,
                       const void* vq, const void* vs, const void* ktail, const void* kts,
                       const void* vtail, const void* vts, const void* lengths,
                       const void* new_lengths, const void* alibi, const void* sink, void* out,
                       void* part_acc, void* part_ml, int B, int T, int H, int KV, int S,
                       int Dh, int G, float sm, int window, float softcap, int n_split,
                       void* stream) {
  if (B == 0 || T == 0) return cudaSuccess;
  int span = 0;  // the workspace holds n_split partials: it must be the plan's
  if (window < 0 || n_split == 0 || ks_plan(T, H, KV, S, Dh, G, &span) != n_split)
    return cudaErrorInvalidValue;
  KiviSplitArgs a{q, q_dtype, (const int8_t*)kq, (const float*)kchs, (const int8_t*)vq,
                  (const float*)vs, (const int8_t*)ktail, (const float*)kts,
                  (const int8_t*)vtail, (const float*)vts, (const int*)lengths,
                  (const int*)new_lengths, (const float*)alibi, (const float*)sink, out,
                  (float*)part_acc, (float2*)part_ml, B, T, H, KV, S, Dh, G, sm, window,
                  softcap, span, n_split};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = v4 ? kivi_split_int4(a, st) : kivi_split_k4v8(a, st);
  if (err != cudaSuccess) return err;
  switch (q_dtype) {
    case PQ_F32: return launch_combine<float>(a, st);
    case PQ_BF16: return launch_combine<__nv_bfloat16>(a, st);
    case PQ_F16: return launch_combine<__half>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

#define PQ_KS_PARAMS                                                                        \
  const void *q, int q_dtype, const void *kq, const void *kchs, const void *vq,             \
      const void *vs, const void *ktail, const void *kts, const void *vtail, const void *vts, \
      const void *lengths, const void *new_lengths, const void *alibi, const void *sink,    \
      void *out, void *part_acc, void *part_ml, int B, int T, int H, int KV, int S, int Dh,  \
      int G, float sm, int window, float softcap, int n_split, void *stream
#define PQ_KS_ARGS                                                                         \
  q, q_dtype, kq, kchs, vq, vs, ktail, kts, vtail, vts, lengths, new_lengths, alibi, sink, \
      out, part_acc, part_ml, B, T, H, KV, S, Dh, G, sm, window, softcap, n_split, stream

// The split plan of a KIVI attention call (ks_plan): the number of splits,
// the span in *span; 0 where the one-pass kernel (kivi_attention.cu) takes it.
PQ_EXPORT int pq_kivi_split_plan(int T, int H, int KV, int S, int Dh, int G, int* span) {
  return ks_plan(T, H, KV, S, Dh, G, span);
}

PQ_EXPORT int pq_k4v8_attention_split(PQ_KS_PARAMS) { return split_entry(false, PQ_KS_ARGS); }

PQ_EXPORT int pq_int4_kv_attention_split(PQ_KS_PARAMS) { return split_entry(true, PQ_KS_ARGS); }
