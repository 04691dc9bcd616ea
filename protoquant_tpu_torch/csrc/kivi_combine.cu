// The split-S KIVI decode (csrc/kivi_split.cuh): the entry points, which
// launch the split kernel and then the merge on one stream (two
// CUDA launches; the wrappers count the call once), and the plan.
//
// The merge is split_merge (split_common.cuh, split_merge.cu), which the
// int8 and K8V4 split decode shares.

#include "kivi_split.cuh"

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
  return split_merge(SplitMergeArgs{a.part_acc, a.part_ml, a.sink, out, q_dtype, B, T, H, KV,
                                    Dh, n_split},
                     st);
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
// the span in *span; 0 where the prefill kernel (attn_prefill.cuh) takes it.
PQ_EXPORT int pq_kivi_split_plan(int T, int H, int KV, int S, int Dh, int G, int* span) {
  return ks_plan(T, H, KV, S, Dh, G, span);
}

PQ_EXPORT int pq_k4v8_attention_split(PQ_KS_PARAMS) { return split_entry(false, PQ_KS_ARGS); }

PQ_EXPORT int pq_int4_kv_attention_split(PQ_KS_PARAMS) { return split_entry(true, PQ_KS_ARGS); }
