// The split-S decode of the int8, K8V4 and paged int8 attentions
// (csrc/attn_split.cuh):
// the entry points, which launch the split kernel and then split_merge
// (split_common.cuh) on one stream (two CUDA launches; the wrappers count the
// call once), and the plan.

#include "attn_split.cuh"

static int split_entry(bool v4, const void* q, int q_dtype, const void* kq, const void* ks,
                       const void* vq, const void* vs, const void* lengths, const void* kpos,
                       const void* alibi, const void* sink, void* out, void* part_acc,
                       void* part_ml, int B, int T, int H, int KV, int S, int Dh, float sm,
                       int window, float softcap, int sinks, int n_split, void* stream) {
  if (B == 0 || T == 0) return cudaSuccess;
  int span = 0;  // the workspace holds n_split partials: it must be the plan's
  if ((v4 && S % 2) || window < 0 || sinks < 0 || n_split == 0 ||
      as_plan(T, H, KV, S, Dh, window, sinks, kpos != nullptr, &span) != n_split)
    return cudaErrorInvalidValue;
  AttnSplitArgs a{q, q_dtype, (const int8_t*)kq, (const float*)ks, (const int8_t*)vq,
                  (const float*)vs, (const int*)lengths, (const int*)kpos, (const float*)alibi,
                  (float*)part_acc, (float2*)part_ml, B, T, H, KV, S, Dh, sm, window, softcap,
                  sinks, n_split, 0, 0};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (v4)  // K8V4 takes no variant but the scale: no VAR instance
    err = attn_split_k8v4(a, st);
  else if (kpos != nullptr || alibi != nullptr || sinks > 0)
    err = attn_split_ext(a, st);
  else  // the learned sinks join in the merge
    err = attn_split_int8(a, window > 0 || softcap > 0.0f ? 1 : 0, st);
  if (err != cudaSuccess) return err;
  return split_merge(SplitMergeArgs{(const float*)part_acc, (const float2*)part_ml,
                                    (const float*)sink, out, q_dtype, B, T, H, KV, Dh, n_split},
                     st);
}

// The split plan of an int8 or K8V4 attention call (as_plan): the number of
// splits, the span in *span; 0 where the prefill kernel (attn_prefill.cu)
// takes it. ``ring``: the call passes ring positions.
PQ_EXPORT int pq_attn_split_plan(int T, int H, int KV, int S, int Dh, int window, int sinks,
                                 int ring, int* span) {
  return as_plan(T, H, KV, S, Dh, window, sinks, ring != 0, span);
}

PQ_EXPORT int pq_int8_kv_attention_split(const void* q, int q_dtype, const void* kq,
                                         const void* ks, const void* vq, const void* vs,
                                         const void* lengths, const void* kpos,
                                         const void* alibi, const void* sink, void* out,
                                         void* part_acc, void* part_ml, int B, int T, int H,
                                         int KV, int S, int Dh, float sm, int window,
                                         float softcap, int sinks, int n_split, void* stream) {
  return split_entry(false, q, q_dtype, kq, ks, vq, vs, lengths, kpos, alibi, sink, out,
                     part_acc, part_ml, B, T, H, KV, S, Dh, sm, window, softcap, sinks, n_split,
                     stream);
}

PQ_EXPORT int pq_mixed_kv_attention_split(const void* q, int q_dtype, const void* kq,
                                          const void* ks, const void* vq, const void* vs,
                                          const void* lengths, void* out, void* part_acc,
                                          void* part_ml, int B, int T, int H, int KV, int S,
                                          int Dh, float sm, int n_split, void* stream) {
  return split_entry(true, q, q_dtype, kq, ks, vq, vs, lengths, nullptr, nullptr, nullptr, out,
                     part_acc, part_ml, B, T, H, KV, S, Dh, sm, 0, 0.0f, 0, n_split, stream);
}

// The split plan of a paged decode (T = 1) over a table of maxP entries of
// ps keys, head dim Dh: as_plan over the table's maxP * ps columns (the
// number of splits, the span in *span), 0 where the rows do not fit a block
// and csrc/paged_attention.cu takes the call. ops/paged_attention.py
// computes the same plan in Python; the entry below refuses a call whose
// n_split differs from it.
PQ_EXPORT int pq_paged_split_plan(int H, int KV, int maxP, int ps, int Dh, int* span) {
  if (maxP <= 0 || ps <= 0 || (long long)maxP * ps > (1 << 30)) return 0;
  if (Dh != 64 && Dh != 128 && Dh != 256) return 0;
  return as_plan(1, H, KV, maxP * ps, Dh, 0, 0, false, span);
}

// The paged int8 decode attention, split: the split kernel over the pool
// through the table (attn_split_paged.cu), then split_merge without a sink,
// on one stream (two CUDA launches; the wrapper counts the call once).
PQ_EXPORT int pq_paged_int8_attention_split(const void* q, int q_dtype, const void* kq,
                                            const void* ks, const void* vq, const void* vs,
                                            const void* page_table, const void* lengths,
                                            const void* alibi, void* out, void* part_acc,
                                            void* part_ml, int B, int H, int KV, int maxP,
                                            int ps, int Dh, float sm, int n_split,
                                            void* stream) {
  if (B == 0) return cudaSuccess;
  int span = 0;  // the workspace holds n_split partials: it must be the plan's
  if (n_split == 0 || pq_paged_split_plan(H, KV, maxP, ps, Dh, &span) != n_split)
    return cudaErrorInvalidValue;
  AttnSplitArgs a{q, q_dtype, (const int8_t*)kq, (const float*)ks, (const int8_t*)vq,
                  (const float*)vs, (const int*)lengths, nullptr, (const float*)alibi,
                  (float*)part_acc, (float2*)part_ml, B, 1, H, KV, maxP * ps, Dh, sm, 0, 0.0f,
                  0, n_split, 0, 0, (const int*)page_table, maxP, ps};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = attn_split_paged(a, st);
  if (err != cudaSuccess) return err;
  return split_merge(SplitMergeArgs{(const float*)part_acc, (const float2*)part_ml, nullptr, out,
                                    q_dtype, B, 1, H, KV, Dh, n_split},
                     st);
}
