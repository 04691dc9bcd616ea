// The prefill attention over the dense int8, K8V4 and KIVI caches
// (csrc/attn_prefill.cuh): the entry points, which pick the least instance
// family a call's variants need and launch it on the caller's stream. The
// split-S decodes (attn_split.cu, kivi_combine.cu) take the calls their
// plans admit; the wrappers in ops/attention.py route every other call here.

#include "attn_prefill.cuh"

static int prefill_entry(bool v4, const void* q, int q_dtype, const void* kq, const void* ks,
                         const void* vq, const void* vs, const void* lengths, const void* kpos,
                         const void* alibi, const void* sink, void* out, int B, int T, int H,
                         int KV, int S, int Dh, float sm, int window, float softcap, int sinks,
                         void* stream) {
  if (B == 0 || T == 0) return cudaSuccess;
  if (KV <= 0 || H % KV != 0 || (v4 && S % 2) || window < 0 || sinks < 0)
    return cudaErrorInvalidValue;
  const AttnPrefillArgs a{q, q_dtype, (const int8_t*)kq, (const float*)ks, (const int8_t*)vq,
                          (const float*)vs, (const int*)lengths, (const int*)kpos,
                          (const float*)alibi, (const float*)sink, out, B, T, H, KV, S, Dh,
                          sm, window, softcap, sinks};
  cudaStream_t st = (cudaStream_t)stream;
  if (v4)  // K8V4 takes no variant but the scale: no VAR instance
    return attn_prefill_k8v4(a, st);
  if (kpos != nullptr || alibi != nullptr || sinks > 0) return attn_prefill_ext(a, st);
  if (window > 0 || softcap > 0.0f || sink != nullptr) return attn_prefill_var(a, st);
  return attn_prefill_int8(a, st);
}

PQ_EXPORT int pq_int8_kv_attention(const void* q, int q_dtype, const void* kq, const void* ks,
                                   const void* vq, const void* vs, const void* lengths,
                                   const void* kpos, const void* alibi, const void* sink,
                                   void* out, int B, int T, int H, int KV, int S, int Dh,
                                   float sm, int window, float softcap, int sinks,
                                   void* stream) {
  return prefill_entry(false, q, q_dtype, kq, ks, vq, vs, lengths, kpos, alibi, sink, out, B, T,
                       H, KV, S, Dh, sm, window, softcap, sinks, stream);
}

PQ_EXPORT int pq_mixed_kv_attention(const void* q, int q_dtype, const void* kq, const void* ks,
                                    const void* vq, const void* vs, const void* lengths,
                                    void* out, int B, int T, int H, int KV, int S, int Dh,
                                    float sm, void* stream) {
  return prefill_entry(true, q, q_dtype, kq, ks, vq, vs, lengths, nullptr, nullptr, nullptr,
                       out, B, T, H, KV, S, Dh, sm, 0, 0.0f, 0, stream);
}

static int kivi_entry(bool v4, const void* q, int q_dtype, const void* kq, const void* kchs,
                      const void* vq, const void* vs, const void* ktail, const void* kts,
                      const void* vtail, const void* vts, const void* lengths,
                      const void* new_lengths, const void* alibi, const void* sink, void* out,
                      int B, int T, int H, int KV, int S, int Dh, int G, float sm, int window,
                      float softcap, void* stream) {
  if (B == 0 || T == 0) return cudaSuccess;
  if (KV <= 0 || H % KV != 0 || G < 2 || G % 2 || S % G || window < 0)
    return cudaErrorInvalidValue;
  const AttnPrefillArgs a{q, q_dtype, (const int8_t*)kq, nullptr, (const int8_t*)vq,
                          (const float*)vs, (const int*)lengths, nullptr, (const float*)alibi,
                          (const float*)sink, out, B, T, H, KV, S, Dh, sm, window, softcap, 0,
                          (const float*)kchs, (const int8_t*)ktail, (const float*)kts,
                          (const int8_t*)vtail, (const float*)vts, (const int*)new_lengths, G};
  cudaStream_t st = (cudaStream_t)stream;
  return v4 ? attn_prefill_kivi_int4(a, st) : attn_prefill_kivi_k4v8(a, st);
}

#define PQ_KA_PARAMS                                                                       \
  const void *q, int q_dtype, const void *kq, const void *kchs, const void *vq,            \
      const void *vs, const void *ktail, const void *kts, const void *vtail,               \
      const void *vts, const void *lengths, const void *new_lengths, const void *alibi,    \
      const void *sink, void *out, int B, int T, int H, int KV, int S, int Dh, int G,      \
      float sm, int window, float softcap, void *stream
#define PQ_KA_ARGS                                                                        \
  q, q_dtype, kq, kchs, vq, vs, ktail, kts, vtail, vts, lengths, new_lengths, alibi, sink, \
      out, B, T, H, KV, S, Dh, G, sm, window, softcap, stream

PQ_EXPORT int pq_k4v8_attention(PQ_KA_PARAMS) { return kivi_entry(false, PQ_KA_ARGS); }

PQ_EXPORT int pq_int4_kv_attention(PQ_KA_PARAMS) { return kivi_entry(true, PQ_KA_ARGS); }
