// The prefill attention over the dense int8 and K8V4 caches
// (csrc/attn_prefill.cuh): the entry points, which pick the least instance
// family a call's variants need and launch it on the caller's stream. The
// split-S decode (attn_split.cu) takes the calls its plan admits; the
// wrappers in ops/attention.py route every other call here.

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
