// The prefill attention kernel (csrc/attn_prefill.cuh): the K4V8 instances
// (packed int4 K, int8 V; VAR 0 to 2). Its own translation unit, so that
// nvcc builds it beside the others.
#include "attn_prefill.cuh"

cudaError_t attn_prefill_kivi_k4v8(const AttnPrefillArgs& a, cudaStream_t st) {
  return ap_kivi_dispatch<false>(a, st);
}
