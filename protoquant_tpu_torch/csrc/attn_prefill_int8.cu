// The prefill attention kernel (csrc/attn_prefill.cuh): the full-causal
// instances (VAR = 0). Its own translation unit, so that nvcc builds it
// beside the others.
#include "attn_prefill.cuh"

cudaError_t attn_prefill_int8(const AttnPrefillArgs& a, cudaStream_t st) {
  return ap_dispatch<false, 0>(a, st);
}
