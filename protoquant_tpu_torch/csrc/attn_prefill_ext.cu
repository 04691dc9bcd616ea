// The prefill attention kernel (csrc/attn_prefill.cuh): the instances that
// also read ring positions, StreamingLLM sinks and ALiBi slopes (VAR = 2).
// Its own translation unit, so that nvcc builds it beside the others.
#include "attn_prefill.cuh"

cudaError_t attn_prefill_ext(const AttnPrefillArgs& a, cudaStream_t st) {
  return ap_dispatch<false, 2>(a, st);
}
