// The prefill attention kernel (csrc/attn_prefill.cuh): the window, softcap
// and learned-sink instances (VAR = 1). Its own translation unit, so that
// nvcc builds it beside the others.
#include "attn_prefill.cuh"

cudaError_t attn_prefill_var(const AttnPrefillArgs& a, cudaStream_t st) {
  return ap_dispatch<false, 1>(a, st);
}
