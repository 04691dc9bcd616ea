// The prefill attention kernel (csrc/attn_prefill.cuh): the K8V4 instances
// (packed int4 V, VAR = 0). Its own translation unit, so that nvcc builds it
// beside the others.
#include "attn_prefill.cuh"

cudaError_t attn_prefill_k8v4(const AttnPrefillArgs& a, cudaStream_t st) {
  return ap_dispatch<true, 0>(a, st);
}
