// The split-S decode kernel (csrc/attn_split.cuh) over the K8V4 cache: int8
// K, packed int4 V token pairs with parity-split scales; full causal with a
// score scale (VAR = 0). Its own translation unit, so that nvcc builds it
// beside the others.
#include "attn_split.cuh"

cudaError_t attn_split_k8v4(const AttnSplitArgs& a, cudaStream_t st) {
  return as_dispatch<true, 0>(a, st);
}
