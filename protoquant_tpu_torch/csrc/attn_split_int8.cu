// The split-S decode kernel (csrc/attn_split.cuh) over the dense int8
// cache: the full-causal instances (VAR = 0) and the window and softcap ones
// (VAR = 1). Its own translation unit, so that nvcc builds it beside the
// others.
#include "attn_split.cuh"

cudaError_t attn_split_int8(const AttnSplitArgs& a, int var, cudaStream_t st) {
  return var == 0 ? as_dispatch<false, 0>(a, st) : as_dispatch<false, 1>(a, st);
}
