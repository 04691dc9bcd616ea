// The split-S decode kernel (csrc/attn_split.cuh) over the dense int8
// cache: the instances that also read ring positions, StreamingLLM sinks and
// ALiBi slopes (VAR = 2). Its own translation unit, so that nvcc builds it
// beside the others.
#include "attn_split.cuh"

cudaError_t attn_split_ext(const AttnSplitArgs& a, cudaStream_t st) {
  return as_dispatch<false, 2>(a, st);
}
