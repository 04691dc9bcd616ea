// The split-S KIVI decode kernel (csrc/kivi_split.cuh) for the K4V8 cache:
// int8 V rows with per-token scales. Its own translation unit, so that
// nvcc builds it beside the Int4 instances.
#include "kivi_split.cuh"

cudaError_t kivi_split_k4v8(const KiviSplitArgs& a, cudaStream_t st) {
  return kivi_split_dispatch<false>(a, st);
}
