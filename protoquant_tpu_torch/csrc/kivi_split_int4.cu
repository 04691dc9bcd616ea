// The split-S KIVI decode kernel (csrc/kivi_split.cuh) for the Int4 cache:
// V packed as token pairs with parity-split per-token scales. Its own
// translation unit, so that nvcc builds it beside the K4V8 instances.
#include "kivi_split.cuh"

cudaError_t kivi_split_int4(const KiviSplitArgs& a, cudaStream_t st) {
  return kivi_split_dispatch<true>(a, st);
}
