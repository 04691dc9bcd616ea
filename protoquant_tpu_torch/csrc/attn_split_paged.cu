// The split-S decode kernel (csrc/attn_split.cuh) over the paged int8 pool
// (PAGED): the plain instances (VAR 0) and the ALiBi ones (VAR 2), at the
// head dims the paged wrapper takes. Its own translation unit, so that nvcc
// builds it beside the others.
#include "attn_split.cuh"

template <int VAR>
static cudaError_t paged_dispatch(const AttnSplitArgs& a, cudaStream_t st) {
  switch (a.Dh) {
    case 64: return as_rows<64, false, VAR, true>(a, st);
    case 128: return as_rows<128, false, VAR, true>(a, st);
    case 256: return as_rows<256, false, VAR, true>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t attn_split_paged(const AttnSplitArgs& a, cudaStream_t st) {
  return a.alibi != nullptr ? paged_dispatch<2>(a, st) : paged_dispatch<0>(a, st);
}
