// What the split-S decode attentions share: kivi_split.cuh (the K4V8 and
// Int4 caches) and attn_split.cuh (the int8 and K8V4 caches). Asynchronous
// copies into shared memory, exact int8 and nibble conversions, q loads, and
// the merge of the splits' partials (split_merge, in split_merge.cu).
//
// The merge: one block of SM_THREADS threads per (query row, kv head, b)
// merges that row's partials in split order. The splits' (m, l) are staged
// in shared memory; m = max(sink, the m of every split with l > 0); each
// split's weight w_i = e^(m_i - m) (0 where l_i = 0) is computed once; l =
// (sink ? e^(sink - m) : 0) + sum l_i w_i in split order by every thread;
// then thread (g, c) sums w_i acc_i over the splits i = g mod SG (SG =
// SM_THREADS / (Dh / 4)) in split order on its four dims, and the SG sums
// meet in shared memory in order g = 0, 1, ...: out = sum / max(l, 1e-30),
// cast to q's type. The learned sink joins here once, as the initial state
// m = sink, l = 1, acc = 0. No atomics: two calls on the same inputs give
// the same bits. Bound: the live splits' partials, read once; the many
// threads keep several splits' loads in flight at once.

#pragma once

#include "kivi.cuh"

constexpr float SP_NEG_INF = -1e30f;
constexpr int SP_MAX_SPLITS = 2048;  // the merge keeps (m, l, w) of each in shared memory

// The partials of a split decode and what the merge writes: acc [B, KV,
// n_split, R, Dh] f32 (not normalised), (m, l) [B, KV, n_split, R], sink [H]
// f32 or null, out [B, T, H, Dh] in q's dtype; R = T * (H / KV).
struct SplitMergeArgs {
  const float* part_acc;
  const float2* part_ml;
  const float* sink;
  void* out;
  int q_dtype;
  int B, T, H, KV, Dh, n_split;
};

// Launches the merge on ``st``; defined in split_merge.cu.
cudaError_t split_merge(const SplitMergeArgs& a, cudaStream_t st);

// The signed nibble at bit ``sh`` of a word given as x = word ^ 0x88888888
// (every nibble biased by 8), as an f32: 2^23 + (nib + 8) - (2^23 + 8), exact.
__device__ __forceinline__ float sp_nib(unsigned x, int sh) {
  return __fsub_rn(__uint_as_float(0x4B000000u | ((x >> sh) & 0xFu)), 8388616.0f);
}

// The signed byte e of a word given as x = word ^ 0x80808080, as an f32, exact.
__device__ __forceinline__ float sp_byte(unsigned x, int e) {
  return __fsub_rn(__uint_as_float(__byte_perm(x, 0x4B000000u, 0x7650 + e)), 8388736.0f);
}

__device__ __forceinline__ float sp_load_q(const void* q, int dtype, size_t i) {
  if (dtype == PQ_BF16) return __bfloat162float(((const __nv_bfloat16*)q)[i]);
  if (dtype == PQ_F16) return __half2float(((const __half*)q)[i]);
  return ((const float*)q)[i];
}

// N (1, 2, 4 or 8) bytes at p as words (the rest zero).
template <int N>
__device__ __forceinline__ void sp_load_bytes(const int8_t* p, unsigned (&w)[(N + 3) / 4]) {
  if constexpr (N == 8) {
    const uint2 v = *(const uint2*)p;
    w[0] = v.x;
    w[1] = v.y;
  } else if constexpr (N == 4) {
    w[0] = *(const unsigned*)p;
  } else if constexpr (N == 2) {
    w[0] = *(const unsigned short*)p;
  } else {
    w[0] = *(const unsigned char*)p;
  }
}
