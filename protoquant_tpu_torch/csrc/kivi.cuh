// Shared arithmetic of the KIVI caches (K4V8KVCache, Int4KVCache): nibble
// unpack and pack, and the chunk requantizer of
// core/numerics.py:kivi_chunk_quantize, bit for bit:
//   s   = max(amax * f32(1/7), 1e-12)        (a multiply by the constant)
//   nib = clamp(rint(x / s), -7, 7)          (IEEE division, half to even)
// with x = int8 code * its per-token scale, one f32 product. Spelled with
// __fmul_rn / __fdiv_rn so no flag or contraction changes a rounding.
#pragma once

#include "common.cuh"

// 1/7 rounded once to f32, as jnp.float32(1.0 / 7.0)
#define PQ_INV7 ((float)(1.0 / 7.0))

// Signed nibbles of a byte given sign-extended in an int.
__device__ __forceinline__ int pq_nib_lo(int byte) { return (int)((unsigned)byte << 28) >> 28; }
__device__ __forceinline__ int pq_nib_hi(int byte) { return (int)((unsigned)byte << 24) >> 28; }

// Byte e (0..3) of a 32-bit word, sign-extended.
__device__ __forceinline__ int pq_byte(int word, int e) { return (int)(int8_t)(word >> (8 * e)); }

__device__ __forceinline__ int8_t pq_pack_nibs(int lo, int hi) {
  return (int8_t)((lo & 0x0F) | (hi << 4));
}

__device__ __forceinline__ float pq_kivi_scale(float amax) {
  return fmaxf(__fmul_rn(amax, PQ_INV7), PQ_SCALE_EPS);
}

__device__ __forceinline__ int pq_kivi_code(float x, float s) {
  return (int)fminf(fmaxf(rintf(__fdiv_rn(x, s)), -7.0f), 7.0f);
}
