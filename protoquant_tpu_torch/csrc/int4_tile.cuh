// Nibble and MMA helpers of the int4-weight GEMMs (int4_decode.cuh's
// decode kernels, int4_tile_sm90.cuh's tile kernels).
//
// Packing (core/numerics.py pack_int4): within each group of g codes, byte j
// of the group's g/2 bytes holds k = j in its low nibble and k = j + g/2 in
// its high nibble. So 4 bytes of a weight row give the codes of two K
// steps (low nibbles, high nibbles) whose activations sit at the same 4
// offsets of the group's two halves: no shuffle of nibbles between threads.
#pragma once

#include "common.cuh"

// 4 bytes of a weight row -> each byte's low (lo) and high (hi) nibble as
// code + 8, one per byte (0 .. 15).
__device__ __forceinline__ void w4_biased_nibbles(uint32_t w, uint32_t& lo, uint32_t& hi) {
  lo = (w & 0x0F0F0F0Fu) ^ 0x08080808u;
  hi = ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
}

// Four biased nibbles -> their codes as int8 bytes (exact): u - 8 in each
// byte, as (u + 0x78) ^ 0x80, which no byte carries out of (u <= 15).
__device__ __forceinline__ uint32_t w4_codes_s8(uint32_t u) {
  return (u + 0x78787878u) ^ 0x80808080u;
}

// Four biased nibbles -> two bf16 pairs of their codes (exact): the bf16 of
// bits 0x43 << 8 | u is 128 + u, and 128 + u - 136 is the code.
__device__ __forceinline__ void w4_codes_bf16(uint32_t u, uint32_t* b) {
  const __nv_bfloat162 off = __floats2bfloat162_rn(136.0f, 136.0f);
  uint32_t v0 = __byte_perm(u, 0x43u, 0x4140);  // bytes 0, 1
  uint32_t v1 = __byte_perm(u, 0x43u, 0x4342);  // bytes 2, 3
  __nv_bfloat162 r0 = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v0), off);
  __nv_bfloat162 r1 = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v1), off);
  b[0] = *reinterpret_cast<uint32_t*>(&r0);
  b[1] = *reinterpret_cast<uint32_t*>(&r1);
}

__device__ __forceinline__ void w4_mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void w4_mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
