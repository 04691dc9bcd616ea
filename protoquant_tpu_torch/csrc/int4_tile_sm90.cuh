// The weight-only and int4-weight GEMMs at prefill sizes on TMA and wgmma:
// the tile kernel that ops/wo4_matmul.py, ops/w4a8_matmul.py and
// ops/wo_matmul.py route every product of more token rows than the body's
// decode threshold to (SPLIT_DECODE_MAX_M, INT4_DECODE_MAX_M,
// GROUP_DECODE_MAX_M, WO_DECODE_MAX_M: prefill chunks, the experts at
// prefill), for four bodies (instanced in wo4_tile.cu, w4a8_tile.cu,
// w4a8_group_tile.cu and wo_tile.cu):
//   SPLIT (B11, weight-only int4 "split"; replaces
//          protoquant_tpu/ops/wo4_matmul.py:_wo4_split_kernel): x in bf16; for
//          each K-group in ascending order p = x_g . q_g (exact bf16 x code
//          products summed in f32), acc = acc + p * s[n, g], a separate f32
//          multiply and add; out = cast(acc + bias).
//   TWO_LEVEL (B12, W4A8 "two_level"; replaces
//          protoquant_tpu/ops/w4a8_matmul.py:_w4a8_2l_kernel): each code
//          requantized to int8, w8 = rint(q * r16[n, g]) (an f32 multiply, then
//          an add of 1.5 * 2^23 that rounds half to even); one exact int32 sum
//          over all of K; out = cast((f32(acc) * (s_x * 0.0625)) * scol[n] + bias).
//   GROUP (B12, W4A8 "group"; replaces
//          protoquant_tpu/ops/w4a8_matmul.py:_w4a8_kernel): for each K-group
//          in ascending order an exact int32 sum p of int8 x code products,
//          acc = acc + f32(p) * s[n, g], a separate f32 multiply and add;
//          out = cast(acc * s_x + bias), bit for bit the plain version's.
//   WO8 (B5, weight-only int8; replaces protoquant_tpu/ops/wo_matmul.py:_wo_kernel):
//          x in bf16; one f32 sum over all of K of exact bf16 x int8 products;
//          out = cast(acc * s_w[n] + bias), a separate f32 multiply and add.
// The int4 weight is packed [N, K/2] int8 (core/numerics.py pack_int4): within
// each group of g codes, byte j of the group's g/2 bytes holds k = j in its
// low nibble and k = j + g/2 in its high nibble. The int8 weight is [N, K].
//
// Bound on the H100 (7B gate/up, M 256, g 128): operations, 2 M N K at the
// dense peak (bf16 989 TFLOP/s: 23.3 us; int8 1979 TOP/s: 11.7 us); the
// packed weight and its table (24 MB, 7.1 us at 3.35 TB/s) only below ~100
// tokens (WO8's 45 MB, 13.5 us, below ~190). So the products must run on
// wgmma, every weight byte should leave device memory once per token tile,
// and the unpacking must hide under the products. (Measured, PERF.md: the
// consumers' chain of conversion, products and SPLIT's group epilogue
// bounds it, not its loads.) Design:
// - out^T = W x^T: a block owns 128 weight rows (the outputs n; two consumer
//   warp groups of 64, wgmma's M side) by BT tokens (64, 128 or 256, wgmma's
//   N side), so a chunk of 33-64 rows wastes at most 31 of 64 columns.
// - The weight is wgmma's A operand from registers. K runs in stages of 64
//   packed bytes of every weight row (128 codes). TMA brings a stage's
//   packed bytes (128 rows x 64 bytes, 64-byte swizzle: a thread reading 4
//   bytes of rows g and g + 8 of its warp hits no bank twice) and the two
//   64-code halves of activations they multiply (BT rows each, K-major, the
//   B operand: int8 with the 64-byte swizzle, bf16 with the 128-byte one).
//   With g >= 128 a stage is half of a group or one group: half 0 holds the
//   codes of the stage's low nibbles, half 1 of its high nibbles; with g 32
//   or 64 a stage holds whole groups and the halves are in K order. No
//   unpacked copy of W exists in shared or device memory.
// - A consumer thread reads, for each of its two weight rows, one word of
//   each 16-byte chunk of the stage (the bf16 body gathers bytes 2t, 2t + 1,
//   2t + 8, 2t + 9 of the chunk with one byte permute, the k pattern of
//   wgmma's bf16 A fragment, whose layout a warp shares with mma.sync's),
//   and turns each word's low and high nibbles into the A fragments of two
//   k steps: bf16 codes by a byte permute and one bf16x2 subtract (exact);
//   int8 codes by the requant: with g >= 128 a stage's one group per row
//   gets a table of its 16 requantized codes (a quad of threads shares a
//   row and builds a quarter each), looked up 4 codes at a time by byte
//   permutes (i4t_lookup); with g 32 or 64 per code (a permute makes the
//   code's f32, three f32 operations round it, three permutes pack four).
//   The B descriptor of each k step points at the activations of those
//   codes (the map depends on the group kind GK: 0 for g 32, 1 for g 64, 2
//   for g 128 and 256).
// - WO8 takes stages of 64 codes: TMA brings the weight rows' 64 bytes (the
//   64-byte swizzle) and one half of activations (128-byte stages ran no
//   faster at 256 tokens, PERF.md). A k16 step takes chunk c of a row: the
//   thread reads the words holding bytes 2t, 2t + 1 and 2t + 8, 2t + 9
//   (k 2t, 2t + 1, 2t + 8, 2t + 9, wgmma's bf16 A fragment) and turns each
//   pair into bf16 by pq_int8_pair_bf16 (a permute, two ANDs, a bf16x2
//   subtract: exact). No group epilogue and no table: one accumulator set,
//   chained over the block's K range, so its token tile goes to 256.
// - Warp specialised as qmatmul.cu: a TMA producer warp group (setmaxnreg
//   40) keeps a ring of stages full behind full and empty mbarriers; two
//   consumer groups (232 registers) convert and multiply. A consumer keeps
//   up to I4T_NBUF k steps' products in flight (as many fragment buffers,
//   wgmma.wait_group NBUF - 1 before one is refilled), converting the next
//   step while they run. Every step multiplies, rows and columns past
//   N, M or K included (TMA's zeros): a wgmma inside a branch makes ptxas
//   serialise them (C7518).
// - SPLIT keeps the group's partial p in its own accumulators: a group's
//   first wgmma starts them at zero (scale-d 0); after its last, the consumer
//   waits for its products and adds p * s to the running sum (2 x BT / 2
//   registers, so BT <= 128); the other consumer group's products run
//   meanwhile. (Two partials, each group's scale pass delayed until its
//   buffer came round again, at BT 64, ran slower; PERF.md has the times.)
//   GROUP does the same with TWO_LEVEL's int8 operands: the codes by the
//   biased-nibble subtract (no table), an exact int32 p, then acc +=
//   f32(p) * s. TWO_LEVEL chains one int32 sum over its whole K range.
// - K split over a thread block cluster of 1 to 8 blocks (ops/wo4_matmul.py
//   int4_tile_plan), at units of max(64, g / 2) packed bytes: every split
//   starts on a group boundary. GROUP takes 1: its f32 chain runs over the
//   groups in order, and partials summed afterwards would move its bits.
// - Epilogue as qmatmul.cu: each consumer stages its sums as a [token][weight
//   row] tile in the drained stages, block r of the cluster sums the
//   partials of its 1 / CS of the tokens in rank order over distributed
//   shared memory and stores whole output rows, 4 columns a thread. s_x,
//   scol and the bias are staged in shared memory before the main loop; the
//   group tables (s or r16) are read from device memory, a stage ahead for
//   TWO_LEVEL and GROUP. One launch, no workspace, capturable in a CUDA graph. The
//   arithmetic is the plain version's: __fmul_rn / __fadd_rn, never an FMA.
// PQ_I4T_ABLATE (tools/gemm_timing.py --int4 --ablate builds it): 1 no code
// conversion (the raw words are the fragments), 2 the loads alone (no
// conversion, no product), 3 SPLIT and GROUP without the group epilogue (one
// chain), 4 the conversion and products alone (no loads), 5 TWO_LEVEL's
// per-code requant at every group (no table).
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "int4_tile.cuh"  // w4_codes_bf16
#include "sm90_gemm.cuh"

#ifndef PQ_I4T_ABLATE
#define PQ_I4T_ABLATE 0
#endif

namespace i4t_cg = cooperative_groups;

constexpr int I4T_BW = 128;           // weight rows (outputs n) of a block
constexpr int I4T_SB = 64;            // (packed) weight bytes of a row a stage
constexpr int I4T_THREADS = 384;      // two consumer warp groups, then the producer
constexpr int I4T_MAX_SPLITS = 8;     // the portable cluster size
constexpr int I4T_NBUF = 4;           // A fragment buffers: k steps in flight a consumer
constexpr int I4T_SMEM = 200 * 1024;  // the ring's budget
constexpr int I4T_LDP = I4T_BW + 4;   // word stride of a staged tile row: no bank conflict

// The bodies: SPLIT, TWO_LEVEL and GROUP (int4, packed), WO8 (int8).
enum I4tBody { I4T_SPLIT = 0, I4T_TWO_LEVEL = 1, I4T_WO8 = 2, I4T_GROUP = 3 };

template <int BODY, int BT>
struct I4tShape {
  // bytes of an activation: int8 (W4A8) or bf16
  static constexpr int EA = BODY == I4T_TWO_LEVEL || BODY == I4T_GROUP ? 1 : 2;
  static constexpr int HALVES = BODY == I4T_WO8 ? 1 : 2;  // activation halves a stage
  static constexpr int HALF = BT * 64 * EA;            // one 64-code half of the activations
  static constexpr int W = I4T_BW * I4T_SB;            // the (packed) weight tile
  static constexpr int STAGE = HALVES * HALF + W;
  static constexpr int STAGES = I4T_SMEM / STAGE < 8 ? I4T_SMEM / STAGE : 8;
  static constexpr int SMEM = STAGES * STAGE + 1024;   // + room to align to 1024
  // A fragment buffers (k steps in flight a consumer): 2 beside WO8's 128
  // accumulators at 256 tokens
  static constexpr int NBUF = BODY == I4T_WO8 && BT == 256 ? 2 : I4T_NBUF;
  static_assert(HALF % 1024 == 0 && W % 1024 == 0, "swizzled tiles stay 1024-aligned");
  static_assert(BT * I4T_LDP * 4 <= STAGES * STAGE, "the staged tile fits the stages");
  static_assert((BODY != I4T_SPLIT && BODY != I4T_GROUP) || BT <= 128,
                "SPLIT and GROUP hold two accumulators");
};

// -- wgmma with A from registers ------------------------------------------------
// d[64 x N] (+)= A[64 x K] . B[N x K]^T: A in registers (a warp's 16 rows with
// the per-warp layout of mma.sync's A), B K-major in shared memory with the
// swizzle its descriptor names; accumulate 0 starts d at the product. Thread
// (warp w of the group, lane l) holds d[4 j + 2 h + e] at row 16 w + l / 4 +
// 8 h, column 8 j + 2 (l % 4) + e. Overloaded by the accumulator: int8 k32
// (int) or bf16 k16 (float), N = 2 x its length.

__device__ __forceinline__ void i4t_mma(
    int (&d)[32], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void i4t_mma(
    int (&d)[64], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void i4t_mma(
    int (&d)[128], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, "
      "%126, %127"
      "}, {%128, %129, %130, %131}, %132, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void i4t_mma(
    float (&d)[32], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void i4t_mma(
    float (&d)[64], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void i4t_mma(
    float (&d)[128], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, "
      "%126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// -- the kernel -------------------------------------------------------------------

// Keep the compiler from moving reads or writes of accumulators across the
// asynchronous products.
template <int R>
__device__ __forceinline__ void i4t_fence(int (&d)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) asm volatile("" : "+r"(d[r])::"memory");
}
template <int R>
__device__ __forceinline__ void i4t_fence(float (&d)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) asm volatile("" : "+f"(d[r])::"memory");
}

// Four biased nibbles (code + 8, one a byte) -> four int8 bytes rint(code * r):
// byte i becomes the f32 2^23 + u by one byte permute (bits 0x4B0000uu), less
// 2^23 + 8 the code, exactly; an f32 multiply, then an add of 1.5 * 2^23 that
// rounds to an integer, half to even, in the low byte of the sum (|code * r|
// <= 128); three permutes gather the four low bytes.
__device__ __forceinline__ uint32_t i4t_requant(uint32_t u, float r) {
  uint32_t y[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float code =
        __fadd_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | i)), -8388616.0f);
    y[i] = __float_as_uint(__fadd_rn(__fmul_rn(code, r), 12582912.0f));
  }
  return __byte_perm(__byte_perm(y[0], y[1], 0x0040), __byte_perm(y[2], y[3], 0x0040), 0x5410);
}

// The low (n 0) or high (n 1) nibbles of a word, biased (code + 8), a byte each.
__device__ __forceinline__ uint32_t i4t_nibbles(uint32_t w, int n) {
  return ((n ? w >> 4 : w) & 0x0F0F0F0Fu) ^ 0x08080808u;
}

// PTX prmt in its default mode: byte i of the result is byte (s_i & 7) of
// {a, b}, or, where bit 3 of s's nibble i is set, that byte's sign bit
// replicated over all 8 bits (CUDA's __byte_perm documents 3-bit selectors).
__device__ __forceinline__ uint32_t i4t_prmt(uint32_t a, uint32_t b, uint32_t s) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(s));
  return d;
}

// The requantized codes of the low (n 0) or high (n 1) nibbles of a word, a
// byte each, from a row's table ``tw`` (entry e of word e / 4, byte e % 4,
// the code of raw nibble e): the nibbles' low 3 bits, packed into a
// selector, pick among entries 0-7 and 8-15, and each nibble's bit 3,
// replicated over its byte, picks one.
__device__ __forceinline__ uint32_t i4t_lookup(const uint32_t (&tw)[4], uint32_t w, int n) {
  const uint32_t v = (n ? w >> 4 : w) & 0x07070707u;
  const uint32_t sel = __byte_perm(v | (v >> 4), 0, 0x0020);
  const uint32_t m = i4t_prmt(n ? w : w << 4, 0, 0xBA98);  // bit 7 of each byte, replicated
  return (__byte_perm(tw[0], tw[1], sel) & ~m) | (__byte_perm(tw[2], tw[3], sel) & m);
}

// Columns col .. col + 3 of output row ``row``, as far as N goes: one aligned
// store where N % 4 == 0.
template <typename OutT>
__device__ __forceinline__ void i4t_store4(OutT* __restrict__ out, int row, int col, int N,
                                           const float (&y)[4]) {
  OutT* p = out + (size_t)row * N + col;
  if ((N & 3) == 0) {
    struct alignas(4 * sizeof(OutT)) Quad { OutT v[4]; } q;
#pragma unroll
    for (int e = 0; e < 4; ++e) q.v[e] = pq_from_float<OutT>(y[e]);
    *reinterpret_cast<Quad*>(p) = q;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (col + e < N) p[e] = pq_from_float<OutT>(y[e]);
  }
}

// Byte offset of the 16-byte chunk c of weight row r in a stage's (packed)
// weight tile (rows of 64 bytes, the 64-byte swizzle).
__device__ __forceinline__ int i4t_wchunk(int r, int c) {
  return r * I4T_SB + ((c ^ ((r >> 1) & 3)) << 4);
}

// The packed bytes [64 st, 64 st + 64) of every weight row multiply the
// activations of two 64-code halves; the first starts at this K.
__device__ __forceinline__ int i4t_half0(int st, int group) {
  const int b0 = st * I4T_SB, half = group / 2;
  return (b0 / half) * group + b0 % half;
}

template <int BODY, int BT, int GK>
__global__ void __launch_bounds__(I4T_THREADS, 1)
int4_tile_kernel(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_w, const float* __restrict__ table,
                 const float* __restrict__ sx, const float* __restrict__ scol,
                 const float* __restrict__ bias, void* __restrict__ out, int out_dtype, int M,
                 int N, int K, int group) {
  using S = I4tShape<BODY, BT>;
  constexpr bool SPLIT = BODY == I4T_SPLIT, WO8 = BODY == I4T_WO8, GROUP = BODY == I4T_GROUP;
  constexpr bool INT8X = BODY == I4T_TWO_LEVEL || GROUP;  // int8 activations with s_x
  using Acc = typename std::conditional<BODY == I4T_TWO_LEVEL, int, float>::type;
  // the group's partial (SPLIT f32, GROUP int32)
  using Part = typename std::conditional<GROUP, int, float>::type;
  constexpr int NB = S::NBUF;
  constexpr int GPS = GK == 0 ? 4 : GK == 1 ? 2 : 1;  // groups a stage touches
  constexpr int NA = BT / 2;                          // accumulators a thread
  extern __shared__ __align__(1024) uint8_t i4t_smem_raw[];
  __shared__ __align__(8) uint64_t full[S::STAGES], empty[S::STAGES];
  __shared__ float sx_s[BT], scol_s[I4T_BW], bias_s[I4T_BW];
  const uint32_t raw = sm90_smem_addr(i4t_smem_raw);
  uint8_t* const smem = i4t_smem_raw + (((raw + 1023u) & ~1023u) - raw);

  i4t_cg::cluster_group cluster = i4t_cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int m0 = (int)(blockIdx.x / cs) * BT, n0 = (int)blockIdx.y * I4T_BW;
  const int half = group / 2, G = K / group;
  // this block's stages [st_lo, st_hi): units of max(64, g / 2) packed bytes
  // (WO8: a stage)
  const int upu = !WO8 && half > I4T_SB ? half / I4T_SB : 1;  // stages a unit
  const int stages = ((WO8 ? K : K / 2) + I4T_SB - 1) / I4T_SB;
  const int units = (stages + upu - 1) / upu;
  const int st_lo = upu * (rank * units / cs);
  const int st_hi = min(stages, upu * ((rank + 1) * units / cs));

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival from each consumer group
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    // producer: one thread keeps the ring full
    regs_dealloc<40>();
    if (threadIdx.x == 256) {
      int s = 0;
      uint32_t ph = 0;
      for (int st = st_lo; st < st_hi; ++st) {
        mbar_wait(&empty[s], ph ^ 1);
#if PQ_I4T_ABLATE == 4
        mbar_arrive(&full[s]);  // the products alone, on whatever the stage holds
#else
        mbar_arrive_expect_tx(&full[s], S::STAGE);
        uint8_t* const base = smem + s * S::STAGE;
        if constexpr (WO8) {  // the stage's codes [k0, k0 + 64): activations, weight bytes
          const int k0 = st * I4T_SB;
          tma_load_2d(base, &map_x, &full[s], k0, m0);
          tma_load_2d(base + S::HALF, &map_w, &full[s], k0, n0);
        } else {
          const int k0 = i4t_half0(st, group);
          tma_load_2d(base, &map_x, &full[s], k0, m0);
          tma_load_2d(base + S::HALF, &map_x, &full[s], k0 + max(half, 64), m0);
          tma_load_2d(base + 2 * S::HALF, &map_w, &full[s], st * I4T_SB, n0);
        }
#endif
        if (++s == S::STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    if (cs > 1) {  // the consumers' two cluster barriers
      cluster_barrier();
      cluster_barrier();
    }
  } else {
    // consumers: group wg owns weight rows [64 wg, 64 wg + 64) of the block;
    // thread (warp w, lane l) rows r0 = 64 wg + 16 w + l / 4 and r0 + 8
    regs_alloc<232>();
    const int t = threadIdx.x;
    const int l = t & 31, q4 = l & 3;
    const int r0 = 64 * wg + 16 * ((t >> 5) & 3) + (l >> 2);
    if (t < BT) sx_s[t] = INT8X && m0 + t < M ? sx[m0 + t] : 0.0f;
    if (t < I4T_BW) {
      scol_s[t] = !SPLIT && !GROUP && n0 + t < N ? scol[n0 + t] : 0.0f;
      bias_s[t] = bias != nullptr && n0 + t < N ? bias[n0 + t] : 0.0f;
    }
    // the thread's table entries (s or r16) of stage st's groups, zeros past
    // N, G or the block's stages
    auto load_tab = [&](int st, float (&v)[2][GPS]) {
      const int gi0 = st * I4T_SB / half;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = n0 + r0 + 8 * h;
#pragma unroll
        for (int q = 0; q < GPS; ++q)
          v[h][q] = row < N && gi0 + q < G && st < st_hi
                        ? __ldg(table + (size_t)row * G + gi0 + q) : 0.0f;
      }
    };

    Acc acc[NA];
    Part p[SPLIT || GROUP ? NA : 1];  // SPLIT, GROUP: the group's partial
#pragma unroll
    for (int e = 0; e < NA; ++e) acc[e] = 0;
#pragma unroll
    for (int e = 0; e < (SPLIT || GROUP ? NA : 1); ++e) p[e] = 0;
    uint32_t ab[NB][4];  // the A fragments of NB k steps
    float tab[2][GPS], tab_next[2][GPS];
    if (!WO8) load_tab(st_lo, tab);

    int s = 0, prev = 0;
    uint32_t ph = 0;
    for (int st = st_lo; st < st_hi; ++st) {
      // TWO_LEVEL, GROUP: a stage ahead (the requant needs it first; GROUP's
      // first group may end after one product)
      if (INT8X) load_tab(st + 1, tab_next);
      mbar_wait(&full[s], ph);
      const uint8_t* const ws = smem + s * S::STAGE + S::HALVES * S::HALF;
      const uint32_t xa = sm90_smem_addr(smem + s * S::STAGE);  // half 0; half h at + h HALF
      if constexpr (WO8) {
        // 4 k16 steps: step c takes chunk c of the thread's rows r0 and r0 + 8,
        // k 2t, 2t + 1 (bytes 2t, 2t + 1 of word t / 2) and 2t + 8, 2t + 9 (of
        // word 2 + t / 2), and the activations' 32 bytes at 32 c
        const uint32_t sel = (q4 & 1) ? 0x4342u : 0x4140u;
        const int wo = 4 * (q4 >> 1);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
#if PQ_I4T_ABLATE == 2
          if (c == 0 && (t & 127) == 0) mbar_arrive(&empty[s]);  // nothing reads the stage
          continue;
#endif
          // the products that read ab[c % NB] are done; after step NB - 1's
          // wait, all the last stage's are
          wgmma_wait<NB - 1>();
          if (c == NB - 1 && st > st_lo && (t & 127) == 0) mbar_arrive(&empty[prev]);
          const uint8_t* const w0 = ws + i4t_wchunk(r0, c) + wo;
          const uint8_t* const w1 = ws + i4t_wchunk(r0 + 8, c) + wo;
          uint32_t (&a)[4] = ab[c % NB];
          a[0] = *reinterpret_cast<const uint32_t*>(w0);
          a[1] = *reinterpret_cast<const uint32_t*>(w1);
          a[2] = *reinterpret_cast<const uint32_t*>(w0 + 8);
          a[3] = *reinterpret_cast<const uint32_t*>(w1 + 8);
#if PQ_I4T_ABLATE != 1
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = pq_int8_pair_bf16(a[i], sel);
#endif
          wgmma_fence();
          i4t_mma(acc, a, wgmma_desc_sw128(xa + 32 * c), 1);
          wgmma_commit();
        }
      } else {
        // the thread's word of each chunk c of its rows r0 + 8 h
        uint32_t wv[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const uint8_t* const ch = ws + i4t_wchunk(r0 + 8 * h, c);
            if (SPLIT) {  // bytes 2t, 2t + 1, 8 + 2t, 9 + 2t: k 2t, 2t + 1, 2t + 8, 2t + 9
              const uint32_t a = *reinterpret_cast<const uint32_t*>(ch + 4 * (q4 >> 1));
              const uint32_t b = *reinterpret_cast<const uint32_t*>(ch + 8 + 4 * (q4 >> 1));
              wv[h][c] = __byte_perm(a, b, (q4 & 1) ? 0x7632 : 0x5410);
            } else {      // bytes 4t .. 4t + 3: k 4t .. 4t + 3
              wv[h][c] = *reinterpret_cast<const uint32_t*>(ch + 4 * q4);
            }
          }
#if PQ_I4T_ABLATE == 2
        (void)wv;
        if ((t & 127) == 0) mbar_arrive(&empty[s]);
#else
        if constexpr (SPLIT) {
          // 8 k16 steps: chunk c = j / 2, nibble n = j % 2
          const bool opens = group != 256 || (st & 1) == 0;   // the stage opens a group
          const bool closes = group != 256 || (st & 1) == 1;  // the stage closes one
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c = j >> 1, n = j & 1;
            // the products that read ab[j % NBUF] are done (a stage starts drained)
            if (j >= I4T_NBUF) wgmma_wait<I4T_NBUF - 1>();
            uint32_t (&a)[4] = ab[j % I4T_NBUF];
#if PQ_I4T_ABLATE == 1
            a[0] = wv[0][c]; a[1] = wv[1][c]; a[2] = wv[0][c] >> n; a[3] = wv[1][c] >> n;
#else
            uint32_t b0[2], b1[2];
            w4_codes_bf16(i4t_nibbles(wv[0][c], n), b0);
            w4_codes_bf16(i4t_nibbles(wv[1][c], n), b1);
            a[0] = b0[0];
            a[1] = b1[0];
            a[2] = b0[1];
            a[3] = b1[1];
#endif
            // the step's 16 activations: (half, byte offset) by group kind
            const int hb = GK == 2 ? n : c >> 1;
            const int ob = GK == 2   ? 32 * c
                           : GK == 1 ? 32 * (c & 1) + 64 * n
                                     : 64 * (c & 1) + 32 * n;
            const bool first = PQ_I4T_ABLATE == 3
                                   ? j == 0 && st == st_lo
                                   : GK == 0 ? n == 0 : GK == 1 ? (j & 3) == 0 : j == 0 && opens;
            wgmma_fence();
            i4t_mma(p, a, wgmma_desc_sw128(xa + hb * S::HALF + ob), first ? 0 : 1);
            wgmma_commit();
            const bool ends = GK == 0 ? n == 1 : GK == 1 ? (j & 3) == 3 : j == 7;
            if (ends) {
              wgmma_wait<0>();
              i4t_fence(p);
#if PQ_I4T_ABLATE != 3
              if (GK != 2 || closes) {
                const int q = GK == 0 ? c : GK == 1 ? c >> 1 : 0;
#pragma unroll
                for (int e = 0; e < NA; ++e)
                  acc[e] = __fadd_rn(acc[e], __fmul_rn(p[e], tab[(e >> 1) & 1][q]));
              }
#endif
            }
          }
          if ((t & 127) == 0) mbar_arrive(&empty[s]);  // every product of the stage is done
          if (st + 1 < st_hi) load_tab(st + 1, tab);
        } else if constexpr (GROUP) {
          // 4 k32 steps, TWO_LEVEL's map of chunks, nibbles and activations;
          // the codes by the biased-nibble subtract. A group's first product
          // starts p at zero; after its last the consumer waits for its
          // products and adds f32(p) * s to acc. Every stage ends with a
          // group's end or, at g = 256, half of one: drained either way.
          const bool opens = group != 256 || (st & 1) == 0;   // the stage opens a group
          const bool closes = group != 256 || (st & 1) == 1;  // the stage closes one
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int sj = j >> 1, n = j & 1;
            const int cx = GK == 0 ? j : 2 * sj, cy = GK == 0 ? j : 2 * sj + 1;
            const int nx = GK == 0 ? 0 : n, ny = GK == 0 ? 1 : n;
            uint32_t (&a)[4] = ab[j % I4T_NBUF];  // a stage starts drained
#if PQ_I4T_ABLATE == 1
            a[0] = wv[0][cx] >> nx; a[1] = wv[1][cx] >> nx;
            a[2] = wv[0][cy] >> ny; a[3] = wv[1][cy] >> ny;
#else
            a[0] = w4_codes_s8(i4t_nibbles(wv[0][cx], nx));
            a[1] = w4_codes_s8(i4t_nibbles(wv[1][cx], nx));
            a[2] = w4_codes_s8(i4t_nibbles(wv[0][cy], ny));
            a[3] = w4_codes_s8(i4t_nibbles(wv[1][cy], ny));
#endif
            const int hb = GK == 2 ? n : GK == 1 ? sj : j >> 1;
            const int ob = GK == 2 ? 32 * sj : GK == 1 ? 32 * n : 32 * (j & 1);
            const bool first = PQ_I4T_ABLATE == 3 ? j == 0 && st == st_lo
                               : GK == 0          ? true
                               : GK == 1          ? n == 0
                                                  : j == 0 && opens;
            wgmma_fence();
            i4t_mma(p, a, wgmma_desc_sw64(xa + hb * S::HALF + ob), first ? 0 : 1);
            wgmma_commit();
            const bool ends = GK == 0 ? true : GK == 1 ? n == 1 : j == 3;
            if (ends) {
              wgmma_wait<0>();
              i4t_fence(p);
#if PQ_I4T_ABLATE != 3
              if (GK != 2 || closes) {
                const int q = GK == 0 ? j : GK == 1 ? sj : 0;
#pragma unroll
                for (int e = 0; e < NA; ++e)
                  acc[e] = __fadd_rn(acc[e],
                                     __fmul_rn(__int2float_rn(p[e]), tab[(e >> 1) & 1][q]));
              }
#endif
            }
          }
          if ((t & 127) == 0) mbar_arrive(&empty[s]);  // every product of the stage is done
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int q = 0; q < GPS; ++q) tab[h][q] = tab_next[h][q];
        } else {
          // GK 2 (the stage inside one group): each row's 16 requantized codes
          // as a table of 4 words, entry n the raw nibble n's code; thread t of
          // a quad (which shares its rows) builds word t
          uint32_t tw[2][4];
          if (GK == 2 && PQ_I4T_ABLATE != 5) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint32_t mine = i4t_requant((0x03020100u + 0x04040404u * q4) ^ 0x08080808u,
                                                tab[h][0]);
#pragma unroll
              for (int q = 0; q < 4; ++q) tw[h][q] = __shfl_sync(0xffffffffu, mine, (l & ~3) | q);
            }
          }
          // 4 k32 steps; GK 1, 2: step j = 2 sj + n takes nibble n of chunks
          // 2 sj (k 0-15 of the step) and 2 sj + 1 (k 16-31); GK 0: step j takes
          // chunk j, its low nibbles k 0-15 and high k 16-31
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int sj = j >> 1, n = j & 1;
            // the products that read ab[j] (the last stage's step j) are done; after
            // the last step's wait, all the last stage's are
            wgmma_wait<I4T_NBUF - 1>();
            if (j == 3 && st > st_lo && (t & 127) == 0) mbar_arrive(&empty[prev]);
            const int cx = GK == 0 ? j : 2 * sj, cy = GK == 0 ? j : 2 * sj + 1;
            const int nx = GK == 0 ? 0 : n, ny = GK == 0 ? 1 : n;
            const int qx = GK == 0 ? cx : GK == 1 ? cx >> 1 : 0;
            const int qy = GK == 0 ? cy : GK == 1 ? cy >> 1 : 0;
            uint32_t (&a)[4] = ab[j % I4T_NBUF];
#if PQ_I4T_ABLATE == 1
            a[0] = wv[0][cx] >> nx; a[1] = wv[1][cx] >> nx;
            a[2] = wv[0][cy] >> ny; a[3] = wv[1][cy] >> ny;
#else
            if (GK == 2 && PQ_I4T_ABLATE != 5) {
              a[0] = i4t_lookup(tw[0], wv[0][cx], nx);
              a[1] = i4t_lookup(tw[1], wv[1][cx], nx);
              a[2] = i4t_lookup(tw[0], wv[0][cy], ny);
              a[3] = i4t_lookup(tw[1], wv[1][cy], ny);
            } else {
              a[0] = i4t_requant(i4t_nibbles(wv[0][cx], nx), tab[0][qx]);
              a[1] = i4t_requant(i4t_nibbles(wv[1][cx], nx), tab[1][qx]);
              a[2] = i4t_requant(i4t_nibbles(wv[0][cy], ny), tab[0][qy]);
              a[3] = i4t_requant(i4t_nibbles(wv[1][cy], ny), tab[1][qy]);
            }
#endif
            const int hb = GK == 2 ? n : GK == 1 ? sj : j >> 1;
            const int ob = GK == 2 ? 32 * sj : GK == 1 ? 32 * n : 32 * (j & 1);
            wgmma_fence();
            i4t_mma(acc, a, wgmma_desc_sw64(xa + hb * S::HALF + ob), 1);
            wgmma_commit();
          }
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int q = 0; q < GPS; ++q) tab[h][q] = tab_next[h][q];
        }
#endif
      }
      prev = s;
      if (++s == S::STAGES) {
        s = 0;
        ph ^= 1;
      }
    }
    wgmma_wait<0>();
    i4t_fence(acc);
#if PQ_I4T_ABLATE == 3
    if constexpr (SPLIT || GROUP) {
#pragma unroll
      for (int e = 0; e < NA; ++e) acc[e] = st_hi > st_lo ? (float)p[e] : 0.0f;
    }
#endif

    // The sums go to the drained stages as a [token][weight row] tile, so
    // the output leaves in whole rows: acc[4 j + 2 h + e] is token 8 j + 2 t
    // + e of row r0 + 8 h.
    named_barrier(1, 256);  // both groups' products have drained the stages
    Acc* const part = reinterpret_cast<Acc*>(smem);
#pragma unroll
    for (int j = 0; j < BT / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          part[(8 * j + 2 * q4 + e) * I4T_LDP + r0 + 8 * h] = acc[4 * j + 2 * h + e];
    if (cs > 1)
      cluster_barrier();  // every block's partial written
    else
      named_barrier(1, 256);

    // Block r of the cluster sums the partials of the tokens [r BT / cs,
    // (r + 1) BT / cs) in rank order and applies the epilogue, 4 columns a
    // thread, a warp a token.
    constexpr int CH = I4T_BW / 4;
    const int lo = rank * BT / cs * CH, hi = (rank + 1) * BT / cs * CH;
    const int cl = (t % CH) * 4;  // the thread's columns, the same in every row it takes
    if (n0 + cl < N) {
#pragma unroll 2
      for (int idx = lo + t; idx < hi; idx += 256) {
        const int rl = idx / CH;
        if (m0 + rl >= M) break;
        Acc v[4] = {0, 0, 0, 0};
        for (int c = 0; c < cs; ++c) {
          const Acc* src = cs == 1 ? part : cluster.map_shared_rank(part, c);
          const Acc* q = src + rl * I4T_LDP + cl;
          if constexpr (BODY != I4T_TWO_LEVEL) {
            const float4 f = *reinterpret_cast<const float4*>(q);
            if (c == 0) {
              v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
            } else {
              v[0] = __fadd_rn(v[0], f.x); v[1] = __fadd_rn(v[1], f.y);
              v[2] = __fadd_rn(v[2], f.z); v[3] = __fadd_rn(v[3], f.w);
            }
          } else {
            const int4 f = *reinterpret_cast<const int4*>(q);
            v[0] += f.x; v[1] += f.y; v[2] += f.z; v[3] += f.w;
          }
        }
        float y[4];
        const float sxr = BODY == I4T_TWO_LEVEL ? __fmul_rn(sx_s[rl], 0.0625f) : sx_s[rl];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          y[e] = SPLIT   ? (float)v[e]
                 : GROUP ? __fmul_rn((float)v[e], sxr)
                 : WO8   ? __fmul_rn((float)v[e], scol_s[cl + e])
                         : __fmul_rn(__fmul_rn(__int2float_rn((int)v[e]), sxr), scol_s[cl + e]);
          if (bias != nullptr) y[e] = __fadd_rn(y[e], bias_s[cl + e]);
        }
        if (out_dtype == PQ_F32)
          i4t_store4(static_cast<float*>(out), m0 + rl, n0 + cl, N, y);
        else if (out_dtype == PQ_BF16)
          i4t_store4(static_cast<__nv_bfloat16*>(out), m0 + rl, n0 + cl, N, y);
        else
          i4t_store4(static_cast<__half*>(out), m0 + rl, n0 + cl, N, y);
      }
    }
    if (cs > 1) cluster_barrier();  // no block leaves while another reads its partial
  }
}

// -- host ---------------------------------------------------------------------------

template <int BODY, int BT, int GK>
static cudaError_t i4t_launch(const void* x, const void* packed, const void* table,
                              const void* sx, const void* scol, const void* bias, void* out,
                              int out_dtype, int M, int N, int K, int group, int splits,
                              cudaStream_t stream) {
  using S = I4tShape<BODY, BT>;
  CUtensorMap map_x, map_w;
  cudaError_t err =
      S::EA == 2
          ? sm90_map_2d(&map_x, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K, 64, BT,
                        CU_TENSOR_MAP_SWIZZLE_128B)
          : sm90_map_2d(&map_x, x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, M, K, 64, BT,
                        CU_TENSOR_MAP_SWIZZLE_64B);
  if (err == cudaSuccess)  // WO8: int8 [N, K]; int4: packed [N, K / 2]
    err = sm90_map_2d(&map_w, packed, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, N,
                      BODY == I4T_WO8 ? K : K / 2, I4T_SB, I4T_BW, CU_TENSOR_MAP_SWIZZLE_64B);
  auto kernel = int4_tile_kernel<BODY, BT, GK>;
  static bool smem_set = false;
  if (err == cudaSuccess) err = pq_allow_smem(kernel, S::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((M + BT - 1) / BT * splits), (unsigned)((N + I4T_BW - 1) / I4T_BW));
  cfg.blockDim = dim3(I4T_THREADS);
  cfg.dynamicSmemBytes = S::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, map_x, map_w, (const float*)table, (const float*)sx,
                           (const float*)scol, (const float*)bias, out, out_dtype, M, N, K,
                           group);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int BODY, int BT>
static cudaError_t i4t_launch_g(const void* x, const void* packed, const void* table,
                                const void* sx, const void* scol, const void* bias, void* out,
                                int out_dtype, int M, int N, int K, int group, int splits,
                                cudaStream_t stream) {
  if (group == 32)
    return i4t_launch<BODY, BT, 0>(x, packed, table, sx, scol, bias, out, out_dtype, M, N, K,
                                    group, splits, stream);
  if (group == 64)
    return i4t_launch<BODY, BT, 1>(x, packed, table, sx, scol, bias, out, out_dtype, M, N, K,
                                    group, splits, stream);
  return i4t_launch<BODY, BT, 2>(x, packed, table, sx, scol, bias, out, out_dtype, M, N, K,
                                  group, splits, stream);
}

// Checks common to both entries: group 32, 64, 128 or 256 dividing K; k_splits
// 1 to 8 and at most the units of K; the operands 16-byte aligned; a known
// output type.
static bool i4t_args_ok(const void* x, const void* packed, int out_dtype, int K, int group,
                        int k_splits) {
  if (!(group == 32 || group == 64 || group == 128 || group == 256) || K <= 0 ||
      K % group != 0 || k_splits < 1 || k_splits > I4T_MAX_SPLITS || (uintptr_t)x % 16 != 0 ||
      (uintptr_t)packed % 16 != 0 || out_dtype < PQ_F32 || out_dtype > PQ_F16)
    return false;
  const int unit = group / 2 > I4T_SB ? group / 2 : I4T_SB;
  return k_splits <= (K / 2 + unit - 1) / unit;
}
