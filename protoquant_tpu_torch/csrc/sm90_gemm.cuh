// Hopper (sm_90a) building blocks for GEMM kernels: TMA tile loads with the
// 128-byte swizzle, mbarrier waits and arrivals, wgmma on operands in shared
// memory, and the host-side tensor maps. qmatmul.cu (B2's tile route) and
// int4_tile_sm90.cuh (B11 and B12's) are built from them.
//
// Layout contract between TMA and wgmma: a tile of R rows x 128 bytes of K,
// loaded by one cp.async.bulk.tensor with CU_TENSOR_MAP_SWIZZLE_128B into
// shared memory aligned to 1024 bytes, lies as R rows of 128 bytes, the
// 16-byte chunks of row r XOR-ed with r % 8. A wgmma descriptor over it is
// K-major with the 128-byte swizzle (layout type 1), 8-row groups 1024 bytes
// apart (SBO), and its start address moved 32 bytes along K per k32 step.
#pragma once

#include <cuda.h>
#include <dlfcn.h>

#include "common.cuh"

__device__ __forceinline__ uint32_t sm90_smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// -- mbarrier ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(sm90_smem_addr(bar)),
               "r"(count));
}

// Make the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and add ``bytes`` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   sm90_smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(sm90_smem_addr(bar))
               : "memory");
}

// Wait until the phase of parity ``parity`` has completed. A fresh barrier
// is in phase 0: waiting on parity 1 returns at once, on parity 0 it blocks
// until the first phase completes.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = sm90_smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// -- TMA ----------------------------------------------------------------------

// Copy the box at (c0 along K in bytes, c1 along rows) of ``map`` into
// shared memory at ``dst``; its bytes complete a transaction on ``bar``.
// Elements outside the matrix arrive as zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(sm90_smem_addr(dst)),
      "l"((uint64_t)map), "r"(sm90_smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// -- wgmma ----------------------------------------------------------------------

// The same for the 64-byte swizzle (rows of 64 bytes, 16-byte chunk c of row r
// at c ^ ((r >> 1) & 3); the tile 512-aligned).
__device__ __forceinline__ uint64_t wgmma_desc_sw64(uint32_t addr) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;
  d |= (uint64_t)(512 >> 4) << 32;  // SBO: 8 rows of 64 bytes
  d |= (uint64_t)2 << 62;           // layout: 64-byte swizzle
  return d;
}

// Descriptor of a K-major operand tile with the 128-byte swizzle at shared
// address ``addr`` (the tile 1024-aligned; addr may sit 32 k bytes into it).
__device__ __forceinline__ uint64_t wgmma_desc_sw128(uint32_t addr) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);  // start address, 16-byte units
  d |= (uint64_t)1 << 16;                          // LBO: unused for swizzled K-major
  d |= (uint64_t)(1024 >> 4) << 32;                // SBO: 8 rows of 128 bytes
  d |= (uint64_t)1 << 62;                          // layout: 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of the accumulators across
// the asynchronous products.
template <int R>
__device__ __forceinline__ void wgmma_fence_regs(int (&d)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) asm volatile("" : "+r"(d[r])::"memory");
}

// d[64 x 128] += A[64 x 32] . B[128 x 32]^T, s8 x s8 -> s32, both operands
// K-major in shared memory. Thread (warp w of the group, lane l) holds
// d[4 j + 2 h + e] at row 16 w + l / 4 + 8 h, column 8 j + 2 (l % 4) + e.
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// -- warp specialisation ------------------------------------------------------

template <int R>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Barrier ``id`` (1-15; 0 is __syncthreads) over ``threads`` threads.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Every thread of every block of the cluster; the writes before it are
// visible to the reads after it, shared memory of the other blocks included.
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// -- host: tensor maps ----------------------------------------------------------

typedef CUresult (*Sm90EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                    const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                    const cuuint32_t*, CUtensorMapInterleave,
                                    CUtensorMapSwizzle, CUtensorMapL2promotion,
                                    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda.so.1, which the process has already
// loaded (the runtime does not export it, and linking libcuda's stub would
// tie the library to one installation); null if libcuda lacks it.
static Sm90EncodeTiled sm90_encode_tiled() {
  static Sm90EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    if (h != nullptr) fn = (Sm90EncodeTiled)dlsym(h, "cuTensorMapEncodeTiled");
  }
  return fn;
}

// The map of a row-major [rows, cols] matrix of ``type`` (elements of
// ``elem`` bytes) at ``ptr`` (16-byte aligned, cols * elem a multiple of 16),
// read in boxes of ``box_rows`` rows x ``box_cols`` elements with
// ``swizzle`` (box_cols * elem at most the swizzle's span); out-of-bounds
// elements read as zeros.
static cudaError_t sm90_map_2d(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
                               int elem, int rows, int cols, int box_cols, int box_rows,
                               CUtensorMapSwizzle swizzle) {
  Sm90EncodeTiled encode = sm90_encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elems[2] = {1, 1};
  CUresult r = encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elems,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The map of a row-major int8 [rows, k] matrix at ``ptr`` (16-byte aligned,
// k a multiple of 16), read in boxes of ``box_rows`` rows x 128 bytes with
// the 128-byte swizzle; out-of-bounds elements read as zeros.
static cudaError_t sm90_int8_map(CUtensorMap* map, const void* ptr, int rows, int k,
                                 int box_rows) {
  return sm90_map_2d(map, ptr, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, rows, k, 128, box_rows,
                     CU_TENSOR_MAP_SWIZZLE_128B);
}
