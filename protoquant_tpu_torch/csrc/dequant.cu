// int8 codes times their scale, per column or per row, to float.
//
// Replaces protoquant_tpu/ops/dequant.py:_dequant_cols_kernel and
// _dequant_rows_kernel (Pallas): out[m, n] = q[m, n] * s[n] (scale on the
// last axis) or q[m, n] * s[m] (scale on the leading axis), in f32, rounded
// once to the output type.
// Bound on the H100: bytes. One byte in and 2 or 4 bytes out per element,
// one multiply.
// Design: an elementwise grid-stride loop over the flattened [M, N] array
// in tiles of 512 codes, one tile per warp. Each thread loads 16 codes with
// one 16-byte load (the warp reads 512 contiguous bytes) into the warp's
// shared-memory stage; then each thread takes 4 codes at a time, lane after
// lane, so each store instruction of the warp writes one contiguous run
// (512 bytes of f32, 256 of bf16) and, when N is a multiple of 4, the 4
// codes share a row and the scales of a column tile come as one 16-byte
// load. A first version stored each thread's own 16 results (64-byte
// strides across the warp) and read 16 scales one by one: 2 to 4.5 times
// slower. The product is __fmul_rn, rounded once to the output type, as
// the plain version. Codes past the last whole tile take a scalar loop.

#include "common.cuh"

constexpr int DQ_THREADS = 256;
constexpr int DQ_WARPS = DQ_THREADS / 32;
constexpr int DQ_TILE = 32 * 16;         // codes per warp and step
constexpr int DQ_MAX_BLOCKS = 132 * 16;  // a few waves on the H100's 132 SMs

template <typename O>
__device__ __forceinline__ void dq_store4(O* dst, const float (&f)[4]) {
  __align__(8) O h[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = pq_from_float<O>(f[j]);
  *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(h);
}

template <>
__device__ __forceinline__ void dq_store4<float>(float* dst, const float (&f)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2], f[3]);
}

// The scales of codes i .. i + 3.
__device__ __forceinline__ void dq_scales(const float* __restrict__ s, long long i, int N,
                                          int scale_on_last, float (&sc)[4]) {
  if (N % 4 == 0) {  // one row; the column is a multiple of 4
    const long long r = i / N;
    if (scale_on_last) {
      const float4 v = *reinterpret_cast<const float4*>(s + (i - r * N));
      sc[0] = v.x; sc[1] = v.y; sc[2] = v.z; sc[3] = v.w;
    } else {
      sc[0] = sc[1] = sc[2] = sc[3] = s[r];
    }
    return;
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) sc[u] = scale_on_last ? s[(i + u) % N] : s[(i + u) / N];
}

template <typename O>
__global__ void __launch_bounds__(DQ_THREADS)
dequant_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
               O* __restrict__ out, long long total, int N, int scale_on_last) {
  __shared__ __align__(16) int8_t stage[DQ_WARPS][DQ_TILE];
  const int lane = threadIdx.x & 31;
  int8_t* st = stage[threadIdx.x >> 5];
  const long long tiles = total / DQ_TILE;
  const long long warps = (long long)gridDim.x * DQ_WARPS;
  for (long long t = (long long)blockIdx.x * DQ_WARPS + (threadIdx.x >> 5); t < tiles;
       t += warps) {
    const long long base = t * DQ_TILE;
    reinterpret_cast<int4*>(st)[lane] = reinterpret_cast<const int4*>(q + base)[lane];
    __syncwarp();
#pragma unroll
    for (int j = 0; j < DQ_TILE / 128; ++j) {
      const int off = 128 * j + 4 * lane;
      const char4 c = *reinterpret_cast<const char4*>(st + off);
      float sc[4];
      dq_scales(s, base + off, N, scale_on_last, sc);
      const float f[4] = {__fmul_rn((float)c.x, sc[0]), __fmul_rn((float)c.y, sc[1]),
                          __fmul_rn((float)c.z, sc[2]), __fmul_rn((float)c.w, sc[3])};
      dq_store4<O>(out + base + off, f);
    }
    __syncwarp();
  }
  const long long stride = (long long)gridDim.x * DQ_THREADS;
  for (long long i = tiles * DQ_TILE + (long long)blockIdx.x * DQ_THREADS + threadIdx.x;
       i < total; i += stride) {
    const float sc = scale_on_last ? s[i % N] : s[i / N];
    out[i] = pq_from_float<O>(__fmul_rn((float)q[i], sc));
  }
}

template <typename O>
static cudaError_t launch(const void* q, const void* s, void* out, int M, int N,
                          int scale_on_last, cudaStream_t stream) {
  const long long total = (long long)M * N;
  const long long want = total / DQ_TILE / DQ_WARPS + 1;
  const int blocks = (int)(want < DQ_MAX_BLOCKS ? want : DQ_MAX_BLOCKS);
  dequant_kernel<O><<<blocks, DQ_THREADS, 0, stream>>>(
      (const int8_t*)q, (const float*)s, (O*)out, total, N, scale_on_last);
  return cudaGetLastError();
}

PQ_EXPORT int pq_dequant(const void* q, const void* s, void* out, int out_dtype, int M,
                         int N, int scale_on_last, void* stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  switch (out_dtype) {
    case PQ_F32: return launch<float>(q, s, out, M, N, scale_on_last, st);
    case PQ_BF16: return launch<__nv_bfloat16>(q, s, out, M, N, scale_on_last, st);
    case PQ_F16: return launch<__half>(q, s, out, M, N, scale_on_last, st);
    default: return cudaErrorInvalidValue;
  }
}
