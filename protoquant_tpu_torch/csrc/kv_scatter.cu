// In-place decode write of one token's int8 K/V row and scales into the
// int8 cache: the dense layout and the paged pool.
//
// Dense: replaces protoquant_tpu/ops/kv_scatter.py:_scatter_kernel (Pallas).
//   kq/vq [B, KV, S, Dh] int8, ks/vs [B, KV, S] f32 (updated in place)
//   k8/v8 [B, KV, Dh] int8, ks_new/vs_new [B, KV] f32, lengths [B] int32
// Row (b, h) is written at position max(lengths[b], 0) when that is below
// S; a slot at capacity drops the write, as the XLA scatter drops an
// out-of-bounds index.
// Paged: replaces protoquant_tpu/ops/kv_scatter.py:_paged_scatter_kernel.
//   kq/vq [P, KV, ps, Dh] int8 pools, ks/vs [P, KV, 1, ps] f32 (in place),
//   page_table [B, maxP] int32 (-1 unmapped). With len = max(lengths[b], 0)
//   row (b, h) goes to page page_table[b, len / ps] at offset len % ps; an
//   unmapped entry, or len / ps >= maxP, sends it to the trash page P - 1,
//   which no live slot reads. Each block reads its own table entry (the
//   TPU kernel had it prefetched as a scalar).
// Mixed K8V4: replaces protoquant_tpu/ops/kv_scatter.py:_scatter_mixed_kernel.
//   kq [B, KV, S, Dh] int8, ks [B, KV, S] f32 (K as the dense layout);
//   vq [B, KV, S/2, Dh] int8 packed token pairs (row r: token 2r in the low
//   nibble, 2r + 1 in the high one), vs [B, KV, 2, S/2] f32 (plane 0 even
//   tokens, plane 1 odd); v4 [B, KV, Dh] int8 nibble values in [-7, 7].
// With ln = max(lengths[b], 0) < S: K row ln and its scale as the dense
// write; the byte vq[.., ln / 2, d] keeps its other nibble and takes v4's
// in the nibble of parity ln % 2 (a read-modify-write); vs[.., ln % 2,
// ln / 2] takes the V scale. A launch holds one token per row, so the two
// tokens of a byte never meet in one launch, and each byte has one writer.
// Bound on the H100, all three: launch overhead. A step moves 2*(Dh + 4) bytes
// per (b, kv head), a few tens of KB in all. Design: one block per
// (b, kv head), one thread per byte of the head row, scales written by
// thread 0; nothing else of the cache is touched, so there is no copy of it
// and no host sync (the launch can be captured in a CUDA graph).

#include "common.cuh"

__global__ void kv_scatter_kernel(int8_t* __restrict__ kq, float* __restrict__ ks,
                                  int8_t* __restrict__ vq, float* __restrict__ vs,
                                  const int* __restrict__ lengths,
                                  const int8_t* __restrict__ k8, const float* __restrict__ ks_new,
                                  const int8_t* __restrict__ v8, const float* __restrict__ vs_new,
                                  int KV, int S, int Dh) {
  const int bh = blockIdx.x;  // b * KV + h
  const int b = bh / KV;
  const int pos = max(lengths[b], 0);
  if (pos >= S) return;
  const size_t row = (size_t)bh * S + pos;
  for (int d = threadIdx.x; d < Dh; d += blockDim.x) {
    kq[row * Dh + d] = k8[(size_t)bh * Dh + d];
    vq[row * Dh + d] = v8[(size_t)bh * Dh + d];
  }
  if (threadIdx.x == 0) {
    ks[row] = ks_new[bh];
    vs[row] = vs_new[bh];
  }
}

PQ_EXPORT int pq_kv_scatter_decode(void* kq, void* ks, void* vq, void* vs, const void* lengths,
                                   const void* k8, const void* ks_new, const void* v8,
                                   const void* vs_new, int B, int KV, int S, int Dh,
                                   void* stream) {
  if (B == 0 || KV == 0) return cudaSuccess;
  const int threads = Dh < 1024 ? Dh : 1024;
  kv_scatter_kernel<<<B * KV, threads, 0, (cudaStream_t)stream>>>(
      (int8_t*)kq, (float*)ks, (int8_t*)vq, (float*)vs, (const int*)lengths,
      (const int8_t*)k8, (const float*)ks_new, (const int8_t*)v8, (const float*)vs_new,
      KV, S, Dh);
  return cudaGetLastError();
}

__global__ void kv_mixed_scatter_kernel(int8_t* __restrict__ kq, float* __restrict__ ks,
                                        int8_t* __restrict__ vq, float* __restrict__ vs,
                                        const int* __restrict__ lengths,
                                        const int8_t* __restrict__ k8,
                                        const float* __restrict__ ks_new,
                                        const int8_t* __restrict__ v4,
                                        const float* __restrict__ vs_new, int KV, int S,
                                        int Dh) {
  const int bh = blockIdx.x;  // b * KV + h
  const int b = bh / KV;
  const int pos = max(lengths[b], 0);
  if (pos >= S) return;
  const int S2 = S / 2, parity = pos & 1, vrow = pos >> 1;
  const size_t row = (size_t)bh * S + pos;
  const size_t vrow_at = ((size_t)bh * S2 + vrow) * Dh;
  for (int d = threadIdx.x; d < Dh; d += blockDim.x) {
    kq[row * Dh + d] = k8[(size_t)bh * Dh + d];
    const int cur = vq[vrow_at + d];
    const int nib = v4[(size_t)bh * Dh + d] & 0x0F;
    vq[vrow_at + d] = (int8_t)(parity ? (cur & 0x0F) | (nib << 4) : (cur & ~0x0F) | nib);
  }
  if (threadIdx.x == 0) {
    ks[row] = ks_new[bh];
    vs[(size_t)bh * S + parity * S2 + vrow] = vs_new[bh];
  }
}

PQ_EXPORT int pq_kv_mixed_scatter_decode(void* kq, void* ks, void* vq, void* vs,
                                         const void* lengths, const void* k8,
                                         const void* ks_new, const void* v4,
                                         const void* vs_new, int B, int KV, int S, int Dh,
                                         void* stream) {
  if (B == 0 || KV == 0) return cudaSuccess;
  if (S % 2) return cudaErrorInvalidValue;
  const int threads = Dh < 1024 ? Dh : 1024;
  kv_mixed_scatter_kernel<<<B * KV, threads, 0, (cudaStream_t)stream>>>(
      (int8_t*)kq, (float*)ks, (int8_t*)vq, (float*)vs, (const int*)lengths,
      (const int8_t*)k8, (const float*)ks_new, (const int8_t*)v4, (const float*)vs_new,
      KV, S, Dh);
  return cudaGetLastError();
}

__global__ void paged_kv_scatter_kernel(int8_t* __restrict__ kq, float* __restrict__ ks,
                                        int8_t* __restrict__ vq, float* __restrict__ vs,
                                        const int* __restrict__ page_table,
                                        const int* __restrict__ lengths,
                                        const int8_t* __restrict__ k8,
                                        const float* __restrict__ ks_new,
                                        const int8_t* __restrict__ v8,
                                        const float* __restrict__ vs_new,
                                        int maxP, int P, int KV, int ps, int Dh) {
  const int bh = blockIdx.x;  // b * KV + h
  const int b = bh / KV, h = bh % KV;
  const int len = max(lengths[b], 0);
  const int idx = len / ps;
  int page = idx < maxP ? page_table[(size_t)b * maxP + idx] : -1;
  if (page < 0) page = P - 1;
  const size_t row = ((size_t)page * KV + h) * ps + len % ps;
  for (int d = threadIdx.x; d < Dh; d += blockDim.x) {
    kq[row * Dh + d] = k8[(size_t)bh * Dh + d];
    vq[row * Dh + d] = v8[(size_t)bh * Dh + d];
  }
  if (threadIdx.x == 0) {
    ks[row] = ks_new[bh];
    vs[row] = vs_new[bh];
  }
}

PQ_EXPORT int pq_paged_kv_scatter_decode(void* kq, void* ks, void* vq, void* vs,
                                         const void* page_table, const void* lengths,
                                         const void* k8, const void* ks_new, const void* v8,
                                         const void* vs_new, int B, int maxP, int P, int KV,
                                         int ps, int Dh, void* stream) {
  if (B == 0 || KV == 0) return cudaSuccess;
  if (P < 1 || ps < 1 || maxP < 1) return cudaErrorInvalidValue;
  const int threads = Dh < 1024 ? Dh : 1024;
  paged_kv_scatter_kernel<<<B * KV, threads, 0, (cudaStream_t)stream>>>(
      (int8_t*)kq, (float*)ks, (int8_t*)vq, (float*)vs, (const int*)page_table,
      (const int*)lengths, (const int8_t*)k8, (const float*)ks_new, (const int8_t*)v8,
      (const float*)vs_new, maxP, P, KV, ps, Dh);
  return cudaGetLastError();
}
