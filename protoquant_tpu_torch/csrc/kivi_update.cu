// The decode update of the KIVI caches, in place, one launch per step:
// tail insert, then the chunk flush when this step completes a chunk.
//
// Replaces protoquant_tpu/ops/kv_scatter.py:kivi4_decode_update (the XLA
// insert and flush math around the Pallas _kivi4_flush_kernel) and
// k4v8_decode_update (around _k4v8_write_kernel). On the TPU the Pallas
// calls were only the aliased writes; here one kernel computes the whole
// function of ops/kv_scatter.py:*_decode_update_ref.
//   kq [B, KV, S/2, Dh] int8 packed K, kchs [B, KV, S/G, Dh] f32,
//   ktail/vtail [B, KV, 2G, Dh] int8, kts/vts [B, KV, 2G] f32,
//   Int4 (V4): vq [B, KV, S/2, Dh] packed V, vs [B, KV, 2, S/2] f32;
//   K4V8:      vq [B, KV, S, Dh] int8,       vs [B, KV, S] f32;
//   lengths/adv [B] int32, k8/v8 [B, KV, Dh] int8, ks_new/vs_new [B, KV] f32.
// With ln = max(lengths[b], 0): when ln < S the new rows go to tail row
// ln mod 2G (K4V8: V also to vq/vs at ln). Chunk c = ln / G flushes when
// (c + 1) G <= min(lengths + adv, S) and (c + 1) G > ln: its G tail rows
// (c G mod 2G + j, the row just inserted among them) are requantized, K
// per channel, V per token (kivi.cuh), and packed into rows c G / 2 ...
// of kq (and vq), kchs[c] (and the parity-split vs). An inactive slot
// (adv = 0) inserts and never flushes.
// Bound on the H100: launch overhead. A step reads and writes a few tens
// of KB (a flush adds 3G / 2 Dh bytes per (b, kv head)).
// Design: one block per (b, kv head), one thread per channel. Thread d
// writes byte d of the new rows, thread 0 the scales; a barrier, then
// thread d requantizes channel d of K over the G rows (the amax and the
// codes read the int8 tail again, no staging), and for Int4 a warp per
// token pair requantizes V (warp max over Dh) and packs the pair.

#include "kivi.cuh"

template <bool V4>
__global__ void kivi_update_kernel(int8_t* __restrict__ kq, float* __restrict__ kchs,
                                   int8_t* __restrict__ vq, float* __restrict__ vs,
                                   int8_t* __restrict__ ktail, float* __restrict__ kts,
                                   int8_t* __restrict__ vtail, float* __restrict__ vts,
                                   const int* __restrict__ lengths, const int* __restrict__ adv,
                                   const int8_t* __restrict__ k8, const float* __restrict__ ks_new,
                                   const int8_t* __restrict__ v8, const float* __restrict__ vs_new,
                                   int KV, int S, int Dh, int G) {
  const int bh = blockIdx.x;  // b * KV + h
  const int b = bh / KV, d = threadIdx.x;
  const int TC = 2 * G, S2 = S / 2, NC = S / G;
  const int len = lengths[b];
  const int ln = max(len, 0);
  const size_t tb = (size_t)bh * TC;  // first tail row of (b, h)

  if (ln < S) {
    const size_t row = tb + ln % TC;
    ktail[row * Dh + d] = k8[(size_t)bh * Dh + d];
    vtail[row * Dh + d] = v8[(size_t)bh * Dh + d];
    if (!V4) vq[((size_t)bh * S + ln) * Dh + d] = v8[(size_t)bh * Dh + d];
    if (d == 0) {
      kts[row] = ks_new[bh];
      vts[row] = vs_new[bh];
      if (!V4) vs[(size_t)bh * S + ln] = vs_new[bh];
    }
  }
  const int c = ln / G;
  const long long new_len = min(max((long long)len + adv[b], 0LL), (long long)S);
  const bool flush = (long long)(c + 1) * G <= new_len && (c + 1) * G > ln;
  if (!flush) return;  // the same for every thread of the block
  __syncthreads();  // the inserted row and scales are visible to the block

  const int r0 = (c * G) % TC;
  float amax = 0.0f;
  for (int j = 0; j < G; ++j) {
    const size_t r = tb + r0 + j;
    amax = fmaxf(amax, fabsf(__fmul_rn((float)ktail[r * Dh + d], kts[r])));
  }
  const float s = pq_kivi_scale(amax);
  int8_t* kout = kq + ((size_t)bh * S2 + (size_t)c * (G / 2)) * Dh;
  for (int p = 0; p < G / 2; ++p) {
    const size_t ra = tb + r0 + 2 * p, rb = ra + 1;
    const int lo = pq_kivi_code(__fmul_rn((float)ktail[ra * Dh + d], kts[ra]), s);
    const int hi = pq_kivi_code(__fmul_rn((float)ktail[rb * Dh + d], kts[rb]), s);
    kout[(size_t)p * Dh + d] = pq_pack_nibs(lo, hi);
  }
  kchs[((size_t)bh * NC + c) * Dh + d] = s;

  if (V4) {
    const int warp = d >> 5, lane = d & 31, warps = blockDim.x >> 5;
    for (int p = warp; p < G / 2; p += warps) {
      const size_t ra = tb + r0 + 2 * p, rb = ra + 1;
      const float sa_in = vts[ra], sb_in = vts[rb];
      float ma = 0.0f, mb = 0.0f;
      for (int e = lane; e < Dh; e += 32) {
        ma = fmaxf(ma, fabsf(__fmul_rn((float)vtail[ra * Dh + e], sa_in)));
        mb = fmaxf(mb, fabsf(__fmul_rn((float)vtail[rb * Dh + e], sb_in)));
      }
      const float sa = pq_kivi_scale(pq_warp_max(ma));
      const float sb = pq_kivi_scale(pq_warp_max(mb));
      const size_t prow = (size_t)c * (G / 2) + p;
      int8_t* vout = vq + ((size_t)bh * S2 + prow) * Dh;
      for (int e = lane; e < Dh; e += 32) {
        const int lo = pq_kivi_code(__fmul_rn((float)vtail[ra * Dh + e], sa_in), sa);
        const int hi = pq_kivi_code(__fmul_rn((float)vtail[rb * Dh + e], sb_in), sb);
        vout[e] = pq_pack_nibs(lo, hi);
      }
      if (lane == 0) {
        vs[(size_t)bh * 2 * S2 + prow] = sa;       // plane 0: even tokens
        vs[(size_t)bh * 2 * S2 + S2 + prow] = sb;  // plane 1: odd tokens
      }
    }
  }
}

template <bool V4>
static int launch(void* kq, void* kchs, void* vq, void* vs, void* ktail, void* kts,
                  void* vtail, void* vts, const void* lengths, const void* adv,
                  const void* k8, const void* ks_new, const void* v8, const void* vs_new,
                  int B, int KV, int S, int Dh, int G, void* stream) {
  if (B == 0 || KV == 0) return cudaSuccess;
  if (G < 2 || G % 2 || S % G || Dh % 32 || Dh > 1024) return cudaErrorInvalidValue;
  kivi_update_kernel<V4><<<B * KV, Dh, 0, (cudaStream_t)stream>>>(
      (int8_t*)kq, (float*)kchs, (int8_t*)vq, (float*)vs, (int8_t*)ktail, (float*)kts,
      (int8_t*)vtail, (float*)vts, (const int*)lengths, (const int*)adv, (const int8_t*)k8,
      (const float*)ks_new, (const int8_t*)v8, (const float*)vs_new, KV, S, Dh, G);
  return cudaGetLastError();
}

PQ_EXPORT int pq_k4v8_decode_update(void* kq, void* kchs, void* vq, void* vs, void* ktail,
                                    void* kts, void* vtail, void* vts, const void* lengths,
                                    const void* adv, const void* k8, const void* ks_new,
                                    const void* v8, const void* vs_new, int B, int KV, int S,
                                    int Dh, int G, void* stream) {
  return launch<false>(kq, kchs, vq, vs, ktail, kts, vtail, vts, lengths, adv, k8, ks_new,
                       v8, vs_new, B, KV, S, Dh, G, stream);
}

PQ_EXPORT int pq_kivi4_decode_update(void* kq, void* kchs, void* vq, void* vs, void* ktail,
                                     void* kts, void* vtail, void* vts, const void* lengths,
                                     const void* adv, const void* k8, const void* ks_new,
                                     const void* v8, const void* vs_new, int B, int KV, int S,
                                     int Dh, int G, void* stream) {
  return launch<true>(kq, kchs, vq, vs, ktail, kts, vtail, vts, lengths, adv, k8, ks_new,
                      v8, vs_new, B, KV, S, Dh, G, stream);
}
