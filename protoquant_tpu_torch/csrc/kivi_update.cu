// The update of the KIVI caches, in place, one launch a call: the tail
// writes and every chunk flush the call completes, for a decode step (T =
// 1, route "decode") or a prefill chunk (T > 1, route "prefill").
//
// Replaces protoquant_tpu/ops/kv_scatter.py:kivi4_decode_update (the XLA
// insert and flush math around the Pallas _kivi4_flush_kernel) and
// k4v8_decode_update (around _k4v8_write_kernel), and the JAX caches' XLA
// update for T > 1 (protoquant_tpu/models/kv_cache.py, _xla_update of
// Int4KVCache and K4V8KVCache), which computes the same function. On the
// TPU the Pallas calls were only the aliased writes; here one kernel
// computes the whole function of ops/kv_scatter.py:*_decode_update_ref.
//   kq [B, KV, S/2, Dh] int8 packed K, kchs [B, KV, S/G, Dh] f32,
//   ktail/vtail [B, KV, 2G, Dh] int8, kts/vts [B, KV, 2G] f32,
//   Int4 (V4): vq [B, KV, S/2, Dh] packed V, vs [B, KV, 2, S/2] f32;
//   K4V8:      vq [B, KV, S, Dh] int8,       vs [B, KV, S] f32;
//   lengths/adv [B] int32; the new rows k8/v8 [B, KV, T, Dh] int8 and
//   their scales ks_new/vs_new [B, KV, T] f32 at the element strides given
//   (the Dh bytes of a row contiguous and 16-byte aligned).
// With L = max(lengths[b], 0):
//   decode: when L < S the new row goes to tail row L mod 2G (K4V8: V
//     also to vq/vs at L). Chunk c = L / G flushes when (c + 1) G <=
//     min(max(lengths + adv, 0), S); its rows are the tail rows of
//     positions c G + j, but the new row at position L.
//   prefill: chunk c = L / G + f, f < (G - 1 + T) / G, flushes when
//     (c + 1) G <= min(L + adv, S); a position below L reads its tail row,
//     one at or past L the new row min(pos - L, T - 1). Then the latest
//     min(T, 2G) new rows go to the tails (positions past S too), and
//     K4V8's V rows to vq/vs at the positions below S.
// A flushed chunk is requantized, K per channel, V per token (kivi.cuh:
// core/numerics.py:kivi_chunk_quantize, bit for bit), and packed into rows
// c G / 2 ... of kq (and vq), kchs[c] (and the parity-split vs).
// Bound on the H100: launch overhead. A decode step moves a few tens of
// KB; a prefill chunk's new rows are T (Dh + 4) bytes a side per (b, kv
// head), 128 KB a layer at Llama-2-7B's T 256 and B 1.
// Design: grid (B KV, sides, z), 256 threads. Side 0 is K, side 1 V: Int4
// takes both sides on both routes, so its V flush runs beside K's on
// another SM; K4V8's decode takes the K side alone, whose block also
// inserts the V row, and its prefill both (the V side writes the rows of
// its slot's tokens). A decode's z is 1, a prefill's its slot: slot z
// takes the call's z-th chunk. A block with nothing to flush writes its
// rows (decode: the insert) and returns. A flushing block stages the
// chunk's rows and their scales in shared memory by 16-byte cp.async in
// one pass (the new rows from the input, not back through the tail). K: a
// thread takes a word (4 channels) of a share of the rows, its channel
// maxima reduced by shuffles within a warp and through shared memory
// across warps, then that word of a share of the token pairs. V: 8 lanes
// take a token pair, 16 channels of both rows a lane, each row's amax
// reduced by shuffles, every pair of a 7B chunk at once. Each division is
// ku_div's, branch-free: __fdiv_rn's branch kept a thread's divisions in
// series (1.3-2.2 us of a 7B decode flush, 4-5 of a prefill chunk, by
// tools/kivi_timing.py --ablate). Slot 0 of a prefill alone reads old tail
// rows (positions below L), and new rows can land on them once T > G; so
// slot 0 alone writes the tails, after its stage.

#include "kivi.cuh"

#define KU_THREADS 256
#define KU_WARPS (KU_THREADS / 32)
// Build variants that tools/kivi_timing.py --ablate times (0: the kernel):
// 1 staging and tails alone, no requantization; 2 codes by IEEE division
// (__fdiv_rn, as kivi.cuh's pq_kivi_code) instead of ku_div
#ifndef PQ_KU_ABLATE
#define PQ_KU_ABLATE 0
#endif
#define KU_MAX_SMEM (227 * 1024)

__host__ __device__ __forceinline__ int ku_align16(int n) { return (n + 15) / 16 * 16; }
// Dynamic shared memory of a block: the staged rows (G of Dh codes) and
// their G scales, the K maxima of each warp [KU_WARPS][Dh], the
// K channel scales [Dh] and their reciprocals' room [Dh].
static inline int ku_smem(int G, int Dh) {
  return G * Dh + ku_align16(4 * G) + 4 * (KU_WARPS + 2) * Dh;
}

__device__ __forceinline__ int ku_word(const int8_t* p) { return *reinterpret_cast<const int*>(p); }

// N consecutive words at p (16-byte aligned when N is a multiple of 4, 8
// when of 2) in as few loads
template <int N>
__device__ __forceinline__ void ku_words(const int8_t* p, int* w) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const int4 v = reinterpret_cast<const int4*>(p)[i];
      w[4 * i] = v.x;
      w[4 * i + 1] = v.y;
      w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
  } else if constexpr (N == 2) {
    const int2 v = *reinterpret_cast<const int2*>(p);
    w[0] = v.x;
    w[1] = v.y;
  } else {
    w[0] = ku_word(p);
  }
}

template <int N>
__device__ __forceinline__ void ku_store_words(int8_t* p, const uint32_t* w) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      reinterpret_cast<int4*>(p)[i] =
          make_int4((int)w[4 * i], (int)w[4 * i + 1], (int)w[4 * i + 2], (int)w[4 * i + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<int2*>(p) = make_int2((int)w[0], (int)w[1]);
  } else {
    *reinterpret_cast<uint32_t*>(p) = w[0];
  }
}

__device__ __forceinline__ int4 ku_ld16(const int8_t* p) { return *reinterpret_cast<const int4*>(p); }
__device__ __forceinline__ void ku_st16(int8_t* p, int4 w) { *reinterpret_cast<int4*>(p) = w; }

// Code e (0..3) of a word times its token's scale: one f32 product, as the
// plain version's k8.float() * scale.
__device__ __forceinline__ float ku_val(int word, int e, float s) {
  return __fmul_rn((float)pq_byte(word, e), s);
}

// x / s rounded to nearest even, the quotient IEEE division gives, from y =
// RN(1 / s) (__frcp_rn): q0 = RN(x y) lies within 2 ulps of x / s, one
// correction q1 = RN(q0 + RN(x - q0 s) y) within one, and then, by
// Markstein's theorem (y the correctly rounded reciprocal, q1 within an
// ulp, so x - q1 s is exact in an FMA), RN(q1 + (x - q1 s) y) is the
// correctly rounded quotient. No branch, unlike __fdiv_rn, so a thread's
// divisions overlap. Here |x / s| <= 7 and x is 0 or at least 1e-12 (a
// code times a scale), so nothing overflows or underflows.
__device__ __forceinline__ float ku_div(float x, float s, float y) {
  const float q0 = __fmul_rn(x, y);
  const float q1 = __fmaf_rn(__fmaf_rn(-q0, s, x), y, q0);
  return __fmaf_rn(__fmaf_rn(-q1, s, x), y, q1);
}

// pq_kivi_code(x, s) of kivi.cuh, y = RN(1 / s)
__device__ __forceinline__ int ku_code(float x, float s, float y) {
#if PQ_KU_ABLATE == 2
  return pq_kivi_code(x, s);
#else
  return (int)fminf(fmaxf(rintf(ku_div(x, s, y)), -7.0f), 7.0f);
#endif
}

// K over the chunk's G staged rows (buf [G][DH]): the channel scales into
// kch[0, DH) and the packed pairs (token 2p in the low nibble, 2p + 1 in
// the high one) into row p of kout. Thread (g, w) takes word w of rows g,
// g + GW, ...; every thread of the block calls it.
template <int DH>
__device__ __forceinline__ void ku_flush_k(const int8_t* buf, const float* bsc, float* red,
                                           float* chs, int G, int8_t* __restrict__ kout,
                                           float* __restrict__ kch) {
  constexpr int WC = DH / 4, GW = KU_THREADS / WC;
  const int tid = threadIdx.x, w = tid % WC, g = tid / WC;
  float m[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int j = g; j < G; j += GW) {
    const int word = ku_word(buf + j * DH + 4 * w);
    const float s = bsc[j];
#pragma unroll
    for (int e = 0; e < 4; ++e) m[e] = fmaxf(m[e], fabsf(ku_val(word, e, s)));
  }
  // lanes WC apart hold the same words; then one partial a warp (WC <= 32)
  // or a row group (WC > 32: a warp holds 32 words of one) to shared memory
#pragma unroll
  for (int o = WC; o < 32; o <<= 1)
#pragma unroll
    for (int e = 0; e < 4; ++e) m[e] = fmaxf(m[e], __shfl_xor_sync(0xffffffffu, m[e], o));
  constexpr int RG = WC <= 32 ? KU_WARPS : GW;
  if (WC > 32 || (tid & 31) < WC) {
    const int r = WC <= 32 ? tid >> 5 : g;
#pragma unroll
    for (int e = 0; e < 4; ++e) red[r * DH + 4 * w + e] = m[e];
  }
  __syncthreads();
  for (int d = tid; d < DH; d += KU_THREADS) {
    float a = 0.0f;
#pragma unroll
    for (int r = 0; r < RG; ++r) a = fmaxf(a, red[r * DH + d]);
    const float s = pq_kivi_scale(a);
    chs[d] = s;
    chs[DH + d] = __frcp_rn(s);
    kch[d] = s;
  }
  __syncthreads();
  for (int i = tid; i < G / 2 * WC; i += KU_THREADS) {
    const int p = i / WC, wi = i % WC;
    const int wa = ku_word(buf + (2 * p) * DH + 4 * wi);
    const int wb = ku_word(buf + (2 * p + 1) * DH + 4 * wi);
    const float sa = bsc[2 * p], sb = bsc[2 * p + 1];
    uint32_t out = 0u;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float cs = chs[4 * wi + e], cy = chs[DH + 4 * wi + e];
      const int lo = ku_code(ku_val(wa, e, sa), cs, cy);
      const int hi = ku_code(ku_val(wb, e, sb), cs, cy);
      out |= (uint32_t)(uint8_t)pq_pack_nibs(lo, hi) << (8 * e);
    }
    *reinterpret_cast<uint32_t*>(kout + (size_t)p * DH + 4 * wi) = out;
  }
}

// Int4's V over np staged token pairs (buf [2 np][DH]): a scale a token
// (pair p's even token into vs0[p], its odd one into vs1[p]) and the
// packed pairs into row p of vout. LPR = 8 lanes take a pair, WPL
// consecutive words of each of its two rows a lane, and reduce each row's
// amax by shuffles; a warp takes PPW = 4 pairs at once (one pass over a 7B
// chunk's 32 pairs, where 32 lanes a pair took four and ~0.8 us more,
// tools/kivi_timing.py --ablate). Every lane runs every pass of its warp.
template <int DH>
__device__ __forceinline__ void ku_flush_v4(const int8_t* buf, const float* bsc, int np,
                                            int8_t* __restrict__ vout, float* __restrict__ vs0,
                                            float* __restrict__ vs1) {
  constexpr int LPR = 8, WPL = DH / 4 / LPR, PPW = 32 / LPR;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, l = lane % LPR;
  for (int p0 = warp * PPW; p0 < np; p0 += KU_WARPS * PPW) {
    const int p = p0 + lane / LPR;
    const bool live = p < np;
    int wa[WPL], wb[WPL];
    float sa = 0.0f, sb = 0.0f, ma = 0.0f, mb = 0.0f;
    if (live) {
      sa = bsc[2 * p];
      sb = bsc[2 * p + 1];
      ku_words<WPL>(buf + (2 * p) * DH + 4 * WPL * l, wa);
      ku_words<WPL>(buf + (2 * p + 1) * DH + 4 * WPL * l, wb);
    } else {
#pragma unroll
      for (int k = 0; k < WPL; ++k) wa[k] = wb[k] = 0;
    }
#pragma unroll
    for (int k = 0; k < WPL; ++k) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ma = fmaxf(ma, fabsf(ku_val(wa[k], e, sa)));
        mb = fmaxf(mb, fabsf(ku_val(wb[k], e, sb)));
      }
    }
#pragma unroll
    for (int o = 1; o < LPR; o <<= 1) {
      ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, o));
      mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, o));
    }
    const float ta = pq_kivi_scale(ma), tb = pq_kivi_scale(mb);
    const float ra = __frcp_rn(ta), rb = __frcp_rn(tb);
    if (!live) continue;
    uint32_t out[WPL];
#pragma unroll
    for (int k = 0; k < WPL; ++k) {
      out[k] = 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lo = ku_code(ku_val(wa[k], e, sa), ta, ra);
        const int hi = ku_code(ku_val(wb[k], e, sb), tb, rb);
        out[k] |= (uint32_t)(uint8_t)pq_pack_nibs(lo, hi) << (8 * e);
      }
    }
    ku_store_words<WPL>(vout + (size_t)p * DH + 4 * WPL * l, out);
    if (l == 0) {
      vs0[p] = ta;
      vs1[p] = tb;
    }
  }
}

template <bool V4, int DH>
__global__ void __launch_bounds__(KU_THREADS)
kivi_update_kernel(int8_t* __restrict__ kq, float* __restrict__ kchs, int8_t* __restrict__ vq,
                   float* __restrict__ vs, int8_t* __restrict__ ktail, float* __restrict__ kts,
                   int8_t* __restrict__ vtail, float* __restrict__ vts,
                   const int* __restrict__ lengths, const int* __restrict__ adv,
                   const int8_t* __restrict__ k8, const float* __restrict__ ks_new,
                   const int8_t* __restrict__ v8, const float* __restrict__ vs_new, int KV,
                   int S, int G, int T, int xsb, int xsh, int xst, int ssb, int ssh, int sst,
                   int prefill) {
  constexpr int VPR = DH / 16;  // 16-byte vectors a row
  extern __shared__ __align__(16) int8_t ku_shared[];
  const int bh = blockIdx.x, b = bh / KV, h = bh - b * KV, slot = blockIdx.z;
  const bool vside = blockIdx.y == 1;
  const bool rows_only = vside && !V4;  // K4V8's V at prefill: rows at their positions
  const int tid = threadIdx.x, TC = 2 * G, S2 = S / 2;
  const int len = lengths[b];
  const long long L = max(len, 0), a = adv[b];
  int8_t* tail = (vside ? vtail : ktail) + (size_t)bh * TC * DH;
  float* ts = (vside ? vts : kts) + (size_t)bh * TC;
  const int8_t* x = (vside ? v8 : k8) + (size_t)b * xsb + (size_t)h * xsh;
  const float* xs = (vside ? vs_new : ks_new) + (size_t)b * ssb + (size_t)h * ssh;

  const long long c = L / G + slot;
  const long long limit = prefill ? min(L + a, (long long)S)
                                  : min(max((long long)len + a, 0LL), (long long)S);
  const bool flush = (c + 1) * G <= limit && !rows_only;  // the same for the whole block

  if (!prefill) {  // the new row into the tail; K4V8's K block also V's, warp 1
    if (L < S) {
      const size_t row = (size_t)(L % TC);
      if (tid < VPR) ku_st16(tail + row * DH + tid * 16, ku_ld16(x + tid * 16));
      if (tid == 0) ts[row] = xs[0];
      if (!V4 && tid >= 32 && tid < 32 + VPR) {
        const int v = tid - 32;
        const int4 w = ku_ld16(v8 + (size_t)b * xsb + (size_t)h * xsh + v * 16);
        ku_st16(vtail + ((size_t)bh * TC + row) * DH + v * 16, w);
        ku_st16(vq + ((size_t)bh * S + L) * DH + v * 16, w);
      }
      if (!V4 && tid == 32) {
        const float s = vs_new[(size_t)b * ssb + (size_t)h * ssh];
        vts[(size_t)bh * TC + row] = s;
        vs[(size_t)bh * S + L] = s;
      }
    }
    if (!flush) return;
  } else if (rows_only) {  // K4V8's V rows of this slot's tokens, below S
    const int t0 = slot * G, t1 = min(t0 + G, T);
    for (int i = tid; i < (t1 - t0) * VPR; i += KU_THREADS) {
      const int t = t0 + i / VPR, v = i % VPR;
      if (L + t < S)
        ku_st16(vq + ((size_t)bh * S + L + t) * DH + v * 16, ku_ld16(x + (size_t)t * xst + v * 16));
    }
    for (int t = t0 + tid; t < t1; t += KU_THREADS)
      if (L + t < S) vs[(size_t)bh * S + L + t] = xs[(size_t)t * sst];
  }

  int8_t* buf = ku_shared;
  float* bsc = reinterpret_cast<float*>(buf + G * DH);
  if (flush) {  // stage the chunk: the tail below L, the new rows from L
    for (int i = tid; i < G * VPR; i += KU_THREADS) {
      const int j = i / VPR, v = i % VPR;
      const long long pos = c * G + j;
      const bool fresh = prefill ? pos >= L : pos == L;
      const int8_t* src = fresh ? x + (size_t)min(pos - L, (long long)T - 1) * xst
                                : tail + (size_t)(pos % TC) * DH;
      pq_cp_async16(buf + j * DH + v * 16, src + v * 16);
    }
    for (int j = tid; j < G; j += KU_THREADS) {
      const long long pos = c * G + j;
      const bool fresh = prefill ? pos >= L : pos == L;
      pq_cp_async4(bsc + j, fresh ? xs + (size_t)min(pos - L, (long long)T - 1) * sst
                                  : ts + pos % TC);
    }
    pq_cp_async_commit();
    pq_cp_async_wait<0>();
    __syncthreads();  // staged, and every old tail row read
  }
  if (prefill && slot == 0) {  // the latest min(T, 2G) new rows into the tails
    const int n = min(T, TC), t0 = T - n;
    for (int i = tid; i < n * VPR; i += KU_THREADS) {
      const int t = t0 + i / VPR, v = i % VPR;
      ku_st16(tail + (size_t)((L + t) % TC) * DH + v * 16, ku_ld16(x + (size_t)t * xst + v * 16));
    }
    for (int t = t0 + tid; t < T; t += KU_THREADS) ts[(L + t) % TC] = xs[(size_t)t * sst];
  }
  if (!flush || PQ_KU_ABLATE == 1) return;

  const size_t prow = (size_t)bh * S2 + (size_t)c * (G / 2);  // the chunk's first packed row
  if (!vside) {
    float* red = reinterpret_cast<float*>(buf + G * DH + ku_align16(4 * G));
    ku_flush_k<DH>(buf, bsc, red, red + KU_WARPS * DH, G, kq + prow * DH,
                   kchs + ((size_t)bh * (S / G) + c) * DH);
  } else {
    float* vs0 = vs + (size_t)bh * 2 * S2 + (size_t)c * (G / 2);
    ku_flush_v4<DH>(buf, bsc, G / 2, vq + prow * DH, vs0, vs0 + S2);
  }
}

template <bool V4, int DH>
static int launch_dh(int B, int KV, int smem, cudaStream_t stream, void* kq, void* kchs,
                     void* vq, void* vs, void* ktail, void* kts, void* vtail, void* vts,
                     const void* lengths, const void* adv, const void* k8, const void* ks_new,
                     const void* v8, const void* vs_new, int S, int G, int T, int xsb, int xsh,
                     int xst, int ssb, int ssh, int sst, int prefill) {
  static bool smem_set = false;
  if (smem > 48 * 1024) {
    const cudaError_t err = pq_allow_smem(kivi_update_kernel<V4, DH>, KU_MAX_SMEM, smem_set);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(B * KV, V4 || prefill ? 2 : 1, prefill ? (G - 1 + T) / G : 1);
  kivi_update_kernel<V4, DH><<<grid, KU_THREADS, smem, stream>>>(
      (int8_t*)kq, (float*)kchs, (int8_t*)vq, (float*)vs, (int8_t*)ktail, (float*)kts,
      (int8_t*)vtail, (float*)vts, (const int*)lengths, (const int*)adv, (const int8_t*)k8,
      (const float*)ks_new, (const int8_t*)v8, (const float*)vs_new, KV, S, G, T, xsb, xsh, xst,
      ssb, ssh, sst, prefill);
  return cudaGetLastError();
}

template <bool V4>
static int launch(void* kq, void* kchs, void* vq, void* vs, void* ktail, void* kts,
                  void* vtail, void* vts, const void* lengths, const void* adv,
                  const void* k8, const void* ks_new, const void* v8, const void* vs_new,
                  int B, int KV, int S, int Dh, int G, int T, int xsb, int xsh, int xst,
                  int ssb, int ssh, int sst, int prefill, void* stream) {
  if (B == 0 || KV == 0) return cudaSuccess;
  const int smem = ku_smem(G, Dh);
  if (G < 2 || G % 2 || S % G || T < 1 || (!prefill && T != 1) || smem > KU_MAX_SMEM)
    return cudaErrorInvalidValue;
#define KU_ARGS B, KV, smem, (cudaStream_t)stream, kq, kchs, vq, vs, ktail, kts, vtail, vts, \
                lengths, adv, k8, ks_new, v8, vs_new, S, G, T, xsb, xsh, xst, ssb, ssh, sst, \
                prefill
  switch (Dh) {
    case 32: return launch_dh<V4, 32>(KU_ARGS);
    case 64: return launch_dh<V4, 64>(KU_ARGS);
    case 128: return launch_dh<V4, 128>(KU_ARGS);
    case 256: return launch_dh<V4, 256>(KU_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef KU_ARGS
}

PQ_EXPORT int pq_k4v8_decode_update(void* kq, void* kchs, void* vq, void* vs, void* ktail,
                                    void* kts, void* vtail, void* vts, const void* lengths,
                                    const void* adv, const void* k8, const void* ks_new,
                                    const void* v8, const void* vs_new, int B, int KV, int S,
                                    int Dh, int G, int T, int xsb, int xsh, int xst, int ssb,
                                    int ssh, int sst, int prefill, void* stream) {
  return launch<false>(kq, kchs, vq, vs, ktail, kts, vtail, vts, lengths, adv, k8, ks_new,
                       v8, vs_new, B, KV, S, Dh, G, T, xsb, xsh, xst, ssb, ssh, sst, prefill,
                       stream);
}

PQ_EXPORT int pq_kivi4_decode_update(void* kq, void* kchs, void* vq, void* vs, void* ktail,
                                     void* kts, void* vtail, void* vts, const void* lengths,
                                     const void* adv, const void* k8, const void* ks_new,
                                     const void* v8, const void* vs_new, int B, int KV, int S,
                                     int Dh, int G, int T, int xsb, int xsh, int xst, int ssb,
                                     int ssh, int sst, int prefill, void* stream) {
  return launch<true>(kq, kchs, vq, vs, ktail, kts, vtail, vts, lengths, adv, k8, ks_new, v8,
                      vs_new, B, KV, S, Dh, G, T, xsb, xsh, xst, ssb, ssh, sst, prefill, stream);
}

// A check of ku_div against IEEE division: over s = every significand in
// [1, 2) and the nx values xs[], the quotients whose bits differ are added
// to *bad. Launches only for the card tests.
__global__ void ku_div_check_kernel(const float* __restrict__ xs, int nx,
                                    unsigned long long* __restrict__ bad) {
  const unsigned m = blockIdx.x * blockDim.x + threadIdx.x;
  const float s = __uint_as_float(0x3f800000u | (m & 0x7fffffu));
  const float y = __frcp_rn(s);
  unsigned n = 0;
  for (int i = 0; i < nx; ++i) {
    const float x = xs[i];
    n += __float_as_uint(ku_div(x, s, y)) != __float_as_uint(__fdiv_rn(x, s));
  }
  if (n) atomicAdd(bad, (unsigned long long)n);
}

PQ_EXPORT int pq_kivi_div_check(const void* xs, int nx, void* bad, void* stream) {
  ku_div_check_kernel<<<(1 << 23) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const float*)xs, nx, (unsigned long long*)bad);
  return cudaGetLastError();
}
