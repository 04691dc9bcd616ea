// Flash attention over the dense int8 KV cache, causal, with GQA, and over
// the mixed K8V4 cache (the same keys, int4 values).
//
// Replaces protoquant_tpu/ops/attention.py:_attn_kernel (Pallas) with all
// its variants (sliding window, score scale, softcap, ring positions,
// StreamingLLM sinks, ALiBi, learned sinks), and _attn_mixed_kernel (V4 =
// true; the wrapper passes its score scale and no other variant, as the TPU
// kernel takes).
//   q [B, T, H, Dh] (f32/bf16/f16), kq/vq [B, KV, S, Dh] int8,
//   ks/vs [B, KV, S] f32, lengths [B] int32 = cache length BEFORE this
//   step's T tokens; kpos [B, S] int32 or null, alibi [H] f32 or null,
//   sink [H] f32 or null (GPT-OSS's learned sinks).
//   Query row r = t * group + g of kv head h is q head h * group + g at
//   absolute position p_t = lengths[b] + t. Column c holds position pos_c =
//   kpos[b, c] (a ring cache; negative = never written) or c. It is visible
//   iff 0 <= pos_c <= p_t and, with window > 0, pos_c > p_t - window or
//   pos_c < sinks (StreamingLLM sinks stay visible).
//   score[r, c] = (q[r] . kq[c]) * ks[c] * sm      (sm = scale or Dh^-0.5)
//   with softcap > 0: score = softcap * tanh(score / softcap), then with
//   ALiBi: score -= alibi[h * group + g] * (p_t - pos_c), before the mask
//   out[r]      = sum_c softmax(score)[r, c] * vs[c] * vq[c]
//   with learned sinks the softmax runs over [score[r, :], sink[h * group +
//   g]] and the sink's share is dropped: row r's online softmax starts from
//   m = sink, l = 1, acc = 0 (the TPU kernel's initial state), read once
//   into registers, so no tile is walked for it and it composes with every
//   other variant.
// The per-token scales factor out of both dots, so no f32 copy of the cache
// is ever made.
// Bound on the H100: bytes, the visible part of the int8 cache
// (2 * L * Dh + 8 * L per (b, kv head), L the keys inside the rows' windows)
// plus q and out (and a ring's positions, 4 * S per b).
// Design: one block of 4 warps per (b, kv head, 16 query rows); each warp
// owns 4 rows. The loop runs over 64-key tiles (32 at Dh = 256) from the
// tile holding the first row's earliest visible key, lengths[b] + t_min -
// window + 1 (0 without a window: the TPU kernel's block skipping, so
// windowed decode reads O(window) bytes), up to lengths[b] + t_max, so dead
// tiles are never read; with sinks the tiles holding columns < sinks are
// walked first, then the skip. A ring cache scatters positions over its
// columns, so every tile of its S = O(window) columns is walked, as on the
// TPU, each tile's [KT] positions staged in shared memory. Rows of one
// block whose windows are disjoint see tiles where every key of theirs is
// masked: p is zeroed by the mask, not by exp, so their running max and sum
// stay untouched. Each tile's int8 K and V rows and their scales are staged
// in shared memory (K rows padded by 4 bytes so a warp's 32 keys fall in 32
// banks). Lane j scores keys j and j + 32 against the warp's rows; the
// online softmax (running max m, denominator l) is in f32; p * vs goes
// through shared memory and each lane accumulates Dh/32 output dims. The
// output is acc / max(l, 1e-30). Every variant is a runtime value read only
// by an instance that takes it: VAR = 1 reads the window, the softcap and
// the learned sinks (Gemma-2, Mistral, GPT-OSS: its global layers too, with
// window 0), VAR = 2 also the ring's positions, the StreamingLLM sinks and
// ALiBi, and a call takes the least instance its variants need; the
// full-causal instance (VAR = 0) compiles them all out (read by every
// instance, the window and softcap alone cost Llama-2-7B's decode 2.5-8 %
// on an H100, and the positions and slopes Gemma-2's sliding decode 4.5 %:
// tools/attention_timing.py). Each row's ALiBi slope sits in a register.
// At decode (one row per block) three warps would only load and one block
// would walk each (b, kv head): a call whose rows fit a split block (every
// decode) takes the split-S design of attn_split.cuh instead (as_plan
// decides; ops/attention.py asks pq_attn_split_plan), and this kernel keeps
// the calls with more rows (prefill chunks).
// V4 (K8V4): vq [B, KV, S/2, Dh] int8 holds token pairs (row r: token 2r in
// the low nibble, 2r + 1 in the high one) and vs [B, KV, 2, S/2] f32 their
// per-token scales (plane 0 even tokens, plane 1 odd). Each tile's 32 byte
// rows are unpacked into the same int8 Vs rows, one token each, and vss
// takes the scale of each token's parity, so the rest of the loop is the
// dense kernel's; V is int4, but the sum stays f32 (the TPU kernel's bf16
// lanes are a choice for its matrix unit). Bound: bytes, Dh + 8 + Dh / 2
// per valid key and kv head.

#include "kivi.cuh"

constexpr int AT_WARPS = 4;
constexpr int AT_RPW = 4;                   // query rows per warp
constexpr int AT_QROWS = AT_WARPS * AT_RPW;  // query rows per block
constexpr int AT_THREADS = AT_WARPS * 32;
constexpr float AT_NEG_INF = -1e30f;

template <int DH, int KT, bool V4, int VAR, typename QT>
__global__ void __launch_bounds__(AT_THREADS)
attn_kernel(const QT* __restrict__ q, const int8_t* __restrict__ kq,
            const float* __restrict__ ks, const int8_t* __restrict__ vq,
            const float* __restrict__ vs, const int* __restrict__ lengths,
            const int* __restrict__ kpos, const float* __restrict__ alibi,
            const float* __restrict__ sink, QT* __restrict__ out, int T, int H, int KV, int S,
            float sm, int window, float softcap, int sinks) {
  constexpr int DPL = DH / 32;  // output dims per lane
  constexpr int KPL = KT / 32;  // keys per lane
  constexpr int KSTR = DH + 4;  // padded K row (bytes)
  __shared__ __align__(16) float Qs[AT_QROWS][DH];
  __shared__ __align__(16) int8_t Ks[KT][KSTR];
  __shared__ __align__(16) int8_t Vs[KT][DH];
  __shared__ float kss[KT], vss[KT];
  __shared__ float Ps[AT_QROWS][KT];
  __shared__ int poss[KT];  // EXT: the tile's positions (-1 past the keys)

  const int b = blockIdx.z, h = blockIdx.y, r0 = blockIdx.x * AT_QROWS;
  const int group = H / KV, R = T * group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int len = lengths[b];
  const int rows_here = min(AT_QROWS, R - r0);
  const int t_max = (r0 + rows_here - 1) / group;
  constexpr bool EXT = VAR == 2;  // ring positions, sinks, ALiBi
  const bool ring = EXT && kpos != nullptr;  // positions scattered: walk every column
  const int n_keys = ring ? S : max(0, min(S, len + t_max + 1));
  // first tile holding a key inside the block's first row's window; with
  // sinks, the tiles holding columns < c_sink come first
  const bool skip = VAR > 0 && window > 0 && !ring;
  const int c_start = skip ? (max(len + r0 / group - window + 1, 0) / KT) * KT : 0;
  const int c_sink = EXT && skip ? min(sinks, n_keys) : 0;
  const float inv_cap = VAR > 0 && softcap > 0.0f ? 1.0f / softcap : 0.0f;

  for (int i = threadIdx.x; i < AT_QROWS * DH; i += AT_THREADS) {
    const int r = i / DH, d = i % DH, gr = r0 + r;
    float v = 0.0f;
    if (gr < R) {
      const int t = gr / group, gi = gr % group;
      v = pq_to_float(q[(((size_t)b * T + t) * H + h * group + gi) * DH + d]);
    }
    Qs[r][d] = v;
  }

  const size_t bh = (size_t)b * KV + h;
  const int8_t* kb = kq + bh * S * DH;
  const int8_t* vb = vq + bh * (V4 ? S / 2 : S) * DH;
  const float* ksb = ks + bh * S;
  const float* vsb = vs + bh * S;  // [2, S/2] or [S]: S floats either way

  const int wr0 = warp * AT_RPW;  // first block row of this warp
  const bool warp_live = r0 + wr0 < R;
  float m[AT_RPW], l[AT_RPW], acc[AT_RPW][DPL], slope[AT_RPW];
#pragma unroll
  for (int i = 0; i < AT_RPW; ++i) {
    const int r = r0 + wr0 + i;
    slope[i] = EXT && alibi != nullptr && r < R ? alibi[h * group + r % group] : 0.0f;
    // a learned sink: denominator mass without a value
    const bool has_sink = VAR > 0 && sink != nullptr && r < R;
    m[i] = has_sink ? sink[h * group + r % group] : AT_NEG_INF;
    l[i] = has_sink ? 1.0f : 0.0f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[i][e] = 0.0f;
  }

  for (int c0 = c_sink > 0 ? 0 : c_start; c0 < n_keys;
       c0 = EXT ? max(c0 + KT, c0 + KT < c_sink ? 0 : c_start) : c0 + KT) {
    __syncthreads();  // Q staged / previous tile consumed
    for (int i = threadIdx.x; i < KT * (DH / 4); i += AT_THREADS) {
      const int j = i / (DH / 4), w = i % (DH / 4), c = c0 + j;
      int kw = 0, vw = 0;
      if (c < n_keys) {
        kw = ((const int*)(kb + (size_t)c * DH))[w];
        if constexpr (!V4) vw = ((const int*)(vb + (size_t)c * DH))[w];
      }
      *(int*)&Ks[j][4 * w] = kw;
      if constexpr (!V4) *(int*)&Vs[j][4 * w] = vw;
    }
    for (int j = threadIdx.x; j < KT; j += AT_THREADS) {
      const int c = c0 + j;
      kss[j] = c < n_keys ? ksb[c] : 0.0f;
      if constexpr (!V4) vss[j] = c < n_keys ? vsb[c] : 0.0f;
      if constexpr (EXT) poss[j] = c >= n_keys ? -1 : ring ? kpos[(size_t)b * S + c] : c;
    }
    if constexpr (V4) {  // KT / 2 packed byte rows, two tokens each
      for (int i = threadIdx.x; i < (KT / 2) * (DH / 4); i += AT_THREADS) {
        const int pr = i / (DH / 4), w = i % (DH / 4), tok = c0 + 2 * pr;
        const int vw = tok < n_keys ? ((const int*)(vb + (size_t)(tok / 2) * DH))[w] : 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int byte = pq_byte(vw, e);
          Vs[2 * pr][4 * w + e] = (int8_t)pq_nib_lo(byte);
          Vs[2 * pr + 1][4 * w + e] = (int8_t)pq_nib_hi(byte);
        }
      }
      for (int j = threadIdx.x; j < KT / 2; j += AT_THREADS) {
        const int tok = c0 + 2 * j;
        vss[2 * j] = tok < n_keys ? vsb[tok / 2] : 0.0f;
        vss[2 * j + 1] = tok + 1 < n_keys ? vsb[S / 2 + tok / 2] : 0.0f;
      }
    }
    __syncthreads();
    if (!warp_live) continue;

    float s[AT_RPW][KPL];
#pragma unroll
    for (int i = 0; i < AT_RPW; ++i)
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk) s[i][kk] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 qv[AT_RPW];
#pragma unroll
      for (int i = 0; i < AT_RPW; ++i) qv[i] = *(const float4*)&Qs[wr0 + i][d];
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk) {
        const char4 k4 = *(const char4*)&Ks[lane + 32 * kk][d];
        const float kx = k4.x, ky = k4.y, kz = k4.z, kw = k4.w;
#pragma unroll
        for (int i = 0; i < AT_RPW; ++i)
          s[i][kk] += qv[i].x * kx + qv[i].y * ky + qv[i].z * kz + qv[i].w * kw;
      }
    }

#pragma unroll
    for (int i = 0; i < AT_RPW; ++i) {
      const int r = r0 + wr0 + i;
      const int limit = r < R ? len + r / group : -1;  // dead rows see no key
      const int lower = VAR > 0 && window > 0 ? limit - window : -1;  // keys <= lower are out
      bool valid[KPL];
      float sc[KPL];
      float tmax = AT_NEG_INF;
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk) {
        const int j = lane + 32 * kk, c = c0 + j;
        float v = (s[i][kk] * kss[j]) * sm;
        if constexpr (EXT) {
          const int pos = poss[j];  // -1 past the keys
          valid[kk] = pos >= 0 && pos <= limit && (window <= 0 || pos > lower || pos < sinks);
        } else {
          valid[kk] = c < n_keys && c <= limit && (VAR == 0 || c > lower);
        }
        if (VAR > 0 && softcap > 0.0f) v = softcap * tanhf(v * inv_cap);
        if constexpr (EXT) v -= slope[i] * (float)(limit - poss[j]);  // slope 0 without ALiBi
        sc[kk] = valid[kk] ? v : AT_NEG_INF;
        tmax = fmaxf(tmax, sc[kk]);
      }
      tmax = pq_warp_max(tmax);
      const float m_new = fmaxf(m[i], tmax);
      const float corr = expf(m[i] - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk) {
        const int j = lane + 32 * kk;
        const float p = valid[kk] ? expf(sc[kk] - m_new) : 0.0f;
        psum += p;
        Ps[wr0 + i][j] = p * vss[j];
      }
      psum = pq_warp_sum(psum);
      l[i] = l[i] * corr + psum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[i][e] *= corr;
    }
    __syncwarp();

    const int jmax = min(KT, n_keys - c0);
    for (int j = 0; j < jmax; ++j) {
      float v[DPL];
#pragma unroll
      for (int e = 0; e < DPL; ++e) v[e] = (float)Vs[j][lane * DPL + e];
#pragma unroll
      for (int i = 0; i < AT_RPW; ++i) {
        const float p = Ps[wr0 + i][j];
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[i][e] += p * v[e];
      }
    }
  }

  if (!warp_live) return;
#pragma unroll
  for (int i = 0; i < AT_RPW; ++i) {
    const int r = r0 + wr0 + i;
    if (r >= R) continue;
    const int t = r / group, gi = r % group;
    QT* o = out + (((size_t)b * T + t) * H + h * group + gi) * DH + lane * DPL;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < DPL; ++e) o[e] = pq_from_float<QT>(acc[i][e] / denom);
  }
}

template <int DH, int KT, bool V4, typename QT>
static cudaError_t launch_t(const void* q, const void* kq, const void* ks, const void* vq,
                            const void* vs, const void* lengths, const void* kpos,
                            const void* alibi, const void* sink, void* out, int B, int T,
                            int H, int KV, int S, float sm, int window, float softcap,
                            int sinks, cudaStream_t stream) {
  const int R = T * (H / KV);
  dim3 grid((R + AT_QROWS - 1) / AT_QROWS, KV, B);
#define PQ_AT_KARGS (const QT*)q, (const int8_t*)kq, (const float*)ks, (const int8_t*)vq, \
      (const float*)vs, (const int*)lengths, (const int*)kpos, (const float*)alibi, \
      (const float*)sink, (QT*)out, T, H, KV, S, sm, window, softcap, sinks
  if constexpr (!V4) {  // K8V4 takes no variant but the scale: no VAR instance
    if (kpos != nullptr || alibi != nullptr || sinks > 0) {
      attn_kernel<DH, KT, false, 2, QT><<<grid, AT_THREADS, 0, stream>>>(PQ_AT_KARGS);
      return cudaGetLastError();
    }
    if (window > 0 || softcap > 0.0f || sink != nullptr) {
      attn_kernel<DH, KT, false, 1, QT><<<grid, AT_THREADS, 0, stream>>>(PQ_AT_KARGS);
      return cudaGetLastError();
    }
  }
  attn_kernel<DH, KT, V4, 0, QT><<<grid, AT_THREADS, 0, stream>>>(PQ_AT_KARGS);
#undef PQ_AT_KARGS
  return cudaGetLastError();
}

template <bool V4, typename QT>
static cudaError_t launch_dh(int Dh, const void* q, const void* kq, const void* ks,
                             const void* vq, const void* vs, const void* lengths,
                             const void* kpos, const void* alibi, const void* sink,
                             void* out, int B, int T, int H, int KV, int S, float sm,
                             int window, float softcap, int sinks, cudaStream_t stream) {
#define PQ_AT_ARGS q, kq, ks, vq, vs, lengths, kpos, alibi, sink, out, B, T, H, KV, S, sm, \
                   window, softcap, sinks, stream
  switch (Dh) {
    case 32: return launch_t<32, 64, V4, QT>(PQ_AT_ARGS);
    case 64: return launch_t<64, 64, V4, QT>(PQ_AT_ARGS);
    case 128: return launch_t<128, 64, V4, QT>(PQ_AT_ARGS);
    case 256: return launch_t<256, 32, V4, QT>(PQ_AT_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef PQ_AT_ARGS
}

template <bool V4>
static int entry(const void* q, int q_dtype, const void* kq, const void* ks, const void* vq,
                 const void* vs, const void* lengths, const void* kpos, const void* alibi,
                 const void* sink, void* out, int B, int T, int H, int KV, int S, int Dh,
                 float sm, int window, float softcap, int sinks, void* stream) {
  if (B == 0 || T == 0) return cudaSuccess;
  if (KV == 0 || H % KV != 0 || (V4 && S % 2) || window < 0 || sinks < 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define PQ_AT_DARGS Dh, q, kq, ks, vq, vs, lengths, kpos, alibi, sink, out, B, T, H, KV, S, \
                    sm, window, softcap, sinks, st
  switch (q_dtype) {
    case PQ_F32: return launch_dh<V4, float>(PQ_AT_DARGS);
    case PQ_BF16: return launch_dh<V4, __nv_bfloat16>(PQ_AT_DARGS);
    case PQ_F16: return launch_dh<V4, __half>(PQ_AT_DARGS);
    default: return cudaErrorInvalidValue;
  }
#undef PQ_AT_DARGS
}

PQ_EXPORT int pq_int8_kv_attention(const void* q, int q_dtype, const void* kq, const void* ks,
                                   const void* vq, const void* vs, const void* lengths,
                                   const void* kpos, const void* alibi, const void* sink,
                                   void* out, int B, int T, int H, int KV, int S, int Dh,
                                   float sm, int window, float softcap, int sinks,
                                   void* stream) {
  return entry<false>(q, q_dtype, kq, ks, vq, vs, lengths, kpos, alibi, sink, out, B, T, H, KV,
                      S, Dh, sm, window, softcap, sinks, stream);
}

PQ_EXPORT int pq_mixed_kv_attention(const void* q, int q_dtype, const void* kq, const void* ks,
                                    const void* vq, const void* vs, const void* lengths,
                                    void* out, int B, int T, int H, int KV, int S, int Dh,
                                    float sm, void* stream) {
  return entry<true>(q, q_dtype, kq, ks, vq, vs, lengths, nullptr, nullptr, nullptr, out, B, T,
                     H, KV, S, Dh, sm, 0, 0.0f, 0, stream);
}
