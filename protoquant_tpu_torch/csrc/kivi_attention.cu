// Flash attention over the KIVI caches, causal, with GQA, prefill or decode.
//
// Replaces protoquant_tpu/ops/attention.py:_attn_k4v8_kernel (K4V8KVCache)
// and _attn4_kernel (Int4KVCache) with their sliding-window, score-scale,
// softcap, ALiBi and learned-sink variants (all they take); one template, V4
// choosing the V layout.
//   q [B, T, H, Dh] (f32/bf16/f16); kq [B, KV, S/2, Dh] int8 packed K (row
//   r: token 2r in the low nibble, 2r + 1 in the high one); kchs [B, KV,
//   S/G, Dh] f32 per-(chunk, channel) K scales; ktail/vtail [B, KV, 2G, Dh]
//   int8 and kts/vts [B, KV, 2G] f32 (row j: the latest position = j mod
//   2G); K4V8: vq [B, KV, S, Dh] int8, vs [B, KV, S] f32; Int4 (V4): vq
//   [B, KV, S/2, Dh] packed like K, vs [B, KV, 2, S/2] per-token scales,
//   plane 0 even tokens, plane 1 odd; lengths [B] = length BEFORE this
//   step's T tokens, new_lengths after it; alibi [H] f32 or null; sink [H]
//   f32 or null (GPT-OSS's learned sinks).
// Query row t (horizon len + t) sees key position p <= len + t and, with
// window > 0, p > len + t - window. Positions
// below the frontier F = (min(new_len, S) / G) G come from the packed
// store, K as nib * kchs[p / G][d] (the single f32 product of the plain
// version's dequant); the others from the tails, one final block of 2G
// rows where column col holds position pos = horizon - ((horizon - col)
// mod 2G), valid iff F <= pos < S. For K4V8 the tail block reads V from
// the tail mirror (vtail/vts), as the TPU kernel does; it holds the same
// rows as vq/vs at those positions.
//   score = (q . k) * sm (sm = scale or Dh^-0.5); with softcap > 0, score =
//   softcap * tanh(score / softcap), then with ALiBi score -= alibi[head] *
//   (horizon - pos), before the mask, in the packed tiles and the tail
//   alike; softmax online in f32, out = sum p * vs * v; a learned sink
//   joins each row's softmax without a value, as the initial state m =
//   sink, l = 1, acc = 0 (the TPU kernels' init).
// The per-channel K scale cannot leave the q . k sum, so each 64-key tile
// is unpacked into f32 in shared memory; the per-token V scale multiplies
// p, as in the dense kernel. All arithmetic is f32 (the TPU kernel's bf16
// lanes are a choice for its matrix unit).
// Bound on the H100: bytes, the visible part of the packed store (Dh / 2 per
// key for K, Dh (K4V8) or Dh / 2 (Int4) for V, plus scales), the live tail
// rows, q and out.
// Design: as csrc/attention.cu, one block of 4 warps per (b, kv head, 16
// query rows), each warp owning 4 rows; 64-key tiles (32 at Dh = 256)
// walked from the tile of the first row's earliest visible key (packed tiles
// wholly below the window are skipped, as the TPU kernel skips its blocks)
// up to min(F, len + t_max + 1), then the tail in 64-row tiles, masked by
// the same window. The window, the softcap and the learned sinks are read
// only by the VAR >= 1 instances, the ALiBi slopes only by VAR = 2, and a
// call takes the least
// instance its variants need, as in csrc/attention.cu; each row's slope
// sits in a register.
// Shared memory is dynamic (about 53 KB at Dh = 128). This one-pass kernel
// takes the calls that the split-S design of csrc/kivi_split.cuh cannot:
// more query rows a kv head than a split block holds (prefill chunks), or a
// chunk G it does not tile (ks_plan there decides).

#include "kivi.cuh"

constexpr int KA_WARPS = 4;
constexpr int KA_RPW = 4;
constexpr int KA_QROWS = KA_WARPS * KA_RPW;
constexpr int KA_THREADS = KA_WARPS * 32;
constexpr float KA_NEG_INF = -1e30f;

template <int DH, int KT>
constexpr int ka_smem_bytes() {
  return 4 * (KA_QROWS * DH + KT * (DH + 4) + KA_QROWS * KT + KT) + KT * DH;
}

template <int DH, int KT, bool V4, int VAR, typename QT>
__global__ void __launch_bounds__(KA_THREADS)
kivi_attn_kernel(const QT* __restrict__ q, const int8_t* __restrict__ kq,
                 const float* __restrict__ kchs, const int8_t* __restrict__ vq,
                 const float* __restrict__ vs, const int8_t* __restrict__ ktail,
                 const float* __restrict__ kts, const int8_t* __restrict__ vtail,
                 const float* __restrict__ vts, const int* __restrict__ lengths,
                 const int* __restrict__ new_lengths, const float* __restrict__ alibi,
                 const float* __restrict__ sink, QT* __restrict__ out, int T, int H, int KV,
                 int S, int G, float sm, int window, float softcap) {
  constexpr int DPL = DH / 32;  // output dims per lane
  constexpr int KPL = KT / 32;  // keys per lane
  constexpr int KSTR = DH + 4;  // padded f32 K row: float4 reads of 8 rows hit 8 bank groups
  extern __shared__ __align__(16) unsigned char smem[];
  float(*Qs)[DH] = reinterpret_cast<float(*)[DH]>(smem);
  float(*Kf)[KSTR] = reinterpret_cast<float(*)[KSTR]>(smem + 4 * KA_QROWS * DH);
  float(*Ps)[KT] = reinterpret_cast<float(*)[KT]>(smem + 4 * (KA_QROWS * DH + KT * KSTR));
  float* vss = reinterpret_cast<float*>(smem + 4 * (KA_QROWS * DH + KT * KSTR + KA_QROWS * KT));
  int8_t(*Vs)[DH] = reinterpret_cast<int8_t(*)[DH]>(
      smem + 4 * (KA_QROWS * DH + KT * KSTR + KA_QROWS * KT + KT));

  const int b = blockIdx.z, h = blockIdx.y, r0 = blockIdx.x * KA_QROWS;
  const int group = H / KV, R = T * group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int TC = 2 * G, S2 = S / 2;
  const int len = lengths[b];
  const int frontier = (min(max(new_lengths[b], 0), S) / G) * G;
  const int rows_here = min(KA_QROWS, R - r0);
  const int t_max = (r0 + rows_here - 1) / group;
  const int n_keys = max(0, min(frontier, len + t_max + 1));  // packed keys walked
  const int n_packed = (n_keys + KT - 1) / KT, n_tail = (TC + KT - 1) / KT;
  // first packed tile holding a key inside the block's first row's window
  const int tile0 =
      VAR > 0 && window > 0 ? min(max(len + r0 / group - window + 1, 0) / KT, n_packed) : 0;
  const float inv_cap = VAR > 0 && softcap > 0.0f ? 1.0f / softcap : 0.0f;

  for (int i = threadIdx.x; i < KA_QROWS * DH; i += KA_THREADS) {
    const int r = i / DH, d = i % DH, gr = r0 + r;
    float v = 0.0f;
    if (gr < R) {
      const int t = gr / group, gi = gr % group;
      v = pq_to_float(q[(((size_t)b * T + t) * H + h * group + gi) * DH + d]);
    }
    Qs[r][d] = v;
  }

  const size_t bh = (size_t)b * KV + h;
  const int8_t* kb = kq + bh * S2 * DH;
  const float* chb = kchs + bh * (size_t)(S / G) * DH;
  const int8_t* vb = vq + bh * (size_t)(V4 ? S2 : S) * DH;
  const float* vsb = vs + bh * (size_t)S;  // [2, S/2] or [S]: S floats either way
  const int8_t* ktb = ktail + bh * TC * DH;
  const int8_t* vtb = vtail + bh * TC * DH;
  const float* ktsb = kts + bh * TC;
  const float* vtsb = vts + bh * TC;

  const int wr0 = warp * KA_RPW;
  const bool warp_live = r0 + wr0 < R;
  float m[KA_RPW], l[KA_RPW], acc[KA_RPW][DPL], slope[KA_RPW];
#pragma unroll
  for (int i = 0; i < KA_RPW; ++i) {
    const int r = r0 + wr0 + i;
    slope[i] = VAR == 2 && alibi != nullptr && r < R ? alibi[h * group + r % group] : 0.0f;
    // a learned sink: denominator mass without a value
    const bool has_sink = VAR > 0 && sink != nullptr && r < R;
    m[i] = has_sink ? sink[h * group + r % group] : KA_NEG_INF;
    l[i] = has_sink ? 1.0f : 0.0f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[i][e] = 0.0f;
  }

  for (int tile = tile0; tile < n_packed + n_tail; ++tile) {
    const bool tail = tile >= n_packed;
    const int c0 = (tail ? tile - n_packed : tile) * KT;
    const int n_here = tail ? TC : n_keys;  // keys (or tail rows) that exist
    __syncthreads();  // Q staged / previous tile consumed
    if (!tail) {
      // packed K (and V4's packed V): KT / 2 byte rows, two tokens each
      for (int i = threadIdx.x; i < (KT / 2) * (DH / 4); i += KA_THREADS) {
        const int pr = i / (DH / 4), w = i % (DH / 4), tok = c0 + 2 * pr;
        int kw = 0, vw = 0;
        float4 sc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (tok < n_keys) {
          kw = ((const int*)(kb + (size_t)(tok / 2) * DH))[w];
          sc = ((const float4*)(chb + (size_t)(tok / G) * DH))[w];
          if (V4) vw = ((const int*)(vb + (size_t)(tok / 2) * DH))[w];
        }
        const float s4[4] = {sc.x, sc.y, sc.z, sc.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kbyte = pq_byte(kw, e);
          Kf[2 * pr][4 * w + e] = __fmul_rn((float)pq_nib_lo(kbyte), s4[e]);
          Kf[2 * pr + 1][4 * w + e] = __fmul_rn((float)pq_nib_hi(kbyte), s4[e]);
          if (V4) {
            const int vbyte = pq_byte(vw, e);
            Vs[2 * pr][4 * w + e] = (int8_t)pq_nib_lo(vbyte);
            Vs[2 * pr + 1][4 * w + e] = (int8_t)pq_nib_hi(vbyte);
          }
        }
      }
      if (V4) {
        for (int j = threadIdx.x; j < KT / 2; j += KA_THREADS) {
          const int tok = c0 + 2 * j;
          vss[2 * j] = tok < n_keys ? vsb[tok / 2] : 0.0f;
          vss[2 * j + 1] = tok < n_keys ? vsb[S2 + tok / 2] : 0.0f;
        }
      } else {
        for (int i = threadIdx.x; i < KT * (DH / 4); i += KA_THREADS) {
          const int j = i / (DH / 4), w = i % (DH / 4), c = c0 + j;
          *(int*)&Vs[j][4 * w] = c < n_keys ? ((const int*)(vb + (size_t)c * DH))[w] : 0;
        }
        for (int j = threadIdx.x; j < KT; j += KA_THREADS) {
          const int c = c0 + j;
          vss[j] = c < n_keys ? vsb[c] : 0.0f;
        }
      }
    } else {
      // tail rows: int8 K times its per-token scale, int8 V
      for (int i = threadIdx.x; i < KT * (DH / 4); i += KA_THREADS) {
        const int j = i / (DH / 4), w = i % (DH / 4), col = c0 + j;
        int kw = 0, vw = 0;
        float s = 0.0f;
        if (col < TC) {
          kw = ((const int*)(ktb + (size_t)col * DH))[w];
          vw = ((const int*)(vtb + (size_t)col * DH))[w];
          s = ktsb[col];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) Kf[j][4 * w + e] = __fmul_rn((float)pq_byte(kw, e), s);
        *(int*)&Vs[j][4 * w] = vw;
      }
      for (int j = threadIdx.x; j < KT; j += KA_THREADS) {
        const int col = c0 + j;
        vss[j] = col < TC ? vtsb[col] : 0.0f;
      }
    }
    __syncthreads();
    if (!warp_live) continue;

    float s[KA_RPW][KPL];
#pragma unroll
    for (int i = 0; i < KA_RPW; ++i)
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk) s[i][kk] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 qv[KA_RPW];
#pragma unroll
      for (int i = 0; i < KA_RPW; ++i) qv[i] = *(const float4*)&Qs[wr0 + i][d];
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk) {
        const float4 k4 = *(const float4*)&Kf[lane + 32 * kk][d];
#pragma unroll
        for (int i = 0; i < KA_RPW; ++i)
          s[i][kk] += qv[i].x * k4.x + qv[i].y * k4.y + qv[i].z * k4.z + qv[i].w * k4.w;
      }
    }

#pragma unroll
    for (int i = 0; i < KA_RPW; ++i) {
      const int r = r0 + wr0 + i;
      const int horizon = len + r / group;
      // positions <= lower are out
      const int lower = VAR > 0 && window > 0 ? horizon - window : -1 - S;
      bool valid[KPL];
      float sc[KPL];
      float tmax = KA_NEG_INF;
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk) {
        const int c = c0 + lane + 32 * kk;
        bool ok = r < R && c < n_here;
        int pos = c;  // the packed store holds position c
        if (ok && !tail) {
          ok = c <= horizon && (VAR == 0 || c > lower);  // c < n_keys <= frontier
        } else if (ok) {
          int md = (horizon - c) % TC;
          if (md < 0) md += TC;
          pos = horizon - md;
          ok = pos >= frontier && pos < S && (VAR == 0 || pos > lower);
        }
        valid[kk] = ok;
        float v = s[i][kk] * sm;
        if (VAR > 0 && softcap > 0.0f) v = softcap * tanhf(v * inv_cap);
        if (VAR == 2) v -= slope[i] * (float)(horizon - pos);
        sc[kk] = ok ? v : KA_NEG_INF;
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

    const int jmax = min(KT, n_here - c0);
    for (int j = 0; j < jmax; ++j) {
      float v[DPL];
#pragma unroll
      for (int e = 0; e < DPL; ++e) v[e] = (float)Vs[j][lane * DPL + e];
#pragma unroll
      for (int i = 0; i < KA_RPW; ++i) {
        const float p = Ps[wr0 + i][j];
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[i][e] += p * v[e];
      }
    }
  }

  if (!warp_live) return;
#pragma unroll
  for (int i = 0; i < KA_RPW; ++i) {
    const int r = r0 + wr0 + i;
    if (r >= R) continue;
    const int t = r / group, gi = r % group;
    QT* o = out + (((size_t)b * T + t) * H + h * group + gi) * DH + lane * DPL;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < DPL; ++e) o[e] = pq_from_float<QT>(acc[i][e] / denom);
  }
}

template <int DH, int KT, bool V4, int VAR, typename QT>
static cudaError_t launch_var(const void* q, const void* kq, const void* kchs, const void* vq,
                              const void* vs, const void* ktail, const void* kts,
                              const void* vtail, const void* vts, const void* lengths,
                              const void* new_lengths, const void* alibi, const void* sink,
                              void* out, int B, int T, int H, int KV, int S, int G, float sm,
                              int window, float softcap, cudaStream_t stream) {
  constexpr int smem = ka_smem_bytes<DH, KT>();
  static bool configured = false;
  cudaError_t err = pq_allow_smem(kivi_attn_kernel<DH, KT, V4, VAR, QT>, smem, configured);
  if (err != cudaSuccess) return err;
  const int R = T * (H / KV);
  dim3 grid((R + KA_QROWS - 1) / KA_QROWS, KV, B);
  kivi_attn_kernel<DH, KT, V4, VAR, QT><<<grid, KA_THREADS, smem, stream>>>(
      (const QT*)q, (const int8_t*)kq, (const float*)kchs, (const int8_t*)vq,
      (const float*)vs, (const int8_t*)ktail, (const float*)kts, (const int8_t*)vtail,
      (const float*)vts, (const int*)lengths, (const int*)new_lengths, (const float*)alibi,
      (const float*)sink, (QT*)out, T, H, KV, S, G, sm, window, softcap);
  return cudaGetLastError();
}

template <int DH, int KT, bool V4, typename QT>
static cudaError_t launch_t(const void* q, const void* kq, const void* kchs, const void* vq,
                            const void* vs, const void* ktail, const void* kts,
                            const void* vtail, const void* vts, const void* lengths,
                            const void* new_lengths, const void* alibi, const void* sink,
                            void* out, int B, int T, int H, int KV, int S, int G, float sm,
                            int window, float softcap, cudaStream_t stream) {
#define PQ_KA_VARGS q, kq, kchs, vq, vs, ktail, kts, vtail, vts, lengths, new_lengths, alibi, \
                    sink, out, B, T, H, KV, S, G, sm, window, softcap, stream
  if (alibi != nullptr) return launch_var<DH, KT, V4, 2, QT>(PQ_KA_VARGS);
  if (window > 0 || softcap > 0.0f || sink != nullptr)
    return launch_var<DH, KT, V4, 1, QT>(PQ_KA_VARGS);
  return launch_var<DH, KT, V4, 0, QT>(PQ_KA_VARGS);
#undef PQ_KA_VARGS
}

template <bool V4, typename QT>
static cudaError_t launch_dh(int Dh, const void* q, const void* kq, const void* kchs,
                             const void* vq, const void* vs, const void* ktail, const void* kts,
                             const void* vtail, const void* vts, const void* lengths,
                             const void* new_lengths, const void* alibi, const void* sink,
                             void* out, int B, int T, int H, int KV, int S, int G, float sm,
                             int window, float softcap, cudaStream_t st) {
#define PQ_KA_ARGS q, kq, kchs, vq, vs, ktail, kts, vtail, vts, lengths, new_lengths, alibi, \
                   sink, out, B, T, H, KV, S, G, sm, window, softcap, st
  switch (Dh) {
    case 32: return launch_t<32, 64, V4, QT>(PQ_KA_ARGS);
    case 64: return launch_t<64, 64, V4, QT>(PQ_KA_ARGS);
    case 128: return launch_t<128, 64, V4, QT>(PQ_KA_ARGS);
    case 256: return launch_t<256, 32, V4, QT>(PQ_KA_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef PQ_KA_ARGS
}

template <bool V4>
static int entry(const void* q, int q_dtype, const void* kq, const void* kchs, const void* vq,
                 const void* vs, const void* ktail, const void* kts, const void* vtail,
                 const void* vts, const void* lengths, const void* new_lengths,
                 const void* alibi, const void* sink, void* out, int B, int T, int H, int KV,
                 int S, int Dh, int G, float sm, int window, float softcap, void* stream) {
  if (B == 0 || T == 0) return cudaSuccess;
  if (KV == 0 || H % KV != 0 || G < 2 || G % 2 || S % G || window < 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define PQ_KA_DARGS Dh, q, kq, kchs, vq, vs, ktail, kts, vtail, vts, lengths, new_lengths, \
                    alibi, sink, out, B, T, H, KV, S, G, sm, window, softcap, st
  switch (q_dtype) {
    case PQ_F32: return launch_dh<V4, float>(PQ_KA_DARGS);
    case PQ_BF16: return launch_dh<V4, __nv_bfloat16>(PQ_KA_DARGS);
    case PQ_F16: return launch_dh<V4, __half>(PQ_KA_DARGS);
    default: return cudaErrorInvalidValue;
  }
#undef PQ_KA_DARGS
}

PQ_EXPORT int pq_k4v8_attention(const void* q, int q_dtype, const void* kq, const void* kchs,
                                const void* vq, const void* vs, const void* ktail,
                                const void* kts, const void* vtail, const void* vts,
                                const void* lengths, const void* new_lengths,
                                const void* alibi, const void* sink, void* out, int B, int T,
                                int H, int KV, int S, int Dh, int G, float sm, int window,
                                float softcap, void* stream) {
  return entry<false>(q, q_dtype, kq, kchs, vq, vs, ktail, kts, vtail, vts, lengths,
                      new_lengths, alibi, sink, out, B, T, H, KV, S, Dh, G, sm, window, softcap,
                      stream);
}

PQ_EXPORT int pq_int4_kv_attention(const void* q, int q_dtype, const void* kq,
                                   const void* kchs, const void* vq, const void* vs,
                                   const void* ktail, const void* kts, const void* vtail,
                                   const void* vts, const void* lengths,
                                   const void* new_lengths, const void* alibi,
                                   const void* sink, void* out, int B, int T, int H, int KV,
                                   int S, int Dh, int G, float sm, int window, float softcap,
                                   void* stream) {
  return entry<true>(q, q_dtype, kq, kchs, vq, vs, ktail, kts, vtail, vts, lengths,
                     new_lengths, alibi, sink, out, B, T, H, KV, S, Dh, G, sm, window, softcap,
                     stream);
}
