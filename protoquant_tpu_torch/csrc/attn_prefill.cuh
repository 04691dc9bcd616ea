// Flash-attention prefill over the dense int8 KV cache, the mixed K8V4
// cache and the KIVI caches (K4V8, Int4) on the H100's bf16 tensor cores:
// every int8_kv_attention, mixed_kv_attention, k4v8_attention and
// int4_kv_attention call that the split-S decodes (attn_split.cuh, as_plan;
// kivi_split.cuh, ks_plan) do not take, i.e. every prefill chunk (dense,
// ring, the paged cache's gathered window) and the KIVI decodes whose chunk
// G the split design does not tile.
//
// Replaces protoquant_tpu/ops/attention.py:_attn_kernel (Pallas) with all
// its variants (sliding window, score scale, softcap, ring positions,
// StreamingLLM sinks, ALiBi, learned sinks), _attn_mixed_kernel (V4 =
// true; the wrapper passes its score scale and no other variant, as the TPU
// kernel takes), and (KIVI = true) _attn_k4v8_kernel and _attn4_kernel (V4:
// Int4) with theirs (window, score scale, softcap, ALiBi, learned sinks).
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
//   m = sink, l = 1, acc = 0 (the TPU kernel's initial state).
// V4 (K8V4): vq [B, KV, S/2, Dh] holds token pairs (row r: token 2r in the
// low nibble, 2r + 1 in the high one), vs [B, KV, 2, S/2] their scales
// (plane 0 even tokens, plane 1 odd).
// KIVI: kq [B, KV, S/2, Dh] packed K (token pairs, as V4's V), kchs [B, KV,
// S/G, Dh] f32 per-(chunk, channel) K scales, ktail/vtail [B, KV, 2G, Dh]
// int8 and kts/vts [B, KV, 2G] f32 (row j: the latest position = j mod 2G),
// new_lengths [B] the lengths after the step; ks and kpos are null, sinks 0.
// K4V8: vq/vs as the int8 cache's; Int4 (V4): as K8V4's. Positions below
// the frontier F = (min(new_len, S) / G) G come from the packed store, K as
// nib * kchs[p / G][d] (the plain version's single f32 product) and score =
// (q . k) * sm; the others from the tails: tail column col holds position
// pos = F - (F mod 2G) + col (+ 2G where col < F mod 2G), the one position
// = col mod 2G in [F, F + 2G), visible iff pos < S and as above; its score
// is (q . ktail[col]) * kts[col] * sm and its V is vtail[col] * vts[col]
// (K4V8's V tail mirrors vq at those positions, as the TPU kernel reads
// it). For a query row at p_t < F + 2G (every row of a step whose lengths
// advance by T) this is the TPU kernel's rule, the latest position <= p_t
// = col mod 2G, visible iff >= F (and < S).
//
// Numerics: the TPU kernel's lanes (_attend runs it with lane = bf16):
// q . k and (p * vs) . v on bf16 operands into f32 sums, but with q and
// p * vs each split into bf16 terms, one product per term. An int8 value
// is exact in bf16 and a bf16 q times it exact in f32, so for bf16 q (the
// engine's) one term of q loses nothing; f16 q takes 2 (exact), f32 q 3
// (within 2^-25). p * vs takes 3 terms (within 2^-25): with the TPU's
// single bf16 term the outputs moved by a bf16 ulp against the plain
// version's often enough that the 2-layer bf16 agreements of chip_smoke.py
// (phases 5, 9, 11) moved from rel L2 0.002-0.013 to 0.026-0.030, at their
// 0.03 limit, where the int8 activation codes turn each ulp into a code
// step. A KIVI packed K element (nib times an f32 scale) is no bf16 value:
// it takes 2 terms (within 2^-17 of itself), each q term meeting each K
// term (bf16 q: 2 products, against the TPU kernel's one product of a
// single bf16 k_nib * s_tile); a tail tile's int8 K one.
// ops/attention.py:dense_attention_tiles_ref spells this decomposition out
// in plain PyTorch, kivi_attention_tiles_ref the KIVI walk on top of it.
//
// Bound on the H100: at prefill the operations, 4 Dh per visible (row, key)
// at the dense bf16 peak; short chunks over long caches the bytes of the
// keys inside the rows' windows. What holds it back is neither: the
// tile's int8 -> bf16 conversion (KIVI: the nibble times its scale, split
// in two terms), the softmax on the fragments and the three terms of p * vs
// take more instructions than the products, and a warp issues them one
// after another (PERF.md).
// Design:
// - One block of 8 warps per (64 query rows, kv head, b): 4 row groups of
//   16 rows, so the GQA rows of a kv head share each K/V tile, and 2 warps
//   a row group, each taking half of every tile's keys with its own online
//   softmax (m, l, O); the halves meet in shared memory at the end, in a
//   fixed order. Blocks are numbered from the last row block down, so the
//   longest walks launch first. (A chunk gives few blocks: 7B's 256 rows
//   over 32 kv heads are 128, one an SM, whose warps wait on their own
//   instructions' latency; the second warp of a row group doubles the
//   warps an SM has to issue from.)
// - The walk: KT = 64-key tiles (128 at Dh 128, 32 at Dh 256) from the
//   tile holding the block's first row's earliest visible key,
//   lengths[b] + t_min - window + 1 (0 without a window: the TPU kernel's
//   block skipping), up to its last row's horizon min(S, lengths[b] +
//   t_max + 1), so a padded chunk whose rows reach past S is clamped at S;
//   with StreamingLLM sinks the tiles holding columns < sinks come first,
//   then the skip. A ring scatters positions over its columns, so every
//   tile of its S = O(window) columns is loaded, each tile's positions
//   staged beside it, and converted only if some row of the block reaches
//   one of them. KIVI: the packed tiles up to min(F, the last row's
//   horizon + 1), then the 2G tail columns in tiles of KT (walked only
//   where F < S and the last row reaches F). A warp skips the products of
//   its part of a tile wholly outside its own rows (past its last row's
//   horizon or the packed keys, or below its first row's window and the
//   sinks; a ring's: none of its positions there; a tail part: past 2G, or
//   its last row below F): every element would be masked.
// - Staging: the raw int8 K and V rows (K8V4: the packed byte rows) move by
//   16-byte cp.async (zero-filled past the walk's end), the scales and a
//   ring's positions by 4-byte copies, into a ring of NS stages: tile
//   i + NS - 1 is in flight while tile i is converted and consumed. Each
//   tile is converted once, by the whole block, into bf16 K and V in shared
//   memory (exactly: through 2^23 + x; K8V4's nibbles unpacked there, the
//   low one token 2r, the high one 2r + 1), in rows of Dh + 8 so that the
//   8 rows an ldmatrix phase reads fall in 32 distinct banks. A KIVI packed
//   tile stages its KT / 2 packed K rows and the chunk-scale rows they span
//   (up to KT / 8 rows, in the room a tail tile's int8 K rows take; a
//   smaller G, below 8, reads its scale rows from global memory at the
//   conversion), and converts each element to __fmul_rn(nib, kchs[p /
//   G][d]) and that to 2 bf16 terms, each a K tile of its own.
// - Per warp and tile part: S = Q K^T by mma.sync.m16n8k16 (Q and K
//   fragments by ldmatrix, each 32-dim step's loaded before its products),
//   then on the accumulator fragments score = S * ks * sm, the softcap,
//   ALiBi with the column's position, the mask; each row's max over the 4
//   lanes of a quad; FA2's online rescale (m, a per-lane partial l summed
//   over the quad at the end, O scaled by exp(m_old - m_new) where some
//   row's max moved); a masked entry's p is zeroed by the mask, not by
//   exp, so a row with no visible key in a tile keeps m, l and O as they
//   were (its learned sink too); p * vs goes from the accumulators into
//   the A fragments of O += P V (V fragments by ldmatrix.trans) in
//   registers, never through shared memory. out = O / max(l, 1e-30).
// - No workspace, no atomics, no host sync: a call can be captured in a
//   CUDA graph, and two calls on the same inputs give the same bits.
// Every variant is a runtime value read only by an instance that takes it:
// VAR = 1 reads the window, the softcap and the learned sinks, VAR = 2 also
// the ring's positions, the StreamingLLM sinks and ALiBi (KIVI: ALiBi), and
// a call takes the least instance its variants need; VAR = 0 (full causal)
// and K8V4 compile them all out.

#pragma once

#include "split_common.cuh"

constexpr int AP_RG = 4;                    // row groups of 16 query rows
constexpr int AP_KS = 2;                    // warps sharing a row group, each a part of a tile
constexpr int AP_ROWS = 16 * AP_RG;         // query rows of a block
constexpr int AP_THREADS = 32 * AP_RG * AP_KS;
constexpr float AP_NEG_INF = -1e30f;

struct AttnPrefillArgs {
  const void* q;
  int q_dtype;
  const int8_t* kq;
  const float* ks;
  const int8_t* vq;
  const float* vs;
  const int* lengths;
  const int* kpos;
  const float* alibi;
  const float* sink;
  void* out;
  int B, T, H, KV, S, Dh;
  float sm;
  int window;
  float softcap;
  int sinks;
  // the KIVI caches (kq then holds the packed K; ks and kpos are null)
  const float* kchs;
  const int8_t* ktail;
  const float* kts;
  const int8_t* vtail;
  const float* vts;
  const int* new_lengths;
  int G;
};

// bf16 terms of q (Q): 1 for bf16 q, 2 for f16, 3 for f32; of p * vs (P): 3.
template <typename QT>
struct ApTerms {
  static constexpr int Q = 3, P = 3;
};
template <>
struct ApTerms<__nv_bfloat16> {
  static constexpr int Q = 1, P = 3;
};
template <>
struct ApTerms<__half> {
  static constexpr int Q = 2, P = 3;
};

// Shared memory of an instance: Q (NQ terms, [AP_ROWS][STR] bf16 each), the
// bf16 K tiles (NK terms, [KT][STR] each) and V tile, then NS raw stages,
// each the tile's int8 K rows, V rows (K8V4: KT / 2 packed rows), K scales,
// V scales and, at VAR = 2, positions. A KIVI packed tile puts its KT / 2
// packed K rows and up to SR chunk-scale rows where a tail tile's int8 K
// rows go; its V rows (Int4: KT / 2 packed) where the tail's V rows go.
// NS = 3 where two blocks an SM still fit (int8 and K8V4: also for f32 and
// f16 q), else 2.
template <int DH, bool V4, int VAR, typename QT, bool KIVI = false>
struct ApGeom {
  static constexpr int NQ = ApTerms<QT>::Q, NP = ApTerms<QT>::P;
  static constexpr int NK = KIVI ? 2 : 1;  // bf16 terms of K
  static constexpr int KT = DH == 128 ? 128 : DH == 256 ? 32 : 64;  // keys of a tile
  static constexpr int STR = DH + 8;              // padded bf16 row
  static constexpr int OFF_SC = KT / 2 * DH;      // KIVI: chunk-scale rows after the packed K
  static constexpr int SR = KT / 8;               // chunk-scale rows a stage holds
  static constexpr int OFF_V = KT * DH;
  static constexpr int OFF_KS = OFF_V + (V4 && !KIVI ? KT / 2 : KT) * DH;
  static constexpr int OFF_VS = OFF_KS + 4 * KT;
  static constexpr int OFF_POS = OFF_VS + 4 * KT;
  static constexpr int STAGE = OFF_POS + (VAR == 2 && !KIVI ? 4 * KT : 0);
  static constexpr int QBYTES = NQ * AP_ROWS * STR * 2;
  static constexpr int TILES = (NK + 1) * KT * STR * 2;
  static constexpr bool FITS3 = QBYTES + TILES + 3 * STAGE <= 113 * 1024;
  static constexpr int NS = FITS3 || (NQ > 1 && !KIVI) ? 3 : 2;
  static constexpr int SMEM = QBYTES + TILES + NS * STAGE;
  static_assert(DH % 32 == 0 && STAGE % 16 == 0, "16-byte copies and k16 fragments");
  static_assert(KT % (16 * AP_KS) == 0, "a warp takes whole k16 steps of a tile");
  static_assert(SMEM >= (DH / 2 + 4) * 4 * AP_RG * 32, "the parts' merge reuses the tiles");
  static_assert(SMEM <= 227 * 1024, "the H100's shared memory a block");
  static_assert(OFF_SC + SR * DH * 4 == OFF_V, "a packed tile's K and scale rows fill the K room");
  // blocks an SM the registers must leave room for: at Dh <= 64 two (128
  // registers a thread), where the GQA grids (GPT-OSS: 512 blocks) fill the
  // card many times over; left to itself ptxas takes 130-175 there, one
  // block an SM
  static constexpr int MINB = DH <= 64 ? 2 : 1;
};

// ldmatrix and mma are volatile asm: never moved across the block's barriers.
__device__ __forceinline__ void ap_ldsm4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ap_ldsm4t(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// c += a . b over one m16n8k16 tile: bf16 operands, f32 accumulators.
__device__ __forceinline__ void ap_mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x0, x1) as NT bf16x2 terms, the first rounded to nearest, each next one
// the rounded remainder: x = sum of the terms within 2^-(8 NT + 1) |x|.
template <int NT>
__device__ __forceinline__ void ap_terms(float x0, float x1, uint32_t (&w)[NT]) {
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
    w[i] = *reinterpret_cast<const uint32_t*>(&v);
    if (i + 1 < NT) {
      const float2 f = __bfloat1622float2(v);
      x0 -= f.x;
      x1 -= f.y;
    }
  }
}

// Two small integers held exactly in f32 as one bf16x2 word (their low 16
// bits are 0: the upper halves are the bf16 values).
__device__ __forceinline__ uint32_t ap_pack_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// 8 int8 values (two words) as 8 bf16, exactly.
__device__ __forceinline__ uint4 ap_i8x8(uint2 w) {
  const unsigned x = w.x ^ 0x80808080u, y = w.y ^ 0x80808080u;
  return make_uint4(ap_pack_exact(sp_byte(x, 0), sp_byte(x, 1)),
                    ap_pack_exact(sp_byte(x, 2), sp_byte(x, 3)),
                    ap_pack_exact(sp_byte(y, 0), sp_byte(y, 1)),
                    ap_pack_exact(sp_byte(y, 2), sp_byte(y, 3)));
}

// 8 packed bytes of K8V4's V: the low nibbles (token 2r) and the high ones
// (token 2r + 1) as 8 bf16 each, exactly.
__device__ __forceinline__ void ap_nib8(uint2 w, uint4& lo, uint4& hi) {
  const unsigned x = w.x ^ 0x88888888u, y = w.y ^ 0x88888888u;
  lo = make_uint4(ap_pack_exact(sp_nib(x, 0), sp_nib(x, 8)),
                  ap_pack_exact(sp_nib(x, 16), sp_nib(x, 24)),
                  ap_pack_exact(sp_nib(y, 0), sp_nib(y, 8)),
                  ap_pack_exact(sp_nib(y, 16), sp_nib(y, 24)));
  hi = make_uint4(ap_pack_exact(sp_nib(x, 4), sp_nib(x, 12)),
                  ap_pack_exact(sp_nib(x, 20), sp_nib(x, 28)),
                  ap_pack_exact(sp_nib(y, 4), sp_nib(y, 12)),
                  ap_pack_exact(sp_nib(y, 20), sp_nib(y, 28)));
}

// 8 packed bytes of a KIVI K row (dims d .. d + 7; the low nibbles token
// 2r, the high ones 2r + 1) times the chunk's scales s of those dims, each
// the plain version's single f32 product, as NK bf16 terms of 8 each.
template <int NK>
__device__ __forceinline__ void ap_kivi8(uint2 w, const float (&s)[8], uint4 (&lo)[NK],
                                         uint4 (&hi)[NK]) {
  const unsigned x = w.x ^ 0x88888888u, y = w.y ^ 0x88888888u;
  uint32_t wl[4][NK], wh[4][NK];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned z = k < 2 ? x : y;
    const int sh = 16 * (k & 1);  // bytes 2k and 2k + 1 of the 8
    ap_terms<NK>(__fmul_rn(sp_nib(z, sh), s[2 * k]), __fmul_rn(sp_nib(z, sh + 8), s[2 * k + 1]),
                 wl[k]);
    ap_terms<NK>(__fmul_rn(sp_nib(z, sh + 4), s[2 * k]),
                 __fmul_rn(sp_nib(z, sh + 12), s[2 * k + 1]), wh[k]);
  }
#pragma unroll
  for (int t = 0; t < NK; ++t) {
    lo[t] = make_uint4(wl[0][t], wl[1][t], wl[2][t], wl[3][t]);
    hi[t] = make_uint4(wh[0][t], wh[1][t], wh[2][t], wh[3][t]);
  }
}

__device__ __forceinline__ void ap_store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void ap_store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void ap_store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

template <int DH, bool V4, int VAR, typename QT, bool KIVI>
__global__ void __launch_bounds__(AP_THREADS, (ApGeom<DH, V4, VAR, QT, KIVI>::MINB))
    attn_prefill_kernel(const AttnPrefillArgs a) {
  using Gm = ApGeom<DH, V4, VAR, QT, KIVI>;
  constexpr int NQ = Gm::NQ, NK = Gm::NK, NP = Gm::NP, KT = Gm::KT, STR = Gm::STR, NS = Gm::NS;
  constexpr int KW = KT / AP_KS;  // keys of a tile a warp takes
  constexpr int NB = KW / 8;      // their n8 blocks
  constexpr int DB = DH / 8;      // n8 blocks of the head dims
  constexpr int VG = DH == 256 ? 8 : DB;  // n8 blocks of V whose fragments load together
  constexpr bool EXT = VAR == 2;  // ring positions, StreamingLLM sinks, ALiBi
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [NQ][AP_ROWS][STR]
  __nv_bfloat16* Kb = Qs + NQ * AP_ROWS * STR;                 // [NK][KT][STR]
  __nv_bfloat16* Vb = Kb + NK * KT * STR;                      // [KT][STR]
  unsigned char* raw = smem + Gm::QBYTES + Gm::TILES;          // [NS][STAGE]

  const int group = a.H / a.KV, R = a.T * group, S = a.S;
  const int per_rb = a.KV * a.B;
  const int n_rb = (R + AP_ROWS - 1) / AP_ROWS;
  const int rb = n_rb - 1 - (int)(blockIdx.x / per_rb);  // the last row blocks first
  const int h = (int)(blockIdx.x % per_rb) % a.KV, b = (int)(blockIdx.x % per_rb) / a.KV;
  const int r0 = rb * AP_ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp % AP_RG, kh = warp / AP_RG;  // row group, key part of a tile
  const int g = lane >> 2, t4 = lane & 3;
  const int len = a.lengths[b];
  const int t_min = r0 / group, t_max = (min(r0 + AP_ROWS, R) - 1) / group;
  const bool ring = EXT && !KIVI && a.kpos != nullptr;  // positions scattered: walk every column
  // KIVI: the frontier F (packed keys below it) and the tail's 2G columns
  const int F = KIVI ? min(max(a.new_lengths[b], 0), S) / a.G * a.G : 0;
  const int TC = KIVI ? 2 * a.G : 0;
  const int f_mod = KIVI ? F % TC : 0;  // 0 or G
  const int n_keys = ring ? S : max(0, min(KIVI ? F : S, len + t_max + 1));
  const bool windowed = VAR > 0 && a.window > 0;
  // first tile holding a key inside the block's first row's window; with
  // sinks, the tiles holding columns < c_sink come first
  const bool skip = windowed && !ring;
  const int c_start = skip ? (max(len + t_min - a.window + 1, 0) / KT) * KT : 0;
  const int sinks = EXT ? a.sinks : 0;  // StreamingLLM sinks (read with a window only)
  const int c_sink = EXT && skip ? min(sinks, n_keys) : 0;
  const float inv_cap = VAR > 0 && a.softcap > 0.0f ? 1.0f / a.softcap : 0.0f;
  auto next_tile = [&](int c0) {
    return EXT ? max(c0 + KT, c0 + KT < c_sink ? 0 : c_start) : c0 + KT;
  };

  const size_t bh = (size_t)b * a.KV + h;
  const int8_t* kb = a.kq + bh * (size_t)(KIVI ? S / 2 : S) * DH;
  const int8_t* vb = a.vq + bh * (size_t)(V4 ? S / 2 : S) * DH;
  const float* ksb = KIVI ? nullptr : a.ks + bh * S;
  const float* vsb = a.vs + bh * S;  // [2, S/2] or [S]: S floats either way
  const float* chb = KIVI ? a.kchs + bh * (size_t)(S / a.G) * DH : nullptr;
  const int8_t* ktb = KIVI ? a.ktail + bh * (size_t)TC * DH : nullptr;
  const int8_t* vtb = KIVI ? a.vtail + bh * (size_t)TC * DH : nullptr;
  const float* ktsb = KIVI ? a.kts + bh * TC : nullptr;
  const float* vtsb = KIVI ? a.vts + bh * TC : nullptr;

  // this thread's rows: g and g + 8 of its row group's 16
  const int wr = r0 + rg * 16;
  const bool warp_live = wr < R;
  int hi[2], lo[2];  // the row's visible columns of a contiguous cache: (lo, hi]
  int lim[2];        // the row's position p_t (-1: a dead row sees no key)
  float slope[2], m[2], l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wr + g + 8 * i;
    const bool live = r < R;
    lim[i] = live ? len + r / group : -1;
    hi[i] = min(lim[i], n_keys - 1);
    lo[i] = windowed ? lim[i] - a.window : -1;
    slope[i] = EXT && a.alibi != nullptr && live ? a.alibi[h * group + r % group] : 0.0f;
    // a learned sink: denominator mass without a value, in key part 0's lane
    // t4 = 0 (the parts and the quad's partials are summed at the end)
    const bool has_sink = VAR > 0 && a.sink != nullptr && live && kh == 0;
    m[i] = has_sink ? a.sink[h * group + r % group] : AP_NEG_INF;
    l[i] = has_sink && t4 == 0 ? 1.0f : 0.0f;
  }
  float o[DB][4];
#pragma unroll
  for (int dn = 0; dn < DB; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.0f;
  // the columns the warp's rows can see: up to its last live row's horizon,
  // from its first row's window (sinks aside)
  const int w_hi = warp_live ? len + (min(wr + 16, R) - 1) / group : -1;
  const int w_lo = windowed ? len + wr / group - a.window + 1 : 0;

  auto load_tile = [&](int slot, int c0) {
    unsigned char* st = raw + slot * Gm::STAGE;
    const int keys = min(KT, n_keys - c0);  // keys of the tile inside the walk
    const int8_t* ksrc = kb + (size_t)c0 * DH;
    const int8_t* vsrc = vb + (size_t)(V4 ? c0 / 2 : c0) * DH;
    for (int u = threadIdx.x; u < KT * DH / 16; u += AP_THREADS) {
      const bool p = u / (DH / 16) < keys;
      pq_cp_async16(st + 16 * u, p ? ksrc + 16 * u : kb, p);
      if constexpr (!V4) pq_cp_async16(st + Gm::OFF_V + 16 * u, p ? vsrc + 16 * u : vb, p);
    }
    if constexpr (V4) {  // packed row pr holds tokens c0 + 2 pr and c0 + 2 pr + 1
      for (int u = threadIdx.x; u < (KT / 2) * DH / 16; u += AP_THREADS) {
        const bool p = 2 * (u / (DH / 16)) < keys;
        pq_cp_async16(st + Gm::OFF_V + 16 * u, p ? vsrc + 16 * u : vb, p);
      }
    }
    for (int j = threadIdx.x; j < KT; j += AP_THREADS) {
      const bool p = j < keys;
      pq_cp_async4(st + Gm::OFF_KS + 4 * j, p ? ksb + c0 + j : ksb, p);
      // K8V4: token c0 + j's scale in the plane of its parity (c0 is even)
      const float* vsj = V4 ? vsb + (j & 1) * (S / 2) + (c0 + j) / 2 : vsb + c0 + j;
      pq_cp_async4(st + Gm::OFF_VS + 4 * j, p ? vsj : vsb, p);
      if constexpr (EXT) {
        if (ring) {
          int* pos = reinterpret_cast<int*>(st + Gm::OFF_POS) + j;
          if (p)
            pq_cp_async4(pos, a.kpos + (size_t)b * S + c0 + j, true);
          else
            *pos = -1;  // past the ring's columns
        }
      }
    }
  };

  auto convert = [&](const unsigned char* st) {
    for (int u = threadIdx.x; u < KT * DH / 8; u += AP_THREADS) {
      const int key = u / (DH / 8), d = (u % (DH / 8)) * 8;
      *reinterpret_cast<uint4*>(Kb + key * STR + d) =
          ap_i8x8(*reinterpret_cast<const uint2*>(st + 8 * u));
      if constexpr (!V4)
        *reinterpret_cast<uint4*>(Vb + key * STR + d) =
            ap_i8x8(*reinterpret_cast<const uint2*>(st + Gm::OFF_V + 8 * u));
    }
    if constexpr (V4) {
      for (int u = threadIdx.x; u < (KT / 2) * DH / 8; u += AP_THREADS) {
        const int pr = u / (DH / 8), d = (u % (DH / 8)) * 8;
        uint4 lo4, hi4;
        ap_nib8(*reinterpret_cast<const uint2*>(st + Gm::OFF_V + 8 * u), lo4, hi4);
        *reinterpret_cast<uint4*>(Vb + (2 * pr) * STR + d) = lo4;
        *reinterpret_cast<uint4*>(Vb + (2 * pr + 1) * STR + d) = hi4;
      }
    }
  };

  // KIVI: a tail tile holds the int8 rows of tail columns [c0, c0 + KT), K
  // and V with their per-token scales; a packed tile the packed K rows of
  // keys [c0, c0 + KT), the chunk-scale rows they span when at most SR (a
  // chunk G below 8 reads them from global memory at the conversion), the V
  // rows (Int4: packed) and the V scales.
  auto scale_rows = [&](int c0, int keys, int& ch0) {
    ch0 = c0 / a.G;
    return (c0 + keys - 1) / a.G - ch0 + 1;
  };
  auto load_kivi = [&](int slot, bool tail, int c0) {
    unsigned char* st = raw + slot * Gm::STAGE;
    if (tail) {
      const int keys = min(KT, TC - c0);
      for (int u = threadIdx.x; u < KT * DH / 16; u += AP_THREADS) {
        const bool p = u / (DH / 16) < keys;
        pq_cp_async16(st + 16 * u, p ? ktb + (size_t)c0 * DH + 16 * u : ktb, p);
        pq_cp_async16(st + Gm::OFF_V + 16 * u, p ? vtb + (size_t)c0 * DH + 16 * u : vtb, p);
      }
      for (int j = threadIdx.x; j < KT; j += AP_THREADS) {
        const bool p = j < keys;
        pq_cp_async4(st + Gm::OFF_KS + 4 * j, p ? ktsb + c0 + j : ktsb, p);
        pq_cp_async4(st + Gm::OFF_VS + 4 * j, p ? vtsb + c0 + j : vtsb, p);
      }
      return;
    }
    const int keys = min(KT, n_keys - c0);
    const int8_t* ksrc = kb + (size_t)(c0 / 2) * DH;
    const int8_t* vsrc = vb + (size_t)(V4 ? c0 / 2 : c0) * DH;
    for (int u = threadIdx.x; u < (KT / 2) * DH / 16; u += AP_THREADS) {
      const bool p = 2 * (u / (DH / 16)) < keys;  // packed row: tokens c0 + 2 pr, + 1
      pq_cp_async16(st + 16 * u, p ? ksrc + 16 * u : kb, p);
      if constexpr (V4) pq_cp_async16(st + Gm::OFF_V + 16 * u, p ? vsrc + 16 * u : vb, p);
    }
    if constexpr (!V4) {
      for (int u = threadIdx.x; u < KT * DH / 16; u += AP_THREADS) {
        const bool p = u / (DH / 16) < keys;
        pq_cp_async16(st + Gm::OFF_V + 16 * u, p ? vsrc + 16 * u : vb, p);
      }
    }
    int ch0;
    const int n_sr = scale_rows(c0, keys, ch0);
    if (n_sr <= Gm::SR) {
      const float* src = chb + (size_t)ch0 * DH;
      for (int u = threadIdx.x; u < n_sr * DH / 4; u += AP_THREADS)
        pq_cp_async16(st + Gm::OFF_SC + 16 * u, src + 4 * u, true);
    }
    for (int j = threadIdx.x; j < KT; j += AP_THREADS) {
      const bool p = j < keys;
      const float* vsj = V4 ? vsb + (j & 1) * (S / 2) + (c0 + j) / 2 : vsb + c0 + j;
      pq_cp_async4(st + Gm::OFF_VS + 4 * j, p ? vsj : vsb, p);
    }
  };

  auto convert_kivi = [&](const unsigned char* st, bool tail, int c0) {
    if (tail) {  // int8 K (one exact term) and V
      for (int u = threadIdx.x; u < KT * DH / 8; u += AP_THREADS) {
        const int key = u / (DH / 8), d = (u % (DH / 8)) * 8;
        *reinterpret_cast<uint4*>(Kb + key * STR + d) =
            ap_i8x8(*reinterpret_cast<const uint2*>(st + 8 * u));
        *reinterpret_cast<uint4*>(Vb + key * STR + d) =
            ap_i8x8(*reinterpret_cast<const uint2*>(st + Gm::OFF_V + 8 * u));
      }
      return;
    }
    const int keys = min(KT, n_keys - c0);
    int ch0;
    const bool staged = scale_rows(c0, keys, ch0) <= Gm::SR;
    const float* scs = reinterpret_cast<const float*>(st + Gm::OFF_SC);
    for (int u = threadIdx.x; u < (KT / 2) * DH / 8; u += AP_THREADS) {
      const int pr = u / (DH / 8), d = (u % (DH / 8)) * 8;
      uint4 klo[NK], khi[NK];
      if (2 * pr < keys) {
        const int ch = (c0 + 2 * pr) / a.G;  // both tokens' chunk (G is even)
        const float* srow = staged ? scs + (ch - ch0) * DH + d : chb + (size_t)ch * DH + d;
        const float4 s0 = *reinterpret_cast<const float4*>(srow);
        const float4 s1 = *reinterpret_cast<const float4*>(srow + 4);
        const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
        ap_kivi8<NK>(*reinterpret_cast<const uint2*>(st + 8 * u), sc, klo, khi);
      } else {
#pragma unroll
        for (int t = 0; t < NK; ++t) klo[t] = khi[t] = make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int t = 0; t < NK; ++t) {
        *reinterpret_cast<uint4*>(Kb + (t * KT + 2 * pr) * STR + d) = klo[t];
        *reinterpret_cast<uint4*>(Kb + (t * KT + 2 * pr + 1) * STR + d) = khi[t];
      }
    }
    if constexpr (V4) {
      for (int u = threadIdx.x; u < (KT / 2) * DH / 8; u += AP_THREADS) {
        const int pr = u / (DH / 8), d = (u % (DH / 8)) * 8;
        uint4 lo4, hi4;
        ap_nib8(*reinterpret_cast<const uint2*>(st + Gm::OFF_V + 8 * u), lo4, hi4);
        *reinterpret_cast<uint4*>(Vb + (2 * pr) * STR + d) = lo4;
        *reinterpret_cast<uint4*>(Vb + (2 * pr + 1) * STR + d) = hi4;
      }
    } else {
      for (int u = threadIdx.x; u < KT * DH / 8; u += AP_THREADS) {
        const int key = u / (DH / 8), d = (u % (DH / 8)) * 8;
        *reinterpret_cast<uint4*>(Vb + key * STR + d) =
            ap_i8x8(*reinterpret_cast<const uint2*>(st + Gm::OFF_V + 8 * u));
      }
    }
  };

  // fragment addresses: Q and K by ldmatrix, V by ldmatrix.trans; the warp
  // takes the keys [kh KW, (kh + 1) KW) of each tile
  const __nv_bfloat16* qrow = Qs + (rg * 16 + (lane & 15)) * STR + (lane >> 4) * 8;
  const __nv_bfloat16* krow = Kb + (kh * KW + (lane & 7)) * STR + (lane >> 3) * 8;
  const __nv_bfloat16* vrow =
      Vb + (kh * KW + (lane & 7) + ((lane >> 3) & 1) * 8) * STR + (lane >> 4) * 8;

  const int c_first = c_sink > 0 ? 0 : c_start;
  // the walk as virtual columns v in [c_first, v_end): the tiles of the
  // cache, then (KIVI) the tail's from pk_end, tail column v - pk_end
  const int pk_end = KIVI ? c_first + max(0, n_keys - c_first + KT - 1) / KT * KT : n_keys;
  const bool tail_live = KIVI && F < S && len + t_max >= F;
  const int v_end = pk_end + (tail_live ? (TC + KT - 1) / KT * KT : 0);
  auto load = [&](int slot, int v) {
    if constexpr (KIVI)
      load_kivi(slot, v >= pk_end, v >= pk_end ? v - pk_end : v);
    else
      load_tile(slot, v);
  };
  int c_load = c_first;
#pragma unroll 1
  for (int s = 0; s < NS - 1; ++s) {
    if (c_load < v_end) {
      load(s, c_load);
      c_load = next_tile(c_load);
    }
    pq_cp_async_commit();
  }
  // Q rows r0 .. r0 + 63 as NQ bf16 terms, while the first tiles are in
  // flight; rows past R are 0
  const QT* q = static_cast<const QT*>(a.q);
  for (int u = threadIdx.x; u < AP_ROWS * (DH / 8); u += AP_THREADS) {
    const int r = u / (DH / 8), d = (u % (DH / 8)) * 8, gr = r0 + r;
    const QT* src = gr < R ? q + (((size_t)b * a.T + gr / group) * a.H + h * group +
                                  gr % group) * DH + d
                           : nullptr;
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      uint32_t w[NQ];
      ap_terms<NQ>(src ? pq_to_float(src[e]) : 0.0f, src ? pq_to_float(src[e + 1]) : 0.0f, w);
#pragma unroll
      for (int i = 0; i < NQ; ++i)
        *reinterpret_cast<uint32_t*>(Qs + (i * AP_ROWS + r) * STR + d + e) = w[i];
    }
  }

  int it = 0;
#pragma unroll 1
  for (int v = c_first; v < v_end; v = next_tile(v), ++it) {
    pq_cp_async_wait<NS - 2>();  // this thread's copies of tile it have landed
    __syncthreads();    // everyone's have; tile it - 1 is consumed
    if (c_load < v_end) {
      load((it + NS - 1) % NS, c_load);
      c_load = next_tile(c_load);
    }
    pq_cp_async_commit();
    const bool tail = KIVI && v >= pk_end;  // block-uniform
    const int c0 = tail ? v - pk_end : v;
    const unsigned char* st = raw + (it % NS) * Gm::STAGE;
    if (ring) {  // a ring's tile that no row of the block reaches is not even converted
      bool any = false;
      for (int j = threadIdx.x; j < KT; j += AP_THREADS) {
        const int p = reinterpret_cast<const int*>(st + Gm::OFF_POS)[j];
        any |= p >= 0 && p <= len + t_max &&
               (!windowed || p > len + t_min - a.window || p < a.sinks);
      }
      if (!__syncthreads_or(any)) continue;
    }
    if constexpr (KIVI)
      convert_kivi(st, tail, c0);
    else
      convert(st);
    __syncthreads();
    const int cw = c0 + kh * KW;  // the warp's first column
    const float* kss = reinterpret_cast<const float*>(st + Gm::OFF_KS) + kh * KW;
    const float* vss = reinterpret_cast<const float*>(st + Gm::OFF_VS) + kh * KW;
    const int* poss = reinterpret_cast<const int*>(st + Gm::OFF_POS) + kh * KW;
    if (tail) {  // a tail part: is any of its columns' positions inside the warp's rows' reach?
      bool any = false;
      for (int j = lane; j < KW; j += 32) {
        const int c = cw + j, p = F - f_mod + c + (c < f_mod ? TC : 0);
        any |= c < TC && p < S && p <= w_hi && (!windowed || p >= w_lo);
      }
      if (!warp_live || !__any_sync(0xffffffffu, any)) continue;
    } else if (ring) {  // a ring's part: is any of its positions inside the warp's rows' reach?
      bool any = false;
      for (int j = lane; j < KW; j += 32) {
        const int p = poss[j];
        any |= p >= 0 && p <= w_hi && (!windowed || p >= w_lo || p < a.sinks);
      }
      if (!warp_live || !__any_sync(0xffffffffu, any)) continue;
    } else if (!warp_live || cw > w_hi || (KIVI && cw >= n_keys) ||
               !(cw + KW > w_lo || (EXT && cw < a.sinks))) {
      continue;  // every element of the warp's rows is masked
    }

    float sc[NB][4];
#pragma unroll
    for (int jn = 0; jn < NB; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[jn][e] = 0.0f;
#pragma unroll
    for (int kd = 0; kd < DH / 32; ++kd) {  // 32 dims: two k16 steps
      // every fragment of the step first, then NB independent mma chains
      uint32_t qa[NQ][2][4];
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        ap_ldsm4(qa[i][0], qrow + i * AP_ROWS * STR + 32 * kd);
        ap_ldsm4(qa[i][1], qrow + i * AP_ROWS * STR + 32 * kd + 16);
      }
#pragma unroll
      for (int kt = 0; kt < NK; ++kt) {  // every q term meets every K term
        if (kt > 0 && tail) break;       // a tail tile's int8 K: one exact term
        uint32_t kf[NB][4];
#pragma unroll
        for (int jn = 0; jn < NB; ++jn)
          ap_ldsm4(kf[jn], krow + (kt * KT + jn * 8) * STR + 32 * kd);
#pragma unroll
        for (int k = 0; k < 2; ++k)
#pragma unroll
          for (int i = 0; i < NQ; ++i)
#pragma unroll
            for (int jn = 0; jn < NB; ++jn)
              ap_mma(sc[jn], qa[i][k], kf[jn][2 * k], kf[jn][2 * k + 1]);
      }
    }

    // element (jn, e) is row g + 8 (e >> 1), column cw + 8 jn + 2 t4 + (e & 1);
    // the per-column values first: scale, and at VAR = 2 the position
    float cs[NB][2];
    int cp[NB][2];
#pragma unroll
    for (int jn = 0; jn < NB; ++jn)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int j = 8 * jn + 2 * t4 + x, c = cw + j;
        if (tail) {  // tail column c: its one position in [F, F + 2G), if below S
          const int p = F - f_mod + c + (c < f_mod ? TC : 0);
          cs[jn][x] = kss[j] * a.sm;
          cp[jn][x] = c < TC && p < S ? p : -1;
        } else {  // a KIVI packed key's scale is in its K already
          cs[jn][x] = KIVI ? a.sm : kss[j] * a.sm;
          cp[jn][x] = !EXT ? c : ring ? poss[j] : (c < n_keys ? c : -1);
        }
      }
#pragma unroll
    for (int jn = 0; jn < NB; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[jn][e] *= cs[jn][e & 1];
    if (VAR > 0 && a.softcap > 0.0f) {  // one uniform branch: no tanh issued uncapped
#pragma unroll
      for (int jn = 0; jn < NB; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[jn][e] = a.softcap * tanhf(sc[jn][e] * inv_cap);
    }
    bool vld[NB][4];
    float mx[2] = {AP_NEG_INF, AP_NEG_INF};
#pragma unroll
    for (int jn = 0; jn < NB; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, pos = cp[jn][e & 1];
        float v = sc[jn][e];
        // bitwise, not short-circuit: no branch per element (lo = -1 without
        // a window, so that pos > lo holds for every written position)
        const bool ok = tail  ? (pos >= 0) & (pos <= lim[i]) & (pos > lo[i])
                        : EXT ? (pos >= 0) & (pos <= lim[i]) & ((pos > lo[i]) | (pos < sinks))
                              : (pos <= hi[i]) & (pos > lo[i]);
        if constexpr (EXT) v -= slope[i] * (float)(lim[i] - pos);  // slope 0 without ALiBi
        vld[jn][e] = ok;
        sc[jn][e] = ok ? v : AP_NEG_INF;
        mx[i] = fmaxf(mx[i], sc[jn][e]);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = __expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr[i];
    }
    // O scaled only where some row's max moved (a factor of 1 changes nothing)
    if (__any_sync(0xffffffffu, corr[0] != 1.0f || corr[1] != 1.0f)) {
#pragma unroll
      for (int dn = 0; dn < DB; ++dn) {
        o[dn][0] *= corr[0];
        o[dn][1] *= corr[0];
        o[dn][2] *= corr[1];
        o[dn][3] *= corr[1];
      }
    }
#pragma unroll
    for (int jn = 0; jn < NB; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 8 * jn + 2 * t4 + (e & 1), i = e >> 1;
        const float p = vld[jn][e] ? __expf(sc[jn][e] - m[i]) : 0.0f;
        l[i] += p;
        sc[jn][e] = vld[jn][e] ? p * vss[j] : 0.0f;  // p * vs: the A operand of P V
      }

#pragma unroll
    for (int kc = 0; kc < KW / 16; ++kc) {  // 16 keys: n8 blocks 2 kc and 2 kc + 1
      uint32_t pa[NP][4];
#pragma unroll
      for (int f = 0; f < 4; ++f) {  // a0..a3: (row g | g + 8) x (keys 2 t4 | + 8)
        const float* src = sc[2 * kc + (f >> 1)] + 2 * (f & 1);
        uint32_t w[NP];
        ap_terms<NP>(src[0], src[1], w);
#pragma unroll
        for (int i = 0; i < NP; ++i) pa[i][f] = w[i];
      }
      // V fragments for up to 128 dims first, then independent mma chains
#pragma unroll
      for (int d0 = 0; d0 < DB; d0 += VG) {
        uint32_t vf[VG / 2][4];
#pragma unroll
        for (int v = 0; v < VG / 2; ++v) ap_ldsm4t(vf[v], vrow + kc * 16 * STR + (d0 + 2 * v) * 8);
#pragma unroll
        for (int i = 0; i < NP; ++i)
#pragma unroll
          for (int v = 0; v < VG / 2; ++v) {
            ap_mma(o[d0 + 2 * v], pa[i], vf[v][0], vf[v][1]);
            ap_mma(o[d0 + 2 * v + 1], pa[i], vf[v][2], vf[v][3]);
          }
      }
    }
  }
  pq_cp_async_wait<0>();

  // the key parts of a row group meet in shared memory, lane by lane (the
  // same rows and dims), in part order: m = max, l and O scaled to it
  __syncthreads();  // every warp is done with the tiles
  float* mrg = reinterpret_cast<float*>(smem);  // [DB * 4 + 4][AP_RG][32]
  auto slot = [&](int f) -> float& { return mrg[(f * AP_RG + rg) * 32 + lane]; };
  for (int part = 1; part < AP_KS; ++part) {
    if (kh == part) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        slot(DB * 4 + i) = m[i];
        slot(DB * 4 + 2 + i) = l[i];
      }
#pragma unroll
      for (int dn = 0; dn < DB; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e) slot(dn * 4 + e) = o[dn][e];
    }
    __syncthreads();
    if (kh == 0) {
      float f0[2], f1[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m1 = slot(DB * 4 + i), m_new = fmaxf(m[i], m1);
        f0[i] = __expf(m[i] - m_new);
        f1[i] = __expf(m1 - m_new);
        m[i] = m_new;
        l[i] = l[i] * f0[i] + slot(DB * 4 + 2 + i) * f1[i];
      }
#pragma unroll
      for (int dn = 0; dn < DB; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[dn][e] = o[dn][e] * f0[e >> 1] + slot(dn * 4 + e) * f1[e >> 1];
    }
    __syncthreads();
  }

  if (!warp_live || kh != 0) return;
  QT* out = static_cast<QT*>(a.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = wr + g + 8 * i;
    if (r >= R) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    QT* orow = out + (((size_t)b * a.T + r / group) * a.H + h * group + r % group) * DH + 2 * t4;
#pragma unroll
    for (int dn = 0; dn < DB; ++dn)
      ap_store2(orow + 8 * dn, o[dn][2 * i] / denom, o[dn][2 * i + 1] / denom);
  }
}

template <int DH, bool V4, int VAR, typename QT, bool KIVI>
static cudaError_t ap_launch(const AttnPrefillArgs& a, cudaStream_t st) {
  using Gm = ApGeom<DH, V4, VAR, QT, KIVI>;
  auto kernel = attn_prefill_kernel<DH, V4, VAR, QT, KIVI>;
  static bool configured = false;
  cudaError_t err = pq_allow_smem(kernel, Gm::SMEM, configured);
  if (err != cudaSuccess) return err;
  const long long rows = (long long)a.T * (a.H / a.KV);
  const long long blocks = (rows + AP_ROWS - 1) / AP_ROWS * a.KV * a.B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, AP_THREADS, Gm::SMEM, st>>>(a);
  return cudaGetLastError();
}

template <bool V4, int VAR, typename QT, bool KIVI>
static cudaError_t ap_dh(const AttnPrefillArgs& a, cudaStream_t st) {
  switch (a.Dh) {
    case 32: return ap_launch<32, V4, VAR, QT, KIVI>(a, st);
    case 64: return ap_launch<64, V4, VAR, QT, KIVI>(a, st);
    case 128: return ap_launch<128, V4, VAR, QT, KIVI>(a, st);
    case 256: return ap_launch<256, V4, VAR, QT, KIVI>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

// The prefill kernel of one instance family for every head dim and q dtype.
template <bool V4, int VAR, bool KIVI = false>
static cudaError_t ap_dispatch(const AttnPrefillArgs& a, cudaStream_t st) {
  switch (a.q_dtype) {
    case PQ_F32: return ap_dh<V4, VAR, float, KIVI>(a, st);
    case PQ_BF16: return ap_dh<V4, VAR, __nv_bfloat16, KIVI>(a, st);
    case PQ_F16: return ap_dh<V4, VAR, __half, KIVI>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

// A KIVI tier's instances: the least VAR its call's variants need.
template <bool V4>
static cudaError_t ap_kivi_dispatch(const AttnPrefillArgs& a, cudaStream_t st) {
  if (a.alibi != nullptr) return ap_dispatch<V4, 2, true>(a, st);
  if (a.window > 0 || a.softcap > 0.0f || a.sink != nullptr) return ap_dispatch<V4, 1, true>(a, st);
  return ap_dispatch<V4, 0, true>(a, st);
}

// The instance families, one nvcc each: attn_prefill_int8.cu (VAR 0),
// attn_prefill_var.cu (VAR 1), attn_prefill_ext.cu (VAR 2),
// attn_prefill_k8v4.cu (packed V, VAR 0), attn_prefill_kivi_k4v8.cu and
// attn_prefill_kivi_int4.cu (the KIVI tiers, VAR 0 to 2).
cudaError_t attn_prefill_int8(const AttnPrefillArgs& a, cudaStream_t st);
cudaError_t attn_prefill_var(const AttnPrefillArgs& a, cudaStream_t st);
cudaError_t attn_prefill_ext(const AttnPrefillArgs& a, cudaStream_t st);
cudaError_t attn_prefill_k8v4(const AttnPrefillArgs& a, cudaStream_t st);
cudaError_t attn_prefill_kivi_k4v8(const AttnPrefillArgs& a, cudaStream_t st);
cudaError_t attn_prefill_kivi_int4(const AttnPrefillArgs& a, cudaStream_t st);
