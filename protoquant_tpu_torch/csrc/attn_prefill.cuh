// Flash-attention prefill over the dense int8 KV cache and the mixed K8V4
// cache on the H100's bf16 tensor cores: every int8_kv_attention and
// mixed_kv_attention call that the split-S decode (attn_split.cuh, as_plan)
// does not take, i.e. every prefill chunk: dense, ring, and the paged
// cache's gathered window.
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
//   m = sink, l = 1, acc = 0 (the TPU kernel's initial state).
// V4 (K8V4): vq [B, KV, S/2, Dh] holds token pairs (row r: token 2r in the
// low nibble, 2r + 1 in the high one), vs [B, KV, 2, S/2] their scales
// (plane 0 even tokens, plane 1 odd).
//
// Numerics: the TPU kernel's lanes (_attend runs it with lane = bf16):
// q . k and (p * vs) . v on bf16 operands into f32 sums, but with q and
// p * vs each split into bf16 terms, one product per term. An int8 value
// is exact in bf16 and a bf16 q times it exact in f32, so for bf16 q (the
// engine's) one term of q loses nothing; f16 q takes 2 (exact), f32 q 3
// (within 2^-25). p * vs takes 2 terms (within 2^-17; f32 q: 3): with the
// TPU's single bf16 term the outputs moved by a bf16 ulp against the plain
// version's often enough that the 2-layer bf16 agreements of chip_smoke.py
// (phases 5, 9, 11) moved from rel L2 0.002-0.013 to 0.026-0.030, at their
// 0.03 limit, where the int8 activation codes turn each ulp into a code
// step. ops/attention.py:dense_attention_tiles_ref spells this
// decomposition out in plain PyTorch.
//
// Bound on the H100: at prefill the operations, 4 Dh per visible (row, key)
// at the dense bf16 peak; short chunks over long caches the bytes of the
// keys inside the rows' windows. What holds it back is neither: the
// tile's int8 -> bf16 conversion, the softmax on the fragments and the
// three terms of p * vs take more instructions than the products, and a
// warp issues them one after another (PERF.md).
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
//   one of them. A warp skips the products of its part of a tile wholly
//   outside its own rows (past its last row's horizon, or below its first
//   row's window and the sinks; a ring's: none of its positions there):
//   every element would be masked.
// - Staging: the raw int8 K and V rows (K8V4: the packed byte rows) move by
//   16-byte cp.async (zero-filled past the walk's end), the scales and a
//   ring's positions by 4-byte copies, into a ring of NS stages: tile
//   i + NS - 1 is in flight while tile i is converted and consumed. Each
//   tile is converted once, by the whole block, into bf16 K and V in shared
//   memory (exactly: through 2^23 + x; K8V4's nibbles unpacked there, the
//   low one token 2r, the high one 2r + 1), in rows of Dh + 8 so that the
//   8 rows an ldmatrix phase reads fall in 32 distinct banks.
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
// the ring's positions, the StreamingLLM sinks and ALiBi, and a call takes
// the least instance its variants need; VAR = 0 (full causal) and K8V4
// compile them all out.

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
// bf16 K and V tiles ([KT][STR]), then NS raw stages, each the tile's int8 K
// rows, V rows (K8V4: KT / 2 packed rows), K scales, V scales and, at VAR =
// 2, positions. NS = 3 where two blocks an SM still fit, else 2.
template <int DH, bool V4, int VAR, typename QT>
struct ApGeom {
  static constexpr int NQ = ApTerms<QT>::Q, NP = ApTerms<QT>::P;
  static constexpr int KT = DH == 128 ? 128 : DH == 256 ? 32 : 64;  // keys of a tile
  static constexpr int STR = DH + 8;              // padded bf16 row
  static constexpr int OFF_V = KT * DH;
  static constexpr int OFF_KS = OFF_V + (V4 ? KT / 2 : KT) * DH;
  static constexpr int OFF_VS = OFF_KS + 4 * KT;
  static constexpr int OFF_POS = OFF_VS + 4 * KT;
  static constexpr int STAGE = OFF_POS + (VAR == 2 ? 4 * KT : 0);
  static constexpr int QBYTES = NQ * AP_ROWS * STR * 2;
  static constexpr int TILES = 2 * KT * STR * 2;
  static constexpr int NS = NQ > 1 || QBYTES + TILES + 3 * STAGE <= 113 * 1024 ? 3 : 2;
  static constexpr int SMEM = QBYTES + TILES + NS * STAGE;
  static_assert(DH % 32 == 0 && STAGE % 16 == 0, "16-byte copies and k16 fragments");
  static_assert(KT % (16 * AP_KS) == 0, "a warp takes whole k16 steps of a tile");
  static_assert(SMEM >= (DH / 2 + 4) * 4 * AP_RG * 32, "the parts' merge reuses the tiles");
};

__device__ __forceinline__ void ap_cp16(void* dst, const void* src, bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void ap_cp4(void* dst, const void* src, bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 4 : 0)
               : "memory");
}

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

__device__ __forceinline__ void ap_store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void ap_store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void ap_store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

template <int DH, bool V4, int VAR, typename QT>
__global__ void __launch_bounds__(AP_THREADS) attn_prefill_kernel(const AttnPrefillArgs a) {
  using Gm = ApGeom<DH, V4, VAR, QT>;
  constexpr int NQ = Gm::NQ, NP = Gm::NP, KT = Gm::KT, STR = Gm::STR, NS = Gm::NS;
  constexpr int KW = KT / AP_KS;  // keys of a tile a warp takes
  constexpr int NB = KW / 8;      // their n8 blocks
  constexpr int DB = DH / 8;      // n8 blocks of the head dims
  constexpr int VG = DH == 256 ? 8 : DB;  // n8 blocks of V whose fragments load together
  constexpr bool EXT = VAR == 2;  // ring positions, StreamingLLM sinks, ALiBi
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [NQ][AP_ROWS][STR]
  __nv_bfloat16* Kb = Qs + NQ * AP_ROWS * STR;                 // [KT][STR]
  __nv_bfloat16* Vb = Kb + KT * STR;                           // [KT][STR]
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
  const bool ring = EXT && a.kpos != nullptr;  // positions scattered: walk every column
  const int n_keys = ring ? S : max(0, min(S, len + t_max + 1));
  const bool windowed = VAR > 0 && a.window > 0;
  // first tile holding a key inside the block's first row's window; with
  // sinks, the tiles holding columns < c_sink come first
  const bool skip = windowed && !ring;
  const int c_start = skip ? (max(len + t_min - a.window + 1, 0) / KT) * KT : 0;
  const int c_sink = EXT && skip ? min(a.sinks, n_keys) : 0;
  const float inv_cap = VAR > 0 && a.softcap > 0.0f ? 1.0f / a.softcap : 0.0f;
  auto next_tile = [&](int c0) {
    return EXT ? max(c0 + KT, c0 + KT < c_sink ? 0 : c_start) : c0 + KT;
  };

  const size_t bh = (size_t)b * a.KV + h;
  const int8_t* kb = a.kq + bh * S * DH;
  const int8_t* vb = a.vq + bh * (size_t)(V4 ? S / 2 : S) * DH;
  const float* ksb = a.ks + bh * S;
  const float* vsb = a.vs + bh * S;  // [2, S/2] or [S]: S floats either way

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
      ap_cp16(st + 16 * u, p ? ksrc + 16 * u : kb, p);
      if constexpr (!V4) ap_cp16(st + Gm::OFF_V + 16 * u, p ? vsrc + 16 * u : vb, p);
    }
    if constexpr (V4) {  // packed row pr holds tokens c0 + 2 pr and c0 + 2 pr + 1
      for (int u = threadIdx.x; u < (KT / 2) * DH / 16; u += AP_THREADS) {
        const bool p = 2 * (u / (DH / 16)) < keys;
        ap_cp16(st + Gm::OFF_V + 16 * u, p ? vsrc + 16 * u : vb, p);
      }
    }
    for (int j = threadIdx.x; j < KT; j += AP_THREADS) {
      const bool p = j < keys;
      ap_cp4(st + Gm::OFF_KS + 4 * j, p ? ksb + c0 + j : ksb, p);
      // K8V4: token c0 + j's scale in the plane of its parity (c0 is even)
      const float* vsj = V4 ? vsb + (j & 1) * (S / 2) + (c0 + j) / 2 : vsb + c0 + j;
      ap_cp4(st + Gm::OFF_VS + 4 * j, p ? vsj : vsb, p);
      if constexpr (EXT) {
        if (ring) {
          int* pos = reinterpret_cast<int*>(st + Gm::OFF_POS) + j;
          if (p)
            ap_cp4(pos, a.kpos + (size_t)b * S + c0 + j, true);
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

  // fragment addresses: Q and K by ldmatrix, V by ldmatrix.trans; the warp
  // takes the keys [kh KW, (kh + 1) KW) of each tile
  const __nv_bfloat16* qrow = Qs + (rg * 16 + (lane & 15)) * STR + (lane >> 4) * 8;
  const __nv_bfloat16* krow = Kb + (kh * KW + (lane & 7)) * STR + (lane >> 3) * 8;
  const __nv_bfloat16* vrow =
      Vb + (kh * KW + (lane & 7) + ((lane >> 3) & 1) * 8) * STR + (lane >> 4) * 8;

  const int c_first = c_sink > 0 ? 0 : c_start;
  int c_load = c_first;
#pragma unroll 1
  for (int s = 0; s < NS - 1; ++s) {
    if (c_load < n_keys) {
      load_tile(s, c_load);
      c_load = next_tile(c_load);
    }
    sp_commit();
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
  for (int c0 = c_first; c0 < n_keys; c0 = next_tile(c0), ++it) {
    sp_wait<NS - 2>();  // this thread's copies of tile it have landed
    __syncthreads();    // everyone's have; tile it - 1 is consumed
    if (c_load < n_keys) {
      load_tile((it + NS - 1) % NS, c_load);
      c_load = next_tile(c_load);
    }
    sp_commit();
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
    convert(st);
    __syncthreads();
    const int cw = c0 + kh * KW;  // the warp's first column
    const float* kss = reinterpret_cast<const float*>(st + Gm::OFF_KS) + kh * KW;
    const float* vss = reinterpret_cast<const float*>(st + Gm::OFF_VS) + kh * KW;
    const int* poss = reinterpret_cast<const int*>(st + Gm::OFF_POS) + kh * KW;
    if (ring) {  // a ring's part: is any of its positions inside the warp's rows' reach?
      bool any = false;
      for (int j = lane; j < KW; j += 32) {
        const int p = poss[j];
        any |= p >= 0 && p <= w_hi && (!windowed || p >= w_lo || p < a.sinks);
      }
      if (!warp_live || !__any_sync(0xffffffffu, any)) continue;
    } else if (!warp_live || cw > w_hi || !(cw + KW > w_lo || (EXT && cw < a.sinks))) {
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
      uint32_t qa[NQ][2][4], kf[NB][4];
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        ap_ldsm4(qa[i][0], qrow + i * AP_ROWS * STR + 32 * kd);
        ap_ldsm4(qa[i][1], qrow + i * AP_ROWS * STR + 32 * kd + 16);
      }
#pragma unroll
      for (int jn = 0; jn < NB; ++jn) ap_ldsm4(kf[jn], krow + jn * 8 * STR + 32 * kd);
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int i = 0; i < NQ; ++i)
#pragma unroll
          for (int jn = 0; jn < NB; ++jn) ap_mma(sc[jn], qa[i][k], kf[jn][2 * k], kf[jn][2 * k + 1]);
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
        cs[jn][x] = kss[j] * a.sm;
        cp[jn][x] = !EXT ? c : ring ? poss[j] : (c < n_keys ? c : -1);
      }
    bool vld[NB][4];
    float mx[2] = {AP_NEG_INF, AP_NEG_INF};
#pragma unroll
    for (int jn = 0; jn < NB; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, pos = cp[jn][e & 1];
        float v = sc[jn][e] * cs[jn][e & 1];
        const bool ok = EXT ? pos >= 0 && pos <= lim[i] &&
                                  (!windowed || pos > lo[i] || pos < a.sinks)
                            : pos <= hi[i] && pos > lo[i];
        if (VAR > 0 && a.softcap > 0.0f) v = a.softcap * tanhf(v * inv_cap);
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
  sp_wait<0>();

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

template <int DH, bool V4, int VAR, typename QT>
static cudaError_t ap_launch(const AttnPrefillArgs& a, cudaStream_t st) {
  using Gm = ApGeom<DH, V4, VAR, QT>;
  auto kernel = attn_prefill_kernel<DH, V4, VAR, QT>;
  static bool configured = false;
  cudaError_t err = pq_allow_smem(kernel, Gm::SMEM, configured);
  if (err != cudaSuccess) return err;
  const long long rows = (long long)a.T * (a.H / a.KV);
  const long long blocks = (rows + AP_ROWS - 1) / AP_ROWS * a.KV * a.B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, AP_THREADS, Gm::SMEM, st>>>(a);
  return cudaGetLastError();
}

template <bool V4, int VAR, typename QT>
static cudaError_t ap_dh(const AttnPrefillArgs& a, cudaStream_t st) {
  switch (a.Dh) {
    case 32: return ap_launch<32, V4, VAR, QT>(a, st);
    case 64: return ap_launch<64, V4, VAR, QT>(a, st);
    case 128: return ap_launch<128, V4, VAR, QT>(a, st);
    case 256: return ap_launch<256, V4, VAR, QT>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

// The prefill kernel of one instance family for every head dim and q dtype.
template <bool V4, int VAR>
static cudaError_t ap_dispatch(const AttnPrefillArgs& a, cudaStream_t st) {
  switch (a.q_dtype) {
    case PQ_F32: return ap_dh<V4, VAR, float>(a, st);
    case PQ_BF16: return ap_dh<V4, VAR, __nv_bfloat16>(a, st);
    case PQ_F16: return ap_dh<V4, VAR, __half>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

// The instance families, one nvcc each: attn_prefill_int8.cu (VAR 0),
// attn_prefill_var.cu (VAR 1), attn_prefill_ext.cu (VAR 2),
// attn_prefill_k8v4.cu (packed V, VAR 0).
cudaError_t attn_prefill_int8(const AttnPrefillArgs& a, cudaStream_t st);
cudaError_t attn_prefill_var(const AttnPrefillArgs& a, cudaStream_t st);
cudaError_t attn_prefill_ext(const AttnPrefillArgs& a, cudaStream_t st);
cudaError_t attn_prefill_k8v4(const AttnPrefillArgs& a, cudaStream_t st);
