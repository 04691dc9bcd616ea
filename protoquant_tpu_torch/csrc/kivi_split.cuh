// Split-S decode attention over the KIVI caches (flash-decoding), the
// design that ops/attention.py routes every decode-sized call to; the
// prefill kernel of csrc/attn_prefill.cuh (KIVI) keeps the calls with many
// query rows (prefill). The contract is the one attn_prefill.cuh states for
// the KIVI caches, variant for variant (window, score scale, softcap, ALiBi,
// learned sinks; frontier and tail rule; K4V8's V tail mirror; Dh 32, 64,
// 128, 256; q in f32, bf16, f16).
//
// Bound on the H100: bytes, the visible part of the packed store (Dh / 2 per
// key for K, Dh (K4V8) or Dh / 2 (Int4) for V, plus scales), the live tail
// rows, q and out. At decode a one-pass kernel (one block on each (b, kv
// head), one warp of four busy, a synchronous load and two barriers per
// tile) is held back by latency, not bytes. A call takes this design, whatever its batch, when
// its rows fit one block, its G (>= 8) divides or is divided by the tile,
// and it needs at most SP_MAX_SPLITS splits: ks_plan decides, and
// pq_kivi_split_plan (kivi_combine.cu) tells the wrapper, which sizes the
// partials' workspace by it. This design:
// - Grid (n_split, KV, B). Split sp < n_split - 1 covers the packed keys
//   [sp span, (sp + 1) span) (span = lcm(KsGeom::SPAN, G), a multiple of
//   the tile and of G: 256 keys, 128 at Dh 128, which beat half and twice
//   that on an H100 at the 7B, Gemma-2 and GPT-OSS decodes; the grid is
//   sized from the capacity S, so nothing waits on the lengths that live
//   on the card); the last
//   split covers the tail: the positions
//   [max(F, first key in the window, len - 2G + 1), min(len + T, S)), each
//   read from tail row pos mod 2G. Enumerating positions is the tail rule
//   pos = horizon - ((horizon - col) mod 2G), valid iff F <= pos < S, read
//   the other way round: a position p of that range is row t's iff p <=
//   horizon and p > horizon - 2G, which each score tests.
// - A split whose range holds no key that a row sees (past the last row's
//   horizon or the frontier, or wholly below the first row's window) writes
//   an empty partial (m = -1e30, l = 0) and exits; the merge never reads
//   the acc of a split with l = 0.
// - Four warps split each tile's keys, not the rows: a lane owns one packed
//   row (tokens 2i and 2i + 1) of its warp's slice, or one tail row, and
//   Dh / LPR of its dims (LPR = Dh / 64 lanes share a row at Dh >= 128; their
//   sums meet by shuffles). It reads the row's packed bytes from shared
//   memory and forms each K element in registers as __fmul_rn(nib, kchs[p /
//   G][d]), the plain version's single f32 product (the nibble and int8
//   byte conversions go through 2^23 + x, exact), then the dot products of
//   both tokens with all R rows of the block. Each warp keeps its own
//   online softmax (m, l, acc) per row; p (times the V scale) goes to the
//   warp's shared row and the warp's lanes, one per Dh / 32 output dims,
//   walk the warp's keys for p . V. The block merges its warps' states in a
//   fixed order and writes the split's partial: acc (not normalised), m, l.
// - The raw bytes (packed K rows, V rows, the tile's chunk-channel K scale
//   rows, the V scales; in the tail split its K and V rows and scales) move
//   by 16-byte cp.async.cg (4-byte for the tail's scales) into a ring of two
//   stages, tile i + 1 in flight while tile i is consumed (a split of one
//   tile, as at Dh <= 128, overlaps its copies with the other resident
//   blocks' work). Only the rows that hold live keys are copied.
// - f32 on the CUDA cores: at decode M = group <= 8 rows a kv head; the work
//   is bytes.
// - split_merge (split_common.cuh, shared with the int8 and K8V4 split
//   decode of attn_split.cuh) merges each row's partials in split order: the
//   learned sink joins once, as the initial state m = sink, l = 1, acc = 0;
//   m = max m_i, l = sum l_i e^(m_i - m), out = sum acc_i e^(m_i - m) / l.
//   The partials live in a workspace the wrapper takes from PyTorch's
//   allocator ([B, KV, n_split, R, Dh] f32 and [B, KV, n_split, R] (m, l)).
//   No atomics: two calls on the same inputs give the same bits, and the
//   pair of launches can be captured in a CUDA graph.
// Rows per block R = T group is bounded by the register budget of the
// per-row state: at most 16 at Dh <= 64, 8 at 128, 4 at 256 (template RB,
// the least power of two >= R; rows past R are never computed). The
// window, the softcap and the ALiBi slopes are read only by the VAR >= 1
// (ALiBi: VAR = 2) instances; the learned sinks only by the merge.

#pragma once

#include <numeric>

#include "split_common.cuh"

struct KiviSplitArgs {
  const void* q;
  int q_dtype;
  const int8_t* kq;
  const float* kchs;
  const int8_t* vq;
  const float* vs;
  const int8_t* ktail;
  const float* kts;
  const int8_t* vtail;
  const float* vts;
  const int* lengths;
  const int* new_lengths;
  const float* alibi;
  const float* sink;
  void* out;
  float* part_acc;
  float2* part_ml;
  int B, T, H, KV, S, Dh, G;
  float sm;
  int window;
  float softcap;
  int span, n_split;
};

constexpr int KS_THREADS = 128;
constexpr int KS_WARPS = KS_THREADS / 32;
constexpr int KS_STAGES = 2;
constexpr int KS_MIN_G = 8;

// Tile geometry at head dim DH.
template <int DH>
struct KsGeom {
  static constexpr int LPR = DH >= 128 ? DH / 64 : 1;  // lanes sharing a packed row
  static constexpr int DK = DH / LPR;                  // dims of a lane's dot product
  static constexpr int PRW = 32 / LPR;                 // packed (or tail) rows a warp takes
  static constexpr int KW = 2 * PRW;                   // keys a warp takes of a packed tile
  static constexpr int KT = KS_WARPS * KW;             // keys of a packed tile
  static constexpr int PT = KT / 2;                    // packed rows of a tile; tail positions
  static constexpr int KSTR = DH + 16;                 // padded K row in shared memory, bytes
  static constexpr int DPL = DH / 32;                  // output dims of a lane in p . V
  static constexpr int MAX_RB = DH == 256 ? 4 : DH == 128 ? 8 : 16;
  static constexpr int SPAN = DH == 128 ? 128 : 256;  // packed keys of a split, before lcm G
};

// The split plan of a call at head dim DH with R query rows a kv head: the
// number of splits (the packed ones over the capacity S, and the tail's),
// with the span in *span; 0 where the prefill kernel takes the call.
template <int DH>
inline int ks_plan_dh(int R, int S, int G, int* span) {
  using Gm = KsGeom<DH>;
  if (R > Gm::MAX_RB || G < KS_MIN_G || (Gm::KT % G != 0 && G % Gm::KT != 0)) return 0;
  const int sp = std::lcm(Gm::SPAN, G);
  const int n = (S + sp - 1) / sp + 1;
  if (n > SP_MAX_SPLITS) return 0;
  *span = sp;
  return n;
}

inline int ks_plan(int T, int H, int KV, int S, int Dh, int G, int* span) {
  if (T <= 0 || KV <= 0 || H % KV != 0 || G < 2 || G % 2 || S % G) return 0;
  const int R = T * (H / KV);
  switch (Dh) {
    case 32: return ks_plan_dh<32>(R, S, G, span);
    case 64: return ks_plan_dh<64>(R, S, G, span);
    case 128: return ks_plan_dh<128>(R, S, G, span);
    case 256: return ks_plan_dh<256>(R, S, G, span);
    default: return 0;
  }
}

// Bytes of one stage: K rows, V rows, the tile's chunk-channel K scales, the
// V scales (the tail split puts kts and vts where the V scales go).
template <int DH, bool V4>
__host__ __device__ constexpr int ks_stage_bytes(int G) {
  using Gm = KsGeom<DH>;
  const int nch = Gm::KT / (G < Gm::KT ? G : Gm::KT);
  return Gm::PT * Gm::KSTR + (V4 ? Gm::PT : Gm::KT) * DH + nch * DH * 4 + Gm::KT * 4;
}

template <int DH, bool V4, int RB>
__host__ __device__ constexpr int ks_smem_bytes(int G) {
  using Gm = KsGeom<DH>;
  const int stages = KS_STAGES * ks_stage_bytes<DH, V4>(G);
  const int merge = KS_WARPS * RB * (DH + 2) * 4;  // reuses the stages after the walk
  return (stages > merge ? stages : merge) + 4 * (RB * DH + KS_WARPS * RB * Gm::KW);
}

template <int DH, bool V4, int VAR, int RB>
__global__ void __launch_bounds__(KS_THREADS) kivi_split_kernel(const KiviSplitArgs a) {
  using Gm = KsGeom<DH>;
  constexpr int PRW = Gm::PRW, KW = Gm::KW, KT = Gm::KT, PT = Gm::PT, KSTR = Gm::KSTR;
  constexpr int DK = Gm::DK, DPL = Gm::DPL;
  constexpr int VBYTES = (V4 ? PT : KT) * DH;
  extern __shared__ __align__(16) unsigned char smem[];

  const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = a.H / a.KV, R = a.T * group;
  const int S = a.S, G = a.G, TC = 2 * G, S2 = S / 2;
  const bool tail = sp == a.n_split - 1;
  const int len = a.lengths[b];
  const int frontier = (min(max(a.new_lengths[b], 0), S) / G) * G;
  const int top = len + a.T;  // one past the last row's horizon
  const bool windowed = VAR > 0 && a.window > 0;
  const int lo = windowed ? max(len - a.window + 1, 0) : 0;  // first key a row sees
  int k_lo, k_hi;  // the block's keys (packed) or positions (tail)
  if (!tail) {
    k_lo = max(sp * a.span, lo);
    k_hi = min(min((sp + 1) * a.span, S), min(frontier, top));
  } else {
    k_lo = max(max(frontier, lo), len - TC + 1);
    k_hi = min(top, S);
  }
  const size_t bh = (size_t)b * a.KV + h;
  const size_t pbase = (bh * a.n_split + sp) * R;
  if (k_lo >= k_hi) {  // an empty partial
    for (int r = threadIdx.x; r < R; r += KS_THREADS)
      a.part_ml[pbase + r] = make_float2(SP_NEG_INF, 0.0f);
    return;
  }

  const int nch = KT / min(G, KT);
  const int stage_bytes = ks_stage_bytes<DH, V4>(G);
  float* Qs = reinterpret_cast<float*>(smem + KS_STAGES * stage_bytes);
  float* Pw = Qs + RB * DH + warp * RB * KW;  // this warp's p (times the V scale), [RB][KW]
  const int tsz = tail ? PT : KT;             // keys (positions) of a tile
  const int base = tail ? k_lo : sp * a.span;
  const int t0 = (k_lo - base) / tsz;
  const int n_tiles = (k_hi - 1 - base) / tsz + 1 - t0;

  const int8_t* kg = a.kq + bh * S2 * DH;
  const int8_t* vg = a.vq + bh * (size_t)(V4 ? S2 : S) * DH;
  const float* csg = a.kchs + bh * (size_t)(S / G) * DH;
  const float* vsg = a.vs + bh * (size_t)S;  // [2, S/2] or [S]: S floats either way
  const int8_t* ktg = a.ktail + bh * TC * DH;
  const int8_t* vtg = a.vtail + bh * TC * DH;
  const float* ktsg = a.kts + bh * TC;
  const float* vtsg = a.vts + bh * TC;

  // copies of tile t0 + i into stage i % KS_STAGES
  auto issue = [&](int i) {
    unsigned char* Ks = smem + (i % KS_STAGES) * stage_bytes;
    int8_t* Vs = reinterpret_cast<int8_t*>(Ks + PT * KSTR);
    float* Cs = reinterpret_cast<float*>(Ks + PT * KSTR + VBYTES);
    float* Ss = Cs + nch * DH;
    const int k0 = base + (t0 + i) * tsz;
    const int a0 = max(k_lo, k0), a1 = min(k_hi, k0 + tsz);
    constexpr int C16 = DH / 16;  // 16-byte pieces of a row
    if (!tail) {
      const int r0 = (a0 - k0) / 2, r1 = (a1 - k0 + 1) / 2;  // packed rows holding live keys
      const int8_t* kt = kg + (size_t)(k0 / 2) * DH;
      const int8_t* vt = vg + (size_t)(V4 ? k0 / 2 : k0) * DH;
      for (int idx = threadIdx.x; idx < (r1 - r0) * C16; idx += KS_THREADS) {
        const int row = r0 + idx / C16, c = 16 * (idx % C16);
        pq_cp_async16(Ks + row * KSTR + c, kt + row * DH + c);
        if (V4) pq_cp_async16(Vs + row * DH + c, vt + row * DH + c);
      }
      if (!V4) {
        const int j0 = a0 - k0;
        for (int idx = threadIdx.x; idx < (a1 - a0) * C16; idx += KS_THREADS) {
          const int row = j0 + idx / C16, c = 16 * (idx % C16);
          pq_cp_async16(Vs + row * DH + c, vt + (size_t)row * DH + c);
        }
      }
      const int c0 = k0 / G, ncl = min(nch, S / G - c0);
      for (int idx = threadIdx.x; idx < ncl * (DH / 4); idx += KS_THREADS)
        pq_cp_async16(Cs + 4 * idx, csg + (size_t)c0 * DH + 4 * idx);
      if (V4) {  // the two parity planes of the tile's PT packed rows
        const int n4 = min(PT, S2 - k0 / 2) / 4;
        for (int idx = threadIdx.x; idx < 2 * n4; idx += KS_THREADS) {
          const int plane = idx / n4, c = 4 * (idx % n4);
          pq_cp_async16(Ss + plane * PT + c, vsg + plane * S2 + k0 / 2 + c);
        }
      } else {
        const int n4 = min(KT, S - k0) / 4;
        for (int idx = threadIdx.x; idx < n4; idx += KS_THREADS)
          pq_cp_async16(Ss + 4 * idx, vsg + k0 + 4 * idx);
      }
    } else {  // positions [a0, a1) = [k0, a1), row j of the tile from tail row (k0 + j) mod 2G
      for (int idx = threadIdx.x; idx < (a1 - a0) * C16; idx += KS_THREADS) {
        const int j = idx / C16, c = 16 * (idx % C16);
        const int col = (k0 + j) % TC;
        pq_cp_async16(Ks + j * KSTR + c, ktg + (size_t)col * DH + c);
        pq_cp_async16(Vs + j * DH + c, vtg + (size_t)col * DH + c);
      }
      for (int j = threadIdx.x; j < a1 - a0; j += KS_THREADS) {
        const int col = (k0 + j) % TC;
        pq_cp_async4(Ss + j, ktsg + col);
        pq_cp_async4(Ss + PT + j, vtsg + col);
      }
    }
  };

  issue(0);
  pq_cp_async_commit();
  if (n_tiles > 1) issue(1);
  pq_cp_async_commit();

  for (int i = threadIdx.x; i < R * DH; i += KS_THREADS) {
    const int r = i / DH, d = i % DH;
    const int t = r / group, gi = r % group;
    Qs[i] = sp_load_q(a.q, a.q_dtype, (((size_t)b * a.T + t) * a.H + h * group + gi) * DH + d);
  }
  float m[RB], l[RB], acc[RB][DPL], slope[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    m[r] = SP_NEG_INF;
    l[r] = 0.0f;
    slope[r] = VAR == 2 && a.alibi != nullptr && r < R ? a.alibi[h * group + r % group] : 0.0f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] = 0.0f;
  }
  const float inv_cap = VAR > 0 && a.softcap > 0.0f ? 1.0f / a.softcap : 0.0f;
  const int prow = lane % PRW, jp = lane / PRW;  // the lane's row in the warp's slice, dim part

  for (int i = 0; i < n_tiles; ++i) {
    pq_cp_async_wait<KS_STAGES - 1>();
    __syncthreads();  // tile i landed; Q staged
    const unsigned char* Ks = smem + (i % KS_STAGES) * stage_bytes;
    const int8_t* Vs = reinterpret_cast<const int8_t*>(Ks + PT * KSTR);
    const float* Cs = reinterpret_cast<const float*>(Ks + PT * KSTR + VBYTES);
    const float* Ss = Cs + nch * DH;
    const int k0 = base + (t0 + i) * tsz;
    const int wn = tail ? PRW : KW;  // keys of the warp's slice
    const int w0 = k0 + warp * wn;
    if (w0 < k_hi && w0 + wn > k_lo) {  // warp-uniform: its slice holds live keys
      const int pr = warp * PRW + prow;  // the lane's packed (or tail) row in the tile
      const unsigned char* krow = Ks + pr * KSTR + jp * DK;
      float s[RB][2];
#pragma unroll
      for (int r = 0; r < RB; ++r) s[r][0] = s[r][1] = 0.0f;
      if (!tail) {
        const float* cs = Cs + ((k0 + 2 * pr) / G - k0 / G) * DH + jp * DK;
#pragma unroll
        for (int c = 0; c < DK / 16; ++c) {
          const uint4 kw = *reinterpret_cast<const uint4*>(krow + 16 * c);
          const unsigned x[4] = {kw.x ^ 0x88888888u, kw.y ^ 0x88888888u, kw.z ^ 0x88888888u,
                                 kw.w ^ 0x88888888u};
          float klo[16], khi[16];
#pragma unroll
          for (int wi = 0; wi < 4; ++wi) {
            const float4 s4 = *reinterpret_cast<const float4*>(cs + 16 * c + 4 * wi);
            const float sc[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              klo[4 * wi + e] = __fmul_rn(sp_nib(x[wi], 8 * e), sc[e]);
              khi[4 * wi + e] = __fmul_rn(sp_nib(x[wi], 8 * e + 4), sc[e]);
            }
          }
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            if (r >= R) break;
            const float* qr = Qs + r * DH + jp * DK + 16 * c;
#pragma unroll
            for (int d4 = 0; d4 < 4; ++d4) {
              const float4 q4 = *reinterpret_cast<const float4*>(qr + 4 * d4);
              s[r][0] += q4.x * klo[4 * d4] + q4.y * klo[4 * d4 + 1] + q4.z * klo[4 * d4 + 2] +
                         q4.w * klo[4 * d4 + 3];
              s[r][1] += q4.x * khi[4 * d4] + q4.y * khi[4 * d4 + 1] + q4.z * khi[4 * d4 + 2] +
                         q4.w * khi[4 * d4 + 3];
            }
          }
        }
      } else {
        const float ksc = Ss[pr];
#pragma unroll
        for (int c = 0; c < DK / 16; ++c) {
          const uint4 kw = *reinterpret_cast<const uint4*>(krow + 16 * c);
          const unsigned x[4] = {kw.x ^ 0x80808080u, kw.y ^ 0x80808080u, kw.z ^ 0x80808080u,
                                 kw.w ^ 0x80808080u};
          float kf[16];
#pragma unroll
          for (int wi = 0; wi < 4; ++wi)
#pragma unroll
            for (int e = 0; e < 4; ++e) kf[4 * wi + e] = __fmul_rn(sp_byte(x[wi], e), ksc);
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            if (r >= R) break;
            const float* qr = Qs + r * DH + jp * DK + 16 * c;
#pragma unroll
            for (int d4 = 0; d4 < 4; ++d4) {
              const float4 q4 = *reinterpret_cast<const float4*>(qr + 4 * d4);
              s[r][0] += q4.x * kf[4 * d4] + q4.y * kf[4 * d4 + 1] + q4.z * kf[4 * d4 + 2] +
                         q4.w * kf[4 * d4 + 3];
            }
          }
        }
      }

      // scores, masks and the warp's online softmax, row by row
      const int key = tail ? k0 + pr : k0 + 2 * pr;  // the lane's first token
      const int ntok = tail ? 1 : 2;
      bool any = false;
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r >= R) break;
#pragma unroll
        for (int o = PRW; o < 32; o <<= 1) {  // the LPR lanes of a row meet
          s[r][0] += __shfl_xor_sync(0xffffffffu, s[r][0], o);
          s[r][1] += __shfl_xor_sync(0xffffffffu, s[r][1], o);
        }
        const int hz = len + r / group;
        float sc[2];
        bool ok[2];
#pragma unroll
        for (int tk = 0; tk < 2; ++tk) {
          const int p = key + tk;
          bool v_ok = tk < ntok && p >= k_lo && p < k_hi && p <= hz;
          if (tail) v_ok = v_ok && p > hz - TC;
          if (windowed) v_ok = v_ok && p > hz - a.window;
          float v = s[r][tk] * a.sm;
          if (VAR > 0 && a.softcap > 0.0f) v = a.softcap * tanhf(v * inv_cap);
          if (VAR == 2) v -= slope[r] * (float)(hz - p);
          ok[tk] = v_ok;
          sc[tk] = v_ok ? v : SP_NEG_INF;
        }
        const float tmax = pq_warp_max(fmaxf(sc[0], sc[1]));
        float p0 = 0.0f, p1 = 0.0f;
        if (tmax > SP_NEG_INF) {  // warp-uniform: the row sees a key of the slice
          any = true;
          const float m_new = fmaxf(m[r], tmax);
          const float corr = expf(m[r] - m_new);
          p0 = ok[0] ? expf(sc[0] - m_new) : 0.0f;
          p1 = ok[1] ? expf(sc[1] - m_new) : 0.0f;
          l[r] = l[r] * corr + (jp == 0 ? p0 + p1 : 0.0f);
          m[r] = m_new;
#pragma unroll
          for (int e = 0; e < DPL; ++e) acc[r][e] *= corr;
        }
        if (jp == 0) {  // p times the V scale, 0 where masked (whatever a masked key's slot holds)
          float* pr_row = Pw + r * KW;
          if (tail) {
            pr_row[prow] = ok[0] ? p0 * Ss[PT + pr] : 0.0f;
          } else {
            const float vs0 = V4 ? Ss[pr] : Ss[2 * pr], vs1 = V4 ? Ss[PT + pr] : Ss[2 * pr + 1];
            pr_row[2 * prow] = ok[0] ? p0 * vs0 : 0.0f;
            pr_row[2 * prow + 1] = ok[1] ? p1 * vs1 : 0.0f;
          }
        }
      }
      // p . V over the warp's keys, each lane on its DPL output dims
      if (any) {
        __syncwarp();
        constexpr int NW = (DPL + 3) / 4;
        if (!tail && !V4) {  // int8 V rows, two keys a step
#pragma unroll 4
          for (int j = 0; j < KW; j += 2) {
            const int8_t* v0 = Vs + (warp * KW + j) * DH + lane * DPL;
            unsigned w0w[NW], w1w[NW];
            sp_load_bytes<DPL>(v0, w0w);
            sp_load_bytes<DPL>(v0 + DH, w1w);
            float f0[DPL], f1[DPL];
#pragma unroll
            for (int e = 0; e < DPL; ++e) {
              f0[e] = sp_byte(w0w[e / 4] ^ 0x80808080u, e % 4);
              f1[e] = sp_byte(w1w[e / 4] ^ 0x80808080u, e % 4);
            }
#pragma unroll
            for (int r = 0; r < RB; ++r) {
              if (r >= R) break;
              const float2 p = *reinterpret_cast<const float2*>(Pw + r * KW + j);
#pragma unroll
              for (int e = 0; e < DPL; ++e) acc[r][e] += p.x * f0[e] + p.y * f1[e];
            }
          }
        } else if (!tail) {  // packed int4 V rows: tokens 2jj (low nibble) and 2jj + 1
#pragma unroll 4
          for (int jj = 0; jj < PRW; ++jj) {
            unsigned ww[NW];
            sp_load_bytes<DPL>(Vs + (warp * PRW + jj) * DH + lane * DPL, ww);
            float f0[DPL], f1[DPL];
#pragma unroll
            for (int e = 0; e < DPL; ++e) {
              const unsigned x = ww[e / 4] ^ 0x88888888u;
              f0[e] = sp_nib(x, 8 * (e % 4));
              f1[e] = sp_nib(x, 8 * (e % 4) + 4);
            }
#pragma unroll
            for (int r = 0; r < RB; ++r) {
              if (r >= R) break;
              const float2 p = *reinterpret_cast<const float2*>(Pw + r * KW + 2 * jj);
#pragma unroll
              for (int e = 0; e < DPL; ++e) acc[r][e] += p.x * f0[e] + p.y * f1[e];
            }
          }
        } else {  // tail int8 V rows, one position each
#pragma unroll 4
          for (int jj = 0; jj < PRW; ++jj) {
            unsigned ww[NW];
            sp_load_bytes<DPL>(Vs + (warp * PRW + jj) * DH + lane * DPL, ww);
#pragma unroll
            for (int r = 0; r < RB; ++r) {
              if (r >= R) break;
              const float p = Pw[r * KW + jj];
#pragma unroll
              for (int e = 0; e < DPL; ++e)
                acc[r][e] += p * sp_byte(ww[e / 4] ^ 0x80808080u, e % 4);
            }
          }
        }
      }
    }
    __syncthreads();  // stage i % KS_STAGES consumed
    if (i + KS_STAGES < n_tiles) issue(i + KS_STAGES);
    pq_cp_async_commit();
  }

  // merge the warps' states in warp order; write the split's partial
#pragma unroll
  for (int r = 0; r < RB; ++r) l[r] = pq_warp_sum(l[r]);
  pq_cp_async_wait<0>();
  __syncthreads();
  float* Mw = reinterpret_cast<float*>(smem);  // [warps][RB]
  float* Lw = Mw + KS_WARPS * RB;
  float* Aw = Lw + KS_WARPS * RB;  // [warps][RB][DH]
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    if (r >= R) break;
    if (lane == 0) {
      Mw[warp * RB + r] = m[r];
      Lw[warp * RB + r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < DPL; ++e) Aw[(warp * RB + r) * DH + lane * DPL + e] = acc[r][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * DH; idx += KS_THREADS) {
    const int r = idx / DH, d = idx % DH;
    float M = SP_NEG_INF;
#pragma unroll
    for (int w = 0; w < KS_WARPS; ++w) M = fmaxf(M, Mw[w * RB + r]);
    float L = 0.0f, A = 0.0f;
#pragma unroll
    for (int w = 0; w < KS_WARPS; ++w) {
      const float e = expf(Mw[w * RB + r] - M);
      L += Lw[w * RB + r] * e;
      A += Aw[(w * RB + r) * DH + d] * e;
    }
    a.part_acc[(pbase + r) * DH + d] = A;
    if (d == 0) a.part_ml[pbase + r] = make_float2(M, L);
  }
}

template <int DH, bool V4, int VAR, int RB>
static cudaError_t ks_launch(const KiviSplitArgs& a, cudaStream_t st) {
  static bool configured = false;
  cudaError_t err = pq_allow_smem(kivi_split_kernel<DH, V4, VAR, RB>,
                                  ks_smem_bytes<DH, V4, RB>(KS_MIN_G), configured);
  if (err != cudaSuccess) return err;
  dim3 grid(a.n_split, a.KV, a.B);
  kivi_split_kernel<DH, V4, VAR, RB>
      <<<grid, KS_THREADS, ks_smem_bytes<DH, V4, RB>(a.G), st>>>(a);
  return cudaGetLastError();
}

template <int DH, bool V4, int VAR>
static cudaError_t ks_rows(const KiviSplitArgs& a, cudaStream_t st) {
  const int R = a.T * (a.H / a.KV);
  if (R <= 1) return ks_launch<DH, V4, VAR, 1>(a, st);
  if (R <= 2) return ks_launch<DH, V4, VAR, 2>(a, st);
  if (R <= 4) return ks_launch<DH, V4, VAR, 4>(a, st);
  if constexpr (KsGeom<DH>::MAX_RB >= 8)
    if (R <= 8) return ks_launch<DH, V4, VAR, 8>(a, st);
  if constexpr (KsGeom<DH>::MAX_RB >= 16)
    if (R <= 16) return ks_launch<DH, V4, VAR, 16>(a, st);
  return cudaErrorInvalidValue;
}

template <int DH, bool V4>
static cudaError_t ks_var(const KiviSplitArgs& a, cudaStream_t st) {
  if (a.alibi != nullptr) return ks_rows<DH, V4, 2>(a, st);
  if (a.window > 0 || a.softcap > 0.0f) return ks_rows<DH, V4, 1>(a, st);
  return ks_rows<DH, V4, 0>(a, st);  // the learned sinks join in the merge
}

// The split kernel for every head dim of one V layout.
template <bool V4>
static cudaError_t kivi_split_dispatch(const KiviSplitArgs& a, cudaStream_t st) {
  switch (a.Dh) {
    case 32: return ks_var<32, V4>(a, st);
    case 64: return ks_var<64, V4>(a, st);
    case 128: return ks_var<128, V4>(a, st);
    case 256: return ks_var<256, V4>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

// Defined in kivi_split_k4v8.cu and kivi_split_int4.cu (one nvcc each).
cudaError_t kivi_split_k4v8(const KiviSplitArgs& a, cudaStream_t st);
cudaError_t kivi_split_int4(const KiviSplitArgs& a, cudaStream_t st);
