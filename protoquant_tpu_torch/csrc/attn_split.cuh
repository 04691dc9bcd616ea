// Split-S decode attention over the dense int8 cache, the K8V4 cache and
// the paged int8 pool (flash-decoding), the design that ops/attention.py
// routes every decode-sized call of int8_kv_attention and
// mixed_kv_attention to, and ops/paged_attention.py every paged decode whose
// rows fit a block; the prefill kernel of csrc/attn_prefill.cuh keeps the
// calls with many query rows, csrc/paged_attention.cu the paged
// calls the plan refuses. The contract is attn_prefill.cuh's, variant for
// variant (window, score scale, softcap, ring positions, StreamingLLM sinks,
// ALiBi, learned sinks; K8V4 the scale alone; Dh 32, 64, 128, 256; q in
// f32, bf16, f16), and paged_attention.cu's for the paged pool.
//
// Bound on the H100: bytes, the keys some row of the step sees (Dh + 4 of K
// and its scale, Dh + 4 of V and its scale, or Dh / 2 + 4 for K8V4's packed
// V), q and out. A one-pass kernel puts one block on each (b, kv head) at
// decode, with a single query row to feed each tile it loads: latency, not
// bytes, holds it back. A call takes this design,
// whatever its batch, when its rows fit one block and it needs at most
// SP_MAX_SPLITS splits: as_plan decides, and pq_attn_split_plan
// (attn_split.cu) tells the wrapper, which sizes the partials' workspace by
// it. This design, kivi_split.cuh's adapted to int8 K (no chunk-channel
// scale, no tail: each key carries its own K and V scale):
// - Grid (n_split, KV, B). Split sp covers the columns [sp span, (sp + 1)
//   span) (AsGeom::SPAN = 128 at every Dh, 1 to 4 tiles: on an H100 it beat
//   256 at the Gemma-2 and GPT-OSS sliding decodes and BLOOM's, and 64 at
//   the 7B decode at batch 32, tools/attention_timing.py). The grid is sized
//   from the capacity S, so nothing waits on the lengths that live on the
//   card, and the pair of launches can be captured in a CUDA graph. A
//   window over a contiguous cache without StreamingLLM sinks bounds the
//   splits a row sees: the grid then covers the window alone, block x
//   taking split x + (the row's first key in the window) / span. Where the
//   batch's rows keep more splits live than one wave of the card holds
//   (every block counts them from the lengths, so all agree), the span
//   grows by tiles until the rows' splits would fit one wave (as_launch
//   asks the card its SMs and the instance's blocks an SM): a second,
//   partial wave would cost a drain and refill of the copies. So a sliding
//   layer of Gemma-2 at B = 4 runs 33 blocks of 128 columns a (b, kv head)
//   while its rows are short, and fewer, longer ones once they fill their
//   windows; GPT-OSS's window of 128 keeps 2 or 3 of 128.
// - A split whose columns hold no key that a row sees writes an empty
//   partial (m = -1e30, l = 0) and exits. Over a contiguous cache its live
//   columns are [max(start, first key in the first row's window), min(end,
//   len + T, S)); with StreamingLLM sinks and a window, a split holding a
//   column < sinks starts at its first column instead (the sink columns stay
//   visible, as int8_kv_attention_xla keeps them; the Pallas kernel drops
//   them, fault F2). A ring (kpos) scatters positions over its columns: the
//   block stages its split's positions in shared memory first and keeps the
//   columns from the first to the last that some row sees (a position p with
//   0 <= p <= len + T - 1 and, with a window, p > len - window or p < sinks),
//   exiting if there is none.
// - Four warps split each tile's keys, not the rows: a lane owns one key of
//   its warp's slice and Dh / LPR of its dims (LPR = Dh / 64 lanes share a
//   key at Dh >= 128; their sums meet by shuffles). It converts the key's
//   int8 bytes in registers (exactly, through 2^23 + x) and forms the dot
//   with all R rows of the block; score = (q . k) * ks[c] * sm, then the
//   softcap, then ALiBi's - slope (p_t - pos), then the mask, per position.
//   Each warp keeps its own online softmax (m, l, acc) per row; p times the
//   key's V scale goes to the warp's shared row and the warp's lanes, one
//   per Dh / 32 output dims, walk the warp's keys for p . V (K8V4: the
//   packed byte rows, tokens 2i and 2i + 1 from the low and high nibbles,
//   each token's scale taken from the plane of its parity). The block merges
//   its warps' states in a fixed order and writes the split's partial: acc
//   (not normalised), m, l.
// - The raw bytes (K rows, V rows or K8V4's packed byte rows) move by
//   16-byte cp.async.cg, the per-token scales by 4-byte copies, into a ring
//   of two stages, tile i + 1 in flight while tile i is consumed. Only the
//   rows that hold live keys are copied; a key outside them is masked, and
//   its p times V scale is selected to 0, never multiplied (its staged scale
//   may be anything).
// - f32 on the CUDA cores: at decode R <= 8 rows a kv head; the work is
//   bytes.
// - split_merge (split_common.cuh) merges each row's partials in split
//   order; the learned sinks join there once, as the initial state m = sink,
//   l = 1. No atomics: two calls on the same inputs give the same bits.
// - The paged pool (template flag PAGED, replacing
//   protoquant_tpu/ops/paged_attention.py:_kernel): only where column c
//   lives changes. The columns are the table's maxP * ps virtual positions
//   (key slot s of entry j at j ps + s), the grid is sized from that width
//   (never from the lengths on the card, so the pair of launches stays
//   capturable), and column c is row pool[max(page_table[b, c / ps], 0), h,
//   c % ps] of the K and V pools and of their scales: the block reads its
//   split's table entries once into shared memory (the ring positions' slot,
//   unused there) and every copy takes its row from there, at any page size
//   (a tile may span pages). Decode only, VAR 0, or VAR 2 for ALiBi (no ring
//   positions, no sinks, no window).
// Rows per block R = T group is bounded by the register budget of the
// per-row state: at most 16 at Dh <= 64, 8 at 128, 4 at 256 (template RB,
// the least power of two >= R; rows past R are never computed). The window
// and the softcap are read only by the VAR >= 1 instances, the positions,
// the StreamingLLM sinks and the ALiBi slopes only by VAR = 2; K8V4 takes
// VAR = 0 alone (its only variant is the scale).

#pragma once

#include <algorithm>

#include "split_common.cuh"

struct AttnSplitArgs {
  const void* q;
  int q_dtype;
  const int8_t* kq;
  const float* ks;
  const int8_t* vq;
  const float* vs;
  const int* lengths;
  const int* kpos;
  const float* alibi;
  float* part_acc;
  float2* part_ml;
  int B, T, H, KV, S, Dh;
  float sm;
  int window;
  float softcap;
  int sinks;
  int n_split;
  // a window's grid (as_launch): the blocks one wave of the card holds, and
  // the longer span a batch takes whose live splits would overflow it
  int wave, span_big;
  // the paged pool (PAGED instances): the table [B, maxP] and the page size;
  // S is then the table's maxP * ps virtual columns
  const int* page_table;
  int maxP, ps;
};

constexpr int AS_THREADS = 128;
constexpr int AS_WARPS = AS_THREADS / 32;
constexpr int AS_STAGES = 2;

// Tile geometry at head dim DH.
template <int DH>
struct AsGeom {
  static constexpr int LPR = DH >= 128 ? DH / 64 : 1;  // lanes sharing a key
  static constexpr int DK = DH / LPR;                  // dims of a lane's dot product
  static constexpr int KW = 32 / LPR;                  // keys a warp takes of a tile
  static constexpr int KT = AS_WARPS * KW;             // keys of a tile
  static constexpr int KSTR = DH + 16;                 // padded K row in shared memory, bytes
  static constexpr int DPL = DH / 32;                  // output dims of a lane in p . V
  static constexpr int MAX_RB = DH == 256 ? 4 : DH == 128 ? 8 : 16;
  static constexpr int SPAN = 128;                     // columns of a split
  static_assert(SPAN % KT == 0, "a split holds whole tiles");
};

// The SMs of the current card, asked once.
inline int as_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) == cudaSuccess &&
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess)
      n = sms;
  }
  return n > 0 ? n : 1;
}

// The split plan of a call at head dim DH with R query rows a kv head: the
// number of splits, the span in *span; 0 where the prefill kernel takes
// the call. The splits cover the capacity S, SPAN columns each; for a
// window over a contiguous cache without StreamingLLM sinks (window_grid >
// 0) they cover the window alone: its window + T - 1 columns touch at most
// (window + T - 2) / SPAN + 2 splits, counted from each row's first.
template <int DH>
inline int as_plan_dh(int T, int R, int S, int window_grid, int* span) {
  using Gm = AsGeom<DH>;
  if (R > Gm::MAX_RB) return 0;
  int n = (S + Gm::SPAN - 1) / Gm::SPAN;
  if (window_grid > 0) n = std::min(n, (window_grid + T - 2) / Gm::SPAN + 2);
  if (n > SP_MAX_SPLITS) return 0;
  *span = Gm::SPAN;
  return n;
}

inline int as_plan(int T, int H, int KV, int S, int Dh, int window, int sinks, bool ring,
                   int* span) {
  if (T <= 0 || KV <= 0 || H % KV != 0 || S <= 0) return 0;
  const int R = T * (H / KV);
  const int wg = ring || sinks > 0 ? 0 : window;
  switch (Dh) {
    case 32: return as_plan_dh<32>(T, R, S, wg, span);
    case 64: return as_plan_dh<64>(T, R, S, wg, span);
    case 128: return as_plan_dh<128>(T, R, S, wg, span);
    case 256: return as_plan_dh<256>(T, R, S, wg, span);
    default: return 0;
  }
}

// Row b's splits of span sp that hold a key of its window, counted from the
// one holding the first.
__device__ inline int as_window_splits(int len, int T, int window, int S, int sp) {
  const int lo = len - window + 1 > 0 ? len - window + 1 : 0;
  const int top = len + T < S ? len + T : S;
  return top > lo ? (top - 1) / sp - lo / sp + 1 : 0;
}

// Bytes of one stage: K rows, V rows (K8V4: packed byte rows), the K and
// the V scales of the tile's keys.
template <int DH, bool V4>
__host__ __device__ constexpr int as_stage_bytes() {
  using Gm = AsGeom<DH>;
  return Gm::KT * Gm::KSTR + (V4 ? Gm::KT / 2 : Gm::KT) * DH + 2 * Gm::KT * 4;
}

// The stages, which the warps' merge reuses after the walk.
template <int DH, bool V4, int RB>
__host__ __device__ constexpr int as_stages_bytes() {
  const int stages = AS_STAGES * as_stage_bytes<DH, V4>();
  const int merge = AS_WARPS * RB * (DH + 2) * 4;
  return stages > merge ? stages : merge;
}

// Dynamic shared memory: the stages, q, the warps' p rows and, at VAR = 2,
// the split's ring positions (paged: the pool rows of its columns, there).
template <int DH, bool V4, int VAR, int RB, bool PAGED = false>
__host__ __device__ constexpr int as_smem_bytes() {
  using Gm = AsGeom<DH>;
  return as_stages_bytes<DH, V4, RB>() + 4 * (RB * DH + AS_WARPS * RB * Gm::KW) +
         (VAR == 2 || PAGED ? 4 * Gm::SPAN : 0);
}

template <int DH, bool V4, int VAR, int RB, bool PAGED = false>
__global__ void __launch_bounds__(AS_THREADS) attn_split_kernel(const AttnSplitArgs a) {
  static_assert(!(PAGED && V4), "the paged pool holds int8 V");
  using Gm = AsGeom<DH>;
  constexpr int KW = Gm::KW, KT = Gm::KT, KSTR = Gm::KSTR, DK = Gm::DK, DPL = Gm::DPL;
  constexpr int SPAN = Gm::SPAN;
  constexpr int VBYTES = (V4 ? KT / 2 : KT) * DH;
  constexpr int STAGE = as_stage_bytes<DH, V4>();
  constexpr bool EXT = VAR == 2;  // ring positions, StreamingLLM sinks, ALiBi
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int live_cols[2];  // a ring split's first and last column that a row sees

  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = a.H / a.KV, R = a.T * group, S = a.S;
  const int len = a.lengths[b];
  const bool windowed = VAR > 0 && a.window > 0;
  const bool ring = EXT && a.kpos != nullptr;
  // the split: blockIdx.x, or counted from the one holding the row's first
  // key in the window where the grid covers the window alone (as_plan); the
  // span there grows to span_big where the batch's rows keep more splits
  // live than one wave holds (every block reads every length: all agree)
  const bool from_window = windowed && !ring && !(EXT && a.sinks > 0);
  __shared__ int batch_live;
  int span = SPAN;
  if (from_window && a.span_big > SPAN) {
    if (warp == 0) {
      int n = 0;
      for (int i = lane; i < a.B; i += 32)
        n += as_window_splits(a.lengths[i], a.T, a.window, S, SPAN);
      n = __reduce_add_sync(0xffffffffu, n);
      if (lane == 0) batch_live = n;
    }
    __syncthreads();
    if ((long long)batch_live * a.KV > a.wave) span = a.span_big;
  }
  const int sp = blockIdx.x + (from_window ? max(len - a.window + 1, 0) / span : 0);
  const int s0 = sp * span, s1 = min(s0 + span, S);
  float* Qs = reinterpret_cast<float*>(smem + as_stages_bytes<DH, V4, RB>());
  float* Pw = Qs + RB * DH + warp * RB * KW;  // this warp's p (times the V scale), [RB][KW]
  // [SPAN], a ring's positions (a ring's span is always SPAN)
  int* Pos = reinterpret_cast<int*>(Qs + RB * DH + AS_WARPS * RB * KW);
  const size_t bh = (size_t)b * a.KV + h;
  const size_t pbase = (bh * a.n_split + blockIdx.x) * R;
  // paged: the pool row [page][h][slot] of each of the split's columns, read
  // through the table (an unmapped entry, -1, reads page 0), so that every
  // copy below takes its address from shared memory
  unsigned* Rows = reinterpret_cast<unsigned*>(Pos);
  if constexpr (PAGED) {
    for (int c = s0 + threadIdx.x; c < s1; c += AS_THREADS) {
      const int page = max(a.page_table[(size_t)b * a.maxP + c / a.ps], 0);
      Rows[c - s0] = ((unsigned)page * a.KV + h) * a.ps + c % a.ps;
    }
    __syncthreads();
  }
  // the row of column c in the K and V payloads and scales below
  auto pool_row = [&](int c) -> size_t {
    if constexpr (PAGED) return Rows[c - s0];
    else return (size_t)c;
  };

  int k_lo, k_hi;  // the block's columns holding live keys
  if (ring) {
    if (threadIdx.x == 0) {
      live_cols[0] = S;
      live_cols[1] = -1;
    }
    __syncthreads();
    const int last = len + a.T - 1;  // the last row's position
    int c_min = S, c_max = -1;
    for (int c = s0 + threadIdx.x; c < s1; c += AS_THREADS) {
      const int p = a.kpos[(size_t)b * S + c];
      Pos[c - s0] = p;
      if (p >= 0 && p <= last && (!windowed || p > len - a.window || p < a.sinks)) {
        c_min = min(c_min, c);
        c_max = max(c_max, c);
      }
    }
    if (c_max >= 0) {
      atomicMin(&live_cols[0], c_min);
      atomicMax(&live_cols[1], c_max);
    }
    __syncthreads();
    k_lo = live_cols[0];
    k_hi = live_cols[1] + 1;
  } else {
    // the split's part of the rows' windows, [w_lo, w_hi), and of the sink
    // columns, [s0, n_hi); their hull where both hold keys
    const int top = min(len + a.T, S);  // one past the last row's last key
    const int lo = windowed ? max(len - a.window + 1, 0) : 0;  // first key a row sees
    const int w_lo = max(s0, lo), w_hi = min(s1, top);
    const int n_hi = EXT && windowed ? min(s1, min(a.sinks, top)) : 0;
    k_lo = w_lo < w_hi && s0 >= n_hi ? w_lo : s0;
    k_hi = w_lo < w_hi ? w_hi : n_hi;
  }
  if (k_lo >= k_hi) {  // an empty partial
    for (int r = threadIdx.x; r < R; r += AS_THREADS)
      a.part_ml[pbase + r] = make_float2(SP_NEG_INF, 0.0f);
    return;
  }

  const int t0 = (k_lo - s0) / KT;
  const int n_tiles = (k_hi - 1 - s0) / KT + 1 - t0;
  const int S2 = S / 2;
  const size_t cache = PAGED ? 0 : bh * S;  // the (b, kv head)'s first row (paged: the pool's)
  const int8_t* kg = a.kq + cache * DH;
  const int8_t* vg = a.vq + (V4 ? cache / 2 : cache) * DH;
  const float* ksg = a.ks + cache;
  const float* vsg = a.vs + cache;  // [2, S/2] or [S]: S floats either way

  // copies of tile t0 + i into stage i % AS_STAGES
  auto issue = [&](int i) {
    unsigned char* Ks = smem + (i % AS_STAGES) * STAGE;
    int8_t* Vs = reinterpret_cast<int8_t*>(Ks + KT * KSTR);
    float* Ss = reinterpret_cast<float*>(Ks + KT * KSTR + VBYTES);  // [KT] K, then [KT] V scales
    const int k0 = s0 + (t0 + i) * KT;
    const int j0 = max(k_lo, k0) - k0, j1 = min(k_hi, k0 + KT) - k0;  // live keys of the tile
    constexpr int C16 = DH / 16;  // 16-byte pieces of a row
    for (int idx = threadIdx.x; idx < (j1 - j0) * C16; idx += AS_THREADS) {
      const int j = j0 + idx / C16, c = 16 * (idx % C16);
      const size_t r = pool_row(k0 + j);
      pq_cp_async16(Ks + j * KSTR + c, kg + r * DH + c);
      if (!V4) pq_cp_async16(Vs + j * DH + c, vg + r * DH + c);
    }
    if (V4) {  // the packed rows holding live keys: row r has tokens k0 + 2r, k0 + 2r + 1
      const int r0 = j0 / 2, r1 = (j1 + 1) / 2;
      for (int idx = threadIdx.x; idx < (r1 - r0) * C16; idx += AS_THREADS) {
        const int row = r0 + idx / C16, c = 16 * (idx % C16);
        pq_cp_async16(Vs + row * DH + c, vg + (size_t)(k0 / 2 + row) * DH + c);
      }
    }
    for (int j = j0 + threadIdx.x; j < j1; j += AS_THREADS) {
      const int c = k0 + j;
      pq_cp_async4(Ss + j, ksg + pool_row(c));
      pq_cp_async4(Ss + KT + j, V4 ? vsg + (c & 1) * S2 + c / 2 : vsg + pool_row(c));
    }
  };

#pragma unroll
  for (int i = 0; i < AS_STAGES; ++i) {
    if (i < n_tiles) issue(i);
    pq_cp_async_commit();
  }

  for (int i = threadIdx.x; i < R * DH; i += AS_THREADS) {
    const int r = i / DH, d = i % DH;
    const int t = r / group, gi = r % group;
    Qs[i] = sp_load_q(a.q, a.q_dtype, (((size_t)b * a.T + t) * a.H + h * group + gi) * DH + d);
  }
  float m[RB], l[RB], acc[RB][DPL], slope[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    m[r] = SP_NEG_INF;
    l[r] = 0.0f;
    slope[r] = EXT && a.alibi != nullptr && r < R ? a.alibi[h * group + r % group] : 0.0f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] = 0.0f;
  }
  const float inv_cap = VAR > 0 && a.softcap > 0.0f ? 1.0f / a.softcap : 0.0f;
  const int prow = lane % KW, jp = lane / KW;  // the lane's key in the warp's slice, dim part

  for (int i = 0; i < n_tiles; ++i) {
    pq_cp_async_wait<AS_STAGES - 1>();
    __syncthreads();  // tile i landed; Q staged
    const unsigned char* Ks = smem + (i % AS_STAGES) * STAGE;
    const int8_t* Vs = reinterpret_cast<const int8_t*>(Ks + KT * KSTR);
    const float* Ss = reinterpret_cast<const float*>(Ks + KT * KSTR + VBYTES);
    const int k0 = s0 + (t0 + i) * KT;
    const int w0 = k0 + warp * KW;
    if (w0 < k_hi && w0 + KW > k_lo) {  // warp-uniform: its slice holds live keys
      const int j = warp * KW + prow;   // the lane's key in the tile
      const unsigned char* krow = Ks + j * KSTR + jp * DK;
      float s[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) s[r] = 0.0f;
#pragma unroll
      for (int c = 0; c < DK / 16; ++c) {
        const uint4 kw = *reinterpret_cast<const uint4*>(krow + 16 * c);
        const unsigned x[4] = {kw.x ^ 0x80808080u, kw.y ^ 0x80808080u, kw.z ^ 0x80808080u,
                               kw.w ^ 0x80808080u};
        float kf[16];
#pragma unroll
        for (int wi = 0; wi < 4; ++wi)
#pragma unroll
          for (int e = 0; e < 4; ++e) kf[4 * wi + e] = sp_byte(x[wi], e);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          if (r >= R) break;
          const float* qr = Qs + r * DH + jp * DK + 16 * c;
#pragma unroll
          for (int d4 = 0; d4 < 4; ++d4) {
            const float4 q4 = *reinterpret_cast<const float4*>(qr + 4 * d4);
            s[r] += q4.x * kf[4 * d4] + q4.y * kf[4 * d4 + 1] + q4.z * kf[4 * d4 + 2] +
                    q4.w * kf[4 * d4 + 3];
          }
        }
      }

      // scores, masks and the warp's online softmax, row by row
      const int key = k0 + j;
      const float ksc = Ss[j], vsc = Ss[KT + j];  // anything for a key never copied
      const int pos = EXT && ring ? Pos[key - s0] : key;
      const bool copied = key >= k_lo && key < k_hi;
      bool any = false;
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r >= R) break;
#pragma unroll
        for (int o = KW; o < 32; o <<= 1) s[r] += __shfl_xor_sync(0xffffffffu, s[r], o);
        const int hz = len + r / group;  // the row's position
        bool ok = copied && pos >= 0 && pos <= hz;
        if (windowed) ok = ok && (pos > hz - a.window || (EXT && pos < a.sinks));
        float v = (s[r] * ksc) * a.sm;
        if (VAR > 0 && a.softcap > 0.0f) v = a.softcap * tanhf(v * inv_cap);
        if (EXT) v -= slope[r] * (float)(hz - pos);  // slope 0 without ALiBi
        const float sc = ok ? v : SP_NEG_INF;
        const float tmax = pq_warp_max(sc);
        float p = 0.0f;
        if (tmax > SP_NEG_INF) {  // warp-uniform: the row sees a key of the slice
          any = true;
          const float m_new = fmaxf(m[r], tmax);
          const float corr = expf(m[r] - m_new);
          p = ok ? expf(sc - m_new) : 0.0f;
          l[r] = l[r] * corr + (jp == 0 ? p : 0.0f);
          m[r] = m_new;
#pragma unroll
          for (int e = 0; e < DPL; ++e) acc[r][e] *= corr;
        }
        // p times the V scale, 0 where masked (whatever a masked key's slot holds)
        if (jp == 0) Pw[r * KW + prow] = ok ? p * vsc : 0.0f;
      }
      // p . V over the warp's keys, each lane on its DPL output dims
      if (any) {
        __syncwarp();
        constexpr int NW = (DPL + 3) / 4;
        if constexpr (!V4) {  // int8 V rows, two keys a step
#pragma unroll 4
          for (int jj = 0; jj < KW; jj += 2) {
            const int8_t* v0 = Vs + (warp * KW + jj) * DH + lane * DPL;
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
              const float2 p = *reinterpret_cast<const float2*>(Pw + r * KW + jj);
#pragma unroll
              for (int e = 0; e < DPL; ++e) acc[r][e] += p.x * f0[e] + p.y * f1[e];
            }
          }
        } else {  // packed int4 V rows: tokens 2jj (low nibble) and 2jj + 1 (high)
#pragma unroll 4
          for (int jj = 0; jj < KW / 2; ++jj) {
            unsigned ww[NW];
            sp_load_bytes<DPL>(Vs + (warp * KW / 2 + jj) * DH + lane * DPL, ww);
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
        }
      }
    }
    __syncthreads();  // stage i % AS_STAGES consumed
    if (i + AS_STAGES < n_tiles) issue(i + AS_STAGES);
    pq_cp_async_commit();
  }

  // merge the warps' states in warp order; write the split's partial
#pragma unroll
  for (int r = 0; r < RB; ++r) l[r] = pq_warp_sum(l[r]);
  pq_cp_async_wait<0>();
  __syncthreads();
  float* Mw = reinterpret_cast<float*>(smem);  // [warps][RB]
  float* Lw = Mw + AS_WARPS * RB;
  float* Aw = Lw + AS_WARPS * RB;  // [warps][RB][DH]
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
  for (int idx = threadIdx.x; idx < R * DH; idx += AS_THREADS) {
    const int r = idx / DH, d = idx % DH;
    float M = SP_NEG_INF;
#pragma unroll
    for (int w = 0; w < AS_WARPS; ++w) M = fmaxf(M, Mw[w * RB + r]);
    float L = 0.0f, A = 0.0f;
#pragma unroll
    for (int w = 0; w < AS_WARPS; ++w) {
      const float e = expf(Mw[w * RB + r] - M);
      L += Lw[w * RB + r] * e;
      A += Aw[(w * RB + r) * DH + d] * e;
    }
    a.part_acc[(pbase + r) * DH + d] = A;
    if (d == 0) a.part_ml[pbase + r] = make_float2(M, L);
  }
}

template <int DH, bool V4, int VAR, int RB, bool PAGED = false>
static cudaError_t as_launch(AttnSplitArgs a, cudaStream_t st) {
  using Gm = AsGeom<DH>;
  constexpr int smem = as_smem_bytes<DH, V4, VAR, RB, PAGED>();
  auto kernel = attn_split_kernel<DH, V4, VAR, RB, PAGED>;
  static bool configured = false;
  static int per_sm = 0;  // blocks of this instance an SM holds
  cudaError_t err = pq_allow_smem(kernel, smem, configured);
  if (err != cudaSuccess) return err;
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, AS_THREADS, smem);
    if (err != cudaSuccess) return err;
  }
  // a window's grid: the least span, in tiles, whose splits for rows that
  // have filled their windows fit one wave
  a.wave = per_sm * as_sms();
  a.span_big = 0;
  if (VAR > 0 && a.window > 0 && a.kpos == nullptr && a.sinks == 0) {
    auto splits = [&](int sp) {
      return std::min((a.S + sp - 1) / sp, (a.window + a.T - 2) / sp + 2);
    };
    int sp = Gm::SPAN;
    while ((long long)a.B * a.KV * splits(sp) > a.wave && sp < a.S) sp += Gm::KT;
    a.span_big = sp;
  }
  dim3 grid(a.n_split, a.KV, a.B);
  kernel<<<grid, AS_THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

// PAGED: decode rows (T = 1) of a group of at most 8, the paged wrapper's.
template <int DH, bool V4, int VAR, bool PAGED = false>
static cudaError_t as_rows(const AttnSplitArgs& a, cudaStream_t st) {
  const int R = a.T * (a.H / a.KV);
  if (R <= 1) return as_launch<DH, V4, VAR, 1, PAGED>(a, st);
  if (R <= 2) return as_launch<DH, V4, VAR, 2, PAGED>(a, st);
  if (R <= 4) return as_launch<DH, V4, VAR, 4, PAGED>(a, st);
  if constexpr (AsGeom<DH>::MAX_RB >= 8)
    if (R <= 8) return as_launch<DH, V4, VAR, 8, PAGED>(a, st);
  if constexpr (AsGeom<DH>::MAX_RB >= 16 && !PAGED)
    if (R <= 16) return as_launch<DH, V4, VAR, 16>(a, st);
  return cudaErrorInvalidValue;
}

// The split kernel of one instance family for every head dim.
template <bool V4, int VAR>
static cudaError_t as_dispatch(const AttnSplitArgs& a, cudaStream_t st) {
  switch (a.Dh) {
    case 32: return as_rows<32, V4, VAR>(a, st);
    case 64: return as_rows<64, V4, VAR>(a, st);
    case 128: return as_rows<128, V4, VAR>(a, st);
    case 256: return as_rows<256, V4, VAR>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

// The instance families, one nvcc each: attn_split_int8.cu (int8 V, VAR 0
// and 1), attn_split_ext.cu (int8 V, VAR 2), attn_split_k8v4.cu (packed V),
// attn_split_paged.cu (the paged pool: VAR 0, and VAR 2 for ALiBi).
cudaError_t attn_split_int8(const AttnSplitArgs& a, int var, cudaStream_t st);
cudaError_t attn_split_ext(const AttnSplitArgs& a, cudaStream_t st);
cudaError_t attn_split_k8v4(const AttnSplitArgs& a, cudaStream_t st);
cudaError_t attn_split_paged(const AttnSplitArgs& a, cudaStream_t st);
