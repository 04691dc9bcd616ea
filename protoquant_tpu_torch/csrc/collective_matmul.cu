// Ring reduce-scatter int8 matmul: the row-parallel reduction of tensor
// parallelism as one kernel.
//
// Replaces protoquant_tpu/ops/collective_matmul.py:_ring_kernel (Pallas,
// explicit remote DMAs between TPU chips). Rank d of tp holds xq_d [M, K]
// (its K/tp slice of the activations), s_x_d [M], wq_d [N, K] (its K rows of
// the weight, in the port's [N, K] layout) and s_w [N]; it ends with chunk d
// of the reduced product, out_d [M, nc] with nc = N / tp:
//   A_d[e]   = (float(xq_d . wq_d[e*nc:(e+1)*nc]^T) * s_x_d) * s_w[e*nc:...]
//   out_e    = ((A_{e+1}[e] + A_{e+2}[e]) + ...) + A_e[e]   (indices mod tp)
// the ring order of parallel/collective.py: the partial of chunk e starts at
// rank e + 1 and hops to the right, each rank adding its own product.
//
// Bound on the H100: bytes. At decode (M = 4) the ranks read the whole
// row-parallel weight once (N * K int8 over all ranks); the partials are
// M * N * 4 bytes a hop.
//
// Design. A thread block cluster of CS blocks (1-8; ops/gemm_plan.py
// ring_plan) owns tile t (columns t*64.. of every chunk) of rank rank_base +
// z (blockIdx.z; all ranks on one card are one launch) and splits the
// rank's K between its blocks in whole 64-byte steps: block q of the
// cluster takes the steps [q steps / CS, (q + 1) steps / CS). Ring step s
// has its chunk e = (r - 1 - s) mod tp. Its product is the split-K decode
// GEMM's (int8_mma.cuh: out^T = W x^T through mma.sync m16n8k32, 16 weight
// rows a warp, 4 warps a block, the weight straight into registers a group
// of steps ahead), for MF fragments of 8 tokens. A unit is a step's product
// for up to 8 MF token rows: each block writes its int32 partial to one of
// two tiles of shared memory (alternating, so a unit's product overlaps the
// other blocks' sums of the one before); after a cluster barrier block q
// sums the CS partials of its 1 / CS of the tile in rank order through
// distributed shared memory (int32 addition is exact, so the bits do not
// depend on CS), applies the epilogue with __fmul_rn (never contracted into
// an FMA), adds the received partial with __fadd_rn (received + own, the
// plain version's order) and either stores the sum into the right rank's
// receive slot (s + 1) % 2 or, at the last step, writes out. A step's
// first unit is computed before its wait, so the product overlaps the
// neighbour's hop, and each unit's first loads are issued before the
// previous unit's barrier, wait and sums. Two routes, chosen by M before
// launch by the caller (ops/collective_matmul.py ring_fragments, which
// owns the threshold), named by MF, the fragments of 8 tokens of a unit:
//  - decode (MF = 1, 2, 4; M <= 8 MF): a step is one unit, the tokens read
//    from global memory through L1 (QdStream).
//  - prefill (MF = 8, any M): a step walks the token rows in units of 64;
//    the tokens of each group of 4 steps are staged in shared memory by
//    cp.async (two buffers, the next group's in flight) and read by all 4
//    warps from there, which leaves the registers for the weight of 4 steps
//    ahead (RingStaged).
// Tried and dropped (tools/gemm_timing.py --ring --ablate, PERF.md): every
// step's product computed before the first wait, into tp partial tiles (no
// faster than a step at a time); the prefill weight read through L2 with
// ld.cg for the next token groups' re-reads (no faster than ld.cs).
//
// Protocol. Two receive slots per rank ([2][M][nc] f32) and, per slot and
// tile, a data flag (written by the left rank) and a credit flag (written by
// the right rank into the sender's array), 32-bit counters. A flag guards a
// tile, i.e. a cluster:
//  - Each flag holds how many times its slot has been filled (data) or read
//    (credit) since the flags were made. A call knows those counts from its
//    epoch (1, 2, ... per flag set, passed by the host): a call fills slot
//    sl uses(tp - 1, sl) times, so before call E the count is (E - 1) times
//    that. Nothing is ever reset, so no reset can race the next call.
//  - A receiver waits until its data flag equals the count its step needs;
//    a sender waits, before it fills the right rank's slot, until its credit
//    flag says the right rank has read that slot's previous contents (the
//    TPU kernel's credit_sem). So a rank that runs ahead never lands in a
//    slot its neighbour still reads, also across calls.
//  - Thread 0 of every block of the cluster reads the flags with
//    ld.acquire.sys before a block barrier; after a cluster barrier
//    (barrier.cluster.arrive.release / wait.acquire: every block's share of
//    the step stored, every slot read) the cluster's leader (block 0,
//    thread 0) stores the data flag with st.release.sys, and another thread
//    (on another SM where the cluster has one) the credit flag, side by
//    side. No fence precedes either release. The rule this relies on is
//    the PTX memory model's (PTX ISA, "Memory Consistency Model": base
//    causality order and the Causality axiom): base causality order is
//    transitive over program order and synchronizes-with. A block's slot
//    reads and its stores of the step's sums precede its
//    barrier.cluster.arrive.release in program order; that arrive
//    synchronizes with the releasing thread's barrier.cluster.wait.acquire
//    (cluster scope), which precedes its st.release.sys in program order;
//    and that release synchronizes with the neighbour's ld.acquire.sys that
//    reads the flag's value (both system scope, so morally strong), which
//    precedes the neighbour's block barrier and its reads (or writes) of
//    the slot. So every store of the step precedes every read of it in
//    causality order and is seen, and no read sees a later refill. A
//    fence.sc.sys before each release is not needed and cost 3-5 us a
//    step. Partials move with ld/st.cg (L2, never a stale L1 line). System
//    scope lets the same body serve peer memory on other cards later; the
//    fenceless release has run only with every rank on one card, so it is
//    to be checked again on peer memory.
//  - Every wait is bounded (SPIN_NS): a protocol fault traps, the launch
//    fails, and the wrapper raises; it never hangs.
// Co-residence: a block spins on its neighbours' clusters, so every block of
// the launch must be resident at once. The launch carries the cooperative
// attribute beside the cluster dimension (cudaLaunchKernelEx): CUDA refuses
// a grid whose clusters the card cannot hold at once.
//
// Ablations (-DPQ_RING_ABLATE, timing only; tools/gemm_timing.py --ring
// --ablate): 1 the prefill route's tokens read from global memory as the
// decode route's (no staging), 2 no flags (no waits, no releases: the hops
// race), 3 no hop (no flags; each step stores its own sums to out), 4 loads
// alone (the MMAs replaced by an XOR of the loaded words).

#include <cooperative_groups.h>

#include <cstdio>
#include <type_traits>

#ifndef PQ_RING_ABLATE
#define PQ_RING_ABLATE 0
#endif
#if PQ_RING_ABLATE == 4
#define PQ_QD_LOADS_ALONE
#endif
#include "int8_mma.cuh"

namespace cg = cooperative_groups;

constexpr int RING_MAX = 8;
constexpr unsigned long long SPIN_NS = 2000000000ull;  // 2 s
constexpr int RING_PREFILL_MF = 8;     // 64 token rows a unit on the prefill route
constexpr int RING_STAGE_STEPS = 4;    // steps of a staged token group (prefill)
// blocks an SM the registers must allow (at most 168 a thread): left to
// itself ptxas takes 212-250 for every instance, two blocks an SM
constexpr int RING_MIN_BLOCKS = 3;
// a staged token row: 4 steps and 64 bytes of padding, so the two rows that
// one quarter-warp reads sit 64 bytes apart modulo 128 (no bank conflict)
constexpr int RING_STAGE_ROW = RING_STAGE_STEPS * QD_STEP + 64;
constexpr int RING_STAGE_BYTES = 8 * RING_PREFILL_MF * RING_STAGE_ROW;  // one buffer

struct RingParams {
  const int8_t* xq[RING_MAX];  // by local rank: [M, K]
  const float* sx[RING_MAX];   // [M]
  const int8_t* wq[RING_MAX];  // [N, K]
  const float* sw[RING_MAX];   // [N]
  float* out[RING_MAX];        // [M, nc]
  float* comm[RING_MAX];       // by ring rank: [2][M][nc] receive slots
  unsigned* data[RING_MAX];    // by ring rank: [2][tiles]
  unsigned* credit[RING_MAX];  // by ring rank: [2][tiles]
  int tp, rank_base, M, N, K, nc;
  int vec4;  // nc % 4 == 0 and out, comm 16-byte aligned: partials move 16 bytes at a time
  unsigned epoch;
};

__device__ __forceinline__ unsigned ld_acquire_sys(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(unsigned* p, unsigned v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until *flag == want, at most SPIN_NS; then trap.
__device__ void wait_flag(const unsigned* flag, unsigned want, const char* what, int rank,
                          int tile, int step) {
  if (ld_acquire_sys(flag) == want) return;
  const unsigned long long t0 = global_ns();
  unsigned got;
  while ((got = ld_acquire_sys(flag)) != want) {
    __nanosleep(100);
    if (global_ns() - t0 > SPIN_NS) {
      printf("pq_ring_qmatmul_rs: rank %d tile %d step %d waited for %s %u, holds %u\n", rank,
             tile, step, what, want, got);
      __trap();
    }
  }
}

// Ring steps 1..upto that read receive slot sl (steps of parity sl).
__device__ __forceinline__ unsigned slot_uses(int upto, int sl) {
  return sl ? (unsigned)(upto + 1) / 2 : (unsigned)upto / 2;
}

// Times slot sl has been filled (and read) after step s of call `epoch`.
__device__ __forceinline__ unsigned slot_count(unsigned epoch, int tp, int s, int sl) {
  return (epoch - 1u) * slot_uses(tp - 1, sl) + slot_uses(s, sl);
}

// The prefill route's QdStream: the thread's share over the steps [s_lo,
// s_hi) for the 64 token rows m0.. of X [M, K], the weight straight into
// registers (w0, w1 at byte 16 t) a group of RING_STAGE_STEPS ahead, each
// group's tokens staged by every thread of the block with cp.async into
// tok[group parity] (zeros past M, K and s_hi) and read from there. start()
// issues the first group's loads (the token buffers free: every warp past
// the last finish()), finish(acc) the rest; every thread of the block calls
// both.
struct RingStaged {
  static constexpr int U = RING_STAGE_STEPS, MF = RING_PREFILL_MF, CHUNKS = 8 * MF * U * 4;
  int4 wa[2][U], wb[2][U];
  const int8_t *w0, *w1, *X;
  int8_t* tok;
  bool ok0, ok1;
  int m0, M, s_lo, s_hi, K;

  __device__ __forceinline__ void load(int buf, int s0) {
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = s0 + u;
      const size_t off = (size_t)s * QD_STEP;
      const bool in = s < s_hi && s * QD_STEP + 16 * t < K;
      wa[buf][u] = qd_load_w(w0 + off, ok0 && in);
      wb[buf][u] = qd_load_w(w1 + off, ok1 && in);
    }
    int8_t* dst = tok + buf * RING_STAGE_BYTES;
    for (int c = threadIdx.x; c < CHUNKS; c += QD_THREADS) {  // 16-byte chunks, row-major
      const int row = c / (U * 4), kc = c % (U * 4);
      const int s = s0 + kc / 4, kb = s * QD_STEP + (kc % 4) * 16;
      const bool ok = m0 + row < M && s < s_hi && kb < K;
      pq_cp_async16(dst + row * RING_STAGE_ROW + kc * 16,
                 X + (ok ? (size_t)(m0 + row) * K + kb : 0), ok);
    }
    pq_cp_async_commit();
  }

  __device__ __forceinline__ void mma(int (&acc)[MF][4], int buf) {
    const int t = threadIdx.x & 3, g = (threadIdx.x >> 2) & 7;
    const int8_t* src = tok + buf * RING_STAGE_BYTES + g * RING_STAGE_ROW + 16 * t;
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int f = 0; f < MF; ++f) {
        const int4 x = *reinterpret_cast<const int4*>(src + 8 * f * RING_STAGE_ROW + u * QD_STEP);
#ifdef PQ_QD_LOADS_ALONE
        acc[f][0] ^= wa[buf][u].x ^ wb[buf][u].w ^ x.x ^ x.w;
#else
        qd_step(acc[f], wa[buf][u], wb[buf][u], x);
#endif
      }
  }

  __device__ __forceinline__ void start(const int8_t* w0_, const int8_t* w1_, bool ok0_,
                                        bool ok1_, const int8_t* X_, int m0_, int M_, int s_lo_,
                                        int s_hi_, int K_, int8_t* tok_) {
    w0 = w0_, w1 = w1_, ok0 = ok0_, ok1 = ok1_, X = X_, m0 = m0_, M = M_;
    s_lo = s_lo_, s_hi = s_hi_, K = K_, tok = tok_;
    if (s_lo < s_hi) load(0, s_lo);
  }

  __device__ __forceinline__ void finish(int (&acc)[MF][4]) {
    const int groups = (s_hi - s_lo + U - 1) / U;
    int gi = 0;
    for (; gi + 2 <= groups; gi += 2) {  // two groups an iteration: the buffers stay in registers
      load(1, s_lo + (gi + 1) * U);
      pq_cp_async_wait<1>();
      __syncthreads();  // group gi's tokens staged
      mma(acc, 0);
      __syncthreads();  // every warp done with buffer 0
      if (gi + 2 < groups) {
        load(0, s_lo + (gi + 2) * U);
        pq_cp_async_wait<1>();
      } else {
        pq_cp_async_wait<0>();
      }
      __syncthreads();
      mma(acc, 1);
      __syncthreads();
    }
    if (gi < groups) {
      pq_cp_async_wait<0>();
      __syncthreads();
      mma(acc, 0);
      __syncthreads();
    }
  }
};

template <int MF>
__global__ void __launch_bounds__(QD_THREADS, RING_MIN_BLOCKS)
    ring_kernel(const __grid_constant__ RingParams p) {
  // [2][8 MF tokens][QD_ROWS columns] int32 partials, then on the prefill
  // route [2][64 tokens][RING_STAGE_ROW] staged token bytes
  extern __shared__ __align__(16) int part_smem[];
  constexpr bool STAGED = MF == RING_PREFILL_MF && PQ_RING_ABLATE != 1;
  constexpr int TOKENS = 8 * MF;
  constexpr int E = TOKENS * QD_ROWS;  // elements of a unit's tile
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), crank = (int)cluster.block_rank();
  const int z = blockIdx.z, tp = p.tp, r = p.rank_base + z;
  const int right = (r + 1) % tp, left = (r + tp - 1) % tp;
  const int tile = blockIdx.x / cs, tiles = gridDim.x / cs, c0 = tile * QD_ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int M = p.M, K = p.K, nc = p.nc;
  const int steps = (K + QD_STEP - 1) / QD_STEP;
  const int s_lo = (int)((long long)crank * steps / cs);
  const int s_hi = (int)((long long)(crank + 1) * steps / cs);
  const size_t slot = (size_t)M * nc;
  const int8_t* X = p.xq[z];
  const int8_t* W = p.wq[z];
  const float* sx = p.sx[z];
  const float* sw = p.sw[z];
  // the thread's two weight rows, as columns of a chunk
  const int n0 = c0 + warp * 16 + g, n1 = n0 + 8;
  const bool ok0 = n0 < nc, ok1 = n1 < nc;
  auto chunk = [&](int s) { return ((r - 1 - s) % tp + tp) % tp; };

  // Unit u: step u / groups, token rows (u % groups) * TOKENS.. Its loads
  // start early (start(u)); qd_partial computes the block's int32 partial
  // into part ([token][column]).
  const int groups = (M + TOKENS - 1) / TOKENS, units = tp * groups;
  using Stream = std::conditional_t<STAGED, RingStaged, QdStream<MF>>;
  Stream st;
  auto start = [&](int u) {
    const int e = chunk(u / groups), m0 = u % groups * TOKENS;
    const int8_t* w0 = W + (size_t)(e * nc + (ok0 ? n0 : 0)) * K + 16 * t;
    const int8_t* w1 = W + (size_t)(e * nc + (ok1 ? n1 : 0)) * K + 16 * t;
    if constexpr (STAGED) {
      st.start(w0, w1, ok0, ok1, X, m0, M, s_lo, s_hi, K,
               reinterpret_cast<int8_t*>(part_smem + 2 * E));
    } else {
      const int8_t* xr[MF];
      bool okx[MF];
#pragma unroll
      for (int f = 0; f < MF; ++f) {
        const int m = m0 + 8 * f + g;
        okx[f] = m < M;
        xr[f] = X + (size_t)(okx[f] ? m : 0) * K + 16 * t;
      }
      st.start(w0, w1, ok0, ok1, xr, okx, s_lo, s_hi, K);
    }
  };

  // Before step s touches the slots: the left rank's partial has arrived
  // (data) and the right rank has read what this rank last put in its slot
  // (credit).
  auto wait_step = [&](int s) {
#if PQ_RING_ABLATE != 2 && PQ_RING_ABLATE != 3
    if (threadIdx.x == 0) {
      const int recv = s & 1, send = (s + 1) & 1;
      if (s > 0)
        wait_flag(&p.data[r][recv * tiles + tile], slot_count(p.epoch, tp, s, recv), "data", r,
                  tile, s);
      if (s + 1 < tp)
        wait_flag(&p.credit[r][send * tiles + tile], slot_count(p.epoch, tp, s + 1, send) - 1u,
                  "credit", r, tile, s);
    }
    __syncthreads();
#endif
  };

  // Block crank's share of step s's unit at token rows m0..: the cluster's
  // partials summed in rank order (qd_sum_partials), the epilogue, the
  // received partial added, then forwarded or written out (consecutive
  // threads, consecutive columns).
  auto serve = [&](int s, int m0, const int* part) {
    const int e = chunk(s);
    const bool adds = s > 0 && PQ_RING_ABLATE != 3, forwards = s + 1 < tp && PQ_RING_ABLATE != 3;
    const float* in = p.comm[r] + (s & 1) * slot;
    float* fwd = p.comm[right] + ((s + 1) & 1) * slot;
    float* out = p.out[z];
    constexpr int V = E / 4;  // 16-byte vectors of 4 columns
    const int v0 = crank * V / cs, v1 = (crank + 1) * V / cs;
    for (int v = v0 + threadIdx.x; v < v1; v += QD_THREADS) {
      const int m = m0 + 4 * v / QD_ROWS, cv = c0 + 4 * v % QD_ROWS;
      if (m >= M || cv >= nc) continue;
      const int4 q = qd_sum_partials(part, v, cs);
      const int sum[4] = {q.x, q.y, q.z, q.w};
      const float sxm = sx[m];
      const size_t idx = (size_t)m * nc + cv;
      if (p.vec4) {  // the 4 columns exist and lie 16-byte aligned
        float y[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          y[j] = __fmul_rn(__fmul_rn(__int2float_rn(sum[j]), sxm), sw[e * nc + cv + j]);
        if (adds) {
          const float4 a = __ldcg(reinterpret_cast<const float4*>(in + idx));
          y[0] = __fadd_rn(a.x, y[0]);
          y[1] = __fadd_rn(a.y, y[1]);
          y[2] = __fadd_rn(a.z, y[2]);
          y[3] = __fadd_rn(a.w, y[3]);
        }
        const float4 o = make_float4(y[0], y[1], y[2], y[3]);
        if (forwards)
          __stcg(reinterpret_cast<float4*>(fwd + idx), o);
        else
          *reinterpret_cast<float4*>(out + idx) = o;
        continue;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cv + j;
        if (c >= nc) break;
        float y = __fmul_rn(__fmul_rn(__int2float_rn(sum[j]), sxm), sw[e * nc + c]);
        if (adds) y = __fadd_rn(__ldcg(in + idx + j), y);
        if (forwards)
          __stcg(fwd + idx + j, y);
        else
          out[idx + j] = y;
      }
    }
  };

  // After a cluster barrier (every block's share of step s stored, every
  // slot read): the right rank may read, the left rank may refill. The
  // data flag is stored by the leader (block 0, thread 0), the credit flag
  // by thread 0 of the cluster's last block (thread 32 of a lone block), so
  // the two releases' system-scope waits run side by side.
  auto release_step = [&](int s) {
#if PQ_RING_ABLATE != 2 && PQ_RING_ABLATE != 3
    const int recv = s & 1, send = (s + 1) & 1;
    if (crank == 0 && threadIdx.x == 0 && s + 1 < tp)
      st_release_sys(&p.data[right][send * tiles + tile], slot_count(p.epoch, tp, s + 1, send));
    if (crank == cs - 1 && threadIdx.x == (cs == 1 ? 32 : 0) && s > 0)
      st_release_sys(&p.credit[left][recv * tiles + tile], slot_count(p.epoch, tp, s, recv));
#endif
  };

  start(0);
  for (int u = 0; u < units; ++u) {
    const int s = u / groups, m0 = u % groups * TOKENS;
    int* part = part_smem + (u & 1) * E;  // the partial tiles alternate
    qd_partial<MF>(st, part);
    if (u + 1 < units) start(u + 1);  // its loads fly while this unit is served
    cluster.sync();  // every block's partial written, the other tile's sums done
    if (m0 == 0) wait_step(s);
    serve(s, m0, part);
    if (m0 + TOKENS >= M) {
      cluster.sync();  // the step stored and read; the last keeps shared memory alive
      release_step(s);
    }
  }
}

// Shared memory of ring_kernel<MF>: two partial tiles, and on the staged
// prefill route two token buffers.
template <int MF>
constexpr int ring_smem() {
  return 2 * 8 * MF * QD_ROWS * (int)sizeof(int) +
         (MF == RING_PREFILL_MF && PQ_RING_ABLATE != 1 ? 2 * RING_STAGE_BYTES : 0);
}

// The launch of ring_kernel<MF> over tiles x tp_local clusters of `splits`
// blocks; with `clusters` set, only the clusters of that launch the card
// holds at once (cudaOccupancyMaxActiveClusters).
template <int MF>
static cudaError_t ring_run(const RingParams& p, int tiles, int tp_local, int splits,
                            cudaStream_t stream, int* clusters) {
  static bool smem_set = false;
  auto kernel = ring_kernel<MF>;
  cudaError_t err = pq_allow_smem(kernel, ring_smem<MF>(), smem_set);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles * splits), 1, (unsigned)tp_local);
  cfg.blockDim = dim3(QD_THREADS);
  cfg.dynamicSmemBytes = (size_t)ring_smem<MF>();
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  if (clusters != nullptr)
    return cudaOccupancyMaxActiveClusters(clusters, reinterpret_cast<const void*>(kernel), &cfg);
  // The result is this launch's alone: the host keeps the call's epoch only
  // if it launched. A refused launch leaves no error behind for the next.
  cudaGetLastError();
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

// The instance of MF fragments: 1, 2, 4 (decode) or RING_PREFILL_MF.
static cudaError_t ring_dispatch(const RingParams& p, int mf, int tiles, int tp_local,
                                 int splits, cudaStream_t stream, int* clusters) {
  switch (mf) {
    case 1: return ring_run<1>(p, tiles, tp_local, splits, stream, clusters);
    case 2: return ring_run<2>(p, tiles, tp_local, splits, stream, clusters);
    case 4: return ring_run<4>(p, tiles, tp_local, splits, stream, clusters);
    case RING_PREFILL_MF: return ring_run<RING_PREFILL_MF>(p, tiles, tp_local, splits, stream,
                                                           clusters);
    default: return cudaErrorInvalidValue;
  }
}

// Pointer arrays: xq, sx, wq, sw and out by local rank (tp_local of them,
// ranks rank_base ..), comm, data and credit by ring rank (tp of them).
// mf: the instance, 1, 2 or 4 fragments of 8 tokens (decode; M at most 8
// mf) or 8 (prefill), as ops/collective_matmul.py ring_fragments picks it.
// k_splits: the blocks of a cluster, 1 to 8 and at most the K steps
// (ops/gemm_plan.py ring_plan). A grid whose clusters the card cannot hold
// at once is refused at launch (cudaErrorCooperativeLaunchTooLarge).
PQ_EXPORT int pq_ring_qmatmul_rs(const void* const* xq, const void* const* sx,
                                 const void* const* wq, const void* const* sw,
                                 void* const* out, void* const* comm, void* const* data,
                                 void* const* credit, int tp, int rank_base, int tp_local,
                                 int M, int N, int K, int mf, int k_splits, unsigned epoch,
                                 void* stream) {
  const int steps = (K + QD_STEP - 1) / QD_STEP;
  if (tp < 1 || tp > RING_MAX || tp_local < 1 || rank_base < 0 || rank_base + tp_local > tp ||
      N % tp != 0 || K % 16 != 0 || epoch == 0 || k_splits < 1 || k_splits > QD_MAX_SPLITS ||
      (k_splits > 1 && k_splits > steps) || (mf < RING_PREFILL_MF && M > 8 * mf))
    return cudaErrorInvalidValue;
  if (M == 0) return cudaSuccess;
  RingParams p = {};
  for (int z = 0; z < tp_local; ++z) {
    p.xq[z] = (const int8_t*)xq[z];
    p.sx[z] = (const float*)sx[z];
    p.wq[z] = (const int8_t*)wq[z];
    p.sw[z] = (const float*)sw[z];
    p.out[z] = (float*)out[z];
  }
  for (int r = 0; r < tp; ++r) {
    p.comm[r] = (float*)comm[r];
    p.data[r] = (unsigned*)data[r];
    p.credit[r] = (unsigned*)credit[r];
  }
  p.tp = tp;
  p.rank_base = rank_base;
  p.M = M;
  p.N = N;
  p.K = K;
  p.nc = N / tp;
  p.epoch = epoch;
  p.vec4 = p.nc % 4 == 0;
  for (int z = 0; z < tp_local; ++z) p.vec4 &= (uintptr_t)p.out[z] % 16 == 0;
  for (int r = 0; r < tp; ++r) p.vec4 &= (uintptr_t)p.comm[r] % 16 == 0;
  const int tiles = (p.nc + QD_ROWS - 1) / QD_ROWS;
  return ring_dispatch(p, mf, tiles, tp_local, k_splits, (cudaStream_t)stream, nullptr);
}

// The clusters of k_splits blocks that the card holds at once of the
// kernel instance of mf fragments (its route, its shared memory) for a ring
// of tp, for the plan; launches nothing.
PQ_EXPORT int pq_ring_qmatmul_rs_clusters(int mf, int tp, int k_splits, int* clusters) {
  if (tp < 1 || tp > RING_MAX || k_splits < 1 || k_splits > QD_MAX_SPLITS)
    return cudaErrorInvalidValue;
  RingParams p = {};
  p.tp = tp;
  return ring_dispatch(p, mf, 64, 1, k_splits, nullptr, clusters);
}
