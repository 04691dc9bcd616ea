// The register-resident row quantizer: an elementwise producer, then the
// rowquant contract on each row (s = max(amax / 127, 1e-12) by IEEE
// division, q = rint(v / s), half to even, clamped to +-127). Shared by
// csrc/rowquant.cu (the producer is the identity) and the SwiGLU producer
// of csrc/fused_quant.cu.
//
// Design:
// - A row is cut into ``C`` slices (C = 1 to RQ_MAX_BLOCKS), one block a
//   slice; with C > 1 the row's blocks are one thread block cluster.
//   ops/rowquant.py's plan picks C, the block's threads and the 16-byte
//   vectors a thread holds (R = 1, 2 or 4), and the C entry refuses a
//   plan whose blocks cannot hold the row.
// - From the row's first 16-byte boundary on, the row is a run of 16-byte
//   vectors (8 bf16 / f16 or 4 f32 values); slice r of C takes the vectors
//   [r n / C, (r + 1) n / C). Thread t of a block takes the vectors
//   lo + i threads + t (i < R): its R 16-byte loads are issued before any
//   arithmetic, so a block has its whole slice in flight at once, and
//   neighbouring threads read neighbouring addresses. The elements before
//   the boundary (the head, fewer than a vector: a row whose start is not
//   16-byte aligned, as every other row of an odd K is) are read one by one
//   by threads [0, head) of slice 0, those after the last whole vector (the
//   tail) by threads [V, V + tail) of slice C - 1.
// - The row stays in registers (the raw words, and the producer's values
//   where they cost more than a conversion to make again, two to a register
//   where they are 16-bit values): no row in shared memory, and the row is
//   read once. The absolute maximum is
//   reduced by warp shuffles, then over the block's warps through shared
//   memory. A maximum does not depend on order, and every code is
//   elementwise, so any cut of the row gives the plain version's bits.
// - With C > 1, each block stores its maximum into slot ``rank`` of every
//   block of the cluster (distributed shared memory) by st.async, which
//   completes 4 bytes of the target block's mbarrier transaction; a block
//   reads its own C slots once its mbarrier has counted 4 C bytes. The
//   mbarriers are made at the kernel's start, before a cluster barrier
//   whose (relaxed) arrive comes before the loads and whose wait comes
//   after them, so its latency hides behind theirs; no block stores into a
//   peer before that wait. A block never reads a peer's memory and leaves
//   only after every peer has stored into it, so no second barrier is
//   needed to keep shared memory alive. (Barriers after the reduction, as a
//   pull of the peers' maxima needs, made a cluster launch slower than one
//   block a row at every decode width but the widest: PERF.md.)
// - Codes leave as one 4-byte (f32 in) or 8-byte (bf16, f16 in) store a
//   vector where the codes' row is aligned as the input's is (as it is for
//   a fresh output and an aligned input), byte by byte otherwise. Division
//   is spelled __fdiv_rn and rounding rintf: no reciprocal multiply, which
//   would change bits.

#pragma once

#include "common.cuh"

constexpr int RQ_MAX_BLOCKS = 8;  // the portable cluster size

// The most threads a block of R vectors a thread, and the blocks an SM
// its registers are budgeted for: 1024 threads of 64 registers, two blocks
// of 768 threads of 40 (so that two rows of up to 1536 vectors share an SM
// at prefill), 512 of 128.
#define RQ_MAX_THREADS(R) ((R) >= 4 ? 512 : (R) >= 2 ? 768 : 1024)
#define RQ_MIN_BLOCKS(R) ((R) == 2 ? 2 : 1)

// A producer is a functor of the row's elements (one input's, or two
// inputs' pair) giving the f32 value to quantize. KEEP says whether the
// block keeps those values between the maximum and the codes, PER of them
// a Kept word (keep and restore, exactly), or makes them again from the
// raw words.
// The identity producer (B1): the row's value in f32, made again (a
// conversion).
struct RqIdentity {
  static constexpr bool KEEP = false;
  static constexpr int PER = 1;
  using Kept = float;
  template <typename T>
  __device__ __forceinline__ float operator()(T x, T) const {
    return pq_to_float(x);
  }
  __device__ __forceinline__ Kept keep(const float (&y)[PER]) const { return y[0]; }
  __device__ __forceinline__ float restore(Kept w, int) const { return w; }
};

template <typename T>
__device__ __forceinline__ uint4 rq_ld16(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// V values of T from a 16-byte word, element j at bytes [j sizeof(T), ...).
template <typename T>
__device__ __forceinline__ T rq_elem(const uint4& w, int j) {
  return reinterpret_cast<const T*>(&w)[j];
}

// The cluster's exchange of the blocks' maxima (row_quant.cuh's design
// note): an mbarrier a block, made ready before the loads; each block's
// maximum stored into slot ``rank`` of every block by st.async, which
// completes 4 bytes of that block's mbarrier transaction.
__device__ __forceinline__ unsigned rq_smem(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void rq_bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(rq_smem(bar)), "r"(1) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// This block's mbarrier expects ``bytes`` and counts this arrival.
__device__ __forceinline__ void rq_bar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(rq_smem(bar)),
               "r"(bytes)
               : "memory");
}

// ``v`` into ``slot`` of cluster block ``rank``, completing 4 bytes of
// that block's ``bar``.
__device__ __forceinline__ void rq_push(float* slot, uint64_t* bar, int rank, float v) {
  unsigned rs, rb;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rs) : "r"(rq_smem(slot)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rb) : "r"(rq_smem(bar)), "r"(rank));
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(rs),
               "r"(__float_as_uint(v)), "r"(rb)
               : "memory");
}

__device__ __forceinline__ void rq_bar_wait(uint64_t* bar) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(rq_smem(bar))
        : "memory");
  } while (!done);
}

__device__ __forceinline__ uint32_t rq_code(float v, float s) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -PQ_QMAX), PQ_QMAX);
  return (uint32_t)(int)q & 0xffu;
}

// One block's slice of one row: NIN inputs (1: a; 2: a and b, which
// ``op(a, b)`` combines) of rows of K values; the row's codes into ``q``
// and its scale into ``s_out`` (by rank 0). ``C``: a row's blocks (the
// cluster).
template <typename T, int R, int NIN, typename Op>
__device__ __forceinline__ void rq_row(const T* __restrict__ a, const T* __restrict__ b,
                                       int8_t* __restrict__ q, float* __restrict__ s_out, int K,
                                       int C, const Op& op) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float wmax[32];
  __shared__ float parts[RQ_MAX_BLOCKS];
  __shared__ __align__(8) uint64_t bar;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthreads >> 5;
  int rank = 0;
  size_t row = blockIdx.x;
  if (C > 1) {  // a block a row divides nothing (a uniform branch)
    rank = (int)(blockIdx.x % C);
    row = blockIdx.x / C;
    // the mbarrier made ready; arrive now, wait before the first remote store
    if (tid == 0) rq_bar_init(&bar);
    asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
  }

  const T* ar = a + row * K;
  const T* br = NIN == 2 ? b + row * K : nullptr;
  // the row's head, whole vectors and tail, and this block's vectors
  const int head = min(K, (int)(((16u - ((unsigned)(uintptr_t)ar & 15u)) & 15u) / sizeof(T)));
  const int nvec = (K - head) / V;
  const int tail = K - head - nvec * V;
  int v0 = 0, v1 = nvec;
  if (C > 1) {
    v0 = rank * nvec / C;
    v1 = (rank + 1) * nvec / C;
  }
  const T* av = ar + head;
  const T* bv = NIN == 2 ? br + head : nullptr;
  // b's vectors are read whole where b's rows are aligned as a's, else by
  // element (a launch-wide property: both advance K elements a row)
  const bool b_whole = NIN == 2 && (((uintptr_t)bv & 15u) == 0);
  uint4 ra[R], rb[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int j = v0 + i * nthreads + tid;
    if (j < v1) {
      ra[i] = rq_ld16(av + (size_t)j * V);
      if (NIN == 2) {
        if (b_whole) {
          rb[i] = rq_ld16(bv + (size_t)j * V);
        } else {
          T* e = reinterpret_cast<T*>(&rb[i]);
#pragma unroll
          for (int k = 0; k < V; ++k) e[k] = bv[(size_t)j * V + k];
        }
      }
    }
  }
  // the one head or tail element this thread may hold
  int ei = -1;
  if (rank == 0 && tid < head) ei = tid;
  if (rank == C - 1 && tid >= V && tid < V + tail) ei = head + nvec * V + (tid - V);

  // the producer's value of element k of vector i: made once and kept where
  // it costs (SwiGLU), made again from the raw word where it is one
  // conversion (the identity), so the block holds the row in fewer registers
  constexpr bool KEEP = Op::KEEP;
  constexpr int PER = Op::PER;
  typename Op::Kept f[KEEP ? R : 1][V / PER];
  auto value = [&](int i, int k) {
    return op(rq_elem<T>(ra[i], k), NIN == 2 ? rq_elem<T>(rb[i], k) : rq_elem<T>(ra[i], k));
  };
  const float e = ei >= 0 ? op(ar[ei], NIN == 2 ? br[ei] : ar[ei]) : 0.0f;
  float amax = fabsf(e);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int j = v0 + i * nthreads + tid;
    if (j < v1) {
#pragma unroll
      for (int k = 0; k < V; k += PER) {
        float y[PER];
#pragma unroll
        for (int p = 0; p < PER; ++p) {
          y[p] = value(i, k + p);
          amax = fmaxf(amax, fabsf(y[p]));
        }
        if constexpr (KEEP) f[i][k / PER] = op.keep(y);
      }
    }
  }

  // the row's absolute maximum: warps, the block, then the cluster
  amax = pq_warp_max(amax);
  if (lane == 0) wmax[warp] = amax;
  __syncthreads();
  amax = pq_warp_max(lane < nwarps ? wmax[lane] : 0.0f);
  if (C > 1) {
    // every block's mbarrier is ready (made before its arrive, which came
    // before its loads); this block's maximum into slot rank of every
    // block; each lane l < C of every warp reads slot l once this block's C
    // slots have landed
    asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
    if (tid == 0) rq_bar_expect(&bar, 4 * C);
    if (tid < C) rq_push(&parts[rank], &bar, tid, amax);
    rq_bar_wait(&bar);
    amax = pq_warp_max(lane < C ? parts[lane] : 0.0f);
  }
  const float s = fmaxf(__fdiv_rn(amax, PQ_QMAX), PQ_SCALE_EPS);

  // the codes: the input row is 16-byte aligned at its head, the codes' row
  // there is V-byte aligned where q and a share their offset mod V
  int8_t* qr = q + row * K;
  int8_t* qv = qr + head;
  const bool whole = (((uintptr_t)qv) & (V - 1)) == 0;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int j = v0 + i * nthreads + tid;
    if (j < v1) {
      uint32_t c[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if constexpr (KEEP)
          c[k] = rq_code(op.restore(f[i][k / PER], k % PER), s);
        else
          c[k] = rq_code(value(i, k), s);
      }
      uint32_t w[V / 4];
#pragma unroll
      for (int k = 0; k < V / 4; ++k)
        w[k] = c[4 * k] | c[4 * k + 1] << 8 | c[4 * k + 2] << 16 | c[4 * k + 3] << 24;
      int8_t* dst = qv + (size_t)j * V;
      if (whole) {
        if (V == 8)
          *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[V / 4 - 1]);
        else
          *reinterpret_cast<uint32_t*>(dst) = w[0];
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) dst[k] = (int8_t)(w[k / 4] >> (8 * (k % 4)));
      }
    }
  }
  if (ei >= 0) qr[ei] = (int8_t)rq_code(e, s);
  if (rank == 0 && tid == 0) s_out[row] = s;
}

// Launch ``kernel`` over ``rows`` rows of ``blocks`` blocks each (a
// cluster where blocks > 1) of ``threads`` threads.
template <typename Kernel, typename... Args>
static cudaError_t rq_launch(Kernel kernel, int rows, int blocks, int threads,
                            cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)rows * (unsigned)blocks);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = blocks > 1 ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Whether a plan can run: blocks in [1, RQ_MAX_BLOCKS], R in {1, 2, 4},
// threads a multiple of 32 in [32, RQ_MAX_THREADS(R)], and each block's
// threads x R vectors holding its share of the row's whole vectors (at
// most K / V of them, whatever the row's alignment).
static bool rq_plan_ok(int K, int V, int blocks, int threads, int R) {
  if (K <= 0 || blocks < 1 || blocks > RQ_MAX_BLOCKS) return false;
  if (R != 1 && R != 2 && R != 4) return false;
  if (threads < 32 || threads > RQ_MAX_THREADS(R) || threads % 32 != 0) return false;
  const long long nvec = K / V;
  return (nvec + blocks - 1) / blocks <= (long long)threads * R;
}
