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
// Design. Block (t, 0, z) is tile t (columns t*64.. of every chunk) of rank
// rank_base + z; all ranks on one card are one launch. At ring step s it
// computes its tile of chunk e = (r - 1 - s) mod tp (the 64 x 64 int8 tile
// product of int8_mma.cuh, row block by row block), applies the epilogue
// with __fmul_rn (never contracted into an FMA), waits for the left rank's
// partial in its receive slot s % 2, adds its own with __fadd_rn (received
// + own, the plain version's order), and either stores the sum into the
// right rank's receive slot (s + 1) % 2 and signals it, or, at the last
// step, writes out. The local product is computed before the wait, so it
// overlaps the neighbour's hop.
//
// Protocol. Two receive slots per rank ([2][M][nc] f32) and, per slot and
// tile, a data flag (written by the left rank) and a credit flag (written by
// the right rank into the sender's array), 32-bit counters:
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
//  - Flags are stored with st.release.sys after a block barrier and a
//    system fence, and read with ld.acquire.sys by one thread before a
//    block barrier; partials move with ld/st.cg (L2, never a stale L1
//    line). System scope lets the same body serve peer memory on other
//    cards later.
//  - Every wait is bounded (SPIN_NS): a protocol fault traps, the launch
//    fails, and the wrapper raises; it never hangs.
// Co-residence: a block spins on its neighbours' blocks, so every block of
// the launch must be resident at once. The launch is cooperative
// (cudaLaunchCooperativeKernel), which refuses a grid that does not fit.
//
// Bound on the H100: bytes. At decode (M = 4) the ranks read the whole
// row-parallel weight once (N * K int8 over all ranks); the partials are
// M * N * 4 bytes per hop. A launch over one card puts N / 64 blocks on the
// card (64 at N = 4096); a later version splits K to put more there.

#include <cstdio>

#include "int8_mma.cuh"

constexpr int RING_MAX = 8;
constexpr unsigned long long SPIN_NS = 2000000000ull;  // 2 s

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

__global__ void __launch_bounds__(QM_THREADS) ring_kernel(const __grid_constant__ RingParams p) {
  __shared__ __align__(16) int8_t As[2][BM][LDS];
  __shared__ __align__(16) int8_t Bs[2][BN][LDS];

  const int z = blockIdx.z, tp = p.tp, r = p.rank_base + z;
  const int right = (r + 1) % tp, left = (r + tp - 1) % tp;
  const int tile = blockIdx.x, tiles = gridDim.x, c0 = tile * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int g = lane >> 2, t = lane & 3;
  const size_t slot = (size_t)p.M * p.nc;
  const int8_t* A = p.xq[z];
  const float* sx = p.sx[z];
  const float* sw = p.sw[z];

  for (int s = 0; s < tp; ++s) {
    const int e = ((r - 1 - s) % tp + tp) % tp;
    const int n0 = e * p.nc + c0;  // first weight row (output column) of the tile
    const int recv = s & 1, send = (s + 1) & 1;
    const bool adds = s > 0, forwards = s + 1 < tp;
    const float* in = p.comm[r] + recv * slot;
    float* fwd = p.comm[right] + send * slot;
    for (int m0 = 0; m0 < p.M; m0 += BM) {
      int acc[2][4][4];
      int8_tile_mma(acc, As, Bs, A, p.wq[z], p.M, p.N, p.K, m0, n0);
      if (m0 == 0) {
        if (threadIdx.x == 0) {
          if (adds)
            wait_flag(&p.data[r][recv * tiles + tile], slot_count(p.epoch, tp, s, recv),
                      "data", r, tile, s);
          if (forwards)
            wait_flag(&p.credit[r][send * tiles + tile],
                      slot_count(p.epoch, tp, s + 1, send) - 1u, "credit", r, tile, s);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + wm + i * 16 + g + 8 * h;
          if (row >= p.M) continue;
          const float sxr = sx[row];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const int col = wn + j * 8 + 2 * t + q;  // within the tile
              if (c0 + col >= p.nc) continue;
              float v = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h + q]), sxr),
                                  sw[n0 + col]);
              const size_t idx = (size_t)row * p.nc + c0 + col;
              if (adds) v = __fadd_rn(__ldcg(in + idx), v);
              if (forwards)
                __stcg(fwd + idx, v);
              else
                p.out[z][idx] = v;
            }
          }
        }
      }
    }
    __syncthreads();  // every partial of this step is stored, every slot read
    if (threadIdx.x == 0) {
      __threadfence_system();
      if (forwards)
        st_release_sys(&p.data[right][send * tiles + tile], slot_count(p.epoch, tp, s + 1, send));
      if (adds)
        st_release_sys(&p.credit[left][recv * tiles + tile], slot_count(p.epoch, tp, s, recv));
    }
  }
}

// Pointer arrays: xq, sx, wq, sw and out by local rank (tp_local of them,
// ranks rank_base ..), comm, data and credit by ring rank (tp of them).
PQ_EXPORT int pq_ring_qmatmul_rs(const void* const* xq, const void* const* sx,
                                 const void* const* wq, const void* const* sw,
                                 void* const* out, void* const* comm, void* const* data,
                                 void* const* credit, int tp, int rank_base, int tp_local,
                                 int M, int N, int K, unsigned epoch, void* stream) {
  if (tp < 1 || tp > RING_MAX || tp_local < 1 || rank_base < 0 || rank_base + tp_local > tp ||
      N % tp != 0 || K % 16 != 0 || epoch == 0)
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
  dim3 grid((p.nc + BN - 1) / BN, 1, tp_local);
  void* args[] = {&p};
  cudaError_t err = cudaLaunchCooperativeKernel((const void*)ring_kernel, grid, dim3(QM_THREADS),
                                                args, 0, (cudaStream_t)stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}
