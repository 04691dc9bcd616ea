// Decode attention over the paged int8 KV pool, walking the page table.
//
// Replaces protoquant_tpu/ops/paged_attention.py:_kernel (Pallas), with its
// ALiBi variant.
//   q [B, 1, H, Dh] (f32/bf16/f16), kq/vq [P, KV, ps, Dh] int8 pools,
//   ks/vs [P, KV, 1, ps] f32, page_table [B, maxP] int32 (-1 unmapped, read
//   as page 0, as the TPU kernel's index map clamps), lengths [B] int32 =
//   cache length BEFORE this step, alibi [H] f32 or null. Key slot s of
//   table entry j is absolute position p_c = j * ps + s and is visible iff
//   it is <= lengths[b]. Query head h * G + g reads kv head h.
//   score[g, c] = (q[g] . kq[c]) * ks[c] * Dh^-0.5
//                 (ALiBi: - alibi[h * G + g] * (lengths[b] - p_c))
//   out[g]      = sum_c softmax(score)[g, c] * vs[c] * vq[c]
// Bound on the H100: bytes, the valid keys of each row's pages
// ((lengths[b] + 1) * (2 * Dh + 8) per (b, kv head)) plus q and out.
// Design: one block of 4 warps per (kv head, b) holding the G query rows of
// that head. The block loops over table entries j = 0 .. lengths[b] / ps
// only, reading each page id itself (the TPU kernel had the table
// prefetched as scalars), so pages past the row's own length are never
// read and no contiguous window is gathered. Each page's valid int8 K and V
// rows and their scales are staged in shared memory (16-byte global loads;
// K rows padded by 4 bytes so 32 threads scoring 32 keys hit 32 banks).
// Thread s scores key s against the G rows; one warp per row runs the
// online softmax in f32 (running max m, denominator l, rescale factor);
// then thread d accumulates output dim d over the page's keys with p * vs.
// The output is acc / max(l, 1e-30). ALiBi is a template switch, so the
// plain instance is the kernel as it was. At B = 4 and KV = 32 that is 128
// blocks, and the longest row sets the time: ops/paged_attention.py sends
// every call whose rows fit a split block to the split-S design over the
// page table (attn_split.cuh, PAGED), and this kernel keeps the calls its
// plan refuses (G 8 at Dh 256).

#include "common.cuh"

constexpr int PA_THREADS = 128;
constexpr int PA_WARPS = PA_THREADS / 32;
constexpr int PA_MAXG = 8;  // query heads per kv head
constexpr float PA_NEG_INF = -1e30f;

__host__ __device__ constexpr int pa_round16(int n) { return (n + 15) & ~15; }

// Dynamic shared memory, in bytes from the base: K rows [ps][Dh + 4] int8,
// V rows [ps][Dh] int8, then f32 (q first, so its float4 reads are
// aligned): q[G][Dh], ks[ps], vs[ps], p[G][ps], m[G], l[G], corr[G].
struct PaLayout {
  int v, f, bytes;
  __host__ __device__ PaLayout(int ps, int dh, int g) {
    v = pa_round16(ps * (dh + 4));
    f = v + pa_round16(ps * dh);
    bytes = f + 4 * (2 * ps + g * dh + g * ps + 3 * g);
  }
};

template <int DH, bool ALIBI, typename QT>
__global__ void __launch_bounds__(PA_THREADS)
paged_attn_kernel(const QT* __restrict__ q, const int8_t* __restrict__ kq,
                  const float* __restrict__ ks, const int8_t* __restrict__ vq,
                  const float* __restrict__ vs, const int* __restrict__ page_table,
                  const int* __restrict__ lengths, const float* __restrict__ alibi,
                  QT* __restrict__ out, int H, int KV, int maxP, int ps, float sm) {
  constexpr int KSTR = DH + 4;
  constexpr int DPT = (DH + PA_THREADS - 1) / PA_THREADS;  // output dims per thread
  extern __shared__ __align__(16) unsigned char pa_smem[];
  const int G = H / KV;
  const PaLayout lay(ps, DH, G);
  int8_t* Ks = (int8_t*)pa_smem;
  int8_t* Vs = (int8_t*)(pa_smem + lay.v);
  float* Qs = (float*)(pa_smem + lay.f);
  float* kss = Qs + G * DH;
  float* vss = kss + ps;
  float* Ps = vss + ps;
  float* ms = Ps + G * ps;
  float* ls = ms + G;
  float* cs = ls + G;

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = max(lengths[b], 0);
  const int n_pages = min(len / ps + 1, maxP);

  for (int i = tid; i < G * DH; i += PA_THREADS)
    Qs[i] = pq_to_float(q[((size_t)b * H + h * G) * DH + i]);
  if (tid < G) {
    ms[tid] = PA_NEG_INF;
    ls[tid] = 0.0f;
  }
  float acc[PA_MAXG][DPT], slope[PA_MAXG];
#pragma unroll
  for (int g = 0; g < PA_MAXG; ++g) {
    slope[g] = ALIBI && g < G ? alibi[h * G + g] : 0.0f;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[g][i] = 0.0f;
  }

  for (int j = 0; j < n_pages; ++j) {
    const int page = max(page_table[(size_t)b * maxP + j], 0);
    const size_t row0 = ((size_t)page * KV + h) * ps;  // first key row of the page
    const int n_valid = min(ps, len - j * ps + 1);     // keys at positions <= len
    __syncthreads();  // q staged / the previous page consumed
    const int4* kg = (const int4*)(kq + row0 * DH);
    const int4* vg = (const int4*)(vq + row0 * DH);
    for (int c = tid; c < n_valid * (DH / 16); c += PA_THREADS) {
      const int r = c / (DH / 16), w = c % (DH / 16);
      const int4 kv = kg[c];
      int* kd = (int*)(Ks + r * KSTR + w * 16);
      kd[0] = kv.x;
      kd[1] = kv.y;
      kd[2] = kv.z;
      kd[3] = kv.w;
      *(int4*)(Vs + r * DH + w * 16) = vg[c];
    }
    for (int s = tid; s < n_valid; s += PA_THREADS) {
      kss[s] = ks[row0 + s];
      vss[s] = vs[row0 + s];
    }
    __syncthreads();

    for (int s = tid; s < n_valid; s += PA_THREADS) {
      const int8_t* kr = Ks + s * KSTR;
      float dot[PA_MAXG];
#pragma unroll
      for (int g = 0; g < PA_MAXG; ++g) dot[g] = 0.0f;
#pragma unroll 4
      for (int d = 0; d < DH; d += 4) {
        const char4 k4 = *(const char4*)(kr + d);
        const float kx = k4.x, ky = k4.y, kz = k4.z, kw = k4.w;
#pragma unroll
        for (int g = 0; g < PA_MAXG; ++g) {
          if (g < G) {
            const float4 qv = *(const float4*)(Qs + g * DH + d);
            dot[g] += qv.x * kx + qv.y * ky + qv.z * kz + qv.w * kw;
          }
        }
      }
      const float kscale = kss[s];
      const float dist = (float)(len - (j * ps + s));  // the query's position minus the key's
#pragma unroll
      for (int g = 0; g < PA_MAXG; ++g) {
        if (g < G) {
          float v = (dot[g] * kscale) * sm;
          if constexpr (ALIBI) v -= slope[g] * dist;
          Ps[g * ps + s] = v;
        }
      }
    }
    __syncthreads();

    for (int g = warp; g < G; g += PA_WARPS) {
      float* pr = Ps + g * ps;
      float tmax = PA_NEG_INF;
      for (int s = lane; s < n_valid; s += 32) tmax = fmaxf(tmax, pr[s]);
      tmax = pq_warp_max(tmax);
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, tmax);
      float psum = 0.0f;
      for (int s = lane; s < n_valid; s += 32) {
        const float p = expf(pr[s] - m_new);
        psum += p;
        pr[s] = p * vss[s];
      }
      psum = pq_warp_sum(psum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        cs[g] = corr;
        ls[g] = ls[g] * corr + psum;
        ms[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = tid + i * PA_THREADS;
      if (d < DH) {
#pragma unroll
        for (int g = 0; g < PA_MAXG; ++g)
          if (g < G) acc[g][i] *= cs[g];
        for (int s = 0; s < n_valid; ++s) {
          const float v = (float)Vs[s * DH + d];
#pragma unroll
          for (int g = 0; g < PA_MAXG; ++g)
            if (g < G) acc[g][i] += Ps[g * ps + s] * v;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    const int d = tid + i * PA_THREADS;
    if (d >= DH) continue;
#pragma unroll
    for (int g = 0; g < PA_MAXG; ++g) {
      if (g < G) {
        const float denom = fmaxf(ls[g], 1e-30f);
        out[((size_t)b * H + h * G + g) * DH + d] = pq_from_float<QT>(acc[g][i] / denom);
      }
    }
  }
}

template <int DH, bool ALIBI, typename QT>
static cudaError_t launch_a(const void* q, const void* kq, const void* ks, const void* vq,
                            const void* vs, const void* page_table, const void* lengths,
                            const void* alibi, void* out, int B, int H, int KV, int maxP,
                            int ps, float sm, cudaStream_t stream) {
  const int bytes = PaLayout(ps, DH, H / KV).bytes;
  if (bytes > 48 * 1024) {
    if (bytes > 227 * 1024) return cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(paged_attn_kernel<DH, ALIBI, QT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(KV, B);
  paged_attn_kernel<DH, ALIBI, QT><<<grid, PA_THREADS, bytes, stream>>>(
      (const QT*)q, (const int8_t*)kq, (const float*)ks, (const int8_t*)vq, (const float*)vs,
      (const int*)page_table, (const int*)lengths, (const float*)alibi, (QT*)out, H, KV,
      maxP, ps, sm);
  return cudaGetLastError();
}

template <int DH, typename QT>
static cudaError_t launch_t(const void* q, const void* kq, const void* ks, const void* vq,
                            const void* vs, const void* page_table, const void* lengths,
                            const void* alibi, void* out, int B, int H, int KV, int maxP,
                            int ps, float sm, cudaStream_t stream) {
  if (alibi != nullptr)
    return launch_a<DH, true, QT>(q, kq, ks, vq, vs, page_table, lengths, alibi, out, B, H,
                                  KV, maxP, ps, sm, stream);
  return launch_a<DH, false, QT>(q, kq, ks, vq, vs, page_table, lengths, alibi, out, B, H,
                                 KV, maxP, ps, sm, stream);
}

template <typename QT>
static cudaError_t launch_dh(int Dh, const void* q, const void* kq, const void* ks,
                             const void* vq, const void* vs, const void* page_table,
                             const void* lengths, const void* alibi, void* out, int B, int H,
                             int KV, int maxP, int ps, float sm, cudaStream_t stream) {
#define PQ_PA_ARGS q, kq, ks, vq, vs, page_table, lengths, alibi, out, B, H, KV, maxP, ps, sm, \
                   stream
  switch (Dh) {
    case 64: return launch_t<64, QT>(PQ_PA_ARGS);
    case 128: return launch_t<128, QT>(PQ_PA_ARGS);
    case 256: return launch_t<256, QT>(PQ_PA_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef PQ_PA_ARGS
}

PQ_EXPORT int pq_paged_int8_attention(const void* q, int q_dtype, const void* kq, const void* ks,
                                      const void* vq, const void* vs, const void* page_table,
                                      const void* lengths, const void* alibi, void* out, int B,
                                      int H, int KV, int maxP, int ps, int Dh, float sm,
                                      void* stream) {
  if (B == 0) return cudaSuccess;
  if (KV == 0 || H % KV != 0 || H / KV > PA_MAXG || maxP < 1 || ps < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define PQ_PA_DARGS Dh, q, kq, ks, vq, vs, page_table, lengths, alibi, out, B, H, KV, maxP, ps, \
                    sm, st
  switch (q_dtype) {
    case PQ_F32: return launch_dh<float>(PQ_PA_DARGS);
    case PQ_BF16: return launch_dh<__nv_bfloat16>(PQ_PA_DARGS);
    case PQ_F16: return launch_dh<__half>(PQ_PA_DARGS);
    default: return cudaErrorInvalidValue;
  }
#undef PQ_PA_DARGS
}
