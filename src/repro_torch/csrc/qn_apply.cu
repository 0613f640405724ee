// Quasi-Newton inverse kernels for Hopper (sm_90a): the SHINE hot path.
//
//   H x   = alpha x + sum_i mask[i,b] u[i,b,:] <v[i,b,:], x>
//   H^T x = alpha x + sum_i mask[i,b] v[i,b,:] <u[i,b,:], x>
//
// Replaces two Pallas TPU kernels of repro/kernels/qn_apply.py:
//   * qn_apply_multi_pallas (_make_coeff_multi_kernel, _make_apply_multi_kernel):
//     out[k] = (H^T if transpose[k] else H) xs[k] for K stacked right-hand sides;
//   * broyden_step_pallas (_make_broyden_step_kernel): one whole Broyden
//     iteration -- H g_new, H^T s, den = s^T H y and the guarded ring-slot
//     write of the rank-one pair a = (s - H y)/den, b = H^T s.
//
// What bounds it on the card: bytes.  Each call streams the (m, B, D) U/V
// ring (bf16 by default) twice -- a coefficient pass and an apply pass --
// and does ~2 flops per byte, far below the H100's ~295 flop/byte ridge.
// One prefill Broyden step at m=8, B=4, D=256*2304 streams ~151 MB of ring
// (a 45 us bound at the H100 SXM data-sheet 3.35 TB/s); a decode step
// (D=2304) streams ~0.6 MB and is bound by launch latency.
//
// Design.  The Pallas kernels carry the d-reduction across a sequential
// TPU grid and alias the ring row in and out.  Hopper blocks run in no
// order, so each op is two launches on one stream:
//   1. a coefficient kernel, grid (n_chunks, B): each block reduces its
//      d-chunk into f32 partial dot products, written to a (B, n_chunks, P)
//      scratch -- no atomics, so results are the same from run to run;
//   2. an apply kernel, grid (n_chunks, B): each block folds the partials
//      (a short loop over n_chunks), then emits its chunk of the outputs.
//      broyden_step reads its chunk of the old slot row into ev_u/ev_v and
//      only then writes a/b into that row in place.  A block writes only the
//      d-range that it alone reads, so no read-after-write race crosses
//      blocks.
// Loads are 4-element vectors (16 B f32 / 8 B bf16) when D % 4 == 0 and the
// pointers are aligned, else scalar; the ragged edge of D is masked, there is
// no padding of m or D.  Ring loads are upcast to f32; every accumulation is
// f32; ring writes round to the storage dtype (round to nearest even).
// Per-thread accumulators live in registers, so the ring memory m is a
// template bound: m <= 32, K <= 4.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKMax = 4;

// Load up to 4 consecutive elements starting at p (n valid, zero-filled).
__device__ __forceinline__ float4 load4(const float* p, int n, bool vec) {
  if (vec && n == 4) return *reinterpret_cast<const float4*>(p);
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  if (n > 0) r.x = p[0];
  if (n > 1) r.y = p[1];
  if (n > 2) r.z = p[2];
  if (n > 3) r.w = p[3];
  return r;
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, int n, bool vec) {
  if (vec && n == 4) {
    uint2 raw = *reinterpret_cast<const uint2*>(p);
    __nv_bfloat162 lo = *reinterpret_cast<__nv_bfloat162*>(&raw.x);
    __nv_bfloat162 hi = *reinterpret_cast<__nv_bfloat162*>(&raw.y);
    float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
    return make_float4(a.x, a.y, b.x, b.y);
  }
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  if (n > 0) r.x = __bfloat162float(p[0]);
  if (n > 1) r.y = __bfloat162float(p[1]);
  if (n > 2) r.z = __bfloat162float(p[2]);
  if (n > 3) r.w = __bfloat162float(p[3]);
  return r;
}

__device__ __forceinline__ void store4(float* p, float4 x, int n, bool vec) {
  if (vec && n == 4) { *reinterpret_cast<float4*>(p) = x; return; }
  if (n > 0) p[0] = x.x;
  if (n > 1) p[1] = x.y;
  if (n > 2) p[2] = x.z;
  if (n > 3) p[3] = x.w;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x, int n, bool vec) {
  if (vec && n == 4) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
    uint2 raw;
    raw.x = *reinterpret_cast<uint32_t*>(&lo);
    raw.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = raw;
    return;
  }
  if (n > 0) p[0] = __float2bfloat16_rn(x.x);
  if (n > 1) p[1] = __float2bfloat16_rn(x.y);
  if (n > 2) p[2] = __float2bfloat16_rn(x.z);
  if (n > 3) p[3] = __float2bfloat16_rn(x.w);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float4 fma4(float c, float4 a, float4 acc) {
  return make_float4(fmaf(c, a.x, acc.x), fmaf(c, a.y, acc.y),
                     fmaf(c, a.z, acc.z), fmaf(c, a.w, acc.w));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Reduce NACC per-thread accumulators over the block and write the first n
// of them to dst.  red: shared scratch of kWarps * NACC floats.
template <int NACC>
__device__ __forceinline__ void block_reduce_store(float (&acc)[NACC], int n,
                                                   float* red, float* dst) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int a = 0; a < NACC; ++a) {
    if (a < n) {
      float s = warp_sum(acc[a]);
      if (lane == 0) red[warp * NACC + a] = s;
    }
  }
  __syncthreads();
  for (int a = threadIdx.x; a < n; a += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w * NACC + a];
    dst[a] = s;
  }
}

// ---------------------------------------------------------------------------
// qn_apply_multi
// ---------------------------------------------------------------------------

// partial[b, c, k*m + i] = sum_{d in chunk c} cb_k[i, b, d] * xs[k, b, d],
// cb_k = u if transpose bit k is set, else v.
template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
qn_coeff_kernel(const T* __restrict__ u, const T* __restrict__ v,
                const float* __restrict__ xs, float* __restrict__ partial,
                int m, int B, long long D, int K, int tmask, int chunk,
                int nchunks, bool vec) {
  __shared__ float red[kWarps * kKMax * M];
  const int c = blockIdx.x, b = blockIdx.y;
  const bool any_t = tmask != 0, any_f = tmask != (1 << K) - 1;
  float acc[kKMax * M];
#pragma unroll
  for (int a = 0; a < kKMax * M; ++a) acc[a] = 0.f;
  const long long d0 = (long long)c * chunk;
  const long long d1 = d0 + chunk < D ? d0 + chunk : D;
  for (long long d = d0 + 4LL * threadIdx.x; d < d1; d += 4LL * kThreads) {
    const int n = (int)(d1 - d < 4 ? d1 - d : 4);
    float4 x[kKMax];
#pragma unroll
    for (int k = 0; k < kKMax; ++k)
      if (k < K) x[k] = load4(xs + ((long long)k * B + b) * D + d, n, vec);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      if (i < m) {
        const long long row = ((long long)i * B + b) * D + d;
        float4 ui = make_float4(0.f, 0.f, 0.f, 0.f), vi = ui;
        if (any_t) ui = load4(u + row, n, vec);
        if (any_f) vi = load4(v + row, n, vec);
#pragma unroll
        for (int k = 0; k < kKMax; ++k)
          if (k < K) acc[k * M + i] += dot4((tmask >> k) & 1 ? ui : vi, x[k]);
      }
    }
  }
  // compact (k, i) -> k*m + i before the block reduction
  float packed[kKMax * M];
#pragma unroll
  for (int a = 0; a < kKMax * M; ++a) packed[a] = 0.f;
#pragma unroll
  for (int k = 0; k < kKMax; ++k)
#pragma unroll
    for (int i = 0; i < M; ++i)
      if (k < K && i < m) packed[k * m + i] = acc[k * M + i];
  block_reduce_store(packed, K * m, red,
                     partial + ((long long)b * nchunks + c) * (K * m));
}

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
qn_apply_kernel(const T* __restrict__ u, const T* __restrict__ v,
                const float* __restrict__ xs, const float* __restrict__ mask,
                const float* __restrict__ alpha_p,
                const float* __restrict__ partial, float* __restrict__ out,
                int m, int B, long long D, int K, int tmask, int chunk,
                int nchunks, bool vec) {
  __shared__ float coeff[kKMax * M];
  const int c = blockIdx.x, b = blockIdx.y;
  const int P = K * m;
  for (int a = threadIdx.x; a < P; a += blockDim.x) {
    float s = 0.f;
    const float* src = partial + (long long)b * nchunks * P + a;
    for (int cc = 0; cc < nchunks; ++cc) s += src[(long long)cc * P];
    coeff[a] = s * mask[(a % m) * B + b];
  }
  __syncthreads();
  const bool any_t = tmask != 0, any_f = tmask != (1 << K) - 1;
  const float alpha = *alpha_p;
  float cf[kKMax * M];
#pragma unroll
  for (int k = 0; k < kKMax; ++k)
#pragma unroll
    for (int i = 0; i < M; ++i)
      cf[k * M + i] = (k < K && i < m) ? coeff[k * m + i] : 0.f;
  const long long d0 = (long long)c * chunk;
  const long long d1 = d0 + chunk < D ? d0 + chunk : D;
  for (long long d = d0 + 4LL * threadIdx.x; d < d1; d += 4LL * kThreads) {
    const int n = (int)(d1 - d < 4 ? d1 - d : 4);
    float4 term[kKMax];
#pragma unroll
    for (int k = 0; k < kKMax; ++k) term[k] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      if (i < m) {
        const long long row = ((long long)i * B + b) * D + d;
        float4 ui = make_float4(0.f, 0.f, 0.f, 0.f), vi = ui;
        if (any_f) ui = load4(u + row, n, vec);
        if (any_t) vi = load4(v + row, n, vec);
#pragma unroll
        for (int k = 0; k < kKMax; ++k)
          if (k < K) term[k] = fma4(cf[k * M + i], (tmask >> k) & 1 ? vi : ui, term[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kKMax; ++k) {
      if (k < K) {
        const long long off = ((long long)k * B + b) * D + d;
        float4 x = load4(xs + off, n, vec);
        float4 o = make_float4(fmaf(alpha, x.x, term[k].x), fmaf(alpha, x.y, term[k].y),
                               fmaf(alpha, x.z, term[k].z), fmaf(alpha, x.w, term[k].w));
        store4(out + off, o, n, vec);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// broyden_step
// ---------------------------------------------------------------------------

// partial[b, c, :] = [v_i.g (i<m), u_i.s (i<m), s.g, s.hg_old] over chunk c
template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
broyden_coeff_kernel(const T* __restrict__ u, const T* __restrict__ v,
                     const float* __restrict__ g, const float* __restrict__ s,
                     const float* __restrict__ hg, float* __restrict__ partial,
                     int m, int B, long long D, int chunk, int nchunks, bool vec) {
  __shared__ float red[kWarps * (2 * M + 2)];
  const int c = blockIdx.x, b = blockIdx.y;
  float acc[2 * M + 2];
#pragma unroll
  for (int a = 0; a < 2 * M + 2; ++a) acc[a] = 0.f;
  const long long d0 = (long long)c * chunk;
  const long long d1 = d0 + chunk < D ? d0 + chunk : D;
  for (long long d = d0 + 4LL * threadIdx.x; d < d1; d += 4LL * kThreads) {
    const int n = (int)(d1 - d < 4 ? d1 - d : 4);
    const long long off = (long long)b * D + d;
    const float4 gk = load4(g + off, n, vec), sk = load4(s + off, n, vec);
    const float4 hk = load4(hg + off, n, vec);
    acc[2 * M] += dot4(sk, gk);
    acc[2 * M + 1] += dot4(sk, hk);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      if (i < m) {
        const long long row = ((long long)i * B + b) * D + d;
        acc[i] += dot4(load4(v + row, n, vec), gk);
        acc[M + i] += dot4(load4(u + row, n, vec), sk);
      }
    }
  }
  float packed[2 * M + 2];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    packed[i] = 0.f;
    packed[M + i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < M; ++i) {
    if (i < m) {
      packed[i] = acc[i];
      packed[m + i] = acc[M + i];
    }
  }
  packed[2 * m] = acc[2 * M];
  packed[2 * m + 1] = acc[2 * M + 1];
  block_reduce_store(packed, 2 * m + 2, red,
                     partial + ((long long)b * nchunks + c) * (2 * m + 2));
}

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
broyden_apply_kernel(T* __restrict__ u, T* __restrict__ v,
                     const float* __restrict__ g, const float* __restrict__ s,
                     const float* __restrict__ hg, const float* __restrict__ mask,
                     const int* __restrict__ slot, const float* __restrict__ active,
                     const float* __restrict__ alpha_p, float eps,
                     const float* __restrict__ partial, float* __restrict__ hg_new,
                     float* __restrict__ b_out, float* __restrict__ den_out,
                     T* __restrict__ ev_u, T* __restrict__ ev_v, int m, int B,
                     long long D, int chunk, int nchunks, bool vec) {
  __shared__ float tot[2 * M + 2];
  const int c = blockIdx.x, b = blockIdx.y;
  const int P = 2 * m + 2;
  for (int a = threadIdx.x; a < P; a += blockDim.x) {
    float sum = 0.f;
    const float* src = partial + (long long)b * nchunks * P + a;
    for (int cc = 0; cc < nchunks; ++cc) sum += src[(long long)cc * P];
    tot[a] = sum;
  }
  __syncthreads();
  const float alpha = *alpha_p;
  float cg[M], cs[M];
  float den = alpha * tot[2 * m] - tot[2 * m + 1];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const float mk = i < m ? mask[i * B + b] : 0.f;
    cg[i] = i < m ? tot[i] * mk : 0.f;
    cs[i] = i < m ? tot[m + i] * mk : 0.f;
    den += i < m ? mk * tot[i] * tot[m + i] : 0.f;
  }
  const bool safe = fabsf(den) > eps;
  const bool upd = safe && active[b] > 0.5f;
  const float inv_den = safe ? 1.f / den : 0.f;
  if (c == 0 && threadIdx.x == 0) den_out[b] = den;
  const int sl = slot[b];
  const long long d0 = (long long)c * chunk;
  const long long d1 = d0 + chunk < D ? d0 + chunk : D;
  for (long long d = d0 + 4LL * threadIdx.x; d < d1; d += 4LL * kThreads) {
    const int n = (int)(d1 - d < 4 ? d1 - d : 4);
    const long long off = (long long)b * D + d;
    const float4 gk = load4(g + off, n, vec), sk = load4(s + off, n, vec);
    const float4 hk = load4(hg + off, n, vec);
    float4 hgn = make_float4(alpha * gk.x, alpha * gk.y, alpha * gk.z, alpha * gk.w);
    float4 bb = make_float4(alpha * sk.x, alpha * sk.y, alpha * sk.z, alpha * sk.w);
    float4 eu = make_float4(0.f, 0.f, 0.f, 0.f), ev = eu;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      if (i < m) {
        const long long row = ((long long)i * B + b) * D + d;
        const float4 ui = load4(u + row, n, vec), vi = load4(v + row, n, vec);
        hgn = fma4(cg[i], ui, hgn);
        bb = fma4(cs[i], vi, bb);
        if (i == sl) {
          eu = ui;
          ev = vi;
        }
      }
    }
    store4(hg_new + off, hgn, n, vec);
    store4(b_out + off, bb, n, vec);
    // eviction: the slot's old row, read above (storage values round-trip
    // through f32 exactly)
    store4(ev_u + off, eu, n, vec);
    store4(ev_v + off, ev, n, vec);
    if (upd) {
      const float4 a = make_float4((sk.x - (hgn.x - hk.x)) * inv_den,
                                   (sk.y - (hgn.y - hk.y)) * inv_den,
                                   (sk.z - (hgn.z - hk.z)) * inv_den,
                                   (sk.w - (hgn.w - hk.w)) * inv_den);
      const long long row = ((long long)sl * B + b) * D + d;
      store4(u + row, a, n, vec);
      store4(v + row, bb, n, vec);
    }
  }
}

template <typename T, int M>
cudaError_t qn_apply_multi_t(const void* u, const void* v, const float* xs,
                             const float* mask, const float* alpha, float* partial,
                             float* out, int m, int B, long long D, int K, int tmask,
                             int chunk, int nchunks, bool vec, cudaStream_t st) {
  dim3 grid(nchunks, B);
  qn_coeff_kernel<T, M><<<grid, kThreads, 0, st>>>(
      (const T*)u, (const T*)v, xs, partial, m, B, D, K, tmask, chunk, nchunks, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  qn_apply_kernel<T, M><<<grid, kThreads, 0, st>>>(
      (const T*)u, (const T*)v, xs, mask, alpha, partial, out, m, B, D, K, tmask,
      chunk, nchunks, vec);
  return cudaGetLastError();
}

template <typename T, int M>
cudaError_t broyden_step_t(void* u, void* v, const float* g, const float* s,
                           const float* hg, const float* mask, const int* slot,
                           const float* active, const float* alpha, float eps,
                           float* partial, float* hg_new, float* b_out, float* den,
                           void* ev_u, void* ev_v, int m, int B, long long D,
                           int chunk, int nchunks, bool vec, cudaStream_t st) {
  dim3 grid(nchunks, B);
  broyden_coeff_kernel<T, M><<<grid, kThreads, 0, st>>>(
      (const T*)u, (const T*)v, g, s, hg, partial, m, B, D, chunk, nchunks, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  broyden_apply_kernel<T, M><<<grid, kThreads, 0, st>>>(
      (T*)u, (T*)v, g, s, hg, mask, slot, active, alpha, eps, partial, hg_new, b_out,
      den, (T*)ev_u, (T*)ev_v, m, B, D, chunk, nchunks, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Both entry points return a cudaError_t (0 = launched).  Pointers are device
// pointers; `bf16` selects the ring storage type (else float32).
int qn_apply_multi_launch(const void* u, const void* v, const float* xs,
                          const float* mask, const float* alpha, float* partial,
                          float* out, int m, int B, long long D, int K, int tmask,
                          int chunk, int nchunks, int bf16, int vec, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (K < 1 || K > kKMax || m < 1 || m > 32) return (int)cudaErrorInvalidValue;
#define QN_CALL(TT, MM)                                                              \
  return (int)qn_apply_multi_t<TT, MM>(u, v, xs, mask, alpha, partial, out, m, B, D, \
                                       K, tmask, chunk, nchunks, vec != 0, st)
  if (bf16) {
    if (m <= 8) QN_CALL(__nv_bfloat16, 8);
    if (m <= 16) QN_CALL(__nv_bfloat16, 16);
    QN_CALL(__nv_bfloat16, 32);
  }
  if (m <= 8) QN_CALL(float, 8);
  if (m <= 16) QN_CALL(float, 16);
  QN_CALL(float, 32);
#undef QN_CALL
}

int broyden_step_launch(void* u, void* v, const float* g, const float* s,
                        const float* hg, const float* mask, const int* slot,
                        const float* active, const float* alpha, float eps,
                        float* partial, float* hg_new, float* b_out, float* den,
                        void* ev_u, void* ev_v, int m, int B, long long D, int chunk,
                        int nchunks, int bf16, int vec, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (m < 1 || m > 32) return (int)cudaErrorInvalidValue;
#define BS_CALL(TT, MM)                                                             \
  return (int)broyden_step_t<TT, MM>(u, v, g, s, hg, mask, slot, active, alpha, eps, \
                                     partial, hg_new, b_out, den, ev_u, ev_v, m, B, \
                                     D, chunk, nchunks, vec != 0, st)
  if (bf16) {
    if (m <= 8) BS_CALL(__nv_bfloat16, 8);
    if (m <= 16) BS_CALL(__nv_bfloat16, 16);
    BS_CALL(__nv_bfloat16, 32);
  }
  if (m <= 8) BS_CALL(float, 8);
  if (m <= 16) BS_CALL(float, 16);
  BS_CALL(float, 32);
#undef BS_CALL
}

}  // extern "C"
