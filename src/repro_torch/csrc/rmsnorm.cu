// RMSNorm forward for Hopper (sm_90a).
//
// Replaces repro/kernels/rmsnorm.py: rmsnorm_pallas (_rmsnorm_kernel),
// out = x * rsqrt(mean(x^2) + eps) * w, with the mean, the normalization and
// the scale all in f32 and the result rounded once (round to nearest even) to
// the dtype of x.  The weight has the dtype of x (the port keeps parameters in
// the activation dtype).
//
// What bounds it on the card: bytes.  Each element is read once and written
// once (~3 flops each): at the paths' 1024 x 2304 bf16 that is 9.4 MB, 0.0028
// ms at 3.35 TB/s.  The design keeps every byte of x and w on chip between
// its load and its use:
//   * a row is held by W warps (1 to 10; rmsnorm.plan picks): PER 16-byte
//     vectors per lane, D = PER * W * 32 * 8 in bf16 (* 4 in f32), PER and
//     W template parameters instantiated for the registry's widths (1280,
//     2048, 2304, 2560, 3072, 5120, 6144 give PER * W = 5, 8, 9, 10, 12,
//     20, 24 in bf16) and MLA's kv_norm (512: 2), so no lane is masked and
//     every load and store is a coalesced 16-byte access.  Many
//     rows (training, prefill) take the fewest warps a row that keep PER <=
//     12 (one warp at 2304-3072, two at 6144), which keeps each row in one
//     warp's registers; few rows (decode) spread a row over more warps (PER
//     1-3; 10 warps, 320 threads, at 5120), so that the latency of one row's loads and its serial
//     arithmetic is short;
//   * the weight loaded once per warp and held in registers across the
//     warp's rows, packed in its own dtype (half the registers of f32; the
//     conversion is one instruction per element);
//   * a persistent grid-stride loop over rows, a warp's next row loaded
//     after its current row is stored (at the paths' 1024 rows, and at few
//     rows, a warp has one row: the grid covers the rows in one pass);
//   * the sum of squares reduced by __shfl_xor_sync within a warp; across
//     the W warps of a row through 8 floats of shared memory and one
//     barrier a row (none at W = 1).
// Any other width and a row that is not 16-byte aligned take
// rmsnorm_generic_kernel: one warp per row, element loads, a second read of
// the row (from L1) for the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> struct Vec;  // one 16-byte vector of T, as floats
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& v, float (&f)[N]) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(p[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ __forceinline__ static uint4 pack(const float (&f)[N]) {
    uint4 v;
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return v;
  }
};
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& v, float (&f)[N]) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ __forceinline__ static uint4 pack(const float (&f)[N]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float& d, float x) { d = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16& d, float x) {
  d = __float2bfloat16_rn(x);
}

// A block of R row groups of W warps (blockDim.x = 32 * W * R); a group
// normalizes one row at a time, each lane holding PER 16-byte vectors of it
// (vectors lane + 32 * w' + 32 * W * j of warp w' of the group, so a warp's
// loads are coalesced), D = PER * W * 32 * N.  PER and W are template
// parameters, so every load and store has a constant offset.  Rows b + g,
// b + g + gridDim.x * R, ... for block b's group g; every group of a block
// walks the same number of steps (a group past the last row idles), so the
// cross-warp sum (W > 1) may take a barrier.
// A block holds at most 256 threads, or one row group of W > 8 warps.
template <int W>
constexpr int kMaxThreads = W > 8 ? 32 * W : 256;

template <typename T, int PER, int W>
__global__ void __launch_bounds__(kMaxThreads<W>)
rmsnorm_vec_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                   int rows, float eps) {
  using V = Vec<T>;
  constexpr long long D = (long long)PER * W * 32 * V::N;
  constexpr int vs = W * 32;         // vectors between a lane's own
  __shared__ float red[2][kMaxThreads<W> / 32];  // warp partials, by step parity
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = warp / W;
  const int per_block = (blockDim.x >> 5) / W;  // R
  const int step = gridDim.x * per_block;
  const int v0 = (warp % W) * 32 + lane;
  int base = blockIdx.x * per_block;
  if (base >= rows) return;  // the whole block: uniform

  const uint4* wv = reinterpret_cast<const uint4*>(w) + v0;
  uint4 wr[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) wr[j] = __ldg(wv + j * vs);

  auto load = [&](uint4 (&r)[PER], int rr) {
    const uint4* src = reinterpret_cast<const uint4*>(x + rr * D) + v0;
#pragma unroll
    for (int j = 0; j < PER; ++j) r[j] = src[j * vs];
  };
  uint4 xa[PER];
  if (base + grp < rows) load(xa, base + grp);
  for (int it = 0;; ++it) {
    const int row = base + grp;
    const bool live = row < rows;
    float ss = 0.f;
    if (live) {
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        float f[V::N];
        V::unpack(xa[j], f);
#pragma unroll
        for (int e = 0; e < V::N; ++e) ss = fmaf(f[e], f[e], ss);
      }
    }
    ss = warp_sum(ss);
    if constexpr (W > 1) {  // the group's warps, in a fixed order
      if (lane == 0) red[it & 1][warp] = ss;
      __syncthreads();
      ss = 0.f;
#pragma unroll
      for (int k = 0; k < W; ++k) ss += red[it & 1][grp * W + k];
    }
    const float inv = rsqrtf(ss * (1.f / (float)D) + eps);  // no division: D is constant
    if (live) {
      uint4* dst = reinterpret_cast<uint4*>(out + row * D) + v0;
      // the weight stays packed: without this the compiler hoists its f32
      // conversion out of the row loop (PER * 8 more registers)
#pragma unroll
      for (int j = 0; j < PER; ++j)
        asm volatile("" : "+r"(wr[j].x), "+r"(wr[j].y), "+r"(wr[j].z), "+r"(wr[j].w));
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        float f[V::N], g[V::N];
        V::unpack(xa[j], f);
        V::unpack(wr[j], g);
#pragma unroll
        for (int e = 0; e < V::N; ++e) f[e] = f[e] * inv * g[e];
        dst[j * vs] = V::pack(f);
      }
    }
    base += step;
    if (base >= rows) break;
    if (base + grp < rows) load(xa, base + grp);
  }
}

// Any width and alignment: one warp per row, element loads; the row is read
// twice (the second time from L1).
template <typename T>
__global__ void __launch_bounds__(256)
rmsnorm_generic_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                       int rows, int D, float eps) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int n_warps = gridDim.x * warps;
  for (int row = blockIdx.x * warps + (threadIdx.x >> 5); row < rows; row += n_warps) {
    const T* xr = x + (long long)row * D;
    float ss = 0.f;
    for (int i = lane; i < D; i += 32) {
      const float f = to_f32(xr[i]);
      ss = fmaf(f, f, ss);
    }
    const float inv = rsqrtf(warp_sum(ss) / (float)D + eps);
    T* dst = out + (long long)row * D;
    for (int i = lane; i < D; i += 32) from_f32(dst[i], to_f32(xr[i]) * inv * to_f32(__ldg(w + i)));
  }
}

template <typename T, int PER, int W>
cudaError_t launch_vec(const void* x, const void* w, void* out, int rows, float eps, int n_cta,
                       int threads, cudaStream_t st) {
  if (threads % (32 * W) || threads > kMaxThreads<W>) return cudaErrorInvalidValue;
  rmsnorm_vec_kernel<T, PER, W><<<n_cta, threads, 0, st>>>((const T*)x, (const T*)w,
                                                             (T*)out, rows, eps);
  return cudaGetLastError();
}

// The (PER, W) splits of rmsnorm.plan (VEC_SPLITS there): the registry's
// widths (1280, 2048, 2304, 2560, 3072, 5120, 6144; 5, 8, 9, 10, 12, 20, 24
// bf16 vectors a lane of one warp, twice that in f32) and MLA's kv_norm
// (512: 2) over 1-10 warps a row.
#define RMS_SPLITS(X) \
  X(9, 1) X(10, 1) X(12, 1) X(9, 2) X(10, 2) X(12, 2) X(12, 4) X(2, 5) X(3, 3) X(3, 4) \
  X(3, 6) X(3, 8) X(8, 1) X(2, 4) X(8, 2) X(2, 1) X(5, 1) X(1, 5) X(2, 10) X(10, 4)

template <typename T>
cudaError_t launch(const void* x, const void* w, void* out, int rows, int D, float eps,
                   int per, int wpr, int n_cta, int threads, cudaStream_t st) {
  if (per == 0) {
    rmsnorm_generic_kernel<T><<<n_cta, threads, 0, st>>>((const T*)x, (const T*)w, (T*)out,
                                                          rows, D, eps);
    return cudaGetLastError();
  }
  if (per * wpr * 32 * Vec<T>::N != D) return cudaErrorInvalidValue;
#define RMS_CASE(P, Wp) \
  if (per == P && wpr == Wp) return launch_vec<T, P, Wp>(x, w, out, rows, eps, n_cta, threads, st);
  RMS_SPLITS(RMS_CASE)
#undef RMS_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x, out (rows, D) and w (D,), contiguous, one dtype (bf16 when `bf16`, else
// float32).  `per` 16-byte vectors per lane over `wpr` warps per row select
// the width's instance (then x, w and out must be 16-byte aligned), `per` 0
// the generic kernel (one warp per row); `n_cta` blocks of `threads` (a
// multiple of 32 * wpr, at most 256, or 32 * wpr past 8 warps) threads.
// Returns a cudaError_t (0 = launched).
int rmsnorm_launch(const void* x, const void* w, void* out, int rows, int D, float eps,
                   int bf16, int per, int wpr, int n_cta, int threads, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (rows < 1 || D < 1 || n_cta < 1 || threads < 32 || threads > 320 || threads % 32)
    return (int)cudaErrorInvalidValue;
  return bf16 ? (int)launch<__nv_bfloat16>(x, w, out, rows, D, eps, per, wpr, n_cta, threads,
                                           st)
              : (int)launch<float>(x, w, out, rows, D, eps, per, wpr, n_cta, threads, st);
}

}  // extern "C"
