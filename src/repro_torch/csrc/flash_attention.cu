// Flash-attention forward for Hopper (sm_90a): prefill and decode.
//
// Replaces repro/kernels/flash_attention.py: flash_attention_pallas
// (_flash_kernel) and decode_attention_pallas, which is the same kernel at
// block_q = 1.  Here too one kernel body serves both: a template over the
// number of query rows per block (BQ) and the number of threads that split
// one row's keys (KSPLIT).  Prefill launches BQ=64 rows x 2 key lanes;
// decode launches one query row whose keys are split over one lane per key
// of a tile.
//
// Semantics carried over from the Pallas kernel and the oracle
// (repro/kernels/ref.py attention_ref):
//   * q is scaled in f32 before q.k; online softmax with f32 running max,
//     denominator and accumulator;
//   * GQA: query head h reads kv head h / (H / KV);
//   * per-row kv_length mask and a causal mask kpos <= qpos (query row s
//     sits at key position s, as attention_ref takes it on every path);
//   * masked scores are the finite NEG_INF = -1e30, so a row whose every key
//     is masked averages all keys uniformly (the oracle's answer), not NaN;
//   * S and T need not divide the tiles: ragged query rows and key tiles are
//     masked (keys past T take -inf and weigh exactly nothing).
// Key tiles past kv_length, and past the causal diagonal of the block's last
// row, are skipped whenever the row has at least one valid key (a skipped
// masked key would weigh exp(-1e30 - m) = 0 exactly).  Decode over a
// max_len cache therefore reads only the live prefix.
//
// What bounds it on the card: the card's own bound is bytes at both shapes
// (prefill B=4, S=T=256, 36 heads x 64 does ~1.2 GFLOP causal against
// ~19 MB; decode reads the live K/V prefix once).  This first version runs
// the products on the f32 FMA pipes rather than the tensor cores, stages
// K/V tiles in shared memory as f32 with scalar loads, and keeps each
// thread's query row and accumulator in registers, so it sits far above
// that bound (PERF.md); mma/wgmma with TMA-fed tiles and a split-K
// flash-decode are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int HD> struct Tile {
  static constexpr int BK = HD <= 64 ? 64 : 32;  // keys per shared tile
};

template <typename T, int HD, int BQ, int KSPLIT>
__global__ void __launch_bounds__(BQ* KSPLIT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ kv_len,
                 T* __restrict__ out, int S, int Tk, int H, int KV, float scale,
                 int causal) {
  constexpr int BK = Tile<HD>::BK;
  constexpr int NT = BQ * KSPLIT;
  constexpr int NJ = BK / KSPLIT;  // keys of a tile per thread
  static_assert(NJ >= 1, "KSPLIT must not exceed the key tile");
  __shared__ float ks[BK][HD + 1];
  __shared__ float vs[BK][HD + 1];

  const int tid = threadIdx.x;
  const int row = tid / KSPLIT, lane = tid % KSPLIT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = blockIdx.x * BQ;
  const int s_idx = r0 + row;
  const bool row_ok = s_idx < S;
  const int kvh = h / (H / KV);
  const int len = kv_len != nullptr ? kv_len[b] : Tk;

  float qr[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d)
    qr[d] = row_ok ? to_f(q[(((long long)b * S + s_idx) * H + h) * HD + d]) * scale
                   : 0.f;

  int limit = Tk;
  if (len >= 1) {
    limit = len < limit ? len : limit;
    if (causal) {
      const int qmax = r0 + BQ < S ? r0 + BQ : S;  // last row's position + 1
      limit = qmax < limit ? qmax : limit;
    }
  }
  const int n_tiles = (limit + BK - 1) / BK;

  float m_i = kNegInf, l_i = 0.f;
  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t0 = tile * BK;
    __syncthreads();  // previous tile fully consumed
    for (int idx = tid; idx < BK * HD; idx += NT) {
      const int j = idx / HD, d = idx % HD;
      const int t = t0 + j;
      float kx = 0.f, vx = 0.f;
      if (t < Tk) {
        const long long off = (((long long)b * Tk + t) * KV + kvh) * HD + d;
        kx = to_f(k[off]);
        vx = to_f(v[off]);
      }
      ks[j][d] = kx;
      vs[j][d] = vx;
    }
    __syncthreads();

    float sc[NJ];
    float mt = kNegInf;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int j = lane + jj * KSPLIT;
      const int t = t0 + j;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], ks[j][d], dot);
      const bool valid = t < len && (!causal || t <= s_idx);
      sc[jj] = t >= Tk ? -INFINITY : (valid ? dot : kNegInf);
      mt = fmaxf(mt, sc[jj]);
    }
    const float m_new = fmaxf(m_i, mt);
    const float corr = expf(m_i - m_new);
    l_i *= corr;
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] *= corr;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int j = lane + jj * KSPLIT;
      const float p = expf(sc[jj] - m_new);
      l_i += p;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] = fmaf(p, vs[j][d], acc[d]);
    }
    m_i = m_new;
  }

  // merge the KSPLIT partial softmax states of a row: lanes of one warp by
  // shuffles, then (KSPLIT > 32) the row's warps through shared memory
  constexpr int WL = KSPLIT < 32 ? KSPLIT : 32;
#pragma unroll
  for (int off = WL / 2; off > 0; off >>= 1) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m_i, off);
    const float l_o = __shfl_xor_sync(0xffffffffu, l_i, off);
    const float m_n = fmaxf(m_i, m_o);
    const float c1 = expf(m_i - m_n), c2 = expf(m_o - m_n);
    l_i = l_i * c1 + l_o * c2;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      const float a_o = __shfl_xor_sync(0xffffffffu, acc[d], off);
      acc[d] = acc[d] * c1 + a_o * c2;
    }
    m_i = m_n;
  }
  if constexpr (KSPLIT > 32) {
    constexpr int NW = KSPLIT / 32;
    static_assert(BQ * NW * (HD + 2) <= BK * (HD + 1), "merge scratch too small");
    float* red = &ks[0][0];
    __syncthreads();
    const int w = lane / 32;
    if ((lane & 31) == 0) {
      float* dst = red + (row * NW + w) * (HD + 2);
      dst[0] = m_i;
      dst[1] = l_i;
#pragma unroll
      for (int d = 0; d < HD; ++d) dst[2 + d] = acc[d];
    }
    __syncthreads();
    if (lane == 0) {
      for (int ww = 1; ww < NW; ++ww) {
        const float* src = red + (row * NW + ww) * (HD + 2);
        const float m_o = src[0], l_o = src[1];
        const float m_n = fmaxf(m_i, m_o);
        const float c1 = expf(m_i - m_n), c2 = expf(m_o - m_n);
        l_i = l_i * c1 + l_o * c2;
#pragma unroll
        for (int d = 0; d < HD; ++d) acc[d] = acc[d] * c1 + src[2 + d] * c2;
        m_i = m_n;
      }
    }
  }
  if (lane == 0 && row_ok) {
    const float inv = 1.f / fmaxf(l_i, 1e-30f);
    T* dst = out + (((long long)b * S + s_idx) * H + h) * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) dst[d] = from_f<T>(acc[d] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch_t(const void* q, const void* k, const void* v, const int* kv_len,
                     void* out, int B, int S, int Tk, int H, int KV, float scale,
                     int causal, int decode, cudaStream_t st) {
  if (decode) {
    constexpr int KS = Tile<HD>::BK;
    dim3 grid(S, H, B);
    flash_fwd_kernel<T, HD, 1, KS><<<grid, KS, 0, st>>>(
        (const T*)q, (const T*)k, (const T*)v, kv_len, (T*)out, S, Tk, H, KV, scale,
        causal);
  } else {
    constexpr int BQ = 64;
    dim3 grid((S + BQ - 1) / BQ, H, B);
    flash_fwd_kernel<T, HD, BQ, 2><<<grid, BQ * 2, 0, st>>>(
        (const T*)q, (const T*)k, (const T*)v, kv_len, (T*)out, S, Tk, H, KV, scale,
        causal);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int HD, const void* q, const void* k, const void* v,
                      const int* kv_len, void* out, int B, int S, int Tk, int H,
                      int KV, float scale, int causal, int decode,
                      cudaStream_t st) {
  switch (HD) {
    // the head dims this slice serves: 16 (smoke configs), 64 (MiniCPM-2B);
    // each instantiation fully unrolls its row, so the set is kept small
    case 16: return launch_t<T, 16>(q, k, v, kv_len, out, B, S, Tk, H, KV, scale, causal, decode, st);
    case 64: return launch_t<T, 64>(q, k, v, kv_len, out, B, S, Tk, H, KV, scale, causal, decode, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, S, H, HD), k/v (B, T, KV, HD), out like q, all contiguous, one dtype
// (bf16 when `bf16`, else float32).  kv_len: (B,) int32 device pointer or
// null (= T).  `decode` selects the one-row-per-block launch.  Returns a
// cudaError_t (0 = launched).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           const int* kv_len, void* out, int B, int S, int Tk, int H,
                           int KV, int HD, float scale, int causal, int decode,
                           int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (KV < 1 || H % KV != 0) return (int)cudaErrorInvalidValue;
  if (bf16)
    return (int)launch_hd<__nv_bfloat16>(HD, q, k, v, kv_len, out, B, S, Tk, H, KV,
                                         scale, causal, decode, st);
  return (int)launch_hd<float>(HD, q, k, v, kv_len, out, B, S, Tk, H, KV, scale,
                               causal, decode, st);
}

}  // extern "C"
