// Flash-attention forward for Hopper (sm_90a): prefill and decode.
//
// Replaces repro/kernels/flash_attention.py: flash_attention_pallas
// (_flash_kernel) and decode_attention_pallas, which is the same Pallas
// kernel at block_q = 1.
//
// Semantics carried over from the Pallas kernel and the oracle
// (repro/kernels/ref.py attention_ref), on every path below:
//   * f32 scores (scale applied in f32; at head dims 16 and 64 the scale is a
//     power of two, so this equals the Pallas kernel's scaling of q; at 80,
//     96 and 128 the two round differently, within the f32 tolerance), online
//     softmax with f32 running max, denominator and accumulator;
//   * GQA: query head h reads kv head h / (H / KV);
//   * per-row kv_length mask and a causal mask kpos <= qpos (query row s
//     sits at key position s, as attention_ref takes it on every path);
//   * masked scores are the finite NEG_INF = -1e30, so a row whose every key
//     is masked (kv_length 0) averages all T keys uniformly, not NaN;
//   * S and T need not divide the tiles: keys at or past T weigh exactly
//     nothing, ragged query rows are computed and not stored.
// Key tiles past kv_length, and past the causal diagonal of a block's last
// row, are skipped whenever the row has at least one valid key (a skipped
// masked key would weigh exp(-1e30 - m) = 0 exactly), so decode over a
// max_len cache reads only the live prefix.
//
// What bounds it on the card: bytes, at both shapes of the paths.  Prefill
// B=4, S=T=256, 36 heads x 64, causal moves ~19 MB (q, k, v read once, out
// written once: 0.0056 ms at 3.35 TB/s) against ~1.2 GFLOP (0.0012 ms at
// 989 TFLOP/s bf16).  Decode reads the live K/V prefix once: ~14.8 MB for
// kv_length 129/257/200/1024 over a 1024-token cache, 0.0044 ms.
//
// Design (bf16, the paths' dtype):
//   * prefill, flash_fwd_mma_kernel: a CTA of 4 warps owns a 64-row query
//     tile of one (b, h), 16 rows per warp; grid (H, B, ceil(S/64)) with the
//     q-block index reversed, so that the q-blocks holding the most key tiles
//     (the last rows under the causal mask) of every head are dispatched
//     first and the lightest form the tail (struct Mma: the shape per head
//     dim).  Q is loaded once into ldmatrix
//     A-fragments held in registers.  K/V stream through a 2-stage ring of
//     bf16 key tiles in shared memory (32 keys at hd 64, 64 at hd 16),
//     filled by 16-byte cp.async copies (zero-fill past the live keys), so
//     that tile j+1 loads while tile j computes (at hd 80 and 96, 10 or 12
//     chunks a row, the CTA walks rows x chunks with a stride of 128 threads);
//     rows are padded by 16 bytes
//     so ldmatrix is free of bank conflicts.  Both products run on the tensor
//     cores (mma.sync m16n8k16 bf16 -> f32): S = Q K^T from ldmatrix K
//     fragments, the online softmax on the accumulator fragments (a row
//     lives in a quad of 4 threads: two shuffles; exponentials on the SFU),
//     P converted to bf16 A-fragments in registers, O += P V from
//     ldmatrix.trans V fragments.  Masks are applied only on the tiles that
//     need them.  The epilogue stages O through the warp's own Q rows in
//     shared memory and stores 16-byte rows.  Registers are capped per head
//     dim (the O accumulator is HD / 2 f32 a thread): 128 a thread (4 CTAs
//     per SM) up to hd 64, 170 (3) at 80 and 96, 255 (2) at 128 and 192,
//     where the tiles also take 51 KB and 77 KB of dynamic shared memory.
//     At hd 192 (MLA: q and k are 128 + 64 wide, v zero-padded to 192) the
//     Q fragments are read from the Q tile in shared memory every key tile
//     instead of being held: 96 f32 of O plus 48 registers of Q would not
//     fit the 255.
//   * decode, split-K flash-decode in two launches: decode_split_kernel,
//     grid (ceil(T/128), KV, B) -- the grid comes from T, never from
//     kv_length, which lives on the device -- takes the H/KV query rows of
//     one kv head over a 128-key chunk, so K/V is read once per group,
//     16 bytes per lane (8 lanes per 64-dim row; 10 or 12 of a group of 16
//     at hd 80 and 96, 24 of a whole warp at hd 192, struct Dec), and
//     writes an f32 partial
//     (m, l, acc[hd]) per row (an empty one, l = 0, past the row's live
//     keys); decode_combine_kernel, grid (H, B), merges the partials.  This
//     part is bandwidth-bound, so it stays on the FMA pipes.
// Float32 inputs (the card-vs-CPU parity checks at smoke widths) take the
// FMA body flash_fwd_f32_kernel, one query row per thread pair (prefill) or
// one row per block (decode): TF32 products would break those checks.  It
// keeps a row's q and accumulator in registers, so at hd 128 and 192 it
// spills (ptxas reports how much); it is right, and off the paths' bf16.
//
// Left for later: wgmma (mma.sync keeps the causal product below the byte
// bound at these shapes), two 16-row m-tiles per warp for long prompts (each
// K/V fragment then feeds two products), a persistent grid, and fusing the
// decode combine into the split launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;     // a masked score
constexpr float kEmpty = -3e38f;      // running max of a state with no key yet
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kDecodeChunk = 128;     // keys per split-K decode CTA

// ---------------------------------------------------------------------------
// float32: the FMA body
// ---------------------------------------------------------------------------

// BK keys per shared tile: 2 x BK x (HD + 1) f32 of K and V stay under the
// 48 KB of static shared memory (16 keys at hd 192)
template <int HD> struct Tile {
  static constexpr int BK = HD <= 64 ? 64 : HD <= 128 ? 32 : 16;
};

// BQ query rows per block, KSPLIT threads splitting one row's keys.
template <int HD, int BQ, int KSPLIT>
__global__ void __launch_bounds__(BQ* KSPLIT)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ kv_len,
                     float* __restrict__ out, int S, int Tk, int H, int KV,
                     float scale, int causal) {
  constexpr int BK = Tile<HD>::BK;
  constexpr int NT = BQ * KSPLIT;
  constexpr int NJ = BK / KSPLIT;  // keys of a tile per thread
  static_assert(NJ >= 1, "KSPLIT must not exceed the key tile");
  // the lanes of a block narrower than a warp (decode at hd 192: 16 threads)
  constexpr unsigned FULL = NT >= 32 ? 0xffffffffu : (1u << NT) - 1u;
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
    qr[d] = row_ok ? q[(((long long)b * S + s_idx) * H + h) * HD + d] * scale : 0.f;

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
        kx = k[off];
        vx = v[off];
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
    const float m_o = __shfl_xor_sync(FULL, m_i, off);
    const float l_o = __shfl_xor_sync(FULL, l_i, off);
    const float m_n = fmaxf(m_i, m_o);
    const float c1 = expf(m_i - m_n), c2 = expf(m_o - m_n);
    l_i = l_i * c1 + l_o * c2;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      const float a_o = __shfl_xor_sync(FULL, acc[d], off);
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
    float* dst = out + (((long long)b * S + s_idx) * H + h) * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) dst[d] = acc[d] * inv;
  }
}

// ---------------------------------------------------------------------------
// bf16 building blocks: cp.async, ldmatrix, mma.sync
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; with `full` false the zero-fill form
// (src-size 0) reads nothing and writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the SFU, flushing subnormal results to 0 (the probabilities of a
// softmax lose nothing to that: they are summed with a 1 from the row max)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x = lo: low half
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ void unpack8(const uint4& w, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(p[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// ---------------------------------------------------------------------------
// bf16 prefill: tensor-core flash-attention forward
// ---------------------------------------------------------------------------

// The prefill kernel's shape per head dim: BK keys per K/V tile (one tile of
// 32 keys at hd 16 is less than one 16-byte copy per thread), MINB CTAs per
// SM the registers are capped for (the O accumulator is HD / 2 f32 a thread:
// 128 registers hold it without spills up to hd 64, 170 up to 96, 255 at
// 128 and 192), SMEM bytes of dynamic shared memory (Q, then 2 stages of K
// and V; over 48 KB at hd 128: 51 KB, and 77 KB at 192).
template <int HD> struct Mma {
  static constexpr int BQ = 64, STAGES = 2;
  static constexpr int BK = HD >= 32 ? 32 : 64;
  static constexpr int MINB = HD <= 64 ? 4 : (HD <= 96 ? 3 : 2);
  // Q's A-fragments live in registers up to hd 128; at 192 (96 f32 of O a
  // thread) they are read from the Q tile in shared memory every key tile
  static constexpr bool QREG = HD <= 128;
  static constexpr int LD = HD + 8;  // shared row stride (elements): +16 B, ldmatrix conflict-free
  static constexpr int SMEM = (BQ + 2 * STAGES * BK) * LD * 2;
};

// A CTA of 4 warps owns a 64-row query tile of one (b, h), 16 rows per warp;
// BK keys per K/V tile, in a 2-stage ring.
template <int HD>
__global__ void __launch_bounds__(128, Mma<HD>::MINB)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ kv_len, __nv_bfloat16* __restrict__ out,
                     int S, int Tk, int H, int KV, float scale, int causal) {
  constexpr int BQ = Mma<HD>::BQ, STAGES = Mma<HD>::STAGES, BK = Mma<HD>::BK;
  constexpr int LD = Mma<HD>::LD;
  constexpr int CPR = HD / 8;  // 16-byte chunks per row
  constexpr int KSTEPS = HD / 16;  // k-steps of Q K^T
  constexpr int NT = BK / 8;       // 8-key n-tiles of S
  constexpr int DT = HD / 8;       // 8-dim n-tiles of O
  // EVEN: a thread copies one 16-byte column of rows RSTEP apart (CPR
  // divides the CTA: hd 16, 64, 128); else (hd 80, 96: 10 or 12 chunks a
  // row) the CTA walks the tile's rows x CPR chunks with a stride of 128
  constexpr bool EVEN = 128 % CPR == 0 && BK % (128 / CPR) == 0;
  constexpr int RSTEP = EVEN ? 128 / CPR : 1;  // rows between one thread's copies
  static_assert(HD % 16 == 0 && BK % 16 == 0, "head dim and key tile: multiples of 16");
  extern __shared__ __align__(128) unsigned char fa_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(fa_smem);
  __nv_bfloat16* ks = qs + BQ * LD;
  __nv_bfloat16* vs = ks + STAGES * BK * LD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x, b = blockIdx.y;
  // grid (H, B, q-blocks): the q-blocks with the most key tiles (the last
  // rows under the causal mask) of every head are dispatched first
  const int r0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int kvh = h / (H / KV);
  const int len = kv_len != nullptr ? kv_len[b] : Tk;

  int limit = Tk;  // keys past it are masked for every row of the block
  if (len >= 1) {
    limit = min(len, Tk);
    if (causal) limit = min(limit, min(r0 + BQ, S));
  }
  const int n_tiles = (limit + BK - 1) / BK;
  const long long kv_stride = (long long)KV * HD;  // elements between keys

  // A thread copies the 16-byte column `ccol` of rows crow, crow + RSTEP,
  // ...: its source pointers advance one tile of keys per issue, its shared
  // addresses cycle over the stages.  Rows past S (Q) or past `limit` (K/V)
  // take the zero-fill form (src-size 0): nothing is read.
  const int crow = EVEN ? tid / CPR : 0, ccol = EVEN ? (tid % CPR) * 8 : 0;
  const __nv_bfloat16* qg = q + (((long long)b * S + r0) * H + h) * HD;
  if constexpr (EVEN) {
#pragma unroll
    for (int i = 0; i < BQ / RSTEP; ++i) {
      const int r = crow + i * RSTEP;
      cp_async16(smem_u32(&qs[r * LD + ccol]), qg + (long long)r * H * HD + ccol, r0 + r < S);
    }
  } else {
#pragma unroll
    for (int i = 0; i < (BQ * CPR + 127) / 128; ++i) {
      const int c = tid + i * 128, r = c / CPR, col = (c % CPR) * 8;
      if (c < BQ * CPR)
        cp_async16(smem_u32(&qs[r * LD + col]), qg + (long long)r * H * HD + col, r0 + r < S);
    }
  }
  const long long rstep = RSTEP * kv_stride;
  const long long kv0 = ((long long)b * Tk * KV + kvh) * HD;
  const __nv_bfloat16* kg = k + kv0 + crow * kv_stride + ccol;
  const __nv_bfloat16* vg = v + kv0 + crow * kv_stride + ccol;
  const uint32_t ks_dst = smem_u32(&ks[crow * LD + ccol]);
  const uint32_t vs_dst = smem_u32(&vs[crow * LD + ccol]);
  auto issue = [&](int tile) {  // tile's K and V into its stage: one commit group
    if (tile < n_tiles) {
      const uint32_t st = (tile % STAGES) * BK * LD * 2;
      if constexpr (EVEN) {
        const int r = tile * BK + crow;
#pragma unroll
        for (int i = 0; i < BK / RSTEP; ++i) {
          const bool ok = r + i * RSTEP < limit;
          const uint32_t so = st + i * RSTEP * LD * 2;
          cp_async16(ks_dst + so, kg + i * rstep, ok);
          cp_async16(vs_dst + so, vg + i * rstep, ok);
        }
        kg += BK * kv_stride;
        vg += BK * kv_stride;
      } else {
#pragma unroll
        for (int i = 0; i < (BK * CPR + 127) / 128; ++i) {
          const int c = tid + i * 128, r = c / CPR, col = (c % CPR) * 8;
          if (c < BK * CPR) {
            const int key = tile * BK + r;
            const long long off = kv0 + key * kv_stride + col;
            const uint32_t so = st + (r * LD + col) * 2;
            cp_async16(ks_dst + so, k + off, key < limit);
            cp_async16(vs_dst + so, v + off, key < limit);
          }
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) issue(t);  // Q joins tile 0's group

  uint32_t qa[Mma<HD>::QREG ? KSTEPS : 1][4];
  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  const float sl2 = scale * kLog2e;  // scores in the log2 domain: ex2 below
  const int row_g = r0 + warp * 16 + (lane >> 2);  // rows of d0/d1; +8 for d2/d3

  for (int j = 0; j < n_tiles; ++j) {
    issue(j + STAGES - 1);
    cp_async_wait<STAGES - 1>();  // tile j (and Q) have landed
    __syncthreads();
    const uint32_t q_row = smem_u32(&qs[(warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8]);
    if constexpr (Mma<HD>::QREG) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) ldsm_x4(qa[kk], q_row + kk * 32);
      }
    }
    const __nv_bfloat16* kt = ks + (j % STAGES) * BK * LD;
    const __nv_bfloat16* vt = vs + (j % STAGES) * BK * LD;

    // S = Q K^T, 16 x BK per warp
    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
    if constexpr (Mma<HD>::QREG) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int key = nt * 8 + (lane & 7);
#pragma unroll
        for (int kp = 0; kp < KSTEPS / 2; ++kp) {
          uint32_t bf[4];
          ldsm_x4(bf, smem_u32(&kt[key * LD + kp * 32 + (lane >> 3) * 8]));
          mma_bf16(sc[nt], qa[2 * kp], bf[0], bf[1]);
          mma_bf16(sc[nt], qa[2 * kp + 1], bf[2], bf[3]);
        }
        if constexpr (KSTEPS % 2) {  // hd 16 and 80: one k-step left
          uint32_t bf[2];
          ldsm_x2(bf, smem_u32(&kt[key * LD + (KSTEPS - 1) * 16 + ((lane >> 3) & 1) * 8]));
          mma_bf16(sc[nt], qa[KSTEPS - 1], bf[0], bf[1]);
        }
      }
    } else {
      // Q from shared memory, two k-steps at a time; each sc[nt] takes the
      // k-steps in the same order as above
      static_assert(KSTEPS % 2 == 0, "Q from shared memory: an even number of k-steps");
#pragma unroll
      for (int kp = 0; kp < KSTEPS / 2; ++kp) {
        uint32_t q0[4], q1[4];
        ldsm_x4(q0, q_row + kp * 64);
        ldsm_x4(q1, q_row + kp * 64 + 32);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t bf[4];
          ldsm_x4(bf, smem_u32(&kt[(nt * 8 + (lane & 7)) * LD + kp * 32 + (lane >> 3) * 8]));
          mma_bf16(sc[nt], q0, bf[0], bf[1]);
          mma_bf16(sc[nt], q1, bf[2], bf[3]);
        }
      }
    }

    // scale, and mask only the tiles that hold a masked key: the causal
    // diagonal alone (the common case) compares key and row, any other
    // mask (kv_length, keys past T) takes the general rule
    const int t0 = j * BK;
    const bool edge = t0 + BK > min(len, Tk) || len < 1;
    const bool diag = causal && t0 + BK - 1 > r0;
    // key t > row s  <=>  nt*8 + (e&1) - (e>>1)*8 > thr
    const int thr = r0 + warp * 16 + (lane >> 2) - t0 - (lane & 3) * 2;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[nt][e] * sl2;
        if (edge) {
          const int t = t0 + nt * 8 + (lane & 3) * 2 + (e & 1);
          const int s = row_g + (e >> 1) * 8;
          if (t >= Tk) x = -INFINITY;
          else if (!(t < len && (!causal || t <= s))) x = kNegInf;
        } else if (diag && nt * 8 + (e & 1) - (e >> 1) * 8 > thr) {
          x = kNegInf;
        }
        sc[nt][e] = x;
      }

    // online softmax on the fragments: a row lives in a quad of 4 lanes
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[nt][0], sc[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[nt][2], sc[nt][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float corr = ex2(m_r[r] - mx[r]);
      m_r[r] = mx[r];
      l_r[r] *= corr;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        o[dt][2 * r] *= corr;
        o[dt][2 * r + 1] *= corr;
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(sc[nt][e] - m_r[e >> 1]);
        sc[nt][e] = p;
        l_r[e >> 1] += p;  // this lane's share; the quad is summed at the end
      }

    // O += P V: P as bf16 A-fragments straight from the S accumulators
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
      const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, smem_u32(&vt[key * LD + dp * 16 + (lane >> 4) * 8]));
        mma_bf16(o[2 * dp], pa, bf[0], bf[1]);
        mma_bf16(o[2 * dp + 1], pa, bf[2], bf[3]);
      }
    }
    __syncthreads();  // the stage is free for tile j + STAGES
  }
  cp_async_wait<0>();

  // epilogue: normalize, stage through this warp's own Q rows, 16-byte stores
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    inv[r] = 1.f / fmaxf(l_r[r], 1e-30f);
  }
  __nv_bfloat16* os = qs + warp * 16 * LD;
  const int rr = lane >> 2, cc = (lane & 3) * 2;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    *reinterpret_cast<uint32_t*>(&os[rr * LD + dt * 8 + cc]) =
        pack_bf16(o[dt][0] * inv[0], o[dt][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(&os[(rr + 8) * LD + dt * 8 + cc]) =
        pack_bf16(o[dt][2] * inv[1], o[dt][3] * inv[1]);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * CPR / 32; ++i) {
    const int c = lane + i * 32, r = c / CPR, col = (c % CPR) * 8;
    const int s = r0 + warp * 16 + r;
    if (s < S)
      *reinterpret_cast<uint4*>(out + (((long long)b * S + s) * H + h) * HD + col) =
          *reinterpret_cast<const uint4*>(&os[r * LD + col]);
  }
}

// ---------------------------------------------------------------------------
// bf16 decode: split-K flash-decode (split launch, then combine launch)
// ---------------------------------------------------------------------------

// The decode split kernel's shape per head dim: a key row is LPR = HD / 8
// 16-byte chunks, held by a group of LP lanes (LPR rounded up to a power of
// two, so that a row's dot product and the key groups of a warp reduce by
// xor shuffles; at hd 80, 96 and 192 the lanes past LPR hold nothing); NKG
// key groups of LP lanes, KPT keys a thread, NTH threads in NW warps (256
// at LP 16 and 512 at LP 32, a whole warp a row at hd 192, so that a
// thread's keys stay at 8: 64 registers of K and V).
template <int HD> struct Dec {
  static constexpr int LPR = HD / 8;
  static constexpr int LP = LPR <= 2 ? 2 : LPR <= 4 ? 4 : LPR <= 8 ? 8 : LPR <= 16 ? 16 : 32;
  static constexpr int NTH = LP * 16 > 128 ? LP * 16 : 128;
  static constexpr int NKG = NTH / LP;
  static constexpr int KPT = kDecodeChunk / NKG;
  static constexpr int NW = NTH / 32;
  // V rows held in registers beside K (up to hd 128); at hd 192 the 512
  // threads have 128 registers each, and a thread loads its V rows where it
  // weighs them (G = 1 at DeepSeek-V2-Lite's 16/16 heads: each is read once)
  static constexpr bool VHOLD = HD <= 128;
};

// Partials: (B, H, n_chunks, HD + 2) f32, each (m, l, acc[HD]) with acc
// unnormalized; an empty partial (chunk past the row's live keys) is
// (kEmpty, 0) and its acc is never read.
template <int HD>
__global__ void __launch_bounds__(Dec<HD>::NTH)
decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const int* __restrict__ kv_len, float* __restrict__ part, int Tk,
                    int H, int KV, float scale) {
  constexpr int LPR = Dec<HD>::LPR, LP = Dec<HD>::LP, NTH = Dec<HD>::NTH;
  constexpr int NKG = Dec<HD>::NKG, KPT = Dec<HD>::KPT, NW = Dec<HD>::NW;
  constexpr int PS = HD + 2;
  static_assert(LPR >= 1 && LPR <= LP && KPT >= 1 && PS <= NTH, "head dim out of range");
  __shared__ float red[2][NW][PS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_chunks = gridDim.x, G = H / KV;
  const int len = kv_len != nullptr ? kv_len[b] : Tk;
  const int limit = len >= 1 ? min(len, Tk) : Tk;  // kv_length 0: all T keys
  const int t0 = chunk * kDecodeChunk;
  const long long row_stride = (long long)n_chunks * PS;  // between query rows
  float* pb = part + ((long long)b * H + kvh * G) * row_stride + chunk * PS;
  if (t0 >= limit) {
    for (int g = tid; g < G; g += NTH) {
      pb[g * row_stride] = kEmpty;
      pb[g * row_stride + 1] = 0.f;
    }
    return;
  }

  const int li = tid % LP, kg = tid / LP;
  const bool row_lane = li < LPR;  // holds a 16-byte chunk of the row
  const long long kv_stride = (long long)KV * HD;
  const long long base = ((long long)b * Tk * KV + kvh) * HD + li * 8;
  constexpr bool VHOLD = Dec<HD>::VHOLD;
  uint4 kr[KPT], vr[VHOLD ? KPT : 1];
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const int t = t0 + kg + i * NKG;
    kr[i] = make_uint4(0u, 0u, 0u, 0u);
    if constexpr (VHOLD) vr[i] = kr[i];
    if (row_lane && t < limit) {
      kr[i] = __ldg(reinterpret_cast<const uint4*>(k + base + t * kv_stride));
      if constexpr (VHOLD)
        vr[i] = __ldg(reinterpret_cast<const uint4*>(v + base + t * kv_stride));
    }
  }

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    float qf[8];
    unpack8(row_lane ? __ldg(reinterpret_cast<const uint4*>(q + ((long long)b * H + h) * HD +
                                                            li * 8))
                     : make_uint4(0u, 0u, 0u, 0u),
            qf);
#pragma unroll
    for (int e = 0; e < 8; ++e) qf[e] *= scale;
    float s[KPT];
    float m = kEmpty;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      float kf[8];
      unpack8(kr[i], kf);
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) dot = fmaf(qf[e], kf[e], dot);
#pragma unroll
      for (int off = LP / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      s[i] = len >= 1 ? dot : kNegInf;
      if (t0 + kg + i * NKG < limit) m = fmaxf(m, s[i]);
    }
    float l = 0.f, acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.f;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int t = t0 + kg + i * NKG;
      const float p = t < limit ? expf(s[i] - m) : 0.f;
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if constexpr (VHOLD) {
        vv = vr[i];
      } else if (row_lane && t < limit) {
        vv = __ldg(reinterpret_cast<const uint4*>(v + base + t * kv_stride));
      }
      float vf[8];
      unpack8(vv, vf);
      l += p;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = fmaf(p, vf[e], acc[e]);
    }
    // merge the warp's key groups (lanes that differ above the row lanes)
#pragma unroll
    for (int off = LP; off < 32; off <<= 1) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m, off);
      const float l_o = __shfl_xor_sync(0xffffffffu, l, off);
      const float m_n = fmaxf(m, m_o);
      const float c1 = expf(m - m_n), c2 = expf(m_o - m_n);
      l = l * c1 + l_o * c2;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[e] = acc[e] * c1 + __shfl_xor_sync(0xffffffffu, acc[e], off) * c2;
      m = m_n;
    }
    // then the NW warps, through shared memory (double-buffered by g)
    float* rw = red[g & 1][warp];
    if (lane < LPR) {
      if (lane == 0) {
        rw[0] = m;
        rw[1] = l;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) rw[2 + lane * 8 + e] = acc[e];
    }
    __syncthreads();
    if (tid < PS) {
      const float(*rd)[PS] = red[g & 1];
      float mm = rd[0][0];
#pragma unroll
      for (int w = 1; w < NW; ++w) mm = fmaxf(mm, rd[w][0]);
      float val = mm;
      if (tid >= 1) {
        val = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) val += expf(rd[w][0] - mm) * rd[w][tid];
      }
      pb[g * row_stride + tid] = val;
    }
  }
}

// One block of whole warps per (h, b), one thread per output dim.
template <int HD> constexpr int combine_threads() { return (HD + 31) / 32 * 32; }

template <int HD>
__global__ void __launch_bounds__(combine_threads<HD>())
decode_combine_kernel(const float* __restrict__ part, __nv_bfloat16* __restrict__ out,
                      int H, int n_chunks) {
  constexpr int PS = HD + 2;
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  if (d >= HD) return;
  const float* p = part + ((long long)b * H + h) * n_chunks * PS;
  float mm = kEmpty;
  for (int c = 0; c < n_chunks; ++c)
    if (p[c * PS + 1] > 0.f) mm = fmaxf(mm, p[c * PS]);
  float num = 0.f, den = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const float l = p[c * PS + 1];
    if (l > 0.f) {  // empty partials are skipped
      const float w = expf(p[c * PS] - mm);
      den += w * l;
      num += w * p[c * PS + 2 + d];
    }
  }
  out[((long long)b * H + h) * HD + d] = __float2bfloat16_rn(num / fmaxf(den, 1e-30f));
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const int* kv_len,
                       void* out, int B, int S, int Tk, int H, int KV, float scale,
                       int causal, int decode, cudaStream_t st) {
  const float *qf = (const float*)q, *kf = (const float*)k, *vf = (const float*)v;
  if (decode) {
    constexpr int KS = Tile<HD>::BK;
    flash_fwd_f32_kernel<HD, 1, KS><<<dim3(S, H, B), KS, 0, st>>>(
        qf, kf, vf, kv_len, (float*)out, S, Tk, H, KV, scale, causal);
  } else {
    constexpr int BQ = 64;
    flash_fwd_f32_kernel<HD, BQ, 2><<<dim3((S + BQ - 1) / BQ, H, B), BQ * 2, 0, st>>>(
        qf, kf, vf, kv_len, (float*)out, S, Tk, H, KV, scale, causal);
  }
  return cudaGetLastError();
}

// The prefill kernel's opt-in to more than 48 KB of dynamic shared memory,
// set once per device (the attribute lasts for the process).
template <int HD>
cudaError_t opt_in_smem(int smem) {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_fwd_mma_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const int* kv_len,
                        void* out, float* partial, int B, int S, int Tk, int H, int KV,
                        float scale, int causal, int decode, cudaStream_t st) {
  using bf = __nv_bfloat16;
  if (!decode) {
    constexpr int smem = Mma<HD>::SMEM;
    if (smem > 48 * 1024) {  // past the static limit: opt in to more
      const cudaError_t err = opt_in_smem<HD>(smem);
      if (err != cudaSuccess) return err;
    }
    flash_fwd_mma_kernel<HD><<<dim3(H, B, (S + Mma<HD>::BQ - 1) / Mma<HD>::BQ), 128, smem, st>>>(
        (const bf*)q, (const bf*)k, (const bf*)v, kv_len, (bf*)out, S, Tk, H, KV, scale,
        causal);
    return cudaGetLastError();
  }
  const int n_chunks = (Tk + kDecodeChunk - 1) / kDecodeChunk;
  decode_split_kernel<HD><<<dim3(n_chunks, KV, B), Dec<HD>::NTH, 0, st>>>(
      (const bf*)q, (const bf*)k, (const bf*)v, kv_len, partial, Tk, H, KV, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || decode == 2) return err;  // 2: the partials only
  decode_combine_kernel<HD><<<dim3(H, B), combine_threads<HD>(), 0, st>>>(partial, (bf*)out, H,
                                                                      n_chunks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, S, H, HD), k/v (B, T, KV, HD), out like q, all contiguous and
// 16-byte aligned, one dtype (bf16 when `bf16`, else float32).  kv_len: (B,)
// int32 device pointer or null (= T).  `decode` selects the decode launch
// (S == 1, not causal): for bf16 the split-K pair, which needs `partial`, an
// f32 scratch of B * H * ceil(T / chunk) * (HD + 2), with `chunk` equal to
// the kernel's keys per split CTA; `decode` 2 launches the split alone and
// leaves the partials (m, l, acc) there (a cache split across ranks merges
// them with decode_combine_launch).  Returns a cudaError_t (0 = launched).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           const int* kv_len, void* out, float* partial, int B, int S,
                           int Tk, int H, int KV, int HD, float scale, int causal,
                           int decode, int bf16, int chunk, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (KV < 1 || H % KV != 0 || Tk < 1) return (int)cudaErrorInvalidValue;
  if (bf16 && decode &&
      (partial == nullptr || chunk != kDecodeChunk || S != 1 || causal))
    return (int)cudaErrorInvalidValue;
  if (decode == 2 && !bf16) return (int)cudaErrorInvalidValue;
  // the registry's head dims: 16 (smoke configs), 64 (MiniCPM-2B), 80
  // (StableLM-3B), 96 (Phi-3-mini), 128 (InternLM2-20B, DeepSeekMoE-16B),
  // 192 (DeepSeek-V2-Lite's MLA: qk_nope 128 + qk_rope 64, v padded to 192)
#define FA_CASE(D)                                                                      \
  case D:                                                                               \
    return bf16 ? (int)launch_bf16<D>(q, k, v, kv_len, out, partial, B, S, Tk, H, KV,    \
                                      scale, causal, decode, st)                        \
                : (int)launch_f32<D>(q, k, v, kv_len, out, B, S, Tk, H, KV, scale, causal, \
                                     decode, st);
  switch (HD) {
    FA_CASE(16)
    FA_CASE(64)
    FA_CASE(80)
    FA_CASE(96)
    FA_CASE(128)
    FA_CASE(192)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FA_CASE
}

// Merge the decode partials `partial` (B, H, n_chunks, HD + 2) f32 into the
// bf16 output (B, H, HD): the combine launch alone, over chunks gathered
// from several ranks' slices of one cache.
int decode_combine_launch(const float* partial, void* out, int B, int H, int n_chunks,
                          int HD, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B < 1 || H < 1 || n_chunks < 1) return (int)cudaErrorInvalidValue;
#define DC_CASE(D)                                                                  \
  case D:                                                                           \
    decode_combine_kernel<D><<<dim3(H, B), combine_threads<D>(), 0, st>>>(          \
        partial, (__nv_bfloat16*)out, H, n_chunks);                                 \
    return (int)cudaGetLastError();
  switch (HD) {
    DC_CASE(16)
    DC_CASE(64)
    DC_CASE(80)
    DC_CASE(96)
    DC_CASE(128)
    DC_CASE(192)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DC_CASE
}

}  // extern "C"
