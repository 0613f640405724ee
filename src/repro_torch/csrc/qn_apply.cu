// Quasi-Newton inverse kernels for Hopper (sm_90a): the SHINE hot path.
//
//   H x   = alpha x + sum_i mask[i,b] u[i,b,:] <v[i,b,:], x>
//   H^T x = alpha x + sum_i mask[i,b] v[i,b,:] <u[i,b,:], x>
//
// Replaces the Pallas TPU kernels of repro/kernels/qn_apply.py:
//   * qn_apply_multi_pallas (_make_coeff_multi_kernel, _make_apply_multi_kernel):
//     out[k] = (H^T if transpose[k] else H) xs[k] for K <= 4 stacked right-hand
//     sides; qn_apply_pallas (_coeff_kernel, _apply_kernel) is its K=1 case and
//     launches the same kernel (qn_kernel);
//   * broyden_step_pallas (_make_broyden_step_kernel): one whole Broyden
//     iteration -- H g_new, H^T s, den = s^T H y and the guarded ring-slot
//     write of the rank-one pair a = (s - H y)/den, b = H^T s (broyden_kernel);
//   * lowrank_append_pallas (_append_kernel): that ring-slot write alone
//     (lowrank_append_kernel, one launch over row slot[b] only).
//
// What bounds it: bytes.  ~2 flops per ring byte, far below the H100's ~295
// flop/byte ridge.  Two shapes matter (m=8, B=4, bf16 ring):
//   * prefill / training, D = 256*2304: the (m, B, D) U/V ring is 75.5 MB
//     against a 50 MB L2.  broyden_step's bound (each input read once, each
//     output written once) is 139 MB, 0.042 ms at 3.35 TB/s; qn_apply_multi
//     K=1 reads the 75.5 MB ring and 9.4 MB of x and writes 9.4 MB: 94 MB,
//     0.028 ms.  Every element's
//     coefficients are sums over all of D, so the apply cannot start before
//     every byte of the coefficient pass has been read: a second pass over
//     the ring is unavoidable, and what it costs is the question;
//   * decode, D = 2304: 0.6 MB in all, a 0.2 us bound; the time is launch
//     latency and one round trip to memory.
//
// Design: one launch per op, one structure for both ops.  Ring row i is one
// contiguous B*D vector; each CTA owns a contiguous slice of it (`plan` in
// kernels/qn_apply.py) and walks the slice in tiles of NT*EPT elements:
// thread t owns one 16-byte chunk of every ring row and every f32 vector of
// a tile, and is the only thread that reads it.  Tiles are staged into a
// ring of `nbuf` shared-memory buffers by cp.async.cg 16-byte copies,
// `pref` tiles in flight:
//   1. phase 1 walks the slice forward and accumulates the f32 coefficient
//      partials (and broyden_step's s.g, s.hg); at each sample boundary the
//      block reduces them (warp shuffles, one shared step, fixed order);
//   2. the partials of a sample are summed over its CTAs in a fixed order:
//      through a (B, n_cta, P) scratch after one cooperative grid barrier
//      (streaming), or through the shared memory of the sample's thread-
//      block cluster (resident).  No atomics: every CTA gets the same sums,
//      bit for bit, and two calls give the same outputs;
//   3. phase 2 walks the slice backward: the last nbuf tiles of phase 1 are
//      still in shared memory and are used without a reload, and the tiles
//      reloaded next are the ones phase 1 read last, which phase 1 marked
//      evict_last in the L2 (every other load is evict_first).  It emits
//      out (or hg_new, b, the evicted rows and the guarded slot rows).  A
//      CTA writes only ring elements of its own slice, after the barrier
//      that ends every CTA's phase 1, and each after it has read them: no
//      read-after-write race crosses CTAs.
// Schedules (chosen by `plan`):
//   * resident, D <= 4096 (the decode shape): one cluster of <= 8 CTAs per
//     sample, each holding its <= 512-element slice whole in shared memory;
//     every byte is read once, and there is no scratch and no grid barrier;
//   * streaming, the prefill and training shapes: a persistent cooperative
//     grid (SMs x the CTAs per SM the occupancy query allows, two at the
//     paths' shapes) of equal slices of B*D, at most two samples each.
//     With B at least the co-resident CTAs, each sample is its own slice
//     and the launch needs no barrier.
// Loads: 16-byte cp.async where D % (16 / itemsize) == 0 and the pointers
// are 16-byte aligned (template VEC=1, chosen once per call); else the
// masked scalar path (VEC=0), per element, for the ragged edge.  No padding
// of m or D.  The ring memory is a template bound (M = 8, 16, 32; rows past
// m predicated), K <= 4 (KT = 1 or 4).  f32 accumulation everywhere; ring
// writes round to nearest even in the storage type; evicted rows are copies
// of the raw storage bits.
// What is left (PERF.md): phase 2 still reloads what neither shared memory
// nor the L2 kept; the m rows of a tile are read in lockstep, a pattern
// that streams slower than one linear read on the H100; the grid barrier
// waits for the slowest CTA; and a decode-sized call is one memory round
// trip plus launch latency.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // lowrank_append
constexpr int kKMax = 4;
constexpr int kMaxPref = 8;  // tiles in flight per CTA (pref < nbuf)
// dynamic shared memory a CTA may take (227 KB less the kernels' static
// reduction scratch); kernels/qn_apply.py sizes nbuf within SMEM_BUDGET
constexpr int kSmemMax = 220 * 1024;
constexpr int kLoadU = 1, kLoadV = 2, kLoadX = 4;
// threads per CTA of the stream kernels: kThreadRows / M, so that a tile
// (one 16-byte chunk per thread of each of the 2m ring rows) stays ~32 KB
constexpr int kThreadRows = 1024;

// ---------------------------------------------------------------------------
// element access
// ---------------------------------------------------------------------------

template <int BF16>
struct Ring;
template <>
struct Ring<1> {
  using T = __nv_bfloat16;
  static constexpr int kEpt = 8;  // elements per 16-byte chunk
};
template <>
struct Ring<0> {
  using T = float;
  static constexpr int kEpt = 4;
};

// 16 bytes global -> shared, bypassing L1; `policy` (from l2_policy) tells
// the L2 how long to keep the line
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, uint64_t policy) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "l"(policy)
               : "memory");
}

// an L2 eviction policy: keep the lines (evict_last) or let them go first
__device__ __forceinline__ uint64_t l2_policy(bool keep) {
  uint64_t p;
  if (keep)
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
  else
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wait until at most n (< kMaxPref) groups are pending
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// a 16-byte chunk of ring storage to f32 (bf16 -> f32 is exact)
__device__ __forceinline__ void unpack(const uint4& r, float (&x)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    x[2 * j] = __uint_as_float(w[j] << 16);
    x[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack(const uint4& r, float (&x)[4]) {
  x[0] = __uint_as_float(r.x);
  x[1] = __uint_as_float(r.y);
  x[2] = __uint_as_float(r.z);
  x[3] = __uint_as_float(r.w);
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// f32 -> a 16-byte chunk of ring storage, rounding to nearest even
__device__ __forceinline__ uint4 pack(const float (&x)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) w[j] = bf16_bits(x[2 * j]) | (bf16_bits(x[2 * j + 1]) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint4 pack(const float (&x)[4]) {
  return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]), __float_as_uint(x[2]),
                    __float_as_uint(x[3]));
}

// element e of a packed chunk, as raw storage
__device__ __forceinline__ void put_raw(__nv_bfloat16* p, const uint4& r, int e) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
  *p = __ushort_as_bfloat16((unsigned short)(w[e >> 1] >> (16 * (e & 1))));
}

__device__ __forceinline__ void put_raw(float* p, const uint4& r, int e) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
  *p = __uint_as_float(w[e]);
}

__device__ __forceinline__ void from_f32(__nv_bfloat16& d, float x) { d = __float2bfloat16_rn(x); }
__device__ __forceinline__ void from_f32(float& d, float x) { d = x; }

// Which elements of thread chunk [f, f + EPT) lie in [lo, hi).  With VEC the
// chunk lies wholly in or out (slices and sample boundaries are multiples of
// EPT); the scalar path tests each element.
template <int VEC, int EPT>
__device__ __forceinline__ bool chunk_mask(long long f, long long lo, long long hi,
                                           bool (&ok)[EPT]) {
  bool any = false;
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    ok[e] = VEC ? (f >= lo && f < hi) : (f + e >= lo && f + e < hi);
    any |= ok[e];
  }
  return any;
}

template <int VEC, int EPT>
__device__ __forceinline__ void store_f32(float* p, const float (&x)[EPT],
                                          const bool (&ok)[EPT]) {
  if (VEC) {
#pragma unroll
    for (int h = 0; h < EPT / 4; ++h)
      reinterpret_cast<float4*>(p)[h] = make_float4(x[4 * h], x[4 * h + 1], x[4 * h + 2],
                                                    x[4 * h + 3]);
  } else {
#pragma unroll
    for (int e = 0; e < EPT; ++e)
      if (ok[e]) p[e] = x[e];
  }
}

template <int VEC, typename T, int EPT>
__device__ __forceinline__ void store_raw(T* p, const uint4& r, const bool (&ok)[EPT]) {
  if (VEC) {
    *reinterpret_cast<uint4*>(p) = r;
  } else {
#pragma unroll
    for (int e = 0; e < EPT; ++e)
      if (ok[e]) put_raw(p + e, r, e);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// tot[a] = sum over the block of acc[a], in a fixed order
template <int P, int NT>
__device__ __forceinline__ void block_reduce(const float (&acc)[P], float* red, float* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int a = 0; a < P; ++a) {
    const float s = warp_sum(acc[a]);
    if (lane == 0) red[warp * P + a] = s;
  }
  __syncthreads();
  for (int a = threadIdx.x; a < P; a += NT) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) s += red[w * P + a];
    tot[a] = s;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// the streaming walk shared by qn_kernel and broyden_kernel
// ---------------------------------------------------------------------------

struct StreamArgs {
  void* u;                    // ring (m, B, D), storage type
  void* v;
  const float* vec[kKMax];    // f32 (B, D) inputs: xs[k]; or g, s, hg_old
  float* out[kKMax];          // f32 (B, D) outputs: out[k]; or hg_new, b
  void* ev_u;                 // broyden: evicted rows (B, D), storage type
  void* ev_v;
  float* den;                 // broyden: (B,)
  const float* mask;          // (m, B)
  const float* alpha;         // 0-d
  const int* slot;            // broyden: (B,)
  const unsigned char* active;  // broyden: (B,) bool
  float eps;
  float* partial;             // (B, n_cta, P) when slices cross CTAs, else null
  long long D;
  long long slice;            // elements per CTA
  // csize 0: CTA c owns [c * slice, (c + 1) * slice) of B*D (cooperative);
  // csize >= 1: CTA c is rank c % csize of sample c / csize's cluster and
  // owns that rank's slice of the sample
  int csize;
  // phase 1 marks the l2_tiles tiles before the ones that stay in shared
  // memory evict_last in the L2 (phase 2 reads them next), every other
  // load evict_first
  int l2_tiles;
  int m, B, K, tmask, n_cta, nbuf, pref, coop;
};

// A tile's shared-memory buffer: m u rows, m v rows (TILE storage elements
// each), then nvec f32 vectors of TILE; vector sub-chunk h of thread t sits
// at (h * NT + t) * 4 floats, so a warp's 16-byte reads never share a bank.
template <int BF16, int NT>
struct Tile {
  using T = typename Ring<BF16>::T;
  static constexpr int EPT = Ring<BF16>::kEpt, TILE = NT * EPT;
  static __host__ __device__ long long bytes(int m, int nvec) {
    return (long long)2 * m * TILE * sizeof(T) + (long long)nvec * TILE * sizeof(float);
  }
};

// Stage tile [ft, min(ft + TILE, f1)) of the needed parts into buf: thread t
// copies its own chunk of each needed row and vector.  One commit group per
// call, empty or not.
template <int BF16, int M, int NT, int VEC>
__device__ __forceinline__ void load_tile(const StreamArgs& a, int nvec, unsigned char* buf,
                                          long long ft, long long f1, int parts,
                                          uint64_t policy) {
  using TL = Tile<BF16, NT>;
  using T = typename TL::T;
  constexpr int EPT = TL::EPT, TILE = TL::TILE;
  const int t = threadIdx.x;
  const long long f = ft + (long long)t * EPT;
  const long long bd = (long long)a.B * a.D;
  T* su = reinterpret_cast<T*>(buf) + t * EPT;
  float* sx = reinterpret_cast<float*>(buf + (long long)2 * a.m * TILE * sizeof(T));
  const T* gu = static_cast<const T*>(a.u) + f;
  const T* gv = static_cast<const T*>(a.v) + f;
  if (VEC) {
    if (f < f1) {
#pragma unroll
      for (int i = 0; i < M; ++i) {
        if (i < a.m) {
          if (parts & kLoadU) cp_async16(su + i * TILE, gu + i * bd, policy);
          if (parts & kLoadV) cp_async16(su + (a.m + i) * TILE, gv + i * bd, policy);
        }
      }
#pragma unroll
      for (int k = 0; k < kKMax; ++k)
        if (k < nvec && (parts & kLoadX))
#pragma unroll
          for (int h = 0; h < EPT / 4; ++h)
            cp_async16(sx + k * TILE + (h * NT + t) * 4, a.vec[k] + f + 4 * h, policy);
    }
  } else {
    const int n = f < f1 ? (int)(f1 - f < EPT ? f1 - f : EPT) : 0;
#pragma unroll 1
    for (int i = 0; i < M; ++i) {
      if (i < a.m) {
#pragma unroll
        for (int e = 0; e < EPT; ++e) {
          if (parts & kLoadU) su[i * TILE + e] = e < n ? gu[i * bd + e] : T(0.f);
          if (parts & kLoadV) su[(a.m + i) * TILE + e] = e < n ? gv[i * bd + e] : T(0.f);
        }
      }
    }
#pragma unroll 1
    for (int k = 0; k < kKMax; ++k)
      if (k < nvec && (parts & kLoadX))
#pragma unroll
        for (int e = 0; e < EPT; ++e)
          sx[k * TILE + ((e >> 2) * NT + t) * 4 + (e & 3)] = e < n ? a.vec[k][f + e] : 0.f;
  }
  cp_async_commit();
}

// thread t's chunk of ring row r (0..m-1 u, m..2m-1 v) and of vector k
template <int BF16, int NT>
__device__ __forceinline__ uint4 ring_chunk(const unsigned char* buf, int r) {
  return reinterpret_cast<const uint4*>(buf)[(long long)r * NT + threadIdx.x];
}

template <int BF16, int NT, int VEC, int EPT>
__device__ __forceinline__ void vec_chunk(const unsigned char* buf, int m, int k,
                                          const bool (&ok)[EPT], float (&x)[EPT]) {
  using TL = Tile<BF16, NT>;
  const float4* sx = reinterpret_cast<const float4*>(
      buf + (long long)2 * m * TL::TILE * sizeof(typename TL::T) +
      (long long)k * TL::TILE * sizeof(float));
#pragma unroll
  for (int h = 0; h < EPT / 4; ++h) {
    const float4 q = sx[h * NT + threadIdx.x];
    // the scalar path zeroes the elements outside [lo, hi)
    x[4 * h] = VEC || ok[4 * h] ? q.x : 0.f;
    x[4 * h + 1] = VEC || ok[4 * h + 1] ? q.y : 0.f;
    x[4 * h + 2] = VEC || ok[4 * h + 2] ? q.z : 0.f;
    x[4 * h + 3] = VEC || ok[4 * h + 3] ? q.w : 0.f;
  }
}

template <int VEC, int EPT>
__device__ __forceinline__ void ring_f32(const uint4& r, const bool (&ok)[EPT],
                                         float (&x)[EPT]) {
  unpack(r, x);
#pragma unroll
  for (int e = 0; e < EPT; ++e) x[e] = VEC || ok[e] ? x[e] : 0.f;
}

template <int EPT>
__device__ __forceinline__ float dot(const float (&a)[EPT], const float (&b)[EPT]) {
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < EPT; ++e) s = fmaf(a[e], b[e], s);
  return s;
}

// The walk: phase 1 forward (Op::accumulate, a block reduction at each
// sample boundary), the partials' exchange, phase 2 backward (Op::setup per
// sample, Op::emit per tile).
template <class Op>
__device__ __forceinline__ void stream_walk(const StreamArgs& a, Op& op) {
  constexpr int NT = Op::NT, TILE = Op::TILE, P = Op::P;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[(NT / 32) * P];
  __shared__ float tot[P];
  const int c = blockIdx.x;
  const long long D = a.D, bd = (long long)a.B * D;
  long long f0, f1;
  if (a.csize) {
    const long long b0 = c / a.csize, end = (b0 + 1) * D;
    f0 = b0 * D + (long long)(c % a.csize) * a.slice;
    f0 = f0 < end ? f0 : end;
    f1 = f0 + a.slice < end ? f0 + a.slice : end;
  } else {
    f0 = (long long)c * a.slice;
    f1 = f0 + a.slice < bd ? f0 + a.slice : bd;
  }
  const int ntiles = f1 > f0 ? (int)((f1 - f0 + TILE - 1) / TILE) : 0;
  const int keep = ntiles > a.nbuf ? ntiles - a.nbuf : 0;  // tiles >= keep stay
  const long long stage = Op::stage_bytes(a);
  auto buf = [&](int j) { return smem + (long long)(j % a.nbuf) * stage; };
  // the tiles that stay in shared memory take phase 2's parts too
  auto parts1 = [&](int j) { return j >= keep ? op.load1 | op.load2 : op.load1; };
  const uint64_t evict_first = l2_policy(false), evict_last = l2_policy(true);
  auto hint1 = [&](int j) {
    return j < keep && j >= keep - a.l2_tiles ? evict_last : evict_first;
  };

  // phase 1: forward
  for (int i = threadIdx.x; i < P; i += NT) tot[i] = 0.f;  // an empty slice
  float acc[P];
#pragma unroll
  for (int i = 0; i < P; ++i) acc[i] = 0.f;
  for (int p = 0; p < a.pref; ++p) {
    if (p < ntiles) op.load(buf(p), f0 + (long long)p * TILE, f1, parts1(p), hint1(p));
    else cp_async_commit();
  }
  int sb = ntiles ? (int)(f0 / D) : 0;
  long long lo = f0, hi = (long long)(sb + 1) * D < f1 ? (long long)(sb + 1) * D : f1;
  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait_n(a.pref - 1);
    const int jn = j + a.pref;
    if (jn < ntiles) op.load(buf(jn), f0 + (long long)jn * TILE, f1, parts1(jn), hint1(jn));
    else cp_async_commit();
    const long long ft = f0 + (long long)j * TILE;
    const long long te = ft + TILE < f1 ? ft + TILE : f1;
    for (;;) {
      op.accumulate(buf(j), ft, lo, hi, acc);
      if (hi > te) break;  // the sample goes on in the next tile
      block_reduce<P, NT>(acc, red, tot);
#pragma unroll
      for (int i = 0; i < P; ++i) acc[i] = 0.f;
      if (a.partial)
        for (int i = threadIdx.x; i < P; i += NT)
          a.partial[((long long)sb * a.n_cta + c) * P + i] = tot[i];
      if (hi >= f1) break;
      ++sb;
      lo = hi;
      hi = hi + D < f1 ? hi + D : f1;
      if (lo >= te) break;
    }
  }

  // every CTA's partials, folded in ascending CTA order: across the grid
  // through the scratch (fold, below), or across the sample's cluster
  // through its CTAs' shared memory; a CTA alone with its sample already
  // holds the sum in tot
  if (a.coop) cooperative_groups::this_grid().sync();
  if (a.csize > 1) {
    cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
    cl.sync();  // every rank's tot is final
    constexpr int kPer = (P + NT - 1) / NT;
    float sum[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = threadIdx.x + j * NT;
      sum[j] = 0.f;
      if (i < P)
        for (int r = 0; r < a.csize; ++r) sum[j] += cl.map_shared_rank(tot, r)[i];
    }
    cl.sync();  // every rank has read every tot
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (threadIdx.x + j * NT < P) tot[threadIdx.x + j * NT] = sum[j];
  }
  auto fold = [&](int b) {
    __syncthreads();  // every thread has read the previous sample's tot
    if (a.partial) {
      const long long c0 = (long long)b * D / a.slice;
      long long c1 = ((long long)(b + 1) * D - 1) / a.slice;
      c1 = c1 < a.n_cta - 1 ? c1 : a.n_cta - 1;
      for (int i = threadIdx.x; i < P; i += NT) {
        float s = 0.f;
        for (long long cc = c0; cc <= c1; ++cc) s += a.partial[((long long)b * a.n_cta + cc) * P + i];
        tot[i] = s;
      }
    }
    __syncthreads();
    op.setup(tot, b, (long long)b * D >= f0);
  };

  // phase 2: backward
  if (ntiles == 0) return;
  sb = (int)((f1 - 1) / D);
  hi = f1;
  lo = (long long)sb * D > f0 ? (long long)sb * D : f0;
  fold(sb);
  for (int j = ntiles - 1; j >= 0; --j) {
    cp_async_wait_n(a.pref - 1);
    const int jn = j - a.pref;  // reload a tile that did not stay
    if (jn >= 0 && jn < keep)
      op.load(buf(jn), f0 + (long long)jn * TILE, f1, op.load2, evict_first);
    else cp_async_commit();
    const long long ft = f0 + (long long)j * TILE;
    for (;;) {
      op.emit(buf(j), ft, lo, hi);
      if (lo < ft || lo <= f0) break;  // the sample goes on in the previous tile
      --sb;
      hi = lo;
      lo = (long long)sb * D > f0 ? (long long)sb * D : f0;
      fold(sb);
      if (hi <= ft) break;
    }
  }
}

// ---------------------------------------------------------------------------
// qn_apply_multi: out[k] = (H^T if bit k of tmask else H) xs[k]
// ---------------------------------------------------------------------------

template <int BF16, int M, int KT, int VEC>
struct QnOp {
  using TL = Tile<BF16, kThreadRows / M>;
  using T = typename TL::T;
  static constexpr int NT = kThreadRows / M, EPT = TL::EPT, TILE = TL::TILE, P = KT * M;
  const StreamArgs& a;
  int load1, load2;  // phase 1: the coefficient rows; phase 2: the apply rows
  float alpha;
  float cf[P];
  int b = 0;

  __device__ explicit QnOp(const StreamArgs& args) : a(args) {
    const bool any_t = a.tmask != 0, any_f = a.tmask != (1 << a.K) - 1;
    load1 = (any_t ? kLoadU : 0) | (any_f ? kLoadV : 0) | kLoadX;
    load2 = (any_f ? kLoadU : 0) | (any_t ? kLoadV : 0) | kLoadX;
    alpha = *a.alpha;
  }
  static __device__ long long stage_bytes(const StreamArgs& a) { return TL::bytes(a.m, a.K); }

  __device__ void load(unsigned char* buf, long long ft, long long f1, int parts,
                       uint64_t policy) const {
    load_tile<BF16, M, NT, VEC>(a, a.K, buf, ft, f1, parts, policy);
  }

  __device__ void accumulate(const unsigned char* buf, long long ft, long long lo,
                             long long hi, float (&acc)[P]) const {
    bool ok[EPT];
    if (!chunk_mask<VEC, EPT>(ft + (long long)threadIdx.x * EPT, lo, hi, ok)) return;
    float x[KT][EPT];
#pragma unroll
    for (int k = 0; k < KT; ++k)
      if (k < a.K) vec_chunk<BF16, NT, VEC, EPT>(buf, a.m, k, ok, x[k]);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      if (i < a.m) {
        float ur[EPT] = {}, vr[EPT] = {};
        if (load1 & kLoadU) ring_f32<VEC>(ring_chunk<BF16, NT>(buf, i), ok, ur);
        if (load1 & kLoadV) ring_f32<VEC>(ring_chunk<BF16, NT>(buf, a.m + i), ok, vr);
#pragma unroll
        for (int k = 0; k < KT; ++k) {
          if (k < a.K) {
            const bool tk = (a.tmask >> k) & 1;
            float w[EPT];
#pragma unroll
            for (int e = 0; e < EPT; ++e) w[e] = tk ? ur[e] : vr[e];
            acc[k * M + i] += dot(w, x[k]);
          }
        }
      }
    }
  }

  __device__ void setup(const float* tot, int sample, bool) {
    b = sample;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const float mk = i < a.m ? a.mask[i * a.B + b] : 0.f;
#pragma unroll
      for (int k = 0; k < KT; ++k) cf[k * M + i] = (k < a.K && i < a.m) ? tot[k * M + i] * mk : 0.f;
    }
  }

  __device__ void emit(const unsigned char* buf, long long ft, long long lo, long long hi) const {
    const long long f = ft + (long long)threadIdx.x * EPT;
    bool ok[EPT];
    if (!chunk_mask<VEC, EPT>(f, lo, hi, ok)) return;
    float term[KT][EPT];
#pragma unroll
    for (int k = 0; k < KT; ++k)
#pragma unroll
      for (int e = 0; e < EPT; ++e) term[k][e] = 0.f;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      if (i < a.m) {
        float ur[EPT] = {}, vr[EPT] = {};
        if (load2 & kLoadU) ring_f32<VEC>(ring_chunk<BF16, NT>(buf, i), ok, ur);
        if (load2 & kLoadV) ring_f32<VEC>(ring_chunk<BF16, NT>(buf, a.m + i), ok, vr);
#pragma unroll
        for (int k = 0; k < KT; ++k) {
          if (k < a.K) {
            const bool tk = (a.tmask >> k) & 1;
#pragma unroll
            for (int e = 0; e < EPT; ++e)
              term[k][e] = fmaf(cf[k * M + i], tk ? vr[e] : ur[e], term[k][e]);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      if (k < a.K) {
        float x[EPT], o[EPT];
        vec_chunk<BF16, NT, VEC, EPT>(buf, a.m, k, ok, x);
#pragma unroll
        for (int e = 0; e < EPT; ++e) o[e] = fmaf(alpha, x[e], term[k][e]);
        store_f32<VEC, EPT>(a.out[k] + f, o, ok);
      }
    }
  }
};

// ---------------------------------------------------------------------------
// broyden_step
// ---------------------------------------------------------------------------

// partials: [v_i.g (i < M), u_i.s (i < M), s.g, s.hg_old]
template <int BF16, int M, int VEC>
struct BroydenOp {
  using TL = Tile<BF16, kThreadRows / M>;
  using T = typename TL::T;
  static constexpr int NT = kThreadRows / M, EPT = TL::EPT, TILE = TL::TILE, P = 2 * M + 2;
  static constexpr int load1 = kLoadU | kLoadV | kLoadX, load2 = load1;
  const StreamArgs& a;
  float alpha;
  float cg[M], cs[M];
  float inv_den = 0.f;
  bool upd = false;
  int sl = -1, b = 0;

  __device__ explicit BroydenOp(const StreamArgs& args) : a(args) { alpha = *a.alpha; }
  static __device__ long long stage_bytes(const StreamArgs& a) { return TL::bytes(a.m, 3); }

  __device__ void load(unsigned char* buf, long long ft, long long f1, int parts,
                       uint64_t policy) const {
    load_tile<BF16, M, NT, VEC>(a, 3, buf, ft, f1, parts, policy);
  }

  __device__ void accumulate(const unsigned char* buf, long long ft, long long lo,
                             long long hi, float (&acc)[P]) const {
    bool ok[EPT];
    if (!chunk_mask<VEC, EPT>(ft + (long long)threadIdx.x * EPT, lo, hi, ok)) return;
    float g[EPT], s[EPT], hg[EPT];
    vec_chunk<BF16, NT, VEC, EPT>(buf, a.m, 0, ok, g);
    vec_chunk<BF16, NT, VEC, EPT>(buf, a.m, 1, ok, s);
    vec_chunk<BF16, NT, VEC, EPT>(buf, a.m, 2, ok, hg);
    acc[2 * M] += dot(s, g);
    acc[2 * M + 1] += dot(s, hg);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      if (i < a.m) {
        float ur[EPT], vr[EPT];
        ring_f32<VEC>(ring_chunk<BF16, NT>(buf, i), ok, ur);
        ring_f32<VEC>(ring_chunk<BF16, NT>(buf, a.m + i), ok, vr);
        acc[i] += dot(vr, g);
        acc[M + i] += dot(ur, s);
      }
    }
  }

  __device__ void setup(const float* tot, int sample, bool owns_first) {
    b = sample;
    float den = alpha * tot[2 * M] - tot[2 * M + 1];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const float mk = i < a.m ? a.mask[i * a.B + b] : 0.f;
      cg[i] = i < a.m ? tot[i] * mk : 0.f;
      cs[i] = i < a.m ? tot[M + i] * mk : 0.f;
      den += i < a.m ? mk * tot[i] * tot[M + i] : 0.f;
    }
    const bool safe = fabsf(den) > a.eps;
    upd = safe && a.active[b] != 0;
    inv_den = safe ? 1.f / den : 0.f;
    sl = a.slot[b];
    upd = upd && sl >= 0 && sl < a.m;  // a slot outside the ring writes nothing
    if (owns_first && threadIdx.x == 0) a.den[b] = den;
  }

  __device__ void emit(const unsigned char* buf, long long ft, long long lo, long long hi) const {
    const long long f = ft + (long long)threadIdx.x * EPT;
    bool ok[EPT];
    if (!chunk_mask<VEC, EPT>(f, lo, hi, ok)) return;
    float g[EPT], s[EPT], hg[EPT], hgn[EPT], bb[EPT];
    vec_chunk<BF16, NT, VEC, EPT>(buf, a.m, 0, ok, g);
    vec_chunk<BF16, NT, VEC, EPT>(buf, a.m, 1, ok, s);
    vec_chunk<BF16, NT, VEC, EPT>(buf, a.m, 2, ok, hg);
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      hgn[e] = alpha * g[e];
      bb[e] = alpha * s[e];
    }
    uint4 eu = make_uint4(0u, 0u, 0u, 0u), ev = eu;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      if (i < a.m) {
        const uint4 ru = ring_chunk<BF16, NT>(buf, i), rv = ring_chunk<BF16, NT>(buf, a.m + i);
        float ur[EPT], vr[EPT];
        unpack(ru, ur);
        unpack(rv, vr);
#pragma unroll
        for (int e = 0; e < EPT; ++e) {
          hgn[e] = fmaf(cg[i], ur[e], hgn[e]);
          bb[e] = fmaf(cs[i], vr[e], bb[e]);
        }
        if (i == sl) {  // the evicted pair: the slot's old raw bits
          eu = ru;
          ev = rv;
        }
      }
    }
    const long long bd = (long long)a.B * a.D;
    store_f32<VEC, EPT>(a.out[0] + f, hgn, ok);
    store_f32<VEC, EPT>(a.out[1] + f, bb, ok);
    store_raw<VEC>(static_cast<T*>(a.ev_u) + f, eu, ok);
    store_raw<VEC>(static_cast<T*>(a.ev_v) + f, ev, ok);
    if (upd) {  // every read of this chunk is done: write the slot rows
      float an[EPT];
#pragma unroll
      for (int e = 0; e < EPT; ++e) an[e] = (s[e] - (hgn[e] - hg[e])) * inv_den;
      T* du = static_cast<T*>(a.u) + sl * bd + f;
      T* dv = static_cast<T*>(a.v) + sl * bd + f;
      if (VEC) {
        *reinterpret_cast<uint4*>(du) = pack(an);
        *reinterpret_cast<uint4*>(dv) = pack(bb);
      } else {
#pragma unroll
        for (int e = 0; e < EPT; ++e) {
          if (ok[e]) {
            from_f32(du[e], an[e]);
            from_f32(dv[e], bb[e]);
          }
        }
      }
    }
  }
};

template <int BF16, int M, int KT, int VEC>
__global__ void __launch_bounds__(kThreadRows / M, 1) qn_kernel(const StreamArgs a) {
  QnOp<BF16, M, KT, VEC> op(a);
  stream_walk(a, op);
}

template <int BF16, int M, int VEC>
__global__ void __launch_bounds__(kThreadRows / M, 1) broyden_kernel(const StreamArgs a) {
  BroydenOp<BF16, M, VEC> op(a);
  stream_walk(a, op);
}

// ---------------------------------------------------------------------------
// lowrank_append
// ---------------------------------------------------------------------------

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

// The ring-slot write alone (lowrank_append_pallas): each block reads its
// chunk of row slot[b] of U and V into ev_u/ev_v, and only then, where
// upd[b], writes a = (s - hy) * inv_den and b into that row in place.  No
// other ring row is read or written.  A slot outside [0, m) writes nothing.
template <typename T>
__global__ void __launch_bounds__(kThreads)
lowrank_append_kernel(T* __restrict__ u, T* __restrict__ v,
                      const float* __restrict__ s, const float* __restrict__ hy,
                      const float* __restrict__ bvec, const float* __restrict__ inv_den,
                      const int* __restrict__ slot, const float* __restrict__ upd,
                      T* __restrict__ ev_u, T* __restrict__ ev_v, int m, int B,
                      long long D, int chunk, bool vec) {
  const int c = blockIdx.x, b = blockIdx.y;
  const int sl = slot[b];
  if (sl < 0 || sl >= m) return;
  const bool write = upd[b] > 0.5f;
  const float k = inv_den[b];
  const long long d0 = (long long)c * chunk;
  const long long d1 = d0 + chunk < D ? d0 + chunk : D;
  for (long long d = d0 + 4LL * threadIdx.x; d < d1; d += 4LL * kThreads) {
    const int n = (int)(d1 - d < 4 ? d1 - d : 4);
    const long long off = (long long)b * D + d;
    const long long row = ((long long)sl * B + b) * D + d;
    store4(ev_u + off, load4(u + row, n, vec), n, vec);
    store4(ev_v + off, load4(v + row, n, vec), n, vec);
    if (write) {
      const float4 sk = load4(s + off, n, vec), hk = load4(hy + off, n, vec);
      const float4 a = make_float4((sk.x - hk.x) * k, (sk.y - hk.y) * k,
                                   (sk.z - hk.z) * k, (sk.w - hk.w) * k);
      store4(u + row, a, n, vec);
      store4(v + row, load4(bvec + off, n, vec), n, vec);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Raise a kernel's dynamic shared-memory limit once to what a call needs.
cudaError_t ensure_smem(const void* fn, long long bytes) {
  static const void* fns[64];
  static long long have[64];
  static int n = 0;
  int i = 0;
  while (i < n && fns[i] != fn) ++i;
  if (i < n && have[i] >= bytes) return cudaSuccess;
  if (i == n) {
    if (n == 64) return cudaErrorInvalidValue;
    fns[n] = fn;
    have[n++] = 0;
  }
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err == cudaSuccess) have[i] = bytes;
  return err;
}

// Launch one stream kernel: cooperative where the slices cut B*D flat (a
// refused cooperative launch returns its error), a cluster per sample where
// a sample spans several CTAs, else a plain launch (one CTA per sample).
cudaError_t launch_stream(const void* fn, StreamArgs& a, int nt, long long stage,
                          cudaStream_t st) {
  const bool ok = a.coop ? a.partial && a.csize == 0
                         : a.csize >= 1 && a.csize <= 8 && a.slice * a.csize >= a.D &&
                               a.n_cta == a.B * a.csize;
  if (!ok || a.pref < 1 || a.pref > kMaxPref || a.nbuf <= a.pref || a.n_cta < 1 ||
      a.slice < 1 || a.l2_tiles < 0)
    return cudaErrorInvalidValue;
  const long long smem = stage * a.nbuf;
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  cudaError_t err = ensure_smem(fn, smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&a};
  if (a.coop)
    return cudaLaunchCooperativeKernel(fn, dim3(a.n_cta), dim3(nt), args, (size_t)smem, st);
  if (a.csize == 1) return cudaLaunchKernel(fn, dim3(a.n_cta), dim3(nt), args, (size_t)smem, st);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.n_cta);
  cfg.blockDim = dim3(nt);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelExC(&cfg, fn, args);
}

template <int BF16, int M, int KT>
const void* qn_fn(int vec) {
  return vec ? (const void*)qn_kernel<BF16, M, KT, 1> : (const void*)qn_kernel<BF16, M, KT, 0>;
}

template <int BF16, int M>
const void* broyden_fn(int vec) {
  return vec ? (const void*)broyden_kernel<BF16, M, 1> : (const void*)broyden_kernel<BF16, M, 0>;
}

int template_memory(int m) { return m <= 8 ? 8 : m <= 16 ? 16 : 32; }

// The kernel for (op, ring type, m, K, vec) and its tile's bytes; null if
// the combination has no kernel.
const void* stream_fn(int broyden, int bf16, int m, int K, int vec, long long* stage) {
  if (m < 1 || m > 32 || (!broyden && (K < 1 || K > kKMax))) return nullptr;
  const int mt = template_memory(m), nvec = broyden ? 3 : K;
  const int tile = (kThreadRows / mt) * (bf16 ? 8 : 4);
  *stage = (long long)2 * m * tile * (bf16 ? 2 : 4) + (long long)nvec * tile * 4;
#define QN_FN(B_, M_)                                                             \
  if (mt == M_) return broyden ? broyden_fn<B_, M_>(vec)                          \
                               : (K == 1 ? qn_fn<B_, M_, 1>(vec) : qn_fn<B_, M_, 4>(vec))
  if (bf16) {
    QN_FN(1, 8);
    QN_FN(1, 16);
    QN_FN(1, 32);
  } else {
    QN_FN(0, 8);
    QN_FN(0, 16);
    QN_FN(0, 32);
  }
#undef QN_FN
  return nullptr;
}

}  // namespace

extern "C" {

// Every entry point returns a cudaError_t (0 = launched).  Pointers are
// device pointers; `bf16` selects the ring storage type (else float32).

// The co-resident CTAs of the stream kernel for (op, ring type, m, K, vec)
// with `nbuf` tile buffers: SMs x the CTAs per SM the occupancy query allows.
int qn_stream_ctas(int broyden, int bf16, int m, int K, int vec, int nbuf, int* ctas) {
  long long stage = 0;
  const void* fn = stream_fn(broyden, bf16, m, K, vec, &stage);
  if (!fn || nbuf < 2 || stage * nbuf > kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t err = ensure_smem(fn, stage * nbuf);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreadRows / template_memory(m),
                                                      (size_t)(stage * nbuf));
  if (err != cudaSuccess) return (int)err;
  *ctas = sms * per_sm;
  return per_sm > 0 ? 0 : (int)cudaErrorInvalidConfiguration;
}

int qn_apply_multi_launch(const void* u, const void* v, const float* xs, const float* mask,
                          const float* alpha, float* partial, float* out, int m, int B,
                          long long D, int K, int tmask, int n_cta, long long slice, int csize,
                          int nbuf, int pref, int l2_tiles, int coop, int bf16, int vec,
                          void* stream) {
  long long stage = 0;
  const void* fn = stream_fn(0, bf16, m, K, vec, &stage);
  if (!fn) return (int)cudaErrorInvalidValue;
  StreamArgs a = {};
  a.u = const_cast<void*>(u);
  a.v = const_cast<void*>(v);
  for (int k = 0; k < K; ++k) {
    a.vec[k] = xs + (long long)k * B * D;
    a.out[k] = out + (long long)k * B * D;
  }
  a.mask = mask;
  a.alpha = alpha;
  a.partial = coop ? partial : nullptr;
  a.D = D;
  a.slice = slice;
  a.csize = csize;
  a.m = m;
  a.B = B;
  a.K = K;
  a.tmask = tmask;
  a.n_cta = n_cta;
  a.nbuf = nbuf;
  a.pref = pref;
  a.l2_tiles = l2_tiles;
  a.coop = coop;
  return (int)launch_stream(fn, a, kThreadRows / template_memory(m), stage, (cudaStream_t)stream);
}

int broyden_step_launch(void* u, void* v, const float* g, const float* s, const float* hg,
                        const float* mask, const int* slot, const unsigned char* active,
                        const float* alpha, float eps, float* partial, float* hg_new,
                        float* b_out, float* den, void* ev_u, void* ev_v, int m, int B,
                        long long D, int n_cta, long long slice, int csize, int nbuf, int pref,
                        int l2_tiles, int coop, int bf16, int vec, void* stream) {
  long long stage = 0;
  const void* fn = stream_fn(1, bf16, m, 1, vec, &stage);
  if (!fn) return (int)cudaErrorInvalidValue;
  StreamArgs a = {};
  a.u = u;
  a.v = v;
  a.vec[0] = g;
  a.vec[1] = s;
  a.vec[2] = hg;
  a.out[0] = hg_new;
  a.out[1] = b_out;
  a.ev_u = ev_u;
  a.ev_v = ev_v;
  a.den = den;
  a.mask = mask;
  a.alpha = alpha;
  a.slot = slot;
  a.active = active;
  a.eps = eps;
  a.partial = coop ? partial : nullptr;
  a.D = D;
  a.slice = slice;
  a.csize = csize;
  a.m = m;
  a.B = B;
  a.K = 3;
  a.n_cta = n_cta;
  a.nbuf = nbuf;
  a.pref = pref;
  a.l2_tiles = l2_tiles;
  a.coop = coop;
  return (int)launch_stream(fn, a, kThreadRows / template_memory(m), stage, (cudaStream_t)stream);
}

int lowrank_append_launch(void* u, void* v, const float* s, const float* hy,
                          const float* bvec, const float* inv_den, const int* slot,
                          const float* upd, void* ev_u, void* ev_v, int m, int B,
                          long long D, int chunk, int nchunks, int bf16, int vec,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (m < 1) return (int)cudaErrorInvalidValue;
  dim3 grid(nchunks, B);
  if (bf16)
    lowrank_append_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        (__nv_bfloat16*)u, (__nv_bfloat16*)v, s, hy, bvec, inv_den, slot, upd,
        (__nv_bfloat16*)ev_u, (__nv_bfloat16*)ev_v, m, B, D, chunk, vec != 0);
  else
    lowrank_append_kernel<float><<<grid, kThreads, 0, st>>>(
        (float*)u, (float*)v, s, hy, bvec, inv_den, slot, upd, (float*)ev_u,
        (float*)ev_v, m, B, D, chunk, vec != 0);
  return (int)cudaGetLastError();
}

}  // extern "C"
