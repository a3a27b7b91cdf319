// Single-query decode attention over a kv-head-major KV cache (Hopper):
// K4 over a contiguous cache and K5 over a page pool, one kernel body.
//
// Replaces mpi_operator_tpu/ops/attention.py::_decode_kernel, reached
// through decode_attention (K4) and paged_decode_attention (K5): one
// decode step of attention for every (batch row, kv head), with per-row
// cursors, native GQA and a fused int8 dequant.
//
//   q        [B, H, D]       compute dtype (bf16 or f32)
//   cur      [B]             int32: row b attends positions <= cur[b]
//   out      [B, H, D]       compute dtype
// K4 (contiguous):
//   k, v     [B, KV, L, D]   compute dtype, or int8 with scales
//   ks, vs   [B, KV, L]      f32 per-position scales (int8 only)
// K5 (paged):
//   k, v     [NP, KV, ps, D] a pool of NP pages of ps positions each
//   ks, vs   [NP, KV, ps]    f32 per-(page slot) scales (int8 only)
//   pt       [B, nblk]       int32: logical position t of row b lives in
//                            page pt[b, t / ps] at slot t % ps; the
//                            logical length is nblk * ps
//
// The two differ only in where row t of (b, kv head h) is read from,
// which an address policy (ContiguousRows, PagedRows) supplies; the walk,
// the staging, the online softmax and the numerics are one template, so
// K5 on a pool gives bit for bit what K4 gives on the same logical cache
// gathered contiguous.
//
// Query head h belongs to kv head h / G (G = H / KV), so one CTA serves
// the whole group from one read of the cache: no repeated-KV copy.
//
// What bounds it on an H100: bytes. The kernel does ~4 flops per cache
// element it reads, far under the ~295 flops per byte where the tensor
// cores would become the limit. The least time is
//   sum_b (cur_b + 1) * KV * D * (bytes of k + bytes of v)
//   (+ 8 bytes per position and kv head for the int8 scales,
//    + 4 bytes per page-table entry for K5)
// over 3.35 TB/s. The design keeps the bytes at that minimum: positions
// past a row's cursor are never read, each cache element is read once,
// int8 stays int8 until it is in shared memory, and the softmax never
// leaves the CTA.
//
// The design is the simple one. One CTA of 128 threads per (b, kv head);
// it walks logical positions 0 to cur[b] in tiles of T rows. Each tile
// is staged through shared memory with 16-byte loads (dequantized to the
// compute dtype on the way in), scored by one warp per row with a
// shuffle reduction, and folded into an online softmax with m, l and the
// accumulator in f32. A K5 tile may span pages (any page size >= 1):
// each staged row resolves its own page through the table, in int64. What
// it leaves for later work: with B * KV CTAs (128 at B=8 for gpt2-medium)
// and one sequential walk per CTA, SMs sit idle at small B * KV and long
// caches; the remedy is a split over L (flash-decoding) with a combine
// pass, then TMA loads and wgmma.
//
// Numerics follow the reference kernel: masked scores are -1e30 (never
// -inf), l is clamped at 1e-30, int8 is dequantized cast-then-scale in
// the compute dtype (the bf16 rounding of the product is kept), scores
// and sums accumulate in f32, and p is rounded to the value dtype before
// the p.v product while l sums the unrounded p.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 128;
constexpr int kMaxG = 8;
constexpr float kNegInf = -1e30f;

enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to the compute dtype, returned as f32
template <typename QT> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<QT>(x));
}

// Where row t of (b, kv head h) lives, as a row index into the cache
// (times D for the k/v element, as is for the int8 scale). kChecked: the
// index can be -1 (a page id outside the pool), which stage_tile tests.
struct ContiguousRows {
  int L;
  struct Bound {
    static constexpr bool kChecked = false;
    int64_t slab;
    __device__ __forceinline__ int64_t operator()(int t) const {
      return slab + t;
    }
  };
  __device__ __forceinline__ Bound bind(int b, int h, int KV) const {
    return {(static_cast<int64_t>(b) * KV + h) * L};
  }
  __device__ __forceinline__ int length() const { return L; }
};

// Logical position t of row b lives in page pt[b, t / ps], slot t % ps.
// The block index fits in 32 bits (nblk * ps < 2^31 is checked at
// launch); the page id and the row index are int64. A page id outside
// [0, NP) gives -1, and stage_tile fills that row with NaN: a bad table
// poisons the output instead of reading outside the pool.
struct PagedRows {
  const int32_t* __restrict__ pt;
  int nblk, ps, np;
  struct Bound {
    static constexpr bool kChecked = true;
    const int32_t* __restrict__ row_pt;
    int ps, np;
    int64_t head;                      // kv head within a page: h
    int64_t kv;                        // kv heads a page holds
    __device__ __forceinline__ int64_t operator()(int t) const {
      const int blk = t / ps;
      const int64_t page = row_pt[blk];
      if (page < 0 || page >= np) return -1;
      return (page * kv + head) * ps + (t - blk * ps);
    }
  };
  __device__ __forceinline__ Bound bind(int b, int h, int KV) const {
    return {pt + static_cast<int64_t>(b) * nblk, ps, np, h, KV};
  }
  __device__ __forceinline__ int length() const { return nblk * ps; }
};

// Stage logical rows [t0, t0 + n) of one (b, kv-head) cache into smem
// as the compute dtype QT; rows [n, T) of the tile are zero-filled so
// the p.v product over them adds nothing (their p is 0 as well).
template <typename QT, typename CT, int T, typename Rows>
__device__ __forceinline__ void stage_tile(QT* __restrict__ dst,
                                           const CT* __restrict__ src,
                                           const float* __restrict__ scale,
                                           const Rows& rows, int t0, int n,
                                           int D) {
  constexpr int kElems = 16 / sizeof(CT);  // cache elements per 16 bytes
  const int vec_per_row = D / kElems;
  const int total = T * vec_per_row;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int r = i / vec_per_row;
    const int c = (i - r * vec_per_row) * kElems;
    QT* out = dst + r * D + c;
    if (r >= n) {
#pragma unroll
      for (int e = 0; e < kElems; ++e) out[e] = from_float<QT>(0.f);
      continue;
    }
    const int64_t row = rows(t0 + r);
    if constexpr (Rows::kChecked) {
      if (row < 0) {
#pragma unroll
        for (int e = 0; e < kElems; ++e)
          out[e] = from_float<QT>(__int_as_float(0x7fc00000));   // NaN
        continue;
      }
    }
    const uint4 raw = *reinterpret_cast<const uint4*>(src + row * D + c);
    const CT* vals = reinterpret_cast<const CT*>(&raw);
    if constexpr (sizeof(CT) == 1) {
      // int8: cast to the compute dtype, times the scale in the compute
      // dtype, product rounded to it (k.astype(q) * s.astype(q))
      const float s = round_to<QT>(scale[row]);
#pragma unroll
      for (int e = 0; e < kElems; ++e)
        out[e] = from_float<QT>(static_cast<float>(vals[e]) * s);
    } else {
      // same dtype in and out: one 16-byte store
      *reinterpret_cast<uint4*>(out) = raw;
    }
  }
}

template <typename QT, typename CT, int T, typename Addr>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const QT* __restrict__ q,
                            const CT* __restrict__ k,
                            const CT* __restrict__ v,
                            const float* __restrict__ ks,
                            const float* __restrict__ vs,
                            const int32_t* __restrict__ cur,
                            QT* __restrict__ out, int H, int KV, int D,
                            float sm_scale, Addr addr) {
  __shared__ __align__(16) QT k_s[T * kMaxD];
  __shared__ __align__(16) QT v_s[T * kMaxD];
  __shared__ float s_s[kMaxG * T];    // scores, then rounded p
  __shared__ float m_s[kMaxG];        // running max
  __shared__ float l_s[kMaxG];        // running sum of p
  __shared__ float alpha_s[kMaxG];    // this tile's rescale of acc

  const int h = blockIdx.x;           // kv head
  const int b = blockIdx.y;
  const int G = H / KV;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const typename Addr::Bound rows = addr.bind(b, h, KV);
  const int L = addr.length();               // logical cache length

  // the group's G query rows, lane-strided over D, in registers
  float qr[kMaxG][kMaxD / 32];
  const QT* qb = q + (static_cast<int64_t>(b) * H + h * G) * D;
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int j = 0; j < kMaxD / 32; ++j) {
      const int d = lane + 32 * j;
      qr[g][j] = (g < G && d < D) ? to_float(qb[g * D + d]) : 0.f;
    }

  if (threadIdx.x < kMaxG) {
    m_s[threadIdx.x] = kNegInf;
    l_s[threadIdx.x] = 0.f;
  }
  __syncthreads();

  // each thread owns accumulator entries (g, d) = idx / D, idx % D
  constexpr int kAccPerThread = kMaxG * kMaxD / kThreads;
  float acc[kAccPerThread];
#pragma unroll
  for (int i = 0; i < kAccPerThread; ++i) acc[i] = 0.f;

  const int c = cur[b];
  const int last = c < L - 1 ? c : L - 1;   // never read past the cursor
  const int n_pos = last + 1;               // <= 0: nothing visible

  for (int t0 = 0; t0 < n_pos; t0 += T) {
    const int n = min(T, n_pos - t0);
    stage_tile<QT, CT, T>(k_s, k, ks, rows, t0, n, D);
    stage_tile<QT, CT, T>(v_s, v, vs, rows, t0, n, D);
    __syncthreads();

    // scores: one warp per row, G dot products per row
    for (int r = warp; r < T; r += kWarps) {
      float part[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) part[g] = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxD / 32; ++j) {
        const int d = lane + 32 * j;
        if (d < D) {
          const float kv = to_float(k_s[r * D + d]);
#pragma unroll
          for (int g = 0; g < kMaxG; ++g) part[g] += qr[g][j] * kv;
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
        float s = part[g];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == 0)
          s_s[g * T + r] = (r < n) ? s * sm_scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: one warp per query head of the group
    for (int g = warp; g < G; g += kWarps) {
      float mt = kNegInf;
      for (int r = lane; r < T; r += 32) mt = fmaxf(mt, s_s[g * T + r]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mt);
      float sum = 0.f;
      for (int r = lane; r < T; r += 32) {
        const float p = expf(s_s[g * T + r] - m_new);
        sum += p;
        s_s[g * T + r] = round_to<QT>(p);   // p.astype(v.dtype)
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . v
#pragma unroll
    for (int i = 0; i < kAccPerThread; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      if (idx < G * D) {
        const int g = idx / D;
        const int d = idx - g * D;
        float a = acc[i] * alpha_s[g];
        const float* p = s_s + g * T;
        for (int r = 0; r < n; ++r) a += p[r] * to_float(v_s[r * D + d]);
        acc[i] = a;
      }
    }
    __syncthreads();   // the next tile overwrites k_s, v_s and s_s
  }

  QT* ob = out + (static_cast<int64_t>(b) * H + h * G) * D;
#pragma unroll
  for (int i = 0; i < kAccPerThread; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if (idx < G * D) {
      const int g = idx / D;
      ob[idx] = from_float<QT>(acc[i] / fmaxf(l_s[g], 1e-30f));
    }
  }
}

template <typename QT, typename CT, int T, typename Addr>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* cur, void* out, int B, int H,
           int KV, int D, float sm_scale, Addr addr, cudaStream_t stream) {
  const dim3 grid(KV, B);
  decode_attention_kernel<QT, CT, T, Addr><<<grid, kThreads, 0, stream>>>(
      static_cast<const QT*>(q), static_cast<const CT*>(k),
      static_cast<const CT*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int32_t*>(cur),
      static_cast<QT*>(out), H, KV, D, sm_scale, addr);
  return static_cast<int>(cudaGetLastError());
}

// The tile (64 rows for a bf16 compute dtype, 32 for f32) and the
// instantiation for one (compute dtype, cache dtype) pair; -1 for a pair
// the kernel was not built for.
template <typename Addr>
int dispatch(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* cur, void* out, int B, int H,
             int KV, int D, int q_dtype, int cache_dtype, float sm_scale,
             Addr addr, void* stream) {
  if (B < 1 || KV < 1 || H % KV || H / KV > kMaxG || D < 16 || D > kMaxD ||
      D % 16)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == kBF16 && cache_dtype == kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16, 64>(
        q, k, v, nullptr, nullptr, cur, out, B, H, KV, D, sm_scale, addr, s);
  if (q_dtype == kBF16 && cache_dtype == kI8)
    return launch<__nv_bfloat16, int8_t, 64>(q, k, v, ks, vs, cur, out, B,
                                             H, KV, D, sm_scale, addr, s);
  if (q_dtype == kF32 && cache_dtype == kF32)
    return launch<float, float, 32>(q, k, v, nullptr, nullptr, cur, out, B,
                                    H, KV, D, sm_scale, addr, s);
  if (q_dtype == kF32 && cache_dtype == kI8)
    return launch<float, int8_t, 32>(q, k, v, ks, vs, cur, out, B, H, KV,
                                     D, sm_scale, addr, s);
  return -1;
}

}  // namespace

// The C entry points the ctypes wrappers bind. Shapes, dtypes and
// contiguity are checked by the callers (ops/attention.py); these check
// only what would make the kernel index out of its own arrays, and
// return cudaGetLastError() of the launch (0 = success), or -1 for a
// combination they were not built for.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* ks,
                                       const void* vs, const void* cur,
                                       void* out, int B, int H, int KV,
                                       int L, int D, int q_dtype,
                                       int cache_dtype, float sm_scale,
                                       void* stream) {
  if (L < 1) return -1;
  return dispatch(q, k, v, ks, vs, cur, out, B, H, KV, D, q_dtype,
                  cache_dtype, sm_scale, ContiguousRows{L}, stream);
}

// K5: the same kernel over a page pool of NP pages of ps positions,
// through the [B, nblk] int32 table pt.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* cur, const void* pt, void* out, int B,
    int H, int KV, int NP, int ps, int nblk, int D, int q_dtype,
    int cache_dtype, float sm_scale, void* stream) {
  if (NP < 1 || ps < 1 || nblk < 1 ||
      static_cast<int64_t>(nblk) * ps > 0x7fffffff)
    return -1;
  return dispatch(q, k, v, ks, vs, cur, out, B, H, KV, D, q_dtype,
                  cache_dtype, sm_scale,
                  PagedRows{static_cast<const int32_t*>(pt), nblk, ps, NP},
                  stream);
}
