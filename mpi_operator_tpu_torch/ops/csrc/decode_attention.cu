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
// Both take a workspace the caller owns: ws, f32 partials of
// B * KV * splits * G * (D + 2) values, and tickets, B * KV int32 that
// are 0 before the first launch (every launch leaves them 0 again).
// Launches that share a workspace must be ordered on one stream.
//
// The two differ only in where row t of (b, kv head h) is read from,
// which an address policy (ContiguousRows, PagedRows) supplies; the
// split, the tile walk, the softmax and the combine are one template, so
// K5 on a pool gives bit for bit what K4 gives on the same logical cache
// gathered contiguous. Query head h belongs to kv head h / G (G = H /
// KV), so one CTA serves the whole group from one read of the cache: no
// repeated-KV copy.
//
// What bounds it on an H100: bytes. The kernel does ~4 flops per cache
// element it reads, far under the ~295 flops per byte where the tensor
// cores would become the limit. The least time is
//   sum_b (cur_b + 1) * KV * D * (bytes of k + bytes of v)
//   (+ 8 bytes per position and kv head for the int8 scales,
//    + 4 bytes per page-table entry for K5)
// over 3.35 TB/s. Positions past a row's cursor are never read, each
// cache element is read once, int8 stays int8 until it is in registers,
// and the softmax never leaves the chip. What the design does to reach
// that rate:
// - Split over logical positions (flash-decoding). The grid is (splits,
//   KV, B): CTA (s, h, b) owns positions [s chunk, (s + 1) chunk) of
//   its row, whole tiles of T rows. One CTA a (row, kv head) streams
//   only ~8 GB/s, so with few rows most of the card would sit idle and
//   each CTA would walk its whole cache alone (on an H100, one llama-1b
//   row at 4096 positions: 0.133 ms unsplit, 0.021 ms in 16 splits;
//   scripts/kernel_ab.py --sweep). The chunk is
//   chosen on the host from L, B * KV and the SM count only
//   (ops/attention.py `decode_split_len`: about two CTAs an SM, and
//   no split so short that the combine outweighs it), never from the
//   cursors, which may live on the device; a CTA whose chunk starts past
//   its row's cursor exits at once. Split bounds depend on logical
//   positions only, never on the page size.
// - One launch. Each CTA of a row with more than one live split writes
//   its f32 partial (m, l, acc[G][D]) to the workspace, fences, and
//   takes a ticket; the last to arrive combines the partials in split
//   order (so the output repeats bit for bit), writes the output and
//   resets the ticket. A row with one live split writes its output
//   directly.
// - Overlap. Tiles go through a ring of kStages shared-memory buffers
//   filled by cp.async: tile i + kStages's loads are issued as soon as
//   tile i's buffer is free, so they run under the math of the tiles
//   before them. K5 loads a tile's page ids into
//   shared memory before its data loads (one table read per page, not
//   per row), prefetched into registers under the previous tile's math.
// - Layout in a CTA. Four warps share every tile for the scores and for
//   p.v: a warp owns T/4 rows; PD/8 lanes hold 8 columns of one row each
//   (PD = D padded to 64 or 128), so a warp covers 32/(PD/8) rows a pass.
//   Each lane keeps its own running max, sum and accumulator over the
//   rows it sees; they are merged by shuffles and through shared memory
//   once a split, not once a tile. G is a template parameter (1, 2, 4,
//   8; a G in between rides the next one with its extra heads unused),
//   so G = 1 does one FMA per element.
//
// Numerics follow the reference kernel: masked scores are -1e30 (never
// -inf; p of a masked position is exactly 0, as exp(-1e30 - m) is once
// any position is visible), l is clamped at 1e-30, int8 is dequantized
// cast-then-scale in the compute dtype (the product is rounded to it),
// scores and sums accumulate in f32, p is rounded to the value dtype
// before the p.v product while l sums the unrounded p, and partials are
// rescaled in f32 in the combine. A row whose cursor is negative sees
// nothing and gets zeros. A page id outside the pool gives NaN, never a
// read outside it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 128;
constexpr int kMaxG = 8;
constexpr int kStages = 2;             // tiles in the cp.async ring
constexpr float kNegInf = -1e30f;

enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

// rows of a tile: 64 for a 1- or 2-byte cache, 32 for f32
template <typename CT>
__host__ __device__ constexpr int tile_rows() {
  return sizeof(CT) == 4 ? 32 : 64;
}

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// N bytes (4, 8 or 16) from device memory into shared memory, async
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(N)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Where logical position t of (b, kv head h) lives, as a row index into
// the cache (times D for the k/v element, as is for the int8 scale).
struct ContiguousRows {
  static constexpr bool kPaged = false;
  int L;
  struct Bound {
    int64_t slab;
    __device__ __forceinline__ int fetch_page(int, int, int) const {
      return 0;
    }
    __device__ __forceinline__ int64_t row(int t, const int*, int) const {
      return slab + t;
    }
  };
  __device__ __forceinline__ Bound bind(int b, int h, int KV) const {
    return {(static_cast<int64_t>(b) * KV + h) * L};
  }
  __host__ __device__ int length() const { return L; }
};

// Logical position t of row b lives in page pt[b, t / ps], slot t % ps.
// The block index fits in 32 bits (nblk * ps < 2^31 is checked at
// launch); the page id and the row index are int64. A tile's page ids
// are read once into shared memory (fetch_page), and row() looks them up
// there; a page id outside [0, NP) gives -1, and the tile's row is
// filled with NaN: a bad table poisons the output instead of reading
// outside the pool.
struct PagedRows {
  static constexpr bool kPaged = true;
  const int32_t* __restrict__ pt;
  int nblk, ps, np;
  struct Bound {
    const int32_t* __restrict__ row_pt;
    int ps, np;
    int64_t head;                      // kv head within a page: h
    int64_t kv;                        // kv heads a page holds
    // The i-th page id that positions [t0, t0 + n) touch, or 0 past them
    // (the table is never read past a row's cursor).
    __device__ __forceinline__ int fetch_page(int i, int t0, int n) const {
      const int blk = t0 / ps + i;
      return blk <= (t0 + n - 1) / ps ? row_pt[blk] : 0;
    }
    __device__ __forceinline__ int64_t row(int t, const int* pid_s,
                                           int t0) const {
      const int blk = t / ps;
      const int64_t page = pid_s[blk - t0 / ps];
      if (page < 0 || page >= np) return -1;
      return (page * kv + head) * ps + (t - blk * ps);
    }
  };
  __device__ __forceinline__ Bound bind(int b, int h, int KV) const {
    return {pt + static_cast<int64_t>(b) * nblk, ps, np, h, KV};
  }
  __host__ __device__ int length() const { return nblk * ps; }
};

// Eight consecutive cache elements from shared memory as the compute
// dtype, in f32. int8: cast to the compute dtype, times the scale in the
// compute dtype, product rounded to it (k.astype(q) * s.astype(q)).
template <typename QT, typename CT>
__device__ __forceinline__ void load8(float (&x)[8], const CT* src,
                                      float scale) {
  if constexpr (sizeof(CT) == 1) {
    const uint2 raw = *reinterpret_cast<const uint2*>(src);
    const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      x[i] = round_to<QT>(static_cast<float>(e[i]) * scale);
  } else if constexpr (sizeof(CT) == 2) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = to_float(e[i]);
  } else {
    const float4 lo = *reinterpret_cast<const float4*>(src);
    const float4 hi = *reinterpret_cast<const float4*>(src + 4);
    x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
    x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
  }
}

// Eight cache elements that read as NaN (int8 rows take NaN from their
// scale instead)
template <typename CT>
__device__ __forceinline__ void fill_nan8(CT* dst) {
  if constexpr (sizeof(CT) == 1) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(0u, 0u);
  } else if constexpr (sizeof(CT) == 2) {
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(0x7fc07fc0u, 0x7fc07fc0u, 0x7fc07fc0u, 0x7fc07fc0u);
  } else {
    const uint4 n = make_uint4(0x7fc00000u, 0x7fc00000u, 0x7fc00000u,
                               0x7fc00000u);
    reinterpret_cast<uint4*>(dst)[0] = n;
    reinterpret_cast<uint4*>(dst)[1] = n;
  }
}

struct Work {
  const float* __restrict__ ks;
  const float* __restrict__ vs;
  const int32_t* __restrict__ cur;
  float* __restrict__ ws;         // [B * KV][splits][G][D], then [..][2]
  int* __restrict__ tickets;      // [B * KV]
  int H, KV, D, chunk;
  float sm_scale;
};

// PD: D padded to 64 or 128 (PD / 8 lanes a row); GP: G padded to 1, 2,
// 4 or 8 (the heads past G have q = 0 and are never written).
template <typename QT, typename CT, int PD, int GP, typename Rows>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const QT* __restrict__ q,
                            const CT* __restrict__ k,
                            const CT* __restrict__ v, QT* __restrict__ out,
                            const Work w, const Rows addr) {
  constexpr int T = tile_rows<CT>();
  constexpr int LPR = PD / 8;             // lanes a row
  constexpr int RPP = 32 / LPR;           // rows a warp pass
  constexpr int RW = T / kWarps;          // rows a warp a tile
  constexpr int P = RW / RPP;             // passes a tile
  constexpr int PG = P < 4 ? P : 4;       // passes an online update
  static_assert(P % PG == 0, "whole pass groups");
  constexpr int kTileElems = T * PD;
  // [kStages][T][PD] of k, then of v (cache dtype), in dynamic shared
  // memory
  extern __shared__ __align__(16) unsigned char smem_raw[];
  CT* k_s = reinterpret_cast<CT*>(smem_raw);
  CT* v_s = k_s + kStages * kTileElems;
  __shared__ float ks_s[kStages][T], vs_s[kStages][T];
  __shared__ int pid_s[kStages][T];
  __shared__ float red_m[kWarps][GP], red_l[kWarps][GP];
  __shared__ float red_acc[kWarps][GP][PD];
  __shared__ int last_cta;

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x;
  const int H = w.H, KV = w.KV, D = w.D, chunk = w.chunk;
  const int G = H / KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t bh = static_cast<int64_t>(b) * KV + h;
  QT* ob = out + (static_cast<int64_t>(b) * H + h * G) * D;

  const int L = addr.length();
  const int c = w.cur[b];
  const int last = c < L - 1 ? c : L - 1;  // never read past the cursor
  if (last < 0) {                          // nothing visible: zeros
    if (split == 0)
      for (int i = tid; i < G * D; i += kThreads) ob[i] = from_float<QT>(0.f);
    return;
  }
  const int live = last / chunk + 1;       // splits with a visible position
  if (split >= live) return;
  const int t_begin = split * chunk;
  const int t_end = min(t_begin + chunk, last + 1);
  const int n_tiles = (t_end - t_begin + T - 1) / T;
  const typename Rows::Bound rows = addr.bind(b, h, KV);

  // Stage tile i (positions t0 .. t0 + n - 1) into buffer buf: page ids
  // first (K5), then k, v and the int8 scales by cp.async.
  auto stage = [&](int i, int buf) {
    const int t0 = t_begin + i * T;
    const int n = min(T, t_end - t0);
    const int d_chunks = D / 8;
    for (int j = tid; j < n * d_chunks; j += kThreads) {
      const int r = j / d_chunks;
      const int e = (j - r * d_chunks) * 8;
      const int64_t row = rows.row(t0 + r, pid_s[buf], t0);
      CT* kd = k_s + buf * kTileElems + r * PD + e;
      CT* vd = v_s + buf * kTileElems + r * PD + e;
      if (row < 0) {
        fill_nan8(kd);
        fill_nan8(vd);
        continue;
      }
      const CT* kg = k + row * D + e;
      const CT* vg = v + row * D + e;
      if constexpr (sizeof(CT) == 4) {
        cp_async<16>(kd, kg);
        cp_async<16>(kd + 4, kg + 4);
        cp_async<16>(vd, vg);
        cp_async<16>(vd + 4, vg + 4);
      } else {
        cp_async<8 * sizeof(CT)>(kd, kg);
        cp_async<8 * sizeof(CT)>(vd, vg);
      }
    }
    if constexpr (sizeof(CT) == 1) {
      if (tid < n) {
        const int64_t row = rows.row(t0 + tid, pid_s[buf], t0);
        if (row < 0) {
          ks_s[buf][tid] = __int_as_float(0x7fc00000);
          vs_s[buf][tid] = __int_as_float(0x7fc00000);
        } else {
          cp_async<4>(&ks_s[buf][tid], w.ks + row);
          cp_async<4>(&vs_s[buf][tid], w.vs + row);
        }
      }
    }
  };
  // K5: tile i's page ids, read by the first T threads (0 for others)
  auto fetch_pages = [&](int i) {
    if (!Rows::kPaged || i >= n_tiles || tid >= T) return 0;
    const int t0 = t_begin + i * T;
    return rows.fetch_page(tid, t0, min(T, t_end - t0));
  };
  auto publish_pages = [&](int pg, int buf) {
    if constexpr (Rows::kPaged) {
      if (tid < T) pid_s[buf][tid] = pg;
      __syncthreads();
    }
  };

  // lane layout: LPR lanes a row, 8 columns each
  const int c8 = lane % LPR, rg = lane / LPR;
  const int d0 = c8 * 8;
  const bool active = d0 < D;
  float qr[GP][8];
  {
    const QT* qb = q + (static_cast<int64_t>(b) * H + h * G) * D;
#pragma unroll
    for (int g = 0; g < GP; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        qr[g][e] = (active && g < G) ? to_float(qb[g * D + d0 + e]) : 0.f;
  }
  float m[GP], l[GP], acc[GP][8];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }

#pragma unroll
  for (int i = 0; i < kStages; ++i) {
    if (i < n_tiles) {
      publish_pages(fetch_pages(i), i);
      stage(i, i);
    }
    cp_async_commit();                 // one group a tile, maybe empty
  }

  for (int i = 0; i < n_tiles; ++i) {
    const int buf = i % kStages;
    const int t0 = t_begin + i * T;
    const int n = min(T, t_end - t0);
    const int pg_next = fetch_pages(i + kStages);   // lands under this tile
    cp_async_wait<kStages - 1>();                    // tile i is in
    __syncthreads();
    const CT* kt = k_s + buf * kTileElems;
    const CT* vt = v_s + buf * kTileElems;
#pragma unroll
    for (int j0 = 0; j0 < P; j0 += PG) {
      float s[PG][GP];
      bool vis[PG];
#pragma unroll
      for (int j = 0; j < PG; ++j) {
        const int r = warp * RW + (j0 + j) * RPP + rg;
        vis[j] = r < n;
        float x[8];
        if (active) {
          load8<QT>(x, kt + r * PD + d0,
                    sizeof(CT) == 1 ? round_to<QT>(ks_s[buf][r]) : 1.f);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) x[e] = 0.f;
        }
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) part = fmaf(qr[g][e], x[e], part);
#pragma unroll
          for (int o = 1; o < LPR; o <<= 1)
            part += __shfl_xor_sync(0xffffffffu, part, o);
          s[j][g] = vis[j] ? part * w.sm_scale : kNegInf;
        }
      }
      float p[PG][GP];
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        float mt = m[g];
#pragma unroll
        for (int j = 0; j < PG; ++j) mt = fmaxf(mt, s[j][g]);
        const float alpha = expf(m[g] - mt);
        m[g] = mt;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < PG; ++j) {
          p[j][g] = vis[j] ? expf(s[j][g] - mt) : 0.f;
          sum += p[j][g];
        }
        l[g] = l[g] * alpha + sum;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] *= alpha;
      }
#pragma unroll
      for (int j = 0; j < PG; ++j) {
        const int r = warp * RW + (j0 + j) * RPP + rg;
        float x[8];
        if (active && vis[j]) {
          load8<QT>(x, vt + r * PD + d0,
                    sizeof(CT) == 1 ? round_to<QT>(vs_s[buf][r]) : 1.f);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) x[e] = 0.f;
        }
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          const float pr = round_to<QT>(p[j][g]);   // p.astype(v.dtype)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(pr, x[e], acc[g][e]);
        }
      }
    }
    __syncthreads();                             // buffer buf is free
    if (i + kStages < n_tiles) {
      publish_pages(pg_next, buf);
      stage(i + kStages, buf);
    }
    cp_async_commit();
  }

  // merge the row groups of each warp (lanes LPR apart), then the warps
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float mn = fmaxf(m[g], mo);
      const float fa = expf(m[g] - mn), fb = expf(mo - mn);
      l[g] = l[g] * fa + lo * fb;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
        acc[g][e] = acc[g][e] * fa + ao * fb;
      }
      m[g] = mn;
    }
  }
  if (rg == 0) {
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      if (lane == 0) {
        red_m[warp][g] = m[g];
        red_l[warp][g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) red_acc[warp][g][d0 + e] = acc[g][e];
    }
  }
  __syncthreads();

  float* ws_acc = w.ws + bh * splits * G * D;
  float* ws_ml = w.ws + static_cast<int64_t>(gridDim.z) * KV * splits * G * D +
                 bh * splits * G * 2;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i - g * D;
    float mx = kNegInf;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) mx = fmaxf(mx, red_m[wp][g]);
    float a = 0.f, s = 0.f;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) {
      const float f = expf(red_m[wp][g] - mx);
      a += red_acc[wp][g][d] * f;
      s += red_l[wp][g] * f;
    }
    if (live == 1) {
      ob[i] = from_float<QT>(a / fmaxf(s, 1e-30f));
    } else {
      ws_acc[(static_cast<int64_t>(split) * G + g) * D + d] = a;
      if (d == 0) {
        ws_ml[(split * G + g) * 2] = mx;
        ws_ml[(split * G + g) * 2 + 1] = s;
      }
    }
  }
  if (live == 1) return;

  // the last of the row's live splits to arrive combines them, in split
  // order, and leaves the ticket at 0 for the next launch
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int ticket = atomicAdd(&w.tickets[bh], 1);
    last_cta = ticket == live - 1;
    if (last_cta) w.tickets[bh] = 0;
  }
  __syncthreads();
  if (!last_cta) return;
  __threadfence();
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i - g * D;
    float mx = kNegInf;
    for (int sp = 0; sp < live; ++sp)
      mx = fmaxf(mx, __ldcg(ws_ml + (sp * G + g) * 2));
    float a = 0.f, s = 0.f;
    for (int sp = 0; sp < live; ++sp) {
      const float f = expf(__ldcg(ws_ml + (sp * G + g) * 2) - mx);
      a += __ldcg(ws_acc + (static_cast<int64_t>(sp) * G + g) * D + d) * f;
      s += __ldcg(ws_ml + (sp * G + g) * 2 + 1) * f;
    }
    ob[i] = from_float<QT>(a / fmaxf(s, 1e-30f));
  }
}

template <typename QT, typename CT, int PD, int GP, typename Addr>
int launch(const void* q, const void* k, const void* v, void* out,
           const Work& w, int B, Addr addr, cudaStream_t stream) {
  constexpr int T = tile_rows<CT>();
  const int splits = (addr.length() + w.chunk - 1) / w.chunk;
  const size_t smem = 2 * kStages * T * PD * sizeof(CT);
  auto kernel = decode_attention_kernel<QT, CT, PD, GP, Addr>;
  // static shared memory (up to ~18 KB) counts against the same 48 KB
  // that dynamic memory may take without asking, so always ask
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(splits, w.KV, B), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const CT*>(k),
      static_cast<const CT*>(v), static_cast<QT*>(out), w, addr);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename CT, typename Addr>
int by_shape(const void* q, const void* k, const void* v, void* out,
             const Work& w, int B, Addr addr, cudaStream_t s) {
  const int G = w.H / w.KV;
  if (w.chunk < 1 || w.chunk % tile_rows<CT>() != 0) return -1;
#define DECODE_G(PD)                                                      \
  if (G == 1) return launch<QT, CT, PD, 1>(q, k, v, out, w, B, addr, s);  \
  if (G == 2) return launch<QT, CT, PD, 2>(q, k, v, out, w, B, addr, s);  \
  if (G <= 4) return launch<QT, CT, PD, 4>(q, k, v, out, w, B, addr, s);  \
  return launch<QT, CT, PD, 8>(q, k, v, out, w, B, addr, s);
  if (w.D <= 64) {
    DECODE_G(64)
  }
  DECODE_G(128)
#undef DECODE_G
}

// The instantiation for one (compute dtype, cache dtype) pair; -1 for a
// pair or shape the kernel was not built for.
template <typename Addr>
int dispatch(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* cur, void* out, void* ws,
             void* tickets, int B, int H, int KV, int D, int q_dtype,
             int cache_dtype, int chunk, float sm_scale, Addr addr,
             void* stream) {
  if (B < 1 || KV < 1 || B > 65535 || KV > 65535 || H % KV ||
      H / KV > kMaxG || D < 16 || D > kMaxD || D % 16 || chunk < 1)
    return -1;
  const int splits = (addr.length() + chunk - 1) / chunk;
  if (splits > 1 && (ws == nullptr || tickets == nullptr)) return -1;
  Work w{static_cast<const float*>(ks), static_cast<const float*>(vs),
         static_cast<const int32_t*>(cur), static_cast<float*>(ws),
         static_cast<int*>(tickets), H, KV, D, chunk, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == kBF16 && cache_dtype == kBF16)
    return by_shape<__nv_bfloat16, __nv_bfloat16>(q, k, v, out, w, B, addr,
                                                  s);
  if (q_dtype == kBF16 && cache_dtype == kI8)
    return by_shape<__nv_bfloat16, int8_t>(q, k, v, out, w, B, addr, s);
  if (q_dtype == kF32 && cache_dtype == kF32)
    return by_shape<float, float>(q, k, v, out, w, B, addr, s);
  if (q_dtype == kF32 && cache_dtype == kI8)
    return by_shape<float, int8_t>(q, k, v, out, w, B, addr, s);
  return -1;
}

}  // namespace

// The C entry points the ctypes wrappers bind. Shapes, dtypes and
// contiguity are checked by the callers (ops/attention.py); these check
// only what would make the kernel index out of its own arrays, and
// return cudaGetLastError() of the launch (0 = success), or -1 for a
// combination they were not built for. `chunk` is the split length in
// positions, a multiple of the tile (decode_tile_rows).
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* ks,
                                       const void* vs, const void* cur,
                                       void* out, void* ws, void* tickets,
                                       int B, int H, int KV, int L, int D,
                                       int q_dtype, int cache_dtype,
                                       int chunk, float sm_scale,
                                       void* stream) {
  if (L < 1) return -1;
  return dispatch(q, k, v, ks, vs, cur, out, ws, tickets, B, H, KV, D,
                  q_dtype, cache_dtype, chunk, sm_scale, ContiguousRows{L},
                  stream);
}

// Rows of one tile for a cache dtype (a split length is a multiple of
// it), or -1 for a dtype the kernel was not built for.
extern "C" int decode_tile_rows(int cache_dtype) {
  if (cache_dtype == kF32) return tile_rows<float>();
  if (cache_dtype == kBF16) return tile_rows<__nv_bfloat16>();
  if (cache_dtype == kI8) return tile_rows<int8_t>();
  return -1;
}

// K5: the same kernel over a page pool of NP pages of ps positions,
// through the [B, nblk] int32 table pt.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* cur, const void* pt, void* out, void* ws,
    void* tickets, int B, int H, int KV, int NP, int ps, int nblk, int D,
    int q_dtype, int cache_dtype, int chunk, float sm_scale, void* stream) {
  if (NP < 1 || ps < 1 || nblk < 1 ||
      static_cast<int64_t>(nblk) * ps > 0x7fffffff)
    return -1;
  return dispatch(q, k, v, ks, vs, cur, out, ws, tickets, B, H, KV, D,
                  q_dtype, cache_dtype, chunk, sm_scale,
                  PagedRows{static_cast<const int32_t*>(pt), nblk, ps, NP},
                  stream);
}
