// Flash attention for training (Hopper): the forward K1 and the two
// backward kernels K2 (dq) and K3 (dk, dv).
//
// Replaces mpi_operator_tpu/ops/attention.py:
//   K1 `_fwd_kernel`, reached through `_flash_fwd` (pallas_call :137):
//      blockwise online-softmax attention, output and per-row lse;
//   K2 `_dq_kernel`, reached through `_dq_call` (pallas_call :305):
//      dq = sum_k ds.k with p recomputed from lse, ds = p*(dp-delta)*scale;
//   K3 `_dkv_kernel`, reached through `_dkv_call` (pallas_call :344):
//      dv = sum_q p^T.do, dk = sum_q ds^T.q.
//
//   q, k, v, o, do, dq, dk, dv  [B, S, H, D] bf16, read and written in
//                               place through their strides (no
//                               head-major copy)
//   lse, delta                  [B, H, S] f32
//   mask                        [B, S] uint8 (1 = the key is attended),
//                               or null
//
// Grid. K1 and K2: one CTA per (q-tile, head, batch row) that walks the
// k-tiles; K3: one CTA per (k-tile, head, batch row) that walks the
// q-tiles. Every output tile has one owner: no atomics, and the results
// repeat bit for bit from run to run. Causal CTAs skip the tiles wholly
// above the diagonal and mask per element on the tiles that cross it;
// a warp skips a tile that lies wholly above its own 16 rows (what it
// would add there is exactly zero). Tiles: 64 x 64 for D <= 64; above
// that K1/K2 take 32-key tiles and K3 32-query tiles, so the q-tile and
// the k-tile differ and the registers stay under the limit.
//
// Products. Four warps; each owns 16 rows of the CTA's tile and computes
// every product the Pallas kernels compute (q.k^T, p.v, do.v^T, ds.k,
// p^T.do, ds^T.q) with mma.sync m16n8k16 (bf16 in, f32 accumulate). A
// score tile stays in registers: its accumulator layout is the next
// product's A operand. Tiles are staged through shared memory with
// 16-byte loads; an operand that a product reads along the other axis is
// also staged transposed, so every fragment is one 32-bit load. The
// ragged S tail is masked in the kernel, so any S >= 1 runs here.
//
// What bounds it on an H100: bytes. At the training shape (B=16, S=512,
// H=16, D=64, causal) a kernel moves 68-102 MB and does 9-17 GFLOP:
// 20-30 us at 3.35 TB/s against 9-17 us at 989 TFLOP/s. Each input is
// read from device memory once per CTA that needs it (K and V again by
// every q-tile's CTA, as any tiled attention does; the L2 holds them),
// and the score tile never leaves the SM. What it leaves for later
// work: mma.sync reaches a fraction of the wgmma rate, nothing overlaps
// the staging loads with the products, and the transposed staging writes
// conflict in shared memory; TMA, wgmma and warp specialisation are the
// remedy.
//
// Numerics follow the reference kernels, which the plain versions in
// ops/attention.py repeat step by step:
// - scores are f32 dot products times scale = 1/sqrt(D); masked scores
//   are -1e30, never -inf; columns past S are -inf, so they add nothing
//   even to a row that is masked everywhere else;
// - K1: online softmax in f32; p is rounded to bf16 before p.v while l
//   sums the unrounded p; l is clamped at 1e-30; lse = m + log(l). A row
//   whose keys are all masked gets the mean of v, as the reference's
//   online softmax gives it;
// - K2, K3: p = exp(s - lse), re-masked explicitly (a masked or padded
//   entry is 0, whatever the row's lse); ds = p*(dp - delta)*scale;
// - K2: do and v enter dp exactly (bf16 products in an f32 sum); ds is
//   rounded to bf16 before ds.k;
// - K3: p^T.do runs with p UNROUNDED, as the reference casts do to f32:
//   p is split into three bf16 terms (hi + mid + lo carry p's 24-bit
//   significand) and each goes through the tensor cores; ds is rounded
//   to bf16 before ds^T.q.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;       // four warps, 16 rows each
constexpr int kRowsPerWarp = 16;
constexpr int kPad = 8;             // bf16 padding of a staged row
constexpr float kNegInf = -1e30f;

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;
  const float* delta;
  const uint8_t* mask;
  bf16* out;
  float* lse_out;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int B, S, H;
  int causal;
  float scale;
};

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A operand (16 x 16) at (r0, c0) of a row-major shared tile X[r][c]
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* X,
                                       int ld, int r0, int c0, int lane) {
  const bf16* p = X + (r0 + (lane >> 2)) * ld + c0 + 2 * (lane & 3);
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// B operand (k16 x n8) at (n0, k0) of a shared tile Y[n][k], k contiguous
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1,
                                       const bf16* Y, int ld, int n0, int k0,
                                       int lane) {
  const bf16* p = Y + (n0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// The A operand of columns [16kk, 16kk + 16) of a 16-row accumulator
// tile c[n][4] (n-tiles of 8 columns): accumulator and A layouts match.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&c)[N][4], int kk) {
  a[0] = pack(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

__device__ __forceinline__ int64_t row_offset(int b, int s, int h, int S,
                                              int H, int D) {
  return ((static_cast<int64_t>(b) * S + s) * H + h) * D;
}

// Rows [r0, r0 + R) of head h of batch row b of a [B, S, H, D] tensor
// into X[R][D + kPad] and, when Xt is given, transposed into
// Xt[D][R + kPad]; rows at or past S are zero.
template <int D, int R>
__device__ __forceinline__ void stage(bf16* X, bf16* Xt, const bf16* src,
                                      int b, int h, int r0, int S, int H) {
  constexpr int kVec = D / 8;
  constexpr int ld = D + kPad;
  constexpr int ldt = R + kPad;
  for (int i = threadIdx.x; i < R * kVec; i += kThreads) {
    const int r = i / kVec;
    const int c = (i - r * kVec) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S)
      val = *reinterpret_cast<const uint4*>(
          src + row_offset(b, r0 + r, h, S, H, D) + c);
    if (X != nullptr) *reinterpret_cast<uint4*>(X + r * ld + c) = val;
    if (Xt != nullptr) {
      const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) Xt[(c + j) * ldt + r] = e[j];
    }
  }
}

// Tile rows by head dim: a K1/K2 CTA owns kFwdQ query rows and walks k-tiles of kFwdK keys; a K3
// CTA owns kDkvK keys and walks q-tiles of kDkvQ queries.
template <int D>
struct Tiles {
  static constexpr int kFwdQ = 64;
  static constexpr int kFwdK = D <= 64 ? 64 : 32;
  static constexpr int kDkvQ = D <= 64 ? 64 : 32;
  static constexpr int kDkvK = 64;
};

// ---------------------------------------------------------------------------
// K1: forward
// ---------------------------------------------------------------------------

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  static_assert(BQ == 4 * kRowsPerWarp, "four warps of 16 rows");
  constexpr int ld = D + kPad;
  constexpr int ldt = BK + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);          // [BQ][ld]
  bf16* k_s = q_s + BQ * ld;                          // [BK][ld]
  bf16* vt_s = k_s + BK * ld;                         // [D][ldt]
  uint8_t* kv_s = reinterpret_cast<uint8_t*>(vt_s + D * ldt);   // [BK]

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3;
  const int S = a.S, H = a.H;
  const int row0 = q0 + warp * kRowsPerWarp + (lane >> 2);   // and row0 + 8
  const int warp_last = q0 + warp * kRowsPerWarp + kRowsPerWarp - 1;

  stage<D, BQ>(q_s, nullptr, a.q, b, h, q0, S, H);
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    load_a(qf[kk], q_s, ld, warp * kRowsPerWarp, kk * 16, lane);

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[n][j] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  const int k_end = a.causal ? min(S, q0 + BQ) : S;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();   // every warp is done with the previous tile
    stage<D, BK>(k_s, nullptr, a.k, b, h, k0, S, H);
    stage<D, BK>(nullptr, vt_s, a.v, b, h, k0, S, H);
    if (a.mask != nullptr)
      for (int i = threadIdx.x; i < BK; i += kThreads)
        kv_s[i] = (k0 + i < S) ? a.mask[static_cast<int64_t>(b) * S + k0 + i]
                               : 0;
    __syncthreads();
    if (a.causal && k0 > warp_last) continue;

    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[n][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, k_s, ld, n * 8, kk * 16, lane);
        mma(s[n], qf[kk], b0, b1);
      }

    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + n * 8 + 2 * t + (j & 1);
        const int row = row0 + (j >> 1) * 8;
        float x = s[n][j] * a.scale;
        if (col >= S)
          x = -INFINITY;
        else if ((a.causal && col > row) ||
                 (a.mask != nullptr && kv_s[col - k0] == 0))
          x = kNegInf;
        s[n][j] = x;
        mt[j >> 1] = fmaxf(mt[j >> 1], x);
      }
    float rs[2] = {0.f, 0.f};
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
      const float m_new = fmaxf(m[i], mt[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[n][j] - m[j >> 1]);
        s[n][j] = p;
        rs[j >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l[i] = l[i] * alpha[i] + rs[i];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      acc_to_a(pa, s, kk);                 // p rounded to bf16 (v's dtype)
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, vt_s, ldt, n * 8, kk * 16, lane);
        mma(o[n], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    if (row >= S) continue;
    const float li = fmaxf(l[i], 1e-30f);
    bf16* orow = a.out + row_offset(b, row, h, S, H, D);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
          pack(o[n][2 * i] / li, o[n][2 * i + 1] / li);
    if (t == 0)
      a.lse_out[(static_cast<int64_t>(b) * H + h) * S + row] = m[i] + logf(li);
  }
}

// ---------------------------------------------------------------------------
// K2: dq
// ---------------------------------------------------------------------------

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(Args a) {
  static_assert(BQ == 4 * kRowsPerWarp, "four warps of 16 rows");
  constexpr int ld = D + kPad;
  constexpr int ldt = BK + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);          // [BQ][ld]
  bf16* do_s = q_s + BQ * ld;                         // [BQ][ld]
  bf16* k_s = do_s + BQ * ld;                         // [BK][ld]
  bf16* v_s = k_s + BK * ld;                          // [BK][ld]
  bf16* kt_s = v_s + BK * ld;                         // [D][ldt]
  uint8_t* kv_s = reinterpret_cast<uint8_t*>(kt_s + D * ldt);   // [BK]

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3;
  const int S = a.S, H = a.H;
  const int row0 = q0 + warp * kRowsPerWarp + (lane >> 2);
  const int warp_last = q0 + warp * kRowsPerWarp + kRowsPerWarp - 1;

  stage<D, BQ>(q_s, nullptr, a.q, b, h, q0, S, H);
  stage<D, BQ>(do_s, nullptr, a.dout, b, h, q0, S, H);
  __syncthreads();
  uint32_t qf[D / 16][4], df[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    load_a(qf[kk], q_s, ld, warp * kRowsPerWarp, kk * 16, lane);
    load_a(df[kk], do_s, ld, warp * kRowsPerWarp, kk * 16, lane);
  }
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    const int64_t idx = (static_cast<int64_t>(b) * H + h) * S + row;
    lse_r[i] = row < S ? a.lse[idx] : 0.f;
    delta_r[i] = row < S ? a.delta[idx] : 0.f;
  }

  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) dq[n][j] = 0.f;

  const int k_end = a.causal ? min(S, q0 + BQ) : S;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();
    stage<D, BK>(k_s, kt_s, a.k, b, h, k0, S, H);
    stage<D, BK>(v_s, nullptr, a.v, b, h, k0, S, H);
    if (a.mask != nullptr)
      for (int i = threadIdx.x; i < BK; i += kThreads)
        kv_s[i] = (k0 + i < S) ? a.mask[static_cast<int64_t>(b) * S + k0 + i]
                               : 0;
    __syncthreads();
    if (a.causal && k0 > warp_last) continue;

    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[n][j] = dp[n][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, k_s, ld, n * 8, kk * 16, lane);
        mma(s[n], qf[kk], b0, b1);
        load_b(b0, b1, v_s, ld, n * 8, kk * 16, lane);
        mma(dp[n], df[kk], b0, b1);
      }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + n * 8 + 2 * t + (j & 1);
        const int row = row0 + (j >> 1) * 8;
        const float x = s[n][j] * a.scale;
        const bool valid = col < S && row < S && x > 0.5f * kNegInf &&
                           !(a.causal && col > row) &&
                           (a.mask == nullptr || kv_s[col - k0] != 0);
        const float p = valid ? expf(x - lse_r[j >> 1]) : 0.f;
        s[n][j] = p * (dp[n][j] - delta_r[j >> 1]) * a.scale;     // ds
      }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t da[4];
      acc_to_a(da, s, kk);                 // ds rounded to bf16 (k's dtype)
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, kt_s, ldt, n * 8, kk * 16, lane);
        mma(dq[n], da, b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    if (row >= S) continue;
    bf16* drow = a.dq + row_offset(b, row, h, S, H, D);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(drow + n * 8 + 2 * t) =
          pack(dq[n][2 * i], dq[n][2 * i + 1]);
  }
}

// ---------------------------------------------------------------------------
// K3: dk, dv
// ---------------------------------------------------------------------------

// p split into three bf16 terms, packed as the A operand of columns
// [16kk, 16kk + 16): hi + mid + lo carries p's full f32 significand
template <int N>
__device__ __forceinline__ void split3(uint32_t (&hi)[4], uint32_t (&mid)[4],
                                       uint32_t (&lo)[4],
                                       const float (&c)[N][4], int kk) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int n = 2 * kk + (r >> 1);
    const int j = (r & 1) * 2;
    float x[2] = {c[n][j], c[n][j + 1]};
    float h[2], m[2], w[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      h[e] = __bfloat162float(__float2bfloat16(x[e]));
      const float r1 = x[e] - h[e];
      m[e] = __bfloat162float(__float2bfloat16(r1));
      w[e] = r1 - m[e];
    }
    hi[r] = pack(h[0], h[1]);
    mid[r] = pack(m[0], m[1]);
    lo[r] = pack(w[0], w[1]);
  }
}

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(Args a) {
  static_assert(BK == 4 * kRowsPerWarp, "four warps of 16 keys");
  constexpr int ld = D + kPad;
  constexpr int ldt = BQ + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);          // [BK][ld]
  bf16* v_s = k_s + BK * ld;                          // [BK][ld]
  bf16* q_s = v_s + BK * ld;                          // [BQ][ld]
  bf16* do_s = q_s + BQ * ld;                         // [BQ][ld]
  bf16* qt_s = do_s + BQ * ld;                        // [D][ldt]
  bf16* dot_s = qt_s + D * ldt;                       // [D][ldt]
  float* lse_s = reinterpret_cast<float*>(dot_s + D * ldt);     // [BQ]
  float* delta_s = lse_s + BQ;                                  // [BQ]

  const int b = blockIdx.z, h = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3;
  const int S = a.S, H = a.H;
  const int key0 = k0 + warp * kRowsPerWarp + (lane >> 2);     // and + 8
  const int warp_first = k0 + warp * kRowsPerWarp;

  stage<D, BK>(k_s, nullptr, a.k, b, h, k0, S, H);
  stage<D, BK>(v_s, nullptr, a.v, b, h, k0, S, H);
  bool kvalid[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + i * 8;
    kvalid[i] = key < S &&
                (a.mask == nullptr ||
                 a.mask[static_cast<int64_t>(b) * S + key] != 0);
  }

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[n][j] = dv[n][j] = 0.f;

  const int64_t stat = (static_cast<int64_t>(b) * H + h) * S;
  const int q_begin = a.causal ? (k0 / BQ) * BQ : 0;
  for (int q0 = q_begin; q0 < S; q0 += BQ) {
    __syncthreads();
    stage<D, BQ>(q_s, qt_s, a.q, b, h, q0, S, H);
    stage<D, BQ>(do_s, dot_s, a.dout, b, h, q0, S, H);
    for (int i = threadIdx.x; i < BQ; i += kThreads) {
      const bool in = q0 + i < S;
      lse_s[i] = in ? a.lse[stat + q0 + i] : 0.f;
      delta_s[i] = in ? a.delta[stat + q0 + i] : 0.f;
    }
    __syncthreads();
    if (a.causal && warp_first > q0 + BQ - 1) continue;

    float st[BQ / 8][4], dpt[BQ / 8][4];      // [key][query] tiles
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[n][j] = dpt[n][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      load_a(ka, k_s, ld, warp * kRowsPerWarp, kk * 16, lane);
      load_a(va, v_s, ld, warp * kRowsPerWarp, kk * 16, lane);
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, q_s, ld, n * 8, kk * 16, lane);
        mma(st[n], ka, b0, b1);
        load_b(b0, b1, do_s, ld, n * 8, kk * 16, lane);
        mma(dpt[n], va, b0, b1);
      }
    }
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = n * 8 + 2 * t + (j & 1);
        const int query = q0 + qi;
        const int key = key0 + (j >> 1) * 8;
        const float x = st[n][j] * a.scale;
        const bool valid = kvalid[j >> 1] && query < S &&
                           x > 0.5f * kNegInf && !(a.causal && key > query);
        const float p = valid ? expf(x - lse_s[qi]) : 0.f;
        st[n][j] = p;
        dpt[n][j] = p * (dpt[n][j] - delta_s[qi]) * a.scale;      // ds
      }
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t hi[4], mid[4], lo[4], da[4];
      split3(hi, mid, lo, st, kk);
      acc_to_a(da, dpt, kk);               // ds rounded to bf16 (q's dtype)
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, dot_s, ldt, n * 8, kk * 16, lane);
        mma(dv[n], hi, b0, b1);
        mma(dv[n], mid, b0, b1);
        mma(dv[n], lo, b0, b1);
        load_b(b0, b1, qt_s, ldt, n * 8, kk * 16, lane);
        mma(dk[n], da, b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + i * 8;
    if (key >= S) continue;
    const int64_t off = row_offset(b, key, h, S, H, D);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(a.dk + off + n * 8 + 2 * t) =
          pack(dk[n][2 * i], dk[n][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(a.dv + off + n * 8 + 2 * t) =
          pack(dv[n][2 * i], dv[n][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, size_t smem, const Args& a,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

constexpr size_t tile_bytes(int rows, int cols) {
  return static_cast<size_t>(rows) * (cols + kPad) * sizeof(bf16);
}

template <int D>
int fwd(const Args& a, cudaStream_t s) {
  constexpr int BQ = Tiles<D>::kFwdQ, BK = Tiles<D>::kFwdK;
  const size_t smem = tile_bytes(BQ, D) + tile_bytes(BK, D) +
                      tile_bytes(D, BK) + BK;
  return launch(flash_fwd_kernel<D, BQ, BK>,
                dim3((a.S + BQ - 1) / BQ, a.H, a.B), smem, a, s);
}

template <int D>
int dq(const Args& a, cudaStream_t s) {
  constexpr int BQ = Tiles<D>::kFwdQ, BK = Tiles<D>::kFwdK;
  const size_t smem = 2 * tile_bytes(BQ, D) + 2 * tile_bytes(BK, D) +
                      tile_bytes(D, BK) + BK;
  return launch(flash_dq_kernel<D, BQ, BK>,
                dim3((a.S + BQ - 1) / BQ, a.H, a.B), smem, a, s);
}

template <int D>
int dkv(const Args& a, cudaStream_t s) {
  constexpr int BQ = Tiles<D>::kDkvQ, BK = Tiles<D>::kDkvK;
  const size_t smem = 2 * tile_bytes(BK, D) + 2 * tile_bytes(BQ, D) +
                      2 * tile_bytes(D, BQ) + 2 * BQ * sizeof(float);
  return launch(flash_dkv_kernel<D, BQ, BK>,
                dim3((a.S + BK - 1) / BK, a.H, a.B), smem, a, s);
}

// one instantiation per head dim: multiples of 16 up to 128
#define FLASH_DISPATCH(fn)                                 \
  switch (D) {                                               \
    case 16: return fn<16>(a, s);                            \
    case 32: return fn<32>(a, s);                            \
    case 48: return fn<48>(a, s);                            \
    case 64: return fn<64>(a, s);                            \
    case 80: return fn<80>(a, s);                            \
    case 96: return fn<96>(a, s);                            \
    case 112: return fn<112>(a, s);                          \
    case 128: return fn<128>(a, s);                          \
    default: return -1;                                      \
  }

Args make_args(int B, int S, int H, int causal, float scale) {
  Args a{};
  a.B = B;
  a.S = S;
  a.H = H;
  a.causal = causal;
  a.scale = scale;
  return a;
}

bool bad_shape(int B, int S, int H) {
  return B < 1 || S < 1 || H < 1 || B > 65535 || H > 65535;
}

}  // namespace

// The C entry points the ctypes wrappers bind. Shapes, dtypes and
// contiguity are checked by the callers (ops/attention.py); these check
// only what would make a kernel index out of its arrays, and return
// cudaGetLastError() of the launch (0 = success), or -1 for a shape
// they were not built for.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                const void* mask, void* out, void* lse,
                                int B, int S, int H, int D, int causal,
                                float scale, void* stream) {
  if (bad_shape(B, S, H)) return -1;
  Args a = make_args(B, S, H, causal, scale);
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.mask = static_cast<const uint8_t*>(mask);
  a.out = static_cast<bf16*>(out);
  a.lse_out = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(fwd)
}

extern "C" int flash_dq_launch(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, const void* mask,
                               void* dq_out, int B, int S, int H, int D,
                               int causal, float scale, void* stream) {
  if (bad_shape(B, S, H)) return -1;
  Args a = make_args(B, S, H, causal, scale);
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.mask = static_cast<const uint8_t*>(mask);
  a.dq = static_cast<bf16*>(dq_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(dq)
}

extern "C" int flash_dkv_launch(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* mask,
                                void* dk_out, void* dv_out, int B, int S,
                                int H, int D, int causal, float scale,
                                void* stream) {
  if (bad_shape(B, S, H)) return -1;
  Args a = make_args(B, S, H, causal, scale);
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.mask = static_cast<const uint8_t*>(mask);
  a.dk = static_cast<bf16*>(dk_out);
  a.dv = static_cast<bf16*>(dv_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(dkv)
}
