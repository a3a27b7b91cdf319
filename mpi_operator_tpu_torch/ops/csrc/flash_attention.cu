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
// Grid. K2: one CTA per (q-tile, head, batch row) that walks the
// k-tiles. K1 and K3 are persistent: one CTA per SM walks work tiles
// (K1: a 128-query tile of one head and batch row; K3: a 128-key tile),
// the causal tiles with the most work first (K1's q-tiles last to first,
// K3's key tiles first to last). Every output tile has one owner: no
// atomics, and the results repeat bit for bit from run to run. Causal
// work skips the tiles wholly above the diagonal and masks per element
// on the tiles that cross it.
//
// K1 and K3 are warp specialised (FA3's shape). A CTA is three
// warpgroups: one producer warp issues TMA loads into shared memory, and
// two consumer warpgroups, 64 rows each, run the products with wgmma
// (setmaxnreg moves registers from the producer to them). Tiles are read
// through a 4-D tensor map over [B, S, H, D] in boxes of 64 columns of
// one head with the 128-byte swizzle; rows at or past S and columns at or
// past D arrive as zeros, so a head dim under 64 runs as 64 and one above
// 64 as two boxes (two 64-column sub-tiles), and nothing past D is stored.
// - K1: each work tile's 128 query rows once, then K and V tiles of BK
//   keys (128 up to D=64, 64 above) through a ring of kFwdStages stages
//   under full/empty mbarriers; the next work tile's loads start while
//   the last tile of this one is still in the products. S = Q.K^T with
//   both operands K-major in shared memory; the online softmax on the
//   accumulator in registers; O += P.V with P from registers (the
//   accumulator layout of S is the A-operand layout) and V read MN-major
//   from the tile the TMA wrote. On a causal diagonal tile warpgroup 0
//   computes only the 64 keys its rows can see.
// - K3: each work tile's 128 keys of K and V once, then Q and dO tiles of
//   BQ queries (64 up to D=64, 32 above) and their lse/delta through a
//   ring of kDkvStages. S^T = K.Q^T and dP^T = V.dO^T with K-major
//   operands; p and ds on the accumulators; dV += P^T.dO (three products:
//   the hi/mid/lo split of p) and dK += dS^T.Q with dO and Q read MN-major
//   from the same tiles.
// Neither kernel keeps a transposed copy of any tile. Their element-wise
// work is written without branches or conversions where it can be: the
// exponentials are SFU ex2 (K1 queues on the SFU: 16 ex2 a clock per SM,
// as many cycles as its products take on the tensor cores), masks are
// selects on warp-uniform paths, and p's split is integer bit work.
//
// K2 keeps PR 3's design: four warps of 16 rows, mma.sync m16n8k16 with
// hand-gathered fragments, tiles staged synchronously through shared
// memory (k^T staged transposed).
//
// What bounds them on an H100: bytes. At the training shape (B=16,
// S=512, H=16, D=64, causal) a kernel moves 68-102 MB and does 9-17
// GFLOP: 20-30 us at 3.35 TB/s against 9-17 us at 989 TFLOP/s. Each
// input is read from device memory once per CTA that needs it (K and V
// again by every q-tile, as any tiled attention does; the L2 holds them),
// and the score tile never leaves the SM.
//
// Numerics follow the reference kernels, which the plain versions in
// ops/attention.py repeat step by step:
// - scores are f32 dot products times scale = 1/sqrt(D); masked scores
//   are -1e30, never -inf; columns past S are -inf, so they add nothing
//   even to a row that is masked everywhere else (K1 lets a causal
//   diagonal tile without a key mask use -inf: each of its rows sees its
//   own key, so p = 0 there either way);
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
//   to bf16 before ds^T.q;
// - K1 and K3 take e^x as 2^(x log2 e) on the SFU (relative error about
//   2^-22), K2 as expf.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;       // K2: four warps, 16 rows each
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
  int B, S, H, D;
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
// tile c[n][4] (n-tiles of 8 columns): accumulator and A layouts match,
// for mma.sync and, warp by warp, for wgmma.
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

// K2's tiles by head dim: a CTA owns kFwdQ query rows and walks k-tiles
// of kFwdK keys.
template <int D>
struct Tiles {
  static constexpr int kFwdQ = 64;
  static constexpr int kFwdK = D <= 64 ? 64 : 32;
};

// ---------------------------------------------------------------------------
// Hopper building blocks of K1 and K3: mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

constexpr int kWarpgroup = 128;
constexpr int kWsThreads = 3 * kWarpgroup;   // producer + two consumers
// 40 x 128 + 232 x 256 = 168 x 384: the register file one CTA holds
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
// the rings of walked tiles: K1's k-tiles, K3's q-tiles (measured best)
constexpr int kFwdStages = 2;
constexpr int kDkvStages = 3;
constexpr int kBox = 64;                     // bf16 columns of a 128-byte row
constexpr int kRowBytes = 128;
// a wait this long is a barrier that never completes: trap (a launch
// error the caller sees) rather than hang the card
constexpr long long kHangCycles = 1LL << 34;

// K1: 128 query rows a CTA, k-tiles of BK keys; K3: 128 keys a CTA,
// q-tiles of BQ queries. PD is the head dim padded to whole 64-column
// boxes.
template <int PD>
struct WsTiles {
  static constexpr int kFwdQ = 128;
  static constexpr int kFwdK = PD == 64 ? 128 : 64;
  static constexpr int kDkvK = 128;
  static constexpr int kDkvQ = PD == 64 ? 64 : 32;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  long long start = 0;
  for (int spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == 0)
      start = clock64();
    else if (clock64() - start > kHangCycles)
      __trap();
  }
}

// Box (64 columns from column c0 of head h, `rows` rows from row r0 of
// batch row b) of a [B, S, H, D] tensor map into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int h,
                                         int r0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(h), "r"(r0), "r"(b)
      : "memory");
}

// A [rows][PD] tile of head h as PD/64 sub-tiles of [rows][64], each
// rows x 128 bytes, swizzled; columns at or past D arrive as zeros.
template <int PD>
__device__ __forceinline__ void load_tile(unsigned char* dst, int rows,
                                          const CUtensorMap* map,
                                          uint64_t* bar, int h, int r0,
                                          int b) {
#pragma unroll
  for (int sub = 0; sub < PD / kBox; ++sub)
    tma_load(dst + sub * rows * kRowBytes, map, bar, sub * kBox, h, r0, b);
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, the
// leading and stride byte offsets (16-byte units), layout type 1
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// Operand rows [r0, r0 + 8n) x depth columns [16kk, 16kk + 16) of a
// swizzled [rows][PD] tile, read K-major (the product sums over the
// tile's columns): 8-row groups 1024 bytes apart; 32 bytes a k-step
// inside a 64-column sub-tile.
__device__ __forceinline__ uint64_t kmajor(const unsigned char* tile,
                                           int rows, int r0, int kk) {
  return smem_desc(tile + (kk >> 2) * rows * kRowBytes + r0 * kRowBytes +
                       (kk & 3) * 32,
                   16, 8 * kRowBytes);
}

// Operand depth rows [16kk, 16kk + 16) x all PD columns of the same
// tile, read MN-major (the product sums over the tile's rows): 8-row
// groups 1024 bytes apart, 64-column sub-tiles rows x 128 bytes apart.
__device__ __forceinline__ uint64_t mnmajor(const unsigned char* tile,
                                            int rows, int kk) {
  return smem_desc(tile + kk * 16 * kRowBytes, rows * kRowBytes,
                   8 * kRowBytes);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving register reads and writes of a wgmma
// operand across the fence/commit/wait that order them for the hardware.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+f"(d[n][j])::"memory");
}

// A product's accumulator zeroed before its pipeline stage opens, so
// that no instruction but a wgmma defines it inside the stage.
template <int N>
__device__ __forceinline__ void zero(float (&d)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) d[n][j] = 0.f;
  pin(d);
}

template <int N>
__device__ __forceinline__ void pin(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[n][j])::"memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the SFU (ex2.approx, relative error ~2^-22)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// e^x: 0 for -inf and for the -1e30 scale of a masked score, 1 for x = 0
__device__ __forceinline__ float exp_fast(float x) { return ex2(x * kLog2e); }

// Lane 0 arrives for its warp, once every lane is done with what the
// barrier guards.
__device__ __forceinline__ void warp_arrive(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// Work tile w of a persistent grid (CTA i takes w = i, i + grid, ...):
// heads fastest, then batch rows, then the walked tiles, last to first
// when `reversed`, so that the causal tiles with the most work go first.
struct Work {
  int h, b, tile;
};

__device__ __forceinline__ Work work_tile(int w, int H, int B, int n_tiles,
                                          bool reversed) {
  const int per = H * B;
  const int i = w / per, r = w - i * per;
  return {r % H, r / H, reversed ? n_tiles - 1 - i : i};
}

// Dynamic shared memory rounded up to the 1024 bytes the 128-byte
// swizzle repeats over (the launch asks for 1024 bytes more).
__device__ __forceinline__ unsigned char* align_1k(unsigned char* p) {
  const uint32_t off = smem_u32(p) & 1023u;
  return off ? p + (1024u - off) : p;
}

// wgmma m64nNk16, bf16 in, f32 accumulate into d[N/8][4] (the mma.sync
// accumulator layout, warp by warp). wgmma_ss: A and B from shared
// memory, both K-major. wgmma_rs: A from registers, B MN-major.
// scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[4][4], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[16][4], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[8][4],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16][4],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// ---------------------------------------------------------------------------
// K1: forward
// ---------------------------------------------------------------------------

// K1's online softmax on one warpgroup's score accumulator s (q.k^T of
// the k-tile at k0): masked per element only on a tile that crosses the
// diagonal of the warp's rows, the end of S or a key mask (warp-uniform
// branches, selects inside). Without a key mask or the end of S in the
// tile, scores stay raw and scale and log2(e) fold into one FFMA before
// ex2; on such a causal diagonal tile every row sees its own key, so its
// max is finite and a masked score can be -inf instead of -1e30: p = 0
// either way. Leaves p in s, updates m and l, and leaves in alpha the
// factor that rescales o.
template <int BK>
__device__ __forceinline__ void fwd_softmax(float (&s)[BK / 8][4],
                                            float (&m)[2], float (&l)[2],
                                            float (&alpha)[2],
                                            const uint8_t* mask_t,
                                            const Args& a, int t, int k0,
                                            int row0, int warp_first) {
  const int S = a.S;
  const bool raw = k0 + BK <= S && a.mask == nullptr;
  float mt[2] = {-INFINITY, -INFINITY};
  if (raw && !(a.causal && k0 + BK - 1 > warp_first)) {
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) mt[j >> 1] = fmaxf(mt[j >> 1], s[n][j]);
  } else if (raw) {
    // causal diagonal tile: only col > row is masked
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + n * 8 + 2 * t + (j & 1);
        const int row = row0 + (j >> 1) * 8;
        s[n][j] = col > row ? -INFINITY : s[n][j];
        mt[j >> 1] = fmaxf(mt[j >> 1], s[n][j]);
      }
  } else {
    uint32_t keep = ~0u;             // bit 2n + e: key k0 + 8n + 2t + e
    if (a.mask != nullptr) {
      keep = 0;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          keep |= static_cast<uint32_t>(mask_t[n * 8 + 2 * t + e] != 0)
                  << (2 * n + e);
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + n * 8 + 2 * t + (j & 1);
        const int row = row0 + (j >> 1) * 8;
        const bool dead = (a.causal && col > row) ||
                          !((keep >> (2 * n + (j & 1))) & 1u);
        float x = dead ? kNegInf : s[n][j] * a.scale;
        x = col < S ? x : -INFINITY;
        s[n][j] = x;
        mt[j >> 1] = fmaxf(mt[j >> 1], x);
      }
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
    mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
    if (raw) mt[i] *= a.scale;
    const float m_new = fmaxf(m[i], mt[i]);
    alpha[i] = exp_fast(m[i] - m_new);
    m[i] = m_new;
  }
  if (raw) {
    const float c2 = a.scale * kLog2e;
    const float mb[2] = {m[0] * kLog2e, m[1] * kLog2e};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = ex2(fmaf(s[n][j], c2, -mb[j >> 1]));
        s[n][j] = e;
        rs[j >> 1] += e;
      }
  } else {
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = exp_fast(s[n][j] - m[j >> 1]);
        s[n][j] = e;
        rs[j >> 1] += e;
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
    rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
    l[i] = l[i] * alpha[i] + rs[i];
  }
}

// One k-tile of K1 for one consumer warpgroup: s = q.k^T over the tile's
// first NC keys, the online softmax, o rescaled, o += p.v. Releases Q
// (q_empty) after the work tile's last score product.
template <int NC, int PD, int BQ, int BK>
__device__ __forceinline__ void fwd_tile(
    float (&o)[PD / 8][4], float (&m)[2], float (&l)[2],
    const unsigned char* q_s, const unsigned char* kt,
    const unsigned char* vt, const uint8_t* mask_t, uint64_t* q_empty,
    uint64_t* v_full, uint32_t ph, const Args& a, int c, int lane, int k0,
    int row0, int warp_first, bool last) {
  float s[NC / 8][4];
  zero(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < PD / 16; ++kk)
    wgmma_ss(s, kmajor(q_s, BQ, 64 * c, kk), kmajor(kt, BK, 0, kk), 1);
  wgmma_commit();
  wgmma_wait_all();
  pin(s);
  if (last) warp_arrive(q_empty, lane);
  float alpha[2];
  fwd_softmax<NC>(s, m, l, alpha, mask_t, a, lane & 3, k0, row0, warp_first);
#pragma unroll
  for (int n = 0; n < PD / 8; ++n) {
    o[n][0] *= alpha[0];
    o[n][1] *= alpha[0];
    o[n][2] *= alpha[1];
    o[n][3] *= alpha[1];
  }
  uint32_t pa[NC / 16][4];
#pragma unroll
  for (int kk = 0; kk < NC / 16; ++kk) acc_to_a(pa[kk], s, kk);
  mbar_wait(v_full, ph);
  pin(pa);
  pin(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NC / 16; ++kk)
    wgmma_rs(o, pa[kk], mnmajor(vt, BK, kk), 1);
  wgmma_commit();
  wgmma_wait_all();
  pin(o);
  pin(pa);
}

struct FwdParams {
  CUtensorMap q;   // boxes of kFwdQ rows
  CUtensorMap k;   // boxes of kFwdK rows
  CUtensorMap v;
  Args a;
};

template <int PD>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_fwd_kernel(const __grid_constant__ FwdParams p) {
  constexpr int BQ = WsTiles<PD>::kFwdQ, BK = WsTiles<PD>::kFwdK;
  constexpr int kQBytes = BQ * PD * 2, kKBytes = BK * PD * 2;
  constexpr int kStages = kFwdStages;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t q_full, q_empty, k_full[kStages],
      v_full[kStages], empty[kStages];
  __shared__ uint8_t mask_s[kStages * BK];             // [kStages][BK]
  unsigned char* q_s = align_1k(smem_raw);             // [BQ][PD]
  unsigned char* k_s = q_s + kQBytes;                  // [kStages][BK][PD]
  unsigned char* v_s = k_s + kStages * kKBytes;        // [kStages][BK][PD]

  const Args& a = p.a;
  const int S = a.S;
  const int n_q = (S + BQ - 1) / BQ;
  const int n_work = n_q * a.B * a.H;

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    mbar_init(&q_empty, 8);                            // the consumer warps
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWarpgroup;
  if (wg == 0) {
    // producer: one warp loads each work tile's Q, then walks its k-tiles
    // through the ring; `it` counts the ring's loads across work tiles
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        prefetch_map(&p.q);
        prefetch_map(&p.k);
        prefetch_map(&p.v);
      }
      int it = 0;
      for (int w = blockIdx.x, nw = 0; w < n_work; w += gridDim.x, ++nw) {
        const Work wk = work_tile(w, a.H, a.B, n_q, true);
        const int q0 = wk.tile * BQ;
        const int n_k = ((a.causal ? min(S, q0 + BQ) : S) + BK - 1) / BK;
        mbar_wait(&q_empty, (nw & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&q_full, kQBytes);
          load_tile<PD>(q_s, BQ, &p.q, &q_full, wk.h, q0, wk.b);
        }
        for (int ti = 0; ti < n_k; ++ti, ++it) {
          const int st = it % kStages;
          const uint32_t ph = (it / kStages) & 1;
          const int k0 = ti * BK;
          mbar_wait(&empty[st], ph ^ 1);
          if (a.mask != nullptr) {
            for (int i = lane; i < BK; i += 32)
              mask_s[st * BK + i] =
                  k0 + i < S
                      ? a.mask[static_cast<int64_t>(wk.b) * S + k0 + i]
                      : 0;
            __syncwarp();
          }
          if (lane == 0) {
            mbar_expect_tx(&k_full[st], kKBytes);
            load_tile<PD>(k_s + st * kKBytes, BK, &p.k, &k_full[st], wk.h, k0,
                          wk.b);
            mbar_expect_tx(&v_full[st], kKBytes);
            load_tile<PD>(v_s + st * kKBytes, BK, &p.v, &v_full[st], wk.h, k0,
                          wk.b);
          }
        }
      }
    }
  } else {
    // consumers: warpgroup c owns query rows q0 + 64c .. q0 + 64c + 63 of
    // each work tile
    setmaxnreg_inc<kConsumerRegs>();
    const int c = wg - 1;
    const int tid = threadIdx.x - wg * kWarpgroup;
    const int warp = tid >> 5, lane = tid & 31, t = lane & 3;
    int it = 0;
    for (int w = blockIdx.x, nw = 0; w < n_work; w += gridDim.x, ++nw) {
      const Work wk = work_tile(w, a.H, a.B, n_q, true);
      const int h = wk.h, b = wk.b, q0 = wk.tile * BQ;
      const int n_k = ((a.causal ? min(S, q0 + BQ) : S) + BK - 1) / BK;
      const int row0 = q0 + 64 * c + 16 * warp + (lane >> 2);   // and + 8
      const int wg_last = q0 + 64 * c + 63;
      const int warp_first = q0 + 64 * c + 16 * warp;

      float o[PD / 8][4];
#pragma unroll
      for (int n8 = 0; n8 < PD / 8; ++n8)
#pragma unroll
        for (int j = 0; j < 4; ++j) o[n8][j] = 0.f;
      float m[2] = {kNegInf, kNegInf};
      float l[2] = {0.f, 0.f};

      mbar_wait(&q_full, nw & 1);
      for (int ti = 0; ti < n_k; ++ti, ++it) {
        const int st = it % kStages;
        const uint32_t ph = (it / kStages) & 1;
        const int k0 = ti * BK;
        mbar_wait(&k_full[st], ph);
        const unsigned char* kt = k_s + st * kKBytes;
        const unsigned char* vt = v_s + st * kKBytes;
        const bool last = ti == n_k - 1;
        if (a.causal && k0 > wg_last) {   // above every row of this warpgroup
          if (last) warp_arrive(&q_empty, lane);
          mbar_wait(&v_full[st], ph);
        } else if (BK == 128 && a.causal && k0 + 64 > wg_last) {
          // causal diagonal tile of warpgroup 0: its rows see only the
          // tile's first 64 keys
          fwd_tile<64, PD, BQ, BK>(o, m, l, q_s, kt, vt, mask_s + st * BK,
                                   &q_empty, &v_full[st], ph, a, c, lane, k0,
                                   row0, warp_first, last);
        } else {
          fwd_tile<BK, PD, BQ, BK>(o, m, l, q_s, kt, vt, mask_s + st * BK,
                                   &q_empty, &v_full[st], ph, a, c, lane, k0,
                                   row0, warp_first, last);
        }
        warp_arrive(&empty[st], lane);
      }

#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + i * 8;
        if (row >= S) continue;
        const float li = fmaxf(l[i], 1e-30f);
        const float inv = 1.f / li;
        bf16* orow = a.out + row_offset(b, row, h, S, a.H, a.D);
#pragma unroll
        for (int n8 = 0; n8 < PD / 8; ++n8)
          if (n8 * 8 < a.D)
            *reinterpret_cast<uint32_t*>(orow + n8 * 8 + 2 * t) =
                pack(o[n8][2 * i] * inv, o[n8][2 * i + 1] * inv);
        if (t == 0)
          a.lse_out[(static_cast<int64_t>(b) * a.H + h) * S + row] =
              m[i] + logf(li);
      }
    }
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
// [16kk, 16kk + 16): hi + mid + lo carries p's full f32 significand.
// Each term is the top 16 bits of what is left (hi = p truncated to bf16,
// mid = (p - hi) truncated, lo = p - hi - mid, exact in bf16): integer
// ops and byte permutes, no conversions.
template <int N>
__device__ __forceinline__ void split3(uint32_t (&hi)[4], uint32_t (&mid)[4],
                                       uint32_t (&lo)[4],
                                       const float (&c)[N][4], int kk) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int n = 2 * kk + (r >> 1);
    const int j = (r & 1) * 2;
    uint32_t x[2], r1[2], w[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      x[e] = __float_as_uint(c[n][j + e]);
      const float rest = c[n][j + e] - __uint_as_float(x[e] & 0xFFFF0000u);
      r1[e] = __float_as_uint(rest);
      w[e] = __float_as_uint(rest - __uint_as_float(r1[e] & 0xFFFF0000u));
    }
    hi[r] = __byte_perm(x[0], x[1], 0x7632);
    mid[r] = __byte_perm(r1[0], r1[1], 0x7632);
    lo[r] = __byte_perm(w[0], w[1], 0x7632);
  }
}

struct DkvParams {
  CUtensorMap q;      // boxes of kDkvQ rows
  CUtensorMap dout;   // boxes of kDkvQ rows
  CUtensorMap k;      // boxes of kDkvK rows
  CUtensorMap v;
  Args a;
};

template <int PD>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_dkv_kernel(const __grid_constant__ DkvParams p) {
  constexpr int BK = WsTiles<PD>::kDkvK, BQ = WsTiles<PD>::kDkvQ;
  constexpr int kKBytes = BK * PD * 2, kQBytes = BQ * PD * 2;
  constexpr int kStages = kDkvStages;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t kv_full, kv_empty, q_full[kStages],
      empty[kStages];
  __shared__ float lse_s[kStages * BQ], delta_s[kStages * BQ];
  unsigned char* k_s = align_1k(smem_raw);             // [BK][PD]
  unsigned char* v_s = k_s + kKBytes;                  // [BK][PD]
  unsigned char* q_s = v_s + kKBytes;                  // [kStages][BQ][PD]
  unsigned char* do_s = q_s + kStages * kQBytes;       // [kStages][BQ][PD]

  const Args& a = p.a;
  const int S = a.S;
  const int n_k = (S + BK - 1) / BK;
  const int n_work = n_k * a.B * a.H;

  if (threadIdx.x == 0) {
    mbar_init(&kv_full, 1);
    mbar_init(&kv_empty, 8);                           // the consumer warps
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWarpgroup;
  if (wg == 0) {
    // producer: one warp loads each work tile's K and V, then walks its
    // q-tiles through the ring; `it` counts the ring's loads across work
    // tiles
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        prefetch_map(&p.q);
        prefetch_map(&p.dout);
        prefetch_map(&p.k);
        prefetch_map(&p.v);
      }
      int it = 0;
      for (int w = blockIdx.x, nw = 0; w < n_work; w += gridDim.x, ++nw) {
        const Work wk = work_tile(w, a.H, a.B, n_k, false);
        const int k0 = wk.tile * BK;
        const int q_begin = a.causal ? (k0 / BQ) * BQ : 0;
        const int n_q = (S - q_begin + BQ - 1) / BQ;
        const int64_t stat = (static_cast<int64_t>(wk.b) * a.H + wk.h) * S;
        mbar_wait(&kv_empty, (nw & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&kv_full, 2 * kKBytes);
          load_tile<PD>(k_s, BK, &p.k, &kv_full, wk.h, k0, wk.b);
          load_tile<PD>(v_s, BK, &p.v, &kv_full, wk.h, k0, wk.b);
        }
        for (int ti = 0; ti < n_q; ++ti, ++it) {
          const int st = it % kStages;
          const uint32_t ph = (it / kStages) & 1;
          const int q0 = q_begin + ti * BQ;
          mbar_wait(&empty[st], ph ^ 1);
          for (int i = lane; i < BQ; i += 32) {
            const bool in = q0 + i < S;
            lse_s[st * BQ + i] = in ? a.lse[stat + q0 + i] : 0.f;
            delta_s[st * BQ + i] = in ? a.delta[stat + q0 + i] : 0.f;
          }
          __syncwarp();
          if (lane == 0) {
            mbar_expect_tx(&q_full[st], 2 * kQBytes);
            load_tile<PD>(q_s + st * kQBytes, BQ, &p.q, &q_full[st], wk.h, q0,
                          wk.b);
            load_tile<PD>(do_s + st * kQBytes, BQ, &p.dout, &q_full[st], wk.h,
                          q0, wk.b);
          }
        }
      }
    }
  } else {
    // consumers: warpgroup c owns keys k0 + 64c .. k0 + 64c + 63 of each
    // work tile
    setmaxnreg_inc<kConsumerRegs>();
    const int c = wg - 1;
    const int tid = threadIdx.x - wg * kWarpgroup;
    const int warp = tid >> 5, lane = tid & 31, t = lane & 3;
    int it = 0;
    for (int w = blockIdx.x, nw = 0; w < n_work; w += gridDim.x, ++nw) {
      const Work wk = work_tile(w, a.H, a.B, n_k, false);
      const int h = wk.h, b = wk.b, k0 = wk.tile * BK;
      const int q_begin = a.causal ? (k0 / BQ) * BQ : 0;
      const int n_q = (S - q_begin + BQ - 1) / BQ;
      const int key0 = k0 + 64 * c + 16 * warp + (lane >> 2);    // and + 8
      const int wg_first = k0 + 64 * c;
      const int warp_last = k0 + 64 * c + 16 * warp + 15;
      bool kvalid[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int key = key0 + i * 8;
        kvalid[i] = key < S &&
                    (a.mask == nullptr ||
                     a.mask[static_cast<int64_t>(b) * S + key] != 0);
      }

      float dk[PD / 8][4], dv[PD / 8][4];
#pragma unroll
      for (int n = 0; n < PD / 8; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) dk[n][j] = dv[n][j] = 0.f;

      mbar_wait(&kv_full, nw & 1);
      for (int ti = 0; ti < n_q; ++ti, ++it) {
        const int st = it % kStages;
        const uint32_t ph = (it / kStages) & 1;
        const int q0 = q_begin + ti * BQ;
        const unsigned char* qt = q_s + st * kQBytes;
        const unsigned char* dot = do_s + st * kQBytes;
        const float* lse_t = lse_s + st * BQ;
        const float* delta_t = delta_s + st * BQ;
        mbar_wait(&q_full[st], ph);
        if (!(a.causal && wg_first > q0 + BQ - 1)) {
          float sT[BQ / 8][4], dpT[BQ / 8][4];     // [key][query] tiles
          zero(sT);
          zero(dpT);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < PD / 16; ++kk) {
            wgmma_ss(sT, kmajor(k_s, BK, 64 * c, kk), kmajor(qt, BQ, 0, kk), 1);
            wgmma_ss(dpT, kmajor(v_s, BK, 64 * c, kk), kmajor(dot, BQ, 0, kk),
                     1);
          }
          wgmma_commit();
          wgmma_wait_all();
          pin(sT);
          pin(dpT);
          if (ti == n_q - 1) warp_arrive(&kv_empty, lane);  // K, V read
          // p re-masked per element only on a tile that crosses the
          // diagonal of this warp's keys, the end of S or a key mask
          // (warp-uniform branch, selects inside)
          if (a.mask == nullptr && k0 + BK <= S && q0 + BQ <= S &&
              !(a.causal && warp_last > q0)) {
#pragma unroll
            for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int qi = n * 8 + 2 * t + (j & 1);
                const float x = sT[n][j] * a.scale;
                const float e = exp_fast(x - lse_t[qi]);
                const float pv = x > 0.5f * kNegInf ? e : 0.f;
                sT[n][j] = pv;
                dpT[n][j] = pv * (dpT[n][j] - delta_t[qi]) * a.scale;  // ds
              }
          } else {
#pragma unroll
            for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int qi = n * 8 + 2 * t + (j & 1);
                const int query = q0 + qi;
                const int key = key0 + (j >> 1) * 8;
                const float x = sT[n][j] * a.scale;
                // bitwise, not short-circuit: selects, no branches
                const bool valid = (x > 0.5f * kNegInf) & kvalid[j >> 1] &
                                   (query < S) & !(a.causal & (key > query));
                const float e = exp_fast(x - lse_t[qi]);
                const float pv = valid ? e : 0.f;
                sT[n][j] = pv;
                dpT[n][j] = pv * (dpT[n][j] - delta_t[qi]) * a.scale;  // ds
              }
          }
          uint32_t hi[BQ / 16][4], mid[BQ / 16][4], lo[BQ / 16][4],
              da[BQ / 16][4];
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk) {
            split3(hi[kk], mid[kk], lo[kk], sT, kk);
            acc_to_a(da[kk], dpT, kk);         // ds rounded to bf16 (q's dtype)
          }
          pin(hi);
          pin(mid);
          pin(lo);
          pin(da);
          pin(dk);
          pin(dv);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk) {
            const uint64_t bdo = mnmajor(dot, BQ, kk);
            wgmma_rs(dv, hi[kk], bdo, 1);
            wgmma_rs(dv, mid[kk], bdo, 1);
            wgmma_rs(dv, lo[kk], bdo, 1);
            wgmma_rs(dk, da[kk], mnmajor(qt, BQ, kk), 1);
          }
          wgmma_commit();
          wgmma_wait_all();
          pin(dk);
          pin(dv);
          pin(hi);
          pin(mid);
          pin(lo);
          pin(da);
        } else {
          if (ti == n_q - 1) warp_arrive(&kv_empty, lane);
        }
        warp_arrive(&empty[st], lane);
      }

#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int key = key0 + i * 8;
        if (key >= S) continue;
        const int64_t off = row_offset(b, key, h, S, a.H, a.D);
#pragma unroll
        for (int n = 0; n < PD / 8; ++n)
          if (n * 8 < a.D) {
            *reinterpret_cast<uint32_t*>(a.dk + off + n * 8 + 2 * t) =
                pack(dk[n][2 * i], dk[n][2 * i + 1]);
            *reinterpret_cast<uint32_t*>(a.dv + off + n * 8 + 2 * t) =
                pack(dv[n][2 * i], dv[n][2 * i + 1]);
          }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The wgmma layout probe: one warpgroup, one TMA load of each operand,
// s = q.k^T with both operands K-major (K1's scores) and o = bf16(s).v
// with v MN-major (K1's p.v), through the same maps, descriptors and
// wgmma wrappers as K1. The cuda tests hold s and o against
// torch.matmul; it is no part of any training or serving path.
// ---------------------------------------------------------------------------

template <int PD>
__global__ void __launch_bounds__(kWarpgroup, 1)
    wgmma_probe_kernel(const __grid_constant__ FwdParams p, float* s_out,
                       float* o_out) {
  constexpr int BQ = 64, BK = WsTiles<PD>::kFwdK;
  constexpr int kQBytes = BQ * PD * 2, kKBytes = BK * PD * 2;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full;
  unsigned char* q_s = align_1k(smem_raw);
  unsigned char* k_s = q_s + kQBytes;
  unsigned char* v_s = k_s + kKBytes;
  if (threadIdx.x == 0) {
    mbar_init(&full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(&full, kQBytes + 2 * kKBytes);
    load_tile<PD>(q_s, BQ, &p.q, &full, 0, 0, 0);
    load_tile<PD>(k_s, BK, &p.k, &full, 0, 0, 0);
    load_tile<PD>(v_s, BK, &p.v, &full, 0, 0, 0);
  }
  mbar_wait(&full, 0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int row0 = 16 * warp + (lane >> 2);

  float s[BK / 8][4];
  zero(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < PD / 16; ++kk)
    wgmma_ss(s, kmajor(q_s, BQ, 0, kk), kmajor(k_s, BK, 0, kk), 1);
  wgmma_commit();
  wgmma_wait_all();
  pin(s);
  uint32_t pa[BK / 16][4];
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) acc_to_a(pa[kk], s, kk);
  float o[PD / 8][4];
  zero(o);
  pin(pa);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs(o, pa[kk], mnmajor(v_s, BK, kk), 1);
  wgmma_commit();
  wgmma_wait_all();
  pin(o);
  pin(pa);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int row = row0 + (j >> 1) * 8;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
      s_out[row * BK + n * 8 + 2 * t + (j & 1)] = s[n][j];
#pragma unroll
    for (int n = 0; n < PD / 8; ++n)
      o_out[row * PD + n * 8 + 2 * t + (j & 1)] = o[n][j];
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename Kernel, typename... Params>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem,
           cudaStream_t stream, const Params&... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// cuTensorMapEncodeTiled, reached through the runtime's driver entry
// point (no link against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status);
#endif
    if (e == cudaSuccess && status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// The TMA map of a [B, S, H, D] bf16 tensor: boxes of 64 columns x one
// head x `rows` rows x one batch row, 128-byte swizzle, zeros past every
// edge (columns at or past D too: the box may be wider than D). False
// when the driver refuses it.
bool encode_map(CUtensorMap* map, const void* ptr, const Args& a, int rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t d_bytes = static_cast<cuuint64_t>(a.D) * 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(a.D),
                              static_cast<cuuint64_t>(a.H),
                              static_cast<cuuint64_t>(a.S),
                              static_cast<cuuint64_t>(a.B)};
  const cuuint64_t strides[3] = {d_bytes, d_bytes * a.H, d_bytes * a.H * a.S};
  const cuuint32_t box[4] = {kBox, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the entry points' code for a tensor map the driver refused
constexpr int kEncodeFailed = -2;

// A persistent grid: one CTA per SM (the register file holds one), or
// one per work tile when there are fewer. Returns a CUDA error or 0.
int persistent_grid(int64_t n_work, dim3* grid) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  *grid = dim3(static_cast<unsigned>(n_work < sms ? n_work : sms));
  return 0;
}

template <int PD>
int fwd(const Args& a, cudaStream_t s) {
  constexpr int BQ = WsTiles<PD>::kFwdQ, BK = WsTiles<PD>::kFwdK;
  FwdParams p{};
  p.a = a;
  if (!encode_map(&p.q, a.q, a, BQ) || !encode_map(&p.k, a.k, a, BK) ||
      !encode_map(&p.v, a.v, a, BK))
    return kEncodeFailed;
  const size_t smem =
      1024 + BQ * PD * 2 + kFwdStages * 2 * BK * PD * 2;
  dim3 grid;
  const int e = persistent_grid(
      static_cast<int64_t>((a.S + BQ - 1) / BQ) * a.B * a.H, &grid);
  if (e != 0) return e;
  return launch(flash_fwd_kernel<PD>, grid, kWsThreads, smem, s, p);
}

template <int D>
int dq(const Args& a, cudaStream_t s) {
  constexpr int BQ = Tiles<D>::kFwdQ, BK = Tiles<D>::kFwdK;
  const size_t smem = (2 * BQ + 2 * BK) * (D + kPad) * sizeof(bf16) +
                      D * (BK + kPad) * sizeof(bf16) + BK;
  return launch(flash_dq_kernel<D, BQ, BK>,
                dim3((a.S + BQ - 1) / BQ, a.H, a.B), kThreads, smem, s, a);
}

template <int PD>
int dkv(const Args& a, cudaStream_t s) {
  constexpr int BK = WsTiles<PD>::kDkvK, BQ = WsTiles<PD>::kDkvQ;
  DkvParams p{};
  p.a = a;
  if (!encode_map(&p.q, a.q, a, BQ) || !encode_map(&p.dout, a.dout, a, BQ) ||
      !encode_map(&p.k, a.k, a, BK) || !encode_map(&p.v, a.v, a, BK))
    return kEncodeFailed;
  const size_t smem = 1024 + 2 * BK * PD * 2 + kDkvStages * 2 * BQ * PD * 2;
  dim3 grid;
  const int e = persistent_grid(
      static_cast<int64_t>((a.S + BK - 1) / BK) * a.B * a.H, &grid);
  if (e != 0) return e;
  return launch(flash_dkv_kernel<PD>, grid, kWsThreads, smem, s, p);
}

template <int PD>
int probe(const Args& a, float* s_out, float* o_out, cudaStream_t s) {
  constexpr int BK = WsTiles<PD>::kFwdK;
  Args kv = a;             // k and v hold BK rows, q 64
  kv.S = BK;
  FwdParams p{};
  p.a = a;
  if (!encode_map(&p.q, a.q, a, 64) || !encode_map(&p.k, a.k, kv, BK) ||
      !encode_map(&p.v, a.v, kv, BK))
    return kEncodeFailed;
  const size_t smem = 1024 + (64 + 2 * BK) * PD * 2;
  return launch(wgmma_probe_kernel<PD>, dim3(1), kWarpgroup, smem, s, p,
                s_out, o_out);
}

// K2: one instantiation per head dim (multiples of 16 up to 128); K1 and
// K3: one per padded width (64 up to D=64, 128 above)
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
#define WS_DISPATCH(fn) \
  return D <= 64 ? fn<64>(a, s) : fn<128>(a, s);

Args make_args(int B, int S, int H, int D, int causal, float scale) {
  Args a{};
  a.B = B;
  a.S = S;
  a.H = H;
  a.D = D;
  a.causal = causal;
  a.scale = scale;
  return a;
}

bool bad_shape(int B, int S, int H, int D) {
  return B < 1 || S < 1 || H < 1 || B > 65535 || H > 65535 || D < 16 ||
         D > 128 || D % 16 != 0 ||
         // the persistent kernels count work tiles (>= 32 rows) in an int
         static_cast<int64_t>(B) * H * ((S + 31) / 32) > 0x7FFFFFFF;
}

}  // namespace

// The C entry points the ctypes wrappers bind. Shapes, dtypes and
// contiguity are checked by the callers (ops/attention.py); these check
// only what would make a kernel index out of its arrays, and return
// cudaGetLastError() of the launch (0 = success), -1 for a shape they
// were not built for, or -2 when the driver refused a TMA map.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                const void* mask, void* out, void* lse,
                                int B, int S, int H, int D, int causal,
                                float scale, void* stream) {
  if (bad_shape(B, S, H, D)) return -1;
  Args a = make_args(B, S, H, D, causal, scale);
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.mask = static_cast<const uint8_t*>(mask);
  a.out = static_cast<bf16*>(out);
  a.lse_out = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  WS_DISPATCH(fwd)
}

extern "C" int flash_dq_launch(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, const void* mask,
                               void* dq_out, int B, int S, int H, int D,
                               int causal, float scale, void* stream) {
  if (bad_shape(B, S, H, D)) return -1;
  Args a = make_args(B, S, H, D, causal, scale);
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
  if (bad_shape(B, S, H, D)) return -1;
  Args a = make_args(B, S, H, D, causal, scale);
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
  WS_DISPATCH(dkv)
}

// The layout probe: q [1, 64, 1, D], k and v [1, BK, 1, D] bf16 (BK = 128
// for D <= 64, 64 above) -> s_out [64, BK] and o_out [64, PD] f32 (PD =
// D rounded up to 64 or 128).
extern "C" int flash_wgmma_probe_launch(const void* q, const void* k,
                                        const void* v, void* s_out,
                                        void* o_out, int D, void* stream) {
  if (bad_shape(1, 1, 1, D)) return -1;
  Args a = make_args(1, 64, 1, D, 0, 1.f);
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  float* so = static_cast<float*>(s_out);
  float* oo = static_cast<float*>(o_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D <= 64 ? probe<64>(a, so, oo, s) : probe<128>(a, so, oo, s);
}
