// Flash-attention backward for Hopper (sm_90a), CUDA C++ with a plain C
// interface (built by kernels/build.py with nvcc, bound with ctypes in
// kernels/flash_attention.py).
//
// Replaces the two Pallas TPU kernels of `_bwd_chunk` in
// solvingpapers_tpu/kernels/flash_attention.py — `_bwd_dq_kernel`
// (pallas_call at line 484) and `_bwd_dkv_kernel` (pallas_call at line 517)
// — plus the GQA repeat-then-fold that `_flash_bwd` wraps around them,
// with the in-kernel dropout. From the forward's saved per-row
// log-sum-exp `lse` and the caller's delta = rowsum(dO * O), both float32,
// they recompute the probabilities tile by tile and never write an (Sq, Skv)
// matrix to device memory:
//   s  = (q * scale) k^T            p  = exp(s - lse), 0 where masked
//   dp = dO v^T                     ds = p * (dp - delta)
//   dq = scale * ds k               dv = p^T dO       dk = scale * ds^T q
// and with attention-prob dropout at rate > 0 (keep = the philox.cuh mask
// of (seed, b * N + h, row, col), the forward's, redrawn here):
//   dp <- keep * dp / (1 - rate)    dv = (keep * p / (1 - rate))^T dO
// with ds still taking the UNdropped p. Rate 0 compiles the kernels
// without any of it (template DROP).
//
// Semantics, exactly those of the TPU kernels:
//   * causal masks are END-aligned, offset = Skv - Sq: query row r sees kv
//     columns c <= r + offset; a masked probability is 0 (never
//     exp(BIG_NEG - lse)), so a row that saw no key (its forward gave
//     lse = 0) contributes nothing;
//   * lse and delta come from the caller, so a chunked caller (ring
//     attention) can pass the GLOBAL statistics;
//   * GQA: q head h reads kv head h / (N / Nkv); nothing is repeated in
//     device memory, no float sum uses atomics, and results are
//     deterministic.
//
// Both kernels keep their output tile in float32 registers and loop inside
// the block over the other sequence axis (the loop replaces the TPU grid's
// sequential axis), skipping tiles the causal mask hides entirely. Ragged
// Sq / Skv are masked, not padded: rows past the end load as zeros, get
// probability 0 and are never stored.
//
// bfloat16 (the training path): warp-specialised wgmma kernels.
//   * A block is one producer warpgroup and CONSUMERS = 2 consumer
//     warpgroups, each owning a 64-row output tile (the wgmma M): dq — 128
//     q rows of one (b, q head), looping over 64-row kv tiles; dk/dv — 128
//     kv rows of one (b, kv head), looping over the q heads it was given
//     and, for each, over 64-row q tiles. One producer thread starts TMA
//     loads (cp.async.bulk.tensor, 128-byte swizzle, rows past the end
//     zero-filled) into a ring of up to 8 stages on mbarriers — k, v for
//     dq; q, dO for dk/dv, whose producer warp also copies each tile's
//     lse and delta — while the consumers run wgmma.mma_async (m64nNk16,
//     bf16 in, f32 accumulate) and the softmax recompute (those Hopper
//     helpers, shared with the forward, live in hopper.cuh). setmaxnreg moves
//     registers from the producer (24) to the consumers (240); ptxas then
//     allocates the consumers' region up to 240 (it reports the launch
//     bound's 168 for the kernel).
//   * Every operand lives in shared memory once, row-major as in device
//     memory; no transposed copy is made. dq: S = Q K^T and dP = dO V^T with
//     both operands K-major, then dQ += dS K with dS from registers and K
//     read through wgmma's transpose (MN-major) mode. dk/dv: S^T = K Q^T and
//     dP^T = V dO^T (M = kv rows), so P^T and dS^T come out as accumulators
//     whose register layout is the A operand of dV += P^T dO and
//     dK += dS^T Q, with dO and Q MN-major. The accumulator layout is the
//     mma.sync C layout per warp (rows 16w + g, +8), so philox.cuh's
//     keep_bits_rows / keep_bits_cols give the forward's mask bit for bit.
//   * Within a tile the score products run as two groups: p is recomputed
//     from S while dP's products still run, and the dropout bits are drawn
//     while both run. Per-tile decisions (the whole-tile test) are made
//     before the products start: with that test's branch between the
//     products and their wait, ptxas serialised every wgmma of the
//     dropout-free dk/dv kernels.
//   * p and ds enter their products rounded to bf16, as FlashAttention's
//     backward does.
//   * Work split, decided in Python (kernels/flash_attention.py::bwd_plan)
//     and read here: Params::tiles is the launch order of the output tiles
//     (heaviest first), and block i takes tile tiles[i / per-tile blocks].
//     When B * Nkv * kv tiles is too few blocks to fill the card (MQA:
//     DeepSeek-V3's 8 q heads over one kv head), dk/dv splits the GQA
//     group over Params::splits blocks per kv tile, each writing float32
//     partials that the wrapper folds in head order; otherwise the group
//     folds inside the block and the kernel writes bf16 dk, dv.
// float32 (the parity path and the small float32 configs) at D 16, 32, 64
// and 128: both kernels run their products on the tensor cores, mma.sync
// m16n8k8 in 3xTF32 (hopper.cuh; as flash_fwd.cu's float32 kernel), fed by
// cp.async rings of rows at pitch D + 4 (conflict-free fragment reads).
// Each tile's product reaches dq, dk and dv by an ordinary float add (the
// tensor cores' truncating accumulation never runs over the whole
// sequence), and a score-shaped accumulator is the A operand of the next
// product in place (c_as_a), its B read at the permuted rows (2t, 2t + 1):
// no transposed copy and no P or dS tile in shared memory.
//   * dq, `flash_bwd_dq_tf32`: a block is 64 q rows of one (b, q head),
//     launched heaviest first, and two halves of 4 warps (16 q rows a
//     warp) on alternate kv tiles of 64 rows (32 at D 128), as the float32
//     forward's halves; they add their dq partials through shared memory
//     at the end, so 8 warps share a q tile and phase 7's 256 blocks still
//     fill the card. cp.async copies the q tile (scaled on arrival) and the
//     dO tile once and a ring of two stages, each a pair of k and v tiles.
//     S = Q K^T and dP = dO V^T take q's and dO's A fragments and k's and v's B
//     fragments by ldmatrix.x4; p = exp2(s log2 e - lse log2 e) (a masked
//     score is -inf, so p is exactly 0), with dropout the keep bits of
//     keep_bits_rows in the C fragment's layout; dS stays in C fragments
//     and gives dQ += dS K with k's B fragments at the permuted rows.
//   * dk/dv, `flash_bwd_dkv_tf32`: A block is 64 kv rows and 8 warps, a
//     pair of warps on each 16 kv rows: each warp of a pair takes half of
//     D, both for the score products (the pair adds its two partial s^T and
//     dp^T through shared memory) and for dk and dv, which it owns on that
//     half (D / 2 accumulator registers a warp: one warp holding all of dk
//     and dv at D 128 spilled). cp.async copies k and v once and a ring of
//     two stages of q (scaled on arrival), dO, lse and delta tiles of 64
//     rows (32 at D 128, for shared memory). S^T = K Q^T and dP^T = V dO^T
//     take k's and v's A fragments and q's and dO's B fragments by
//     ldmatrix.x4; their accumulators give dV += P^T dO and dK += dS^T Q.
//     The split of the GQA group and the launch order are `bwd_plan`'s,
//     with kv tiles of KV32 rows: phase 7's MQA shape (1 kv head, 8 q
//     heads, 2048 rows) runs 8 x 32 blocks, not 32.
// What bounds them: at the training shapes dq does 3 and dk/dv 4 products
// of 2*D operations per visible (row, column) pair against O(D) bytes per
// row, so both are compute-bound at the tensor-core peak (float32: three
// tf32 products at 495 TFLOP/s); PERF.md keeps their measured times
// beside that bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"
#include "philox.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 64;  // float32 kernels: q rows of a tile (dq: of a block)
constexpr float LOG2E = 1.4426950408889634f;

// All tensors contiguous: q, dO, dq (B, Sq, N, D); k, v, dk, dv
// (B, Skv, Nkv, D), or with splits > 1 float32 dk, dv partials
// (splits, B, Skv, Nkv, D); lse, delta (B*N, Sq).
struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  int B, N, Nkv, Sq, Skv;
  float scale;
  int causal;
  unsigned long long seed;  // dropout: Philox key
  uint32_t threshold;       // dropout: keep iff word < threshold
  float drop_scale;         // dropout: 1 / (1 - rate)
  int splits;               // dk/dv: blocks per (b, kv head, kv tile)
  const int* tiles;         // output tiles in launch order (not float32 dq's)
};

// first q row at or after which query rows can see kv column `col`, rounded
// down to a 64-row q tile (0 when every row sees it)
__device__ __forceinline__ int first_live_q(const Params& p, int col) {
  if (!p.causal) return 0;
  const int r = col - (p.Skv - p.Sq);
  return r <= 0 ? 0 : (r / BQ) * BQ;
}

// one past the last kv column any of rows [r0, r0 + n) (clipped to Sq) can
// see; 0 when the range holds no row
__device__ __forceinline__ int kv_end_rows(const Params& p, int r0, int n) {
  if (r0 >= p.Sq) return 0;
  if (!p.causal) return p.Skv;
  const int last = min(r0 + n, p.Sq) - 1;
  return max(0, min(p.Skv, last + (p.Skv - p.Sq) + 1));
}

__device__ __forceinline__ bool visible(const Params& p, int row, int col) {
  return row < p.Sq && col < p.Skv &&
         (!p.causal || col <= row + (p.Skv - p.Sq));
}

// ---------------------------------------------------------------------------
// float32: 3xTF32 on the tensor cores (mma.sync), fed by cp.async rings

constexpr int THREADS32 = 256;  // 8 warps a block
constexpr int STAGES32 = 2;     // tiles (dq: pairs of tiles) in flight
constexpr int KV32 = 64;        // dk/dv: kv rows a block, 4 warp pairs of 16

// q rows a tile: 64, or 32 at D 128, where the stages of 64 rows and the
// pairs' partial scores would not fit in shared memory beside k and v
template <int D>
constexpr int dkv_q_rows() {
  return D == 128 ? 32 : 64;
}

// shared memory in floats: the block's k and v tiles, then per stage a q
// tile (scaled), a dO tile and their rows' lse and delta, then each warp's
// partial s^T and dp^T for its pair (X floats a lane); rows at pitch D + 4
template <int D>
struct DkvTf32Smem {
  static constexpr int TQ = dkv_q_rows<D>();
  static constexpr int P = D + 4;
  static constexpr int V = KV32 * P;
  static constexpr int STAGE0 = 2 * KV32 * P;
  static constexpr int STAGE = 2 * TQ * P + 2 * TQ;  // q, dO, lse, delta
  static constexpr int X = TQ;                       // 2 x (TQ / 8) n8 tiles x 4
  static constexpr int XBUF = STAGE0 + STAGES32 * STAGE;  // warp w at XBUF + w * X * 32
  static constexpr size_t bytes = sizeof(float) * (XBUF + (THREADS32 / 32) * X * 32);
  static_assert(BQ % TQ == 0, "first_live_q rounds to a whole q tile");
};

// c (16 x 8NQ) = the 16 rows at `a` times the 8NQ rows at `b` transposed,
// over 8KS columns at both (dk/dv: half of D; dq: all of it); A and B
// fragments by ldmatrix_x4 at this lane's addresses, pitch D + 4. The small
// terms go to an accumulator of their own, added at the end. The k-steps
// run in unrolled runs of at most R (dq at D 128 takes 16 k-steps)
template <int D, int NQ, int KS, int R = 8>
__device__ __forceinline__ void score_product(float (&c)[NQ][4], uint32_t a, uint32_t b) {
  constexpr int P = D + 4;
  constexpr int RUN = KS < R ? KS : R;
  float e[NQ][4];
  zero(c);
  zero(e);
#pragma unroll 1
  for (int k0 = 0; k0 < KS; k0 += RUN)
#pragma unroll
  for (int kk = k0; kk < k0 + RUN; ++kk) {
    uint32_t x[4];
    Tf32A af;
    ldmatrix_x4(x, a + 32u * kk);
    split_tf32(x, af.big, af.small);
#pragma unroll
    for (int np = 0; np < NQ / 2; ++np) {
      uint32_t y[4];
      Tf32B b0, b1;
      ldmatrix_x4(y, b + 4u * (16 * np * P) + 32u * kk);
      b_frags(y, b0, b1);
      mma_3xtf32(c[2 * np], e[2 * np], af, b0);
      mma_3xtf32(c[2 * np + 1], e[2 * np + 1], af, b1);
    }
  }
#pragma unroll
  for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[nt][i] += e[nt][i];
}

// acc (16 x 8NT) += x (16 x 8NQ, C fragments, as the A operand) times
// the 8NQ rows from `rows` (this lane's first: row 2t, column g; pitch
// D + 4), in passes of PASS k-steps (8 PASS registers of A fragments):
// each n8 tile of acc takes a pass's product, accumulated from zero, by
// one add
template <int D, int PASS = 4, int NT, int NQ>
__device__ __forceinline__ void add_product(float (&acc)[NT][4], const float (&x)[NQ][4],
                                            const float* rows) {
  constexpr int P = D + 4;
  static_assert(NQ % PASS == 0, "whole passes");
#pragma unroll
  for (int k0 = 0; k0 < NQ; k0 += PASS) {
    Tf32A xa[PASS];
#pragma unroll
    for (int kk = 0; kk < PASS; ++kk) xa[kk] = c_as_a(x[k0 + kk]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float d[4] = {0.f, 0.f, 0.f, 0.f}, e[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < PASS; ++kk) {
        const float* r = rows + 8 * (k0 + kk) * P + 8 * nt;
        mma_3xtf32(d, e, xa[kk], b_of(r[0], r[P]));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] += d[i] + e[i];
    }
  }
}

// dk/dv: block i = (kv tile p.tiles[i / per_tile], b * Nkv + kv head,
// split), per_tile = B * Nkv * splits, as the bf16 kernel's; the block
// loops over its group / splits q heads and, for each, over the TQ-row q
// tiles from the first 64-row tile that sees the kv tile. Warps w and w + 4
// are a pair on kv rows kv0 + 16 (w % 4): each computes s^T and dp^T over
// its half of D, the pair adds the halves through shared memory, and each
// then owns dk, dv on its half of D (D / 2 accumulator registers each, not
// D: at D 128 a warp holding all of dk and dv spilled). With splits > 1 it
// writes float32 partials for the wrapper to fold.
template <int D, bool DROP>
__global__ void __launch_bounds__(THREADS32, 1) flash_bwd_dkv_tf32(const Params p) {
  using SM = DkvTf32Smem<D>;
  constexpr int TQ = SM::TQ;
  constexpr int NQ = TQ / 8;  // n8 tiles of a warp's s^T and dp^T
  constexpr int P = SM::P;
  constexpr int NT = D / 16;  // n8 tiles of a warp's dk and dv (half of D)
  extern __shared__ __align__(16) float fsm[];
  const uint32_t sbase = smem_addr(fsm);

  const int per_tile = p.B * p.Nkv * p.splits;
  const int tile = blockIdx.x / per_tile;
  const int rest = blockIdx.x - tile * per_tile;
  const int bkv = rest / p.splits;
  const int split = rest - bkv * p.splits;
  const int b = bkv / p.Nkv;
  const int kvh = bkv - b * p.Nkv;
  const int group = p.N / p.Nkv;
  const int heads = group / p.splits;
  const int h0 = kvh * group + split * heads;
  const int kv0 = p.tiles[tile] * KV32;
  const int q_first = first_live_q(p, kv0);
  const int n_q = p.Sq > q_first ? (p.Sq - q_first + TQ - 1) / TQ : 0;
  const int iters = heads * n_q;
  const int offset = p.Skv - p.Sq;
  const int tid = threadIdx.x;
  const long long qstride = static_cast<long long>(p.N) * D;
  const long long kstride = static_cast<long long>(p.Nkv) * D;
  const long long head0 = (static_cast<long long>(b) * p.Skv * p.Nkv + kvh) * D;
  auto stage = [&](int it) { return SM::STAGE0 + (it % STAGES32) * SM::STAGE; };
  // q tile, dO tile, lse and delta of item it (q head, TQ-row q tile)
  auto load_item = [&](int it) {
    const int h = h0 + it / n_q;
    const int q0 = q_first + (it % n_q) * TQ;
    const uint32_t st = sbase + 4u * stage(it);
    const long long at = static_cast<long long>(b) * p.Sq * qstride + h * D + q0 * qstride;
    load_rows<D, THREADS32>(st, static_cast<const float*>(p.q) + at, qstride, TQ, p.Sq - q0,
                            tid);
    load_rows<D, THREADS32>(st + 4u * TQ * P, static_cast<const float*>(p.dout) + at, qstride,
                            TQ, p.Sq - q0, tid);
    if (tid < 2 * TQ) {
      const int r = tid % TQ;
      const bool in = q0 + r < p.Sq;
      const float* src = (tid < TQ ? p.lse : p.delta) +
                         static_cast<long long>(b * p.N + h) * p.Sq + (in ? q0 + r : 0);
      cp_async4(st + 4u * (2 * TQ * P + tid), src, in);
    }
  };
  auto scale_q = [&](int it) { scale_rows<D, THREADS32>(fsm + stage(it), TQ, p.scale, tid); };

  // k, v and item 0 in one group; each item's q is scaled where it landed
  load_rows<D, THREADS32>(sbase, static_cast<const float*>(p.k) + head0 + kv0 * kstride,
                          kstride, KV32, p.Skv - kv0, tid);
  load_rows<D, THREADS32>(sbase + 4u * SM::V,
                          static_cast<const float*>(p.v) + head0 + kv0 * kstride, kstride,
                          KV32, p.Skv - kv0, tid);
  if (iters > 0) load_item(0);
  cp_async_commit();
  cp_async_wait<0>();
  if (iters > 0) scale_q(0);
  __syncthreads();

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wq = warp % 4;
  const int dc = (warp / 4) * (D / 2);  // the warp's half of D
  const int kw = kv0 + 16 * wq;         // the pair's first kv row
  // ldmatrix.x4 addresses (matrix lane / 8, its row lane % 8): k's and v's
  // A fragments (rows kw.., columns dc + 8kk..: rows +0 / +8 x columns
  // +0 / +4), q's and dO's B fragments (two n8 tiles x columns +0 / +4)
  const int mi = lane / 8;
  const int mr = lane % 8;
  const uint32_t a_lane = sbase + 4u * ((16 * wq + mr + 8 * (mi & 1)) * P + dc + 4 * (mi >> 1));
  const uint32_t b_lane = 4u * ((8 * (mi >> 1) + mr) * P + dc + 4 * (mi & 1));
  float* xmine = fsm + SM::XBUF + warp * SM::X * 32 + lane;
  const float* xpair = fsm + SM::XBUF + (warp ^ 4) * SM::X * 32 + lane;

  float dk[NT][4], dv[NT][4];
  zero(dk);
  zero(dv);

#pragma unroll 1  // one q tile at a time
  for (int it = 0; it < iters; ++it) {
    if (it + 1 < iters) load_item(it + 1);
    cp_async_commit();
    const int h = h0 + it / n_q;
    const int qa = q_first + (it % n_q) * TQ;  // the tile's first q row
    const uint32_t qs = sbase + 4u * stage(it);
    const float* qf = fsm + stage(it);
    const float* dof = qf + TQ * P;
    const float* lse_s = qf + 2 * TQ * P;
    const float* dl_s = lse_s + TQ;
    // the pair skips a tile none of whose q rows sees its first kv row
    if (kw < p.Skv && (!p.causal || kw <= min(qa + TQ - 1, p.Sq - 1) + offset)) {
      // with dropout, this q head's keep bits in the transposed layout (the
      // forward's mask, philox.cuh)
      uint32_t kb = 0;
      if (DROP)
        kb = dropout::keep_bits_cols<TQ / 16>(p.seed, static_cast<uint32_t>(b * p.N + h),
                                              qa + 2 * t, kw + g, p.threshold);
      // s^T = k q^T and dp^T = v dO^T (16 kv rows x TQ q columns) over
      // this warp's half of D, then the pair's halves added (the same sum
      // in both warps): st[nt][c] is kv row kw + g + 8 (c / 2), q row
      // qa + 8nt + 2t + c % 2
      float st[NQ][4], dpt[NQ][4];
      score_product<D, NQ, D / 16>(st, a_lane, qs + b_lane);
      score_product<D, NQ, D / 16>(dpt, a_lane + 4u * SM::V, qs + 4u * TQ * P + b_lane);
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          xmine[(4 * nt + c) * 32] = st[nt][c];
          xmine[(4 * NQ + 4 * nt + c) * 32] = dpt[nt][c];
        }
      bar_sync(1 + wq, 64);
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          st[nt][c] += xpair[(4 * nt + c) * 32];
          dpt[nt][c] += xpair[(4 * NQ + 4 * nt + c) * 32];
        }
      // p = exp(s - lse), 0 where masked (a tile every element of which
      // the pair sees skips the test; the test is a select, not a branch);
      // ds = p (dp - delta), and with dropout dp and dv's p are
      // keep * x / (1 - rate)
      const bool whole = qa + TQ <= p.Sq && kw + 16 <= p.Skv &&
                         (!p.causal || kw + 15 <= qa + offset);
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = 8 * nt + 2 * t + c % 2;  // q row qa + r
          const int kv = kw + g + 8 * (c / 2);
          const bool vis = whole || (qa + r < p.Sq && kv < p.Skv &&
                                     (!p.causal || kv <= qa + r + offset));
          const float ex = exp2_approx((st[nt][c] - lse_s[r]) * LOG2E);
          const float pv = vis ? ex : 0.f;
          float dpv = dpt[nt][c];
          float pu = pv;
          if (DROP) {
            const bool kp = (kb >> (4 * nt + c)) & 1u;
            pu = kp ? pv * p.drop_scale : 0.f;
            dpv = kp ? dpv * p.drop_scale : 0.f;
          }
          dpt[nt][c] = pv * (dpv - dl_s[r]);
          st[nt][c] = pu;
        }
      // dV += P^T dO and dK += dS^T q on this warp's half of D, over the
      // tile's q rows: k-step kk takes n8 tile kk (q rows 8kk + 2t, + 1 as
      // its k indices t, t + 4), so dO's and q's B fragments are those
      // rows, column dc + g
      const int row = 2 * t * P + dc + g;
      add_product<D>(dv, st, dof + row);
      add_product<D>(dk, dpt, qf + row);
    }
    cp_async_wait<0>();  // item it + 1 has landed: scale its q
    if (it + 1 < iters) scale_q(it + 1);
    __syncthreads();  // every warp is done with item it's stage and scores
  }

  const long long part0 = static_cast<long long>(split) * p.B * p.Skv * kstride;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = kw + g + 8 * i;
    if (row >= p.Skv) continue;
    const long long at = part0 + head0 + row * kstride + dc + 2 * t;
    float* dkr = static_cast<float*>(p.dk) + at;
    float* dvr = static_cast<float*>(p.dv) + at;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      *reinterpret_cast<float2*>(dkr + 8 * nt) = make_float2(dk[nt][2 * i], dk[nt][2 * i + 1]);
      *reinterpret_cast<float2*>(dvr + 8 * nt) = make_float2(dv[nt][2 * i], dv[nt][2 * i + 1]);
    }
  }
}

// the dq kernel's form at (D, DROP): TKV kv rows a tile (each half of the
// block takes every other tile: 64, or 32 at D 128, where a pair of 64-row
// k and v tiles a stage would not fit beside the q and dO tiles), the
// score products' k-steps in unrolled runs of RUN, dQ += dS K in passes of
// PASS k-steps. At D 128 ptxas holds the kernel at 255 registers, and
// whether it spills inside the tile loop turned on these two: of the forms
// probes/flash_dq_ab.py builds, runs of 8 and passes of 4 spill there
// without dropout and not with it, runs of 4 and passes of 2 the other way
template <int D, bool DROP>
struct DqForm {
  static constexpr int TKV = D == 128 ? 32 : 64;
  static constexpr int RUN = D == 128 && !DROP ? 4 : 8;
  static constexpr int PASS = D == 128 && !DROP ? 2 : 4;
};

// shared memory in floats of the dq kernel: the block's q tile (scaled)
// and dO tile, then per stage a pair of TKV-row k and v tiles, one for
// each half; rows at pitch D + 4. After the loop the stages hold the
// halves' merge
template <int D, int TKV>
struct DqTf32Smem {
  static constexpr int P = D + 4;
  static constexpr int T = TKV * P;      // a k or v tile
  static constexpr int KV = 2 * BQ * P;  // stage s, half h: k at KV + (2s + h) 2T, v at + T
  static constexpr size_t bytes = sizeof(float) * (KV + STAGES32 * 4 * T);
  static_assert(STAGES32 * 4 * T >= (THREADS32 / 2) * (D / 2), "the merge fits");
  static_assert(TKV % 16 == 0, "keep_bits_rows draws 16 columns a group");
};

// dq: block i = (q tile q_tiles - 1 - i / (B * N), b * N + h = i % (B *
// N)), heaviest tiles first; warps w and w + 4 own q rows q0 + 16 (w % 4)
// and take alternate kv tiles (half w / 4: tiles 2j + w / 4), so a block
// is 8 warps on 64 q rows; the halves' dq partials meet at the end. One
// block an SM (up to 255 registers a thread): at two, capped at 128, the
// D 32 and 64 kernels spilled inside the tile loop, and at D <= 64 two
// were no faster than one
template <int D, bool DROP, int TKV = DqForm<D, DROP>::TKV, int RUN = DqForm<D, DROP>::RUN,
          int PASS = DqForm<D, DROP>::PASS>
__global__ void __launch_bounds__(THREADS32, 1) flash_bwd_dq_tf32(const Params p) {
  using SM = DqTf32Smem<D, TKV>;
  constexpr int P = SM::P;
  constexpr int NK = TKV / 8;  // n8 tiles of a warp's s and dp
  constexpr int NT = D / 8;    // n8 tiles of a warp's dq
  constexpr int HT = THREADS32 / 2;
  extern __shared__ __align__(16) float fsm[];
  const uint32_t sbase = smem_addr(fsm);

  const int n_bh = p.B * p.N;
  const int q_tiles = (p.Sq + BQ - 1) / BQ;
  const int bn = blockIdx.x % n_bh;
  const int q0 = (q_tiles - 1 - static_cast<int>(blockIdx.x) / n_bh) * BQ;
  const int b = bn / p.N;
  const int h = bn - b * p.N;
  const int kvh = h / (p.N / p.Nkv);
  const int kv_tiles = (kv_end_rows(p, q0, BQ) + TKV - 1) / TKV;
  const int pairs = (kv_tiles + 1) / 2;
  const int offset = p.Skv - p.Sq;
  const int tid = threadIdx.x;
  // offsets and strides are recomputed where they are used, from the
  // parameters (constant memory): kept across the tile loop, their 64-bit
  // registers pushed the D 128 kernel past 255 and into a spill
  auto q_at = [&] {  // row q0 of (b, h) in q, dO and dq
    return (static_cast<long long>(b) * p.Sq + q0) * p.N * D + h * D;
  };
  auto tile = [&](int it, int half) { return SM::KV + ((it % STAGES32) * 2 + half) * 2 * SM::T; };
  // kv tiles 2it and 2it + 1, one for each half
  auto load_pair = [&](int it) {
    const long long kstride = static_cast<long long>(p.Nkv) * D;
#pragma unroll 1
    for (int half = 0; half < 2 && 2 * it + half < kv_tiles; ++half) {
      const int kv0 = (2 * it + half) * TKV;
      const long long at = (static_cast<long long>(b) * p.Skv + kv0) * kstride + kvh * D;
      const uint32_t kt = sbase + 4u * tile(it, half);
      load_rows<D, THREADS32>(kt, static_cast<const float*>(p.k) + at, kstride, TKV,
                              p.Skv - kv0, tid);
      load_rows<D, THREADS32>(kt + 4u * SM::T, static_cast<const float*>(p.v) + at, kstride, TKV,
                              p.Skv - kv0, tid);
    }
  };

  // the q and dO tiles and the first pair in one group; q is scaled where
  // it landed
  const long long qstride = static_cast<long long>(p.N) * D;
  load_rows<D, THREADS32>(sbase, static_cast<const float*>(p.q) + q_at(), qstride, BQ,
                          p.Sq - q0, tid);
  load_rows<D, THREADS32>(sbase + 4u * BQ * P, static_cast<const float*>(p.dout) + q_at(),
                          qstride, BQ, p.Sq - q0, tid);
  if (pairs > 0) load_pair(0);
  cp_async_commit();

  // this thread's rows row0 and row0 + 8 of its warp's 16 (from r0)
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int half = warp / 4;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = q0 + 16 * (warp % 4);
  const int row0 = r0 + g;
  const int last = min(r0 + 15, p.Sq - 1);  // the warp's last row in range
  cp_async_wait<0>();
  scale_rows<D, THREADS32>(fsm, BQ, p.scale, tid);
  __syncthreads();

  // ldmatrix.x4 addresses (matrix lane / 8, its row lane % 8): q's and
  // dO's A fragments (rows r0.., columns 8kk..: rows +0 / +8 x columns
  // +0 / +4), k's and v's B fragments (two n8 tiles x columns +0 / +4)
  const int mi = lane / 8;
  const int mr = lane % 8;
  const uint32_t qa = sbase + 4u * ((r0 - q0 + mr + 8 * (mi & 1)) * P + 4 * (mi >> 1));
  const uint32_t da = qa + 4u * BQ * P;
  const uint32_t kb_lane = 4u * ((8 * (mi >> 1) + mr) * P + 4 * (mi & 1));

  float acc[NT][4];
  zero(acc);

#pragma unroll 1  // one pair of tiles at a time
  for (int it = 0; it < pairs; ++it) {
    if (it + 1 < pairs) load_pair(it + 1);
    cp_async_commit();
    const int kv0 = (2 * it + half) * TKV;
    const int kt = tile(it, half);
    // a warp whose rows see no column of its tile skips it
    if (kv0 < kv_tiles * TKV && r0 < p.Sq && (!p.causal || kv0 <= last + offset)) {
      // with dropout, the keep bits in the C fragment's layout (the
      // forward's mask, philox.cuh)
      uint32_t kb = 0;
      if (DROP)
        kb = dropout::keep_bits_rows<TKV / 16>(p.seed, bn, row0, kv0 + 2 * t, p.threshold);
      // the rows' lse (x log2 e) and delta, read again each tile (L1 hits)
      // rather than held in registers across the loop
      float lse2[2], dl[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + 8 * i;
        const bool in = row < p.Sq;
        lse2[i] = in ? p.lse[static_cast<long long>(bn) * p.Sq + row] * LOG2E : 0.f;
        dl[i] = in ? p.delta[static_cast<long long>(bn) * p.Sq + row] : 0.f;
      }
      // s = (q scale) k^T (16 x TKV): sc[nt][c] is row row0 + 8 (c / 2),
      // column kv0 + 8nt + 2t + c % 2; a tile every row of this warp sees
      // whole skips the mask, and a masked score is -inf, so p is exactly 0
      float sc[NK][4];
      score_product<D, NK, D / 8, RUN>(sc, qa, sbase + 4u * kt + kb_lane);
      const bool whole =
          r0 + 16 <= p.Sq && kv0 + TKV <= p.Skv && (!p.causal || kv0 + TKV - 1 <= r0 + offset);
      if (!whole) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          // row row0 + 8i sees the columns below lim (from kv0 + 2t)
          const int row = row0 + 8 * i;
          const int lim =
              (row >= p.Sq ? 0 : p.causal ? min(p.Skv, row + offset + 1) : p.Skv) - (kv0 + 2 * t);
#pragma unroll
          for (int nt = 0; nt < NK; ++nt)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              if (8 * nt + j >= lim) sc[nt][2 * i + j] = -INFINITY;
        }
      }
      // p = exp(s - lse) in base 2
#pragma unroll
      for (int nt = 0; nt < NK; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          sc[nt][c] = exp2_approx(fmaf(sc[nt][c], LOG2E, -lse2[c / 2]));
      // dp = dO v^T, then ds = p (dp - delta), with dropout dp is
      // keep * dp / (1 - rate)
      float dp[NK][4];
      score_product<D, NK, D / 8, RUN>(dp, da, sbase + 4u * (kt + SM::T) + kb_lane);
#pragma unroll
      for (int nt = 0; nt < NK; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float dpv = dp[nt][c];
          if (DROP) dpv = (kb >> (4 * nt + c)) & 1u ? dpv * p.drop_scale : 0.f;
          sc[nt][c] *= dpv - dl[c / 2];
        }
      // dQ += dS K: k-step kk takes ds's n8 tile kk (columns 2t, 2t + 1 as
      // its k indices t, t + 4), so k's B fragment is rows 2t, 2t + 1,
      // column g; each n8 tile of dq takes the tile's product by one add
      add_product<D, PASS>(acc, sc, fsm + kt + 2 * t * P + g);
    }
    cp_async_wait<0>();  // the next pair has landed
    __syncthreads();     // and every warp is done with this pair's stage
  }

  // the halves (same rows, alternate kv tiles) meet: half 1 leaves its dq
  // in the stages, half 0 adds it and writes dq = scale * (half 0 + half 1)
  float* mg = fsm + SM::KV;
  const int ht = tid % HT;
  if (half == 1) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) mg[(4 * nt + c) * HT + ht] = acc[nt][c];
  }
  __syncthreads();
  if (half == 1) return;
  float* dqg = static_cast<float*>(p.dq) + q_at();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= p.Sq) continue;
    float* dqr = dqg + (row - q0) * static_cast<long long>(p.N) * D + 2 * t;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      *reinterpret_cast<float2*>(dqr + 8 * nt) =
          make_float2((acc[nt][2 * i] + mg[(4 * nt + 2 * i) * HT + ht]) * p.scale,
                      (acc[nt][2 * i + 1] + mg[(4 * nt + 2 * i + 1) * HT + ht]) * p.scale);
  }
}

// ---------------------------------------------------------------------------
// bfloat16: warp-specialised wgmma kernels fed by TMA

constexpr int CONSUMERS = 2;                      // consumer warpgroups a block
constexpr int WG_THREADS = WG * (1 + CONSUMERS);  // + the producer warpgroup
constexpr int TR = 64;                            // rows of a tile (wgmma M)
constexpr int BLOCK_ROWS = CONSUMERS * TR;        // output rows of a block

// A 64-row tile of D columns is D / 64 panels, each a TMA box of 64 rows x
// 128 bytes in the 128-byte swizzle, 1024-byte aligned.
template <int D>
constexpr uint32_t tile_bytes() {
  return (D / 64) * PANEL;
}

// shared memory of the dq kernel (byte offsets from a 1024-aligned base):
// q and dO of the block's CONSUMERS tiles, then per stage a k and a v tile
template <int D>
struct DqSmem {
  static constexpr uint32_t T = tile_bytes<D>();
  static constexpr uint32_t Q = 0;
  static constexpr uint32_t DO = CONSUMERS * T;
  static constexpr uint32_t KV = 2 * CONSUMERS * T;  // stage s: k at +2sT, v at +(2s+1)T
  // as many stages as fit, up to 8
  static constexpr int STAGES = (SMEM_MAX - 2048 - KV) / (2 * T) < 8
                                    ? (SMEM_MAX - 2048 - KV) / (2 * T)
                                    : 8;
  static constexpr uint32_t BARS = KV + STAGES * 2 * T;  // q, full[STAGES], empty[STAGES]
  static constexpr size_t bytes = BARS + 8 * (1 + 2 * STAGES) + 1024;  // + alignment
};

// shared memory of the dk/dv kernel: k and v of the block's CONSUMERS tiles,
// then per stage a q and a dO tile and the tile's lse (x log2 e) and delta
template <int D>
struct DkvSmem {
  static constexpr uint32_t T = tile_bytes<D>();
  static constexpr uint32_t K = 0;
  static constexpr uint32_t V = CONSUMERS * T;
  static constexpr uint32_t STAGE0 = 2 * CONSUMERS * T;
  static constexpr uint32_t STAGE = 2 * T + 1024;  // q, dO, lse[64], delta[64]
  static constexpr int STAGES = (SMEM_MAX - 2048 - STAGE0) / STAGE < 8
                                    ? (SMEM_MAX - 2048 - STAGE0) / STAGE
                                    : 8;
  static constexpr uint32_t BARS = STAGE0 + STAGES * STAGE;  // kv, full, empty
  static constexpr size_t bytes = BARS + 8 * (1 + 2 * STAGES) + 1024;
};

// The A operands, in bf16, of a 64 x 64 score-shaped f32 accumulator c
// (c[4n + 2i + j] = row g + 8i, column 8n + 2t + j) for the four k-steps of
// a product over its columns (step kk: columns 16kk..16kk+15). Built before
// any product starts, so the f32 tile's registers are free while the
// products run.
struct Frags {
  uint32_t a[4][4];
};

__device__ __forceinline__ void to_frags(Frags& f, const float (&c)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      f.a[kk][r] = pack_bf16(c[8 * kk + 2 * r], c[8 * kk + 2 * r + 1]);
}

// acc (64 x D) += the score-shaped tile held as `f` times the 64-row tile
// at `b` (MN-major: its rows are K)
template <int D>
__device__ __forceinline__ void mma_frags(float (&acc)[D / 2], const Frags& f,
                                          uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, f.a[kk], mnmajor_desc(b, kk));
}

// c (64 x 64) = the 64-row tile at `a` times the 64-row tile at `b`
// transposed, both K-major over D columns
template <int D>
__device__ __forceinline__ void mma_rows(float (&c)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(c, kmajor_desc(a, kk), kmajor_desc(b, kk), kk > 0);
}


// dq: block i = (q tile p.tiles[i / (B * N)], b * N + h = i % (B * N)), so
// blocks launch in the plan's order; consumer c owns rows q0 + 64c and
// skips kv tiles its rows do not see.
template <int D, bool DROP>
__global__ void __launch_bounds__(WG_THREADS, 1)
    flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo, const Params p) {
  using SM = DqSmem<D>;
  constexpr uint32_t T = SM::T;
  constexpr int STAGES = SM::STAGES;
  extern __shared__ uint8_t dsmem[];
  const uint32_t raw = smem_addr(dsmem);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bar_q = base + SM::BARS;
  const uint32_t bar_full = bar_q + 8;                // + 8s
  const uint32_t bar_empty = bar_full + 8 * STAGES;  // + 8s

  const int n_bh = p.B * p.N;
  const int t = blockIdx.x / n_bh;
  const int bn = blockIdx.x - t * n_bh;
  const int b = bn / p.N;
  const int h = bn - b * p.N;
  const int kvh = h / (p.N / p.Nkv);
  const int q0 = p.tiles[t] * BLOCK_ROWS;
  const int kv_tiles = (kv_end_rows(p, q0, BLOCK_ROWS) + TR - 1) / TR;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMERS * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the thread's role, warp-uniform (read from lane 0) so the compiler
  // sees two regions
  const int tx = threadIdx.x;
  const int role = __shfl_sync(0xffffffffu, tx / WG - 1, 0);
  if (role < 0) {  // producer
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_arrive_tx(bar_q, 2 * CONSUMERS * T);
      for (int c = 0; c < CONSUMERS; ++c) {
        tma_tile<D>(base + SM::Q + c * T, &tq, bar_q, h, q0 + c * TR, b);
        tma_tile<D>(base + SM::DO + c * T, &tdo, bar_q, h, q0 + c * TR, b);
      }
#pragma unroll 1  // one tile at a time
      for (int it = 0; it < kv_tiles; ++it) {
        const int s = it % STAGES;
        mbar_wait_or_trap(bar_empty + 8 * s, ((it / STAGES) & 1) ^ 1);
        mbar_arrive_tx(bar_full + 8 * s, 2 * T);
        const uint32_t kt = base + SM::KV + 2 * s * T;
        tma_tile<D>(kt, &tk, bar_full + 8 * s, kvh, it * TR, b);
        tma_tile<D>(kt + T, &tv, bar_full + 8 * s, kvh, it * TR, b);
      }
      drain<STAGES>(bar_empty, kv_tiles);
    }
    return;
  }

  // consumer c: rows q0 + 64c + wr + g + 8i of this thread (i = 0, 1)
  regs_inc<CONSUMER_REGS>();
  const int c = role;
  const int tid = tx % WG;
  const int wr = (tid / 32) * 16;
  const int g = (tid % 32) / 4;
  const int t4 = tid % 4;
  const int qc = q0 + c * TR;
  const int offset = p.Skv - p.Sq;
  const float scale2 = p.scale * LOG2E;
  const int kv_end = kv_end_rows(p, qc, TR);

  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = qc + wr + g + 8 * i;
    const bool in = row < p.Sq;
    lse2[i] = in ? p.lse[static_cast<long long>(bn) * p.Sq + row] * LOG2E : 0.f;
    dl[i] = in ? p.delta[static_cast<long long>(bn) * p.Sq + row] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  const uint32_t qs = base + SM::Q + c * T;
  const uint32_t dos = base + SM::DO + c * T;
  mbar_wait(bar_q, 0);
#pragma unroll 1  // one tile at a time
  for (int it = 0; it < kv_tiles; ++it) {
    const int s = it % STAGES;
    const int kv0 = it * TR;
    const uint32_t ks = base + SM::KV + 2 * s * T;
    mbar_wait(bar_full + 8 * s, (it / STAGES) & 1);
    if (kv0 < kv_end) {
      // s = q k^T and dp = dO v^T, two groups: p is recomputed while dp's
      // products still run. sc[4nt + 2i + j] is row qc + wr + g + 8i,
      // column kv0 + 8nt + 2t + j; a tile every row of this warp sees whole
      // skips the per-element mask (decided before the products: see the
      // dk/dv kernel). With dropout, dp is keep * dp / (1 - rate) (the
      // forward's mask, philox.cuh), its bits drawn while the products run.
      const bool whole = kv0 + TR <= p.Skv &&
                         (!p.causal || kv0 + TR - 1 <= qc + wr + offset);
      float sc[32], dp[32];
      wgmma_fence();
      mma_rows<D>(sc, qs, ks);
      wgmma_commit();
      mma_rows<D>(dp, dos, ks + T);
      wgmma_commit();
      uint32_t kb = 0;
      if (DROP)
        kb = dropout::keep_bits_rows(p.seed, bn, qc + wr + g, kv0 + 2 * t4,
                                     p.threshold);
      wgmma_wait<1>();
      hold(sc);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int e = nt * 4 + 2 * i + j;
            const int row = qc + wr + g + 8 * i;
            const int col = kv0 + nt * 8 + t4 * 2 + j;
            sc[e] = (whole || visible(p, row, col))
                        ? exp2_approx(sc[e] * scale2 - lse2[i])
                        : 0.f;
          }
      wgmma_wait<0>();
      hold(dp);
      // ds = p * (dp - delta)
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        float dpv = dp[e];
        if (DROP) dpv = (kb >> e) & 1u ? dpv * p.drop_scale : 0.f;
        sc[e] *= dpv - dl[(e >> 1) & 1];
      }
      Frags fs;
      to_frags(fs, sc);
      wgmma_fence();
      mma_frags<D>(acc, fs, ks);  // dq += ds k
      wgmma_commit();
      wgmma_wait<0>();
      hold(acc);
    }
    mbar_arrive(bar_empty + 8 * s);
  }
  const long long qstride = static_cast<long long>(p.N) * D;
  __nv_bfloat16* dqg = static_cast<__nv_bfloat16*>(p.dq) +
                       (static_cast<long long>(b) * p.Sq * p.N + h) * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = qc + wr + g + 8 * i;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<uint32_t*>(dqg + row * qstride + dn * 8 + t4 * 2) =
          pack_bf16(acc[dn * 4 + 2 * i] * p.scale, acc[dn * 4 + 2 * i + 1] * p.scale);
  }
}

// dk/dv: block i = (kv tile p.tiles[i / per_tile], b * Nkv + kv head,
// split), per_tile = B * Nkv * splits, so blocks launch in the plan's order;
// the block loops over its group / splits q heads and, for each, over the
// 64-row q tiles from the first that sees the tile; consumer c owns kv rows
// kv0 + 64c and skips q tiles that see none of them. With splits > 1 it
// writes float32 partials (unscaled dv, scaled dk) for the wrapper to fold.
template <int D, bool DROP>
__global__ void __launch_bounds__(WG_THREADS, 1)
    flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo, const Params p) {
  using SM = DkvSmem<D>;
  constexpr uint32_t T = SM::T;
  constexpr int STAGES = SM::STAGES;
  extern __shared__ uint8_t dsmem[];
  const uint32_t raw = smem_addr(dsmem);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = dsmem + (base - raw);  // the same address, generic
  const uint32_t bar_kv = base + SM::BARS;
  const uint32_t bar_full = bar_kv + 8;
  const uint32_t bar_empty = bar_full + 8 * STAGES;

  const int per_tile = p.B * p.Nkv * p.splits;
  const int t = blockIdx.x / per_tile;
  const int rest = blockIdx.x - t * per_tile;
  const int bkv = rest / p.splits;
  const int split = rest - bkv * p.splits;
  const int b = bkv / p.Nkv;
  const int kvh = bkv - b * p.Nkv;
  const int group = p.N / p.Nkv;
  const int heads = group / p.splits;
  const int h0 = kvh * group + split * heads;
  const int kv0 = p.tiles[t] * BLOCK_ROWS;
  const int q_first = first_live_q(p, kv0);
  const int n_q = p.Sq > q_first ? (p.Sq - q_first + TR - 1) / TR : 0;
  const int iters = heads * n_q;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 32);  // the producer warp's lanes
      mbar_init(bar_empty + 8 * s, CONSUMERS * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int tx = threadIdx.x;
  const int role = __shfl_sync(0xffffffffu, tx / WG - 1, 0);
  if (role < 0) {  // producer: warp 0 (lane 0 starts the TMA loads)
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_arrive_tx(bar_kv, 2 * CONSUMERS * T);
        for (int c = 0; c < CONSUMERS; ++c) {
          tma_tile<D>(base + SM::K + c * T, &tk, bar_kv, kvh, kv0 + c * TR, b);
          tma_tile<D>(base + SM::V + c * T, &tv, bar_kv, kvh, kv0 + c * TR, b);
        }
      }
#pragma unroll 1  // one tile at a time
      for (int it = 0; it < iters; ++it) {
        const int s = it % STAGES;
        const int h = h0 + it / n_q;
        const int q0 = q_first + (it % n_q) * TR;
        const long long bn = static_cast<long long>(b) * p.N + h;
        const uint32_t st = base + SM::STAGE0 + s * SM::STAGE;
        float* lse_s = reinterpret_cast<float*>(gbase + SM::STAGE0 + s * SM::STAGE + 2 * T);
        mbar_wait_or_trap(bar_empty + 8 * s, ((it / STAGES) & 1) ^ 1);
        for (int r = lane; r < TR; r += 32) {
          const int row = q0 + r;
          const bool in = row < p.Sq;
          lse_s[r] = in ? p.lse[bn * p.Sq + row] * LOG2E : 0.f;
          lse_s[TR + r] = in ? p.delta[bn * p.Sq + row] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_tx(bar_full + 8 * s, 2 * T);
          tma_tile<D>(st, &tq, bar_full + 8 * s, h, q0, b);
          tma_tile<D>(st + T, &tdo, bar_full + 8 * s, h, q0, b);
        } else {
          mbar_arrive(bar_full + 8 * s);
        }
      }
      if (lane == 0) drain<STAGES>(bar_empty, iters);
    }
    return;
  }

  // consumer c: kv rows kvc + wr + g + 8i of this thread (i = 0, 1)
  regs_inc<CONSUMER_REGS>();
  const int c = role;
  const int tid = tx % WG;
  const int wr = (tid / 32) * 16;
  const int g = (tid % 32) / 4;
  const int t4 = tid % 4;
  const int kvc = kv0 + c * TR;
  const int q_live = kvc < p.Skv ? first_live_q(p, kvc) : p.Sq;
  const int offset = p.Skv - p.Sq;
  const float scale2 = p.scale * LOG2E;
  const uint32_t ks = base + SM::K + c * T;
  const uint32_t vs = base + SM::V + c * T;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(bar_kv, 0);
#pragma unroll 1  // one tile at a time
  for (int it = 0; it < iters; ++it) {
    const int s = it % STAGES;
    const int h = h0 + it / n_q;
    const int q0 = q_first + (it % n_q) * TR;
    const uint32_t qs = base + SM::STAGE0 + s * SM::STAGE;
    const float* lse_s =
        reinterpret_cast<const float*>(gbase + SM::STAGE0 + s * SM::STAGE + 2 * T);
    const float* dl_s = lse_s + TR;
    mbar_wait(bar_full + 8 * s, (it / STAGES) & 1);
    if (q0 >= q_live) {
      // s^T = k q^T and dp^T = v dO^T (kv rows x q columns), two groups;
      // st[4nt + 2i + j] is kv row kvc + wr + g + 8i, q row q0 + 8nt + 2t + j.
      // A tile every row of this warp sees whole skips the per-element
      // mask; that is decided before the products start (see the
      // header: a branch while they run serialised the kernel's wgmma).
      const bool whole = q0 + TR <= p.Sq && kvc + wr + 16 <= p.Skv &&
                         (!p.causal || kvc + wr + 15 <= q0 + offset);
      float st[32], dpt[32];
      wgmma_fence();
      mma_rows<D>(st, ks, qs);
      wgmma_commit();
      mma_rows<D>(dpt, vs, qs + T);
      wgmma_commit();
      // with dropout: this q head's mask in the transposed layout, drawn
      // while the products run
      uint32_t kb = 0;
      if (DROP)
        kb = dropout::keep_bits_cols(p.seed, static_cast<uint32_t>(b * p.N + h),
                                     q0 + 2 * t4, kvc + wr + g, p.threshold);
      wgmma_wait<1>();  // s^T is in: p while dp^T's products run
      hold(st);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int e = nt * 4 + 2 * i + j;
            const int r = nt * 8 + t4 * 2 + j;
            st[e] = (whole || visible(p, q0 + r, kvc + wr + g + 8 * i))
                        ? exp2_approx(st[e] * scale2 - lse_s[r])
                        : 0.f;
          }
      wgmma_wait<0>();
      hold(dpt);
      // ds = p * (dp - delta) with dp (and dv's p) keep * x / (1 - rate)
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int r = (e >> 2) * 8 + t4 * 2 + (e & 1);
        const float pv = st[e];
        float dpv = dpt[e];
        if (DROP) {
          const bool kp = (kb >> e) & 1u;
          st[e] = kp ? pv * p.drop_scale : 0.f;
          dpv = kp ? dpv * p.drop_scale : 0.f;
        }
        dpt[e] = pv * (dpv - dl_s[r]);
      }
      Frags fp, fs;
      to_frags(fp, st);
      to_frags(fs, dpt);
      wgmma_fence();
      mma_frags<D>(dv, fp, qs + T);  // dv += (keep p / (1 - rate))^T dO
      mma_frags<D>(dk, fs, qs);      // dk += ds^T q
      wgmma_commit();
      wgmma_wait<0>();
      hold(dk);
      hold(dv);
    }
    mbar_arrive(bar_empty + 8 * s);
  }
  const long long kstride = static_cast<long long>(p.Nkv) * D;
  const long long head0 = (static_cast<long long>(b) * p.Skv * p.Nkv + kvh) * D;
  const long long part0 = static_cast<long long>(split) * p.B * p.Skv * kstride;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = kvc + wr + g + 8 * i;
    if (row >= p.Skv) continue;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const int e = dn * 4 + 2 * i;
      const long long at = head0 + row * kstride + dn * 8 + t4 * 2;
      if (p.splits == 1) {
        *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(p.dk) + at) =
            pack_bf16(dk[e] * p.scale, dk[e + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(p.dv) + at) =
            pack_bf16(dv[e], dv[e + 1]);
      } else {
        *reinterpret_cast<float2*>(static_cast<float*>(p.dk) + part0 + at) =
            make_float2(dk[e] * p.scale, dk[e + 1] * p.scale);
        *reinterpret_cast<float2*>(static_cast<float*>(p.dv) + part0 + at) =
            make_float2(dv[e], dv[e + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem, bool& configured) {
  // the shared-memory attribute is set once per kernel instance
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  return 0;
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, bool& configured, dim3 grid, int threads,
           const Params& p, cudaStream_t stream) {
  if (const int e = set_smem(kernel, smem, configured)) return e;
  kernel<<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the wgmma kernels: tensor maps of q, k, v, dO, then one block per entry
// of the plan
template <typename Kernel>
int launch_wgmma(Kernel kernel, size_t smem, bool& configured, int blocks, int D,
                 const Params& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  if (!bsnh_map(&tq, p.q, p.B, p.Sq, p.N, D, TR) ||
      !bsnh_map(&tk, p.k, p.B, p.Skv, p.Nkv, D, TR) ||
      !bsnh_map(&tv, p.v, p.B, p.Skv, p.Nkv, D, TR) ||
      !bsnh_map(&tdo, p.dout, p.B, p.Sq, p.N, D, TR))
    return NO_TENSOR_MAP;
  if (const int e = set_smem(kernel, smem, configured)) return e;
  kernel<<<blocks, WG_THREADS, smem, stream>>>(tq, tk, tv, tdo, p);
  return static_cast<int>(cudaGetLastError());
}

// the float32 kernels: shared memory past 48 KB, with the carveout's
// maximum
template <typename Kernel>
int launch_tf32(Kernel kernel, size_t smem, bool& configured, int blocks, const Params& p,
                cudaStream_t s) {
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return launch(kernel, smem, configured, dim3(blocks), THREADS32, p, s);
}

// one block per 64-row q tile and (b, q head)
template <int D, bool DROP, int TKV = DqForm<D, DROP>::TKV, int RUN = DqForm<D, DROP>::RUN,
          int PASS = DqForm<D, DROP>::PASS>
int launch_dq_tf32(const Params& p, cudaStream_t s) {
  static bool configured = false;
  return launch_tf32(flash_bwd_dq_tf32<D, DROP, TKV, RUN, PASS>, DqTf32Smem<D, TKV>::bytes,
                     configured, (p.Sq + BQ - 1) / BQ * p.B * p.N, p, s);
}

// one block per entry of the plan
template <int D, bool DROP>
int launch_dkv_tf32(const Params& p, cudaStream_t s) {
  static bool configured = false;
  return launch_tf32(flash_bwd_dkv_tf32<D, DROP>, DkvTf32Smem<D>::bytes, configured,
                     (p.Skv + KV32 - 1) / KV32 * p.B * p.Nkv * p.splits, p, s);
}

template <int D, bool DROP>
int launch_dq_wgmma(const Params& p, cudaStream_t s) {
  static bool configured = false;
  const int blocks = (p.Sq + BLOCK_ROWS - 1) / BLOCK_ROWS * p.B * p.N;
  return launch_wgmma(flash_bwd_dq_wgmma<D, DROP>, DqSmem<D>::bytes,
                      configured, blocks, D, p, s);
}

template <int D, bool DROP>
int launch_dkv_wgmma(const Params& p, cudaStream_t s) {
  static bool configured = false;
  const int blocks =
      (p.Skv + BLOCK_ROWS - 1) / BLOCK_ROWS * p.B * p.Nkv * p.splits;
  return launch_wgmma(flash_bwd_dkv_wgmma<D, DROP>, DkvSmem<D>::bytes,
                      configured, blocks, D, p, s);
}

// float32 is built for D 16, 32, 64 and 128; bfloat16 (wgmma: whole
// 64-column panels) for 64 and 128 only
template <int D>
int launch_dq(int dtype, bool drop, const Params& p, cudaStream_t s) {
  if (dtype == 0)
    return drop ? launch_dq_tf32<D, true>(p, s) : launch_dq_tf32<D, false>(p, s);
  if constexpr (D % 64 == 0)
    return drop ? launch_dq_wgmma<D, true>(p, s) : launch_dq_wgmma<D, false>(p, s);
  return -1;
}

template <int D>
int launch_dkv(int dtype, bool drop, const Params& p, cudaStream_t s) {
  if (dtype == 0)
    return drop ? launch_dkv_tf32<D, true>(p, s) : launch_dkv_tf32<D, false>(p, s);
  if constexpr (D % 64 == 0)
    return drop ? launch_dkv_wgmma<D, true>(p, s) : launch_dkv_wgmma<D, false>(p, s);
  return -1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Every tensor contiguous with 16-byte
// aligned rows (the wrapper guarantees it). dropout != 0 redraws the
// forward's mask from (seed, threshold) and scales kept entries by
// drop_scale. `tiles`, device int32, lists the output tiles in launch
// order, each once: bf16's of BLOCK_ROWS rows (q tiles for dq, kv tiles
// for dk/dv), float32 dk/dv's of KV32 rows; float32 dq ignores it (its
// blocks launch heaviest first by their index).
// flash_bwd_dkv with splits > 1 splits each kv head's q heads over that
// many blocks and writes float32 partials (splits, B, Skv, Nkv, D) to dk,
// dv for the caller to sum; splits must divide N / Nkv. Each returns 0 on success, the CUDA
// error code of a refused launch, -1 for a (dtype, head_dim) pair this
// library was not built for, or -2 when no tensor map could be made. The
// caller launches only with B, N, Sq and Skv all positive.
extern "C" int flash_bwd_dq(int dtype, int head_dim, const void* q,
                            const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, void* dq,
                            int B, int N, int Nkv, int Sq, int Skv, float scale,
                            int causal, int dropout, unsigned long long seed,
                            unsigned int threshold, float drop_scale,
                            const int* tiles, void* stream) {
  const Params p{q,     k,       v, dout, lse,   delta,  dq,
                 nullptr, nullptr, B, N,    Nkv,   Sq,     Skv,
                 scale, causal,  seed, threshold, drop_scale, 1, tiles};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return -1;
  switch (head_dim) {
    case 16: return launch_dq<16>(dtype, dropout != 0, p, s);
    case 32: return launch_dq<32>(dtype, dropout != 0, p, s);
    case 64: return launch_dq<64>(dtype, dropout != 0, p, s);
    case 128: return launch_dq<128>(dtype, dropout != 0, p, s);
    default: return -1;
  }
}

extern "C" int flash_bwd_dkv(int dtype, int head_dim, const void* q,
                             const void* k, const void* v, const void* dout,
                             const float* lse, const float* delta, void* dk,
                             void* dv, int B, int N, int Nkv, int Sq, int Skv,
                             float scale, int causal, int dropout,
                             unsigned long long seed, unsigned int threshold,
                             float drop_scale, int splits, const int* tiles,
                             void* stream) {
  const Params p{q,     k,      v,    dout,      lse,        delta,  nullptr,
                 dk,    dv,     B,    N,         Nkv,        Sq,     Skv,
                 scale, causal, seed, threshold, drop_scale, splits, tiles};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return -1;
  if (splits < 1 || (N / Nkv) % splits != 0)
    return -1;
  switch (head_dim) {
    case 16: return launch_dkv<16>(dtype, dropout != 0, p, s);
    case 32: return launch_dkv<32>(dtype, dropout != 0, p, s);
    case 64: return launch_dkv<64>(dtype, dropout != 0, p, s);
    case 128: return launch_dkv<128>(dtype, dropout != 0, p, s);
    default: return -1;
  }
}
