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
// float32 (the parity path and the small float32 configs), `*_fma` at D 16,
// 32, 64 and 128: 256 threads, each a 4x4 block of the score tile and D / 16
// output columns; all products as f32 FMAs on the CUDA cores, exact to
// ~1e-6. Their row pitches (D + 4, D + 1) keep shared-memory reads
// conflict-free at every D, as in flash_fwd.cu.
// What bounds them: at the training shapes dq does 3 and dk/dv 4 products
// of 2*D operations per visible (row, column) pair against O(D) bytes per
// row, so both are compute-bound at the tensor-core peak; PERF.md keeps
// their measured times beside that bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"
#include "philox.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 64;            // fma kernels: q rows per tile
constexpr int BK = 64;            // fma kernels: kv rows per tile
constexpr int THREADS = 256;      // fma kernels: 16 row groups x 16 lanes
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
  int splits;               // bf16 dk/dv: blocks per (b, kv head, kv tile)
  const int* tiles;         // bf16: output tiles (BLOCK_ROWS rows) in launch order
};

// first q row at or after which query rows can see kv column `col`, rounded
// down to a 64-row q tile (0 when every row sees it)
__device__ __forceinline__ int first_live_q(const Params& p, int col) {
  if (!p.causal) return 0;
  const int r = col - (p.Skv - p.Sq);
  return r <= 0 ? 0 : (r / BQ) * BQ;
}

// one past the last kv column any row of the q tile starting at q0 sees
__device__ __forceinline__ int kv_end_for(const Params& p, int q0) {
  if (!p.causal) return p.Skv;
  const int last_row = min(q0 + BQ, p.Sq) - 1;
  return max(0, min(p.Skv, last_row + (p.Skv - p.Sq) + 1));
}

__device__ __forceinline__ bool visible(const Params& p, int row, int col) {
  return row < p.Sq && col < p.Skv &&
         (!p.causal || col <= row + (p.Skv - p.Sq));
}

// ---------------------------------------------------------------------------
// float32 on the CUDA cores

template <int D>
struct DqFma {
  static constexpr int QP = D + 4;  // q (scaled) and dO rows
  static constexpr int KP = D + 1;  // k and v rows: column reads conflict-free
  static constexpr int SP = BK + 4;  // ds rows
  static constexpr size_t smem_bytes =
      sizeof(float) * (2 * BQ * QP + 2 * BK * KP + BQ * SP);
};

template <int D, bool DROP>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_fma(Params p) {
  using TL = DqFma<D>;
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * TL::QP;
  float* Ks = dOs + BQ * TL::QP;
  float* Vs = Ks + BK * TL::KP;
  float* dS = Vs + BK * TL::KP;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bn = blockIdx.y;
  const int b = bn / p.N;
  const int h = bn - b * p.N;
  const int kvh = h / (p.N / p.Nkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tiles first
  const long long qstride = static_cast<long long>(p.N) * D;
  const long long kstride = static_cast<long long>(p.Nkv) * D;

  const float* qg =
      static_cast<const float*>(p.q) + (static_cast<long long>(b) * p.Sq * p.N + h) * D;
  const float* dog =
      static_cast<const float*>(p.dout) + (static_cast<long long>(b) * p.Sq * p.N + h) * D;
  const float* kg = static_cast<const float*>(p.k) +
                    (static_cast<long long>(b) * p.Skv * p.Nkv + kvh) * D;
  const float* vg = static_cast<const float*>(p.v) +
                    (static_cast<long long>(b) * p.Skv * p.Nkv + kvh) * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D;
    const int d = i - r * D;
    const int row = q0 + r;
    const bool in = row < p.Sq;
    Qs[r * TL::QP + d] = in ? qg[row * qstride + d] * p.scale : 0.f;
    dOs[r * TL::QP + d] = in ? dog[row * qstride + d] : 0.f;
  }
  float lse[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const bool in = row < p.Sq;
    lse[i] = in ? p.lse[static_cast<long long>(bn) * p.Sq + row] : 0.f;
    dl[i] = in ? p.delta[static_cast<long long>(bn) * p.Sq + row] : 0.f;
  }

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) acc[i][jj] = 0.f;

  const int kv_end = kv_end_for(p, q0);
  for (int kv0 = 0; kv0 < kv_end; kv0 += BK) {
    for (int i = tid; i < BK * D; i += THREADS) {
      const int c = i / D;
      const int d = i - c * D;
      const int col = kv0 + c;
      const bool in = col < p.Skv;
      Ks[c * TL::KP + d] = in ? kg[col * kstride + d] : 0.f;
      Vs[c * TL::KP + d] = in ? vg[col * kstride + d] : 0.f;
    }
    __syncthreads();  // (the first pass also publishes Qs, dOs)

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], da[4], kb[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = Qs[(ty * 4 + i) * TL::QP + d];
        da[i] = dOs[(ty * 4 + i) * TL::QP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kb[j] = Ks[(tx + 16 * j) * TL::KP + d];
        vb[j] = Vs[(tx + 16 * j) * TL::KP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
          dp[i][j] = fmaf(da[i], vb[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = q0 + ty * 4 + i;
        const int col = kv0 + tx + 16 * j;
        const float pv = visible(p, row, col) ? expf(s[i][j] - lse[i]) : 0.f;
        float dpv = dp[i][j];
        if (DROP)
          dpv = dropout::keep(p.seed, bn, row, col, p.threshold)
                    ? dpv * p.drop_scale
                    : 0.f;
        dS[(ty * 4 + i) * TL::SP + tx + 16 * j] = pv * (dpv - dl[i]);
      }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float dsr[4], kr[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsr[i] = dS[(ty * 4 + i) * TL::SP + c];
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) kr[jj] = Ks[c * TL::KP + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < DC; ++jj)
          acc[i][jj] = fmaf(dsr[i], kr[jj], acc[i][jj]);
    }
    __syncthreads();  // before the next tile overwrites Ks, Vs, dS
  }

  float* dqg = static_cast<float*>(p.dq) + (static_cast<long long>(b) * p.Sq * p.N + h) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj)
      dqg[row * qstride + tx + 16 * jj] = acc[i][jj] * p.scale;
  }
}

template <int D>
struct DkvFma {
  static constexpr int RP = D + 1;   // k, v, q (scaled), dO rows
  static constexpr int PP = BQ + 4;  // p^T and ds^T rows: (BK, BQ)
  static constexpr size_t smem_bytes =
      sizeof(float) * (2 * BK * RP + 2 * BQ * RP + 2 * BK * PP + 2 * BQ);
};

template <int D, bool DROP>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_fma(Params p) {
  using TL = DkvFma<D>;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * TL::RP;
  float* Qs = Vs + BK * TL::RP;
  float* dOs = Qs + BQ * TL::RP;
  float* Pt = dOs + BQ * TL::RP;
  float* dSt = Pt + BK * TL::PP;
  float* lse_s = dSt + BK * TL::PP;
  float* dl_s = lse_s + BQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // q columns tx + 16j
  const int ty = tid >> 4;  // kv rows ty*4 + i
  const int bkv = blockIdx.y;
  const int b = bkv / p.Nkv;
  const int kvh = bkv - b * p.Nkv;
  const int group = p.N / p.Nkv;
  const int kv0 = blockIdx.x * BK;
  const long long qstride = static_cast<long long>(p.N) * D;
  const long long kstride = static_cast<long long>(p.Nkv) * D;

  const float* kg = static_cast<const float*>(p.k) +
                    (static_cast<long long>(b) * p.Skv * p.Nkv + kvh) * D;
  const float* vg = static_cast<const float*>(p.v) +
                    (static_cast<long long>(b) * p.Skv * p.Nkv + kvh) * D;
  for (int i = tid; i < BK * D; i += THREADS) {
    const int c = i / D;
    const int d = i - c * D;
    const int col = kv0 + c;
    const bool in = col < p.Skv;
    Ks[c * TL::RP + d] = in ? kg[col * kstride + d] : 0.f;
    Vs[c * TL::RP + d] = in ? vg[col * kstride + d] : 0.f;
  }

  float dk[4][DC], dv[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) dk[i][jj] = dv[i][jj] = 0.f;

  const int q_first = first_live_q(p, kv0);
  for (int gi = 0; gi < group; ++gi) {
    const int h = kvh * group + gi;
    const long long bn = static_cast<long long>(b) * p.N + h;
    const float* qg = static_cast<const float*>(p.q) +
                      (static_cast<long long>(b) * p.Sq * p.N + h) * D;
    const float* dog = static_cast<const float*>(p.dout) +
                       (static_cast<long long>(b) * p.Sq * p.N + h) * D;
    for (int q0 = q_first; q0 < p.Sq; q0 += BQ) {
      __syncthreads();  // the previous tile's readers are done
      for (int i = tid; i < BQ * D; i += THREADS) {
        const int r = i / D;
        const int d = i - r * D;
        const int row = q0 + r;
        const bool in = row < p.Sq;
        Qs[r * TL::RP + d] = in ? qg[row * qstride + d] * p.scale : 0.f;
        dOs[r * TL::RP + d] = in ? dog[row * qstride + d] : 0.f;
      }
      if (tid < BQ) {
        const int row = q0 + tid;
        const bool in = row < p.Sq;
        lse_s[tid] = in ? p.lse[bn * p.Sq + row] : 0.f;
        dl_s[tid] = in ? p.delta[bn * p.Sq + row] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        float ka[4], va[4], qb[4], db[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ka[i] = Ks[(ty * 4 + i) * TL::RP + d];
          va[i] = Vs[(ty * 4 + i) * TL::RP + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qb[j] = Qs[(tx + 16 * j) * TL::RP + d];
          db[j] = dOs[(tx + 16 * j) * TL::RP + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(ka[i], qb[j], s[i][j]);
            dp[i][j] = fmaf(va[i], db[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + 16 * j;
          const float pv = visible(p, q0 + r, kv0 + ty * 4 + i)
                               ? expf(s[i][j] - lse_s[r])
                               : 0.f;
          float pu = pv, dpv = dp[i][j];  // dv's p and ds's dp
          if (DROP) {
            const bool kp = dropout::keep(p.seed, static_cast<uint32_t>(bn),
                                          q0 + r, kv0 + ty * 4 + i,
                                          p.threshold);
            pu = kp ? pv * p.drop_scale : 0.f;
            dpv = kp ? dpv * p.drop_scale : 0.f;
          }
          Pt[(ty * 4 + i) * TL::PP + r] = pu;
          dSt[(ty * 4 + i) * TL::PP + r] = pv * (dpv - dl_s[r]);
        }
      __syncthreads();

#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float pr[4], sr[4], dob[DC], qb[DC];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pr[i] = Pt[(ty * 4 + i) * TL::PP + r];
          sr[i] = dSt[(ty * 4 + i) * TL::PP + r];
        }
#pragma unroll
        for (int jj = 0; jj < DC; ++jj) {
          dob[jj] = dOs[r * TL::RP + tx + 16 * jj];
          qb[jj] = Qs[r * TL::RP + tx + 16 * jj];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < DC; ++jj) {
            dv[i][jj] = fmaf(pr[i], dob[jj], dv[i][jj]);
            dk[i][jj] = fmaf(sr[i], qb[jj], dk[i][jj]);  // q is pre-scaled
          }
      }
    }
  }

  float* dkg = static_cast<float*>(p.dk) +
               (static_cast<long long>(b) * p.Skv * p.Nkv + kvh) * D;
  float* dvg = static_cast<float*>(p.dv) +
               (static_cast<long long>(b) * p.Skv * p.Nkv + kvh) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = kv0 + ty * 4 + i;
    if (col >= p.Skv) continue;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) {
      dkg[col * kstride + tx + 16 * jj] = dk[i][jj];
      dvg[col * kstride + tx + 16 * jj] = dv[i][jj];
    }
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

// one past the last kv column any of rows [r0, r0 + n) (clipped to Sq) can
// see; 0 when the range holds no row
__device__ __forceinline__ int kv_end_rows(const Params& p, int r0, int n) {
  if (r0 >= p.Sq) return 0;
  if (!p.causal) return p.Skv;
  const int last = min(r0 + n, p.Sq) - 1;
  return max(0, min(p.Skv, last + (p.Skv - p.Sq) + 1));
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

template <int D, bool DROP>
int launch_dq_fma(const Params& p, cudaStream_t s) {
  static bool configured = false;
  return launch(flash_bwd_dq_fma<D, DROP>, DqFma<D>::smem_bytes, configured,
                dim3((p.Sq + BQ - 1) / BQ, p.B * p.N), THREADS, p, s);
}

template <int D, bool DROP>
int launch_dkv_fma(const Params& p, cudaStream_t s) {
  static bool configured = false;
  return launch(flash_bwd_dkv_fma<D, DROP>, DkvFma<D>::smem_bytes, configured,
                dim3((p.Skv + BK - 1) / BK, p.B * p.Nkv), THREADS, p, s);
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
    return drop ? launch_dq_fma<D, true>(p, s) : launch_dq_fma<D, false>(p, s);
  if constexpr (D % 64 == 0)
    return drop ? launch_dq_wgmma<D, true>(p, s) : launch_dq_wgmma<D, false>(p, s);
  return -1;
}

template <int D>
int launch_dkv(int dtype, bool drop, const Params& p, cudaStream_t s) {
  if (dtype == 0)
    return drop ? launch_dkv_fma<D, true>(p, s) : launch_dkv_fma<D, false>(p, s);
  if constexpr (D % 64 == 0)
    return drop ? launch_dkv_wgmma<D, true>(p, s) : launch_dkv_wgmma<D, false>(p, s);
  return -1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Every tensor contiguous with 16-byte
// aligned rows (the wrapper guarantees it). dropout != 0 redraws the
// forward's mask from (seed, threshold) and scales kept entries by
// drop_scale. bf16 takes `tiles`, device int32: the output tiles of
// BLOCK_ROWS rows (q tiles for dq, kv tiles for dk/dv) in launch order,
// each once; float32 ignores it. flash_bwd_dkv with splits > 1 (bf16)
// splits each kv head's q heads over that many blocks and writes float32
// partials (splits, B, Skv, Nkv, D) to dk, dv for the caller to sum; splits
// must divide N / Nkv, and float32 takes 1. Each returns 0 on success, the CUDA
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
  if (splits < 1 || (N / Nkv) % splits != 0 || (dtype == 0 && splits != 1))
    return -1;
  switch (head_dim) {
    case 16: return launch_dkv<16>(dtype, dropout != 0, p, s);
    case 32: return launch_dkv<32>(dtype, dropout != 0, p, s);
    case 64: return launch_dkv<64>(dtype, dropout != 0, p, s);
    case 128: return launch_dkv<128>(dtype, dropout != 0, p, s);
    default: return -1;
  }
}
