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
//   * GQA: q head h reads kv head h / (N / Nkv). The dq kernel reads kv
//     without repeating it; the dk/dv kernel folds the repeat INSIDE the
//     block — it loops over the `group` q heads of its kv head and sums
//     their contributions in a fixed order — so nothing is repeated in
//     device memory, no atomics are needed, and the result is
//     deterministic.
//
// Design (simple kernels; wgmma/TMA and warp specialisation come later).
// Both kernels keep their output tile in float32 registers and loop inside
// the block over the other sequence axis (the loop replaces the TPU grid's
// sequential axis), skipping tiles the causal mask hides entirely:
//   dq  — one block per (b*N + h, 64-row q tile), looping over kv tiles up
//         to the last one its rows can see; tiles are issued heaviest
//         first (the last q tiles see the most kv);
//   dkv — one block per (b*Nkv + kv head, 64-row kv tile), looping over the
//         group's q heads and, for each, over q tiles from the first one
//         that sees the kv tile.
// Ragged Sq / Skv are masked, not padded: rows and columns past the end
// load as zeros, get probability 0 and are never stored.
// bfloat16 (the training path), `*_mma`: 4 warps of 16 output rows; tiles
// in shared memory as bf16, row-major and (where a product needs it as its
// B operand along the other axis) transposed; every product on the tensor
// cores with mma.sync m16n8k16 (bf16 in, f32 accumulate). The score-shaped
// accumulators (s, dp) are C fragments whose register layout is the A
// operand layout of the next product, so p and ds never leave registers.
// p and ds are split into a bf16 high part and a bf16 remainder (two
// products each), so those products see ~16 bits of them, as the forward
// does for P; q, k, v and dO are bf16 already, so their products are exact
// products summed in f32.
// float32, `*_fma`: 256 threads, each a 4x4 block of the score tile; all
// products as f32 FMAs on the CUDA cores, exact to ~1e-6.
// What bounds them: at the training shape (Sq = Skv = 8192, D 64, causal)
// dq does 3 and dk/dv 4 products of 2*D operations per visible (row,
// column) pair against O(D) bytes per row, so both are compute-bound at the
// tensor-core peak. Tiles move with plain 16-byte loads through registers
// (no TMA, no prefetch), the transposed tiles are written element by
// element, and the f32 softmax recompute costs more instructions than the
// products, so the kernels stay well below that bound; PERF.md keeps their
// measured times beside it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int BQ = 64;            // q rows per tile
constexpr int BK = 64;            // kv rows per tile
constexpr int THREADS = 256;      // fma kernels: 16 row groups x 16 lanes
constexpr int MMA_THREADS = 128;  // mma kernels: 4 warps x 16 rows
constexpr float LOG2E = 1.4426950408889634f;

// All tensors contiguous: q, dO, dq (B, Sq, N, D); k, v, dk, dv
// (B, Skv, Nkv, D); lse, delta (B*N, Sq).
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
};

// first q row at or after which query rows can see kv column `col`, rounded
// down to a q tile (0 when every row sees it)
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
// bfloat16 on the tensor cores

// mma.sync m16n8k16, row.col, bf16 x bf16 -> f32, accumulating into c.
// Fragments (g = lane / 4, t = lane % 4): A a0 (g, 2t..2t+1), a1 (g+8, ..),
// a2 (g, 2t+8..2t+9), a3 (g+8, ..); B b0 (k 2t..2t+1, n g), b1 (k 2t+8..,
// n g); C c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1).
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16 (the first in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the bf16 remainder x - bf16(x)
__device__ __forceinline__ float bf16_rest(float x) {
  return x - __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* x) {
  return *reinterpret_cast<const uint32_t*>(x);
}

// A fragment of k-step kk from a row-major bf16 tile (16 rows from `rows`,
// pitch `pitch`)
__device__ __forceinline__ void load_a(uint32_t a[4], const __nv_bfloat16* rows,
                                       int pitch, int kk, int g, int t) {
  const __nv_bfloat16* lo = rows + g * pitch + kk * 16 + t * 2;
  const __nv_bfloat16* hi = lo + 8 * pitch;
  a[0] = ld32(lo);
  a[1] = ld32(hi);
  a[2] = ld32(lo + 8);
  a[3] = ld32(hi + 8);
}

// x (in) += the product of a 16 x 64 score-shaped operand held as the C
// fragments c[0..7] (columns 8n..8n+7 in c[n]) with a (64, 8*NO) B operand
// stored transposed as bt (8*NO rows of 64, pitch `pitch`): the operand is
// split into bf16 high and low parts, two products each. With DROP the
// operand is keep * c * drop_scale, keep = bit n * 4 + e of `keep` for
// c[n][e] (dropout applied as the fragments are packed: no extra registers).
template <int NO, bool DROP>
__device__ __forceinline__ void mma_scores(float acc[NO][4], const float c[8][4],
                                           const __nv_bfloat16* bt, int pitch,
                                           int g, int t, uint32_t keep = 0,
                                           float drop_scale = 1.f) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    float c0[4], c1[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      c0[e] = c[2 * kk][e];
      c1[e] = c[2 * kk + 1][e];
      if (DROP) {
        c0[e] = (keep >> (8 * kk + e)) & 1u ? c0[e] * drop_scale : 0.f;
        c1[e] = (keep >> (8 * kk + 4 + e)) & 1u ? c1[e] * drop_scale : 0.f;
      }
    }
    const uint32_t hi[4] = {pack_bf16(c0[0], c0[1]), pack_bf16(c0[2], c0[3]),
                            pack_bf16(c1[0], c1[1]), pack_bf16(c1[2], c1[3])};
    const uint32_t lo[4] = {
        pack_bf16(bf16_rest(c0[0]), bf16_rest(c0[1])),
        pack_bf16(bf16_rest(c0[2]), bf16_rest(c0[3])),
        pack_bf16(bf16_rest(c1[0]), bf16_rest(c1[1])),
        pack_bf16(bf16_rest(c1[2]), bf16_rest(c1[3]))};
#pragma unroll
    for (int dn = 0; dn < NO; ++dn) {
      const __nv_bfloat16* br = bt + (dn * 8 + g) * pitch + kk * 16 + t * 2;
      const uint32_t b0 = ld32(br);
      const uint32_t b1 = ld32(br + 8);
      mma_bf16(acc[dn], hi, b0, b1);
      mma_bf16(acc[dn], lo, b0, b1);
    }
  }
}

// c[n] = A (16 x D, as KD fragments read from `arows`) times the 8 rows
// 8n..8n+7 of the row-major tile `brows` (the B operand, (64, D)), for the
// 8 n-tiles of a 64-wide score tile
template <int D>
__device__ __forceinline__ void mma_rows(float c[8][4], const __nv_bfloat16* arows,
                                         const __nv_bfloat16* brows, int pitch,
                                         int g, int t) {
  constexpr int KD = D / 16;
  uint32_t a[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) load_a(a[kk], arows, pitch, kk, g, t);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int j = 0; j < 4; ++j) c[nt][j] = 0.f;
    const __nv_bfloat16* br = brows + (nt * 8 + g) * pitch + t * 2;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      mma_bf16(c[nt], a[kk], ld32(br + kk * 16), ld32(br + kk * 16 + 8));
  }
}

// a 64-row tile of a contiguous (rows of `stride` elements) bf16 tensor into
// shared memory as 16-byte chunks, rows past `n_rows` as zeros; with `tr`,
// also its transpose (D, 64) at pitch `tpitch`
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int pitch,
                                          __nv_bfloat16* tr, int tpitch,
                                          const __nv_bfloat16* src,
                                          long long stride, int row0, int n_rows,
                                          int tid) {
  constexpr int CH = 64 * D / 8 / MMA_THREADS;  // 16-byte chunks per thread
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int c = tid + i * MMA_THREADS;
    const int r = c / (D / 8);
    const int d = (c - r * (D / 8)) * 8;
    const int row = row0 + r;
    const uint4 x = row < n_rows
                        ? *reinterpret_cast<const uint4*>(src + row * stride + d)
                        : make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(dst + r * pitch + d) = x;
    if (tr != nullptr) {
      const __nv_bfloat16* x8 = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
      for (int e = 0; e < 8; ++e) tr[(d + e) * tpitch + r] = x8[e];
    }
  }
}

template <int D>
struct DqMma {
  // row pitches in bf16: +8 puts the 8 rows a fragment load touches in
  // distinct banks (a pitch of 4 * odd words)
  static constexpr int RP = D + 8;   // q, dO, k, v: (64, D)
  static constexpr int TP = BK + 8;  // k^T: (D, 64)
  static constexpr size_t smem_bytes =
      sizeof(__nv_bfloat16) * (4 * 64 * RP + D * TP);
};

template <int D, bool DROP>
__global__ void __launch_bounds__(MMA_THREADS) flash_bwd_dq_mma(Params p) {
  using TL = DqMma<D>;
  constexpr int KD = D / 16;
  constexpr int NO = D / 8;  // output n-tiles
  extern __shared__ __align__(16) __nv_bfloat16 msmem[];
  __nv_bfloat16* Qs = msmem;
  __nv_bfloat16* dOs = Qs + BQ * TL::RP;
  __nv_bfloat16* Ks = dOs + BQ * TL::RP;
  __nv_bfloat16* Vs = Ks + BK * TL::RP;
  __nv_bfloat16* Kt = Vs + BK * TL::RP;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bn = blockIdx.y;
  const int b = bn / p.N;
  const int h = bn - b * p.N;
  const int kvh = h / (p.N / p.Nkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tiles first
  const int offset = p.Skv - p.Sq;
  const float scale2 = p.scale * LOG2E;
  const long long qstride = static_cast<long long>(p.N) * D;
  const long long kstride = static_cast<long long>(p.Nkv) * D;

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) +
                            (static_cast<long long>(b) * p.Sq * p.N + h) * D;
  const __nv_bfloat16* dog = static_cast<const __nv_bfloat16*>(p.dout) +
                             (static_cast<long long>(b) * p.Sq * p.N + h) * D;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) +
                            (static_cast<long long>(b) * p.Skv * p.Nkv + kvh) * D;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) +
                            (static_cast<long long>(b) * p.Skv * p.Nkv + kvh) * D;

  load_tile<D>(Qs, TL::RP, nullptr, 0, qg, qstride, q0, p.Sq, tid);
  load_tile<D>(dOs, TL::RP, nullptr, 0, dog, qstride, q0, p.Sq, tid);
  __syncthreads();

  // this warp's 16 q rows of q and dO as A fragments, kept in registers
  const int wr = warp * 16;
  uint32_t qa[KD][4], da[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    load_a(qa[kk], Qs + wr * TL::RP, TL::RP, kk, g, t);
    load_a(da[kk], dOs + wr * TL::RP, TL::RP, kk, g, t);
  }
  // rows owned by this thread: wr + g (i = 0) and wr + g + 8 (i = 1)
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wr + g + 8 * i;
    const bool in = row < p.Sq;
    lse2[i] = in ? p.lse[static_cast<long long>(bn) * p.Sq + row] * LOG2E : 0.f;
    dl[i] = in ? p.delta[static_cast<long long>(bn) * p.Sq + row] : 0.f;
  }

  float acc[NO][4];
#pragma unroll
  for (int dn = 0; dn < NO; ++dn)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[dn][j] = 0.f;

  const int kv_end = kv_end_for(p, q0);
  for (int kv0 = 0; kv0 < kv_end; kv0 += BK) {
    load_tile<D>(Ks, TL::RP, Kt, TL::TP, kg, kstride, kv0, p.Skv, tid);
    load_tile<D>(Vs, TL::RP, nullptr, 0, vg, kstride, kv0, p.Skv, tid);
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[nt][j] = dp[nt][j] = 0.f;
      const __nv_bfloat16* kr = Ks + (nt * 8 + g) * TL::RP + t * 2;
      const __nv_bfloat16* vr = Vs + (nt * 8 + g) * TL::RP + t * 2;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        mma_bf16(s[nt], qa[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
        mma_bf16(dp[nt], da[kk], ld32(vr + kk * 16), ld32(vr + kk * 16 + 8));
      }
    }

    // ds = p * (dp - delta), p recomputed in base 2; s[nt][2i + j] is row
    // wr + g + 8i, column kv0 + 8nt + 2t + j. A tile every row of this
    // warp sees whole skips the per-element mask. With dropout, dp is
    // keep * dp / (1 - rate) (the forward's mask, philox.cuh).
    const bool whole =
        kv0 + BK <= p.Skv && (!p.causal || kv0 + BK - 1 <= q0 + wr + offset);
    uint32_t kb = 0;
    if (DROP)
      kb = dropout::keep_bits_rows(p.seed, bn, q0 + wr + g, kv0 + 2 * t,
                                   p.threshold);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int row = q0 + wr + g + 8 * i;
          const int col = kv0 + nt * 8 + t * 2 + j;
          float& x = s[nt][2 * i + j];
          const float pv = (whole || visible(p, row, col))
                               ? exp2f(x * scale2 - lse2[i])
                               : 0.f;
          float dpv = dp[nt][2 * i + j];
          if (DROP)
            dpv = (kb >> (nt * 4 + 2 * i + j)) & 1u ? dpv * p.drop_scale : 0.f;
          x = pv * (dpv - dl[i]);
        }

    mma_scores<NO, false>(acc, s, Kt, TL::TP, g, t);  // dq += ds k
    __syncthreads();  // before the next tile overwrites Ks, Vs, Kt
  }

  __nv_bfloat16* dqg = static_cast<__nv_bfloat16*>(p.dq) +
                       (static_cast<long long>(b) * p.Sq * p.N + h) * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wr + g + 8 * i;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int dn = 0; dn < NO; ++dn)
      *reinterpret_cast<uint32_t*>(dqg + row * qstride + dn * 8 + t * 2) =
          pack_bf16(acc[dn][2 * i] * p.scale, acc[dn][2 * i + 1] * p.scale);
  }
}

template <int D>
struct DkvMma {
  static constexpr int RP = D + 8;   // k, v, q, dO: (64, D)
  static constexpr int TP = BQ + 8;  // q^T, dO^T: (D, 64)
  static constexpr size_t smem_bytes =
      sizeof(__nv_bfloat16) * (4 * 64 * RP + 2 * D * TP) + sizeof(float) * 2 * BQ;
};

template <int D, bool DROP>
__global__ void __launch_bounds__(MMA_THREADS) flash_bwd_dkv_mma(Params p) {
  using TL = DkvMma<D>;
  constexpr int NO = D / 8;
  extern __shared__ __align__(16) __nv_bfloat16 msmem[];
  __nv_bfloat16* Ks = msmem;
  __nv_bfloat16* Vs = Ks + BK * TL::RP;
  __nv_bfloat16* Qs = Vs + BK * TL::RP;
  __nv_bfloat16* dOs = Qs + BQ * TL::RP;
  __nv_bfloat16* Qt = dOs + BQ * TL::RP;
  __nv_bfloat16* dOt = Qt + D * TL::TP;
  float* lse_s = reinterpret_cast<float*>(dOt + D * TL::TP);  // x log2(e)
  float* dl_s = lse_s + BQ;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bkv = blockIdx.y;
  const int b = bkv / p.Nkv;
  const int kvh = bkv - b * p.Nkv;
  const int group = p.N / p.Nkv;
  const int kv0 = blockIdx.x * BK;
  const int offset = p.Skv - p.Sq;
  const float scale2 = p.scale * LOG2E;
  const long long qstride = static_cast<long long>(p.N) * D;
  const long long kstride = static_cast<long long>(p.Nkv) * D;

  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) +
                            (static_cast<long long>(b) * p.Skv * p.Nkv + kvh) * D;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) +
                            (static_cast<long long>(b) * p.Skv * p.Nkv + kvh) * D;
  load_tile<D>(Ks, TL::RP, nullptr, 0, kg, kstride, kv0, p.Skv, tid);
  load_tile<D>(Vs, TL::RP, nullptr, 0, vg, kstride, kv0, p.Skv, tid);

  // this warp's 16 kv rows: kv0 + wr + g (i = 0) and + 8 (i = 1)
  const int wr = warp * 16;
  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int dn = 0; dn < NO; ++dn)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[dn][j] = dv[dn][j] = 0.f;

  const int q_first = first_live_q(p, kv0);
  for (int gi = 0; gi < group; ++gi) {
    const int h = kvh * group + gi;
    const long long bn = static_cast<long long>(b) * p.N + h;
    const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) +
                              (static_cast<long long>(b) * p.Sq * p.N + h) * D;
    const __nv_bfloat16* dog = static_cast<const __nv_bfloat16*>(p.dout) +
                               (static_cast<long long>(b) * p.Sq * p.N + h) * D;
    for (int q0 = q_first; q0 < p.Sq; q0 += BQ) {
      __syncthreads();  // the previous tile's readers are done
      load_tile<D>(Qs, TL::RP, Qt, TL::TP, qg, qstride, q0, p.Sq, tid);
      load_tile<D>(dOs, TL::RP, dOt, TL::TP, dog, qstride, q0, p.Sq, tid);
      if (tid < BQ) {
        const int row = q0 + tid;
        lse_s[tid] = row < p.Sq ? p.lse[bn * p.Sq + row] * LOG2E : 0.f;
      } else {
        const int row = q0 + tid - BQ;
        dl_s[tid - BQ] = row < p.Sq ? p.delta[bn * p.Sq + row] : 0.f;
      }
      __syncthreads();

      // s^T = k q^T (kv rows x q columns); element [nt][2i + j] is kv row
      // kv0 + wr + g + 8i, q row q0 + 8nt + 2t + j
      float s[8][4];
      mma_rows<D>(s, Ks + wr * TL::RP, Qs, TL::RP, g, t);
      const bool whole = q0 + BQ <= p.Sq && kv0 + wr + 16 <= p.Skv &&
                         (!p.causal || kv0 + wr + 15 <= q0 + offset);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int r = nt * 8 + t * 2 + j;
            float& x = s[nt][2 * i + j];
            x = (whole || visible(p, q0 + r, kv0 + wr + g + 8 * i))
                    ? exp2f(x * scale2 - lse_s[r])
                    : 0.f;
          }
      // with dropout: this q head's mask in the transposed layout
      uint32_t kb = 0;
      if (DROP)
        kb = dropout::keep_bits_cols(p.seed, static_cast<uint32_t>(bn),
                                     q0 + 2 * t, kv0 + wr + g, p.threshold);
      // dv += (keep p / (1 - rate))^T dO
      mma_scores<NO, DROP>(dv, s, dOt, TL::TP, g, t, kb, p.drop_scale);

      float dp[8][4];
      mma_rows<D>(dp, Vs + wr * TL::RP, dOs, TL::RP, g, t);  // dp^T = v dO^T
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float dpv = dp[nt][e];
          if (DROP)
            dpv = (kb >> (nt * 4 + e)) & 1u ? dpv * p.drop_scale : 0.f;
          dp[nt][e] = s[nt][e] * (dpv - dl_s[nt * 8 + t * 2 + (e & 1)]);
        }
      mma_scores<NO, false>(dk, dp, Qt, TL::TP, g, t);  // dk += ds^T q
    }
  }

  __nv_bfloat16* dkg = static_cast<__nv_bfloat16*>(p.dk) +
                       (static_cast<long long>(b) * p.Skv * p.Nkv + kvh) * D;
  __nv_bfloat16* dvg = static_cast<__nv_bfloat16*>(p.dv) +
                       (static_cast<long long>(b) * p.Skv * p.Nkv + kvh) * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int col = kv0 + wr + g + 8 * i;
    if (col >= p.Skv) continue;
#pragma unroll
    for (int dn = 0; dn < NO; ++dn) {
      *reinterpret_cast<uint32_t*>(dkg + col * kstride + dn * 8 + t * 2) =
          pack_bf16(dk[dn][2 * i] * p.scale, dk[dn][2 * i + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dvg + col * kstride + dn * 8 + t * 2) =
          pack_bf16(dv[dn][2 * i], dv[dn][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch

template <typename Kernel>
int launch(Kernel kernel, size_t smem, bool& configured, dim3 grid, int threads,
           const Params& p, cudaStream_t stream) {
  // the shared-memory attribute is set once per kernel instance
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  kernel<<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool DROP>
int launch_dq_t(int dtype, const Params& p, cudaStream_t s) {
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.B * p.N);
  if (dtype == 0) {
    static bool configured = false;
    return launch(flash_bwd_dq_fma<D, DROP>, DqFma<D>::smem_bytes, configured,
                  grid, THREADS, p, s);
  }
  static bool configured = false;
  return launch(flash_bwd_dq_mma<D, DROP>, DqMma<D>::smem_bytes, configured,
                grid, MMA_THREADS, p, s);
}

template <int D, bool DROP>
int launch_dkv_t(int dtype, const Params& p, cudaStream_t s) {
  const dim3 grid((p.Skv + BK - 1) / BK, p.B * p.Nkv);
  if (dtype == 0) {
    static bool configured = false;
    return launch(flash_bwd_dkv_fma<D, DROP>, DkvFma<D>::smem_bytes, configured,
                  grid, THREADS, p, s);
  }
  static bool configured = false;
  return launch(flash_bwd_dkv_mma<D, DROP>, DkvMma<D>::smem_bytes, configured,
                grid, MMA_THREADS, p, s);
}

template <int D>
int launch_dq(int dtype, bool drop, const Params& p, cudaStream_t s) {
  return drop ? launch_dq_t<D, true>(dtype, p, s)
              : launch_dq_t<D, false>(dtype, p, s);
}

template <int D>
int launch_dkv(int dtype, bool drop, const Params& p, cudaStream_t s) {
  return drop ? launch_dkv_t<D, true>(dtype, p, s)
              : launch_dkv_t<D, false>(dtype, p, s);
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, void* dk, void* dv, int B, int N, int Nkv, int Sq,
                   int Skv, float scale, int causal, unsigned long long seed,
                   unsigned int threshold, float drop_scale) {
  return Params{q,   k,     v,      dout, lse,  delta, dq,        dk,
                dv,  B,     N,      Nkv,  Sq,   Skv,   scale,     causal,
                seed, threshold, drop_scale};
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Every tensor contiguous (the wrapper
// guarantees it). dropout != 0 redraws the forward's mask from (seed,
// threshold) and scales kept entries by drop_scale. Each returns 0 on
// success, the CUDA error code of a refused launch, or -1 for a (dtype,
// head_dim) pair this library was not built for. The caller launches only
// with B, N, Sq and Skv all positive.
extern "C" int flash_bwd_dq(int dtype, int head_dim, const void* q,
                            const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, void* dq,
                            int B, int N, int Nkv, int Sq, int Skv, float scale,
                            int causal, int dropout, unsigned long long seed,
                            unsigned int threshold, float drop_scale,
                            void* stream) {
  const Params p = make_params(q, k, v, dout, lse, delta, dq, nullptr, nullptr,
                               B, N, Nkv, Sq, Skv, scale, causal, seed,
                               threshold, drop_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((dtype != 0 && dtype != 1)) return -1;
  if (head_dim == 64) return launch_dq<64>(dtype, dropout != 0, p, s);
  if (head_dim == 128) return launch_dq<128>(dtype, dropout != 0, p, s);
  return -1;
}

extern "C" int flash_bwd_dkv(int dtype, int head_dim, const void* q,
                             const void* k, const void* v, const void* dout,
                             const float* lse, const float* delta, void* dk,
                             void* dv, int B, int N, int Nkv, int Sq, int Skv,
                             float scale, int causal, int dropout,
                             unsigned long long seed, unsigned int threshold,
                             float drop_scale, void* stream) {
  const Params p = make_params(q, k, v, dout, lse, delta, nullptr, dk, dv, B, N,
                               Nkv, Sq, Skv, scale, causal, seed, threshold,
                               drop_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((dtype != 0 && dtype != 1)) return -1;
  if (head_dim == 64) return launch_dkv<64>(dtype, dropout != 0, p, s);
  if (head_dim == 128) return launch_dkv<128>(dtype, dropout != 0, p, s);
  return -1;
}
