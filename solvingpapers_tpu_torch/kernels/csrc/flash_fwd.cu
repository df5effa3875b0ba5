// Flash-attention forward for Hopper (sm_90a), CUDA C++ with a plain C
// interface (built by kernels/build.py with nvcc, bound with ctypes in
// kernels/flash_attention.py).
//
// Replaces the Pallas TPU kernel solvingpapers_tpu/kernels/flash_attention.py
// `_fwd_kernel` (launched by `_fwd`) minus its in-kernel dropout: online-
// softmax attention over BSNH tensors that never writes the (Sq, Skv) score
// matrix to device memory, returning o (input dtype) and the per-row
// log-sum-exp (float32).
//
// Semantics, exactly those of the TPU kernel:
//   * causal or bidirectional; the causal mask is END-aligned,
//     offset = Skv - Sq: query row r sees kv columns c <= r + offset;
//   * offset < 0 leaves the first rows with no visible key: such rows get
//     o = 0 and lse = 0 (masked probabilities are zeroed, not exp(0));
//   * GQA: q head h reads kv head h / (N / Nkv), kv is never repeated;
//   * scores, softmax state, the PV accumulator and the final division
//     are float32 (the float32 kernel scales q before QK^T as the TPU
//     kernel does; the bf16 kernel scales the float32 scores, the same
//     value up to rounding, and runs the softmax in base 2).
//
// Design (simple kernels; wgmma/TMA and warp specialisation come later).
// Common to both dtypes:
//   * one thread block per (b*N + h, 64-row q tile);
//   * an in-block loop over 64-column kv tiles, stopping at the last tile
//     any row of the q tile can see (the causal skip) — this loop takes
//     the place of the TPU grid's sequential kv axis;
//   * the row's online-softmax state (max, sum) and its output
//     accumulator stay in registers, in float32;
//   * ragged Sq / Skv are masked: rows past Sq are computed and not
//     stored, columns past Skv get probability 0 (and zeroed V rows).
// bfloat16 (the serving path), `flash_fwd_mma`: 4 warps, 16 q rows each;
// Q, K and V^T tiles in shared memory as bf16; QK^T and PV on the tensor
// cores with mma.sync m16n8k16 (bf16 in, f32 accumulate). The score
// accumulator's register layout is the A operand layout of the PV
// product, so P never leaves registers. P is split into a bf16 high part
// and a bf16 remainder (two PV products), so PV sees ~16 bits of P and
// the result stays as close to the float32 reference as the CUDA-core
// kernel was; QK^T is exact products of bf16 inputs summed in f32.
// float32, `flash_fwd_fma`: 256 threads, Q, K, V and P tiles in shared
// memory as f32, each thread a 4x4 block of the score tile; both products
// as f32 FMAs on the CUDA cores, so f32 stays exact to ~1e-6.
// What bounds it: at the serving shapes (Sq, Skv in the thousands, D 64)
// the work is ~4*D operations per visible (row, column) pair against
// 2*D bytes per kv row, i.e. compute-bound at the tensor-core peak. The
// bf16 kernel moves tiles with plain 16-byte loads through registers
// into shared memory (the next tile's loads overlap this tile's
// products; no TMA), runs mma.sync rather than wgmma, and its f32
// softmax costs more instructions than its products, so it stays well
// below that bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // kv columns per tile
constexpr int THREADS = 256;  // fma kernel: 16 row groups x 16 column lanes
constexpr int MMA_THREADS = 128;  // mma kernel: 4 warps x 16 q rows
constexpr float BIG_NEG = -1073741824.0f;  // -2**30, the reference's fill
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int B, N, Nkv, Sq, Skv;
  long long sq_b, sq_s, sq_h;  // element strides of q (B, Sq, N, D)
  long long sk_b, sk_s, sk_h;  // ... of k (B, Skv, Nkv, D)
  long long sv_b, sv_s, sv_h;  // ... of v (B, Skv, Nkv, D)
  float scale;
  int causal;
};

// Row pitches (in floats) chosen so the two row groups a warp spans land
// in different shared-memory banks, and K's column reads are conflict-free.
template <int D>
struct Tile {
  static constexpr int QP = D + 4;
  static constexpr int KP = D + 1;
  static constexpr int VP = D;
  static constexpr int PP = BK + 4;
  static constexpr size_t smem_bytes =
      sizeof(float) * (BQ * QP + BK * KP + BK * VP + BQ * PP);
};

// ---------------------------------------------------------------------------
// float32 on the CUDA cores

template <int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_fma(Params p) {
  using TL = Tile<D>;
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * TL::QP;
  float* Vs = Ks + BK * TL::KP;
  float* Ps = Vs + BK * TL::VP;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bn = blockIdx.y;
  const int b = bn / p.N;
  const int h = bn - b * p.N;
  const int kvh = h / (p.N / p.Nkv);
  const int q0 = blockIdx.x * BQ;
  const int offset = p.Skv - p.Sq;

  const float* qg = static_cast<const float*>(p.q) + b * p.sq_b + h * p.sq_h;
  const float* kg = static_cast<const float*>(p.k) + b * p.sk_b + kvh * p.sk_h;
  const float* vg = static_cast<const float*>(p.v) + b * p.sv_b + kvh * p.sv_h;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D;
    const int d = i - r * D;
    const int row = q0 + r;
    float x = 0.f;
    if (row < p.Sq) x = qg[row * p.sq_s + d] * p.scale;
    Qs[r * TL::QP + d] = x;
  }

  // last kv column any row of this tile can see (exclusive bound)
  int kv_end = p.Skv;
  if (p.causal) {
    const int last_row = min(q0 + BQ, p.Sq) - 1;
    kv_end = min(p.Skv, last_row + offset + 1);
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = BIG_NEG;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) acc[i][jj] = 0.f;
  }

  for (int kv0 = 0; kv0 < kv_end; kv0 += BK) {
    for (int i = tid; i < BK * D; i += THREADS) {
      const int c = i / D;
      const int d = i - c * D;
      const int col = kv0 + c;
      float kx = 0.f, vx = 0.f;
      if (col < p.Skv) {
        kx = kg[col * p.sk_s + d];
        vx = vg[col * p.sv_s + d];
      }
      Ks[c * TL::KP + d] = kx;
      Vs[c * TL::VP + d] = vx;
    }
    __syncthreads();  // (the first pass also publishes Qs)

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty * 4 + i) * TL::QP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Ks[(tx + 16 * j) * TL::KP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      bool vis[4];
      float rmax = BIG_NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kv0 + tx + 16 * j;
        vis[j] = col < p.Skv && (!p.causal || col <= row + offset);
        if (!vis[j]) s[i][j] = BIG_NEG;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, o));
      const float m_new = fmaxf(m[i], rmax);
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // a masked probability is 0, never exp(BIG_NEG - m_new): a row
        // that has seen no visible key keeps l == 0 (the empty-row guard)
        const float pv = vis[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty * 4 + i) * TL::PP + tx + 16 * j] = pv;
        rsum += pv;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, o);
      l[i] = alpha * l[i] + rsum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pr[4], vr[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = Ps[(ty * 4 + i) * TL::PP + c];
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) vr[jj] = Vs[c * TL::VP + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < DC; ++jj)
          acc[i][jj] = fmaf(pr[i], vr[jj], acc[i][jj]);
    }
    __syncthreads();  // before the next tile overwrites Ks, Vs, Ps
  }

  float* og = static_cast<float*>(p.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.Sq) continue;
    const bool empty = !(l[i] > 0.f);
    // o is allocated contiguous (B, Sq, N, D)
    float* orow = og + ((static_cast<long long>(b) * p.Sq + row) * p.N + h) * D;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj)
      orow[tx + 16 * jj] = empty ? 0.f : acc[i][jj] / l[i];
    if (tx == 0)
      p.lse[static_cast<long long>(bn) * p.Sq + row] =
          empty ? 0.f : m[i] + logf(l[i]);
  }
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores

// mma.sync m16n8k16, row.col, bf16 x bf16 -> f32, accumulating into c.
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

// the bf16 remainder x - bf16(x), for the low half of a split P
__device__ __forceinline__ float bf16_rest(float x) {
  return x - __bfloat162float(__float2bfloat16_rn(x));
}

template <int D>
struct MmaTile {
  // row pitches in bf16: +8 puts the 8 rows a fragment load touches in
  // distinct banks (a pitch of 4*odd words)
  static constexpr int QP = D + 8;
  static constexpr int KP = D + 8;
  static constexpr int VP = BK + 8;  // V is stored transposed: (D, BK)
  static constexpr size_t smem_bytes =
      sizeof(__nv_bfloat16) * (BQ * QP + BK * KP + D * VP);
};

template <int D>
__global__ void __launch_bounds__(MMA_THREADS) flash_fwd_mma(Params p) {
  using TL = MmaTile<D>;
  constexpr int KD = D / 16;  // k-steps of QK^T
  constexpr int NS = BK / 8;  // score n-tiles per kv tile
  constexpr int NO = D / 8;   // output n-tiles
  constexpr int CH = BQ * D / 8 / MMA_THREADS;  // 16-byte chunks per thread
  static_assert(BQ == BK, "one chunk count serves the Q and K/V tiles");
  extern __shared__ __align__(16) __nv_bfloat16 msmem[];
  __nv_bfloat16* Qs = msmem;
  __nv_bfloat16* Ks = Qs + BQ * TL::QP;
  __nv_bfloat16* Vt = Ks + BK * TL::KP;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row (and B column) group
  const int t = lane & 3;   // thread in the group
  const int bn = blockIdx.y;
  const int b = bn / p.N;
  const int h = bn - b * p.N;
  const int kvh = h / (p.N / p.Nkv);
  const int q0 = blockIdx.x * BQ;
  const int offset = p.Skv - p.Sq;
  const float scale2 = p.scale * LOG2E;

  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.sq_b + h * p.sq_h;
  const __nv_bfloat16* kg =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.sk_b + kvh * p.sk_h;
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.sv_b + kvh * p.sv_h;

  // Q tile: 16-byte chunks of 8 bf16 (the wrapper guarantees 16-byte
  // aligned rows), zero past Sq
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int c = tid + i * MMA_THREADS;
    const int r = c / (D / 8);
    const int d = (c - r * (D / 8)) * 8;
    const int row = q0 + r;
    *reinterpret_cast<uint4*>(Qs + r * TL::QP + d) =
        row < p.Sq ? *reinterpret_cast<const uint4*>(qg + row * p.sq_s + d)
                   : make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  // this warp's 16 q rows as A fragments, kept in registers
  const int wr = warp * 16;
  uint32_t qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const __nv_bfloat16* q_lo = Qs + (wr + g) * TL::QP + kk * 16 + t * 2;
    const __nv_bfloat16* q_hi = q_lo + 8 * TL::QP;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(q_lo);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(q_hi);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(q_lo + 8);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(q_hi + 8);
  }

  int kv_end = p.Skv;
  if (p.causal) {
    const int last_row = min(q0 + BQ, p.Sq) - 1;
    kv_end = min(p.Skv, last_row + offset + 1);
  }

  // rows owned by this thread: wr + g (i = 0) and wr + g + 8 (i = 1)
  float m[2] = {BIG_NEG, BIG_NEG};
  float l[2] = {0.f, 0.f};
  float o[NO][4];
#pragma unroll
  for (int dn = 0; dn < NO; ++dn)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[dn][j] = 0.f;

  // K and V tiles move as 16-byte chunks through registers: the next
  // tile's loads are issued before this tile's products, so their
  // latency hides behind the compute. Columns past Skv load as zeros.
  uint4 kbuf[CH], vbuf[CH];
  auto load_kv = [&](int kv0) {
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int c = tid + i * MMA_THREADS;
      const int r = c / (D / 8);
      const int d = (c - r * (D / 8)) * 8;
      const int col = kv0 + r;
      const bool in = col < p.Skv;
      kbuf[i] = in ? *reinterpret_cast<const uint4*>(kg + col * p.sk_s + d)
                   : make_uint4(0, 0, 0, 0);
      vbuf[i] = in ? *reinterpret_cast<const uint4*>(vg + col * p.sv_s + d)
                   : make_uint4(0, 0, 0, 0);
    }
  };
  if (kv_end > 0) load_kv(0);

  for (int kv0 = 0; kv0 < kv_end; kv0 += BK) {
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int c = tid + i * MMA_THREADS;
      const int r = c / (D / 8);
      const int d = (c - r * (D / 8)) * 8;
      *reinterpret_cast<uint4*>(Ks + r * TL::KP + d) = kbuf[i];
      const __nv_bfloat16* v8 = reinterpret_cast<const __nv_bfloat16*>(&vbuf[i]);
#pragma unroll
      for (int e = 0; e < 8; ++e) Vt[(d + e) * TL::VP + r] = v8[e];
    }
    __syncthreads();
    if (kv0 + BK < kv_end) load_kv(kv0 + BK);

    float s[NS][4];
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[nt][j] = 0.f;
      const __nv_bfloat16* kr = Ks + (nt * 8 + g) * TL::KP + t * 2;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        mma_bf16(s[nt], qa[kk],
                 *reinterpret_cast<const uint32_t*>(kr + kk * 16),
                 *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8));
    }

    // online softmax in base 2 (scores times scale * log2(e), m in the
    // same units); s[nt][2*i + j] is row wr + g + 8*i, column
    // kv0 + nt*8 + t*2 + j. A tile every row of this warp sees whole
    // skips the per-element mask.
    const bool whole =
        kv0 + BK <= p.Skv && (!p.causal || kv0 + BK - 1 <= q0 + wr + offset);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + wr + g + 8 * i;
      if (whole) {
#pragma unroll
        for (int nt = 0; nt < NS; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) s[nt][2 * i + j] *= scale2;
      } else {
#pragma unroll
        for (int nt = 0; nt < NS; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int col = kv0 + nt * 8 + t * 2 + j;
            const bool vis = col < p.Skv && (!p.causal || col <= row + offset);
            float& x = s[nt][2 * i + j];
            x = vis ? x * scale2 : BIG_NEG;
          }
      }
      float rmax = BIG_NEG;
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
        rmax = fmaxf(rmax, fmaxf(s[nt][2 * i], s[nt][2 * i + 1]));
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 1));
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 2));
      const float m_new = fmaxf(m[i], rmax);
      const float alpha = exp2f(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          // a masked probability is 0, never 2^(BIG_NEG - m_new): a row
          // that has seen no visible key keeps l == 0 (the empty-row guard)
          float& x = s[nt][2 * i + j];
          x = x > 0.5f * BIG_NEG ? exp2f(x - m_new) : 0.f;
          rsum += x;
        }
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 2);
      l[i] = alpha * l[i] + rsum;
      m[i] = m_new;
#pragma unroll
      for (int dn = 0; dn < NO; ++dn) {
        o[dn][2 * i] *= alpha;
        o[dn][2 * i + 1] *= alpha;
      }
    }

    // PV: the score accumulators of n-tiles 2kk and 2kk+1 are the A
    // fragment of k-step kk; P = hi + lo, both bf16
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const float* s0 = s[2 * kk];
      const float* s1 = s[2 * kk + 1];
      const uint32_t ph[4] = {pack_bf16(s0[0], s0[1]), pack_bf16(s0[2], s0[3]),
                              pack_bf16(s1[0], s1[1]), pack_bf16(s1[2], s1[3])};
      const uint32_t pl[4] = {
          pack_bf16(bf16_rest(s0[0]), bf16_rest(s0[1])),
          pack_bf16(bf16_rest(s0[2]), bf16_rest(s0[3])),
          pack_bf16(bf16_rest(s1[0]), bf16_rest(s1[1])),
          pack_bf16(bf16_rest(s1[2]), bf16_rest(s1[3]))};
#pragma unroll
      for (int dn = 0; dn < NO; ++dn) {
        const __nv_bfloat16* vr = Vt + (dn * 8 + g) * TL::VP + kk * 16 + t * 2;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(vr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(vr + 8);
        mma_bf16(o[dn], ph, b0, b1);
        mma_bf16(o[dn], pl, b0, b1);
      }
    }
    __syncthreads();  // before the next tile overwrites Ks and Vt
  }

  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wr + g + 8 * i;
    if (row >= p.Sq) continue;
    const bool empty = !(l[i] > 0.f);
    const float inv = empty ? 0.f : 1.f / l[i];
    // o is allocated contiguous (B, Sq, N, D)
    __nv_bfloat16* orow =
        og + ((static_cast<long long>(b) * p.Sq + row) * p.N + h) * D;
#pragma unroll
    for (int dn = 0; dn < NO; ++dn)
      *reinterpret_cast<uint32_t*>(orow + dn * 8 + t * 2) =
          pack_bf16(o[dn][2 * i] * inv, o[dn][2 * i + 1] * inv);
    if (t == 0)
      p.lse[static_cast<long long>(bn) * p.Sq + row] =
          empty ? 0.f : m[i] * LN2 + logf(l[i]);
  }
}

// ---------------------------------------------------------------------------
// launch

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem, bool& configured) {
  // the attribute is set once per kernel instance
  if (configured) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  configured = true;
  return 0;
}

template <int D>
int launch_fma(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = Tile<D>::smem_bytes;
  static bool configured = false;
  if (const int e = set_smem(flash_fwd_fma<D>, smem, configured)) return e;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.B * p.N);
  flash_fwd_fma<D><<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_mma(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = MmaTile<D>::smem_bytes;
  static bool configured = false;
  if (const int e = set_smem(flash_fwd_mma<D>, smem, configured)) return e;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.B * p.N);
  flash_fwd_mma<D><<<grid, MMA_THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns 0 on success, the CUDA error
// code of a refused launch, or -1 for a (dtype, head_dim) pair this
// library was not built for.
extern "C" int flash_fwd(int dtype, int head_dim, const void* q,
                         const void* k, const void* v, void* o, float* lse,
                         int B, int N, int Nkv, int Sq, int Skv,
                         long long sq_b, long long sq_s, long long sq_h,
                         long long sk_b, long long sk_s, long long sk_h,
                         long long sv_b, long long sv_s, long long sv_h,
                         float scale, int causal, void* stream) {
  Params p{q,    k,    v,    o,    lse,  B,    N,    Nkv,   Sq,
           Skv,  sq_b, sq_s, sq_h, sk_b, sk_s, sk_h, sv_b,  sv_s,
           sv_h, scale, causal};
  if (Sq == 0 || B * N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64) return launch_fma<64>(p, s);
  if (dtype == 0 && head_dim == 128) return launch_fma<128>(p, s);
  if (dtype == 1 && head_dim == 64) return launch_mma<64>(p, s);
  if (dtype == 1 && head_dim == 128) return launch_mma<128>(p, s);
  return -1;
}
