// The float32 flash kernels as they were before their redesign for
// Hopper (`flash_fwd_fma`, `flash_bwd_dkv_fma` and `flash_bwd_dq_fma`,
// copied unchanged from kernels/csrc/flash_fwd.cu and flash_bwd.cu): f32
// FMAs on the CUDA cores, each thread a 4x4 block of the score tile, K and
// V tiles copied element by element through registers. `chip_smoke.py`
// builds this file beside the port's kernels (`build_probe`, kernels/csrc
// on the include path) and times it in turns with the 3xTF32 kernels that
// replaced it, at the same shapes and through the same C signatures as
// the port's `flash_fwd`, `flash_bwd_dkv` and `flash_bwd_dq` (float32
// only: dtype 0, splits 1, tiles ignored).

#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace fwd {

constexpr int BQ = 64;        // fma kernel: q rows per block
constexpr int BK = 64;        // fma kernel: kv columns per tile
constexpr int THREADS = 256;  // fma kernel: 16 row groups x 16 column lanes
constexpr float BIG_NEG = -1073741824.0f;  // -2**30, the reference's fill
constexpr float LOG2E = 1.4426950408889634f;

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
  unsigned long long seed;  // dropout: Philox key
  uint32_t threshold;       // dropout: keep iff word < threshold
  float drop_scale;         // dropout: 1 / (1 - rate)
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

template <int D, bool DROP>
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
        rsum += pv;
        float pu = pv;  // what the PV product takes
        if (DROP)
          pu = dropout::keep(p.seed, bn, row, kv0 + tx + 16 * j, p.threshold)
                   ? pv * p.drop_scale
                   : 0.f;
        Ps[(ty * 4 + i) * TL::PP + tx + 16 * j] = pu;
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

template <int D, bool DROP>
int launch_fma(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = Tile<D>::smem_bytes;
  static bool configured = false;
  if (const int e = set_smem(flash_fwd_fma<D, DROP>, smem, configured)) return e;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.B * p.N);
  flash_fwd_fma<D, DROP><<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fwd

namespace bwd {

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

template <int D, bool DROP>
int launch_dkv_fma(const Params& p, cudaStream_t s) {
  static bool configured = false;
  return launch(flash_bwd_dkv_fma<D, DROP>, DkvFma<D>::smem_bytes, configured,
                dim3((p.Skv + BK - 1) / BK, p.B * p.Nkv), THREADS, p, s);
}

template <int D, bool DROP>
int launch_dq_fma(const Params& p, cudaStream_t s) {
  static bool configured = false;
  return launch(flash_bwd_dq_fma<D, DROP>, DqFma<D>::smem_bytes, configured,
                dim3((p.Sq + BQ - 1) / BQ, p.B * p.N), THREADS, p, s);
}

}  // namespace bwd

extern "C" int flash_fwd_fma_first(int dtype, int head_dim, const void* q,
                                   const void* k, const void* v, void* o, float* lse,
                                   int B, int N, int Nkv, int Sq, int Skv,
                                   long long sq_b, long long sq_s, long long sq_h,
                                   long long sk_b, long long sk_s, long long sk_h,
                                   long long sv_b, long long sv_s, long long sv_h,
                                   float scale, int causal, int dropout,
                                   unsigned long long seed, unsigned int threshold,
                                   float drop_scale, void* stream) {
  const fwd::Params p{q,    k,    v,    o,    lse,  B,    N,     Nkv,    Sq,
                      Skv,  sq_b, sq_s, sq_h, sk_b, sk_s, sk_h,  sv_b,   sv_s,
                      sv_h, scale, causal, seed, threshold, drop_scale};
  if (Sq == 0 || B * N == 0) return 0;
  if (dtype != 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool drop = dropout != 0;
  switch (head_dim) {
    case 16: return drop ? fwd::launch_fma<16, true>(p, s) : fwd::launch_fma<16, false>(p, s);
    case 32: return drop ? fwd::launch_fma<32, true>(p, s) : fwd::launch_fma<32, false>(p, s);
    case 64: return drop ? fwd::launch_fma<64, true>(p, s) : fwd::launch_fma<64, false>(p, s);
    case 128: return drop ? fwd::launch_fma<128, true>(p, s) : fwd::launch_fma<128, false>(p, s);
    default: return -1;
  }
}

extern "C" int flash_bwd_dkv_fma_first(int dtype, int head_dim, const void* q,
                                       const void* k, const void* v, const void* dout,
                                       const float* lse, const float* delta, void* dk,
                                       void* dv, int B, int N, int Nkv, int Sq, int Skv,
                                       float scale, int causal, int dropout,
                                       unsigned long long seed, unsigned int threshold,
                                       float drop_scale, int splits, const int* tiles,
                                       void* stream) {
  const bwd::Params p{q,     k,      v,    dout,      lse,        delta,  nullptr,
                      dk,    dv,     B,    N,         Nkv,        Sq,     Skv,
                      scale, causal, seed, threshold, drop_scale, splits, tiles};
  if (dtype != 0 || splits != 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool drop = dropout != 0;
  switch (head_dim) {
    case 16: return drop ? bwd::launch_dkv_fma<16, true>(p, s) : bwd::launch_dkv_fma<16, false>(p, s);
    case 32: return drop ? bwd::launch_dkv_fma<32, true>(p, s) : bwd::launch_dkv_fma<32, false>(p, s);
    case 64: return drop ? bwd::launch_dkv_fma<64, true>(p, s) : bwd::launch_dkv_fma<64, false>(p, s);
    case 128: return drop ? bwd::launch_dkv_fma<128, true>(p, s) : bwd::launch_dkv_fma<128, false>(p, s);
    default: return -1;
  }
}

extern "C" int flash_bwd_dq_fma_first(int dtype, int head_dim, const void* q,
                                      const void* k, const void* v, const void* dout,
                                      const float* lse, const float* delta, void* dq,
                                      int B, int N, int Nkv, int Sq, int Skv, float scale,
                                      int causal, int dropout, unsigned long long seed,
                                      unsigned int threshold, float drop_scale,
                                      const int* tiles, void* stream) {
  const bwd::Params p{q,     k,       v, dout, lse,   delta,  dq,
                      nullptr, nullptr, B, N,    Nkv,   Sq,     Skv,
                      scale, causal,  seed, threshold, drop_scale, 1, tiles};
  if (dtype != 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool drop = dropout != 0;
  switch (head_dim) {
    case 16: return drop ? bwd::launch_dq_fma<16, true>(p, s) : bwd::launch_dq_fma<16, false>(p, s);
    case 32: return drop ? bwd::launch_dq_fma<32, true>(p, s) : bwd::launch_dq_fma<32, false>(p, s);
    case 64: return drop ? bwd::launch_dq_fma<64, true>(p, s) : bwd::launch_dq_fma<64, false>(p, s);
    case 128: return drop ? bwd::launch_dq_fma<128, true>(p, s) : bwd::launch_dq_fma<128, false>(p, s);
    default: return -1;
  }
}
