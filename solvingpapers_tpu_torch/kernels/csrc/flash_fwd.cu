// Flash-attention forward for Hopper (sm_90a), CUDA C++ with a plain C
// interface (built by kernels/build.py with nvcc, bound with ctypes in
// kernels/flash_attention.py).
//
// Replaces the Pallas TPU kernel solvingpapers_tpu/kernels/flash_attention.py
// `_fwd_kernel` (launched by `_fwd`, pallas_call at line 271) with its
// in-kernel dropout: online-softmax attention over BSNH tensors that never
// writes the (Sq, Skv) score matrix to device memory, returning o (input
// dtype) and the per-row log-sum-exp (float32).
//
// Semantics, exactly those of the TPU kernel:
//   * causal or bidirectional; the causal mask is END-aligned,
//     offset = Skv - Sq: query row r sees kv columns c <= r + offset;
//   * offset < 0 leaves the first rows with no visible key: such rows get
//     o = 0 and lse = 0 (a masked probability is 0, never exp(BIG_NEG - m));
//   * GQA: q head h reads kv head h / (N / Nkv), kv is never repeated;
//   * ragged Sq / Skv are masked, not padded;
//   * attention-prob dropout at rate > 0: the row sum l takes the
//     UNdropped probabilities (lse is of the undropped mass), the PV
//     product takes keep * p / (1 - rate), with keep the philox.cuh mask of
//     (seed, b * N + h, row, col) — the one the backward kernels redraw;
//     rate 0 compiles the kernels without any of it (template DROP);
//   * scores, softmax state, the PV accumulator and the final division
//     are float32.
//
// What bounds it on an H100: per visible (row, column) pair the two
// products take 4 * D operations against O(D) bytes per row, so at the
// serving and training shapes (sequences in the thousands) the kernel is
// compute-bound at the bf16 tensor-core rate (989 TFLOP/s, about 4096
// operations a clock an SM). At D 64 the softmax weighs as much: each pair
// needs one ex2 on the SFU (16 a clock an SM), 1/16 clock, the same as
// its 256 tensor operations. A kernel that runs the softmax after its
// products reaches at most half the tensor rate there.
//
// bfloat16 (every training and serving call), `flash_fwd_wgmma<D, DROP>`:
//   * A block is one producer warpgroup and two consumer warpgroups; each
//     consumer owns 64 q rows (the wgmma M) of one (b, q head), so a block
//     covers 128 q rows. setmaxnreg moves registers from the producer (24)
//     to the consumers (240). Blocks launch heaviest first: block i takes
//     q tile (tiles - 1 - i / (B * N)), so under the causal mask the tiles
//     that see the most keys start first and the grid's tail is light.
//   * One producer thread loads the block's q tiles once, then keeps k and
//     v tiles of BKV = 128 rows in flight: TMA (cp.async.bulk.tensor) in
//     the 128-byte swizzle into a ring of stages on mbarriers, rows past
//     Skv zero-filled. Tiles of 128 kv rows make the score product
//     m64n128 (half the issue overhead of n64 per operation) and keep
//     S (64 floats a thread) + P (32 registers of bf16) + O (D / 2 floats)
//     within 240 registers at D 128 without spills. Stages: as many as the
//     227 KB of shared memory hold after the q tiles, up to 8 (32 KB each
//     at D 64: 6; 64 KB at D 128: 3); k_j and v_j share a stage, released
//     when P_j V_j is done, so two stages are held and the rest prefetch.
//     The tensor maps take each tensor's own strides and Skv as the row
//     extent, so a sequence slice of the serving cache is read in place.
//   * S = Q K^T runs as wgmma m64n128k16 with both operands K-major from
//     shared memory; the softmax runs in base 2 on the float32 accumulator
//     (ex2.approx). It masks only tiles a row does not see whole, with
//     -inf where the TPU kernel fills BIG_NEG: the probability is 0 either
//     way, and 2^-inf needs no select per element, which the softmax-bound
//     D 64 kernel pays for. P goes to bf16 once, as the register A operand
//     of O += P V, whose V tile wgmma reads in its MN-major (transpose) mode
//     straight from the tile TMA wrote. No transposed copy of V exists.
//     With dropout P V also takes P's bf16 remainder (see to_frags_split):
//     one more product a tile, under the Philox work's time.
//   * The softmax overlaps the products two ways. Within a consumer, the
//     loop issues S_j = Q K_j^T and O += P_{j-1} V_{j-1} together, then
//     runs tile j's softmax while P_{j-1} V_{j-1} is still in the tensor
//     cores (FlashAttention-3's two-stage pipeline); O is rescaled by
//     tile j's factor once that product is done. Between consumers, two
//     named barriers make them take turns issuing their products, so one
//     consumer's softmax runs while the other's products do. With dropout
//     (P and its remainder, below) a consumer runs S_j, the softmax and
//     P_j V_j in order and draws tile j+1's Philox bits after P_j V_j,
//     while the other consumer's products run: the pipeline's registers
//     (S, P twice, O), or Philox beside a product's, made ptxas spill.
//   * Every per-tile decision (whole tile or masked) is made before the
//     products issue: a branch between a wgmma and its wait makes ptxas
//     serialise every wgmma of the kernel.
//   * Epilogue: o = acc * (1 / l) (times 1 / (1 - rate) with dropout) in
//     float32, written as bf16 into the consumer's q tile in the swizzled
//     layout and stored by TMA (rows past Sq are not written); lse by the
//     first thread of each row's quad.
// float32 (the parity paths and the small float32 configs),
// `flash_fwd_tf32<D, DROP>` at D 16, 32, 64 and 128: both products on the
// tensor cores, mma.sync m16n8k8 in 3xTF32 (hopper.cuh: each operand split
// into two tf32 parts, three products accumulated in f32, ~2^-21 relative
// a product where one tf32 product keeps ~2^-11). Three tf32 products at
// 495 TFLOP/s outrun one f32 FMA product at 67. wgmma reads B from shared
// memory and does not transpose 32-bit types, so both parts of k and of a
// transposed v would sit there; with mma.sync the B fragments are split
// in registers, and shared memory holds each f32 tile once.
//   * A block is 64 q rows of one (b, q head), launched heaviest first
//     as bf16's, and two halves of 4 warps (16 rows a warp): half h takes
//     kv tiles 2j + h, and the halves' o, row maxima and row sums meet in
//     shared memory at the end. So 8 warps share a q tile, and the 128
//     blocks of a 1024-row chunk of 8 heads still keep 8 warps an SM.
//     Shared memory: 169 KB a block at D 128 (one an SM), 87 KB at D 64
//     (two).
//   * cp.async copies the q tile (scaled on arrival: q is scaled before
//     QK^T, as the TPU kernel does) and a ring of two stages, each a pair
//     of 32-row k and v tiles, in 16-byte pieces into rows of pitch D + 4
//     floats, rows past Skv zero-filled: pair j + 1's copies are in flight
//     while pair j's products run. The pitch keeps every fragment read
//     free of bank conflicts: ldmatrix's 8 rows of 16 bytes (4 (D + 4)
//     words apart: distinct bank quads) and v's (2t, g) reads
//     (2t (D + 4) = 8t mod 32).
//   * S = Q K^T: q's A fragments by ldmatrix.x4, split once a k-step and
//     used for 4 n8 tiles; k's B fragments by ldmatrix.x4, two n8 tiles at
//     a time, split in registers.
//   * The softmax runs in base 2 (log2 e folded into the exponent,
//     ex2.approx) with the row maximum in scaled units; it masks only tiles
//     a warp does not see whole (a masked probability is exactly 0), and a
//     warp skips a tile none of its rows sees. With dropout the keep bits
//     are philox.cuh's keep_bits_rows, drawn in the C fragment's layout.
//   * O = alpha O + P V with P in registers: each C fragment of S is the
//     A fragment of a k-step (hopper.cuh's c_as_a), and v's B fragment is
//     read from the rows that permutation names; no P tile in shared
//     memory. Each n8 tile of o takes a tile's product (accumulated from
//     zero) by one fma, so the tensor cores' truncating accumulation never
//     runs over the whole row.
//   * Epilogue: o = acc * (1 / l) (times 1 / (1 - rate)) by float2 stores,
//     lse = m + ln l; rows that saw no key get o = 0 and lse = 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"
#include "philox.cuh"

namespace {

using namespace hopper;

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

// ---------------------------------------------------------------------------
// bfloat16: a warp-specialised wgmma kernel fed by a TMA ring

constexpr int CONSUMERS = 2;                      // consumer warpgroups a block
constexpr int WG_THREADS = WG * (1 + CONSUMERS);  // + the producer warpgroup
constexpr int TQ = 64;                            // q rows of a consumer (wgmma M)
constexpr int BLOCK_Q = CONSUMERS * TQ;           // q rows of a block
constexpr int BKV = 128;                          // kv rows of a tile (S's N)
constexpr uint32_t KV_PANEL = BKV * ROW_BYTES;    // a 64-column panel of a kv tile
constexpr int SCHED_BAR = 1;   // named barriers 1, 2: the consumers' turns
constexpr int STORE_BAR = 3;   // 3, 4: a consumer's o tile is written

// shared memory (byte offsets from a 1024-aligned base): the consumers' q
// tiles (each later its o tile), then per stage a k and a v tile, then the
// mbarriers
template <int D>
struct FwdSmem {
  static constexpr uint32_t QT = (D / 64) * PANEL;     // a consumer's q tile
  static constexpr uint32_t KT = (D / 64) * KV_PANEL;  // a k or v tile
  static constexpr uint32_t Q = 0;
  static constexpr uint32_t KV = CONSUMERS * QT;  // stage s: k at +2sKT, v at +(2s+1)KT
  static constexpr int STAGES = (SMEM_MAX - 2048 - KV) / (2 * KT) < 8
                                    ? (SMEM_MAX - 2048 - KV) / (2 * KT)
                                    : 8;
  static_assert(STAGES >= 2, "k_j and v_{j-1} are held together");
  static constexpr uint32_t BARS = KV + STAGES * 2 * KT;  // q, full[STAGES], empty[STAGES]
  static constexpr size_t bytes = BARS + 8 * (1 + 2 * STAGES) + 1024;  // + alignment
};

// one past the last kv column any of rows [r0, r0 + n) (clipped to Sq) can
// see; 0 when the range holds no row
__device__ __forceinline__ int kv_end_rows(const Params& p, int r0, int n) {
  if (r0 >= p.Sq) return 0;
  if (!p.causal) return p.Skv;
  const int last = min(r0 + n, p.Sq) - 1;
  return max(0, min(p.Skv, last + (p.Skv - p.Sq) + 1));
}

// sc (64 x 128) = the q tile at `q` times the kv tile at `k` transposed,
// both K-major over D columns (sc's old values are not read)
template <int D>
__device__ __forceinline__ void mma_scores(float (&sc)[64], uint32_t q, uint32_t k) {
  wgmma_ss_n128_first(sc, kmajor_desc(q, 0), kmajor_desc(k, 0, KV_PANEL));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk)
    wgmma_ss_n128(sc, kmajor_desc(q, kk), kmajor_desc(k, kk, KV_PANEL), 1);
}

// P of a 64 x 128 score tile as the bf16 A operands of the 8 k-steps of
// P V: sc[4nt + 2i + j] is row g + 8i, column 8nt + 2t + j, and step kk
// takes columns 16kk..16kk+15 (the mma.sync A fragment layout)
__device__ __forceinline__ void to_frags(uint32_t (&pf)[8][4], const float (&sc)[64]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pf[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
}

// With dropout, P as bf16 and its bf16 remainder sc - bf16(sc), for a
// second P V product: P then enters with ~16 bits. At rate 0.5 an output is
// twice its kept keys' weighted mean, up to ~8 in the smoke's cases, where
// o's own bf16 rounding takes 0.0156 of the 0.02 limit, and P rounded once
// moved o 0.0204 from the plain version (measured on an H100).
__device__ __forceinline__ void to_frags_split(uint32_t (&pf)[8][4], uint32_t (&pl)[8][4],
                                               const float (&sc)[64]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = sc[8 * kk + 2 * r], b = sc[8 * kk + 2 * r + 1];
      pf[kk][r] = pack_bf16(a, b);
      pl[kk][r] = pack_bf16(a - __bfloat162float(__float2bfloat16_rn(a)),
                            b - __bfloat162float(__float2bfloat16_rn(b)));
    }
}

// the A operands' registers stay untouched until the wait before this
__device__ __forceinline__ void hold_frags(uint32_t (&pf)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) hold(pf[kk]);
}

// o (64 x D) += P (A operands) times the kv tile at `v` (MN-major: its
// rows are K)
template <int D>
__device__ __forceinline__ void mma_pv(float (&o)[D / 2], const uint32_t (&pf)[8][4],
                                       uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) wgmma_rs(o, pf[kk], mnmajor_desc(v, kk, KV_PANEL));
}

// One tile's online softmax, in place: sc holds the raw scores of kv
// columns kv0.. of this thread's rows row0 and row0 + 8 and leaves with
// their probabilities 2^((s - m) scale log2 e) for P V (0 where masked, and
// with dropout 0 where dropped). m (raw units: scale > 0) and this thread's
// share of l are updated; returns through alpha the factor O must be
// rescaled by. `whole` (every element visible) was decided before the
// products issued; it skips the masking pass (one branch a tile).
template <bool DROP>
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             const Params& p, int row0, int kv0,
                                             int t4, bool whole, float scale2,
                                             const uint32_t (&kb)[2]) {
  if (!whole) {
    // row row0 + 8i sees the columns below lim[i] (relative to this
    // thread's first column of the tile); a masked score is -inf
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int lim = (p.causal ? min(p.Skv, row0 + 8 * i + p.Skv - p.Sq + 1) : p.Skv) -
                      (kv0 + 2 * t4);
#pragma unroll
      for (int nt = 0; nt < 16; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float& x = sc[4 * nt + 2 * i + j];
          x = 8 * nt + j < lim ? x : -INFINITY;
        }
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int e = 0; e < 64; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
  float ms[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    // a row that has seen no visible key keeps max -inf: it subtracts 0,
    // so its masked scores give 2^-inf = 0 (never 2^(-inf + inf)) and l
    // stays 0 (the empty-row guard); alpha is 0 until its first key
    ms[i] = mx[i] == -INFINITY ? 0.f : mx[i] * scale2;
    alpha[i] = m[i] == -INFINITY ? 0.f : exp2_approx((m[i] - mx[i]) * scale2);
    m[i] = mx[i];
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    const int i = (e >> 1) & 1;
    const float pv = exp2_approx(fmaf(sc[e], scale2, -ms[i]));
    l[i] += pv;
    sc[e] = (!DROP || ((kb[e >> 5] >> (e & 31)) & 1u)) ? pv : 0.f;
  }
}

template <int D, bool DROP>
__global__ void __launch_bounds__(WG_THREADS, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap to, const Params p) {
  using SM = FwdSmem<D>;
  constexpr uint32_t QT = SM::QT;
  constexpr uint32_t KT = SM::KT;
  constexpr int STAGES = SM::STAGES;
  extern __shared__ uint8_t dsmem[];
  const uint32_t raw = smem_addr(dsmem);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = dsmem + (base - raw);  // the same address, generic
  const uint32_t bar_q = base + SM::BARS;
  const uint32_t bar_full = bar_q + 8;                // + 8s
  const uint32_t bar_empty = bar_full + 8 * STAGES;  // + 8s

  const int n_bh = p.B * p.N;
  const int q_tiles = (p.Sq + BLOCK_Q - 1) / BLOCK_Q;
  const int bn = blockIdx.x % n_bh;
  const int q0 = (q_tiles - 1 - static_cast<int>(blockIdx.x) / n_bh) * BLOCK_Q;  // heaviest first
  const int b = bn / p.N;
  const int h = bn - b * p.N;
  const int kvh = h / (p.N / p.Nkv);
  const int kv_tiles = (kv_end_rows(p, q0, BLOCK_Q) + BKV - 1) / BKV;

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
      mbar_arrive_tx(bar_q, CONSUMERS * QT);
      for (int c = 0; c < CONSUMERS; ++c)
        tma_tile<D>(base + SM::Q + c * QT, &tq, bar_q, h, q0 + c * TQ, b);
#pragma unroll 1  // one tile at a time
      for (int it = 0; it < kv_tiles; ++it) {
        const int s = it % STAGES;
        mbar_wait_or_trap(bar_empty + 8 * s, ((it / STAGES) & 1) ^ 1);
        mbar_arrive_tx(bar_full + 8 * s, 2 * KT);
        const uint32_t kt = base + SM::KV + 2 * s * KT;
        tma_tile<D, BKV>(kt, &tk, bar_full + 8 * s, kvh, it * BKV, b);
        tma_tile<D, BKV>(kt + KT, &tv, bar_full + 8 * s, kvh, it * BKV, b);
      }
      drain<STAGES>(bar_empty, kv_tiles);
    }
    return;
  }

  // consumer c: rows row0 = qc + wr + g and row0 + 8 of this thread
  regs_inc<CONSUMER_REGS>();
  const int c = role;
  const int tid = tx % WG;
  const int wr = (tid / 32) * 16;
  const int g = (tid % 32) / 4;
  const int t4 = tid % 4;
  const int qc = q0 + c * TQ;
  const int row0 = qc + wr + g;
  const int offset = p.Skv - p.Sq;
  const float scale2 = p.scale * LOG2E;
  const uint32_t qs = base + SM::Q + c * QT;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  float alpha[2];
  float sc[64];
  uint32_t pf[8][4], pl[8][4];  // P (with dropout: and its remainder), bf16
  uint32_t kb[2] = {0u, 0u};

  // a tile every row of this warp sees whole skips the per-element mask
  auto whole_tile = [&](int kv0) {
    return kv0 + BKV <= p.Skv && (!p.causal || kv0 + BKV - 1 <= qc + wr + offset);
  };
  auto draw_bits = [&](int kv0) {
    if (DROP) {
      kb[0] = dropout::keep_bits_rows(p.seed, bn, row0, kv0 + 2 * t4, p.threshold);
      kb[1] = dropout::keep_bits_rows(p.seed, bn, row0, kv0 + 64 + 2 * t4, p.threshold);
    }
  };
  auto k_tile = [&](int s) { return base + SM::KV + 2 * s * KT; };

  // the consumers take turns issuing their products: consumer 0 first
  if (c == 1) bar_arrive(SCHED_BAR, 2 * WG);
  mbar_wait(bar_q, 0);
  if (kv_tiles > 0) {
    // tile 0: its scores and softmax
    bool whole = whole_tile(0);
    draw_bits(0);
    mbar_wait(bar_full, 0);
    bar_sync(SCHED_BAR + c, 2 * WG);
    wgmma_fence();
    mma_scores<D>(sc, qs, k_tile(0));
    wgmma_commit();
    bar_arrive(SCHED_BAR + (c ^ 1), 2 * WG);
    wgmma_wait<0>();
    hold(sc);
    softmax_tile<DROP>(sc, m, l, alpha, p, row0, 0, t4, whole, scale2, kb);
    if constexpr (!DROP) {
      // tile it: S_it = Q K_it^T and O += P_{it-1} V_{it-1} issue
      // together; tile it's softmax runs while the second still does
#pragma unroll 1  // one tile at a time
      for (int it = 1; it < kv_tiles; ++it) {
        const int s = it % STAGES;
        const int sp = (it - 1) % STAGES;
        const int kv0 = it * BKV;
        to_frags(pf, sc);
        whole = whole_tile(kv0);
        mbar_wait(bar_full + 8 * s, (it / STAGES) & 1);
        bar_sync(SCHED_BAR + c, 2 * WG);
        wgmma_fence();
        mma_scores<D>(sc, qs, k_tile(s));
        wgmma_commit();
        mma_pv<D>(o, pf, k_tile(sp) + KT);
        wgmma_commit();
        bar_arrive(SCHED_BAR + (c ^ 1), 2 * WG);
        wgmma_wait<1>();
        hold(sc);
        softmax_tile<DROP>(sc, m, l, alpha, p, row0, kv0, t4, whole, scale2, kb);
        wgmma_wait<0>();
        hold(o);
        hold_frags(pf);
        mbar_arrive(bar_empty + 8 * sp);
#pragma unroll
        for (int e = 0; e < D / 2; ++e) o[e] *= alpha[(e >> 1) & 1];
      }
      // the last tile's P V
      const int sp = (kv_tiles - 1) % STAGES;
      to_frags(pf, sc);
      wgmma_fence();
      mma_pv<D>(o, pf, k_tile(sp) + KT);
      wgmma_commit();
      wgmma_wait<0>();
      hold(o);
      mbar_arrive(bar_empty + 8 * sp);
    } else {
      // With dropout P V takes P and its remainder (64 registers): held
      // beside S and O while the softmax ran, they made ptxas spill. So a
      // consumer runs its tiles in order — S_it, softmax, P_it V_it — and
      // draws the next tile's Philox bits between P_it V_it and S_it+1,
      // when only O is held (drawn while a product ran, the 16 Philox
      // chains ptxas interleaves spilled at D 128); the other consumer's
      // products fill the tensor cores meanwhile.
#pragma unroll 1  // one tile at a time
      for (int it = 0; it < kv_tiles; ++it) {
        const int sp = it % STAGES;
        const int kv1 = (it + 1) * BKV;
        const bool more = it + 1 < kv_tiles;
        to_frags_split(pf, pl, sc);
        whole = whole_tile(kv1);
        wgmma_fence();
        mma_pv<D>(o, pf, k_tile(sp) + KT);
        mma_pv<D>(o, pl, k_tile(sp) + KT);
        wgmma_commit();
        wgmma_wait<0>();
        hold(o);
        hold_frags(pf);
        hold_frags(pl);
        mbar_arrive(bar_empty + 8 * sp);
        if (!more) break;
        draw_bits(kv1);
        const int s = (it + 1) % STAGES;
        mbar_wait(bar_full + 8 * s, ((it + 1) / STAGES) & 1);
        bar_sync(SCHED_BAR + c, 2 * WG);
        wgmma_fence();
        mma_scores<D>(sc, qs, k_tile(s));
        wgmma_commit();
        bar_arrive(SCHED_BAR + (c ^ 1), 2 * WG);
        wgmma_wait<0>();
        hold(sc);
        softmax_tile<DROP>(sc, m, l, alpha, p, row0, kv1, t4, whole, scale2, kb);
#pragma unroll
        for (int e = 0; e < D / 2; ++e) o[e] *= alpha[(e >> 1) & 1];
      }
    }
  }
  if (c == 0) bar_sync(SCHED_BAR, 2 * WG);  // consumer 1's last turn

  // epilogue: o = acc / l (times 1 / (1 - rate)), lse = m scale + ln l;
  // rows that saw no key get o = 0 and lse = 0
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const bool empty = !(l[i] > 0.f);
    inv[i] = empty ? 0.f : (DROP ? p.drop_scale : 1.f) / l[i];
    const int row = row0 + 8 * i;
    if (t4 == 0 && row < p.Sq)
      p.lse[static_cast<long long>(bn) * p.Sq + row] =
          empty ? 0.f : m[i] * p.scale + logf(l[i]);
  }
  // o into this consumer's q tile (its last reader, S, is done) in the
  // 128-byte swizzle: 16-byte chunk k of row r sits at chunk k ^ (r % 8),
  // and r % 8 == g; then one TMA store a panel
  uint8_t* ot = gbase + SM::Q + c * QT;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wr + g + 8 * i;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<uint32_t*>(ot + (dn / 8) * PANEL + r * ROW_BYTES +
                                   (((dn % 8) ^ g) * 16) + t4 * 4) =
          pack_bf16(o[dn * 4 + 2 * i] * inv[i], o[dn * 4 + 2 * i + 1] * inv[i]);
  }
  fence_async_shared();
  bar_sync(STORE_BAR + c, WG);
  if (tid == 0 && qc < p.Sq) {
#pragma unroll
    for (int pn = 0; pn < D / 64; ++pn) tma_store(qs + pn * PANEL, &to, pn * 64, h, qc, b);
    tma_store_wait();
  }
}

// ---------------------------------------------------------------------------
// float32: 3xTF32 on the tensor cores (mma.sync), fed by a cp.async ring

constexpr int TQ32 = 64;        // q rows a block: 4 warps of 16, in each half
constexpr int TKV32 = 32;       // kv rows a tile
constexpr int THREADS32 = 256;  // two halves of 4 warps, on alternate kv tiles
constexpr int STAGES32 = 2;     // pairs of kv tiles in flight

// shared memory in floats: the q tile, then per stage and half a k and a
// v tile, every row at pitch D + 4; after the loop the stages hold the
// halves' merge
template <int D>
struct Tf32Smem {
  static constexpr int P = D + 4;
  static constexpr int T = TKV32 * P;  // a k or v tile
  static constexpr int KV = TQ32 * P;  // stage s, half h: k at KV + (2s + h) 2T, v at + T
  static constexpr size_t bytes = sizeof(float) * (KV + STAGES32 * 4 * T);
  static_assert(STAGES32 * 4 * T >= (THREADS32 / 2) * (D / 2 + 4), "the merge fits");
};

template <int D, bool DROP>
__global__ void __launch_bounds__(THREADS32, D == 128 ? 1 : 2)
    flash_fwd_tf32(const Params p) {
  using SM = Tf32Smem<D>;
  constexpr int P = SM::P;
  constexpr int NT = D / 8;   // n8 tiles of a warp's o
  constexpr int HT = THREADS32 / 2;
  extern __shared__ __align__(16) float fsm[];
  const uint32_t sbase = smem_addr(fsm);

  const int n_bh = p.B * p.N;
  const int q_tiles = (p.Sq + TQ32 - 1) / TQ32;
  const int bn = blockIdx.x % n_bh;
  const int q0 = (q_tiles - 1 - static_cast<int>(blockIdx.x) / n_bh) * TQ32;  // heaviest first
  const int b = bn / p.N;
  const int h = bn - b * p.N;
  const int kvh = h / (p.N / p.Nkv);
  const int kv_tiles = (kv_end_rows(p, q0, TQ32) + TKV32 - 1) / TKV32;
  const int pairs = (kv_tiles + 1) / 2;
  const int offset = p.Skv - p.Sq;
  const int tid = threadIdx.x;

  const float* qg = static_cast<const float*>(p.q) + b * p.sq_b + h * p.sq_h + q0 * p.sq_s;
  const float* kg = static_cast<const float*>(p.k) + b * p.sk_b + kvh * p.sk_h;
  const float* vg = static_cast<const float*>(p.v) + b * p.sv_b + kvh * p.sv_h;
  auto tile = [&](int it, int half) { return SM::KV + ((it % STAGES32) * 2 + half) * 2 * SM::T; };
  // kv tiles 2it and 2it + 1, one for each half
  auto load_pair = [&](int it) {
#pragma unroll 1
    for (int half = 0; half < 2 && 2 * it + half < kv_tiles; ++half) {
      const int kv0 = (2 * it + half) * TKV32;
      const uint32_t kt = sbase + 4u * tile(it, half);
      load_rows<D, THREADS32>(kt, kg + kv0 * p.sk_s, p.sk_s, TKV32, p.Skv - kv0, tid);
      load_rows<D, THREADS32>(kt + 4u * SM::T, vg + kv0 * p.sv_s, p.sv_s, TKV32,
                              p.Skv - kv0, tid);
    }
  };

  // the q tile and the first pair in one group; q is scaled where it landed
  load_rows<D, THREADS32>(sbase, qg, p.sq_s, TQ32, p.Sq - q0, tid);
  if (pairs > 0) load_pair(0);
  cp_async_commit();
  cp_async_wait<0>();
  scale_rows<D, THREADS32>(fsm, TQ32, p.scale, tid);
  __syncthreads();

  // warp w owns rows r0 = q0 + 16 (w % 4) .. of the kv tiles 2it + w / 4;
  // this thread rows row0 and row0 + 8
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int half = warp / 4;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = q0 + 16 * (warp % 4);
  const int row0 = r0 + g;
  const int last = min(r0 + 15, p.Sq - 1);  // the warp's last row in range
  // ldmatrix.x4 addresses: matrix lane / 8, its row lane % 8. For q's A
  // fragment (rows r0.., columns 8kk..) the matrices are (rows +0 / +8) x
  // (columns +0 / +4); for k's B fragments two n8 tiles x (columns +0 / +4)
  const int mi = lane / 8;
  const int mr = lane % 8;
  const uint32_t qa = sbase + 4u * ((r0 - q0 + mr + 8 * (mi & 1)) * P + 4 * (mi >> 1));
  const uint32_t kb_lane = 4u * ((8 * (mi >> 1) + mr) * P + 4 * (mi & 1));

  float o[NT][4];
  zero(o);
  float m[2] = {-INFINITY, -INFINITY};  // row maxima, scaled units
  float l[2] = {0.f, 0.f};              // this thread's share of the row sums

#pragma unroll 1  // one pair of tiles at a time
  for (int it = 0; it < pairs; ++it) {
    if (it + 1 < pairs) load_pair(it + 1);
    cp_async_commit();
    const int kv0 = (2 * it + half) * TKV32;
    const uint32_t ks = sbase + 4u * tile(it, half);
    const float* vs = fsm + tile(it, half) + SM::T;
    // a warp whose rows see no column of its tile skips it
    if (kv0 < kv_tiles * TKV32 && r0 < p.Sq && (!p.causal || kv0 <= last + offset)) {
      // S (16 x 32): sc[nt][c] is row row0 + 8 (c / 2), column kv0 + 8nt + 2t + c % 2
      float sc[4][4], se[4][4];
      zero(sc);
      zero(se);
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        uint32_t x[4];
        Tf32A a;
        ldmatrix_x4(x, qa + 32u * kk);
        split_tf32(x, a.big, a.small);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t y[4];
          Tf32B b0, b1;
          ldmatrix_x4(y, ks + kb_lane + 4u * (16 * np * P) + 32u * kk);
          b_frags(y, b0, b1);
          mma_3xtf32(sc[2 * np], se[2 * np], a, b0);
          mma_3xtf32(sc[2 * np + 1], se[2 * np + 1], a, b1);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[nt][c] += se[nt][c];
      // a tile every row of this warp sees whole skips the mask
      const bool whole =
          kv0 + TKV32 <= p.Skv && (!p.causal || kv0 + TKV32 - 1 <= r0 + offset);
      if (!whole) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          // row row0 + 8i sees the columns below lim (from kv0 + 2t)
          const int lim =
              (p.causal ? min(p.Skv, row0 + 8 * i + offset + 1) : p.Skv) - (kv0 + 2 * t);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              if (8 * nt + j >= lim) sc[nt][2 * i + j] = -INFINITY;
        }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) mx[c / 2] = fmaxf(mx[c / 2], sc[nt][c]);
      float ms[2], alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        // a row that has seen no visible key keeps max -inf: it subtracts
        // 0, so its masked scores give 2^-inf = 0 and l stays 0 (the
        // empty-row guard); alpha is 0 until its first key
        ms[i] = mx[i] == -INFINITY ? 0.f : mx[i] * LOG2E;
        alpha[i] = m[i] == -INFINITY ? 0.f : exp2_approx(m[i] * LOG2E - ms[i]);
        m[i] = mx[i];
        l[i] *= alpha[i];
      }
      uint32_t kb = 0;
      if (DROP)
        kb = dropout::keep_bits_rows<TKV32 / 16>(p.seed, bn, row0, kv0 + 2 * t, p.threshold);
      // l takes the undropped p, P V the kept one (1 / (1 - rate) at the end)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float pv = exp2_approx(fmaf(sc[nt][c], LOG2E, -ms[c / 2]));
          l[c / 2] += pv;
          sc[nt][c] = (!DROP || ((kb >> (4 * nt + c)) & 1u)) ? pv : 0.f;
        }
      // O = alpha O + P V: k-step kk takes S's n8 tile kk (columns 2t, 2t + 1
      // as its k indices t, t + 4), so v's B fragment is rows 2t, 2t + 1,
      // column g; each n8 tile of o takes the tile's product by one fma
      Tf32A pa[TKV32 / 8];
#pragma unroll
      for (int kk = 0; kk < TKV32 / 8; ++kk) pa[kk] = c_as_a(sc[kk]);
      const float* v0 = vs + 2 * t * P + g;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float pv[4] = {0.f, 0.f, 0.f, 0.f}, pe[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < TKV32 / 8; ++kk) {
          const float* vr = v0 + 8 * kk * P + 8 * nt;
          mma_3xtf32(pv, pe, pa[kk], b_of(vr[0], vr[P]));
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) o[nt][c] = fmaf(o[nt][c], alpha[c / 2], pv[c] + pe[c]);
      }
    }
    cp_async_wait<0>();  // the next pair has landed
    __syncthreads();     // and every warp is done with this pair's stage
  }

  // the halves (same rows, alternate kv tiles) meet: half 1 leaves o, m
  // and l in the stages, half 0 rescales both to the joint maximum
  float* mg = fsm + SM::KV;
  const int ht = tid % HT;
  if (half == 1) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) mg[(4 * nt + c) * HT + ht] = o[nt][c];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mg[(D / 2 + i) * HT + ht] = m[i];
      mg[(D / 2 + 2 + i) * HT + ht] = l[i];
    }
  }
  __syncthreads();
  if (half == 1) return;
  float a0[2], a1[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m1 = mg[(D / 2 + i) * HT + ht];
    const float mx = fmaxf(m[i], m1);
    a0[i] = m[i] == -INFINITY ? 0.f : exp2_approx((m[i] - mx) * LOG2E);
    a1[i] = m1 == -INFINITY ? 0.f : exp2_approx((m1 - mx) * LOG2E);
    l[i] = l[i] * a0[i] + mg[(D / 2 + 2 + i) * HT + ht] * a1[i];
    m[i] = mx;
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      o[nt][c] = o[nt][c] * a0[c / 2] + mg[(4 * nt + c) * HT + ht] * a1[c / 2];

  // epilogue: o = acc / l (times 1 / (1 - rate)), lse = m + ln l; rows that
  // saw no key get o = 0 and lse = 0
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const bool empty = !(l[i] > 0.f);
    inv[i] = empty ? 0.f : (DROP ? p.drop_scale : 1.f) / l[i];
    const int row = row0 + 8 * i;
    if (t == 0 && row < p.Sq)
      p.lse[static_cast<long long>(bn) * p.Sq + row] = empty ? 0.f : m[i] + logf(l[i]);
  }
  // o is allocated contiguous (B, Sq, N, D)
  float* og = static_cast<float*>(p.o) + (static_cast<long long>(b) * p.Sq * p.N + h) * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= p.Sq) continue;
    float* orow = og + static_cast<long long>(row) * p.N * D + 2 * t;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      *reinterpret_cast<float2*>(orow + 8 * nt) =
          make_float2(o[nt][2 * i] * inv[i], o[nt][2 * i + 1] * inv[i]);
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

// one block per 64-row q tile and (b, q head); shared memory past 48 KB,
// and the carveout that lets two blocks share an SM (D <= 64)
template <int D, bool DROP>
int launch_tf32(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = Tf32Smem<D>::bytes;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(flash_fwd_tf32<D, DROP>,
                                               cudaFuncAttributePreferredSharedMemoryCarveout,
                                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (const int e = set_smem(flash_fwd_tf32<D, DROP>, smem, configured)) return e;
  const int blocks = (p.Sq + TQ32 - 1) / TQ32 * p.B * p.N;
  flash_fwd_tf32<D, DROP><<<blocks, THREADS32, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// tensor maps of q, k, v (their own strides; Skv rows, at least one: with
// Skv 0 no tile is loaded) and of o (allocated contiguous), then one block
// per 128-row q tile and (b, q head)
template <int D, bool DROP>
int launch_wgmma(const Params& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, to;
  const int skv = p.Skv > 0 ? p.Skv : 1;
  if (!bsnh_map(&tq, p.q, p.B, p.Sq, p.N, D, p.sq_b, p.sq_s, p.sq_h, TQ) ||
      !bsnh_map(&tk, p.k, p.B, skv, p.Nkv, D, p.sk_b, p.sk_s, p.sk_h, BKV) ||
      !bsnh_map(&tv, p.v, p.B, skv, p.Nkv, D, p.sv_b, p.sv_s, p.sv_h, BKV) ||
      !bsnh_map(&to, p.o, p.B, p.Sq, p.N, D, TQ))
    return NO_TENSOR_MAP;
  constexpr size_t smem = FwdSmem<D>::bytes;
  static bool configured = false;
  if (const int e = set_smem(flash_fwd_wgmma<D, DROP>, smem, configured)) return e;
  const int blocks = (p.Sq + BLOCK_Q - 1) / BLOCK_Q * p.B * p.N;
  flash_fwd_wgmma<D, DROP><<<blocks, WG_THREADS, smem, stream>>>(tq, tk, tv, to, p);
  return static_cast<int>(cudaGetLastError());
}

// float32 is built for D 16, 32, 64 and 128; bfloat16 (wgmma: whole
// 64-column panels) for 64 and 128 only
template <int D>
int launch(int dtype, bool drop, const Params& p, cudaStream_t s) {
  if (dtype == 0)
    return drop ? launch_tf32<D, true>(p, s) : launch_tf32<D, false>(p, s);
  if constexpr (D % 64 == 0)
    return drop ? launch_wgmma<D, true>(p, s) : launch_wgmma<D, false>(p, s);
  return -1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, the head_dim
// axis has unit stride; the base and the (b, s, h) strides lie on 16-byte
// boundaries (TMA and cp.async read 16 bytes at a time; the wrapper copies
// what does not). dropout != 0
// applies attention-prob dropout with the Philox key `seed`, keeping a
// probability iff its word is below `threshold` and scaling it by
// `drop_scale`. Returns 0 on success, the CUDA error code of a refused
// launch, -1 for a (dtype, head_dim) pair this library was not built for,
// or -2 when no tensor map could be made.
extern "C" int flash_fwd(int dtype, int head_dim, const void* q,
                         const void* k, const void* v, void* o, float* lse,
                         int B, int N, int Nkv, int Sq, int Skv,
                         long long sq_b, long long sq_s, long long sq_h,
                         long long sk_b, long long sk_s, long long sk_h,
                         long long sv_b, long long sv_s, long long sv_h,
                         float scale, int causal, int dropout,
                         unsigned long long seed, unsigned int threshold,
                         float drop_scale, void* stream) {
  Params p{q,    k,    v,    o,    lse,  B,    N,     Nkv,    Sq,
           Skv,  sq_b, sq_s, sq_h, sk_b, sk_s, sk_h,  sv_b,   sv_s,
           sv_h, scale, causal, seed, threshold, drop_scale};
  if (Sq == 0 || B * N == 0) return 0;
  if ((dtype != 0 && dtype != 1)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch<16>(dtype, dropout != 0, p, s);
    case 32: return launch<32>(dtype, dropout != 0, p, s);
    case 64: return launch<64>(dtype, dropout != 0, p, s);
    case 128: return launch<128>(dtype, dropout != 0, p, s);
    default: return -1;
  }
}
