// Dropout for Hopper (sm_90a), CUDA C++ with a plain C interface (built by
// kernels/build.py with nvcc, bound with ctypes in kernels/dropout.py): the
// keep mask of philox.cuh, written out or applied.
//
// Replaces the test-only Pallas kernel `mask_kernel`
// (tests/test_flash_dropout_tpu.py, pallas_call at line 120) that reads the
// TPU kernels' keep mask out through `_dropout_keep`
// (solvingpapers_tpu/kernels/flash_attention.py:60-70), and the residual
// dropout the reference leaves to XLA (Flax's `nn.Dropout`,
// `where(keep, x / (1 - rate), 0)`). Two modes over a (BH, Sq, Skv) region,
// element (bh, row, col) kept iff keep(seed, bh, row, col):
//   * mask  (`dropout_mask`):  writes the keep mask as bytes (1 = keep), the
//     dense attention paths' probability mask and what the checks read;
//   * apply (`dropout_apply`): y = keep ? x / (1 - rate) : 0 for float32 or
//     bfloat16 x, the residual dropout in one pass (forward, and backward on
//     the gradient: the map is its own derivative). The quotient is IEEE
//     float32 division's of float(x) by float32(1 - rate), rounded to x's
//     dtype (round to nearest even), as the plain version computes it.
//
// What bounds it on an H100 (3.35 TB/s; 32-bit integer multiplies at a
// documented 64 a clock an SM, 132 SMs at ~1.98 GHz: 16.7 T/s): one
// Philox4x32-10 call makes the keep bits of four elements in 10 rounds of
// two 32x32->64-bit products. As built, a strip's 8 calls share round 0's
// products and two of rounds 1-2's, so the mask kernel issues 131
// IMAD.WIDE.U32 a thread (16.4 a call; chip_smoke.py counts them in the
// SASS), besides xors, compares and packing on the other integer pipe. At
// (1, 16384, 512) that is 2.1 M calls and 0.0021 ms of multiplies against
// 0.0025 ms of bytes (1 byte written an element), so mask mode is bound by
// bytes; apply mode too (bf16: 33.6 MB read and written, 0.0100 ms;
// float32 0.0200 ms). The card issues IMAD.WIDE.U32 well below the
// documented rate (probes/dropout_ab.py measures it), so on the card the
// multiplies and the instruction issue, not the bytes, set the mask
// kernel's pace.
//
// Design: a thread owns a 2-row x 16-column strip, rows r and r + 8 (r with
// bit 3 clear) and columns c0 .. c0 + 15 (c0 a multiple of 16): exactly the
// eight 2x2 Philox groups (r, c0 + j), j < 8, so it runs 8 independent
// Philox calls (instruction-level parallelism for the integer pipes; the
// key schedule is shared) and no call is repeated by another thread.
// Neighbouring threads take neighbouring strips of one row pair, so a warp
// reads and writes 32 x 16 elements of each row contiguously: 16-byte
// vector stores (one a row in mask mode) and loads. Mask mode's grid is one
// block row per bh and enough 128-thread blocks for every strip; ragged
// edges take element-wise stores.
//
// Apply mode works against the sum of issue and bytes that held its first
// design (one strip a thread, an IEEE division and a packed keep byte an
// element: its integer work and its memory traffic added up):
//   * no division on the fast path: the host passes d = float32(1 - rate)
//     and rcp = RN(1 / d), and an element takes one multiply and two fmas
//     (`quotient`, exact by Markstein's theorem); a row whose quotients
//     leave the range where that holds (zeros stay in it) takes __fdiv_rn;
//   * the keep flags stay predicates: each Philox word is compared with the
//     threshold where its element is selected;
//   * the Philox products written as IMAD.WIDE.U32: left to itself, ptxas
//     splits them into IMAD.HI.U32 + IMAD, and an H100 issues IMAD.HI.U32
//     at 30.4 a clock an SM (probes/imad_hi_rate.cu), so a product costs
//     more of the multiply pipe and more issue slots;
//   * a strip a thread, its loads issued before its Philox work, so its
//     bytes are in flight while the integer pipes run (a resident grid
//     with the next strip in registers gained only at bf16 regions larger
//     than the L2 cache, which no path has: probes/dropout_apply_ab.py);
//   * a ragged row whose length is a multiple of 16 bytes moves 16-byte
//     vectors up to its end; only what is left takes element-wise accesses.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int STRIP = 16;  // columns of a strip

// keep flags of a strip, one byte (0 or 1) per element: k[i][w] holds
// row r + 8i, columns c0 + 4w .. c0 + 4w + 3 (lowest byte first)
struct StripKeep {
  uint32_t k[2][4];
};

__device__ __forceinline__ StripKeep strip_keep(unsigned long long seed,
                                                uint32_t bh, uint32_t r,
                                                uint32_t c0, uint32_t threshold) {
  StripKeep s = {};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    // group (r, c0 + j): words 2i + h are (r + 8i, c0 + j + 8h)
    const dropout::Words g = dropout::group_words(seed, bh, r, c0 + j);
    const int w = j >> 2, sh = 8 * (j & 3);
    s.k[0][w] |= static_cast<uint32_t>(g.w[0] < threshold) << sh;
    s.k[0][2 + w] |= static_cast<uint32_t>(g.w[1] < threshold) << sh;
    s.k[1][w] |= static_cast<uint32_t>(g.w[2] < threshold) << sh;
    s.k[1][2 + w] |= static_cast<uint32_t>(g.w[3] < threshold) << sh;
  }
  return s;
}

__device__ __forceinline__ bool kept(const StripKeep& s, int i, int j) {
  return (s.k[i][j >> 2] >> (8 * (j & 3))) & 1u;
}

// the strip thread `t` of a bh owns: its first row r (bit 3 clear) and
// first column c0
struct Strip {
  int r, c0;
};

__device__ __forceinline__ Strip strip_of(int t, int strips_per_row) {
  const int pair = t / strips_per_row;  // row pair: rows r, r + 8
  return Strip{(pair >> 3) * 16 + (pair & 7), (t - pair * strips_per_row) * STRIP};
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

__global__ void __launch_bounds__(THREADS)
    dropout_mask_kernel(unsigned long long seed, uint32_t threshold, int Sq,
                        int Skv, int strips_per_row, int strips, uint8_t* out) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= strips) return;
  const int bh = blockIdx.y;
  const Strip st = strip_of(t, strips_per_row);
  const StripKeep s = strip_keep(seed, bh, st.r, st.c0, threshold);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = st.r + 8 * i;
    if (row >= Sq) continue;
    uint8_t* dst = out + (static_cast<long long>(bh) * Sq + row) * Skv + st.c0;
    if (st.c0 + STRIP <= Skv && aligned16(dst)) {
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(s.k[i][0], s.k[i][1], s.k[i][2], s.k[i][3]);
    } else {
#pragma unroll  // constant j: the keep flags stay in registers
      for (int j = 0; j < STRIP; ++j)
        if (st.c0 + j < Skv) dst[j] = kept(s, i, j);
    }
  }
}

// ---------------------------------------------------------------- apply mode

// element types of apply mode, as bits
struct F32 {
  using Bits = uint32_t;
};

struct BF16 {
  using Bits = uint16_t;
};

// one strip row of 16 elements: its 16-byte vectors, its 32-bit words and
// its elements
template <typename E>
struct RowBits {
  static constexpr int PER_VEC = 16 / sizeof(typename E::Bits);  // elements
  static constexpr int VECS = STRIP / PER_VEC;
  static constexpr int WORDS = STRIP * sizeof(typename E::Bits) / 4;
  union {
    uint4 v[VECS];
    uint32_t w[WORDS];
    typename E::Bits e[STRIP];
  };
};

// element j of a row as float32 (bf16: its bits in the top half)
template <typename E>
__device__ __forceinline__ float elem(const RowBits<E>& r, int j) {
  if constexpr (sizeof(typename E::Bits) == 4) {
    return __uint_as_float(r.w[j]);
  } else {
    const uint32_t w = r.w[j >> 1];
    return __uint_as_float((j & 1) ? (w & 0xFFFF0000u) : (w << 16));
  }
}

// a row's 16 results, rounded to E (bf16: round to nearest even, two a word)
template <typename E>
__device__ __forceinline__ void put(RowBits<E>& r, const float (&f)[STRIP]) {
  if constexpr (sizeof(typename E::Bits) == 4) {
#pragma unroll
    for (int j = 0; j < STRIP; ++j) r.w[j] = __float_as_uint(f[j]);
  } else {
#pragma unroll
    for (int k = 0; k < STRIP / 2; ++k) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
      r.w[k] = *reinterpret_cast<const uint32_t*>(&p);
    }
  }
}

// x / d, correctly rounded, from y = RN(1 / d) without a division (d in
// [2^-20, 1], so y >= 1): q = RN(x y) is within an ulp of x / d, the
// residual rn = q d - x is exact (an fma), and RN(q - rn y) is x / d
// rounded to nearest (Markstein's theorem), with the sign of zero kept.
// That holds while no step over- or underflows, which `ok` tracks: it
// stays true for q = 0 (then x = 0) and for 2^-80 <= |q| < 2^126, and
// turns false otherwise (NaN and infinite x among them); the caller then
// divides with __fdiv_rn.
__device__ __forceinline__ float quotient(float x, float d, float y, bool& ok) {
  constexpr uint32_t TINY2 = 2u * 0x17800000u;  // bits of 2^-80, doubled
  const float q = __fmul_rn(x, y);
  const float rn = __fmaf_rn(q, d, -x);
  ok &= (fabsf(q) < 0x1p126f) & ((__float_as_uint(q) << 1) - 2u >= TINY2 - 2u);
  return __fmaf_rn(-rn, y, q);
}

// what a thread holds of one strip between its loads and its stores: each
// row's offset, how many of its elements lie in the region (0 past Sq) and
// how many leading 16-byte vectors it moves whole (0 when its base in x or
// y is off 16 bytes), and its elements
template <typename E>
struct StripData {
  long long off[2];
  int n[2], nv[2];
  RowBits<E> in[2];
};

// issues the strip's loads: whole 16-byte vectors where they fit, single
// elements at a ragged row end or an unaligned row
template <typename E>
__device__ __forceinline__ void load_strip(StripData<E>& s, const Strip& st, int bh,
                                           int Sq, int Skv,
                                           const typename E::Bits* x,
                                           const typename E::Bits* y) {
  using R = RowBits<E>;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = st.r + 8 * i;
    s.off[i] = (static_cast<long long>(bh) * Sq + row) * Skv + st.c0;
    s.n[i] = row < Sq ? min(STRIP, Skv - st.c0) : 0;
    s.nv[i] = aligned16(x + s.off[i]) && aligned16(y + s.off[i])
                  ? s.n[i] / R::PER_VEC : 0;
    const uint4* src = reinterpret_cast<const uint4*>(x + s.off[i]);
#pragma unroll
    for (int u = 0; u < R::VECS; ++u)
      if (u < s.nv[i]) s.in[i].v[u] = src[u];
    if (s.nv[i] < R::VECS) {  // a ragged or unaligned row, or one past Sq
#pragma unroll
      for (int j = 0; j < STRIP; ++j)
        if (j >= s.nv[i] * R::PER_VEC) s.in[i].e[j] = j < s.n[i] ? x[s.off[i] + j] : 0;
    }
  }
}

// y = keep ? x / d : 0 over the strip from its Philox words (g[j]: group
// (r, c0 + j), whose words 2i + h are (r + 8i, c0 + j + 8h)), then its
// stores
template <typename E>
__device__ __forceinline__ void apply_strip(const StripData<E>& s,
                                            const dropout::Words (&g)[8],
                                            uint32_t threshold, float d, float rcp,
                                            bool fast, typename E::Bits* y) {
  using R = RowBits<E>;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float f[STRIP];
    bool ok = fast;
#pragma unroll
    for (int j = 0; j < STRIP; ++j) f[j] = quotient(elem(s.in[i], j), d, rcp, ok);
    if (!ok) {
#pragma unroll
      for (int j = 0; j < STRIP; ++j) f[j] = __fdiv_rn(elem(s.in[i], j), d);
    }
#pragma unroll
    for (int j = 0; j < STRIP; ++j)
      f[j] = g[j & 7].w[2 * i + (j >> 3)] < threshold ? f[j] : 0.f;
    R out;
    put(out, f);
    uint4* dst = reinterpret_cast<uint4*>(y + s.off[i]);
#pragma unroll
    for (int u = 0; u < R::VECS; ++u)
      if (u < s.nv[i]) dst[u] = out.v[u];
    if (s.nv[i] * R::PER_VEC < s.n[i]) {
#pragma unroll
      for (int j = 0; j < STRIP; ++j)
        if (j >= s.nv[i] * R::PER_VEC && j < s.n[i]) y[s.off[i] + j] = out.e[j];
    }
  }
}

// A strip a thread: its loads, then its Philox words (the products as
// mul.wide.u32) and its results.
template <typename E>
__global__ void __launch_bounds__(THREADS)
    dropout_apply_kernel(unsigned long long seed, uint32_t threshold, float d,
                         float rcp, int Sq, int Skv, int strips_per_row, int strips,
                         const typename E::Bits* x, typename E::Bits* y) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= strips) return;
  const int bh = blockIdx.y;
  const Strip st = strip_of(t, strips_per_row);
  StripData<E> s;
  load_strip(s, st, bh, Sq, Skv, x, y);
  dropout::Words g[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) g[j] = dropout::group_words<true>(seed, bh, st.r, st.c0 + j);
  apply_strip(s, g, threshold, d, rcp, d >= 0x1p-20f, y);
}

// strips along a row, and of a bh: row pairs (Sq rounded up to 16, halved)
// times strips a row
int strips_per_row(int Skv) { return (Skv + STRIP - 1) / STRIP; }
int strips_of(int Sq, int Skv) { return (Sq + 15) / 16 * 8 * strips_per_row(Skv); }

}  // namespace

// Writes keep(seed, bh, row, col) for bh < BH, row < Sq, col < Skv into the
// contiguous (BH, Sq, Skv) byte array `out`. Returns 0 on success or the
// CUDA error code of a refused launch. The caller launches only with BH,
// Sq and Skv positive, BH <= 65535 and a bh's strips below 2^31.
extern "C" int dropout_mask(unsigned long long seed, unsigned int threshold,
                            int BH, int Sq, int Skv, void* out, void* stream) {
  const int strips = strips_of(Sq, Skv);
  const dim3 grid((strips + THREADS - 1) / THREADS, BH);
  dropout_mask_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      seed, threshold, Sq, Skv, strips_per_row(Skv), strips,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int launch_apply(unsigned long long seed, uint32_t threshold, float d, float rcp,
                 int BH, int Sq, int Skv, const void* x, void* y, cudaStream_t s) {
  const int strips = strips_of(Sq, Skv);
  const dim3 grid((strips + THREADS - 1) / THREADS, BH);
  dropout_apply_kernel<E><<<grid, THREADS, 0, s>>>(
      seed, threshold, d, rcp, Sq, Skv, strips_per_row(Skv), strips,
      static_cast<const typename E::Bits*>(x), static_cast<typename E::Bits*>(y));
  return static_cast<int>(cudaGetLastError());
}

// y = keep(seed, bh, row, col) ? x / d : 0 over contiguous (BH, Sq, Skv) x
// and y of dtype 0 (float32) or 1 (bfloat16), d = float32(1 - rate) and
// rcp = RN(1 / d) in float32; the quotient is IEEE float32 division's,
// rounded to x's dtype. Returns 0 on success, -1 for another dtype, or the
// CUDA error code of a refused launch. The caller launches only with BH,
// Sq and Skv positive, BH <= 65535 and a bh's strips below 2^31.
extern "C" int dropout_apply(int dtype, unsigned long long seed,
                             unsigned int threshold, float d, float rcp, int BH,
                             int Sq, int Skv, const void* x, void* y, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_apply<F32>(seed, threshold, d, rcp, BH, Sq, Skv, x, y, s);
  if (dtype == 1) return launch_apply<BF16>(seed, threshold, d, rcp, BH, Sq, Skv, x, y, s);
  return -1;
}
