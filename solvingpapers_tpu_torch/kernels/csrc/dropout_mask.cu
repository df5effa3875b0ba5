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
//     the gradient: the map is its own derivative). The division is IEEE
//     float32 (__fdiv_rn) of float(x) by float32(1 - rate), rounded to x's
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
// vector stores (one a row in mask mode) and loads. Apply mode issues its
// loads before the Philox work so the memory latency hides under it. Ragged
// edges (Skv not a multiple of 16, Sq not one of 16, a row base off 16
// bytes) take element-wise accesses. The grid is one block row per bh and
// enough 128-thread blocks for every strip: 2048 blocks at (1, 16384, 512),
// many waves on 132 SMs.

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

// element types of apply mode, as bits: float32 and bfloat16
struct F32 {
  using Bits = uint32_t;
  static __device__ __forceinline__ float load(Bits b) { return __uint_as_float(b); }
  static __device__ __forceinline__ Bits store(float f) { return __float_as_uint(f); }
};

struct BF16 {
  using Bits = uint16_t;
  static __device__ __forceinline__ float load(Bits b) {
    return __uint_as_float(static_cast<uint32_t>(b) << 16);
  }
  static __device__ __forceinline__ Bits store(float f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
};

// 16-byte vectors of a strip row of 16 elements
template <typename E>
__host__ __device__ constexpr int row_vecs() {
  return STRIP * sizeof(typename E::Bits) / 16;
}

// a strip row, as its elements or its 16-byte vectors
template <typename E>
union RowVec {
  uint4 v[row_vecs<E>()];
  typename E::Bits e[STRIP];
};

template <typename E>
__device__ __forceinline__ typename E::Bits drop1(typename E::Bits x, bool keep,
                                                  float denom) {
  return E::store(keep ? __fdiv_rn(E::load(x), denom) : 0.f);
}

template <typename E>
__global__ void __launch_bounds__(THREADS)
    dropout_apply_kernel(unsigned long long seed, uint32_t threshold, float denom,
                         int Sq, int Skv, int strips_per_row, int strips,
                         const typename E::Bits* x, typename E::Bits* y) {
  constexpr int VECS = row_vecs<E>();
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= strips) return;
  const int bh = blockIdx.y;
  const Strip st = strip_of(t, strips_per_row);
  long long off[2];
  bool vec[2];
  RowVec<E> in[2];
  // whole, aligned rows: load before the Philox work
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = st.r + 8 * i;
    off[i] = (static_cast<long long>(bh) * Sq + row) * Skv + st.c0;
    vec[i] = row < Sq && st.c0 + STRIP <= Skv && aligned16(x + off[i]) &&
             aligned16(y + off[i]);
    if (vec[i]) {
      const uint4* src = reinterpret_cast<const uint4*>(x + off[i]);
#pragma unroll
      for (int u = 0; u < VECS; ++u) in[i].v[u] = src[u];
    }
  }
  const StripKeep s = strip_keep(seed, bh, st.r, st.c0, threshold);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (vec[i]) {
      RowVec<E> out;
#pragma unroll
      for (int j = 0; j < STRIP; ++j)
        out.e[j] = drop1<E>(in[i].e[j], kept(s, i, j), denom);
      uint4* dst = reinterpret_cast<uint4*>(y + off[i]);
#pragma unroll
      for (int u = 0; u < VECS; ++u) dst[u] = out.v[u];
    } else if (st.r + 8 * i < Sq) {
#pragma unroll
      for (int j = 0; j < STRIP; ++j)
        if (st.c0 + j < Skv)
          y[off[i] + j] = drop1<E>(x[off[i] + j], kept(s, i, j), denom);
    }
  }
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

// y = keep(seed, bh, row, col) ? x / denom : 0 over contiguous (BH, Sq, Skv)
// x and y of dtype 0 (float32) or 1 (bfloat16), denom = float32(1 - rate).
// Returns 0 on success, -1 for another dtype, or the CUDA error code of a
// refused launch. The caller launches only with BH, Sq and Skv positive,
// BH <= 65535 and a bh's strips below 2^31.
extern "C" int dropout_apply(int dtype, unsigned long long seed,
                             unsigned int threshold, float denom, int BH, int Sq,
                             int Skv, const void* x, void* y, void* stream) {
  const int strips = strips_of(Sq, Skv);
  const dim3 grid((strips + THREADS - 1) / THREADS, BH);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    dropout_apply_kernel<F32><<<grid, THREADS, 0, s>>>(
        seed, threshold, denom, Sq, Skv, strips_per_row(Skv), strips,
        static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y));
  } else if (dtype == 1) {
    dropout_apply_kernel<BF16><<<grid, THREADS, 0, s>>>(
        seed, threshold, denom, Sq, Skv, strips_per_row(Skv), strips,
        static_cast<const uint16_t*>(x), static_cast<uint16_t*>(y));
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
