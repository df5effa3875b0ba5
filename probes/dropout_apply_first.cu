// The dropout apply kernel's first design, kept as a probe copy so that
// the redesign (solvingpapers_tpu_torch/kernels/csrc/dropout_mask.cu, apply
// mode) can be timed beside it in one process (probes/dropout_apply_ab.py,
// chip_smoke.py's "kernels: dropout times"). Built as the port's kernels
// are, with kernels/csrc on the include path for philox.cuh.
//
// Its design: one 2-row x 16-column strip a thread (the same strips and
// Philox groups as the redesign), the strip's loads issued before its 8
// Philox calls, the keep flags packed into bytes and unpacked again per
// element, and each kept element divided by an IEEE division (__fdiv_rn);
// one block row per bh with enough 128-thread blocks for every strip, and
// element-wise accesses for a whole ragged strip.

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
    dropout_apply_first_kernel(unsigned long long seed, uint32_t threshold, float denom,
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

// y = keep(seed, bh, row, col) ? x / denom : 0 over contiguous (BH, Sq, Skv)
// x and y of dtype 0 (float32) or 1 (bfloat16), denom = float32(1 - rate).
// Returns 0 on success, -1 for another dtype, or the CUDA error code of a
// refused launch. The caller launches only with BH, Sq and Skv positive,
// BH <= 65535 and a bh's strips below 2^31.
extern "C" int dropout_apply_first(int dtype, unsigned long long seed,
                             unsigned int threshold, float denom, int BH, int Sq,
                             int Skv, const void* x, void* y, void* stream) {
  const int strips = strips_of(Sq, Skv);
  const dim3 grid((strips + THREADS - 1) / THREADS, BH);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    dropout_apply_first_kernel<F32><<<grid, THREADS, 0, s>>>(
        seed, threshold, denom, Sq, Skv, strips_per_row(Skv), strips,
        static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y));
  } else if (dtype == 1) {
    dropout_apply_first_kernel<BF16><<<grid, THREADS, 0, s>>>(
        seed, threshold, denom, Sq, Skv, strips_per_row(Skv), strips,
        static_cast<const uint16_t*>(x), static_cast<uint16_t*>(y));
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
