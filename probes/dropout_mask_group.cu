// The dropout keep-mask kernel's earlier design, kept to time it beside the
// current one (kernels/csrc/dropout_mask.cu) on the same card in one run:
// probes/dropout_ab.py builds and calls it. Same keep function (philox.cuh),
// same plain C interface, other names.
//
// Design: one thread per 2x2 Philox group {row, row ^ 8} x {col, col ^ 8}:
// one Philox4x32-10 call gives the four words, each written as a single
// byte (two rows, two columns 8 apart), masked at the ragged edges; a
// warp's store instruction writes 32 scattered bytes.

#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int THREADS = 256;

// group index g along an axis -> its first element (bit 3 clear)
__device__ __forceinline__ int group_first(int g) {
  return (g >> 3) * 16 + (g & 7);
}

__global__ void __launch_bounds__(THREADS)
    dropout_mask_group_kernel(unsigned long long seed, uint32_t threshold,
                              int Sq, int Skv, int col_groups, uint8_t* out) {
  const int cg = blockIdx.x * THREADS + threadIdx.x;
  if (cg >= col_groups) return;
  const int rg = blockIdx.y;
  const int bh = blockIdx.z;
  const int row = group_first(rg);
  const int col = group_first(cg);
  const dropout::Words g = dropout::group_words(seed, bh, row, col);
  uint8_t* base = out + (static_cast<long long>(bh) * Sq) * Skv;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row + 8 * i;
    if (r >= Sq) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = col + 8 * h;
      if (c < Skv)
        base[static_cast<long long>(r) * Skv + c] = g.w[2 * i + h] < threshold;
    }
  }
}

// groups along an axis of `n` elements: n rounded up to 16, halved
int groups(int n) { return (n + 15) / 16 * 8; }

}  // namespace

// Writes keep(seed, bh, row, col) for bh < BH, row < Sq, col < Skv into the
// contiguous (BH, Sq, Skv) byte array `out`. Returns 0 on success or the
// CUDA error code of a refused launch. BH <= 65535, Sq <= 2 * 65535.
extern "C" int dropout_mask_group(unsigned long long seed, unsigned int threshold,
                                  int BH, int Sq, int Skv, void* out,
                                  void* stream) {
  const int col_groups = groups(Skv);
  const dim3 grid((col_groups + THREADS - 1) / THREADS, groups(Sq), BH);
  dropout_mask_group_kernel<<<grid, THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      seed, threshold, Sq, Skv, col_groups, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
