// Dropout keep mask for Hopper (sm_90a), CUDA C++ with a plain C interface
// (built by kernels/build.py with nvcc, bound with ctypes in
// kernels/dropout.py).
//
// Replaces the test-only Pallas kernel `mask_kernel`
// (tests/test_flash_dropout_tpu.py, pallas_call at line 120) that reads the
// TPU kernels' keep mask out through `_dropout_keep`
// (solvingpapers_tpu/kernels/flash_attention.py:60-70): it writes the keep
// mask of philox.cuh — the one the flash kernels draw inside — for a
// (BH, Sq, Skv) region as bytes (1 = keep). The port uses it as the dense
// paths' attention-prob mask and as the residual dropout's mask, and the
// checks hold it bit for bit against the plain PyTorch keep function.
//
// Design: one thread per 2x2 Philox group {row, row ^ 8} x {col, col ^ 8}:
// one Philox4x32-10 call gives the four words, masked at the ragged edges.
// What bounds it on an H100: it writes one byte per element and reads
// nothing, so the bound is the bytes written over HBM bandwidth; the ten
// Philox rounds (about 100 integer operations per four elements) run on the
// CUDA cores' 32-bit integer pipes and cost more than the store at a high
// load, so it runs above that bound. No design effort beyond coalescing:
// neighbouring threads write neighbouring columns.

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
    dropout_mask_kernel(unsigned long long seed, uint32_t threshold, int Sq,
                        int Skv, int col_groups, uint8_t* out) {
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
// CUDA error code of a refused launch. The caller launches only with BH,
// Sq and Skv positive, BH <= 65535 and Sq <= 2 * 65535.
extern "C" int dropout_mask(unsigned long long seed, unsigned int threshold,
                            int BH, int Sq, int Skv, void* out, void* stream) {
  const int col_groups = groups(Skv);
  const dim3 grid((col_groups + THREADS - 1) / THREADS, groups(Sq), BH);
  dropout_mask_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      seed, threshold, Sq, Skv, col_groups, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
