// How fast one H100 SM issues IMAD.HI.U32 (the high 32 bits of a 32x32-bit
// product, plus an addend): the instruction a Philox product takes when it
// is split into mul.hi.u32 + mul.lo.u32 (IMAD.HI + IMAD) instead of one
// IMAD.WIDE.U32. The method of probes/int_mul_rate.cu: each thread runs
// CHAINS independent chains of 4 * iters steps a = hi(a * M) + b; a block
// times its loop with clock64 between two barriers and writes the cycles.
// Launched with one 1024-thread block per SM, an SM's rate is THREADS *
// CHAINS * 4 * iters / cycles a clock. Plain C interface, called by
// probes/dropout_apply_ab.py; the chains' ends go to `sink`.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 1024;
constexpr int CHAINS = 8;
constexpr uint32_t M = 0xD2511F53u;  // Philox's first round multiplier

__global__ void __launch_bounds__(THREADS)
    imad_hi_kernel(int iters, long long* cycles, uint32_t* sink) {
  uint32_t a[CHAINS], b[CHAINS];
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) {
    a[j] = (blockIdx.x * THREADS + threadIdx.x) * CHAINS + j;
    b[j] = a[j] ^ 0x9E3779B9u;
  }
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int j = 0; j < CHAINS; ++j) a[j] = __umulhi(a[j], M) + b[j];
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  uint32_t x = 0;
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) x ^= a[j];
  sink[blockIdx.x * THREADS + threadIdx.x] = x;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

}  // namespace

// `cycles` holds `blocks` int64, `sink` blocks * 1024 uint32. Returns 0 or
// the CUDA error of the launch.
extern "C" int imad_hi_rate(int blocks, int iters, void* cycles, void* sink,
                            void* stream) {
  imad_hi_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      iters, static_cast<long long*>(cycles), static_cast<uint32_t*>(sink));
  return static_cast<int>(cudaGetLastError());
}
