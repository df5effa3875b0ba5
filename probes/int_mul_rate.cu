// How fast one H100 SM issues the two integer multiplies Philox4x32-10
// compiles to: IMAD (32-bit, a = a * M + b) and IMAD.WIDE.U32 (32x32->64
// plus a 64-bit addend, p = lo(p) * M + p). Plain C interface, called by
// probes/dropout_ab.py.
//
// Each thread runs CHAINS independent chains of 4 * iters steps of one
// form; a block times its loop with clock64 between two barriers and
// writes the cycles. Launched with one 1024-thread block per SM, an SM's
// rate is THREADS * CHAINS * 4 * iters / cycles multiplies a clock. The
// chains' ends go to `sink` so the compiler keeps the work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 1024;
constexpr int CHAINS = 8;
constexpr uint32_t M = 0xD2511F53u;  // Philox's first round multiplier

template <bool WIDE>
__global__ void __launch_bounds__(THREADS)
    mul_rate_kernel(int iters, long long* cycles, uint32_t* sink) {
  uint32_t a[CHAINS], b[CHAINS];
  uint64_t p[CHAINS];
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) {
    a[j] = (blockIdx.x * THREADS + threadIdx.x) * CHAINS + j;
    b[j] = a[j] ^ 0x9E3779B9u;
    p[j] = (static_cast<uint64_t>(b[j]) << 32) | a[j];
  }
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int j = 0; j < CHAINS; ++j) {
        if (WIDE)
          p[j] = static_cast<uint64_t>(static_cast<uint32_t>(p[j])) * M + p[j];
        else
          a[j] = a[j] * M + b[j];
      }
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  uint32_t x = 0;
#pragma unroll
  for (int j = 0; j < CHAINS; ++j)
    x ^= WIDE ? static_cast<uint32_t>(p[j] ^ (p[j] >> 32)) : a[j];
  sink[blockIdx.x * THREADS + threadIdx.x] = x;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

}  // namespace

// wide = 0: IMAD, 1: IMAD.WIDE.U32. `cycles` holds `blocks` int64,
// `sink` blocks * 1024 uint32. Returns 0 or the CUDA error of the launch.
extern "C" int mul_rate(int wide, int blocks, int iters, void* cycles, void* sink,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide)
    mul_rate_kernel<true><<<blocks, THREADS, 0, s>>>(
        iters, static_cast<long long*>(cycles), static_cast<uint32_t*>(sink));
  else
    mul_rate_kernel<false><<<blocks, THREADS, 0, s>>>(
        iters, static_cast<long long*>(cycles), static_cast<uint32_t*>(sink));
  return static_cast<int>(cudaGetLastError());
}
