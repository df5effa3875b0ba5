// The dropout apply kernel of solvingpapers_tpu_torch/kernels/csrc/
// dropout_mask.cu in forms that it does not take, for
// probes/dropout_apply_ab.py, which times them beside it in one process.
// Built as the port's kernels are, with kernels/csrc on the include path:
// this file includes the kernel's source whole and reuses its strip
// loads, quotient and stores (`load_strip`, `apply_strip`), so every form
// computes the same result and differs only in:
//   WIDE        Philox's products as mul.wide.u32 (IMAD.WIDE.U32, the
//               kernel's form), else as ptxas picks (IMAD.HI.U32 + IMAD);
//   PERSISTENT  a grid of the resident blocks split over the bhs, each
//               thread walking its bh's strips with the next one's loads
//               issued before the current one's Philox work, else a
//               strip a thread (the kernel's form);
//   PREFETCH    (persistent) the strip after next prefetched into L2;
//   MIN_BLOCKS  the launch bounds' blocks an SM (1, the kernel's: no
//               register cap).

#include "dropout_mask.cu"

namespace {

// the rows of strip `st` that lie in the region, prefetched into L2
template <typename E>
__device__ __forceinline__ void prefetch_strip(const Strip& st, int bh, int Sq,
                                               int Skv, const typename E::Bits* x) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = st.r + 8 * i;
    if (row < Sq)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(
          x + (static_cast<long long>(bh) * Sq + row) * Skv + st.c0));
  }
}

template <typename E, bool WIDE>
__device__ __forceinline__ void philox_apply(const StripData<E>& s, const Strip& st,
                                             int bh, unsigned long long seed,
                                             uint32_t threshold, float d, float rcp,
                                             typename E::Bits* y) {
  dropout::Words g[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) g[j] = dropout::group_words<WIDE>(seed, bh, st.r, st.c0 + j);
  apply_strip(s, g, threshold, d, rcp, d >= 0x1p-20f, y);
}

template <typename E, bool WIDE, bool PERSISTENT, bool PREFETCH, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    dropout_apply_form_kernel(unsigned long long seed, uint32_t threshold, float d,
                              float rcp, int Sq, int Skv, int strips_per_row,
                              int strips, const typename E::Bits* x,
                              typename E::Bits* y) {
  int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= strips) return;
  const int bh = blockIdx.y;
  Strip st = strip_of(t, strips_per_row);
  StripData<E> cur;
  load_strip(cur, st, bh, Sq, Skv, x, y);
  if constexpr (!PERSISTENT) {
    philox_apply<E, WIDE>(cur, st, bh, seed, threshold, d, rcp, y);
  } else {
    const int stride = gridDim.x * THREADS;
    for (;;) {
      const bool more = static_cast<long long>(t) + stride < strips;
      const int next = more ? t + stride : t;
      const Strip nst = more ? strip_of(next, strips_per_row) : st;
      StripData<E> nxt;
      if (more) load_strip(nxt, nst, bh, Sq, Skv, x, y);
      if constexpr (PREFETCH) {
        if (static_cast<long long>(next) + stride < strips)
          prefetch_strip<E>(strip_of(next + stride, strips_per_row), bh, Sq, Skv, x);
      }
      philox_apply<E, WIDE>(cur, st, bh, seed, threshold, d, rcp, y);
      if (!more) break;
      cur = nxt;
      st = nst;
      t = next;
    }
  }
}

template <typename E, bool WIDE, bool PERSISTENT, bool PREFETCH, int MIN_BLOCKS>
int launch_form(unsigned long long seed, uint32_t threshold, float d, float rcp,
                int BH, int Sq, int Skv, const void* x, void* y, cudaStream_t s) {
  auto kernel = dropout_apply_form_kernel<E, WIDE, PERSISTENT, PREFETCH, MIN_BLOCKS>;
  const int strips = strips_of(Sq, Skv);
  int blocks_x = (strips + THREADS - 1) / THREADS;
  if (PERSISTENT) {
    int per_sm = 0, sms = 0, dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return -2;
    blocks_x = min(blocks_x, max(1, per_sm * sms / BH));
  }
  kernel<<<dim3(blocks_x, BH), THREADS, 0, s>>>(
      seed, threshold, d, rcp, Sq, Skv, strips_per_row(Skv), strips,
      static_cast<const typename E::Bits*>(x), static_cast<typename E::Bits*>(y));
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int launch_any(int wide, int persistent, int prefetch, int min_blocks,
               unsigned long long seed, uint32_t threshold, float d, float rcp,
               int BH, int Sq, int Skv, const void* x, void* y, cudaStream_t s) {
#define FORM(W, P, F, M)                                                          \
  if (wide == W && persistent == P && prefetch == F && min_blocks == M)           \
    return launch_form<E, W, P, F, M>(seed, threshold, d, rcp, BH, Sq, Skv, x, y, s);
  FORM(1, 1, 0, 1) FORM(1, 1, 1, 1) FORM(1, 1, 0, 4) FORM(0, 1, 0, 1)
  FORM(0, 1, 1, 1) FORM(1, 0, 0, 1) FORM(1, 0, 0, 4) FORM(0, 0, 0, 1)
#undef FORM
  return -1;
}

}  // namespace

// The kernel with Philox's products as mul.wide.u32 (wide 1) or as ptxas
// picks (0), a persistent grid (1) or a strip a thread (0), the strip
// after next prefetched into L2 (1) or not, and launch bounds of
// `min_blocks` blocks an SM, in the combinations FORM lists. Arguments
// otherwise as dropout_apply's; returns -1 for a form not listed, -2 when
// the occupancy cannot be read.
extern "C" int dropout_apply_form(int dtype, int wide, int persistent, int prefetch,
                                  int min_blocks, unsigned long long seed,
                                  unsigned int threshold, float d, float rcp, int BH,
                                  int Sq, int Skv, const void* x, void* y,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_any<F32>(wide, persistent, prefetch, min_blocks, seed, threshold, d,
                           rcp, BH, Sq, Skv, x, y, s);
  if (dtype == 1)
    return launch_any<BF16>(wide, persistent, prefetch, min_blocks, seed, threshold, d,
                            rcp, BH, Sq, Skv, x, y, s);
  return -1;
}
