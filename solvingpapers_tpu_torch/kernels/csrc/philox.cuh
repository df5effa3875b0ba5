// The port's dropout keep function, shared by the flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu) and the mask kernel (dropout_mask.cu); its
// plain PyTorch twin is kernels/dropout.py::dropout_keep_reference.
//
// Replaces solvingpapers_tpu/kernels/flash_attention.py `_dropout_keep`
// (and the tile uid `_uid` that seeds it): the TPU kernels draw their keep
// mask from the TPU's hardware PRNG seeded per (q-block, kv-block) tile, so
// the mask depends on the tile sizes and cannot be reproduced off the TPU.
// Here the mask is a pure function of (seed, bh, row, col):
//
//   keep(seed, bh, row, col) = word(seed, bh, row, col) < threshold
//   threshold = min(int((1 - rate) * 2^32), 2^32 - 1)   (the reference's)
//
// where `word` is one 32-bit output of Philox4x32-10 (Random123) with key
// (seed low word, seed high word) and counter (row & ~8, col & ~8, bh, 0):
// one Philox call covers the 2x2 group {row, row ^ 8} x {col, col ^ 8}, and
// the element takes word 2 * bit3(row) + bit3(col). That grouping is the
// one that every mma.sync m16n8k16 thread holds whole in both the (q rows x
// kv columns) layout of the forward and dq kernels and the transposed
// (kv rows x q columns) layout of the dk/dv kernel, so each thread spends
// one Philox call on four of its own elements; the mask depends on neither
// block sizes nor loop order. `bh` is the q head, b * N + h; row and col are
// absolute q and kv indices of the call.

#pragma once

#include <cstdint>

namespace dropout {

struct Words {
  uint32_t w[4];
};

// Philox4x32 with 10 rounds (Random123's philox4x32_10). WIDE writes each
// product as PTX's mul.wide.u32; otherwise ptxas picks the form (IMAD.WIDE.U32,
// or IMAD.HI.U32 + IMAD, which an H100 issues more slowly: probes/imad_hi_rate.cu)
template <bool WIDE = false>
__device__ __forceinline__ Words philox4x32_10(uint32_t c0, uint32_t c1,
                                               uint32_t c2, uint32_t c3,
                                               uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    uint32_t lo0, hi0, lo1, hi1;
    if constexpr (WIDE) {  // one 32x32->64-bit product each (IMAD.WIDE.U32)
      uint64_t p0, p1;
      asm("mul.wide.u32 %0, %1, %2;" : "=l"(p0) : "r"(c0), "n"(0xD2511F53u));
      asm("mul.wide.u32 %0, %1, %2;" : "=l"(p1) : "r"(c2), "n"(0xCD9E8D57u));
      lo0 = static_cast<uint32_t>(p0);
      hi0 = static_cast<uint32_t>(p0 >> 32);
      lo1 = static_cast<uint32_t>(p1);
      hi1 = static_cast<uint32_t>(p1 >> 32);
    } else {
      lo0 = 0xD2511F53u * c0;
      hi0 = __umulhi(0xD2511F53u, c0);
      lo1 = 0xCD9E8D57u * c2;
      hi1 = __umulhi(0xCD9E8D57u, c2);
    }
    const uint32_t n0 = hi1 ^ c1 ^ k0;
    const uint32_t n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return Words{{c0, c1, c2, c3}};
}

// the four words of the 2x2 group that holds (row, col)
template <bool WIDE = false>
__device__ __forceinline__ Words group_words(unsigned long long seed,
                                             uint32_t bh, uint32_t row,
                                             uint32_t col) {
  return philox4x32_10<WIDE>(row & ~8u, col & ~8u, bh, 0u,
                       static_cast<uint32_t>(seed),
                       static_cast<uint32_t>(seed >> 32));
}

__device__ __forceinline__ bool keep(unsigned long long seed, uint32_t bh,
                                     uint32_t row, uint32_t col,
                                     uint32_t threshold) {
  const Words g = group_words(seed, bh, row, col);
  return g.w[((row >> 3) & 1u) * 2u + ((col >> 3) & 1u)] < threshold;
}

// Keep bits of one mma.sync thread's 16 x 64 score slice in the (q rows x
// kv columns) layout of the forward and dq kernels: element [nt][2i + j]
// is q row `row0 + 8i` and kv column `col0 + 8nt + j`, where row0 = the
// warp's first row + g and col0 = the tile's first column + 2t (row0 has
// bit 3 clear, col0 a multiple of 16 plus 2t). Bit nt * 4 + 2i + j.
__device__ __forceinline__ uint32_t keep_bits_rows(unsigned long long seed,
                                                   uint32_t bh, uint32_t row0,
                                                   uint32_t col0,
                                                   uint32_t threshold) {
  uint32_t bits = 0;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const Words g = group_words(seed, bh, row0, col0 + 16 * m + j);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (g.w[2 * i + h] < threshold)
            bits |= 1u << ((2 * m + h) * 4 + 2 * i + j);
    }
  return bits;
}

// The same for the dk/dv kernel's transposed (kv rows x q columns) slice:
// element [nt][2i + j] is kv column `kv0 + 8i` and q row `q0 + 8nt + j`,
// where kv0 = the tile's first kv row + the warp's offset + g and q0 = the
// q tile's first row + 2t. Bit nt * 4 + 2i + j.
__device__ __forceinline__ uint32_t keep_bits_cols(unsigned long long seed,
                                                   uint32_t bh, uint32_t q0,
                                                   uint32_t kv0,
                                                   uint32_t threshold) {
  uint32_t bits = 0;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const Words g = group_words(seed, bh, q0 + 16 * m + j, kv0);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (g.w[2 * h + i] < threshold)
            bits |= 1u << ((2 * m + h) * 4 + 2 * i + j);
    }
  return bits;
}

}  // namespace dropout
