// Hopper (sm_90a) building blocks shared by the flash kernels
// (flash_fwd.cu, flash_bwd.cu): for the warp-specialised bf16 kernels
// mbarriers, TMA tile loads and stores, setmaxnreg, wgmma and its
// shared-memory descriptors in the 128-byte swizzle, and on the host the
// tensor maps those loads read; for the float32 kernels cp.async rings of
// padded rows, ldmatrix, and mma.sync in 3xTF32 with its fragment helpers.
//
// Layout every bf16 kernel here assumes: a tile of R rows of one (b, head) of a
// (B, S, H, D) bf16 tensor is D / 64 panels, each one TMA box of R rows x
// 64 columns (128 bytes a row) in the 128-byte swizzle, 1024-byte aligned.
// The same tile serves wgmma's K-major mode (D is the product's K) and its
// MN-major mode (the rows are K), so no operand is ever transposed.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (the encoder is looked up at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstdint>

namespace hopper {

constexpr int WG = 128;                    // threads of a warpgroup
// setmaxnreg budgets of a block of one producer and two consumer
// warpgroups, within the pool of 384 x 168 registers (168: what
// __launch_bounds__(384, 1) gives a thread): 128 * 24 + 256 * 240 = 64,512
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr uint32_t SMEM_MAX = 227 * 1024;  // a block's shared memory
constexpr uint32_t ROW_BYTES = 128;        // a panel row (8 rows: one swizzle atom)
constexpr uint32_t PANEL = 64 * ROW_BYTES;  // one 64-row panel: 64 rows x 64 bf16

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// --- mbarriers

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

// arrive and add `bytes` to the transactions the current phase waits for
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// wait until the phase of parity `parity` has completed (the consumers)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// the same for the producer, bounded: a wait of 10 s is a lost arrival, not
// a slow load, so it traps and the launch fails instead of hanging the card.
// (Only the producer may trap: a trap in the consumers' region makes ptxas
// allocate it within the launch bound's 168 registers, not setmaxnreg's.)
__device__ __forceinline__ void mbar_wait_or_trap(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  uint64_t t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t0));
  while (!mbar_try_wait(bar, parity)) {
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    if (t - t0 > 10000000000ull) __trap();
  }
}

// the producer's last wait: until the consumers have released the last
// STAGES of `iters` loads (so a consumer stuck on a load traps here too)
template <int STAGES>
__device__ __forceinline__ void drain(uint32_t bar_empty, int iters) {
  for (int it = iters > STAGES ? iters - STAGES : 0; it < iters; ++it)
    mbar_wait_or_trap(bar_empty + 8 * (it % STAGES), (it / STAGES) & 1);
}

// --- TMA

// one box of a 4-d tensor map (coordinates innermost first) into shared
// memory at `dst`, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// the D / 64 panels of an R-row tile starting at `row` of (b, head); the
// map's box is R rows
template <int D, int R = 64>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int head, int row, int b) {
#pragma unroll
  for (int pn = 0; pn < D / 64; ++pn)
    tma_load(dst + pn * R * ROW_BYTES, map, bar, pn * 64, head, row, b);
}

// one box from shared memory at `src` to the tensor (rows past the
// tensor's extent are not written); completes in this thread's bulk group
__device__ __forceinline__ void tma_store(uint32_t src, const CUtensorMap* map,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// the writing thread's generic-proxy stores to shared memory become
// visible to TMA (each writer, before the barrier that orders the store)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// this thread's TMA stores have finished reading shared memory
__device__ __forceinline__ void tma_store_wait() {
  asm volatile(
      "cp.async.bulk.commit_group;\n"
      "cp.async.bulk.wait_group.read 0;\n" ::
          : "memory");
}

// --- named barriers (0 is __syncthreads')

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// --- warpgroup register budgets

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// --- wgmma

// shared-memory matrix descriptor in the 128-byte swizzle (start address,
// leading and stride byte offsets in 16-byte units; layout type 1)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32 | 1ull << 62;
}

// K-major operand: a tile whose D columns are the product's K, in panels
// `panel` bytes apart; step kk is columns 16kk..16kk+15 (32 bytes into a
// panel row; 8-row groups 1024 bytes apart)
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk,
                                                uint32_t panel = PANEL) {
  return sw128_desc(tile + (kk / 4) * panel + (kk % 4) * 32, 16, 1024);
}

// MN-major operand: a tile whose rows are the product's K and whose D
// columns are N; step kk is rows 16kk..16kk+15 (8-row groups 1024 bytes
// apart, 64-column panels `panel` bytes apart)
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk,
                                                 uint32_t panel = PANEL) {
  return sw128_desc(tile + kk * 16 * ROW_BYTES, panel, 1024);
}

// 2^x on the SFU (ex2.approx.ftz: relative error ~2^-22, subnormals to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pins accumulator registers in place around asynchronous wgmma: code
// after a wait reads them only after it
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the same for A operands in registers: their registers stay untouched
// until the wait that precedes this
template <int N>
__device__ __forceinline__ void hold(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// d (+)= A B^T for a 64 x 64 tile: A (64 x 16) and B (64 x 16) both
// K-major in shared memory (descriptors); accumulate iff `accumulate`
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A B^T for a 64 x 128 tile: A (64 x 16) and B (128 x 16) both
// K-major in shared memory (descriptors); accumulate iff `accumulate`
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d = A B^T for a 64 x 128 tile, d's old value neither read nor kept:
// the first k-step of a product whose accumulator registers held other
// values (a read-write operand would keep them live until the issue)
__device__ __forceinline__ void wgmma_ss_n128_first(float (&d)[64], uint64_t da,
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "r"(0));
}

// d += A B for a 64 x 64 tile: A (64 x 16) from registers (the
// mma.sync A fragment layout, warp w holding rows 16w..16w+15), B (16 x 64)
// MN-major in shared memory (descriptor, transpose mode)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B for a 64 x 128 tile: A (64 x 16) from registers (the
// mma.sync A fragment layout, warp w holding rows 16w..16w+15), B (16 x 128)
// MN-major in shared memory (descriptor, transpose mode)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// two floats -> one register of two bf16 (the first in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// --- cp.async (the float32 kernels' rings)

// 16 bytes from global `src` to shared `dst`, or 16 zero bytes when !in
// (src is then not read, but must still be a valid address)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

// the same for 4 bytes (any 4-byte aligned address)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// `rows` rows of D floats from global `src` (row stride `stride` floats,
// 16-byte aligned rows) into shared memory at `dst` (row pitch D + 4
// floats), 16 bytes a copy spread over THREADS threads; rows at or past
// `valid` are zero-filled. Each thread's copies are those with index
// tid + k * THREADS: `scale_rows` touches the same ones.
template <int D, int THREADS>
__device__ __forceinline__ void load_rows(uint32_t dst, const float* src, long long stride,
                                          int rows, int valid, int tid) {
  constexpr int CH = D / 4;  // 16-byte chunks a row
  for (int c = tid; c < rows * CH; c += THREADS) {
    const int r = c / CH;
    const int col = (c - r * CH) * 4;
    const bool in = r < valid;
    cp_async16(dst + 4u * (r * (D + 4) + col), in ? src + r * stride + col : src, in);
  }
}

// this thread's chunks of `load_rows` (landed: after its wait) times s
template <int D, int THREADS>
__device__ __forceinline__ void scale_rows(float* tile, int rows, float s, int tid) {
  constexpr int CH = D / 4;
  for (int c = tid; c < rows * CH; c += THREADS) {
    const int r = c / CH;
    float4* x = reinterpret_cast<float4*>(tile + r * (D + 4) + (c - r * CH) * 4);
    float4 v = *x;
    v.x *= s;
    v.y *= s;
    v.z *= s;
    v.w *= s;
    *x = v;
  }
}

// --- mma.sync m16n8k8 in 3xTF32 (the float32 kernels)
//
// Fragments of mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32 for lane l,
// g = l / 4, t = l % 4: A (16 x 8) a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); B (8 x 8, k x n) b0 (t, g), b1 (t + 4, g); C (16 x 8)
// c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
// A float32 x enters as big = x rounded to tf32 (nearest, ties away) and
// small = x - big (exact), each read by the tensor cores as tf32; a
// product is big·small + small·big + big·big, so each operand carries ~21
// bits and a product errs by ~2^-21 relative, where one tf32 product errs
// by ~2^-11. The tensor cores truncate their float32 accumulator at each
// product, so the small terms go to an accumulator of their own (`e`,
// ~2^-11 of the sum: its truncation is lost in the sum's rounding), and
// a long sum (o over kv tiles, dk and dv over q tiles) is kept in
// registers and takes each tile's product by an ordinary float add.
//
// A C fragment is reused as the A operand of the next product without
// shared memory: its column pair (2t, 2t + 1) is taken as A's k indices
// (t, t + 4) — a0 = c0, a1 = c2, a2 = c1, a3 = c3 (`c_as_a`) — and that
// product's B is read from the same permuted rows (2t, 2t + 1): the sum
// over k does not depend on its order.

struct Tf32A {  // an A fragment, split
  uint32_t big[4], small[4];
};

struct Tf32B {  // a B fragment, split
  uint32_t big[2], small[2];
};

// x's two tf32 parts as bits, in three instructions (two cvt.rna.tf32.f32
// and a subtraction compiled to about seven, with the conversions' NaN and
// infinity tests). big adds half a tf32 ulp to x's bits
// and clears the 13 bits tf32 drops; small = x - big is exact, and the
// tensor cores drop its low 13 bits (|small| <= 2^-11 |x|, so that costs
// at most 2^-21 |x|). |x| within 2^128 (1 - 2^-12); NaN stays NaN.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

template <int N>
__device__ __forceinline__ void split_tf32(const uint32_t (&x)[N], uint32_t (&big)[N],
                                           uint32_t (&small)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split_tf32(__uint_as_float(x[i]), big[i], small[i]);
}

// an accumulator fragment (C layout) as the A operand of a product over
// its columns, split
__device__ __forceinline__ Tf32A c_as_a(const float (&c)[4]) {
  Tf32A a;
  const float x[4] = {c[0], c[2], c[1], c[3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(x[i], a.big[i], a.small[i]);
  return a;
}

// two floats of shared memory `lo` and `hi` as a split B fragment
__device__ __forceinline__ Tf32B b_of(float lo, float hi) {
  Tf32B b;
  split_tf32(lo, b.big[0], b.small[0]);
  split_tf32(hi, b.big[1], b.small[1]);
  return b;
}

// the split B fragments of two n8 tiles from an ldmatrix_x4 of n rows x
// k columns (matrices 0, 1: tile 0's k 0..3 and 4..7; 2, 3: tile 1's)
__device__ __forceinline__ void b_frags(const uint32_t (&y)[4], Tf32B& b0, Tf32B& b1) {
  b0 = b_of(__uint_as_float(y[0]), __uint_as_float(y[1]));
  b1 = b_of(__uint_as_float(y[2]), __uint_as_float(y[3]));
}

// four 8 x 8 b16 matrices (here 8 x 4 float32 each) from shared memory:
// lane l gives the address of row l % 8 of matrix l / 8 and receives
// element (l / 4, l % 4) of each matrix
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a b, one tf32 product
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d + e += a b in 3xTF32: big·big into d, the small terms into e
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], float (&e)[4], const Tf32A& a,
                                           const Tf32B& b) {
  mma_tf32(e, a.small, b.big[0], b.big[1]);
  mma_tf32(e, a.big, b.small[0], b.small[1]);
  mma_tf32(d, a.big, b.big[0], b.big[1]);
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) x[i][c] = 0.f;
}

// --- host: tensor maps (static: each kernel library keeps its own copy)

// cuTensorMapEncodeTiled, from libcuda.so.1, which the process has loaded
// (the runtime library exports no tensor-map encoder; looked up once)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(
                                dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// tensor map of a bf16 (B, S, H, D) tensor with unit stride on D and
// element strides sb, ss, sh on the others (each a positive multiple of 8
// elements: 16 bytes), base 16-byte aligned: boxes of `rows` rows of one
// (b, head) by 64 columns, 128-byte swizzle; rows past S read as zeros and
// are not written
static inline bool bsnh_map(CUtensorMap* map, const void* x, int B, int S, int H,
                            int D, long long sb, long long ss, long long sh,
                            int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {2ull * sh, 2ull * ss, 2ull * sb};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x),
                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the same for a contiguous (B, S, H, D) tensor
static inline bool bsnh_map(CUtensorMap* map, const void* x, int B, int S, int H,
                            int D, int rows) {
  const long long sh = D, ss = static_cast<long long>(H) * D;
  return bsnh_map(map, x, B, S, H, D, ss * S, ss, sh, rows);
}

constexpr int NO_TENSOR_MAP = -2;  // no tensor map could be encoded

}  // namespace hopper
