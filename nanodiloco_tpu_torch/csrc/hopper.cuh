// PTX building blocks for Hopper (sm_90a) kernels: shared-memory addresses,
// mbarriers, TMA tile loads, wgmma with shared-memory descriptors and partial
// waits, warp specialisation (setmaxnreg, named barriers), bf16
// fragments in registers, cp.async, three-product TF32 on mma.sync, the
// second pass of a backward launch split into parts, and the host-side TMA
// descriptor encoder.
//
// Tiles are bf16 rows of N = 256, 128, 96, 64 or 32 elements (the tile's
// width: the head dim, or 96 for an hd-80 tensor, whose columns 80-95 TMA
// fills with zeros), loaded by TMA in boxes of SW / 2 columns with a swizzle
// as wide as a box row: SW = 128 bytes where N is a multiple of 64 (256,
// 128, 64), 64 bytes where it is not (96, 32; a 192-byte row of hd 96 is no
// whole number of 128-byte atoms, so it is three 64-byte ones, as CUTLASS's
// shared-memory selector picks for a 96-wide major dimension). Row r of a box lies at byte
// SW * r, its 16-byte chunks permuted by (r * SW / 128) % 8, and every box
// starts on a 1024-byte boundary. A row is N * 2 / SW boxes (4 at N 256, 2 at
// 128, 3 at 96, 1 at 64 and 32), box b at + b * box_bytes.
// wgmma reads these tiles through descriptors in the matching layout (type
// 1 for the 128-byte swizzle, 2 for the 64-byte one):
//   K-major operand (the reduction axis contiguous, e.g. Q or K in Q K^T):
//     LBO unused (16 bytes), SBO = 8 * SW bytes (the next 8 rows); k-slice kk
//     of 16 elements (32 bytes) starts at box(kk / (SW / 32)) +
//     32 * (kk % (SW / 32)) bytes.
//   MN-major operand (the output axis contiguous, e.g. V in P V, with
//     trans-b = 1): LBO = box_bytes (from one box's SW / 2 output columns to
//     the next: columns 0-63 to 64-127 at N 128; 0-31 to 32-63 to 64-95 at
//     N 96, where layout type 2 first steps by LBO), SBO = 8 * SW bytes (the
//     next 8 reduction rows); k-slice kk of 16 rows starts at 16 * SW * kk
//     bytes.
// The f32 accumulator of m64nNk16 gives thread t of the warpgroup (warp
// w = t / 32, lane l) rows 16 w + l / 4 + 8 h (h = 0, 1) and, for register
// i < N / 2, row half h = (i / 2) % 2 and column 8 (i / 4) + 2 (l % 4) + i % 2.
// Registers 8 kk .. 8 kk + 7, packed to bf16 pairs in order, are exactly the
// A fragment of k-slice kk of an RS wgmma, so a score tile becomes the left
// operand of the next product without leaving registers.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the driver
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// One arrival that also announces `bytes` of TMA traffic to wait for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Spin until the phase of parity `parity` has completed. A phase that never
// completes (a lost arrival or a wrong byte count) ends the kernel with an
// error after ~2^31 polls instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint32_t polls = 0;
  do {
    if (++polls == 0x80000000u) asm volatile("trap;");
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// mbar_wait with the trap of its timeout in a function of its own. In a
// kernel that raises its registers with setmaxnreg_inc, an inline trap on the
// wait's path left ptxas allocating the consumers within the launch's count
// (168 at 384 threads: spills, serialized wgmma); a call keeps the timeout.
__device__ __noinline__ void mbar_timeout() { asm volatile("trap;"); }
__device__ __forceinline__ void mbar_wait_outlined(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint32_t polls = 0;
  do {
    if (++polls == 0x80000000u) mbar_timeout();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ---------------------------------------------------------------------------
// TMA: one box of a 3-D tensor map {c0 (innermost), c1, c2} into shared
// memory; completion is reported to `bar` as transaction bytes. Elements
// outside the tensor are written as zeros.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// wgmma.wait_group N: wait until at most N of this warpgroup's committed
// groups are still in flight. Groups complete in the order they were
// committed, so with two in flight wgmma_wait<1>() waits for the older one
// alone. A register of a group still in flight is neither read nor written
// until a wait covers it (fence_regs after the wait keeps the compiler to it).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// Warp specialisation
// ---------------------------------------------------------------------------
// setmaxnreg.{dec,inc}.sync.aligned.u32 R: lower (dec) or raise (inc) the
// per-thread register limit of the executing warpgroup to R (24..256, a
// multiple of 8). Every warp of the warpgroup executes it together, on a path
// that never rejoins the other warpgroups' (otherwise ptxas ignores it). inc
// blocks until the CTA's pool has the registers, which the dec of another
// warpgroup returns: the totals after both must fit the SM's 65,536 (for a
// CTA of one producer and two consumer warpgroups, 128 x 24 + 256 x 240 =
// 64,512), and the launch's own count (launch bounds) must be no higher than
// what the pool started with.
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  static_assert(R >= 24 && R <= 256 && R % 8 == 0, "setmaxnreg: 24..256, a multiple of 8");
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  static_assert(R >= 24 && R <= 256 && R % 8 == 0, "setmaxnreg: 24..256, a multiple of 8");
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Named barriers (bar.sync / bar.arrive id, threads): `threads` (a multiple
// of 32) arrivals complete barrier `id` (1..15; 0 is __syncthreads'). sync
// arrives and waits for the completion, arrive only counts. Two warpgroups
// take turns with one barrier each: a warpgroup syncs on its own before its
// turn and arrives at the other's after it, 256 threads a barrier, so each
// completion pairs one sync of the one with one arrive of the other; every
// arrive must be matched by a sync before the kernel ends.
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the issue or the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Shared-memory matrix descriptor for a tile in the `swizzle`-byte layout
// (128: layout type 1; 64: layout type 2).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes, int swizzle = 128) {
  const uint64_t layout = swizzle == 128 ? 1 : 2;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// Two floats to one bf16x2 register, `lo` in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A and B from shared memory, both
// K-major (trans-a = trans-b = 0).
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                  uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// The first product of a chain, D[64 x 64] = A[64 x 16] * B[16 x 64], and the
// ones after it, D += A B: as wgmma_m64n64k16_ss with scale-d a constant
// written into the instruction. The first takes D as output only, so no
// instruction needs to set D's registers before it. For a kernel that keeps a
// second group in flight (wgmma_wait<1>): ptxas serializes every wgmma of it
// if a non-wgmma instruction writes an input of one inside its pipeline stage
// (warning C7513), and these forms leave no zeroing move or flag register to
// land there.
__device__ __forceinline__ void wgmma_m64n64k16_ss_first(float (&d)[32], uint64_t desc_a,
                                                        uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(desc_a), "l"(desc_b));
}
__device__ __forceinline__ void wgmma_m64n64k16_ss_acc(float (&d)[32], uint64_t desc_a,
                                                      uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b));
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128], A and B from shared memory, both
// K-major (trans-a = trans-b = 0).
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a,
                                                  uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128], A from registers (four bf16x2 per
// thread, the accumulator fragment layout), B from shared memory MN-major
// (trans-b = 1).
__device__ __forceinline__ void wgmma_m64n128k16_rs_tb(float (&d)[64], uint32_t a0, uint32_t a1,
                                                     uint32_t a2, uint32_t a3, uint64_t desc_b,
                                                     int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(accumulate));
}

// D[64 x 256] (+)= A[64 x 16] * B[16 x 256], A from registers, B from shared
// memory MN-major (trans-b = 1), as wgmma_m64n128k16_rs_tb. B spans four
// 128-byte-swizzle boxes, stepped by the descriptor's LBO.
__device__ __forceinline__ void wgmma_m64n256k16_rs_tb(float (&d)[128], uint32_t a0, uint32_t a1,
                                                     uint32_t a2, uint32_t a3, uint64_t desc_b,
                                                     int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(accumulate));
}

// D[64 x 256] += A[64 x 16] * B[16 x 256]: wgmma_m64n256k16_rs_tb with scale-d
// the constant 1 in the instruction (wgmma_m64n64k16_ss_first says why).
__device__ __forceinline__ void wgmma_m64n256k16_rs_tb_acc(float (&d)[128], uint32_t a0, uint32_t a1,
                                                         uint32_t a2, uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b));
}

// D[64 x 96] (+)= A[64 x 16] * B[16 x 96], A from registers, B from shared
// memory MN-major (trans-b = 1), as wgmma_m64n128k16_rs_tb. B spans three
// 64-byte-swizzle boxes, stepped by the descriptor's LBO.
__device__ __forceinline__ void wgmma_m64n96k16_rs_tb(float (&d)[48], uint32_t a0, uint32_t a1,
                                                    uint32_t a2, uint32_t a3, uint64_t desc_b,
                                                    int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A from registers, B from shared
// memory MN-major (trans-b = 1), as wgmma_m64n128k16_rs_tb.
__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float (&d)[32], uint32_t a0, uint32_t a1,
                                                    uint32_t a2, uint32_t a3, uint64_t desc_b,
                                                    int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(accumulate));
}

// D[64 x 32] (+)= A[64 x 16] * B[16 x 32], A from registers, B from shared
// memory MN-major (trans-b = 1), as wgmma_m64n128k16_rs_tb.
__device__ __forceinline__ void wgmma_m64n32k16_rs_tb(float (&d)[16], uint32_t a0, uint32_t a1,
                                                    uint32_t a2, uint32_t a3, uint64_t desc_b,
                                                    int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(accumulate));
}

// D[64 x N] (+)= A[64 x 16] * B[16 x N], A from registers, B MN-major: the
// instruction picked by N (a product whose width is the head dim).
template <int N>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[N / 2], uint32_t a0, uint32_t a1,
                                            uint32_t a2, uint32_t a3, uint64_t desc_b,
                                            int accumulate) {
  if constexpr (N == 256) {
    wgmma_m64n256k16_rs_tb(d, a0, a1, a2, a3, desc_b, accumulate);
  } else if constexpr (N == 128) {
    wgmma_m64n128k16_rs_tb(d, a0, a1, a2, a3, desc_b, accumulate);
  } else if constexpr (N == 96) {
    wgmma_m64n96k16_rs_tb(d, a0, a1, a2, a3, desc_b, accumulate);
  } else if constexpr (N == 64) {
    wgmma_m64n64k16_rs_tb(d, a0, a1, a2, a3, desc_b, accumulate);
  } else {
    static_assert(N == 32, "wgmma_rs_tb: N is 256, 128, 96, 64 or 32");
    wgmma_m64n32k16_rs_tb(d, a0, a1, a2, a3, desc_b, accumulate);
  }
}

// ---------------------------------------------------------------------------
// cp.async: 16 or 4 bytes from global to shared memory, per thread. A
// `src_bytes` below the copy's size fills the rest with zeros (0: all zeros,
// nothing read). Completion is tracked per thread by commit groups.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's commit groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// Three-product TF32 ("3xTF32") on mma.sync: float32 products on the tensor
// cores at about float32's accuracy. x splits into hi = tf32(x) and
// lo = tf32(x - hi) (x - hi is exact in float32), and a * b is taken as
// lo_a hi_b + hi_a lo_b + hi_a hi_b, summed small terms first into one
// float32 accumulator (CUTLASS's OpMultiplyAddFastF32 order); the dropped
// lo_a lo_b is about 2^-22 of |a b|. One product alone (hi_a hi_b) keeps
// TF32's 2^-11.
//
// m16n8k8 fragments of warp lane l (g = l / 4, t = l % 4), one 32-bit value
// a register:
//   A [16 x 8] (row-major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//     a3 (g + 8, t + 4);
//   B [8 x 8] (k x n, "col"): b0 (t, g), b1 (t + 4, g);
//   C, D [16 x 8] float32: c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//     c3 (g + 8, 2t + 1).
// A product's k order is free as long as A and B agree, so an accumulator
// tile is the A fragment of the next product over its columns as they lie:
// take k = t as column 2t and k = t + 4 as column 2t + 1 (a0 = c0, a1 = c2,
// a2 = c1, a3 = c3) and read B's rows 2t and 2t + 1 to match.
// ---------------------------------------------------------------------------
// x rounded to TF32 (10 mantissa bits): to nearest, ties away from zero.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// D[16 x 8] += A[16 x 8] B[8 x 8] in TF32 with a float32 accumulator.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D += A B from the split fragments of A and B, with the products their parts
// need: lo_a hi_b where A has a lo part (kLoA), hi_a lo_b where B has one
// (kLoB), then hi_a hi_b. Both split is 3xTF32. An operand exact in TF32 (a
// bf16 value: 8 significant bits of TF32's 11) has lo = 0, and its terms
// would add exactly nothing: one product where neither has a lo part, two
// where one has.
template <bool kLoA, bool kLoB>
__device__ __forceinline__ void mma_split(float (&d)[4], const uint32_t (&a_hi)[4],
                                          const uint32_t (&a_lo)[4], const uint32_t (&b_hi)[2],
                                          const uint32_t (&b_lo)[2]) {
  if constexpr (kLoA) mma_tf32(d, a_lo, b_hi[0], b_hi[1]);
  if constexpr (kLoB) mma_tf32(d, a_hi, b_lo[0], b_lo[1]);
  mma_tf32(d, a_hi, b_hi[0], b_hi[1]);
}

// ---------------------------------------------------------------------------
// The second pass of a split backward launch: out_o[j] = scale_o * sum over
// parts p in order 0, 1, ... of ws[p][o][j], for outputs o < outs (1 or 2),
// in float4s, so two launches give the same bits.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(x.x, x.y);
  q[1] = __floats2bfloat162_rn(x.z, x.w);
}

template <typename T>
__global__ void __launch_bounds__(256)
    sum_parts_kernel(const float4* __restrict__ ws, int splits, size_t n4, int outs,
                     T* __restrict__ out0, float scale0, T* __restrict__ out1, float scale1) {
  const size_t total = n4 * outs;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int o = i >= n4;
    const size_t j = i - o * n4;
    float4 acc = ws[o * n4 + j];
    for (int p = 1; p < splits; ++p) {
      const float4 x = ws[(static_cast<size_t>(p) * outs + o) * n4 + j];
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    const float s = o ? scale1 : scale0;
    store4((o ? out1 : out0) + 4 * j, make_float4(acc.x * s, acc.y * s, acc.z * s, acc.w * s));
  }
}

template <typename T>
int sum_parts(const float* ws, int splits, size_t n, int outs, T* out0, float scale0, T* out1,
              float scale1, cudaStream_t stream) {
  const size_t n4 = n / 4;  // n = rows x HD, HD a multiple of 16
  const size_t blocks = (n4 * outs + 255) / 256;
  sum_parts_kernel<T><<<static_cast<unsigned>(blocks < 2112 ? blocks : 2112), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(ws), splits, n4, outs, out0, scale0, out1, scale1);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Host: TMA descriptors
// ---------------------------------------------------------------------------
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function; the runtime hands out its
// address, so the library links against cudart alone.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Map of a contiguous bf16 tensor [heads, rows, hd] as {hd, rows, heads},
// read in boxes of {box_cols, box_rows, 1} (box_cols 64 or 32: the tile's
// SW / 2) with the swizzle as wide as a box row (128 bytes at 64 columns, 64
// at 32). Rows past `rows` and columns past `hd` read as zeros inside each
// head: an hd-80 tensor (160-byte rows) fills a 96-wide tile's third box
// with columns 64-79 and zeros. Returns false if cuTensorMapEncodeTiled
// refuses the map.
inline bool bf16_rows_map(CUtensorMap* map, const void* base, int heads, int rows,
                          int box_rows, int hd, int box_cols) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {hd * sizeof(__nv_bfloat16),
                                 static_cast<cuuint64_t>(rows) * hd * sizeof(__nv_bfloat16)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace hopper
