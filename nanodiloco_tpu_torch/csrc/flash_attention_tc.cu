// Flash attention on Hopper's tensor cores (sm_90a), bf16: forward (B1), dQ
// (B2) and dK/dV (B3) at head dims 256, 128, 96, 80, 64 and 32. The float32
// path, bf16 at hd 16 and every head dim above 256 run the three-product TF32
// kernels of flash_attention_tf32_{fwd,dq,dkv}.cu;
// ops/cuda/flash_attention.py holds the route table that picks one kernel per
// (kernel, dtype, head dim).
//
// Replaces the Pallas TPU kernels of nanodiloco_tpu/ops/pallas/flash_attention.py:
//   B1 flash_fwd_tc_kernel<HD>      <- _fwd_call / _fwd_kernel
//      flash_fwd_ws_kernel<256>     (hd 256)
//   B2 flash_bwd_dq_tc_kernel<HD>   <- _flash_bwd / _bwd_dq_kernel
//   B3 flash_bwd_dkv_tc_kernel<HD>  <- _flash_bwd / _bwd_dkv_kernel
// Layouts are the TPU kernels' own: q, o, dO, dQ [BH, Sq, HD]; k, v, dK, dV
// [BH / group, Sk, HD] (GQA: query head bh reads KV head bh / group); lse and
// delta [BH, Sq] float32.
//
// What bounds them. At the training shape (S 2048, hd 128, causal) B1 does
// two, B2 three and B3 four S x S x hd products per head on O(S x hd) bytes,
// some 300x above the card's ~295 flop/byte ridge; at moe-8x-top2's shape
// (S 1024, hd 64) still ~100x: all are bound by operations, and only the
// tensor cores (wgmma, 989 TFLOP/s in bf16) come near that bound. The first
// kernels of the port, float32 FMAs on the CUDA cores (67 TFLOP/s), reached
// about 22 of those.
//
// Design (the PTX building blocks and the tile layouts are in hopper.cuh):
//   B1: one CTA per (bh, 128-row q tile), longest causal rows first. Two
//       consumer warpgroups own 64 q rows each; one producer warp loads Q once
//       and streams 128-key K and V tiles through a two-stage ring with TMA
//       (full/empty mbarrier pairs), so the next tile is in flight while the
//       current one is multiplied. S = Q K^T is an SS wgmma (m64n128k16 over
//       HD / 16 k-steps, both operands K-major); the online softmax runs on the
//       accumulator fragments in registers (exp2 with scale * log2 e folded
//       in, row max and sum over the four lanes that share a row); P is packed
//       to bf16 in registers and O += P V is an RS wgmma (m64nHDk16) with V
//       MN-major (trans-b).
//   B3: one CTA per (KV head, 64-key tile), keys as the rows of S^T, so
//       that no score tile goes through shared memory. K and V
//       stay resident; a producer warp streams (Q, dO) tiles by TMA and
//       (lse, delta) rows by plain loads for each of the `group` query heads,
//       from the causal diagonal down, through a two-stage ring. One consumer
//       warpgroup computes S^T = K Q^T and dP^T = V dO^T (SS wgmma, m64n64k16
//       over HD / 16 k-steps), P^T = exp(S^T scale - lse) and
//       dS^T = P^T (dP^T - delta) in registers, then dV += P^T dO and
//       dK += dS^T Q (RS wgmma, m64nHDk16, dO and Q MN-major). The group sum
//       stays in the CTA's registers: no atomics, deterministic.
//   HD 64 and 32: the same designs, instantiated per head dim. A row is one
//       TMA box (128 bytes with the 128-byte swizzle at hd 64; 64 bytes with
//       the 64-byte swizzle and descriptor layout type 2 at hd 32); the first
//       products take HD / 16 k-steps and the second are m64nHD. What the
//       smaller head dim frees goes to occupancy in B3: its accumulators
//       (dK, dV: HD registers a thread, 128 at hd 128) and tiles (~50 KB of
//       shared memory at hd 64) fit two CTAs on an SM, so two consumer
//       warpgroups share the tensor cores where hd 128 has one
//       (__launch_bounds__ minimum 2). B1 keeps one CTA an SM: its S tile
//       (64 registers) and packed P (32) do not shrink with HD, and two CTAs
//       of 288 threads would leave 113 registers a thread.
//   HD 96 and 80: a 192-byte row of hd 96 is no whole number of 128-byte
//       swizzle atoms, so the tile is three 32-column boxes with the 64-byte
//       swizzle, as at hd 32 (the atom CUTLASS's shared-memory selector
//       picks for a 96-wide major dimension). K-major k-slices step 32 bytes
//       inside a box and jump a box after two; the MN-major operand of the
//       m64n96k16 products (O += P V; dV += P^T dO, dK += dS^T Q) spans the
//       three boxes, stepped by the descriptor's LBO = one box. hd 80 runs in
//       that tile, as FlashAttention-2 runs hd 80 in its hd-96 kernel
//       (Tile<80>::kN = 96): the tensor map keeps the tensor's 80 columns
//       (160-byte rows), so TMA fills columns 80-95 of the third box with
//       zeros. Q K^T, K Q^T and V dO^T take the 5 k-slices that hold data;
//       the m64n96 products compute 16 zero columns too (10% more of B1's
//       and B3's operations), and the epilogues store only the tensor's 80
//       columns at its own row stride (HD, not kN): nothing is written past
//       a row. Padding hd 96 to 128 in hd 128's tile was the alternative: a
//       third more work on the second products, for no new layout.
//       Occupancy, B3 (ptxas -v, cuobjdump -sass and two A/B calls of
//       scripts/torch_flash_ab.py between variant trees on one H100;
//       PERF.md section 6): two CTAs an SM cap B3 at 168 registers a thread,
//       where dK and dV alone hold 96; at hd 96 and 80 ptxas then spilled
//       168 bytes (27 LDL, 26 STL in the SASS) and serialized the wgmma
//       (C7512). One CTA an SM takes 220 (hd 96) / 208 (hd 80) registers
//       and spills nothing. The spilling pair ran 1-5% faster at Phi-3-mini's
//       and Phi-2's width (B 2 x 32 heads, S 2048), in every turn of both
//       calls, and 20-30% slower at an 8-CTA edge shape in one of them. The
//       spill-free kernel stays (kMinBlocks 1 at hd 80 and above): what the
//       pair shows is that a second warpgroup on the SM pays even with
//       spills, which a CTA of two consumer warpgroups would get without
//       them (ROADMAP, later kernel work).
//   B2: B1's grid and threads, with the online softmax replaced by the saved
//       lse. Q and dO stay resident (loaded once by TMA); the producer streams
//       64-key K and V tiles through a two-stage ring. Per tile each consumer
//       warpgroup issues S = Q K^T and dP = dO V^T back to back (SS wgmma,
//       m64n64k16, all K-major), forms P = exp(S scale - lse) and
//       dS = P (dP - delta) in registers, and adds dQ += dS K (RS wgmma, K
//       MN-major, the same shared tile read through a second descriptor).
//       64-key tiles, not B1's 128, keep a consumer thread near 150
//       registers at hd 128: dQ (64) + S (32) + dP (32) + packed dS (16);
//       128-key tiles would need over 224, more than 288 threads can hold
//       without spills. Each CTA owns its dQ rows and sums its K tiles in one
//       order: no atomics, deterministic.
//   B2 at HD 64 and 32: the same kernel through Tile<HD>. dQ shrinks to HD / 2
//       registers and dQ += dS K is m64nHDk16; ptxas reports 158 / 126 / 107
//       registers at hd 128 / 64 / 32, no spills. Q + dO + the two K/V stages
//       take 128 / 64 / 32 KB of shared memory. What the smaller head dim
//       frees is not spent: one CTA an SM and 64-key tiles at every head dim,
//       chosen by ptxas and a timed run (scripts/torch_flash_ab.py) of the two
//       ways to spend it. 128-key tiles (S and dP at 64 registers each)
//       spilled and ran 3-4% slower at hd 64, no faster at hd 32. Two CTAs an
//       SM (__launch_bounds__ minimum 2) left ptxas 90 registers: it kept dQ
//       in local memory between K tiles and serialized every wgmma (C7512),
//       15-21% slower at hd 64; at hd 32 the extra warpgroups won 16% at
//       moe64e_hd32 despite that but lost at tiny_hd32. The spill-free kernel
//       stays: the gain was one shape's, on a 0.08 ms kernel (PERF.md).
//   B2 at HD 96 and 80: the same kernel through Tile<96> (hd 80 read into it,
//       as in B1 and B3). S = Q K^T and dP = dO V^T take the HD / 16 k-slices
//       that hold data (6, 5); dQ += dS K is m64n96k16, K MN-major across the
//       three boxes. At hd 80 K's columns 80-95 are TMA zeros, so dQ's are
//       zeros, and the epilogue stores HD columns at row stride HD. dQ holds
//       48 registers a thread; ptxas reports 160 (hd 96) / 156 (hd 80), no
//       spills. Two CTAs an SM left ptxas 96 registers: it spilled 340 bytes
//       (70 LDL, 53 STL in the SASS) and serialized the wgmma (C7512), so one
//       CTA an SM stays here too.
//   B2 and B3 at HD 256 (Gemma's head dim). A row is four 128-byte boxes
//       (Tile<256>); the first products take 16 k-slices, stepped across the
//       boxes by kslice(); the second products are m64n256k16 (B2, RS, K
//       MN-major across the four boxes by LBO) and m64n128k16 (B3).
//       B3: dK and dV of 256 columns would take 256 accumulator registers a
//       thread of one warpgroup. Two CTAs share each (KV head, 64-key tile)
//       (Dkv::kParts) and own 128 columns each (kOutN): each computes S^T
//       and dP^T over all 256 columns itself (1.5x B3's products), and its
//       second products read its half of the MN-major Q and dO tiles, from
//       box 2 for the second half. That is the hd-128 kernel's register
//       shape: ptxas 248 registers, no spills, no C7512; K, V and two
//       (Q, dO) stages take 193 KB. The other design, two consumer
//       warpgroups of one CTA each owning a column half and sharing P^T
//       and dS^T through shared memory under named barriers, halves the
//       recomputation but needs a barrier protocol the kernels do not have
//       yet; it was not built. Under the causal mask the first key tiles
//       carry 32x the pairs of the last, and at Gemma-2B's grid (2 KV heads
//       x 32 key tiles x 2 halves, 128 CTAs on 132 SMs) the first tile alone
//       would set the time: a grid under one wave splits its pairs across
//       `splits` CTAs (grid z, flash_attention.py's bwd_splits), whose
//       float32 partials the second pass of hopper.cuh (sum_parts) adds in
//       a fixed order, as the tf32x3 kernels do: still no atomics.
//       B2: Q and dO resident for two warpgroups (128 rows) and two stages
//       of 64-key K and V tiles would take 256 KB at hd 256. One consumer
//       warpgroup a CTA (Dq::kWgs: 64 q rows, 160 threads) keeps the 64-key
//       tiles and both stages in 193 KB and doubles the CTAs (512 at
//       Gemma-2B's shape). A thread holds dQ (128 registers), S and dP (32
//       each) and packed dS (16): ptxas 221 registers, no spills, no C7512.
//       Timed A/B of the alternatives, each against this design in one
//       call of scripts/torch_flash_ab.py on one H100 (device_ms medians of
//       two turns each; PERF.md section 6): B2 with two consumer warpgroups
//       and one K/V stage (192 KB; 288 threads leave ptxas 168 registers:
//       it spilled 420 bytes and serialized the wgmma, C7512) ran 1.74x
//       and 1.73x slower at Gemma-2B's shape and train_hd256's (B 4). B3
//       unsplit ran 1.42x slower at Gemma-2B's shape (128 CTAs) and 3%
//       faster at train_hd256's (256 CTAs: split in two, the second pass
//       cost more than the balance gained), hence the one-wave condition.
//   B1 at HD 256 (flash_fwd_ws_kernel). What bounds it: operations, two
//       S x S x 256 products a head (at train_hd256's shape, B 4 x 8 query
//       heads on 1 KV head, S 2048, causal: 0.0695 ms at 989 TFLOP/s; at
//       Gemma-2B's, B 2: 0.0348), against 8 MB of Q, K, V and O. The hd-128
//       kernel's shape does not fit at 256: Q (128 rows, 64 KB) and two
//       stages of 128-key K and V (64 KB each) are 320 KB of the 227 a CTA
//       may have, and a consumer thread would hold O (128 registers), S (64)
//       and packed P (32), 224 before any address, where 288 threads leave
//       ptxas 168. Design, as
//       FlashAttention-3's forward (Shah et al. 2024, arXiv:2407.08608,
//       sections 3.1-3.2): 128 q rows a CTA in two consumer warpgroups, so K
//       and V are read once for 128 rows as at hd 128; 64-key K and V tiles,
//       each in a two-stage TMA ring with its own full/empty barriers, so K
//       of a tile is refilled as soon as its S is done, V after its product
//       (Q 64 KB + 2 x (32 + 32) KB = 192 KB); S = Q K^T on m64n64k16 (SS,
//       16 k-slices across the four boxes), O += P V on m64n256k16 (RS, V
//       MN-major across the four boxes). The producer is a whole warpgroup
//       (384 threads) that drops to 24 registers (setmaxnreg) so that the
//       consumers rise to 240: O 128, S 32, packed P 16. (a) Each consumer
//       issues S_j and, after rescaling O, O += P_{j-1} V_{j-1}, waits for S
//       alone (wgmma_wait<1>) and runs the softmax of S_j in place while the
//       second product is in flight; P_j is packed after that product
//       retires. (b) The two warpgroups issue their products in turns on
//       two named barriers, so that one's softmax runs while the other's
//       products hold the tensor cores. ptxas (scripts/torch_kernel_report.py):
//       168 registers at launch, the consumers reaching R221 under
//       setmaxnreg 240, no spills, no serialized wgmma. Two compiler rules
//       shaped it: a non-wgmma instruction that wrote a register of a
//       product in flight (P packed while O += P V ran) made ptxas
//       serialize every wgmma of the kernel (C7513), hence P packed after
//       the wait (the products also take scale-d as a constant in the
//       instruction, and the first S product writes its registers without
//       reading them: hopper.cuh's _first / _acc forms); and an inline trap
//       on a wait's path (mbar_wait's timeout) left the consumers allocated
//       within the launch's 168 registers (spills, C7512), hence
//       mbar_wait_outlined.
//       Each step of the design was timed against this kernel in one call
//       of scripts/torch_flash_ab.py each, its tree with that step taken
//       back (device_ms medians at train_hd256's / Gemma-2B's shape; this
//       kernel 0.1391-0.1404 / 0.0693-0.0702 ms on one H100; PERF.md section
//       6): the unpipelined loop with one producer warp (288 threads,
//       ptxas 168 registers, 332 bytes spilled, C7512) 0.2507 / 0.1263;
//       that loop with the producer warpgroup and setmaxnreg (R183, no
//       spills) 0.1462 / 0.0732; and (a) without (b) (R200) 0.1427 / 0.0726.
//       80-key tiles (FlashAttention-3's own choice at 256) were not built.
// P (B1) and P and dS (B3, B2) are rounded to bf16 as the left operand of the
// last product, as every tensor-core flash attention does; the plain versions
// keep them in float32, so the tolerance against them is wider than one
// output ulp.
//
// Ragged lengths: tensor maps are 3-D {HD, S, heads}, so rows past S read as
// zeros inside each head. Zero rows are not masked rows: key columns >= Sk
// are set to -inf in B1 and their p to 0 in B2, and query rows >= Sq get
// lse = +inf in B3 and B2, so their p is 0. A fully masked row keeps m = -inf,
// gets p = 0 and corr = 0, and ends with O = 0 and lse = -inf, never NaN.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared-memory geometry of the bf16 tile that holds a tensor of HD columns
// (hopper.cuh): kN columns (HD; 96 at hd 80, the last 16 zeros), rows of kSw
// bytes in boxes of kCols = kSw / 2 columns, kSw also the swizzle.
template <int HD>
struct Tile {
  static constexpr int kN = HD == 80 ? 96 : HD;
  static constexpr int kSw = kN % 64 == 0 ? 128 : 64;
  static constexpr int kCols = kSw / 2;
  static constexpr int kBoxes = kN / kCols;  // boxes a row: 2 at hd 128, 3 at 96 and 80, else 1
  __host__ __device__ static constexpr uint32_t box(int rows) { return rows * kSw; }
  __host__ __device__ static constexpr uint32_t bytes(int rows) { return rows * kN * 2; }
  // byte offset of k-slice kk (16 columns) of a K-major tile of `rows` rows
  __host__ __device__ static constexpr uint32_t kslice(int kk, int rows) {
    return (kk / (kSw / 32)) * box(rows) + (kk % (kSw / 32)) * 32;
  }
  // descriptors: K-major (S = Q K^T's operands), MN-major k-slice of 16 rows
  static __device__ __forceinline__ uint64_t kmajor(uint32_t addr) {
    return smem_desc(addr, 16, 8 * kSw, kSw);
  }
  static __device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk, int rows) {
    return smem_desc(tile + kk * 16 * kSw, box(rows), 8 * kSw, kSw);
  }
};

// ---------------------------------------------------------------------------
// B1: forward. grid (BH, n q tiles); blockIdx.y is reversed so the longest
// causal rows start first. Threads 0-255 are the two consumer warpgroups,
// 256-287 the producer warp.
// ---------------------------------------------------------------------------
constexpr int kFwdRows = 128;                         // q rows per CTA
constexpr int kFwdKeys = 128;                         // keys per K/V tile
constexpr int kFwdThreads = 288;

template <int HD>
struct Fwd {
  using T = Tile<HD>;
  static constexpr uint32_t kTile = T::bytes(kFwdRows);  // Q, K or V: 32 KB at hd 128
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kTile;                  // K[s] at kK + s * 2 tiles, V after it
  static constexpr uint32_t kBars = kTile + 4 * kTile;
  static constexpr size_t kSmem = 1024 + kBars + 64;     // + alignment slack, barriers
};

template <int HD>
__global__ void __launch_bounds__(kFwdThreads, 1)
    flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int group,
                        int sq, int sk, int causal, float scale) {
  using T = Tile<HD>;
  using L = Fwd<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base + L::kQ;
  const uint32_t bars = base + L::kBars;
  const uint32_t q_full = bars;
  // stage s: full at bars + 8 + 8 s, empty at bars + 24 + 8 s
  auto full = [&](int s) { return bars + 8 + 8 * s; };
  auto empty = [&](int s) { return bars + 24 + 8 * s; };
  auto tile_k = [&](int s) { return base + L::kK + 2 * L::kTile * s; };
  auto tile_v = [&](int s) { return base + L::kK + 2 * L::kTile * s + L::kTile; };

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kFwdRows;
  const int nk = (sk + kFwdKeys - 1) / kFwdKeys;
  const int last_q = min(q0 + kFwdRows, sq) - 1;
  const int n_kt = causal ? min(nk, last_q / kFwdKeys + 1) : nk;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer warp: one thread issues every TMA load ----
    if (threadIdx.x == 256) {
      const int bkv = bh / group;
      mbar_arrive_expect_tx(q_full, L::kTile);
      for (int b = 0; b < T::kBoxes; ++b)
        tma_load_3d(sQ + b * T::box(kFwdRows), &q_map, q_full, T::kCols * b, q0, bh);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt & 1;
        mbar_wait(empty(s), ((kt >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(full(s), 2 * L::kTile);
        for (int b = 0; b < T::kBoxes; ++b) {
          tma_load_3d(tile_k(s) + b * T::box(kFwdKeys), &k_map, full(s), T::kCols * b,
                      kt * kFwdKeys, bkv);
          tma_load_3d(tile_v(s) + b * T::box(kFwdKeys), &v_map, full(s), T::kCols * b,
                      kt * kFwdKeys, bkv);
        }
      }
    }
  } else {
    // ---- consumer warpgroup wg: q rows q0 + 64 wg .. + 63 ----
    const int wg = threadIdx.x >> 7;
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int row_lo = q0 + 64 * wg + 16 * warp + (lane >> 2);  // and row_lo + 8
    const int row_min = q0 + 64 * wg;
    const float c = scale * kLog2e;
    const uint32_t qa = sQ + wg * 64 * T::kSw;

    float acc[T::kN / 2];
#pragma unroll
    for (int i = 0; i < T::kN / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt & 1;
      mbar_wait(full(s), (kt >> 1) & 1);

      float sc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) sc[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = T::kslice(kk, kFwdRows);
        wgmma_m64n128k16_ss(sc, T::kmajor(qa + off), T::kmajor(tile_k(s) + off), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      const int kb = kt * kFwdKeys;
      if (kb + kFwdKeys > sk || (causal && kb + kFwdKeys - 1 > row_min)) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int col = kb + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          const int row = row_lo + 8 * ((i >> 1) & 1);
          if (col >= sk || (causal && col > row)) sc[i] = -INFINITY;
        }
      }

      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float msafe[2], corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h] * c);
        msafe[h] = m_new == -INFINITY ? 0.f : m_new;
        corr[h] = exp2f(m[h] - msafe[h]);
        m[h] = m_new;
        l[h] *= corr[h];
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int h = (i >> 1) & 1;
        const float p = exp2f(fmaf(sc[i], c, -msafe[h]));
        sc[i] = p;
        l[h] += p;  // this thread's share; the four lanes of a row add up at the end
      }
#pragma unroll
      for (int i = 0; i < T::kN / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
      uint32_t pf[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) pf[j] = pack_bf16(sc[2 * j], sc[2 * j + 1]);

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kFwdKeys / 16; ++kk)
        wgmma_rs_tb<T::kN>(acc, pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2], pf[4 * kk + 3],
                           T::mnmajor(tile_v(s), kk, kFwdKeys), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(pf);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const int row = row_lo + 8 * h;
      if (row >= sq) continue;
      const float inv = 1.f / fmaxf(l[h], 1e-30f);
      uint32_t* out = reinterpret_cast<uint32_t*>(o + (static_cast<size_t>(bh) * sq + row) * HD);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        out[4 * j + (lane & 3)] = pack_bf16(acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
      if ((lane & 3) == 0)
        lse[static_cast<size_t>(bh) * sq + row] =
            l[h] > 0.f ? (m[h] + log2f(l[h])) * kLn2 : -INFINITY;
    }
  }
}

// ---------------------------------------------------------------------------
// B1 at HD 256: the warp-specialised forward (the source note). Grid and
// rows as flash_fwd_tc_kernel; 64-key K and V tiles, each in a two-stage ring
// of its own. Threads 0-255 are the two consumer warpgroups, 256-383 the
// producer warpgroup, which hands its registers to them (setmaxnreg).
// ---------------------------------------------------------------------------
constexpr int kWsKeys = 64;        // keys per K or V tile
constexpr int kWsThreads = 384;
constexpr int kWsProducerRegs = 24;
constexpr int kWsConsumerRegs = 240;  // 128 x 24 + 256 x 240 <= 65,536

template <int HD>
struct FwdWs {
  using T = Tile<HD>;
  static constexpr uint32_t kQTile = T::bytes(kFwdRows);  // 64 KB at hd 256
  static constexpr uint32_t kKvTile = T::bytes(kWsKeys);  // K or V: 32 KB at hd 256
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQTile;                   // K[s] at kK + s tiles
  static constexpr uint32_t kV = kK + 2 * kKvTile;         // V[s] at kV + s tiles
  static constexpr uint32_t kBars = kV + 2 * kKvTile;      // 192 KB at hd 256
  static constexpr size_t kSmem = 1024 + kBars + 128;
};

// S = Q K^T of one 64-key tile into sc (SS, HD / 16 k-slices), committed as
// one group. qa: this warpgroup's 64 rows of the 128-row Q tile.
template <int HD>
__device__ __forceinline__ void ws_scores(float (&sc)[kWsKeys / 2], uint32_t qa, uint32_t ka) {
  using T = Tile<HD>;
  wgmma_fence();
  wgmma_m64n64k16_ss_first(sc, T::kmajor(qa), T::kmajor(ka));
#pragma unroll
  for (int kk = 1; kk < HD / 16; ++kk)
    wgmma_m64n64k16_ss_acc(sc, T::kmajor(qa + T::kslice(kk, kFwdRows)),
                           T::kmajor(ka + T::kslice(kk, kWsKeys)));
  wgmma_commit();
}

// O += P V of one 64-key tile (RS, P packed bf16 in registers, V MN-major),
// committed as one group.
template <int HD>
__device__ __forceinline__ void ws_pv(float (&acc)[Tile<HD>::kN / 2],
                                      const uint32_t (&pf)[kWsKeys / 4], uint32_t va) {
  using T = Tile<HD>;
  static_assert(T::kN == 256, "ws_pv: the m64n256 product (instantiated at hd 256 only)");
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kWsKeys / 16; ++kk)
    wgmma_m64n256k16_rs_tb_acc(acc, pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2], pf[4 * kk + 3],
                               T::mnmajor(va, kk, kWsKeys));
  wgmma_commit();
}

// The online softmax of one score tile (keys kb ..) in place: masks it,
// updates the row max m (log2 units) and sum l, leaves P in sc and returns
// each row half's correction of O in corr.
__device__ __forceinline__ void ws_softmax(float (&sc)[kWsKeys / 2], float (&m)[2], float (&l)[2],
                                           float (&corr)[2], int kb, int row_lo, int row_min,
                                           int lane, int sk, int causal, float c) {
  if (kb + kWsKeys > sk || (causal && kb + kWsKeys - 1 > row_min)) {
#pragma unroll
    for (int i = 0; i < kWsKeys / 2; ++i) {
      const int col = kb + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      const int row = row_lo + 8 * ((i >> 1) & 1);
      if (col >= sk || (causal && col > row)) sc[i] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < kWsKeys / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  float msafe[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h] * c);
    msafe[h] = m_new == -INFINITY ? 0.f : m_new;
    corr[h] = exp2f(m[h] - msafe[h]);
    m[h] = m_new;
    l[h] *= corr[h];
  }
#pragma unroll
  for (int i = 0; i < kWsKeys / 2; ++i) {
    const int h = (i >> 1) & 1;
    const float p = exp2f(fmaf(sc[i], c, -msafe[h]));
    sc[i] = p;
    l[h] += p;  // this thread's share; the four lanes of a row add up at the end
  }
}

// P (in sc) packed to bf16 pairs: the A fragments of O += P V.
__device__ __forceinline__ void ws_pack(const float (&sc)[kWsKeys / 2], uint32_t (&pf)[kWsKeys / 4]) {
#pragma unroll
  for (int j = 0; j < kWsKeys / 4; ++j) pf[j] = pack_bf16(sc[2 * j], sc[2 * j + 1]);
}

template <int HD>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_fwd_ws_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int group,
                        int sq, int sk, int causal, float scale) {
  using T = Tile<HD>;
  using L = FwdWs<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base + L::kQ;
  const uint32_t bars = base + L::kBars;
  const uint32_t q_full = bars;
  // stage s of K: full at bars + 8 + 8 s, empty at + 40 + 8 s; of V at + 24, + 56
  auto k_full = [&](int s) { return bars + 8 + 8 * s; };
  auto v_full = [&](int s) { return bars + 24 + 8 * s; };
  auto k_empty = [&](int s) { return bars + 40 + 8 * s; };
  auto v_empty = [&](int s) { return bars + 56 + 8 * s; };
  auto tile_k = [&](int s) { return base + L::kK + L::kKvTile * s; };
  auto tile_v = [&](int s) { return base + L::kV + L::kKvTile * s; };

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kFwdRows;
  const int nk = (sk + kWsKeys - 1) / kWsKeys;
  const int last_q = min(q0 + kFwdRows, sq) - 1;
  const int n_kt = causal ? min(nk, last_q / kWsKeys + 1) : nk;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 8);  // lane 0 of each consumer warp
      mbar_init(v_empty(s), 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer: one thread issues every TMA load ----
    setmaxnreg_dec<kWsProducerRegs>();
    if (threadIdx.x == 256) {
      const int bkv = bh / group;
      mbar_arrive_expect_tx(q_full, L::kQTile);
      for (int b = 0; b < T::kBoxes; ++b)
        tma_load_3d(sQ + b * T::box(kFwdRows), &q_map, q_full, T::kCols * b, q0, bh);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt & 1;
        const uint32_t ph = ((kt >> 1) & 1) ^ 1;
        mbar_wait_outlined(k_empty(s), ph);
        mbar_arrive_expect_tx(k_full(s), L::kKvTile);
        for (int b = 0; b < T::kBoxes; ++b)
          tma_load_3d(tile_k(s) + b * T::box(kWsKeys), &k_map, k_full(s), T::kCols * b,
                      kt * kWsKeys, bkv);
        mbar_wait_outlined(v_empty(s), ph);
        mbar_arrive_expect_tx(v_full(s), L::kKvTile);
        for (int b = 0; b < T::kBoxes; ++b)
          tma_load_3d(tile_v(s) + b * T::box(kWsKeys), &v_map, v_full(s), T::kCols * b,
                      kt * kWsKeys, bkv);
      }
    }
  } else {
    // ---- consumer warpgroup wg: q rows q0 + 64 wg .. + 63 ----
    setmaxnreg_inc<kWsConsumerRegs>();
    const int wg = threadIdx.x >> 7;
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int row_lo = q0 + 64 * wg + 16 * warp + (lane >> 2);  // and row_lo + 8
    const int row_min = q0 + 64 * wg;
    const float c = scale * kLog2e;
    const uint32_t qa = sQ + wg * 64 * T::kSw;
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    float acc[T::kN / 2];
#pragma unroll
    for (int i = 0; i < T::kN / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
    float sc[kWsKeys / 2];
    uint32_t pf[kWsKeys / 4];

    mbar_wait_outlined(q_full, 0);
    // (b): named barrier 1 + wg is this warpgroup's turn to issue its
    // products, which the other opens by arriving at it after its own turn;
    // the second warpgroup opens the first's first turn and leaves its own
    // last turn unanswered, so every arrive meets a sync.
    auto turn_begin = [&]() { named_bar_sync(1 + wg, 256); };
    auto turn_end = [&](bool last) {
      if (!(last && wg == 1)) named_bar_arrive(2 - wg, 256);
    };
    if (wg == 1) named_bar_arrive(1, 256);
    // (a): S_j and O += P_{j-1} V_{j-1} in flight together, the softmax of
    // S_j run under the second. As in FlashAttention-3's forward, P_j stays
    // float in sc until that product retires and O is rescaled between the
    // two issues, so no register of a product in flight is written (the
    // source note: ptxas would serialize every wgmma).
    mbar_wait_outlined(k_full(0), 0);
    turn_begin();
    ws_scores<HD>(sc, qa, tile_k(0));
    turn_end(false);
    wgmma_wait<0>();
    fence_regs(sc);
    release(k_empty(0));
    ws_softmax(sc, m, l, corr, 0, row_lo, row_min, lane, sk, causal, c);
    ws_pack(sc, pf);
    for (int kt = 1; kt < n_kt; ++kt) {
      const int s = kt & 1, sp = s ^ 1;
      mbar_wait_outlined(k_full(s), (kt >> 1) & 1);
      mbar_wait_outlined(v_full(sp), ((kt - 1) >> 1) & 1);
      turn_begin();
      ws_scores<HD>(sc, qa, tile_k(s));
#pragma unroll
      for (int i = 0; i < T::kN / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
      ws_pv<HD>(acc, pf, tile_v(sp));
      turn_end(false);
      wgmma_wait<1>();  // S_j; O += P_{j-1} V_{j-1} still in flight
      fence_regs(sc);
      release(k_empty(s));
      ws_softmax(sc, m, l, corr, kt * kWsKeys, row_lo, row_min, lane, sk, causal, c);
      fence_regs(sc);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pf);
      release(v_empty(sp));
      ws_pack(sc, pf);
    }
    const int s = (n_kt - 1) & 1;
    mbar_wait_outlined(v_full(s), ((n_kt - 1) >> 1) & 1);
    turn_begin();
#pragma unroll
    for (int i = 0; i < T::kN / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
    ws_pv<HD>(acc, pf, tile_v(s));
    turn_end(true);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pf);
    release(v_empty(s));

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const int row = row_lo + 8 * h;
      if (row >= sq) continue;
      const float inv = 1.f / fmaxf(l[h], 1e-30f);
      uint32_t* out = reinterpret_cast<uint32_t*>(o + (static_cast<size_t>(bh) * sq + row) * HD);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        out[4 * j + (lane & 3)] = pack_bf16(acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
      if ((lane & 3) == 0)
        lse[static_cast<size_t>(bh) * sq + row] =
            l[h] > 0.f ? (m[h] + log2f(l[h])) * kLn2 : -INFINITY;
    }
  }
}

// ---------------------------------------------------------------------------
// B2: dQ. grid (BH, n q tiles), blockIdx.y reversed as in B1. Threads 0-255
// are the two consumer warpgroups (at hd 256 the one, 0-127), then the
// producer warp.
// ---------------------------------------------------------------------------
constexpr int kDqKeys = 64;                           // keys per K/V tile

template <int HD>
struct Dq {
  using T = Tile<HD>;
  // consumer warpgroups of 64 q rows: two, one at hd 256 (the source note)
  static constexpr int kWgs = HD == 256 ? 1 : 2;
  static constexpr int kRows = 64 * kWgs;                // q rows per CTA
  static constexpr int kThreads = 128 * kWgs + 32;       // + the producer warp
  static constexpr int kStages = 2;                      // the K/V ring
  static constexpr uint32_t kRowTile = T::bytes(kRows);  // Q or dO: 32 KB at hd 128
  static constexpr uint32_t kKeyTile = T::bytes(kDqKeys);  // K or V: 16 KB at hd 128
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kDo = kRowTile;
  static constexpr uint32_t kKv = 2 * kRowTile;  // stage s: K at + 2 s key tiles, V after it
  static constexpr uint32_t kBars = kKv + kStages * 2 * kKeyTile;
  static constexpr size_t kSmem = 1024 + kBars + 64;
};

template <int HD>
__global__ void __launch_bounds__(Dq<HD>::kThreads, 1)
    flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap do_map,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dq, int group, int sq, int sk, int causal,
                           float scale) {
  using T = Tile<HD>;
  using L = Dq<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base + L::kQ, sdO = base + L::kDo;
  const uint32_t bars = base + L::kBars;
  const uint32_t qdo_full = bars;
  // stage s: full at bars + 8 + 8 s, empty at bars + 8 + 8 (kStages + s)
  auto full = [&](int s) { return bars + 8 + 8 * s; };
  auto empty = [&](int s) { return bars + 8 + 8 * (L::kStages + s); };
  auto tile_k = [&](int s) { return base + L::kKv + 2 * L::kKeyTile * s; };
  auto tile_v = [&](int s) { return base + L::kKv + 2 * L::kKeyTile * s + L::kKeyTile; };

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * L::kRows;
  const int nk = (sk + kDqKeys - 1) / kDqKeys;
  const int last_q = min(q0 + L::kRows, sq) - 1;
  const int n_kt = causal ? min(nk, last_q / kDqKeys + 1) : nk;

  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * L::kWgs);  // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * L::kWgs) {
    // ---- producer warp: one thread issues every TMA load ----
    if (threadIdx.x == 128 * L::kWgs) {
      const int bkv = bh / group;
      mbar_arrive_expect_tx(qdo_full, 2 * L::kRowTile);
      for (int b = 0; b < T::kBoxes; ++b) {
        tma_load_3d(sQ + b * T::box(L::kRows), &q_map, qdo_full, T::kCols * b, q0, bh);
        tma_load_3d(sdO + b * T::box(L::kRows), &do_map, qdo_full, T::kCols * b, q0, bh);
      }
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % L::kStages;
        mbar_wait(empty(s), ((kt / L::kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(full(s), 2 * L::kKeyTile);
        for (int b = 0; b < T::kBoxes; ++b) {
          tma_load_3d(tile_k(s) + b * T::box(kDqKeys), &k_map, full(s), T::kCols * b,
                      kt * kDqKeys, bkv);
          tma_load_3d(tile_v(s) + b * T::box(kDqKeys), &v_map, full(s), T::kCols * b,
                      kt * kDqKeys, bkv);
        }
      }
    }
  } else {
    // ---- consumer warpgroup wg: q rows q0 + 64 wg .. + 63 ----
    const int wg = threadIdx.x >> 7;
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int row_lo = q0 + 64 * wg + 16 * warp + (lane >> 2);  // and row_lo + 8
    const int row_min = q0 + 64 * wg;
    // Under the causal mask the first warpgroup sees no key of the CTA's last
    // tile. It skips that one tile: the ring ends there, so no later load
    // waits for its release.
    const int n_kt_wg = causal ? min(n_kt, min(row_min + 63, last_q) / kDqKeys + 1) : n_kt;
    const float c = scale * kLog2e;
    const uint32_t qa = sQ + wg * 64 * T::kSw;
    const uint32_t doa = sdO + wg * 64 * T::kSw;

    // this thread's two rows, in registers for the whole loop; lse = +inf
    // past Sq makes p = exp2(s - lse) exactly 0 there
    float lse2[2], dlt[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_lo + 8 * h;
      const size_t at = static_cast<size_t>(bh) * sq + row;
      lse2[h] = row < sq ? lse[at] * kLog2e : INFINITY;
      dlt[h] = row < sq ? delta[at] : 0.f;
    }

    float acc[T::kN / 2];
#pragma unroll
    for (int i = 0; i < T::kN / 2; ++i) acc[i] = 0.f;

    mbar_wait(qdo_full, 0);
    for (int kt = 0; kt < n_kt_wg; ++kt) {
      const int s = kt % L::kStages;
      mbar_wait(full(s), (kt / L::kStages) & 1);

      float sc[kDqKeys / 2], dp[kDqKeys / 2];
#pragma unroll
      for (int i = 0; i < kDqKeys / 2; ++i) sc[i] = dp[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_m64n64k16_ss(sc, T::kmajor(qa + T::kslice(kk, L::kRows)),
                           T::kmajor(tile_k(s) + T::kslice(kk, kDqKeys)), kk > 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_m64n64k16_ss(dp, T::kmajor(doa + T::kslice(kk, L::kRows)),
                           T::kmajor(tile_v(s) + T::kslice(kk, kDqKeys)), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

#pragma unroll
      for (int i = 0; i < kDqKeys / 2; ++i) sc[i] = exp2f(fmaf(sc[i], c, -lse2[(i >> 1) & 1]));
      const int kb = kt * kDqKeys;
      if (kb + kDqKeys > sk || (causal && kb + kDqKeys - 1 > row_min)) {
#pragma unroll
        for (int i = 0; i < kDqKeys / 2; ++i) {
          const int col = kb + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          const int row = row_lo + 8 * ((i >> 1) & 1);
          if (col >= sk || (causal && col > row)) sc[i] = 0.f;
        }
      }
      uint32_t dsf[kDqKeys / 4];
#pragma unroll
      for (int j = 0; j < kDqKeys / 4; ++j) {
        const int h = j & 1;  // registers 2 j, 2 j + 1 share row half (2 j / 2) % 2
        dsf[j] = pack_bf16(sc[2 * j] * (dp[2 * j] - dlt[h]),
                           sc[2 * j + 1] * (dp[2 * j + 1] - dlt[h]));
      }

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDqKeys / 16; ++kk)
        wgmma_rs_tb<T::kN>(acc, dsf[4 * kk], dsf[4 * kk + 1], dsf[4 * kk + 2], dsf[4 * kk + 3],
                           T::mnmajor(tile_k(s), kk, kDqKeys), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(dsf);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_lo + 8 * h;
      if (row >= sq) continue;
      uint32_t* out = reinterpret_cast<uint32_t*>(dq + (static_cast<size_t>(bh) * sq + row) * HD);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        out[4 * j + (lane & 3)] =
            pack_bf16(acc[4 * j + 2 * h] * scale, acc[4 * j + 2 * h + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// B3: dK and dV. grid (BH / group, n K tiles), first K tiles (the longest
// causal loops) first. Threads 0-127 are the consumer warpgroup, 128-159 the
// producer warp.
// ---------------------------------------------------------------------------
constexpr int kDkvKeys = 64;                          // keys per CTA
constexpr int kDkvQ = 64;                             // queries per streamed tile
constexpr int kDkvThreads = 160;

template <int HD>
struct Dkv {
  using T = Tile<HD>;
  static constexpr uint32_t kTile = T::bytes(64);     // a 64-row tile: 16 KB at hd 128
  static constexpr uint32_t kK = 0;
  static constexpr uint32_t kV = kTile;
  static constexpr uint32_t kQt = 2 * kTile;          // stage s: Q at + 2 s tiles, dO after it
  static constexpr uint32_t kRows = 6 * kTile;        // stage s: lse at + 512 s, delta + 256
  static constexpr uint32_t kBars = kRows + 1024;
  static constexpr size_t kSmem = 1024 + kBars + 64;
  // two CTAs an SM at hd 64 and 32; one from hd 80, where a cap of two (168
  // registers) spilled and serialized the wgmma (the source note)
  static constexpr int kMinBlocks = HD >= 80 ? 1 : 2;
  // dK and dV columns a CTA owns: every column, 128 at hd 256, where the
  // CTAs of one key tile split them (kParts, the source note)
  static constexpr int kOutN = HD == 256 ? 128 : T::kN;
  static constexpr int kParts = T::kN / kOutN;
  static constexpr int kStoreCols = kParts > 1 ? kOutN : HD;  // at hd 80: HD of kN
};

template <int HD>
__global__ void __launch_bounds__(kDkvThreads, Dkv<HD>::kMinBlocks)
    flash_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const __grid_constant__ CUtensorMap do_map,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                            float* __restrict__ ws, int group, int sq, int sk, int causal,
                            float scale, int splits) {
  using T = Tile<HD>;
  using L = Dkv<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);  // generic pointer to the same bytes
  const uint32_t sK = base + L::kK, sV = base + L::kV;
  const uint32_t bars = base + L::kBars;
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8 + 8 * s; };
  auto empty = [&](int s) { return bars + 24 + 8 * s; };
  auto tile_q = [&](int s) { return base + L::kQt + 2 * L::kTile * s; };
  auto tile_do = [&](int s) { return base + L::kQt + 2 * L::kTile * s + L::kTile; };
  auto rows_lse = [&](int s) { return reinterpret_cast<float*>(gbase + L::kRows + 512 * s); };
  auto rows_delta = [&](int s) {
    return reinterpret_cast<float*>(gbase + L::kRows + 512 * s + 256);
  };

  const int bkv = blockIdx.x / L::kParts;
  const int part = blockIdx.x % L::kParts;  // this CTA's kOutN columns of dK and dV
  const int k0 = blockIdx.y * kDkvKeys;
  const int nq = (sq + kDkvQ - 1) / kDkvQ;
  // q tiles wholly above the diagonal (every query before this tile's first
  // key) contribute nothing under the causal mask
  const int qt_start = causal ? min(k0 / kDkvQ, nq) : 0;
  const int per_head = nq - qt_start;
  // this CTA's pairs [it0, it1): all of them, or at hd 256 part z of
  // `splits` (grid z), whose float32 partials sum_parts adds in order
  int it0 = 0, it1 = group * per_head;
  if constexpr (L::kParts > 1) {
    it0 = static_cast<int>(static_cast<long long>(blockIdx.z) * it1 / splits);
    it1 = static_cast<int>(static_cast<long long>(blockIdx.z + 1) * it1 / splits);
  }

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(full(s), 32);  // every producer lane writes lse / delta rows
      mbar_init(empty(s), 4);  // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer warp ----
    const int lane = threadIdx.x - 128;
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * L::kTile);
      for (int b = 0; b < T::kBoxes; ++b) {
        tma_load_3d(sK + b * T::box(kDkvKeys), &k_map, kv_full, T::kCols * b, k0, bkv);
        tma_load_3d(sV + b * T::box(kDkvKeys), &v_map, kv_full, T::kCols * b, k0, bkv);
      }
    }
    for (int it = it0; it < it1; ++it) {
      const int s = (it - it0) & 1;
      const int bh = bkv * group + it / per_head;
      const int q0 = (qt_start + it % per_head) * kDkvQ;
      mbar_wait(empty(s), (((it - it0) >> 1) & 1) ^ 1);
      float* lse_s = rows_lse(s);
      float* delta_s = rows_delta(s);
      for (int col = lane; col < kDkvQ; col += 32) {
        const int qi = q0 + col;
        const size_t at = static_cast<size_t>(bh) * sq + qi;
        // lse = +inf past Sq makes p = exp2(s - lse) exactly 0 there
        lse_s[col] = qi < sq ? lse[at] * kLog2e : INFINITY;
        delta_s[col] = qi < sq ? delta[at] : 0.f;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(full(s), 2 * L::kTile);
        for (int b = 0; b < T::kBoxes; ++b) {
          tma_load_3d(tile_q(s) + b * T::box(kDkvQ), &q_map, full(s), T::kCols * b, q0, bh);
          tma_load_3d(tile_do(s) + b * T::box(kDkvQ), &do_map, full(s), T::kCols * b, q0, bh);
        }
      } else {
        mbar_arrive(full(s));
      }
    }
  } else {
    // ---- consumer warpgroup: key rows k0 .. k0 + 63 ----
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int key_lo = k0 + 16 * warp + (lane >> 2);  // and key_lo + 8
    const float c = scale * kLog2e;

    float dk_acc[L::kOutN / 2], dv_acc[L::kOutN / 2];
#pragma unroll
    for (int i = 0; i < L::kOutN / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    // the part's columns of the MN-major Q and dO tiles start at box
    // part x kOutN / kCols
    const uint32_t cols = part * (L::kOutN / T::kCols) * T::box(kDkvQ);

    mbar_wait(kv_full, 0);
    for (int it = it0; it < it1; ++it) {
      const int s = (it - it0) & 1;
      const int q0 = (qt_start + it % per_head) * kDkvQ;
      mbar_wait(full(s), ((it - it0) >> 1) & 1);

      float st[32], dpt[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = T::kslice(kk, 64);
        wgmma_m64n64k16_ss(st, T::kmajor(sK + off), T::kmajor(tile_q(s) + off), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = T::kslice(kk, 64);
        wgmma_m64n64k16_ss(dpt, T::kmajor(sV + off), T::kmajor(tile_do(s) + off), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dpt);

      const float* lse_s = rows_lse(s);
      const float* delta_s = rows_delta(s);
      const bool diag = causal && q0 < k0 + kDkvKeys;  // the tile crosses the diagonal
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        const int key = key_lo + 8 * ((i >> 1) & 1);
        float p = exp2f(fmaf(st[i], c, -lse_s[col]));
        if (diag && key > q0 + col) p = 0.f;
        st[i] = p;
        dpt[i] = p * (dpt[i] - delta_s[col]);
      }
      uint32_t pf[16], dsf[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        pf[j] = pack_bf16(st[2 * j], st[2 * j + 1]);
        dsf[j] = pack_bf16(dpt[2 * j], dpt[2 * j + 1]);
      }

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDkvQ / 16; ++kk)
        wgmma_rs_tb<L::kOutN>(dv_acc, pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2],
                              pf[4 * kk + 3], T::mnmajor(tile_do(s) + cols, kk, kDkvQ), 1);
#pragma unroll
      for (int kk = 0; kk < kDkvQ / 16; ++kk)
        wgmma_rs_tb<L::kOutN>(dk_acc, dsf[4 * kk], dsf[4 * kk + 1], dsf[4 * kk + 2],
                              dsf[4 * kk + 3], T::mnmajor(tile_q(s) + cols, kk, kDkvQ), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(pf);
      fence_regs(dsf);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }

    if constexpr (L::kParts > 1) {
      if (splits > 1) {  // this part's float32 partials: ws [splits, 2, BH / group, Sk, HD]
        const size_t n = static_cast<size_t>(gridDim.x / L::kParts) * sk * HD;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int key = key_lo + 8 * h;
          if (key >= sk) continue;
          float* wk = ws + 2 * n * blockIdx.z + (static_cast<size_t>(bkv) * sk + key) * HD +
                      part * L::kOutN + 2 * (lane & 3);
#pragma unroll
          for (int j = 0; j < L::kOutN / 8; ++j) {
            const int i = 4 * j + 2 * h;
            *reinterpret_cast<float2*>(wk + 8 * j) = make_float2(dk_acc[i], dk_acc[i + 1]);
            *reinterpret_cast<float2*>(wk + n + 8 * j) = make_float2(dv_acc[i], dv_acc[i + 1]);
          }
        }
        return;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = key_lo + 8 * h;
      if (key >= sk) continue;
      const size_t off = (static_cast<size_t>(bkv) * sk + key) * HD + part * L::kOutN;
      uint32_t* dk_row = reinterpret_cast<uint32_t*>(dk + off);
      uint32_t* dv_row = reinterpret_cast<uint32_t*>(dv + off);
#pragma unroll
      for (int j = 0; j < L::kStoreCols / 8; ++j) {
        const int i = 4 * j + 2 * h;
        dk_row[4 * j + (lane & 3)] = pack_bf16(dk_acc[i] * scale, dk_acc[i + 1] * scale);
        dv_row[4 * j + (lane & 3)] = pack_bf16(dv_acc[i], dv_acc[i + 1]);
      }
    }
  }
}

constexpr int kErrHeadDim = -1;
constexpr int kErrTensorMap = -2;
constexpr int kErrSplit = -3;

template <int HD>
int launch_fwd_tc(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                  int group, int sq, int sk, int causal, float scale, cudaStream_t stream) {
  using T = Tile<HD>;
  CUtensorMap qm, km, vm;
  if (!bf16_rows_map(&qm, q, bh, sq, kFwdRows, HD, T::kCols) ||
      !bf16_rows_map(&km, k, bh / group, sk, kFwdKeys, HD, T::kCols) ||
      !bf16_rows_map(&vm, v, bh / group, sk, kFwdKeys, HD, T::kCols))
    return kErrTensorMap;
  constexpr size_t smem = Fwd<HD>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (sq + kFwdRows - 1) / kFwdRows);
  flash_fwd_tc_kernel<HD><<<grid, kFwdThreads, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), lse, group, sq, sk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_fwd_ws(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                  int group, int sq, int sk, int causal, float scale, cudaStream_t stream) {
  using T = Tile<HD>;
  using L = FwdWs<HD>;
  CUtensorMap qm, km, vm;
  if (!bf16_rows_map(&qm, q, bh, sq, kFwdRows, HD, T::kCols) ||
      !bf16_rows_map(&km, k, bh / group, sk, kWsKeys, HD, T::kCols) ||
      !bf16_rows_map(&vm, v, bh / group, sk, kWsKeys, HD, T::kCols))
    return kErrTensorMap;
  constexpr size_t smem = L::kSmem;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_ws_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (sq + kFwdRows - 1) / kFwdRows);
  flash_fwd_ws_kernel<HD><<<grid, kWsThreads, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), lse, group, sq, sk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_dq_tc(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                 const float* delta, void* dq, int bh, int group, int sq, int sk, int causal,
                 float scale, cudaStream_t stream) {
  using T = Tile<HD>;
  using L = Dq<HD>;
  CUtensorMap qm, km, vm, dom;
  if (!bf16_rows_map(&qm, q, bh, sq, L::kRows, HD, T::kCols) ||
      !bf16_rows_map(&km, k, bh / group, sk, kDqKeys, HD, T::kCols) ||
      !bf16_rows_map(&vm, v, bh / group, sk, kDqKeys, HD, T::kCols) ||
      !bf16_rows_map(&dom, dout, bh, sq, L::kRows, HD, T::kCols))
    return kErrTensorMap;
  constexpr size_t smem = L::kSmem;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_tc_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (sq + L::kRows - 1) / L::kRows);
  flash_bwd_dq_tc_kernel<HD><<<grid, L::kThreads, smem, stream>>>(
      qm, km, vm, dom, lse, delta, static_cast<__nv_bfloat16*>(dq), group, sq, sk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_dkv_tc(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, void* dk, void* dv, void* ws, int bh,
                  int group, int sq, int sk, int causal, float scale, int splits,
                  cudaStream_t stream) {
  using T = Tile<HD>;
  if (splits < 1 || splits > 65535 || (splits > 1 && (Dkv<HD>::kParts == 1 || ws == nullptr)))
    return kErrSplit;
  CUtensorMap qm, km, vm, dom;
  if (!bf16_rows_map(&qm, q, bh, sq, kDkvQ, HD, T::kCols) ||
      !bf16_rows_map(&km, k, bh / group, sk, kDkvKeys, HD, T::kCols) ||
      !bf16_rows_map(&vm, v, bh / group, sk, kDkvKeys, HD, T::kCols) ||
      !bf16_rows_map(&dom, dout, bh, sq, kDkvQ, HD, T::kCols))
    return kErrTensorMap;
  constexpr size_t smem = Dkv<HD>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_tc_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh / group * Dkv<HD>::kParts, (sk + kDkvKeys - 1) / kDkvKeys, splits);
  __nv_bfloat16* dk16 = static_cast<__nv_bfloat16*>(dk);
  __nv_bfloat16* dv16 = static_cast<__nv_bfloat16*>(dv);
  float* wsf = static_cast<float*>(ws);
  flash_bwd_dkv_tc_kernel<HD><<<grid, kDkvThreads, smem, stream>>>(
      qm, km, vm, dom, lse, delta, dk16, dv16, wsf, group, sq, sk, causal, scale, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return sum_parts(wsf, splits, static_cast<size_t>(bh / group) * sk * HD, 2, dk16, scale, dv16,
                   1.f, stream);
}

}  // namespace

extern "C" {

const char* nd_tc_error_string(int code) {
  if (code == kErrHeadDim)
    return "the tensor-core kernels take head dims 32, 64, 80, 96, 128 and 256";
  if (code == kErrTensorMap)
    return "cuTensorMapEncodeTiled refused a tensor (alignment, strides or driver)";
  if (code == kErrSplit)
    return "split count out of [1, 65535], or a split launch without a workspace or below hd 256";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Each launcher returns cudaGetLastError() after the launch (0 = launched),
// or a negative code above. Tensors are bf16, contiguous, 16-byte aligned.
int nd_flash_fwd_tc(int hd, const void* q, const void* k, const void* v, void* o, float* lse,
                    int bh, int group, int sq, int sk, int causal, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 256)
    return launch_fwd_ws<256>(q, k, v, o, lse, bh, group, sq, sk, causal, scale, st);
  if (hd == 128) return launch_fwd_tc<128>(q, k, v, o, lse, bh, group, sq, sk, causal, scale, st);
  if (hd == 96) return launch_fwd_tc<96>(q, k, v, o, lse, bh, group, sq, sk, causal, scale, st);
  if (hd == 80) return launch_fwd_tc<80>(q, k, v, o, lse, bh, group, sq, sk, causal, scale, st);
  if (hd == 64) return launch_fwd_tc<64>(q, k, v, o, lse, bh, group, sq, sk, causal, scale, st);
  if (hd == 32) return launch_fwd_tc<32>(q, k, v, o, lse, bh, group, sq, sk, causal, scale, st);
  return kErrHeadDim;
}

int nd_flash_bwd_dq_tc(int hd, const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dq, int bh, int group, int sq,
                       int sk, int causal, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 256)
    return launch_dq_tc<256>(q, k, v, dout, lse, delta, dq, bh, group, sq, sk, causal, scale, st);
  if (hd == 128)
    return launch_dq_tc<128>(q, k, v, dout, lse, delta, dq, bh, group, sq, sk, causal, scale, st);
  if (hd == 96)
    return launch_dq_tc<96>(q, k, v, dout, lse, delta, dq, bh, group, sq, sk, causal, scale, st);
  if (hd == 80)
    return launch_dq_tc<80>(q, k, v, dout, lse, delta, dq, bh, group, sq, sk, causal, scale, st);
  if (hd == 64)
    return launch_dq_tc<64>(q, k, v, dout, lse, delta, dq, bh, group, sq, sk, causal, scale, st);
  if (hd == 32)
    return launch_dq_tc<32>(q, k, v, dout, lse, delta, dq, bh, group, sq, sk, causal, scale, st);
  return kErrHeadDim;
}

// ws: float32 [splits, 2, BH / group, Sk, 256] when splits > 1 (hd 256 only:
// dK's and dV's partials), else unused (may be null)
int nd_flash_bwd_dkv_tc(int hd, const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, void* dk, void* dv, void* ws,
                        int bh, int group, int sq, int sk, int causal, float scale, int splits,
                        void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 256)
    return launch_dkv_tc<256>(q, k, v, dout, lse, delta, dk, dv, ws, bh, group, sq, sk, causal,
                              scale, splits, st);
  if (hd == 128)
    return launch_dkv_tc<128>(q, k, v, dout, lse, delta, dk, dv, ws, bh, group, sq, sk, causal,
                              scale, splits, st);
  if (hd == 96)
    return launch_dkv_tc<96>(q, k, v, dout, lse, delta, dk, dv, ws, bh, group, sq, sk, causal,
                             scale, splits, st);
  if (hd == 80)
    return launch_dkv_tc<80>(q, k, v, dout, lse, delta, dk, dv, ws, bh, group, sq, sk, causal,
                             scale, splits, st);
  if (hd == 64)
    return launch_dkv_tc<64>(q, k, v, dout, lse, delta, dk, dv, ws, bh, group, sq, sk, causal,
                             scale, splits, st);
  if (hd == 32)
    return launch_dkv_tc<32>(q, k, v, dout, lse, delta, dk, dv, ws, bh, group, sq, sk, causal,
                             scale, splits, st);
  return kErrHeadDim;
}

}  // extern "C"
