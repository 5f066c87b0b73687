// Flash attention on Hopper's tensor cores (sm_90a), bf16: forward (B1) and
// dK/dV (B3) at head dims 128, 64 and 32, dQ (B2) at head dim 128. The
// float32 path, B2 at hd 64 and 32, and the other head dims run on the FMA
// kernels of flash_attention.cu; ops/cuda/flash_attention.py holds the
// route table that picks one kernel per (kernel, dtype, head dim).
//
// Replaces the Pallas TPU kernels of nanodiloco_tpu/ops/pallas/flash_attention.py:
//   B1 flash_fwd_tc_kernel<HD>      <- _fwd_call / _fwd_kernel
//   B2 flash_bwd_dq_tc_kernel       <- _flash_bwd / _bwd_dq_kernel
//   B3 flash_bwd_dkv_tc_kernel<HD>  <- _flash_bwd / _bwd_dkv_kernel
// Layouts are the TPU kernels' own: q, o, dO, dQ [BH, Sq, HD]; k, v, dK, dV
// [BH / group, Sk, HD] (GQA: query head bh reads KV head bh / group); lse and
// delta [BH, Sq] float32.
//
// What bounds them. At the training shape (S 2048, hd 128, causal) B1 does
// two, B2 three and B3 four S x S x hd products per head on O(S x hd) bytes,
// some 300x above the card's ~295 flop/byte ridge; at moe-8x-top2's shape
// (S 1024, hd 64) still ~100x: all are bound by operations, and only the
// tensor cores (wgmma, 989 TFLOP/s in bf16) come near that bound. The FMA
// kernels they replace ran on the CUDA cores (67 TFLOP/s in f32) and reached
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
//   B3: one CTA per (KV head, 64-key tile), in the transposed form of the
//       FMA kernel so that no score tile goes through shared memory. K and V
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
//   B2: B1's grid and threads, with the online softmax replaced by the saved
//       lse. Q and dO stay resident (loaded once by TMA); the producer streams
//       64-key K and V tiles through a two-stage ring. Per tile each consumer
//       warpgroup issues S = Q K^T and dP = dO V^T back to back (SS wgmma,
//       m64n64k16, all K-major), forms P = exp(S scale - lse) and
//       dS = P (dP - delta) in registers, and adds dQ += dS K (RS wgmma, K
//       MN-major, the same shared tile read through a second descriptor).
//       64-key tiles, not B1's 128, keep a consumer thread near 150
//       registers: dQ (64) + S (32) + dP (32) + packed dS (16); 128-key tiles
//       would need over 224, more than 288 threads can hold without spills.
//       Each CTA owns its dQ rows: no atomics, deterministic.
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

constexpr int kHd = 128;  // B2's only head dim
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared-memory geometry of a bf16 tile of HD columns (hopper.cuh): rows of
// kSw bytes in boxes of min(HD, 64) columns, kSw also the swizzle.
template <int HD>
struct Tile {
  static constexpr int kSw = HD >= 64 ? 128 : 64;
  static constexpr int kBoxes = HD * 2 / kSw;  // TMA boxes a row: 2 at hd 128, else 1
  __host__ __device__ static constexpr uint32_t box(int rows) { return rows * kSw; }
  __host__ __device__ static constexpr uint32_t bytes(int rows) { return rows * HD * 2; }
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
        tma_load_3d(sQ + b * T::box(kFwdRows), &q_map, q_full, 64 * b, q0, bh);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt & 1;
        mbar_wait(empty(s), ((kt >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(full(s), 2 * L::kTile);
        for (int b = 0; b < T::kBoxes; ++b) {
          tma_load_3d(tile_k(s) + b * T::box(kFwdKeys), &k_map, full(s), 64 * b, kt * kFwdKeys,
                      bkv);
          tma_load_3d(tile_v(s) + b * T::box(kFwdKeys), &v_map, full(s), 64 * b, kt * kFwdKeys,
                      bkv);
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

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
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
      for (int i = 0; i < HD / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
      uint32_t pf[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) pf[j] = pack_bf16(sc[2 * j], sc[2 * j + 1]);

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kFwdKeys / 16; ++kk)
        wgmma_rs_tb<HD>(acc, pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2], pf[4 * kk + 3],
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
// B2: dQ. grid (BH, n q tiles), blockIdx.y reversed as in B1. Threads 0-255
// are the two consumer warpgroups, 256-287 the producer warp.
// ---------------------------------------------------------------------------
constexpr int kDqRows = 128;                          // q rows per CTA
constexpr int kDqKeys = 64;                           // keys per K/V tile
constexpr int kDqThreads = 288;
constexpr int kDqStages = 2;
constexpr uint32_t kDqRowBox = kDqRows * 128;         // a 64-column box of Q or dO: 16 KB
constexpr uint32_t kDqKeyBox = kDqKeys * 128;         // a 64-column box of K or V: 8 KB
constexpr uint32_t kDqQ = 0;
constexpr uint32_t kDqDo = 2 * kDqRowBox;
constexpr uint32_t kDqKv = 4 * kDqRowBox;             // stage s: K at + 4 s key boxes, V + 2 boxes
constexpr uint32_t kDqBars = kDqKv + kDqStages * 4 * kDqKeyBox;
constexpr size_t kDqSmem = 1024 + kDqBars + 64;

__global__ void __launch_bounds__(kDqThreads, 1)
    flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap do_map,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dq, int group, int sq, int sk, int causal,
                           float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base + kDqQ, sdO = base + kDqDo;
  const uint32_t bars = base + kDqBars;
  const uint32_t qdo_full = bars;
  // stage s: full at bars + 8 + 8 s, empty at bars + 8 + 8 (kDqStages + s)
  auto full = [&](int s) { return bars + 8 + 8 * s; };
  auto empty = [&](int s) { return bars + 8 + 8 * (kDqStages + s); };
  auto tile_k = [&](int s) { return base + kDqKv + 4 * kDqKeyBox * s; };
  auto tile_v = [&](int s) { return base + kDqKv + 4 * kDqKeyBox * s + 2 * kDqKeyBox; };

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kDqRows;
  const int nk = (sk + kDqKeys - 1) / kDqKeys;
  const int last_q = min(q0 + kDqRows, sq) - 1;
  const int n_kt = causal ? min(nk, last_q / kDqKeys + 1) : nk;

  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    for (int s = 0; s < kDqStages; ++s) {
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
      mbar_arrive_expect_tx(qdo_full, 4 * kDqRowBox);
      tma_load_3d(sQ, &q_map, qdo_full, 0, q0, bh);
      tma_load_3d(sQ + kDqRowBox, &q_map, qdo_full, 64, q0, bh);
      tma_load_3d(sdO, &do_map, qdo_full, 0, q0, bh);
      tma_load_3d(sdO + kDqRowBox, &do_map, qdo_full, 64, q0, bh);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kDqStages;
        mbar_wait(empty(s), ((kt / kDqStages) & 1) ^ 1);
        mbar_arrive_expect_tx(full(s), 4 * kDqKeyBox);
        tma_load_3d(tile_k(s), &k_map, full(s), 0, kt * kDqKeys, bkv);
        tma_load_3d(tile_k(s) + kDqKeyBox, &k_map, full(s), 64, kt * kDqKeys, bkv);
        tma_load_3d(tile_v(s), &v_map, full(s), 0, kt * kDqKeys, bkv);
        tma_load_3d(tile_v(s) + kDqKeyBox, &v_map, full(s), 64, kt * kDqKeys, bkv);
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
    const uint32_t qa = sQ + wg * 64 * 128;
    const uint32_t doa = sdO + wg * 64 * 128;

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

    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;

    mbar_wait(qdo_full, 0);
    for (int kt = 0; kt < n_kt_wg; ++kt) {
      const int s = kt % kDqStages;
      mbar_wait(full(s), (kt / kDqStages) & 1);

      float sc[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint32_t off_q = (kk >> 2) * kDqRowBox + (kk & 3) * 32;
        const uint32_t off_k = (kk >> 2) * kDqKeyBox + (kk & 3) * 32;
        wgmma_m64n64k16_ss(sc, smem_desc(qa + off_q, 16, 1024),
                           smem_desc(tile_k(s) + off_k, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint32_t off_q = (kk >> 2) * kDqRowBox + (kk & 3) * 32;
        const uint32_t off_k = (kk >> 2) * kDqKeyBox + (kk & 3) * 32;
        wgmma_m64n64k16_ss(dp, smem_desc(doa + off_q, 16, 1024),
                           smem_desc(tile_v(s) + off_k, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = exp2f(fmaf(sc[i], c, -lse2[(i >> 1) & 1]));
      const int kb = kt * kDqKeys;
      if (kb + kDqKeys > sk || (causal && kb + kDqKeys - 1 > row_min)) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = kb + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          const int row = row_lo + 8 * ((i >> 1) & 1);
          if (col >= sk || (causal && col > row)) sc[i] = 0.f;
        }
      }
      uint32_t dsf[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int h = j & 1;  // registers 2 j, 2 j + 1 share row half (2 j / 2) % 2
        dsf[j] = pack_bf16(sc[2 * j] * (dp[2 * j] - dlt[h]),
                           sc[2 * j + 1] * (dp[2 * j + 1] - dlt[h]));
      }

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n128k16_rs_tb(acc, dsf[4 * kk], dsf[4 * kk + 1], dsf[4 * kk + 2], dsf[4 * kk + 3],
                               smem_desc(tile_k(s) + kk * 16 * 128, kDqKeyBox, 1024), 1);
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
      uint32_t* out = reinterpret_cast<uint32_t*>(dq + (static_cast<size_t>(bh) * sq + row) * kHd);
#pragma unroll
      for (int j = 0; j < 16; ++j)
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
  // two CTAs an SM below hd 128 (the source note); one at hd 128, where a
  // cap of two spilled and serialized the wgmma
  static constexpr int kMinBlocks = HD == 128 ? 1 : 2;
};

template <int HD>
__global__ void __launch_bounds__(kDkvThreads, Dkv<HD>::kMinBlocks)
    flash_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const __grid_constant__ CUtensorMap do_map,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                            int group, int sq, int sk, int causal, float scale) {
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

  const int bkv = blockIdx.x;
  const int k0 = blockIdx.y * kDkvKeys;
  const int nq = (sq + kDkvQ - 1) / kDkvQ;
  // q tiles wholly above the diagonal (every query before this tile's first
  // key) contribute nothing under the causal mask
  const int qt_start = causal ? min(k0 / kDkvQ, nq) : 0;
  const int per_head = nq - qt_start;
  const int n_it = group * per_head;

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
        tma_load_3d(sK + b * T::box(kDkvKeys), &k_map, kv_full, 64 * b, k0, bkv);
        tma_load_3d(sV + b * T::box(kDkvKeys), &v_map, kv_full, 64 * b, k0, bkv);
      }
    }
    for (int it = 0; it < n_it; ++it) {
      const int s = it & 1;
      const int bh = bkv * group + it / per_head;
      const int q0 = (qt_start + it % per_head) * kDkvQ;
      mbar_wait(empty(s), ((it >> 1) & 1) ^ 1);
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
          tma_load_3d(tile_q(s) + b * T::box(kDkvQ), &q_map, full(s), 64 * b, q0, bh);
          tma_load_3d(tile_do(s) + b * T::box(kDkvQ), &do_map, full(s), 64 * b, q0, bh);
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

    float dk_acc[HD / 2], dv_acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_it; ++it) {
      const int s = it & 1;
      const int q0 = (qt_start + it % per_head) * kDkvQ;
      mbar_wait(full(s), (it >> 1) & 1);

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
        wgmma_rs_tb<HD>(dv_acc, pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2], pf[4 * kk + 3],
                        T::mnmajor(tile_do(s), kk, kDkvQ), 1);
#pragma unroll
      for (int kk = 0; kk < kDkvQ / 16; ++kk)
        wgmma_rs_tb<HD>(dk_acc, dsf[4 * kk], dsf[4 * kk + 1], dsf[4 * kk + 2], dsf[4 * kk + 3],
                        T::mnmajor(tile_q(s), kk, kDkvQ), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(pf);
      fence_regs(dsf);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = key_lo + 8 * h;
      if (key >= sk) continue;
      const size_t off = (static_cast<size_t>(bkv) * sk + key) * HD;
      uint32_t* dk_row = reinterpret_cast<uint32_t*>(dk + off);
      uint32_t* dv_row = reinterpret_cast<uint32_t*>(dv + off);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int i = 4 * j + 2 * h;
        dk_row[4 * j + (lane & 3)] = pack_bf16(dk_acc[i] * scale, dk_acc[i + 1] * scale);
        dv_row[4 * j + (lane & 3)] = pack_bf16(dv_acc[i], dv_acc[i + 1]);
      }
    }
  }
}

constexpr int kErrHeadDim = -1;
constexpr int kErrTensorMap = -2;

template <int HD>
int launch_fwd_tc(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                  int group, int sq, int sk, int causal, float scale, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  if (!bf16_rows_map(&qm, q, bh, sq, kFwdRows, HD) ||
      !bf16_rows_map(&km, k, bh / group, sk, kFwdKeys, HD) ||
      !bf16_rows_map(&vm, v, bh / group, sk, kFwdKeys, HD))
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
int launch_dkv_tc(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, void* dk, void* dv, int bh, int group,
                  int sq, int sk, int causal, float scale, cudaStream_t stream) {
  CUtensorMap qm, km, vm, dom;
  if (!bf16_rows_map(&qm, q, bh, sq, kDkvQ, HD) ||
      !bf16_rows_map(&km, k, bh / group, sk, kDkvKeys, HD) ||
      !bf16_rows_map(&vm, v, bh / group, sk, kDkvKeys, HD) ||
      !bf16_rows_map(&dom, dout, bh, sq, kDkvQ, HD))
    return kErrTensorMap;
  constexpr size_t smem = Dkv<HD>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_tc_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh / group, (sk + kDkvKeys - 1) / kDkvKeys);
  flash_bwd_dkv_tc_kernel<HD><<<grid, kDkvThreads, smem, stream>>>(
      qm, km, vm, dom, lse, delta, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      group, sq, sk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* nd_tc_error_string(int code) {
  if (code == kErrHeadDim)
    return "the tensor-core kernels take head dims 32, 64 and 128 (forward, dK/dV) and 128 "
           "(dQ)";
  if (code == kErrTensorMap)
    return "cuTensorMapEncodeTiled refused a tensor (alignment, strides or driver)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Each launcher returns cudaGetLastError() after the launch (0 = launched),
// or a negative code above. Tensors are bf16, contiguous, 16-byte aligned.
int nd_flash_fwd_tc(int hd, const void* q, const void* k, const void* v, void* o, float* lse,
                    int bh, int group, int sq, int sk, int causal, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 128) return launch_fwd_tc<128>(q, k, v, o, lse, bh, group, sq, sk, causal, scale, st);
  if (hd == 64) return launch_fwd_tc<64>(q, k, v, o, lse, bh, group, sq, sk, causal, scale, st);
  if (hd == 32) return launch_fwd_tc<32>(q, k, v, o, lse, bh, group, sq, sk, causal, scale, st);
  return kErrHeadDim;
}

int nd_flash_bwd_dq_tc(int hd, const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dq, int bh, int group, int sq,
                       int sk, int causal, float scale, void* stream) {
  if (hd != kHd) return kErrHeadDim;
  CUtensorMap qm, km, vm, dom;
  if (!bf16_rows_map(&qm, q, bh, sq, kDqRows, kHd) ||
      !bf16_rows_map(&km, k, bh / group, sk, kDqKeys, kHd) ||
      !bf16_rows_map(&vm, v, bh / group, sk, kDqKeys, kHd) ||
      !bf16_rows_map(&dom, dout, bh, sq, kDqRows, kHd))
    return kErrTensorMap;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kDqSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (sq + kDqRows - 1) / kDqRows);
  flash_bwd_dq_tc_kernel<<<grid, kDqThreads, kDqSmem, static_cast<cudaStream_t>(stream)>>>(
      qm, km, vm, dom, lse, delta, static_cast<__nv_bfloat16*>(dq), group, sq, sk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

int nd_flash_bwd_dkv_tc(int hd, const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, void* dk, void* dv, int bh,
                        int group, int sq, int sk, int causal, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 128)
    return launch_dkv_tc<128>(q, k, v, dout, lse, delta, dk, dv, bh, group, sq, sk, causal,
                              scale, st);
  if (hd == 64)
    return launch_dkv_tc<64>(q, k, v, dout, lse, delta, dk, dv, bh, group, sq, sk, causal,
                             scale, st);
  if (hd == 32)
    return launch_dkv_tc<32>(q, k, v, dout, lse, delta, dk, dv, bh, group, sq, sk, causal,
                             scale, st);
  return kErrHeadDim;
}

}  // extern "C"
