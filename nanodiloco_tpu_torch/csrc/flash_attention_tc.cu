// Flash attention on Hopper's tensor cores (sm_90a), bf16 at head dim 128:
// forward (B1), dQ (B2) and dK/dV (B3). The float32 path and the other head
// dims run on the FMA kernels of flash_attention.cu; ops/cuda/flash_attention.py
// holds the route table that picks one kernel per (kernel, dtype, head dim).
//
// Replaces the Pallas TPU kernels of nanodiloco_tpu/ops/pallas/flash_attention.py:
//   B1 flash_fwd_tc_kernel      <- _fwd_call / _fwd_kernel
//   B2 flash_bwd_dq_tc_kernel   <- _flash_bwd / _bwd_dq_kernel
//   B3 flash_bwd_dkv_tc_kernel  <- _flash_bwd / _bwd_dkv_kernel
// Layouts are the TPU kernels' own: q, o, dO, dQ [BH, Sq, 128]; k, v, dK, dV
// [BH / group, Sk, 128] (GQA: query head bh reads KV head bh / group); lse and
// delta [BH, Sq] float32.
//
// What bounds them. At the training shape (S 2048, causal) B1 does two, B2
// three and B3 four S x S x 128 products per head on O(S x 128) bytes, some
// 300x above the card's ~295 flop/byte ridge: all are bound by operations, and
// only the tensor cores (wgmma, 989 TFLOP/s in bf16) come near that bound. The
// FMA kernels they replace ran on the CUDA cores (67 TFLOP/s in f32) and
// reached about 22 of those.
//
// Design (the PTX building blocks are in hopper.cuh):
//   B1: one CTA per (bh, 128-row q tile), longest causal rows first. Two
//       consumer warpgroups own 64 q rows each; one producer warp loads Q once
//       and streams 128-key K and V tiles through a two-stage ring with TMA
//       (full/empty mbarrier pairs), so the next tile is in flight while the
//       current one is multiplied. S = Q K^T is an SS wgmma (m64n128k16, both
//       operands K-major); the online softmax runs on the accumulator
//       fragments in registers (exp2 with scale * log2 e folded in, row max
//       and sum over the four lanes that share a row); P is packed to bf16 in
//       registers and O += P V is an RS wgmma with V MN-major (trans-b).
//   B3: one CTA per (KV head, 64-key tile), in the transposed form of the
//       FMA kernel so that no score tile goes through shared memory. K and V
//       stay resident; a producer warp streams (Q, dO) tiles by TMA and
//       (lse, delta) rows by plain loads for each of the `group` query heads,
//       from the causal diagonal down, through a two-stage ring. One consumer
//       warpgroup computes S^T = K Q^T and dP^T = V dO^T (SS wgmma, m64n64k16),
//       P^T = exp(S^T scale - lse) and dS^T = P^T (dP^T - delta) in registers,
//       then dV += P^T dO and dK += dS^T Q (RS wgmma, dO and Q MN-major). The
//       group sum stays in the CTA's registers: no atomics, deterministic.
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
// Ragged lengths: tensor maps are 3-D {128, S, heads}, so rows past S read as
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

constexpr int kHd = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// B1: forward. grid (BH, n q tiles); blockIdx.y is reversed so the longest
// causal rows start first. Threads 0-255 are the two consumer warpgroups,
// 256-287 the producer warp.
// ---------------------------------------------------------------------------
constexpr int kFwdRows = 128;                         // q rows per CTA
constexpr int kFwdKeys = 128;                         // keys per K/V tile
constexpr int kFwdThreads = 288;
constexpr uint32_t kFwdBox = kFwdRows * 128;          // one 64-column box: 16 KB
constexpr uint32_t kFwdTile = 2 * kFwdBox;            // a 128 x 128 tile: 32 KB
constexpr uint32_t kFwdQ = 0;
constexpr uint32_t kFwdK = kFwdTile;                  // K[s] at kFwdK + s * 2 tiles
constexpr uint32_t kFwdBars = kFwdTile + 4 * kFwdTile;
constexpr size_t kFwdSmem = 1024 + kFwdBars + 64;     // + alignment slack, barriers

__global__ void __launch_bounds__(kFwdThreads, 1)
    flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int group,
                        int sq, int sk, int causal, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base + kFwdQ;
  const uint32_t bars = base + kFwdBars;
  const uint32_t q_full = bars;
  // stage s: full at bars + 8 + 8 s, empty at bars + 24 + 8 s
  auto full = [&](int s) { return bars + 8 + 8 * s; };
  auto empty = [&](int s) { return bars + 24 + 8 * s; };
  auto tile_k = [&](int s) { return base + kFwdK + 2 * kFwdTile * s; };
  auto tile_v = [&](int s) { return base + kFwdK + 2 * kFwdTile * s + kFwdTile; };

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
      mbar_arrive_expect_tx(q_full, kFwdTile);
      tma_load_3d(sQ, &q_map, q_full, 0, q0, bh);
      tma_load_3d(sQ + kFwdBox, &q_map, q_full, 64, q0, bh);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt & 1;
        mbar_wait(empty(s), ((kt >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(full(s), 2 * kFwdTile);
        tma_load_3d(tile_k(s), &k_map, full(s), 0, kt * kFwdKeys, bkv);
        tma_load_3d(tile_k(s) + kFwdBox, &k_map, full(s), 64, kt * kFwdKeys, bkv);
        tma_load_3d(tile_v(s), &v_map, full(s), 0, kt * kFwdKeys, bkv);
        tma_load_3d(tile_v(s) + kFwdBox, &v_map, full(s), 64, kt * kFwdKeys, bkv);
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
    const uint32_t qa = sQ + wg * 64 * 128;

    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
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
      for (int kk = 0; kk < 8; ++kk) {
        const uint32_t off = (kk >> 2) * kFwdBox + (kk & 3) * 32;
        wgmma_m64n128k16_ss(sc, smem_desc(qa + off, 16, 1024),
                            smem_desc(tile_k(s) + off, 16, 1024), kk > 0);
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
        acc[i] *= corr[h];
      }
      uint32_t pf[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) pf[j] = pack_bf16(sc[2 * j], sc[2 * j + 1]);

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_m64n128k16_rs_tb(acc, pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2], pf[4 * kk + 3],
                               smem_desc(tile_v(s) + kk * 16 * 128, kFwdBox, 1024), 1);
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
      uint32_t* out = reinterpret_cast<uint32_t*>(o + (static_cast<size_t>(bh) * sq + row) * kHd);
#pragma unroll
      for (int j = 0; j < 16; ++j)
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
constexpr uint32_t kDkvBox = 64 * 128;                // one 64-column box: 8 KB
constexpr uint32_t kDkvTile = 2 * kDkvBox;            // a 64 x 128 tile: 16 KB
constexpr uint32_t kDkvK = 0;
constexpr uint32_t kDkvV = kDkvTile;
constexpr uint32_t kDkvQt = 2 * kDkvTile;             // stage s: Q at + 2 s tiles, dO after it
constexpr uint32_t kDkvRows = 6 * kDkvTile;           // stage s: lse at + 512 s, delta + 256
constexpr uint32_t kDkvBars = kDkvRows + 1024;
constexpr size_t kDkvSmem = 1024 + kDkvBars + 64;

__global__ void __launch_bounds__(kDkvThreads, 1)
    flash_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const __grid_constant__ CUtensorMap do_map,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                            int group, int sq, int sk, int causal, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);  // generic pointer to the same bytes
  const uint32_t sK = base + kDkvK, sV = base + kDkvV;
  const uint32_t bars = base + kDkvBars;
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8 + 8 * s; };
  auto empty = [&](int s) { return bars + 24 + 8 * s; };
  auto tile_q = [&](int s) { return base + kDkvQt + 2 * kDkvTile * s; };
  auto tile_do = [&](int s) { return base + kDkvQt + 2 * kDkvTile * s + kDkvTile; };
  auto rows_lse = [&](int s) { return reinterpret_cast<float*>(gbase + kDkvRows + 512 * s); };
  auto rows_delta = [&](int s) {
    return reinterpret_cast<float*>(gbase + kDkvRows + 512 * s + 256);
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
      mbar_arrive_expect_tx(kv_full, 2 * kDkvTile);
      tma_load_3d(sK, &k_map, kv_full, 0, k0, bkv);
      tma_load_3d(sK + kDkvBox, &k_map, kv_full, 64, k0, bkv);
      tma_load_3d(sV, &v_map, kv_full, 0, k0, bkv);
      tma_load_3d(sV + kDkvBox, &v_map, kv_full, 64, k0, bkv);
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
        mbar_arrive_expect_tx(full(s), 2 * kDkvTile);
        tma_load_3d(tile_q(s), &q_map, full(s), 0, q0, bh);
        tma_load_3d(tile_q(s) + kDkvBox, &q_map, full(s), 64, q0, bh);
        tma_load_3d(tile_do(s), &do_map, full(s), 0, q0, bh);
        tma_load_3d(tile_do(s) + kDkvBox, &do_map, full(s), 64, q0, bh);
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

    float dk_acc[64], dv_acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dk_acc[i] = dv_acc[i] = 0.f;

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
      for (int kk = 0; kk < 8; ++kk) {
        const uint32_t off = (kk >> 2) * kDkvBox + (kk & 3) * 32;
        wgmma_m64n64k16_ss(st, smem_desc(sK + off, 16, 1024),
                           smem_desc(tile_q(s) + off, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint32_t off = (kk >> 2) * kDkvBox + (kk & 3) * 32;
        wgmma_m64n64k16_ss(dpt, smem_desc(sV + off, 16, 1024),
                           smem_desc(tile_do(s) + off, 16, 1024), kk > 0);
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
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n128k16_rs_tb(dv_acc, pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2],
                               pf[4 * kk + 3],
                               smem_desc(tile_do(s) + kk * 16 * 128, kDkvBox, 1024), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n128k16_rs_tb(dk_acc, dsf[4 * kk], dsf[4 * kk + 1], dsf[4 * kk + 2],
                               dsf[4 * kk + 3],
                               smem_desc(tile_q(s) + kk * 16 * 128, kDkvBox, 1024), 1);
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
      const size_t off = (static_cast<size_t>(bkv) * sk + key) * kHd;
      uint32_t* dk_row = reinterpret_cast<uint32_t*>(dk + off);
      uint32_t* dv_row = reinterpret_cast<uint32_t*>(dv + off);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int i = 4 * j + 2 * h;
        dk_row[4 * j + (lane & 3)] = pack_bf16(dk_acc[i] * scale, dk_acc[i + 1] * scale);
        dv_row[4 * j + (lane & 3)] = pack_bf16(dv_acc[i], dv_acc[i + 1]);
      }
    }
  }
}

constexpr int kErrHeadDim = -1;
constexpr int kErrTensorMap = -2;

}  // namespace

extern "C" {

const char* nd_tc_error_string(int code) {
  if (code == kErrHeadDim) return "the tensor-core kernels take head dim 128 only";
  if (code == kErrTensorMap)
    return "cuTensorMapEncodeTiled refused a tensor (alignment, strides or driver)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Each launcher returns cudaGetLastError() after the launch (0 = launched),
// or a negative code above. Tensors are bf16, contiguous, 16-byte aligned.
int nd_flash_fwd_tc(int hd, const void* q, const void* k, const void* v, void* o, float* lse,
                    int bh, int group, int sq, int sk, int causal, float scale, void* stream) {
  if (hd != kHd) return kErrHeadDim;
  CUtensorMap qm, km, vm;
  if (!bf16_rows_map(&qm, q, bh, sq, kFwdRows) || !bf16_rows_map(&km, k, bh / group, sk, kFwdKeys) ||
      !bf16_rows_map(&vm, v, bh / group, sk, kFwdKeys))
    return kErrTensorMap;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kFwdSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (sq + kFwdRows - 1) / kFwdRows);
  flash_fwd_tc_kernel<<<grid, kFwdThreads, kFwdSmem, static_cast<cudaStream_t>(stream)>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), lse, group, sq, sk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

int nd_flash_bwd_dq_tc(int hd, const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dq, int bh, int group, int sq,
                       int sk, int causal, float scale, void* stream) {
  if (hd != kHd) return kErrHeadDim;
  CUtensorMap qm, km, vm, dom;
  if (!bf16_rows_map(&qm, q, bh, sq, kDqRows) || !bf16_rows_map(&km, k, bh / group, sk, kDqKeys) ||
      !bf16_rows_map(&vm, v, bh / group, sk, kDqKeys) || !bf16_rows_map(&dom, dout, bh, sq, kDqRows))
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
  if (hd != kHd) return kErrHeadDim;
  CUtensorMap qm, km, vm, dom;
  if (!bf16_rows_map(&qm, q, bh, sq, kDkvQ) || !bf16_rows_map(&km, k, bh / group, sk, kDkvKeys) ||
      !bf16_rows_map(&vm, v, bh / group, sk, kDkvKeys) || !bf16_rows_map(&dom, dout, bh, sq, kDkvQ))
    return kErrTensorMap;
  cudaError_t err =
      cudaFuncSetAttribute(flash_bwd_dkv_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kDkvSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh / group, (sk + kDkvKeys - 1) / kDkvKeys);
  flash_bwd_dkv_tc_kernel<<<grid, kDkvThreads, kDkvSmem, static_cast<cudaStream_t>(stream)>>>(
      qm, km, vm, dom, lse, delta, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      group, sq, sk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
