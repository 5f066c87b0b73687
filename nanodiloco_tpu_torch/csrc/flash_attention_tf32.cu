// Flash attention backward for float32 on Hopper (sm_90a): dQ (B2) and dK/dV
// (B3) as three-product TF32 ("3xTF32") on the tensor cores.
//
// Replaces, for float32 inputs, two of the Pallas TPU kernels of
// nanodiloco_tpu/ops/pallas/flash_attention.py:
//   B2 flash_bwd_dq_tf32_kernel  <- _flash_bwd / _bwd_dq_kernel
//   B3 flash_bwd_dkv_tf32_kernel <- _flash_bwd / _bwd_dkv_kernel
// (the forward, B1, stays on the FMA kernel of flash_attention.cu; bf16 runs
// flash_attention_tc.cu). Layouts are flash_attention.cu's: q, dO, dQ
// [BH, Sq, HD]; k, v, dK, dV [BH / group, Sk, HD]; lse, delta [BH, Sq]; all
// float32. Head dims 16, 32, 64, 80, 96 and 128.
//
// Bound on the H100. B2 does 3 and B3 4 S x S x HD products per head on
// O(S x HD) bytes: operations bound both. The CUDA cores' float32 peak is
// 67 TFLOP/s; the tensor cores take TF32 at 495. One TF32 product keeps 10
// mantissa bits (2^-11), which does not hold the float32 tolerance (1e-4 of
// max|ref|); three products (hopper.cuh: lo hi + hi lo + hi hi, small terms
// first) keep about 2^-22, and give float32-accurate products at 495 / 3 =
// 165 TFLOP/s. That is how torch's memory-efficient attention computes its
// float32 products (cutlass OpMultiplyAddFastF32 on GemmShape<16, 8, 8>).
// The products are mma.sync m16n8k8, not wgmma: wgmma's tf32 takes both
// operands K-major only, and dV += P^T dO, dK += dS^T Q, dQ += dS K read dO,
// Q and K along their rows (MN-major), which would need a transposed copy of
// every tile; mma.sync's B fragment reads any layout from shared memory.
//
// Design. 128 threads, four warps of 16 rows of a 64-row tile. Every tile
// lies row-major in shared memory with a row stride of HD + 4 floats
// (= 4 mod 8): both fragment reads, (row g, column t) and (row 2t, column g),
// then hit 32 different banks, without a swizzle.
//   B3: a CTA owns one 64-key tile of one KV head and walks a contiguous
//       part of its list of (group member, q tile) pairs, from the diagonal
//       down. K and V are split into hi and lo once, in shared memory; each
//       pair's Q, dO, lse and delta arrive by cp.async (double-buffered
//       below hd 128: the next pair's copies fly during this pair's
//       products; single at hd 128, where K and V's hi and lo and one Q and
//       dO tile take 203 KB). S^T = K Q^T and dP^T = V dO^T come out of
//       mma.sync with K and V as A; P^T and dS^T stay in registers, split
//       there, and are the A operand of dV += P^T dO and dK += dS^T Q.
//   B2: a CTA owns one 64-row q tile of one head and walks a contiguous
//       part of its K tiles; Q and dO are split once, K and V stream in by
//       cp.async; dS stays in registers as the A operand of dQ += dS K.
// Up to hd 64 each streamed tile is split once a step into hi and lo tiles
// beside it; at hd 80-128, where those do not fit beside double buffers,
// its fragments are split as they are read (each element once a read by
// each of the four warps). The split is what the loop issues most:
// cvt.rna.tf32.f32 is four instructions in SASS (add, isfinite test,
// select, mask), a split seven.
// A ragged length is masked inside: rows past the end load as zeros
// (cp.async with src-size 0), their p as 0. A row whose lse is +inf gets
// p = 0 and a zero dQ row, never NaN.
//
// Grids that fill the card without atomics. The wrapper splits each CTA's
// loop into `splits` contiguous parts, one CTA each (grid z), so that
// small shapes launch at least two waves of 132 CTAs. With splits > 1 each
// part stores its float32 partial to a workspace [splits, outs, n], and
// sum_parts_kernel adds the parts in a fixed order, scales and stores: two
// launches give the same bits (bit-exact resume needs that). With
// splits == 1 a CTA stores its output directly.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::cp_async16;
using hopper::cp_async4;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::mma_3xtf32;
using hopper::smem_addr;
using hopper::split_tf32;

constexpr int kTile = 64;     // rows of every q and K tile
constexpr int kThreads = 128;  // four warps, 16 rows of a tile each

constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Layout {
  static constexpr int kLd = HD + 4;                // row stride in floats, = 4 mod 8
  static constexpr int kFloats = kTile * kLd;       // one tile
  static constexpr int kStages = HD == 128 ? 1 : 2;  // buffers of each streamed tile
  // streamed tiles split once a step into hi and lo tiles (else as each
  // fragment is read: 4 warps x 1-2 reads of every element), where the
  // extra tiles fit: up to hd 64
  static constexpr bool kPresplit = HD <= 64;
  static constexpr int kSteps = HD / 8;             // k-steps (or n-tiles) over HD
  // k-steps of the first products unrolled; not at hd 128, where two
  // spill (ptxas: 255 registers, 16 bytes)
  static constexpr int kUnroll = HD == 128 ? 1 : 2;
  // tiles in shared memory: 4 split loop-invariant tiles, then 2 streamed
  // operands x kStages buffers, each a raw (or hi) tile and, split, a lo tile
  static constexpr int kTiles = 4 + 2 * kStages * (kPresplit ? 2 : 1);
  static_assert(HD % 16 == 0 && HD <= 128, "head dim");
};

// Rows [row0, row0 + 64) of a row-major [n_rows, HD] float32 matrix into a
// shared tile by cp.async, 16 bytes a copy; rows at or past n_rows are zeros.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int row0,
                                          int n_rows) {
  constexpr int kPerRow = HD / 4;
#pragma unroll
  for (int c = threadIdx.x; c < kTile * kPerRow; c += kThreads) {
    const int r = c / kPerRow;
    const int col = (c % kPerRow) * 4;
    const bool in = row0 + r < n_rows;
    const float* p = src + static_cast<size_t>(in ? row0 + r : 0) * HD + col;
    cp_async16(smem_addr(dst + r * Layout<HD>::kLd + col), p, in ? 16 : 0);
  }
}

// A raw tile into its hi part (in place) and its lo part.
template <int HD>
__device__ __forceinline__ void split_tile(float* hi, float* lo) {
  constexpr int kPerRow = HD / 4;
#pragma unroll
  for (int c = threadIdx.x; c < kTile * kPerRow; c += kThreads) {
    const int e = (c / kPerRow) * Layout<HD>::kLd + (c % kPerRow) * 4;
    float4 x = *reinterpret_cast<float4*>(hi + e);
    uint32_t h[4], l[4];
    split_tf32(x.x, h[0], l[0]);
    split_tf32(x.y, h[1], l[1]);
    split_tf32(x.z, h[2], l[2]);
    split_tf32(x.w, h[3], l[3]);
    *reinterpret_cast<uint4*>(hi + e) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + e) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// The A fragment (hi, lo) of rows [r0, r0 + 16), k-step kk, of a split tile.
template <int HD>
__device__ __forceinline__ void a_frag(const float* hi, const float* lo, int r0, int kk,
                                       uint32_t (&a_hi)[4], uint32_t (&a_lo)[4]) {
  constexpr int kLd = Layout<HD>::kLd;
  const int lane = threadIdx.x & 31;
  const int e = (r0 + (lane >> 2)) * kLd + kk * 8 + (lane & 3);
  const int offs[4] = {0, 8 * kLd, 4, 8 * kLd + 4};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a_hi[i] = __float_as_uint(hi[e + offs[i]]);
    a_lo[i] = __float_as_uint(lo[e + offs[i]]);
  }
}

// A streamed tile: its hi and lo tiles where the layout splits it once a
// step (kPresplit), else its raw tile (lo unused), split as it is read.
struct Streamed {
  const float* hi;
  const float* lo;
};

// B fragment elements e0, e1 of a streamed tile, split.
template <int HD>
__device__ __forceinline__ void b_pair(Streamed x, int e0, int e1, uint32_t (&b_hi)[2],
                                       uint32_t (&b_lo)[2]) {
  if constexpr (Layout<HD>::kPresplit) {
    b_hi[0] = __float_as_uint(x.hi[e0]);
    b_hi[1] = __float_as_uint(x.hi[e1]);
    b_lo[0] = __float_as_uint(x.lo[e0]);
    b_lo[1] = __float_as_uint(x.lo[e1]);
  } else {
    split_tf32(x.hi[e0], b_hi[0], b_lo[0]);
    split_tf32(x.hi[e1], b_hi[1], b_lo[1]);
  }
}

// The split B fragment of X^T for S = A X^T: X's rows [n0, n0 + 8) are the
// n columns, its columns 8 kk .. 8 kk + 7 the k rows.
template <int HD>
__device__ __forceinline__ void bt_frag(Streamed x, int n0, int kk, uint32_t (&b_hi)[2],
                                        uint32_t (&b_lo)[2]) {
  const int lane = threadIdx.x & 31;
  const int e = (n0 + (lane >> 2)) * Layout<HD>::kLd + kk * 8 + (lane & 3);
  b_pair<HD>(x, e, e + 4, b_hi, b_lo);
}

// The split B fragment of X for D = A X over k rows [k0, k0 + 8) in the
// permuted order (k = t is row k0 + 2t, k = t + 4 row k0 + 2t + 1) and
// columns [n0, n0 + 8).
template <int HD>
__device__ __forceinline__ void b_frag(Streamed x, int k0, int n0, uint32_t (&b_hi)[2],
                                       uint32_t (&b_lo)[2]) {
  constexpr int kLd = Layout<HD>::kLd;
  const int lane = threadIdx.x & 31;
  const int e = (k0 + 2 * (lane & 3)) * kLd + n0 + (lane >> 2);
  b_pair<HD>(x, e, e + kLd, b_hi, b_lo);
}

// An accumulator tile [16 x 8] as the split A fragment of the next product
// (k = t is its column 2t, k = t + 4 its column 2t + 1).
__device__ __forceinline__ void acc_frag(const float (&c)[4], uint32_t (&a_hi)[4],
                                         uint32_t (&a_lo)[4]) {
  split_tf32(c[0], a_hi[0], a_lo[0]);
  split_tf32(c[2], a_hi[1], a_lo[1]);
  split_tf32(c[1], a_hi[2], a_lo[2]);
  split_tf32(c[3], a_hi[3], a_lo[3]);
}

// acc[n][*] (rows r0 + g, r0 + g + 8 of a [rows, HD] matrix at `out`, row
// stride HD) times `scale`, stored as float2 pairs; rows at or past n_rows
// are not stored.
template <int HD>
__device__ __forceinline__ void store_rows(float* out, const float (&acc)[HD / 8][4], int r0,
                                           int n_rows, float scale) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + (lane >> 2) + 8 * h;
    if (row >= n_rows) continue;
    float* p = out + static_cast<size_t>(row) * HD + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<float2*>(p + 8 * n) =
          make_float2(acc[n][2 * h] * scale, acc[n][2 * h + 1] * scale);
  }
}

// Zeros in rows r0 + g, r0 + g + 8 of `out` (an empty part's partial). Not
// inlined: inlined, it takes B3's registers at hd 128 past the 255 a thread
// has (ptxas spills 20 bytes).
template <int HD>
__device__ __noinline__ void store_zero_rows(float* out, int r0, int n_rows) {
  const float zero[HD / 8][4] = {};
  store_rows<HD>(out, zero, r0, n_rows, 1.f);
}

// ---------------------------------------------------------------------------
// B3: dK and dV. grid (BH / group, nk, splits). Part z of K tile y walks
// pairs [z n / splits, (z + 1) n / splits) of the n = group x (nq - qt0)
// pairs (g, qt), g-major, qt0 = y under the causal mask (q tiles wholly
// above the diagonal contribute nothing), else 0. Its dK and dV go to
// dk + z * part_stride and dv + z * part_stride, dK times dk_scale.
// ---------------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              float* __restrict__ dk, float* __restrict__ dv, size_t part_stride,
                              int group, int sq, int sk, int causal, float scale, float dk_scale,
                              int splits) {
  using L = Layout<HD>;
  extern __shared__ __align__(16) float smem[];
  float* sKhi = smem;
  float* sKlo = sKhi + L::kFloats;
  float* sVhi = sKlo + L::kFloats;
  float* sVlo = sVhi + L::kFloats;
  float* sQ = sVlo + L::kFloats;              // [kStages] raw (or hi) tiles
  float* sdO = sQ + L::kStages * L::kFloats;  // [kStages] raw (or hi) tiles
  float* sQlo = sdO + L::kStages * L::kFloats;  // [kStages] lo tiles, if kPresplit
  float* sdOlo = sQlo + (L::kPresplit ? L::kStages * L::kFloats : 0);
  float* sRows = smem + L::kTiles * L::kFloats;  // [kStages][lse 64, delta 64]

  const int bkv = blockIdx.x;
  const int k0 = blockIdx.y * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int nq = (sq + kTile - 1) / kTile;
  const int qt0 = causal ? blockIdx.y : 0;
  const int per_head = max(nq - qt0, 0);
  const int n = group * per_head;
  const int i0 = static_cast<int>(static_cast<long long>(blockIdx.z) * n / splits);
  const int i1 = static_cast<int>(static_cast<long long>(blockIdx.z + 1) * n / splits);
  const int r0 = warp * 16;  // this warp's key rows in the tile
  if (i0 == i1) {  // an empty part (causal K tiles near the end have few pairs)
    const size_t off = blockIdx.z * part_stride + static_cast<size_t>(bkv) * sk * HD;
    store_zero_rows<HD>(dk + off, k0 + r0, sk);
    store_zero_rows<HD>(dv + off, k0 + r0, sk);
    return;
  }

  load_tile<HD>(sKhi, k + static_cast<size_t>(bkv) * sk * HD, k0, sk);
  load_tile<HD>(sVhi, v + static_cast<size_t>(bkv) * sk * HD, k0, sk);
  cp_async_commit();

  // pair i's Q, dO, lse and delta into buffer `stage`
  auto load_pair = [&](int i, int stage) {
    const size_t bh = static_cast<size_t>(bkv) * group + i / per_head;
    const int q0 = (qt0 + i % per_head) * kTile;
    load_tile<HD>(sQ + stage * L::kFloats, q + bh * sq * HD, q0, sq);
    load_tile<HD>(sdO + stage * L::kFloats, dout + bh * sq * HD, q0, sq);
    const int r = threadIdx.x & 63;
    const bool in = q0 + r < sq;
    const float* src = (threadIdx.x < 64 ? lse : delta) + bh * sq + (in ? q0 + r : 0);
    cp_async4(smem_addr(sRows + stage * 2 * kTile + threadIdx.x), src, in ? 4 : 0);
  };
  load_pair(i0, 0);
  cp_async_commit();
  cp_async_wait<1>();  // K and V have landed
  __syncthreads();
  split_tile<HD>(sKhi, sKlo);
  split_tile<HD>(sVhi, sVlo);

  float dk_acc[HD / 8][4], dv_acc[HD / 8][4];
#pragma unroll
  for (int n8 = 0; n8 < HD / 8; ++n8)
#pragma unroll
    for (int r = 0; r < 4; ++r) dk_acc[n8][r] = dv_acc[n8][r] = 0.f;

  // this thread's key rows attend to the queries [q_lo, q_lo + q_span)
  int q_lo[2], q_span[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kr = k0 + r0 + g4 + 8 * h;
    q_lo[h] = causal ? kr : 0;
    q_span[h] = kr < sk ? max(sq - q_lo[h], 0) : 0;
  }
  const float scale2 = scale * kLog2e;
  for (int i = i0; i < i1; ++i) {
    const int stage = L::kStages == 1 ? 0 : (i - i0) & 1;
    if constexpr (L::kStages == 2) {
      if (i + 1 < i1) load_pair(i + 1, stage ^ 1);
      cp_async_commit();   // empty when there is no next pair
      cp_async_wait<1>();  // pair i has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const Streamed cQ = {sQ + stage * L::kFloats, sQlo + stage * L::kFloats};
    const Streamed cdO = {sdO + stage * L::kFloats, sdOlo + stage * L::kFloats};
    if constexpr (L::kPresplit) {
      split_tile<HD>(sQ + stage * L::kFloats, sQlo + stage * L::kFloats);
      split_tile<HD>(sdO + stage * L::kFloats, sdOlo + stage * L::kFloats);
      __syncthreads();
    }
    const float* cLse = sRows + stage * 2 * kTile;
    const float* cDelta = cLse + kTile;
    const int q0 = (qt0 + i % per_head) * kTile;

    // S^T = K Q^T, then P^T in place
    float p[8][4], ds[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) p[j][r] = ds[j][r] = 0.f;
#pragma unroll(L::kUnroll)
    for (int kk = 0; kk < L::kSteps; ++kk) {
      uint32_t a_hi[4], a_lo[4];
      a_frag<HD>(sKhi, sKlo, r0, kk, a_hi, a_lo);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t b_hi[2], b_lo[2];
        bt_frag<HD>(cQ, 8 * j, kk, b_hi, b_lo);
        mma_3xtf32(p[j], a_hi, a_lo, b_hi, b_lo);
      }
    }
    // dP^T = V dO^T
#pragma unroll(L::kUnroll)
    for (int kk = 0; kk < L::kSteps; ++kk) {
      uint32_t a_hi[4], a_lo[4];
      a_frag<HD>(sVhi, sVlo, r0, kk, a_hi, a_lo);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t b_hi[2], b_lo[2];
        bt_frag<HD>(cdO, 8 * j, kk, b_hi, b_lo);
        mma_3xtf32(ds[j], a_hi, a_lo, b_hi, b_lo);
      }
    }
    // P = exp(S scale - lse), dS = P (dP - delta), masked
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int h = r >> 1;
        const int qc = 8 * j + 2 * t4 + (r & 1);
        const bool ok = static_cast<unsigned>(q0 + qc - q_lo[h]) <
                        static_cast<unsigned>(q_span[h]);
        const float pv = ok ? exp2f(fmaf(p[j][r], scale2, -cLse[qc] * kLog2e)) : 0.f;
        p[j][r] = pv;
        ds[j][r] = pv * (ds[j][r] - cDelta[qc]);
      }
    // dV += P^T dO, then dK += dS^T Q (P's registers free by then), over
    // this pair's 64 queries
#pragma unroll
    for (int kq = 0; kq < 8; ++kq) {
      uint32_t a_hi[4], a_lo[4];
      acc_frag(p[kq], a_hi, a_lo);
#pragma unroll
      for (int n8 = 0; n8 < HD / 8; ++n8) {
        uint32_t b_hi[2], b_lo[2];
        b_frag<HD>(cdO, 8 * kq, 8 * n8, b_hi, b_lo);
        mma_3xtf32(dv_acc[n8], a_hi, a_lo, b_hi, b_lo);
      }
    }
#pragma unroll
    for (int kq = 0; kq < 8; ++kq) {
      uint32_t a_hi[4], a_lo[4];
      acc_frag(ds[kq], a_hi, a_lo);
#pragma unroll
      for (int n8 = 0; n8 < HD / 8; ++n8) {
        uint32_t b_hi[2], b_lo[2];
        b_frag<HD>(cQ, 8 * kq, 8 * n8, b_hi, b_lo);
        mma_3xtf32(dk_acc[n8], a_hi, a_lo, b_hi, b_lo);
      }
    }
    __syncthreads();  // every warp is done with this buffer
    if constexpr (L::kStages == 1) {
      if (i + 1 < i1) load_pair(i + 1, 0);
      cp_async_commit();
    }
  }

  const size_t off = blockIdx.z * part_stride + static_cast<size_t>(bkv) * sk * HD;
  store_rows<HD>(dk + off, dk_acc, k0 + r0, sk, dk_scale);
  store_rows<HD>(dv + off, dv_acc, k0 + r0, sk, 1.f);
}

// ---------------------------------------------------------------------------
// B2: dQ. grid (BH, nq, splits); the y index is reversed so that the longest
// causal rows start first. Part z of a q tile walks K tiles
// [z n / splits, (z + 1) n / splits) of the n it attends to; its dQ goes to
// dq + z * part_stride, times dq_scale.
// ---------------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             float* __restrict__ dq, size_t part_stride, int group, int sq,
                             int sk, int causal, float scale, float dq_scale, int splits) {
  using L = Layout<HD>;
  extern __shared__ __align__(16) float smem[];
  float* sQhi = smem;
  float* sQlo = sQhi + L::kFloats;
  float* sdOhi = sQlo + L::kFloats;
  float* sdOlo = sdOhi + L::kFloats;
  float* sK = sdOlo + L::kFloats;            // [kStages] raw (or hi) tiles
  float* sV = sK + L::kStages * L::kFloats;  // [kStages] raw (or hi) tiles
  float* sKlo = sV + L::kStages * L::kFloats;  // [kStages] lo tiles, if kPresplit
  float* sVlo = sKlo + (L::kPresplit ? L::kStages * L::kFloats : 0);

  const size_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int nk = (sk + kTile - 1) / kTile;
  const int n = causal ? min(nk, (min(q0 + kTile, sq) - 1) / kTile + 1) : nk;
  const int i0 = static_cast<int>(static_cast<long long>(blockIdx.z) * n / splits);
  const int i1 = static_cast<int>(static_cast<long long>(blockIdx.z + 1) * n / splits);
  const float* kb = k + (bh / group) * sk * HD;
  const float* vb = v + (bh / group) * sk * HD;
  const int r0 = warp * 16;  // this warp's q rows in the tile
  float* out = dq + blockIdx.z * part_stride + bh * sq * HD;
  if (i0 == i1) {  // an empty part (causal q tiles near the start have few K tiles)
    store_zero_rows<HD>(out, q0 + r0, sq);
    return;
  }

  load_tile<HD>(sQhi, q + bh * sq * HD, q0, sq);
  load_tile<HD>(sdOhi, dout + bh * sq * HD, q0, sq);
  cp_async_commit();
  auto load_kv = [&](int kt, int stage) {
    load_tile<HD>(sK + stage * L::kFloats, kb, kt * kTile, sk);
    load_tile<HD>(sV + stage * L::kFloats, vb, kt * kTile, sk);
  };
  load_kv(i0, 0);
  cp_async_commit();

  // this thread's q rows: lse (in log2 units), delta, and the keys
  // [0, k_end) they attend to
  float lse2_r[2], delta_r[2];
  int k_end[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = q0 + r0 + g4 + 8 * h;
    lse2_r[h] = qi < sq ? lse[bh * sq + qi] * kLog2e : 0.f;
    delta_r[h] = qi < sq ? delta[bh * sq + qi] : 0.f;
    k_end[h] = qi < sq ? (causal ? min(sk, qi + 1) : sk) : 0;
  }
  const float scale2 = scale * kLog2e;
  float dq_acc[HD / 8][4];
#pragma unroll
  for (int n8 = 0; n8 < HD / 8; ++n8)
#pragma unroll
    for (int r = 0; r < 4; ++r) dq_acc[n8][r] = 0.f;

  cp_async_wait<1>();  // Q and dO have landed
  __syncthreads();
  split_tile<HD>(sQhi, sQlo);
  split_tile<HD>(sdOhi, sdOlo);

  for (int kt = i0; kt < i1; ++kt) {
    const int stage = L::kStages == 1 ? 0 : (kt - i0) & 1;
    if constexpr (L::kStages == 2) {
      if (kt + 1 < i1) load_kv(kt + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const Streamed cK = {sK + stage * L::kFloats, sKlo + stage * L::kFloats};
    const Streamed cV = {sV + stage * L::kFloats, sVlo + stage * L::kFloats};
    if constexpr (L::kPresplit) {
      split_tile<HD>(sK + stage * L::kFloats, sKlo + stage * L::kFloats);
      split_tile<HD>(sV + stage * L::kFloats, sVlo + stage * L::kFloats);
      __syncthreads();
    }

    // S = Q K^T, dP = dO V^T
    float p[8][4], ds[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) p[j][r] = ds[j][r] = 0.f;
#pragma unroll(L::kUnroll)
    for (int kk = 0; kk < L::kSteps; ++kk) {
      uint32_t a_hi[4], a_lo[4];
      a_frag<HD>(sQhi, sQlo, r0, kk, a_hi, a_lo);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t b_hi[2], b_lo[2];
        bt_frag<HD>(cK, 8 * j, kk, b_hi, b_lo);
        mma_3xtf32(p[j], a_hi, a_lo, b_hi, b_lo);
      }
    }
#pragma unroll(L::kUnroll)
    for (int kk = 0; kk < L::kSteps; ++kk) {
      uint32_t a_hi[4], a_lo[4];
      a_frag<HD>(sdOhi, sdOlo, r0, kk, a_hi, a_lo);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t b_hi[2], b_lo[2];
        bt_frag<HD>(cV, 8 * j, kk, b_hi, b_lo);
        mma_3xtf32(ds[j], a_hi, a_lo, b_hi, b_lo);
      }
    }
    // P = exp(S scale - lse), dS = P (dP - delta), masked
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int h = r >> 1;
        const int kj = kt * kTile + 8 * j + 2 * t4 + (r & 1);
        const float pv = kj < k_end[h] ? exp2f(fmaf(p[j][r], scale2, -lse2_r[h])) : 0.f;
        ds[j][r] = pv * (ds[j][r] - delta_r[h]);
      }
    // dQ += dS K over this tile's 64 keys
#pragma unroll
    for (int kj = 0; kj < 8; ++kj) {
      uint32_t s_hi[4], s_lo[4];
      acc_frag(ds[kj], s_hi, s_lo);
#pragma unroll
      for (int n8 = 0; n8 < HD / 8; ++n8) {
        uint32_t b_hi[2], b_lo[2];
        b_frag<HD>(cK, 8 * kj, 8 * n8, b_hi, b_lo);
        mma_3xtf32(dq_acc[n8], s_hi, s_lo, b_hi, b_lo);
      }
    }
    __syncthreads();  // every warp is done with this buffer
    if constexpr (L::kStages == 1) {
      if (kt + 1 < i1) load_kv(kt + 1, 0);
      cp_async_commit();
    }
  }

  store_rows<HD>(out, dq_acc, q0 + r0, sq, dq_scale);
}

// ---------------------------------------------------------------------------
// The second pass of a split launch: out_o[j] = scale_o * sum over parts p
// in order 0, 1, ... of ws[p][o][j], for outputs o < outs (1 or 2), in
// float4s.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256)
    sum_parts_kernel(const float4* __restrict__ ws, int splits, size_t n4, int outs,
                     float4* __restrict__ out0, float scale0, float4* __restrict__ out1,
                     float scale1) {
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
    (o ? out1 : out0)[j] = make_float4(acc.x * s, acc.y * s, acc.z * s, acc.w * s);
  }
}

int sum_parts(const float* ws, int splits, size_t n, int outs, float* out0, float scale0,
              float* out1, float scale1, cudaStream_t stream) {
  const size_t n4 = n / 4;  // n = rows x HD, HD a multiple of 16
  const size_t blocks = (n4 * outs + 255) / 256;
  sum_parts_kernel<<<static_cast<unsigned>(blocks < 2112 ? blocks : 2112), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(ws), splits, n4, outs, reinterpret_cast<float4*>(out0),
      scale0, reinterpret_cast<float4*>(out1), scale1);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Launchers. Each returns cudaGetLastError() after its launches (0 =
// launched); -1 for a head dim not instantiated, -2 for a split count out of
// range or a split launch without a workspace.
// ---------------------------------------------------------------------------
template <int HD>
constexpr size_t dkv_smem() {
  using L = Layout<HD>;
  return (L::kTiles * L::kFloats + L::kStages * 2 * kTile) * sizeof(float);
}
template <int HD>
constexpr size_t dq_smem() {
  using L = Layout<HD>;
  return L::kTiles * L::kFloats * sizeof(float);
}

bool bad_split(int splits, const void* ws) {
  return splits < 1 || splits > 65535 || (splits > 1 && ws == nullptr);
}

template <int HD>
int launch_dq_tf32(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dq, void* ws, int bh, int group,
                   int sq, int sk, int causal, float scale, int splits, cudaStream_t stream) {
  if (bad_split(splits, ws)) return -2;
  const size_t smem = dq_smem<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_tf32_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(bh) * sq * HD;
  const bool split = splits > 1;
  const dim3 grid(bh, (sq + kTile - 1) / kTile, splits);
  flash_bwd_dq_tf32_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
      static_cast<float*>(split ? ws : dq), split ? n : 0, group, sq, sk, causal, scale,
      split ? 1.f : scale, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || !split) return static_cast<int>(err);
  return sum_parts(static_cast<const float*>(ws), splits, n, 1, static_cast<float*>(dq), scale,
                   nullptr, 0.f, stream);
}

template <int HD>
int launch_dkv_tf32(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, void* dk, void* dv, void* ws, int bh,
                    int group, int sq, int sk, int causal, float scale, int splits,
                    cudaStream_t stream) {
  if (bad_split(splits, ws)) return -2;
  const size_t smem = dkv_smem<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_tf32_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bkv = bh / group;
  const size_t n = static_cast<size_t>(bkv) * sk * HD;
  const bool split = splits > 1;
  float* wsf = static_cast<float*>(ws);
  const dim3 grid(bkv, (sk + kTile - 1) / kTile, splits);
  flash_bwd_dkv_tf32_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
      split ? wsf : static_cast<float*>(dk), split ? wsf + n : static_cast<float*>(dv),
      split ? 2 * n : 0, group, sq, sk, causal, scale, split ? 1.f : scale, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || !split) return static_cast<int>(err);
  return sum_parts(wsf, splits, n, 2, static_cast<float*>(dk), scale, static_cast<float*>(dv),
                   1.f, stream);
}

}  // namespace

#define ND_TF32(LAUNCH, ...)                          \
  switch (hd) {                                       \
    case 16: return LAUNCH<16>(__VA_ARGS__);          \
    case 32: return LAUNCH<32>(__VA_ARGS__);          \
    case 64: return LAUNCH<64>(__VA_ARGS__);          \
    case 80: return LAUNCH<80>(__VA_ARGS__);          \
    case 96: return LAUNCH<96>(__VA_ARGS__);          \
    case 128: return LAUNCH<128>(__VA_ARGS__);        \
    default: return -1;                               \
  }

extern "C" {

const char* nd_tf32_error_string(int code) {
  if (code == -1) return "head dim not instantiated (16, 32, 64, 80, 96, 128)";
  if (code == -2) return "split count out of [1, 65535], or a split launch without a workspace";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// ws: float32 [splits, BH, Sq, hd] when splits > 1, else unused (may be null)
int nd_flash_bwd_dq_tf32(int hd, const void* q, const void* k, const void* v,
                         const void* dout, const float* lse, const float* delta, void* dq,
                         void* ws, int bh, int group, int sq, int sk, int causal, float scale,
                         int splits, void* stream) {
  ND_TF32(launch_dq_tf32, q, k, v, dout, lse, delta, dq, ws, bh, group, sq, sk, causal, scale,
          splits, static_cast<cudaStream_t>(stream))
}

// ws: float32 [splits, 2, BH / group, Sk, hd] when splits > 1 (dK's and
// dV's partials), else unused (may be null)
int nd_flash_bwd_dkv_tf32(int hd, const void* q, const void* k, const void* v,
                          const void* dout, const float* lse, const float* delta, void* dk,
                          void* dv, void* ws, int bh, int group, int sq, int sk, int causal,
                          float scale, int splits, void* stream) {
  ND_TF32(launch_dkv_tf32, q, k, v, dout, lse, delta, dk, dv, ws, bh, group, sq, sk, causal,
          scale, splits, static_cast<cudaStream_t>(stream))
}

}  // extern "C"
