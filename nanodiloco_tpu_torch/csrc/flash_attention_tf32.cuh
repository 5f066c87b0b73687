// Flash attention on Hopper (sm_90a) as three-product TF32 ("3xTF32") on the
// tensor cores: the forward (B1), dQ (B2) and dK/dV (B3) for float32 at every
// head dim, for bf16 at hd 16, and both dtypes at hd 256 n above 256 (bf16
// at hd 32-256 runs the wgmma kernels of
// flash_attention_tc.cu; ops/cuda/flash_attention.py's route() picks one
// kernel per (kernel, dtype, head dim)). This header holds what the three
// share; each kernel has a source of its own, so that nvcc builds them in
// parallel.
//
// Replaces the Pallas TPU kernels of nanodiloco_tpu/ops/pallas/flash_attention.py:
//   B1 flash_fwd_tf32_kernel     <- _fwd_call / _fwd_kernel     (flash_attention_tf32_fwd.cu)
//   B2 flash_bwd_dq_tf32_kernel  <- _flash_bwd / _bwd_dq_kernel  (flash_attention_tf32_dq.cu)
//   B3 flash_bwd_dkv_tf32_kernel <- _flash_bwd / _bwd_dkv_kernel (flash_attention_tf32_dkv.cu)
// Layouts are the TPU kernels' own: q, o, dO, dQ [BH, Sq, HD]; k, v, dK, dV
// [BH / group, Sk, HD] (GQA: query head bh reads KV head bh / group, K/V are
// never expanded); lse and delta [BH, Sq] float32. Head dims 16, 32, 64, 80,
// 96, 128 and 256 in float32, 16 in bf16, and every multiple of 256 above
// 256 in both.
//
// Bound on the H100. B1 does 2, B2 3 and B3 4 S x S x HD products per head on
// O(S x HD) bytes: operations bound all three. The CUDA cores' float32 peak
// is 67 TFLOP/s; the tensor cores take TF32 at 495. One TF32 product keeps 10
// mantissa bits (2^-11), which does not hold the float32 tolerance (1e-4 of
// max|ref|); three products (hopper.cuh: lo hi + hi lo + hi hi, small terms
// first) keep about 2^-22, and give float32-accurate products at 495 / 3 =
// 165 TFLOP/s. That is how torch's memory-efficient attention computes its
// float32 products (cutlass OpMultiplyAddFastF32 on GemmShape<16, 8, 8>).
// The products are mma.sync m16n8k8, not wgmma: wgmma's tf32 takes both
// operands K-major only, and O += P V, dV += P^T dO, dK += dS^T Q, dQ += dS K
// read V, dO, Q and K along their rows (MN-major), which would need a
// transposed copy of every tile; mma.sync's B fragment reads any layout from
// shared memory.
//
// bf16 inputs. A bf16 value has 8 significant bits, TF32 11, so every bf16
// input is exact in TF32: its hi part is the value and its lo part is 0, and
// every product term with a bf16 lo is exactly zero. The bf16 instances skip
// those terms: Q K^T and dO V^T take one product (hi hi), the products of a
// float32 P or dS with a bf16 operand two (lo hi + hi hi). That is what the
// three-product kernel gives on the inputs cast to float32, bit for bit, at
// less than half the work. bf16 tiles land by cp.async in a staging tile and
// are widened to float32 once, where float32 tiles are split (at hd 256 they
// stay bf16 and are widened as read, below); dQ, dK, dV and O are rounded to
// bf16 as they are stored. The bf16 instances serve hd 16, which wgmma's
// m64nNk16 tiles do not take, and the head dims above 256 (through the
// hd-256 tiles, below).
//
// Design. 128 threads, four warps of 16 rows of a 64-row tile. Every tile
// lies row-major in shared memory with a row stride of HD + 4 floats
// (= 4 mod 8): both fragment reads, (row g, column t) and (row 2t, column g),
// then hit 32 different banks, without a swizzle.
//   B1: a CTA owns one 64-row q tile of one head and walks its K tiles up to
//       the causal diagonal. Q is split once into hi and lo tiles; K and V
//       stream in by cp.async, double-buffered. S = Q K^T comes out of
//       mma.sync; the online softmax runs on it in registers, in exp2 with
//       scale * log2 e folded in (a row's 64 columns lie across the four
//       lanes of a quad: its max is two __shfl_xor_sync steps, its sum is
//       kept per lane and added up once at the end); P is split in registers
//       and is the A operand of O += P V.
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
// each of the four warps). The split is what the loops issue most:
// cvt.rna.tf32.f32 is four instructions in SASS (add, isfinite test,
// select, mask), a split seven.
// A ragged length is masked inside: rows past the end load as zeros
// (cp.async with src-size 0), their scores as -inf (B1) or their p as 0 (B2,
// B3). A fully masked row keeps m = -inf in B1 and ends with O = 0 and
// lse = -inf (O is divided by max(l, 1e-30)), never NaN; a row whose lse is
// +inf gets p = 0 and a zero dQ row.
//
// Grids that fill the card without atomics. The backward wrapper splits each
// CTA's loop into `splits` contiguous parts, one CTA each (grid z), so that
// small shapes launch at least two waves of 132 CTAs. With splits > 1 each
// part stores its float32 partial to a workspace [splits, outs, n], and
// sum_parts_kernel adds the parts in a fixed order, scales and stores: two
// launches give the same bits (bit-exact resume needs that). With
// splits == 1 a CTA stores its output directly. B1 is one launch, unsplit:
// split the same way (partial O, m and l merged by a second pass), it took
// half the device time at small grids, but the workspace and the second
// launch cost a caller more host time than that saves, and at those grids
// the caller, not the card, sets the pace (PERF.md, Findings).
//
// hd 256. A 64-row float32 tile at a row stride of 260 floats is 66.6 KB, so
// the layout above (B3: K and V's hi and lo and one Q and dO tile, 399 KB; B1:
// Q's hi and lo and one K and V tile, 266 KB) does not fit the 227 KB a block
// may use, and B3's full dK and dV accumulators would take 256 registers a
// thread. At hd 256 (Layout::kRawRead):
//   - no tile is split or widened in shared memory: each lies as it landed
//     (float32 at a stride of 260 floats; bf16 at 264 bf16, = 4 mod 8 words
//     too, so the fragment reads stay free of bank conflicts) and every
//     fragment element is split (float32) or widened (bf16) as it is read;
//   - the streamed tiles (B1, B2: K and V; B3: Q, dO, lse and delta) have 32
//     rows (Layout::kRows), the stationary ones 64 (B1, B2: the q tile; B3:
//     the key tile). B1 streams K and V double-buffered (float32: 66.6 KB of
//     Q and 4 x 33.3 KB, 200 KB); B2 and B3 single (two 66.6 KB stationary
//     tiles and two 33.3 KB streamed ones, 200 KB). bf16 tiles take half;
//   - B3 splits its output columns across CTAs (grid x = KV head x 2): each
//     CTA owns 128 of dK's and dV's 256 columns, 128 accumulator registers a
//     thread, and computes S^T and dP^T over the full 256-wide contraction
//     itself. That is 6 S x S x HD products instead of 4 (1.5x B3's work),
//     against the other design (warp pairs sharing S^T and dP^T through
//     shared memory), which would need 8 warps' worth of P^T and dS^T tiles
//     and a barrier between the halves of every pair: the column split keeps
//     B3's loop as it is at every other head dim, and every output element
//     is still summed by one thread in one fixed order.
// B1's and B2's O and dQ accumulators are 16 x 256 floats a warp, 128
// registers a thread.
//
// Above hd 256 (hd = 256 n; the dispatcher pads any other head dim up to
// one) nothing above fits: at hd 512 a 64-row float32 tile is 132 KB, B3
// cannot keep its K and V tiles, and an accumulator of 256 columns is
// already 128 registers a thread. The *_wide_tf32_kernel<T> of each source
// reuse the hd-256 tiles, fragments and products (Layout<T, 256>):
//   - the first products (S = Q K^T and dP = dO V^T; B3's S^T and dP^T) run
//     over the head dim in n slices of 256 columns, each loaded (row stride
//     hd) into tiles no larger than the hd-256 kernel's and summed into the
//     same registers, as a GEMM's k-loop does;
//   - the second products write one part of the output columns a CTA: 256
//     in B1 and B2, 128 in B3, as at 256 (grid x = head x parts). So B1 and
//     B2 take n passes over S and B3 2n;
//   - B1 sums the slices in order 0 .. n-1 in every part, so S, m, l and lse
//     are the same bits in each, and part 0 stores lse. B2 and B3 start after
//     the slice that holds their part's columns and end with it, so that the
//     tile the second product reads (B2: K; B3: Q and dO) is still in
//     shared memory; each output element is still one thread's sum in one
//     fixed order;
//   - one buffer of each tile, each load waited for before the products:
//     B1 133 KB in float32 (the q slice, a K slice, the part's V columns),
//     B2 and B3 200 KB (as at 256; B3 reads K and V again for every pair);
//   - the backward's loop split (bwd_splits) and its second pass stay.
// ptxas: B1 239 registers (float32) and 255 with 28 bytes spilled (bf16: 9
// LDL, 5 STL; the state of the slice loop on top of the hd-256 tiles' own),
// B2 254 / 244, B3 254 / 255, no C7512. No model has these head dims: they
// are exact, not fast (PERF.md has their times beside their bounds).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using hopper::cp_async16;
using hopper::cp_async4;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::mma_split;
using hopper::smem_addr;
using hopper::split_tf32;
using hopper::sum_parts;
using bf16 = __nv_bfloat16;

// rows of a stationary tile (B1, B2: the q tile; B3: the key tile), and of
// every tile below hd 256
constexpr int kTile = 64;
constexpr int kThreads = 128;  // four warps, 16 rows of a stationary tile each

constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int HD>
struct Layout {
  // bf16 inputs are exact in TF32: no lo parts, no products of them
  static constexpr bool kExact = std::is_same<T, bf16>::value;
  // hd 256: every tile stays as it landed and is split or widened as read
  static constexpr bool kRawRead = HD == 256;
  // a bf16 tile lands in a staging copy and is widened once into its hi tile
  static constexpr bool kStaged = kExact && !kRawRead;
  // rows of a streamed tile (B1, B2: K and V; B3: Q and dO)
  static constexpr int kRows = kRawRead ? 32 : kTile;
  // row stride in elements of the tile in shared memory (floats, or bf16
  // for a bf16 tile read raw), = 4 mod 8 32-bit words either way
  static constexpr int kLd = kRawRead && kExact ? HD + 8 : HD + 4;
  static constexpr int kFloats = kTile * kLd / (kRawRead && kExact ? 2 : 1);  // one tile
  static constexpr int kRowsFloats = kFloats / kTile * kRows;  // one streamed tile
  static constexpr int kLoFloats = kExact || kRawRead ? 0 : kFloats;  // a tile's lo part
  // a bf16 tile's staging copy ([64][HD] bf16, where cp.async lands it), in
  // floats; a float32 tile lands in its hi tile
  static constexpr int kRawFloats = kStaged ? kTile * HD / 2 : 0;
  static constexpr int kStages = HD >= 128 ? 1 : 2;  // backward: buffers of each streamed tile
  // streamed tiles split once a step into hi and lo tiles (else as each
  // fragment is read: 4 warps x 1-2 reads of every element), where the
  // extra tiles fit: up to hd 64
  static constexpr bool kPresplit = HD <= 64;
  static constexpr int kSteps = HD / 8;             // k-steps (or n-tiles) over HD
  // k-steps of the first products unrolled; not from hd 128, where two
  // spill (ptxas: 255 registers, 16 bytes)
  static constexpr int kUnroll = HD >= 128 ? 1 : 2;
  // B3's output columns a CTA owns (its grid's x splits the rest)
  static constexpr int kCols = kRawRead ? HD / 2 : HD;
  static_assert(HD % 16 == 0 && (HD <= 128 || HD == 256), "head dim");
  static_assert(!kPresplit || kRows == kTile, "a lo tile has 64 rows");
  static_assert(!kExact || kPresplit || kRawRead, "bf16 tiles are widened once a step");
};

// One operand tile in shared memory: its hi and lo tiles, and where cp.async
// lands its raw values (the hi tile itself in float32, a staging tile in bf16).
struct Tile {
  float* hi;
  float* lo;
  float* raw;
};

// Rows [row0, row0 + ROWS) of a row-major [n_rows, HD] matrix (HD columns at
// `src`, row stride `ld`: above hd 256 one slice of a wider row) into a
// tile's raw copy by cp.async, 16 bytes a copy; rows at or past n_rows are
// zeros.
template <typename T, int HD, int ROWS = kTile>
__device__ __forceinline__ void load_tile(float* raw, const T* __restrict__ src, int row0,
                                          int n_rows, int ld = HD) {
  using L = Layout<T, HD>;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = HD / kVec;
  constexpr int kRawLd = L::kStaged ? HD : L::kLd;  // elements
  T* dst = reinterpret_cast<T*>(raw);
#pragma unroll
  for (int c = threadIdx.x; c < ROWS * kPerRow; c += kThreads) {
    const int r = c / kPerRow;
    const int col = (c % kPerRow) * kVec;
    const bool in = row0 + r < n_rows;
    const T* p = src + static_cast<size_t>(in ? row0 + r : 0) * ld + col;
    cp_async16(smem_addr(dst + r * kRawLd + col), p, in ? 16 : 0);
  }
}

// A landed tile into its hi part (in place) and its lo part; a bf16 tile
// widened from its staging copy into its hi tile (it has no lo part). With
// kInfSafe an infinite value gets lo = 0 (x - hi would be NaN), so that a
// q row of -inf gives scores of -inf, as in the plain version (two
// instructions an element: B1 asks for it on its Q tile, split once).
template <typename T, int HD, bool kInfSafe = false>
__device__ __forceinline__ void split_tile(Tile t) {
  using L = Layout<T, HD>;
  static_assert(!L::kRawRead, "hd 256 tiles are split as read");
  if constexpr (L::kExact) {
    constexpr int kPerRow = HD / 8;
#pragma unroll
    for (int c = threadIdx.x; c < kTile * kPerRow; c += kThreads) {
      const int r = c / kPerRow;
      const int col = (c % kPerRow) * 8;
      // 8 bf16; a bf16 is the high half of its float32
      const uint4 x = *reinterpret_cast<const uint4*>(
          reinterpret_cast<const bf16*>(t.raw) + r * HD + col);
      float* h = t.hi + r * L::kLd + col;
      *reinterpret_cast<float4*>(h) =
          make_float4(__uint_as_float(x.x << 16), __uint_as_float(x.x & 0xFFFF0000u),
                      __uint_as_float(x.y << 16), __uint_as_float(x.y & 0xFFFF0000u));
      *reinterpret_cast<float4*>(h + 4) =
          make_float4(__uint_as_float(x.z << 16), __uint_as_float(x.z & 0xFFFF0000u),
                      __uint_as_float(x.w << 16), __uint_as_float(x.w & 0xFFFF0000u));
    }
  } else {
    constexpr int kPerRow = HD / 4;
#pragma unroll
    for (int c = threadIdx.x; c < kTile * kPerRow; c += kThreads) {
      const int e = (c / kPerRow) * L::kLd + (c % kPerRow) * 4;
      float4 x = *reinterpret_cast<float4*>(t.hi + e);
      uint32_t h[4], l[4];
      split_tf32(x.x, h[0], l[0]);
      split_tf32(x.y, h[1], l[1]);
      split_tf32(x.z, h[2], l[2]);
      split_tf32(x.w, h[3], l[3]);
      if constexpr (kInfSafe) {
#pragma unroll
        for (int i = 0; i < 4; ++i) l[i] = isinf(__uint_as_float(h[i])) ? 0u : l[i];
      }
      *reinterpret_cast<uint4*>(t.hi + e) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(t.lo + e) = make_uint4(l[0], l[1], l[2], l[3]);
    }
  }
}

// Element e of a tile's raw copy, split as it is read: a float32 value into
// hi and lo (with kInfSafe lo = 0 where hi is infinite, as split_tile has
// it); a bf16 value (hd 256) widened, exact, with lo = 0.
template <typename T, int HD, bool kInfSafe = false>
__device__ __forceinline__ void read_split(const float* raw, int e, uint32_t& hi, uint32_t& lo) {
  if constexpr (Layout<T, HD>::kExact) {
    hi = static_cast<uint32_t>(reinterpret_cast<const uint16_t*>(raw)[e]) << 16;
    lo = 0u;
  } else {
    split_tf32(raw[e], hi, lo);
    if constexpr (kInfSafe) lo = isinf(__uint_as_float(hi)) ? 0u : lo;
  }
}

// The A fragment (hi, lo) of rows [r0, r0 + 16), k-step kk, of a stationary
// tile: from its hi and lo tiles (lo zero for bf16, never read), or at hd 256
// from its raw copy as it is read.
template <typename T, int HD, bool kInfSafe = false>
__device__ __forceinline__ void a_frag(Tile x, int r0, int kk, uint32_t (&a_hi)[4],
                                       uint32_t (&a_lo)[4]) {
  using L = Layout<T, HD>;
  const int lane = threadIdx.x & 31;
  const int e = (r0 + (lane >> 2)) * L::kLd + kk * 8 + (lane & 3);
  const int offs[4] = {0, 8 * L::kLd, 4, 8 * L::kLd + 4};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (L::kRawRead) {
      read_split<T, HD, kInfSafe>(x.raw, e + offs[i], a_hi[i], a_lo[i]);
    } else {
      a_hi[i] = __float_as_uint(x.hi[e + offs[i]]);
      a_lo[i] = L::kExact ? 0u : __float_as_uint(x.lo[e + offs[i]]);
    }
  }
}

// B fragment elements e0, e1 of a streamed tile, split: from its hi and lo
// tiles where the layout splits it once a step (kPresplit), else from its raw
// tile as it is read.
template <typename T, int HD>
__device__ __forceinline__ void b_pair(Tile x, int e0, int e1, uint32_t (&b_hi)[2],
                                       uint32_t (&b_lo)[2]) {
  using L = Layout<T, HD>;
  if constexpr (L::kPresplit) {
    b_hi[0] = __float_as_uint(x.hi[e0]);
    b_hi[1] = __float_as_uint(x.hi[e1]);
    b_lo[0] = L::kExact ? 0u : __float_as_uint(x.lo[e0]);
    b_lo[1] = L::kExact ? 0u : __float_as_uint(x.lo[e1]);
  } else {
    read_split<T, HD>(x.raw, e0, b_hi[0], b_lo[0]);
    read_split<T, HD>(x.raw, e1, b_hi[1], b_lo[1]);
  }
}

// The split B fragment of X^T for S = A X^T: X's rows [n0, n0 + 8) are the
// n columns, its columns 8 kk .. 8 kk + 7 the k rows.
template <typename T, int HD>
__device__ __forceinline__ void bt_frag(Tile x, int n0, int kk, uint32_t (&b_hi)[2],
                                        uint32_t (&b_lo)[2]) {
  const int lane = threadIdx.x & 31;
  const int e = (n0 + (lane >> 2)) * Layout<T, HD>::kLd + kk * 8 + (lane & 3);
  b_pair<T, HD>(x, e, e + 4, b_hi, b_lo);
}

// The split B fragment of X for D = A X over k rows [k0, k0 + 8) in the
// permuted order (k = t is row k0 + 2t, k = t + 4 row k0 + 2t + 1) and
// columns [n0, n0 + 8).
template <typename T, int HD>
__device__ __forceinline__ void b_frag(Tile x, int k0, int n0, uint32_t (&b_hi)[2],
                                       uint32_t (&b_lo)[2]) {
  constexpr int kLd = Layout<T, HD>::kLd;
  const int lane = threadIdx.x & 31;
  const int e = (k0 + 2 * (lane & 3)) * kLd + n0 + (lane >> 2);
  b_pair<T, HD>(x, e, e + kLd, b_hi, b_lo);
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

// acc[j] += A X^T for this warp's rows [r0, r0 + 16) of a stationary tile A
// and the kN n-tiles of 8 rows of a streamed tile X, over the HD columns
// both hold (S = Q K^T and dP = dO V^T; B3's S^T = K Q^T and dP^T = V dO^T).
// kInfSafe as in a_frag.
template <typename T, int HD, int kN, bool kInfSafe = false>
__device__ __forceinline__ void product_abt(float (&acc)[kN][4], Tile a, int r0, Tile x) {
  using L = Layout<T, HD>;
  constexpr bool E = L::kExact;
#pragma unroll(L::kUnroll)
  for (int kk = 0; kk < L::kSteps; ++kk) {
    uint32_t a_hi[4], a_lo[4];
    a_frag<T, HD, kInfSafe>(a, r0, kk, a_hi, a_lo);
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      uint32_t b_hi[2], b_lo[2];
      bt_frag<T, HD>(x, 8 * j, kk, b_hi, b_lo);
      mma_split<!E, !E>(acc[j], a_hi, a_lo, b_hi, b_lo);
    }
  }
}

// acc[n8] += P X for an accumulator tile P of kN k-steps of 8 (split as the
// A fragment: both parts) and NC columns [c0, c0 + NC) of a streamed tile
// X's kN x 8 rows (O += P V, dQ += dS K, dV += P^T dO, dK += dS^T Q).
template <typename T, int HD, int kN, int NC>
__device__ __forceinline__ void product_pb(float (&acc)[NC / 8][4], const float (&p)[kN][4],
                                           Tile x, int c0) {
  constexpr bool E = Layout<T, HD>::kExact;
#pragma unroll
  for (int kq = 0; kq < kN; ++kq) {
    uint32_t a_hi[4], a_lo[4];
    acc_frag(p[kq], a_hi, a_lo);
#pragma unroll
    for (int n8 = 0; n8 < NC / 8; ++n8) {
      uint32_t b_hi[2], b_lo[2];
      b_frag<T, HD>(x, 8 * kq, c0 + 8 * n8, b_hi, b_lo);
      mma_split<true, !E>(acc[n8], a_hi, a_lo, b_hi, b_lo);
    }
  }
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// acc[n][*] (rows r0 + g, r0 + g + 8 and NC columns of a [rows, HD] matrix
// at `out`, row stride `ld`: HD, or above hd 256 the full head dim) times
// `scale`, stored as pairs; rows at or past n_rows are not stored.
template <typename OutT, int HD, int NC = HD>
__device__ __forceinline__ void store_rows(OutT* out, const float (&acc)[NC / 8][4], int r0,
                                           int n_rows, float scale, int ld = HD) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + (lane >> 2) + 8 * h;
    if (row >= n_rows) continue;
    OutT* p = out + static_cast<size_t>(row) * ld + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < NC / 8; ++n)
      store_pair(p + 8 * n, acc[n][2 * h] * scale, acc[n][2 * h + 1] * scale);
  }
}

// Zeros in rows r0 + g, r0 + g + 8 of `out` (an empty part's partial). Not
// inlined: inlined, it takes B3's registers at hd 128 past the 255 a thread
// has (ptxas spills 20 bytes).
template <typename OutT, int HD, int NC = HD>
__device__ __noinline__ void store_zero_rows(OutT* out, int r0, int n_rows) {
  const float zero[NC / 8][4] = {};
  store_rows<OutT, HD, NC>(out, zero, r0, n_rows, 1.f);
}

// A backward output's rows at `out` + `off` elements: the output itself (T)
// when the launch has one part, else this part's float32 partial in the
// workspace (the launcher passes whichever it is, and the scale).
template <typename T, int HD, int NC = HD>
__device__ __forceinline__ void store_out(void* out, size_t off, const float (&acc)[NC / 8][4],
                                          int r0, int n_rows, float scale, int splits,
                                          int ld = HD) {
  if (std::is_same<T, float>::value || splits > 1)
    store_rows<float, HD, NC>(static_cast<float*>(out) + off, acc, r0, n_rows, scale, ld);
  else
    store_rows<T, HD, NC>(static_cast<T*>(out) + off, acc, r0, n_rows, scale, ld);
}

template <typename T, int HD, int NC = HD>
__device__ __forceinline__ void store_zero_out(void* out, size_t off, int r0, int n_rows,
                                               int splits) {
  if (std::is_same<T, float>::value || splits > 1)
    store_zero_rows<float, HD, NC>(static_cast<float*>(out) + off, r0, n_rows);
  else
    store_zero_rows<T, HD, NC>(static_cast<T*>(out) + off, r0, n_rows);
}

// The sources' launchers each return cudaGetLastError() after their launches
// (0 = launched); -1 for a dtype or head dim not instantiated, -2 for a split
// count out of range or a split launch without a workspace.
inline bool bad_split(int splits, const void* ws) {
  return splits < 1 || splits > 65535 || (splits > 1 && ws == nullptr);
}

// Rows of a streamed tile, and the CTAs that split kernel `kernel`'s output
// columns (0 B1, 1 B2, 2 B3) at head dim hd: HD, or 256 n above 256 with
// HD = 256 (every part of B1 and B2 owns 256 columns there, of B3 128).
template <typename T, int HD>
int tile_geometry(int kernel, int hd, int* rows, int* col_parts) {
  if (kernel < 0 || kernel > 2) return -1;
  *rows = Layout<T, HD>::kRows;
  *col_parts = hd / (kernel == 2 ? Layout<T, HD>::kCols : HD);
  return 0;
}
template <typename T>
int tile_geometry_wide(int, int kernel, int hd, int* rows, int* col_parts) {
  return tile_geometry<T, 256>(kernel, hd, rows, col_parts);
}

}  // namespace

// dtype 0 = float32 at every head dim, 1 = bf16 at hd 16 (the head dim no
// wgmma kernel of flash_attention_tc.cu takes), both at hd 256 n above 256
// (LAUNCH##_wide<T>, which takes hd first).
#define ND_TF32(LAUNCH, ...)                                   \
  if (hd > 256 && hd % 256 == 0) {                             \
    if (dtype == 0) return LAUNCH##_wide<float>(hd, __VA_ARGS__); \
    if (dtype == 1) return LAUNCH##_wide<bf16>(hd, __VA_ARGS__);  \
    return -1;                                                 \
  }                                                            \
  if (dtype == 0) {                                            \
    switch (hd) {                                              \
      case 16: return LAUNCH<float, 16>(__VA_ARGS__);          \
      case 32: return LAUNCH<float, 32>(__VA_ARGS__);          \
      case 64: return LAUNCH<float, 64>(__VA_ARGS__);          \
      case 80: return LAUNCH<float, 80>(__VA_ARGS__);          \
      case 96: return LAUNCH<float, 96>(__VA_ARGS__);          \
      case 128: return LAUNCH<float, 128>(__VA_ARGS__);        \
      case 256: return LAUNCH<float, 256>(__VA_ARGS__);        \
      default: return -1;                                      \
    }                                                          \
  }                                                            \
  if (dtype == 1 && hd == 16) return LAUNCH<bf16, 16>(__VA_ARGS__); \
  return -1;

// Every tf32x3 library exports this: the message of a launcher's return code.
extern "C" const char* nd_tf32_error_string(int code) {
  if (code == -1)
    return "dtype or head dim not instantiated (float32: 16, 32, 64, 80, 96, 128, 256; "
           "bfloat16: 16; both: 256 n above 256)";
  if (code == -2) return "split count out of [1, 65535], or a split launch without a workspace";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Every tf32x3 library exports this too: the rows of a streamed tile and the
// CTAs that split kernel `kernel`'s output columns (0 B1, 1 B2, 2 B3;
// tile_geometry). The wrapper's split rule (bwd_splits) keeps a copy for the
// CPU and holds it against this when it loads a library; -1 as the
// launchers.
extern "C" int nd_tf32_geometry(int kernel, int dtype, int hd, int* rows, int* col_parts) {
  ND_TF32(tile_geometry, kernel, hd, rows, col_parts)
}
