// dK and dV (B3) on Hopper (sm_90a) as three-product TF32: replaces
// _flash_bwd / _bwd_dkv_kernel of nanodiloco_tpu/ops/pallas/flash_attention.py
// for float32 at every head dim up to 256, bf16 at hd 16, and both at hd
// 256 n above 256 (bf16 at hd 256 runs the wgmma kernel). It does four S x S
// x HD products per head on O(S x HD) bytes (six at hd 256, where two CTAs
// split the output columns; 2 + 4 n at hd 256 n, where 2 n do): operations
// bound it. The design, the bound and the bf16 instances:
// flash_attention_tf32.cuh.

#include "flash_attention_tf32.cuh"

namespace {

// P^T = exp(S^T scale - lse) in p and dS^T = P^T (dP^T - delta) in ds, from
// the scores in p and dP^T in ds, over one pair's kN x 8 queries from q0:
// key row h takes the queries [q_lo[h], q_lo[h] + q_span[h]) (0 elsewhere);
// the pair's lse and delta rows in shared memory, scale2 = scale log2 e.
template <int kN>
__device__ __forceinline__ void to_p_ds(float (&p)[kN][4], float (&ds)[kN][4], int q0,
                                        const int (&q_lo)[2], const int (&q_span)[2],
                                        const float* lse, const float* delta, float scale2) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < kN; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int h = r >> 1;
      const int qc = 8 * j + 2 * t4 + (r & 1);
      const bool ok =
          static_cast<unsigned>(q0 + qc - q_lo[h]) < static_cast<unsigned>(q_span[h]);
      const float pv = ok ? exp2f(fmaf(p[j][r], scale2, -lse[qc] * kLog2e)) : 0.f;
      p[j][r] = pv;
      ds[j][r] = pv * (ds[j][r] - delta[qc]);
    }
}

// ---------------------------------------------------------------------------
// B3: dK and dV. grid (BH / group x column parts, nk, splits): x is KV head
// x / parts and the part's kCols output columns (all HD of them below hd
// 256, one half at 256). Part z of K tile y walks pairs [z n / splits,
// (z + 1) n / splits) of the n = group x (nq - qt0) pairs (g, qt), g-major,
// over q tiles of kRows rows (64, 32 at hd 256); qt0 is the first q tile
// that reaches tile y under the causal mask (q tiles wholly above the
// diagonal contribute nothing), else 0. Its dK and dV go to
// dk + z * part_stride and dv + z * part_stride, dK times dk_scale: the
// outputs (T) with one part, else float32 partials in the workspace.
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_tf32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              void* __restrict__ dk, void* __restrict__ dv, size_t part_stride,
                              int group, int sq, int sk, int causal, float scale, float dk_scale,
                              int splits) {
  using L = Layout<T, HD>;
  constexpr bool S = L::kStaged;
  constexpr int kRows = L::kRows;  // queries a Q and dO tile
  constexpr int kN = kRows / 8;    // n-tiles of S^T and dP^T
  constexpr int kCols = L::kCols;  // dK and dV columns this CTA owns
  extern __shared__ __align__(16) float smem[];
  float* sKhi = smem;
  float* sKlo = sKhi + L::kFloats;
  float* sVhi = sKlo + L::kLoFloats;
  float* sVlo = sVhi + L::kFloats;
  float* sQ = sVlo + L::kLoFloats;                // [kStages] raw (or hi) tiles
  float* sdO = sQ + L::kStages * L::kRowsFloats;  // [kStages] raw (or hi) tiles
  float* sQlo = sdO + L::kStages * L::kRowsFloats;  // [kStages] lo tiles, if kPresplit
  float* sdOlo = sQlo + (L::kPresplit ? L::kStages * L::kLoFloats : 0);
  // [kStages][lse kRows, delta kRows], then bf16's staging tiles K, V, Q[], dO[]
  float* sRows = sdOlo + (L::kPresplit ? L::kStages * L::kLoFloats : 0);
  float* sRaw = sRows + L::kStages * 2 * kRows;
  const Tile tK = {sKhi, sKlo, S ? sRaw : sKhi};
  const Tile tV = {sVhi, sVlo, S ? sRaw + L::kRawFloats : sVhi};
  auto q_tile = [&](int s) -> Tile {
    return {sQ + s * L::kRowsFloats, sQlo + s * L::kLoFloats,
            S ? sRaw + (2 + s) * L::kRawFloats : sQ + s * L::kRowsFloats};
  };
  auto do_tile = [&](int s) -> Tile {
    return {sdO + s * L::kRowsFloats, sdOlo + s * L::kLoFloats,
            S ? sRaw + (2 + L::kStages + s) * L::kRawFloats : sdO + s * L::kRowsFloats};
  };

  const int bkv = blockIdx.x / (HD / kCols);
  const int c0 = blockIdx.x % (HD / kCols) * kCols;  // this CTA's first output column
  const int k0 = blockIdx.y * kTile;
  const int warp = threadIdx.x >> 5, g4 = (threadIdx.x & 31) >> 2;
  const int nq = (sq + kRows - 1) / kRows;
  const int qt0 = causal ? k0 / kRows : 0;
  const int per_head = max(nq - qt0, 0);
  const int n = group * per_head;
  const int i0 = static_cast<int>(static_cast<long long>(blockIdx.z) * n / splits);
  const int i1 = static_cast<int>(static_cast<long long>(blockIdx.z + 1) * n / splits);
  const int r0 = warp * 16;  // this warp's key rows in the tile
  const size_t off = blockIdx.z * part_stride + static_cast<size_t>(bkv) * sk * HD + c0;
  if (i0 == i1) {  // an empty part (causal K tiles near the end have few pairs)
    store_zero_out<T, HD, kCols>(dk, off, k0 + r0, sk, splits);
    store_zero_out<T, HD, kCols>(dv, off, k0 + r0, sk, splits);
    return;
  }

  load_tile<T, HD>(tK.raw, k + static_cast<size_t>(bkv) * sk * HD, k0, sk);
  load_tile<T, HD>(tV.raw, v + static_cast<size_t>(bkv) * sk * HD, k0, sk);
  cp_async_commit();

  // pair i's Q, dO, lse and delta into buffer `stage`
  auto load_pair = [&](int i, int stage) {
    const size_t bh = static_cast<size_t>(bkv) * group + i / per_head;
    const int q0 = (qt0 + i % per_head) * kRows;
    load_tile<T, HD, kRows>(q_tile(stage).raw, q + bh * sq * HD, q0, sq);
    load_tile<T, HD, kRows>(do_tile(stage).raw, dout + bh * sq * HD, q0, sq);
    if (threadIdx.x < 2 * kRows) {
      const int r = threadIdx.x % kRows;
      const bool in = q0 + r < sq;
      const float* src = (threadIdx.x < kRows ? lse : delta) + bh * sq + (in ? q0 + r : 0);
      cp_async4(smem_addr(sRows + stage * 2 * kRows + threadIdx.x), src, in ? 4 : 0);
    }
  };
  load_pair(i0, 0);
  cp_async_commit();
  cp_async_wait<1>();  // K and V have landed
  __syncthreads();
  if constexpr (!L::kRawRead) {
    split_tile<T, HD>(tK);
    split_tile<T, HD>(tV);
  }

  float dk_acc[kCols / 8][4], dv_acc[kCols / 8][4];
#pragma unroll
  for (int n8 = 0; n8 < kCols / 8; ++n8)
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
    const Tile cQ = q_tile(stage);
    const Tile cdO = do_tile(stage);
    if constexpr (L::kPresplit) {
      split_tile<T, HD>(cQ);
      split_tile<T, HD>(cdO);
      __syncthreads();
    }
    const float* cLse = sRows + stage * 2 * kRows;
    const float* cDelta = cLse + kRows;
    const int q0 = (qt0 + i % per_head) * kRows;

    // S^T = K Q^T and dP^T = V dO^T, then P^T and dS^T, then dV += P^T dO
    // and dK += dS^T Q (P's registers free by then), over this pair's
    // queries and this CTA's columns
    float p[kN][4], ds[kN][4];
#pragma unroll
    for (int j = 0; j < kN; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) p[j][r] = ds[j][r] = 0.f;
    product_abt<T, HD, kN>(p, tK, r0, cQ);
    product_abt<T, HD, kN>(ds, tV, r0, cdO);
    to_p_ds<kN>(p, ds, q0, q_lo, q_span, cLse, cDelta, scale2);
    product_pb<T, HD, kN, kCols>(dv_acc, p, cdO, c0);
    product_pb<T, HD, kN, kCols>(dk_acc, ds, cQ, c0);
    __syncthreads();  // every warp is done with this buffer
    if constexpr (L::kStages == 1) {
      if (i + 1 < i1) load_pair(i + 1, 0);
      cp_async_commit();
    }
  }

  store_out<T, HD, kCols>(dk, off, dk_acc, k0 + r0, sk, dk_scale, splits);
  store_out<T, HD, kCols>(dv, off, dv_acc, k0 + r0, sk, 1.f, splits);
}

template <typename T, int HD>
constexpr size_t dkv_smem() {
  using L = Layout<T, HD>;
  return (2 * (L::kFloats + L::kLoFloats) + 2 * L::kStages * L::kRowsFloats +
          (L::kPresplit ? 2 * L::kStages * L::kLoFloats : 0) + L::kStages * 2 * L::kRows +
          (2 + 2 * L::kStages) * L::kRawFloats) *
         sizeof(float);
}

template <typename T, int HD>
int launch_dkv_tf32(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, void* dk, void* dv, void* ws, int bh,
                    int group, int sq, int sk, int causal, float scale, int splits,
                    cudaStream_t stream) {
  if (bad_split(splits, ws)) return -2;
  const size_t smem = dkv_smem<T, HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_tf32_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bkv = bh / group;
  const size_t n = static_cast<size_t>(bkv) * sk * HD;
  const bool split = splits > 1;
  float* wsf = static_cast<float*>(ws);
  const dim3 grid(bkv * (HD / Layout<T, HD>::kCols), (sk + kTile - 1) / kTile, splits);
  flash_bwd_dkv_tf32_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, split ? wsf : dk, split ? wsf + n : dv,
      split ? 2 * n : 0, group, sq, sk, causal, scale, split ? 1.f : scale, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || !split) return static_cast<int>(err);
  return sum_parts<T>(wsf, splits, n, 2, static_cast<T*>(dk), scale, static_cast<T*>(dv), 1.f,
                      stream);
}

// ---------------------------------------------------------------------------
// B3 above hd 256 (hd = 256 n, n >= 2; the header's note): grid (BH / group x
// 2 n, nk, splits), x is KV head x / 2n and the part x % 2n whose 128 columns
// of dK and dV the CTA owns. Part z of K tile y walks its pairs as B3 does;
// for each it sums S^T = K Q^T and dP^T = V dO^T over the n slices of 256
// columns (slice s of the key, V, Q and dO tiles in the hd-256 kernel's
// tiles), starting after the slice that holds the part's columns, so that
// the Q and dO tiles left in shared memory hold them for dV += P^T dO and
// dK += dS^T Q. K and V are read again for every pair (n slices of them do
// not fit beside the rest). An empty part stores zeros.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_wide_tf32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                   const T* __restrict__ v, const T* __restrict__ dout,
                                   const float* __restrict__ lse,
                                   const float* __restrict__ delta, void* __restrict__ dk,
                                   void* __restrict__ dv, size_t part_stride, int hd, int group,
                                   int sq, int sk, int causal, float scale, float dk_scale,
                                   int splits) {
  using L = Layout<T, 256>;
  constexpr int kRows = L::kRows;  // queries a Q and dO tile
  constexpr int kN = kRows / 8;    // n-tiles of S^T and dP^T
  constexpr int kCols = L::kCols;  // dK and dV columns this CTA owns
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;                   // one slice of the key tile
  float* sV = sK + L::kFloats;        // one slice of the V tile
  float* sQ = sV + L::kFloats;        // one slice of the pair's Q tile
  float* sdO = sQ + L::kRowsFloats;   // one slice of the pair's dO tile
  float* sRows = sdO + L::kRowsFloats;  // the pair's lse and delta rows
  const Tile tK = {sK, sK, sK}, tV = {sV, sV, sV}, cQ = {sQ, sQ, sQ}, cdO = {sdO, sdO, sdO};

  const int parts = hd / kCols;
  const int bkv = blockIdx.x / parts;
  const int c0 = blockIdx.x % parts * kCols;  // this CTA's first output column
  const int last = c0 / 256 * 256;            // the slice that holds them, summed last
  const int k0 = blockIdx.y * kTile;
  const int warp = threadIdx.x >> 5, g4 = (threadIdx.x & 31) >> 2;
  const int nq = (sq + kRows - 1) / kRows;
  const int qt0 = causal ? k0 / kRows : 0;
  const int per_head = max(nq - qt0, 0);
  const int n = group * per_head;
  const int i0 = static_cast<int>(static_cast<long long>(blockIdx.z) * n / splits);
  const int i1 = static_cast<int>(static_cast<long long>(blockIdx.z + 1) * n / splits);
  const int r0 = warp * 16;  // this warp's key rows in the tile
  const T* kb = k + static_cast<size_t>(bkv) * sk * hd;
  const T* vb = v + static_cast<size_t>(bkv) * sk * hd;

  float dk_acc[kCols / 8][4], dv_acc[kCols / 8][4];
#pragma unroll
  for (int n8 = 0; n8 < kCols / 8; ++n8)
#pragma unroll
    for (int r = 0; r < 4; ++r) dk_acc[n8][r] = dv_acc[n8][r] = 0.f;
  int q_lo[2], q_span[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kr = k0 + r0 + g4 + 8 * h;
    q_lo[h] = causal ? kr : 0;
    q_span[h] = kr < sk ? max(sq - q_lo[h], 0) : 0;
  }
  const float scale2 = scale * kLog2e;

  for (int i = i0; i < i1; ++i) {
    const size_t bh = static_cast<size_t>(bkv) * group + i / per_head;
    const int q0 = (qt0 + i % per_head) * kRows;
    float p[kN][4], ds[kN][4];
#pragma unroll
    for (int j = 0; j < kN; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) p[j][r] = ds[j][r] = 0.f;
    for (int j = 256; j <= hd; j += 256) {
      const int c = (last + j) % hd;  // the slice's first column
      __syncthreads();  // every warp is done with the tiles this step reloads
      load_tile<T, 256>(sK, kb + c, k0, sk, hd);
      load_tile<T, 256>(sV, vb + c, k0, sk, hd);
      load_tile<T, 256, kRows>(sQ, q + bh * sq * hd + c, q0, sq, hd);
      load_tile<T, 256, kRows>(sdO, dout + bh * sq * hd + c, q0, sq, hd);
      if (j == 256 && threadIdx.x < 2 * kRows) {
        const int r = threadIdx.x % kRows;
        const bool in = q0 + r < sq;
        const float* src = (threadIdx.x < kRows ? lse : delta) + bh * sq + (in ? q0 + r : 0);
        cp_async4(smem_addr(sRows + threadIdx.x), src, in ? 4 : 0);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      product_abt<T, 256, kN>(p, tK, r0, cQ);
      product_abt<T, 256, kN>(ds, tV, r0, cdO);
    }
    to_p_ds<kN>(p, ds, q0, q_lo, q_span, sRows, sRows + kRows, scale2);
    product_pb<T, 256, kN, kCols>(dv_acc, p, cdO, c0 - last);
    product_pb<T, 256, kN, kCols>(dk_acc, ds, cQ, c0 - last);
  }

  const size_t off = blockIdx.z * part_stride + static_cast<size_t>(bkv) * sk * hd + c0;
  store_out<T, 256, kCols>(dk, off, dk_acc, k0 + r0, sk, dk_scale, splits, hd);
  store_out<T, 256, kCols>(dv, off, dv_acc, k0 + r0, sk, 1.f, splits, hd);
}

template <typename T>
int launch_dkv_tf32_wide(int hd, const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, const float* delta, void* dk, void* dv, void* ws,
                         int bh, int group, int sq, int sk, int causal, float scale, int splits,
                         cudaStream_t stream) {
  using L = Layout<T, 256>;
  if (bad_split(splits, ws)) return -2;
  const size_t smem = (2 * L::kFloats + 2 * L::kRowsFloats + 2 * L::kRows) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_wide_tf32_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bkv = bh / group;
  const size_t n = static_cast<size_t>(bkv) * sk * hd;
  const bool split = splits > 1;
  float* wsf = static_cast<float*>(ws);
  const dim3 grid(bkv * (hd / L::kCols), (sk + kTile - 1) / kTile, splits);
  flash_bwd_dkv_wide_tf32_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, split ? wsf : dk, split ? wsf + n : dv,
      split ? 2 * n : 0, hd, group, sq, sk, causal, scale, split ? 1.f : scale, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || !split) return static_cast<int>(err);
  return sum_parts<T>(wsf, splits, n, 2, static_cast<T*>(dk), scale, static_cast<T*>(dv), 1.f,
                      stream);
}

}  // namespace

extern "C" {

// ws: float32 [splits, 2, BH / group, Sk, hd] when splits > 1 (dK's and
// dV's partials), else unused (may be null). bf16 at hd 256 runs the wgmma
// kernel (flash_attention_tc.cu): -1 here.
int nd_flash_bwd_dkv_tf32(int dtype, int hd, const void* q, const void* k, const void* v,
                          const void* dout, const float* lse, const float* delta, void* dk,
                          void* dv, void* ws, int bh, int group, int sq, int sk, int causal,
                          float scale, int splits, void* stream) {
  ND_TF32(launch_dkv_tf32, q, k, v, dout, lse, delta, dk, dv, ws, bh, group, sq, sk, causal,
          scale, splits, static_cast<cudaStream_t>(stream))
}

}  // extern "C"
