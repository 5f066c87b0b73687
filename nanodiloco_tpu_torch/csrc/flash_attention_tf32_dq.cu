// dQ (B2) on Hopper (sm_90a) as three-product TF32: replaces _flash_bwd /
// _bwd_dq_kernel of nanodiloco_tpu/ops/pallas/flash_attention.py for float32
// at every head dim up to 256, bf16 at hd 16, and both at hd 256 n above 256
// (bf16 at hd 256 runs the wgmma kernel). It does three S x S x HD products
// per head on O(S x HD) bytes (2 + n at hd 256 n: each part recomputes S and
// dP): operations bound it. The design, the bound and the bf16 instances:
// flash_attention_tf32.cuh.

#include "flash_attention_tf32.cuh"

namespace {

// dS = P (dP - delta) in ds, with P = exp(S scale - lse) (masked to 0 past
// each row's k_end[h]) from the scores S in p, over one tile's kN x 8 keys
// from key k0; lse2 in log2 units, scale2 = scale log2 e.
template <int kN>
__device__ __forceinline__ void to_ds(const float (&p)[kN][4], float (&ds)[kN][4], int k0,
                                      const int (&k_end)[2], const float (&lse2)[2],
                                      const float (&delta)[2], float scale2) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < kN; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int h = r >> 1;
      const int kj = k0 + 8 * j + 2 * t4 + (r & 1);
      const float pv = kj < k_end[h] ? exp2f(fmaf(p[j][r], scale2, -lse2[h])) : 0.f;
      ds[j][r] = pv * (ds[j][r] - delta[h]);
    }
}

// ---------------------------------------------------------------------------
// B2: dQ. grid (BH, nq, splits); the y index is reversed so that the longest
// causal rows start first. Part z of a q tile walks K tiles (64 keys, 32 at
// hd 256) [z n / splits, (z + 1) n / splits) of the n it attends to; its dQ goes to
// dq + z * part_stride, times dq_scale: the output (T) with one part, else a
// float32 partial in the workspace.
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_tf32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             void* __restrict__ dq, size_t part_stride, int group, int sq,
                             int sk, int causal, float scale, float dq_scale, int splits) {
  using L = Layout<T, HD>;
  constexpr bool S = L::kStaged;
  constexpr int kRows = L::kRows;  // keys a K and V tile
  constexpr int kN = kRows / 8;    // n-tiles of S and dP
  extern __shared__ __align__(16) float smem[];
  float* sQhi = smem;
  float* sQlo = sQhi + L::kFloats;
  float* sdOhi = sQlo + L::kLoFloats;
  float* sdOlo = sdOhi + L::kFloats;
  float* sK = sdOlo + L::kLoFloats;              // [kStages] raw (or hi) tiles
  float* sV = sK + L::kStages * L::kRowsFloats;  // [kStages] raw (or hi) tiles
  float* sKlo = sV + L::kStages * L::kRowsFloats;  // [kStages] lo tiles, if kPresplit
  float* sVlo = sKlo + (L::kPresplit ? L::kStages * L::kLoFloats : 0);
  float* sRaw = sVlo + (L::kPresplit ? L::kStages * L::kLoFloats : 0);  // bf16: Q, dO, K[], V[]
  const Tile tQ = {sQhi, sQlo, S ? sRaw : sQhi};
  const Tile tdO = {sdOhi, sdOlo, S ? sRaw + L::kRawFloats : sdOhi};
  auto k_tile = [&](int s) -> Tile {
    return {sK + s * L::kRowsFloats, sKlo + s * L::kLoFloats,
            S ? sRaw + (2 + s) * L::kRawFloats : sK + s * L::kRowsFloats};
  };
  auto v_tile = [&](int s) -> Tile {
    return {sV + s * L::kRowsFloats, sVlo + s * L::kLoFloats,
            S ? sRaw + (2 + L::kStages + s) * L::kRawFloats : sV + s * L::kRowsFloats};
  };

  const size_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int warp = threadIdx.x >> 5, g4 = (threadIdx.x & 31) >> 2;
  const int nk = (sk + kRows - 1) / kRows;
  const int n = causal ? min(nk, (min(q0 + kTile, sq) - 1) / kRows + 1) : nk;
  const int i0 = static_cast<int>(static_cast<long long>(blockIdx.z) * n / splits);
  const int i1 = static_cast<int>(static_cast<long long>(blockIdx.z + 1) * n / splits);
  const T* kb = k + (bh / group) * sk * HD;
  const T* vb = v + (bh / group) * sk * HD;
  const int r0 = warp * 16;  // this warp's q rows in the tile
  const size_t off = blockIdx.z * part_stride + bh * sq * HD;
  if (i0 == i1) {  // an empty part (causal q tiles near the start have few K tiles)
    store_zero_out<T, HD>(dq, off, q0 + r0, sq, splits);
    return;
  }

  load_tile<T, HD>(tQ.raw, q + bh * sq * HD, q0, sq);
  load_tile<T, HD>(tdO.raw, dout + bh * sq * HD, q0, sq);
  cp_async_commit();
  auto load_kv = [&](int kt, int stage) {
    load_tile<T, HD, kRows>(k_tile(stage).raw, kb, kt * kRows, sk);
    load_tile<T, HD, kRows>(v_tile(stage).raw, vb, kt * kRows, sk);
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
  if constexpr (!L::kRawRead) {
    split_tile<T, HD>(tQ);
    split_tile<T, HD>(tdO);
  }

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
    const Tile cK = k_tile(stage);
    const Tile cV = v_tile(stage);
    if constexpr (L::kPresplit) {
      split_tile<T, HD>(cK);
      split_tile<T, HD>(cV);
      __syncthreads();
    }

    // S = Q K^T, dP = dO V^T, then dS, then dQ += dS K over this tile's keys
    float p[kN][4], ds[kN][4];
#pragma unroll
    for (int j = 0; j < kN; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) p[j][r] = ds[j][r] = 0.f;
    product_abt<T, HD, kN>(p, tQ, r0, cK);
    product_abt<T, HD, kN>(ds, tdO, r0, cV);
    to_ds<kN>(p, ds, kt * kRows, k_end, lse2_r, delta_r, scale2);
    product_pb<T, HD, kN, HD>(dq_acc, ds, cK, 0);
    __syncthreads();  // every warp is done with this buffer
    if constexpr (L::kStages == 1) {
      if (kt + 1 < i1) load_kv(kt + 1, 0);
      cp_async_commit();
    }
  }

  store_out<T, HD>(dq, off, dq_acc, q0 + r0, sq, dq_scale, splits);
}

template <typename T, int HD>
constexpr size_t dq_smem() {
  using L = Layout<T, HD>;
  return (2 * (L::kFloats + L::kLoFloats) + 2 * L::kStages * L::kRowsFloats +
          (L::kPresplit ? 2 * L::kStages * L::kLoFloats : 0) +
          (2 + 2 * L::kStages) * L::kRawFloats) *
         sizeof(float);
}

template <typename T, int HD>
int launch_dq_tf32(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dq, void* ws, int bh, int group,
                   int sq, int sk, int causal, float scale, int splits, cudaStream_t stream) {
  if (bad_split(splits, ws)) return -2;
  const size_t smem = dq_smem<T, HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_tf32_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(bh) * sq * HD;
  const bool split = splits > 1;
  const dim3 grid(bh, (sq + kTile - 1) / kTile, splits);
  flash_bwd_dq_tf32_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, split ? ws : dq, split ? n : 0, group, sq, sk,
      causal, scale, split ? 1.f : scale, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || !split) return static_cast<int>(err);
  return sum_parts<T>(static_cast<const float*>(ws), splits, n, 1, static_cast<T*>(dq), scale,
                      nullptr, 0.f, stream);
}

// ---------------------------------------------------------------------------
// B2 above hd 256 (hd = 256 n, n >= 2; the header's note): grid (BH x n, nq,
// splits), x is head x / n and the part x % n whose 256 columns of dQ the
// CTA owns. Part z of a q tile walks its K tiles as B2 does; for each it
// sums S = Q K^T and dP = dO V^T over the n slices of 256 columns (slice s
// of the q, dO, K and V tiles in the hd-256 kernel's tiles), starting after
// the part's own slice so that the K tile left in shared memory is the
// part's columns, which dQ += dS K reads. An empty part stores zeros.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_wide_tf32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                  const T* __restrict__ v, const T* __restrict__ dout,
                                  const float* __restrict__ lse, const float* __restrict__ delta,
                                  void* __restrict__ dq, size_t part_stride, int hd, int group,
                                  int sq, int sk, int causal, float scale, float dq_scale,
                                  int splits) {
  using L = Layout<T, 256>;
  constexpr int kRows = L::kRows;  // keys a K and V tile
  constexpr int kN = kRows / 8;    // n-tiles of S and dP
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                  // one slice of the q tile
  float* sdO = sQ + L::kFloats;      // one slice of the dO tile
  float* sK = sdO + L::kFloats;      // one slice of a K tile
  float* sV = sK + L::kRowsFloats;   // one slice of a V tile
  const Tile tQ = {sQ, sQ, sQ}, tdO = {sdO, sdO, sdO}, cK = {sK, sK, sK}, cV = {sV, sV, sV};

  const int parts = hd / 256;
  const size_t bh = blockIdx.x / parts;
  const int part = blockIdx.x % parts;  // this CTA's columns of dQ: slice `part`
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int warp = threadIdx.x >> 5, g4 = (threadIdx.x & 31) >> 2;
  const int nk = (sk + kRows - 1) / kRows;
  const int n = causal ? min(nk, (min(q0 + kTile, sq) - 1) / kRows + 1) : nk;
  const int i0 = static_cast<int>(static_cast<long long>(blockIdx.z) * n / splits);
  const int i1 = static_cast<int>(static_cast<long long>(blockIdx.z + 1) * n / splits);
  const T* qb = q + bh * sq * hd;
  const T* dob = dout + bh * sq * hd;
  const T* kb = k + (bh / group) * sk * hd;
  const T* vb = v + (bh / group) * sk * hd;
  const int r0 = warp * 16;  // this warp's q rows in the tile

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
  float dq_acc[32][4];
#pragma unroll
  for (int n8 = 0; n8 < 32; ++n8)
#pragma unroll
    for (int r = 0; r < 4; ++r) dq_acc[n8][r] = 0.f;

  for (int kt = i0; kt < i1; ++kt) {
    float p[kN][4], ds[kN][4];
#pragma unroll
    for (int j = 0; j < kN; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) p[j][r] = ds[j][r] = 0.f;
    for (int j = 1; j <= parts; ++j) {
      const int c = (part + j) % parts * 256;  // the slice's first column; the part's last
      __syncthreads();  // every warp is done with the tiles this step reloads
      load_tile<T, 256>(sQ, qb + c, q0, sq, hd);
      load_tile<T, 256>(sdO, dob + c, q0, sq, hd);
      load_tile<T, 256, kRows>(sK, kb + c, kt * kRows, sk, hd);
      load_tile<T, 256, kRows>(sV, vb + c, kt * kRows, sk, hd);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      product_abt<T, 256, kN>(p, tQ, r0, cK);
      product_abt<T, 256, kN>(ds, tdO, r0, cV);
    }
    to_ds<kN>(p, ds, kt * kRows, k_end, lse2_r, delta_r, scale2);
    product_pb<T, 256, kN, 256>(dq_acc, ds, cK, 0);
  }

  const size_t off = blockIdx.z * part_stride + bh * sq * hd + part * 256;
  store_out<T, 256>(dq, off, dq_acc, q0 + r0, sq, dq_scale, splits, hd);
}

template <typename T>
int launch_dq_tf32_wide(int hd, const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, void* dq, void* ws, int bh,
                        int group, int sq, int sk, int causal, float scale, int splits,
                        cudaStream_t stream) {
  using L = Layout<T, 256>;
  if (bad_split(splits, ws)) return -2;
  const size_t smem = 2 * (L::kFloats + L::kRowsFloats) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_wide_tf32_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(bh) * sq * hd;
  const bool split = splits > 1;
  const dim3 grid(bh * (hd / 256), (sq + kTile - 1) / kTile, splits);
  flash_bwd_dq_wide_tf32_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, split ? ws : dq, split ? n : 0, hd, group, sq,
      sk, causal, scale, split ? 1.f : scale, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || !split) return static_cast<int>(err);
  return sum_parts<T>(static_cast<const float*>(ws), splits, n, 1, static_cast<T*>(dq), scale,
                      nullptr, 0.f, stream);
}

}  // namespace

extern "C" {

// ws: float32 [splits, BH, Sq, hd] when splits > 1, else unused (may be null).
// bf16 at hd 256 runs the wgmma kernel (flash_attention_tc.cu): -1 here.
int nd_flash_bwd_dq_tf32(int dtype, int hd, const void* q, const void* k, const void* v,
                         const void* dout, const float* lse, const float* delta, void* dq,
                         void* ws, int bh, int group, int sq, int sk, int causal, float scale,
                         int splits, void* stream) {
  ND_TF32(launch_dq_tf32, q, k, v, dout, lse, delta, dq, ws, bh, group, sq, sk, causal, scale,
          splits, static_cast<cudaStream_t>(stream))
}

}  // extern "C"
