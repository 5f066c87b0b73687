// dQ (B2) on Hopper (sm_90a) as three-product TF32: replaces _flash_bwd /
// _bwd_dq_kernel of nanodiloco_tpu/ops/pallas/flash_attention.py for float32
// at every head dim and bf16 at hd 16 and 256. It does three S x S x HD products per
// head on O(S x HD) bytes: operations bound it. The design, the bound and
// the bf16 instances: flash_attention_tf32.cuh.

#include "flash_attention_tf32.cuh"

namespace {

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
  constexpr bool E = L::kExact;
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
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g4 = lane >> 2, t4 = lane & 3;
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

    // S = Q K^T, dP = dO V^T
    float p[kN][4], ds[kN][4];
#pragma unroll
    for (int j = 0; j < kN; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) p[j][r] = ds[j][r] = 0.f;
#pragma unroll(L::kUnroll)
    for (int kk = 0; kk < L::kSteps; ++kk) {
      uint32_t a_hi[4], a_lo[4];
      a_frag<T, HD>(tQ, r0, kk, a_hi, a_lo);
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        uint32_t b_hi[2], b_lo[2];
        bt_frag<T, HD>(cK, 8 * j, kk, b_hi, b_lo);
        mma_split<!E, !E>(p[j], a_hi, a_lo, b_hi, b_lo);
      }
    }
#pragma unroll(L::kUnroll)
    for (int kk = 0; kk < L::kSteps; ++kk) {
      uint32_t a_hi[4], a_lo[4];
      a_frag<T, HD>(tdO, r0, kk, a_hi, a_lo);
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        uint32_t b_hi[2], b_lo[2];
        bt_frag<T, HD>(cV, 8 * j, kk, b_hi, b_lo);
        mma_split<!E, !E>(ds[j], a_hi, a_lo, b_hi, b_lo);
      }
    }
    // P = exp(S scale - lse), dS = P (dP - delta), masked
#pragma unroll
    for (int j = 0; j < kN; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int h = r >> 1;
        const int kj = kt * kRows + 8 * j + 2 * t4 + (r & 1);
        const float pv = kj < k_end[h] ? exp2f(fmaf(p[j][r], scale2, -lse2_r[h])) : 0.f;
        ds[j][r] = pv * (ds[j][r] - delta_r[h]);
      }
    // dQ += dS K over this tile's keys
#pragma unroll
    for (int kj = 0; kj < kN; ++kj) {
      uint32_t s_hi[4], s_lo[4];
      acc_frag(ds[kj], s_hi, s_lo);
#pragma unroll
      for (int n8 = 0; n8 < HD / 8; ++n8) {
        uint32_t b_hi[2], b_lo[2];
        b_frag<T, HD>(cK, 8 * kj, 8 * n8, b_hi, b_lo);
        mma_split<true, !E>(dq_acc[n8], s_hi, s_lo, b_hi, b_lo);
      }
    }
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

}  // namespace

extern "C" {

// ws: float32 [splits, BH, Sq, hd] when splits > 1, else unused (may be null)
int nd_flash_bwd_dq_tf32(int dtype, int hd, const void* q, const void* k, const void* v,
                         const void* dout, const float* lse, const float* delta, void* dq,
                         void* ws, int bh, int group, int sq, int sk, int causal, float scale,
                         int splits, void* stream) {
  ND_TF32(launch_dq_tf32, q, k, v, dout, lse, delta, dq, ws, bh, group, sq, sk, causal, scale,
          splits, static_cast<cudaStream_t>(stream))
}

}  // extern "C"
