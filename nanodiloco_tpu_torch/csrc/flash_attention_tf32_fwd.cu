// The forward (B1) on Hopper (sm_90a) as three-product TF32: replaces
// _fwd_call / _fwd_kernel of nanodiloco_tpu/ops/pallas/flash_attention.py for
// float32 at every head dim, bf16 at hd 16, and both above 256 (hd 256 n).
// It does two S x S x HD products per head on O(S x HD) bytes: operations
// bound it. The design, the bound and the bf16 instances:
// flash_attention_tf32.cuh.

#include "flash_attention_tf32.cuh"

namespace {

constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// B1: the forward. grid (BH, nq); the y index is reversed so that the
// longest causal rows start first. A CTA walks the K tiles its q tile
// attends to and stores O (divided by max(l, 1e-30)) and lse. K and V come
// in two buffers (the next tile's copies fly during this tile's products)
// or in one (fwd_stages), where that lets two CTAs share an SM and the one
// buffer ran faster in one A/B call on the H100 (scripts/torch_flash_ab.py):
// hd 96 and 80 (154 and 129 KB a CTA with two, 102 and 86 KB with one;
// Phi-3-mini's and Phi-2's widths in float32 took 1.47 and 1.25 ms against
// 2.23 and 1.77) and hd 32 (tiny_f32_hd32: 0.076 ms against 0.081). At hd
// 256 the K and V tiles have 32 rows and two buffers (the header's note).
// ---------------------------------------------------------------------------
__host__ __device__ constexpr int fwd_stages(int hd) {
  return hd == 32 || hd == 80 || hd == 96 ? 1 : 2;
}

// The online softmax of this thread's two rows over one tile's kN x 8 keys
// from key k0 (row h attends to keys below k_end[h]): S (times scale2 =
// scale log2 e, masked to -inf) becomes P in place, m2 (log2 units) and l
// (this lane's share of the row sum) move on, and O's NC columns are
// rescaled.
template <int kN, int NC>
__device__ __forceinline__ void online_softmax(float (&s)[kN][4], float (&acc)[NC / 8][4],
                                               float (&m2)[2], float (&l)[2], int k0,
                                               const int (&k_end)[2], float scale2) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kN; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kj = k0 + 8 * j + 2 * t4 + c;
        const float x = kj < k_end[h] ? s[j][2 * h + c] * scale2 : -INFINITY;
        s[j][2 * h + c] = x;
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, 2));
    const float m_new = fmaxf(m2[h], mx);
    const float m_safe = m_new == -INFINITY ? 0.f : m_new;
    const float corr = exp2f(m2[h] - m_safe);  // 0 while the row had no key
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < kN; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float p = exp2f(s[j][2 * h + c] - m_safe);  // 0 where masked
        s[j][2 * h + c] = p;
        ps += p;
      }
    l[h] = l[h] * corr + ps;
    m2[h] = m_new;
#pragma unroll
    for (int n8 = 0; n8 < NC / 8; ++n8) {
      acc[n8][2 * h] *= corr;
      acc[n8][2 * h + 1] *= corr;
    }
  }
}

// O divided by max(l, 1e-30) (after a quad adds up its lanes' shares of l),
// and lse = m ln 2 + ln l (-inf for a row without a key) where `store_lse`.
template <int NC>
__device__ __forceinline__ void finish_rows(float (&acc)[NC / 8][4], const float (&m2)[2],
                                            float (&l)[2], const int (&qi)[2], int sq,
                                            float* lse_row, bool store_lse) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xFFFFFFFFu, l[h], 1);
    l[h] += __shfl_xor_sync(0xFFFFFFFFu, l[h], 2);
    const float inv = 1.f / fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int n8 = 0; n8 < NC / 8; ++n8) {
      acc[n8][2 * h] *= inv;
      acc[n8][2 * h + 1] *= inv;
    }
    if (store_lse && t4 == 0 && qi[h] < sq)
      lse_row[qi[h]] = l[h] > 0.f ? m2[h] * kLn2 + logf(l[h]) : -INFINITY;
  }
}

template <typename T, int HD>
constexpr size_t fwd_smem() {
  using L = Layout<T, HD>;
  constexpr int kStages = fwd_stages(HD);
  return (L::kFloats + L::kLoFloats + 2 * kStages * L::kRowsFloats +
          (L::kPresplit ? 2 * kStages * L::kLoFloats : 0) + (1 + 2 * kStages) * L::kRawFloats) *
         sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_tf32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                          int group, int sq, int sk, int causal, float scale) {
  using L = Layout<T, HD>;
  constexpr bool S = L::kStaged;
  constexpr int kStages = fwd_stages(HD);
  constexpr int kRows = L::kRows;  // keys a K and V tile
  constexpr int kN = kRows / 8;    // n-tiles of S
  extern __shared__ __align__(16) float smem[];
  float* sQhi = smem;
  float* sQlo = sQhi + L::kFloats;
  float* sK = sQlo + L::kLoFloats;            // [kStages] raw (or hi) tiles
  float* sV = sK + kStages * L::kRowsFloats;  // [kStages] raw (or hi) tiles
  float* sKlo = sV + kStages * L::kRowsFloats;  // [kStages] lo tiles, if kPresplit
  float* sVlo = sKlo + (L::kPresplit ? kStages * L::kLoFloats : 0);
  float* sRaw = sVlo + (L::kPresplit ? kStages * L::kLoFloats : 0);  // bf16: Q, K[], V[]
  const Tile tQ = {sQhi, sQlo, S ? sRaw : sQhi};
  auto k_tile = [&](int s) -> Tile {
    return {sK + s * L::kRowsFloats, sKlo + s * L::kLoFloats,
            S ? sRaw + (1 + s) * L::kRawFloats : sK + s * L::kRowsFloats};
  };
  auto v_tile = [&](int s) -> Tile {
    return {sV + s * L::kRowsFloats, sVlo + s * L::kLoFloats,
            S ? sRaw + (1 + kStages + s) * L::kRawFloats : sV + s * L::kRowsFloats};
  };

  const size_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int warp = threadIdx.x >> 5, g4 = (threadIdx.x & 31) >> 2;
  const int nk = (sk + kRows - 1) / kRows;
  const int n = causal ? min(nk, (min(q0 + kTile, sq) - 1) / kRows + 1) : nk;
  const T* kb = k + (bh / group) * sk * HD;
  const T* vb = v + (bh / group) * sk * HD;
  const int r0 = warp * 16;  // this warp's q rows in the tile

  load_tile<T, HD>(tQ.raw, q + bh * sq * HD, q0, sq);
  cp_async_commit();
  auto load_kv = [&](int kt, int s) {
    load_tile<T, HD, kRows>(k_tile(s).raw, kb, kt * kRows, sk);
    load_tile<T, HD, kRows>(v_tile(s).raw, vb, kt * kRows, sk);
  };
  load_kv(0, 0);
  cp_async_commit();

  // this thread's q rows attend to the keys [0, k_end)
  int qi[2], k_end[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qi[h] = q0 + r0 + g4 + 8 * h;
    k_end[h] = qi[h] < sq ? (causal ? min(sk, qi[h] + 1) : sk) : 0;
  }
  // the online softmax's state of this thread's two rows: m in log2 units,
  // l this lane's share of the row sum (a quad's four lanes add up at the end)
  float m2[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[HD / 8][4];
#pragma unroll
  for (int n8 = 0; n8 < HD / 8; ++n8)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[n8][r] = 0.f;
  const float scale2 = scale * kLog2e;

  cp_async_wait<1>();  // Q has landed
  __syncthreads();
  if constexpr (!L::kRawRead) split_tile<T, HD, true>(tQ);

  for (int kt = 0; kt < n; ++kt) {
    const int stage = kStages == 1 ? 0 : kt & 1;
    if constexpr (kStages == 2) {
      if (kt + 1 < n) load_kv(kt + 1, stage ^ 1);
      cp_async_commit();   // empty when there is no next tile
      cp_async_wait<1>();  // tile kt has landed
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

    // S = Q K^T, then P by the online softmax, then O += P V over this
    // tile's keys
    float s[kN][4];
#pragma unroll
    for (int j = 0; j < kN; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[j][r] = 0.f;
    product_abt<T, HD, kN, true>(s, tQ, r0, cK);
    online_softmax<kN, HD>(s, acc, m2, l, kt * kRows, k_end, scale2);
    product_pb<T, HD, kN, HD>(acc, s, cV, 0);
    __syncthreads();  // every warp is done with this buffer
    if constexpr (kStages == 1) {
      if (kt + 1 < n) load_kv(kt + 1, 0);
      cp_async_commit();
    }
  }

  finish_rows<HD>(acc, m2, l, qi, sq, lse + bh * sq, true);
  store_rows<T, HD>(o + bh * sq * HD, acc, q0 + r0, sq, 1.f);
}

template <typename T, int HD>
int launch_fwd_tf32(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                    int group, int sq, int sk, int causal, float scale, cudaStream_t stream) {
  const size_t smem = fwd_smem<T, HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_tf32_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (sq + kTile - 1) / kTile);
  flash_fwd_tf32_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, group, sq, sk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// B1 above hd 256 (hd = 256 n, n >= 2; the header's note): grid (BH x n, nq),
// x is head x / n and the part x % n whose 256 columns of O the CTA owns.
// For each 32-key tile it sums S = Q K^T over the n slices of 256 columns in
// order (slice s of the q tile and of the K tile in the hd-256 kernel's
// tiles, as a GEMM's k-loop reads them), then adds P V over its part's
// columns of the V tile. Every part computes the same S in the same order,
// so m, l and lse are the same bits in each, and part 0 stores lse.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_wide_tf32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, T* __restrict__ o,
                               float* __restrict__ lse, int hd, int group, int sq, int sk,
                               int causal, float scale) {
  using L = Layout<T, 256>;
  constexpr int kRows = L::kRows;  // keys a K and V tile
  constexpr int kN = kRows / 8;    // n-tiles of S
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                 // one slice of the q tile
  float* sK = sQ + L::kFloats;      // one slice of a K tile
  float* sV = sK + L::kRowsFloats;  // this part's columns of a V tile
  const Tile tQ = {sQ, sQ, sQ}, cK = {sK, sK, sK}, cV = {sV, sV, sV};

  const int parts = hd / 256;
  const size_t bh = blockIdx.x / parts;
  const int c0 = blockIdx.x % parts * 256;  // this CTA's first column of O
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int warp = threadIdx.x >> 5, g4 = (threadIdx.x & 31) >> 2;
  const int nk = (sk + kRows - 1) / kRows;
  const int n = causal ? min(nk, (min(q0 + kTile, sq) - 1) / kRows + 1) : nk;
  const T* qb = q + bh * sq * hd;
  const T* kb = k + (bh / group) * sk * hd;
  const T* vb = v + (bh / group) * sk * hd;
  const int r0 = warp * 16;  // this warp's q rows in the tile

  int qi[2], k_end[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qi[h] = q0 + r0 + g4 + 8 * h;
    k_end[h] = qi[h] < sq ? (causal ? min(sk, qi[h] + 1) : sk) : 0;
  }
  float m2[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[32][4];
#pragma unroll
  for (int n8 = 0; n8 < 32; ++n8)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[n8][r] = 0.f;
  const float scale2 = scale * kLog2e;

  for (int kt = 0; kt < n; ++kt) {
    float s[kN][4];
#pragma unroll
    for (int j = 0; j < kN; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[j][r] = 0.f;
    for (int sl = 0; sl < parts; ++sl) {
      __syncthreads();  // every warp is done with the tiles this step reloads
      load_tile<T, 256>(sQ, qb + sl * 256, q0, sq, hd);
      load_tile<T, 256, kRows>(sK, kb + sl * 256, kt * kRows, sk, hd);
      if (sl == 0) load_tile<T, 256, kRows>(sV, vb + c0, kt * kRows, sk, hd);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      product_abt<T, 256, kN, true>(s, tQ, r0, cK);
    }
    online_softmax<kN, 256>(s, acc, m2, l, kt * kRows, k_end, scale2);
    product_pb<T, 256, kN, 256>(acc, s, cV, 0);
  }

  finish_rows<256>(acc, m2, l, qi, sq, lse + bh * sq, c0 == 0);
  store_rows<T, 256>(o + bh * sq * hd + c0, acc, q0 + r0, sq, 1.f, hd);
}

template <typename T>
int launch_fwd_tf32_wide(int hd, const void* q, const void* k, const void* v, void* o,
                         float* lse, int bh, int group, int sq, int sk, int causal, float scale,
                         cudaStream_t stream) {
  using L = Layout<T, 256>;
  const size_t smem = (L::kFloats + 2 * L::kRowsFloats) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wide_tf32_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh * (hd / 256), (sq + kTile - 1) / kTile);
  flash_fwd_wide_tf32_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, hd, group, sq, sk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int nd_flash_fwd_tf32(int dtype, int hd, const void* q, const void* k, const void* v, void* o,
                      float* lse, int bh, int group, int sq, int sk, int causal, float scale,
                      void* stream) {
  ND_TF32(launch_fwd_tf32, q, k, v, o, lse, bh, group, sq, sk, causal, scale,
          static_cast<cudaStream_t>(stream))
}

}  // extern "C"
