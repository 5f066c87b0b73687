// The forward (B1) on Hopper (sm_90a) as three-product TF32: replaces
// _fwd_call / _fwd_kernel of nanodiloco_tpu/ops/pallas/flash_attention.py for
// float32 at every head dim and bf16 at hd 16 and 256. It does two S x S x HD
// products per head on O(S x HD) bytes: operations bound it. The design,
// the bound and the bf16 instances: flash_attention_tf32.cuh.

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
  constexpr bool E = L::kExact;
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
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g4 = lane >> 2, t4 = lane & 3;
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

    // S = Q K^T
    float s[kN][4];
#pragma unroll
    for (int j = 0; j < kN; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[j][r] = 0.f;
#pragma unroll(L::kUnroll)
    for (int kk = 0; kk < L::kSteps; ++kk) {
      uint32_t a_hi[4], a_lo[4];
      a_frag<T, HD, true>(tQ, r0, kk, a_hi, a_lo);
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        uint32_t b_hi[2], b_lo[2];
        bt_frag<T, HD>(cK, 8 * j, kk, b_hi, b_lo);
        mma_split<!E, !E>(s[j], a_hi, a_lo, b_hi, b_lo);
      }
    }
    // the online softmax over this tile's keys, masked; S becomes P
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kN; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kj = kt * kRows + 8 * j + 2 * t4 + c;
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
      for (int n8 = 0; n8 < HD / 8; ++n8) {
        acc[n8][2 * h] *= corr;
        acc[n8][2 * h + 1] *= corr;
      }
    }
    // O += P V over this tile's keys
#pragma unroll
    for (int kq = 0; kq < kN; ++kq) {
      uint32_t a_hi[4], a_lo[4];
      acc_frag(s[kq], a_hi, a_lo);
#pragma unroll
      for (int n8 = 0; n8 < HD / 8; ++n8) {
        uint32_t b_hi[2], b_lo[2];
        b_frag<T, HD>(cV, 8 * kq, 8 * n8, b_hi, b_lo);
        mma_split<true, !E>(acc[n8], a_hi, a_lo, b_hi, b_lo);
      }
    }
    __syncthreads();  // every warp is done with this buffer
    if constexpr (kStages == 1) {
      if (kt + 1 < n) load_kv(kt + 1, 0);
      cp_async_commit();
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xFFFFFFFFu, l[h], 1);
    l[h] += __shfl_xor_sync(0xFFFFFFFFu, l[h], 2);
    const float inv = 1.f / fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int n8 = 0; n8 < HD / 8; ++n8) {
      acc[n8][2 * h] *= inv;
      acc[n8][2 * h + 1] *= inv;
    }
    if (t4 == 0 && qi[h] < sq)
      lse[bh * sq + qi[h]] = l[h] > 0.f ? m2[h] * kLn2 + logf(l[h]) : -INFINITY;
  }
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

}  // namespace

extern "C" {

int nd_flash_fwd_tf32(int dtype, int hd, const void* q, const void* k, const void* v, void* o,
                      float* lse, int bh, int group, int sq, int sk, int causal, float scale,
                      void* stream) {
  ND_TF32(launch_fwd_tf32, q, k, v, o, lse, bh, group, sq, sk, causal, scale,
          static_cast<cudaStream_t>(stream))
}

}  // extern "C"
