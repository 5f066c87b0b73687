// Flash attention for Hopper (sm_90a): forward (B1), dQ (B2) and dK/dV (B3).
//
// Replaces the three Pallas TPU kernels of
// nanodiloco_tpu/ops/pallas/flash_attention.py:
//   B1 flash_fwd_kernel    <- _fwd_call / _fwd_kernel
//   B2 flash_bwd_dq_kernel <- _flash_bwd / _bwd_dq_kernel
//   B3 flash_bwd_dkv_kernel<- _flash_bwd / _bwd_dkv_kernel
//
// Layouts are the TPU kernels' own: q, o, dO, dQ [BH, Sq, HD]; k, v, dK, dV
// [BH / group, Sk, HD] (GQA: query head bh reads KV head bh / group, K/V are
// never expanded); lse and delta [BH, Sq] float32. Inputs are float32 or
// bfloat16; every product accumulates in float32.
//
// Design. On the TPU the grid ran in order, so the online-softmax state was
// carried in VMEM across a sequential K-block axis. Here CTAs run in parallel
// and in no order, so each CTA owns one output tile and runs the reduction
// loop itself, with the accumulators in registers:
//   B1, B2: one CTA per (bh, 64-row q tile), looping over K tiles up to the
//           causal diagonal.
//   B3:     one CTA per (KV head, 64-row K tile), looping over the `group`
//           query heads that share the KV head and over their q tiles from
//           the diagonal down. It holds the dK/dV sums itself: no atomics,
//           so the result is deterministic.
// A ragged sequence length is masked inside the kernels (rows past the end
// load as zeros, their scores as -inf). A fully masked row keeps m = -inf and
// gets p = 0 and corr = 0, so it ends with O = 0 and lse = -inf, never NaN.
//
// Bound on the H100. At the training shape (hd 128, S 2048, causal) each
// kernel does 2 (B1), 3 (B2) or 4 (B3) S x S x hd products per head against
// O(S x hd) bytes per head, far above the card's ~295 flop/byte ridge: the
// work is bound by operations. These kernels compute those products as
// float32 FMAs from shared memory (64 x 64 tiles, a 4 x 4 or 4 x hd/16
// register tile per thread) on the CUDA cores, whose float32 peak is
// 67 TFLOP/s. They serve every float32 case (wgmma has no float32 path, and
// TF32 would not hold the float32 tolerance) and bf16 at hd 32 and 64; bf16
// at hd 128 runs on the tensor cores in flash_attention_tc.cu (route table in
// ops/cuda/flash_attention.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kTile = 64;          // rows of every q and K tile
constexpr int kThreads = 256;      // 16 x 16 threads; thread (ty, tx)
constexpr int kScoreLd = kTile + 1;  // padded row stride of [64][64] score tiles

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Rows [row0, row0 + 64) of a row-major [n_rows, HD] matrix into a shared
// [64][HD + 1] float32 tile (the +1 keeps column reads free of bank
// conflicts). Rows at or past n_rows load as zeros.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int row0, int n_rows) {
  for (int e = threadIdx.x; e < kTile * HD; e += kThreads) {
    const int r = e / HD;
    const int c = e % HD;
    const int gr = row0 + r;
    dst[r * (HD + 1) + c] =
        gr < n_rows ? to_f32<T>(src[static_cast<size_t>(gr) * HD + c]) : 0.f;
  }
}

// acc[i][j] = sum_d A[ty*4 + i][d] * B[tx + 16 j][d]; A, B are [64][HD + 1].
template <int HD>
__device__ __forceinline__ void mm_abt(const float* A, const float* B, int ty,
                                       int tx, float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty * 4 + i) * (HD + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * (HD + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_k P[ty*4 + i][k] * B[k][tx + 16 j]; P is [64][65],
// B is [64][HD + 1], j < HD / 16.
template <int HD>
__device__ __forceinline__ void mm_ab(const float* P, const float* B, int ty,
                                      int tx, float acc[4][HD / 16]) {
#pragma unroll 4
  for (int k = 0; k < kTile; ++k) {
    float a[4], b[HD / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = P[(ty * 4 + i) * kScoreLd + k];
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) b[j] = B[k * (HD + 1) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Reductions over the 16 threads that share ty (one half of a warp). The xor
// butterfly leaves the same value in all 16 lanes.
__device__ __forceinline__ float max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Number of K tiles a q tile starting at q0 attends to.
__device__ __forceinline__ int k_tiles_for(int q0, int sq, int sk, int causal) {
  const int nk = (sk + kTile - 1) / kTile;
  if (!causal) return nk;
  const int last_q = min(q0 + kTile, sq) - 1;
  return min(nk, last_q / kTile + 1);
}

// ---------------------------------------------------------------------------
// B1: forward. grid (BH, nq); the y index is reversed so the longest causal
// rows start first.
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int group, int sq, int sk,
                     int causal, float scale) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kTile * (HD + 1);
  float* sV = sK + kTile * (HD + 1);
  float* sP = sV + kTile * (HD + 1);

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* kb = k + static_cast<size_t>(bh / group) * sk * HD;
  const T* vb = v + static_cast<size_t>(bh / group) * sk * HD;

  load_tile<T, HD>(sQ, q + static_cast<size_t>(bh) * sq * HD, q0, sq);

  float m[4], l[4], acc[4][HD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) acc[i][j] = 0.f;
  }

  const int kt_end = k_tiles_for(q0, sq, sk, causal);
  for (int kt = 0; kt < kt_end; ++kt) {
    __syncthreads();  // the previous tile's sK, sV, sP are no longer read
    load_tile<T, HD>(sK, kb, kt * kTile, sk);
    load_tile<T, HD>(sV, vb, kt * kTile, sk);
    __syncthreads();

    float s[4][4];
    mm_abt<HD>(sQ, sK, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = kt * kTile + tx + 16 * j;
        const bool ok = kj < sk && (!causal || kj <= qi);
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_safe);
        ps += s[i][j];
      }
      const float corr = m[i] == -INFINITY ? 0.f : expf(m[i] - m_safe);
      l[i] = l[i] * corr + sum16(ps);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) acc[i][j] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j) sP[(ty * 4 + i) * kScoreLd + tx + 16 * j] = s[i][j];
    }
    __syncthreads();
    mm_ab<HD>(sP, sV, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + (static_cast<size_t>(bh) * sq + qi) * HD;
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) orow[tx + 16 * j] = from_f32<T>(acc[i][j] / den);
    if (tx == 0)
      lse[static_cast<size_t>(bh) * sq + qi] = l[i] > 0.f ? m[i] + logf(den) : -INFINITY;
  }
}

// ---------------------------------------------------------------------------
// B2: dQ. Same grid as B1. P = exp(S * scale - lse), dP = dO V^T,
// dS = P (dP - delta), dQ = scale * sum over K tiles of dS K.
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int group, int sq, int sk, int causal, float scale) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + kTile * (HD + 1);
  float* sK = sdO + kTile * (HD + 1);
  float* sV = sK + kTile * (HD + 1);
  float* sdS = sV + kTile * (HD + 1);

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* kb = k + static_cast<size_t>(bh / group) * sk * HD;
  const T* vb = v + static_cast<size_t>(bh / group) * sk * HD;

  load_tile<T, HD>(sQ, q + static_cast<size_t>(bh) * sq * HD, q0, sq);
  load_tile<T, HD>(sdO, dout + static_cast<size_t>(bh) * sq * HD, q0, sq);

  float lse_r[4], delta_r[4], acc[4][HD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    lse_r[i] = qi < sq ? lse[static_cast<size_t>(bh) * sq + qi] : 0.f;
    delta_r[i] = qi < sq ? delta[static_cast<size_t>(bh) * sq + qi] : 0.f;
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) acc[i][j] = 0.f;
  }

  const int kt_end = k_tiles_for(q0, sq, sk, causal);
  for (int kt = 0; kt < kt_end; ++kt) {
    __syncthreads();
    load_tile<T, HD>(sK, kb, kt * kTile, sk);
    load_tile<T, HD>(sV, vb, kt * kTile, sk);
    __syncthreads();

    float s[4][4], dp[4][4];
    mm_abt<HD>(sQ, sK, ty, tx, s);
    mm_abt<HD>(sdO, sV, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = kt * kTile + tx + 16 * j;
        const bool ok = qi < sq && kj < sk && (!causal || kj <= qi);
        const float p = ok ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        sdS[(ty * 4 + i) * kScoreLd + tx + 16 * j] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();
    mm_ab<HD>(sdS, sK, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= sq) continue;
    T* row = dq + (static_cast<size_t>(bh) * sq + qi) * HD;
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) row[tx + 16 * j] = from_f32<T>(acc[i][j] * scale);
  }
}

// ---------------------------------------------------------------------------
// B3: dK and dV. grid (BH / group, nk): one CTA per (KV head, K tile). The
// thread tile is transposed against B2: rows are keys, columns are queries,
// so S^T = K Q^T and dP^T = V dO^T come out of the same mm_abt, and
// dV += P^T dO, dK += dS^T Q come out of mm_ab.
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int group, int sq, int sk,
                         int causal, float scale) {
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kTile * (HD + 1);
  float* sQ = sV + kTile * (HD + 1);
  float* sdO = sQ + kTile * (HD + 1);
  float* sPt = sdO + kTile * (HD + 1);
  float* sdSt = sPt + kTile * kScoreLd;
  float* sLse = sdSt + kTile * kScoreLd;
  float* sDelta = sLse + kTile;

  const int bkv = blockIdx.x;
  const int k0 = blockIdx.y * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_tile<T, HD>(sK, k + static_cast<size_t>(bkv) * sk * HD, k0, sk);
  load_tile<T, HD>(sV, v + static_cast<size_t>(bkv) * sk * HD, k0, sk);

  float dk_acc[4][HD / 16], dv_acc[4][HD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int nq = (sq + kTile - 1) / kTile;
  // q tiles wholly above the diagonal (every query before this K tile's
  // first key) contribute nothing under the causal mask
  const int qt_start = causal ? k0 / kTile : 0;
  for (int g = 0; g < group; ++g) {
    const size_t bh = static_cast<size_t>(bkv) * group + g;
    const T* qb = q + bh * sq * HD;
    const T* db = dout + bh * sq * HD;
    for (int qt = qt_start; qt < nq; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();
      load_tile<T, HD>(sQ, qb, q0, sq);
      load_tile<T, HD>(sdO, db, q0, sq);
      if (threadIdx.x < kTile) {
        const int qi = q0 + threadIdx.x;
        sLse[threadIdx.x] = qi < sq ? lse[bh * sq + qi] : 0.f;
        sDelta[threadIdx.x] = qi < sq ? delta[bh * sq + qi] : 0.f;
      }
      __syncthreads();

      float st[4][4], dpt[4][4];
      mm_abt<HD>(sK, sQ, ty, tx, st);
      mm_abt<HD>(sV, sdO, ty, tx, dpt);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kr = k0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qc = q0 + tx + 16 * j;
          const bool ok = kr < sk && qc < sq && (!causal || kr <= qc);
          const float p = ok ? expf(st[i][j] * scale - sLse[tx + 16 * j]) : 0.f;
          sPt[(ty * 4 + i) * kScoreLd + tx + 16 * j] = p;
          sdSt[(ty * 4 + i) * kScoreLd + tx + 16 * j] = p * (dpt[i][j] - sDelta[tx + 16 * j]);
        }
      }
      __syncthreads();
      mm_ab<HD>(sPt, sdO, ty, tx, dv_acc);
      mm_ab<HD>(sdSt, sQ, ty, tx, dk_acc);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = k0 + ty * 4 + i;
    if (kr >= sk) continue;
    const size_t off = (static_cast<size_t>(bkv) * sk + kr) * HD;
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      dk[off + tx + 16 * j] = from_f32<T>(dk_acc[i][j] * scale);
      dv[off + tx + 16 * j] = from_f32<T>(dv_acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers. Each returns cudaGetLastError() after the launch (0 = launched);
// -1 for a head dim or dtype this file was not instantiated for.
// ---------------------------------------------------------------------------
template <int HD>
constexpr size_t fwd_smem() {
  return (3 * kTile * (HD + 1) + kTile * kScoreLd) * sizeof(float);
}
template <int HD>
constexpr size_t dq_smem() {
  return (4 * kTile * (HD + 1) + kTile * kScoreLd) * sizeof(float);
}
template <int HD>
constexpr size_t dkv_smem() {
  return (4 * kTile * (HD + 1) + 2 * kTile * kScoreLd + 2 * kTile) * sizeof(float);
}

template <typename T, int HD>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
               int bh, int group, int sq, int sk, int causal, float scale,
               cudaStream_t stream) {
  const size_t smem = fwd_smem<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (sq + kTile - 1) / kTile);
  flash_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, group, sq, sk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int bh, int group,
              int sq, int sk, int causal, float scale, cudaStream_t stream) {
  const size_t smem = dq_smem<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (sq + kTile - 1) / kTile);
  flash_bwd_dq_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), group, sq, sk,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv, int bh,
               int group, int sq, int sk, int causal, float scale,
               cudaStream_t stream) {
  const size_t smem = dkv_smem<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh / group, (sk + kTile - 1) / kTile);
  flash_bwd_dkv_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk),
      static_cast<T*>(dv), group, sq, sk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32 at head dims 32, 64, 128; 1 = bfloat16 at 32 and 64
// (bf16 at 128 runs on the tensor cores, in flash_attention_tc.cu).
#define ND_DISPATCH(LAUNCH, ...)                                              \
  {                                                                           \
    if (dtype == 0) {                                                         \
      if (hd == 32) return LAUNCH<float, 32>(__VA_ARGS__);                    \
      if (hd == 64) return LAUNCH<float, 64>(__VA_ARGS__);                    \
      if (hd == 128) return LAUNCH<float, 128>(__VA_ARGS__);                  \
    } else if (dtype == 1) {                                                  \
      if (hd == 32) return LAUNCH<__nv_bfloat16, 32>(__VA_ARGS__);            \
      if (hd == 64) return LAUNCH<__nv_bfloat16, 64>(__VA_ARGS__);            \
    }                                                                         \
    return -1;                                                                \
  }

extern "C" {

const char* nd_error_string(int code) {
  return code < 0 ? "dtype or head dim not instantiated"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}

int nd_flash_fwd(int dtype, int hd, const void* q, const void* k, const void* v,
                 void* o, float* lse, int bh, int group, int sq, int sk,
                 int causal, float scale, void* stream) {
  ND_DISPATCH(launch_fwd, q, k, v, o, lse, bh, group, sq, sk, causal, scale,
              static_cast<cudaStream_t>(stream));
}

int nd_flash_bwd_dq(int dtype, int hd, const void* q, const void* k,
                    const void* v, const void* dout, const float* lse,
                    const float* delta, void* dq, int bh, int group, int sq,
                    int sk, int causal, float scale, void* stream) {
  ND_DISPATCH(launch_dq, q, k, v, dout, lse, delta, dq, bh, group, sq, sk,
              causal, scale, static_cast<cudaStream_t>(stream));
}

int nd_flash_bwd_dkv(int dtype, int hd, const void* q, const void* k,
                     const void* v, const void* dout, const float* lse,
                     const float* delta, void* dk, void* dv, int bh, int group,
                     int sq, int sk, int causal, float scale, void* stream) {
  ND_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, dk, dv, bh, group, sq, sk,
              causal, scale, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
