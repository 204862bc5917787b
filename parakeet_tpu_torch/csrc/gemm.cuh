// Shared pieces of the port's hand-written kernels (sm_90a): dtype loads and
// stores, rounding to the activation dtype, a whole-row LayerNorm, and the
// small tiled f32 GEMM that K8's conv2 and K3's two products run on.
//
// Every source that includes this header is hashed with it by
// ops/_build.py, so an edit here rebuilds each library that uses it.
//
// What bounds the GEMM on the card, and what it does about it: it computes
// C[M, N] = A[M, K] @ W[N, K]^T (W in torch Linear layout) in IEEE f32 FMA
// on the CUDA cores (no TF32, no tensor cores: 67 TFLOP/s peak), in BMx64
// tiles (BM = 64 with 256 threads, or 32 with 128 threads when 64-row tiles
// would give fewer than 256 blocks), 4x4 outputs per thread, K in steps of
// 16 through two shared-memory buffers: the next step's A and W values are
// loaded into registers while the FMAs run on the current one. Each FMA
// takes 0.5 shared-memory words (the SM serves 32 words per clock against
// 128 FMAs), which caps it near half the FMA rate: on an NVIDIA H100 80GB
// HBM3 at 700 W it ran the FFN's GEMMs at 17-21 TFLOP/s (B=8, T'=126-751,
// D=512, F=2048), against 24-27 TFLOP/s for torch.matmul in f32. The block
// kernels (K6, K1, K5, and K4, K7 through them) moved to ffn_gemm.cuh's
// 128x128 cp.async-fed tiles, which reached 32-36 TFLOP/s in K6; K8's conv2
// and K3 stay here. A and W share the activation dtype T; each output
// accumulates over k in order, so the tile shape does not change the
// result. Epilogues:
//   EPI_ACT_NCHW  + bias, ReLU or SiLU, stored (B, N, rows) channel-major
//                                                            K8 conv2
//   EPI_POWER     W rows interleaved (cos_j, sin_j) so each thread holds
//                 both parts of a bin: re*re + im*im, each product and the
//                 sum rounded on its own                     K3 DFT
//   EPI_LOG       log(acc + 2^-24)                           K3 mel
// A's rows are lda apart (lda = K when 0): K3's DFT reads overlapping
// frames x[t*hop + k] straight from the waveform, without building them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Round a float32 value to the storage type T and back (identity for f32).
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// 1 / (1 + exp(-x)) in f32, as the reference kernels' sigmoid_f32.
__device__ __forceinline__ float sigmoid_f32(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ─── Whole LayerNorm over rows: one warp per row ───────────────────────────
// out = round_T((x - mean) * rstd * w + b), f32 statistics, w and b f32.

template <typename T>
__global__ void layer_norm_rows_kernel(const T* __restrict__ x, const float* __restrict__ w,
                                       const float* __restrict__ b, T* __restrict__ out, int M,
                                       int K, float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const T* xr = x + (size_t)row * K;
  float s = 0.f;
  for (int k = lane; k < K; k += 32) s += ld(xr + k);
  const float mean = warp_sum(s) / (float)K;
  float v = 0.f;
  for (int k = lane; k < K; k += 32) {
    const float d = ld(xr + k) - mean;
    v += d * d;
  }
  const float rstd = 1.f / sqrtf(warp_sum(v) / (float)K + eps);
  T* o = out + (size_t)row * K;
  for (int k = lane; k < K; k += 32) st(o + k, (ld(xr + k) - mean) * rstd * w[k] + b[k]);
}

template <typename T>
cudaError_t launch_layer_norm_rows(const void* x, const float* w, const float* b, void* out,
                                   int M, int K, float eps, cudaStream_t stream) {
  const int threads = 256, rows_per_block = threads / 32;
  layer_norm_rows_kernel<T><<<(M + rows_per_block - 1) / rows_per_block, threads, 0, stream>>>(
      static_cast<const T*>(x), w, b, static_cast<T*>(out), M, K, eps);
  return cudaGetLastError();
}

// ─── GEMM: C[M, N] = A[M, K] @ W[N, K]^T ───────────────────────────────────

constexpr int GBM = 64, GBN = 64, GBK = 16;
constexpr int EPI_ACT_NCHW = 0, EPI_POWER = 1, EPI_LOG = 2;
constexpr int ACT_RELU = 0, ACT_SILU = 1;

struct GemmArgs {
  const void* a;                 // (M, K) with rows lda apart, activation dtype
  const void* w[2];              // weight segments, torch layout (nseg, K) each;
                                 // EPI_POWER: w[0] the cos rows, w[1] the sin rows
  const void* bias[1];           // (N,) or null (EPI_ACT_NCHW)
  void* out[1];                  // (B, N, T) for EPI_ACT_NCHW, (M, N/2) for
                                 // EPI_POWER, (M, N) for EPI_LOG
  int M, N, K, nseg;
  int lda;                       // A's row stride in elements; 0 = K
  int T;                         // rows per batch item (EPI_ACT_NCHW)
  int act;                       // ACT_RELU or ACT_SILU (EPI_ACT_NCHW)
};

template <typename T, int EPI, int BM>
__global__ void __launch_bounds__(BM * 4) gemm_nt_kernel(GemmArgs g) {
  constexpr int THREADS = BM * 4;        // (BM/4) x 16 threads, 4x4 outputs each
  constexpr int LROWS = THREADS / 4;     // tile rows loaded per pass: 4 k each
  constexpr int WPASS = GBN / LROWS;     // W passes (A takes one: LROWS == BM)
  static_assert(GBK == 16 && LROWS == BM, "loader assumes 4 threads of 4 k per tile row");
  __shared__ __align__(16) float As[2][GBK][BM + 4];
  __shared__ __align__(16) float Ws[2][GBK][GBN + 4];
  const T* A = static_cast<const T*>(g.a);
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * GBN;

  // each thread loads 4 consecutive k of one A row and of WPASS W rows;
  // its rows and W segments are fixed for the whole loop
  const int lr = tid >> 2, lc = (tid & 3) * 4;
  const int am = m0 + lr;
  const bool a_ok = am < g.M;
  const T* a_row = A + (size_t)(a_ok ? am : 0) * (g.lda > 0 ? g.lda : g.K);
  const T* w_row[WPASS];
  bool w_ok[WPASS];
#pragma unroll
  for (int p = 0; p < WPASS; ++p) {
    const int n = n0 + lr + p * LROWS;
    w_ok[p] = n < g.N;
    int seg = 0, row = 0;
    if (w_ok[p]) {
      if constexpr (EPI == EPI_POWER) {
        seg = n & 1;
        row = n >> 1;
      } else {
        seg = n / g.nseg;
        row = n - seg * g.nseg;
      }
    }
    w_row[p] = static_cast<const T*>(g.w[seg]) + (size_t)row * g.K;
  }

  float a_reg[4], w_reg[WPASS][4];
  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + lc + j;
      a_reg[j] = (a_ok && k < g.K) ? ld(a_row + k) : 0.f;
#pragma unroll
      for (int p = 0; p < WPASS; ++p) w_reg[p][j] = (w_ok[p] && k < g.K) ? ld(w_row[p] + k) : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      As[buf][lc + j][lr] = a_reg[j];
#pragma unroll
      for (int p = 0; p < WPASS; ++p) Ws[buf][lc + j][lr + p * LROWS] = w_reg[p][j];
    }
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  load(0);
  store(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < g.K; k0 += GBK) {
    const bool more = k0 + GBK < g.K;
    if (more) load(k0 + GBK);  // in flight while the FMAs below run
#pragma unroll
    for (int kk = 0; kk < GBK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 w4 = *reinterpret_cast<const float4*>(&Ws[buf][kk][tx * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    // the other buffer was last read before the previous barrier
    if (more) store(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= g.M) continue;
    if constexpr (EPI == EPI_POWER) {
      // columns (2c, 2c+1) of this thread are bin c's real and imaginary parts
      const int half = g.N >> 1;
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        const int n = n0 + tx * 4 + j;
        if (n >= g.N) continue;
        const float re = acc[i][j], im = acc[i][j + 1];
        st(static_cast<T*>(g.out[0]) + (size_t)m * half + (n >> 1),
           __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
      }
      continue;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= g.N) continue;
      float val = acc[i][j];
      if (g.bias[0] != nullptr) val += ld(static_cast<const T*>(g.bias[0]) + n);
      if constexpr (EPI == EPI_ACT_NCHW) {
        const int b = m / g.T, r = m - b * g.T;
        const float z = g.act == ACT_RELU ? fmaxf(val, 0.f) : val * sigmoid_f32(val);
        st(static_cast<T*>(g.out[0]) + ((size_t)b * g.N + n) * g.T + r, z);
      } else if constexpr (EPI == EPI_LOG) {
        st(static_cast<T*>(g.out[0]) + (size_t)m * g.N + n, logf(val + 5.96046448e-8f));
      }
    }
  }
}

template <typename T, int EPI, int BM>
void launch_gemm_tiles(const GemmArgs& g, cudaStream_t stream) {
  dim3 grid((g.N + GBN - 1) / GBN, (g.M + BM - 1) / BM);
  gemm_nt_kernel<T, EPI, BM><<<grid, BM * 4, 0, stream>>>(g);
}

template <typename T, int EPI>
cudaError_t launch_gemm(const GemmArgs& g, cudaStream_t stream) {
  // 64-row tiles unless they leave the card's 132 SMs with under two blocks each
  const long blocks64 = (long)((g.N + GBN - 1) / GBN) * ((g.M + GBM - 1) / GBM);
  if (blocks64 >= 256)
    launch_gemm_tiles<T, EPI, GBM>(g, stream);
  else
    launch_gemm_tiles<T, EPI, GBM / 2>(g, stream);
  return cudaGetLastError();
}

}  // namespace
