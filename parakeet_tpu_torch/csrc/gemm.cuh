// Shared pieces of the port's hand-written kernels (sm_90a): dtype loads and
// stores, rounding to the activation dtype, LayerNorm statistics and a tiled
// f32-accumulating GEMM with an optional LayerNorm prologue and a choice of
// fused epilogues.
//
// Every source that includes this header is hashed with it by
// ops/_build.py, so an edit here rebuilds each library that uses it.
//
// The GEMM computes C[M, N] = A[M, K] @ W[N, K]^T (W in torch Linear layout)
// in BMx64 tiles (BM = 64 with 256 threads, or 32 with 128 threads when
// 64-row tiles would give fewer than 256 blocks), 4x4 outputs per thread, K
// in steps of 16 through two shared-memory buffers: the next step's A and W
// values are loaded into registers while the FMAs run on the current one.
// IEEE f32 FMA (no TF32, no tensor cores). A and W share the activation
// dtype T; each output accumulates over k in order, so the tile shape does
// not change the result. On an H100 80GB HBM3 at 700 W it ran the FFN's
// GEMMs at 17-21 TFLOP/s (B=8, T'=126-751, D=512, F=2048) against 24-27
// TFLOP/s for cuBLAS's f32 GEMMs, and at 9-13 TFLOP/s before the loads
// overlapped the FMAs; the f32 FMA rate of the CUDA cores (67 TFLOP/s)
// bounds it. Epilogues:
//   EPI_PLAIN     + bias, + residual (when given)          K1 pos/out, K5 pw2
//   EPI_QKV       K1's head-major q/k/v split with the u/v bias fold
//   EPI_SILU      + bias, round, SiLU (f32 sigmoid), round   K6 fc1
//   EPI_HALF_RES  residual + 0.5 * (acc + bias), round once  K6 fc2
//   EPI_GLU       W rows interleaved (a_j, g_j) so each thread holds both
//                 halves of a GLU pair: round(a + b_a), round(g + b_g),
//                 round(a * sigmoid(g)); rows at or past min(len_b, T) are 0
//                                                            K5 pw1
//   EPI_ACT_NCHW  + bias, ReLU or SiLU, stored (B, N, rows) channel-major
//                                                            K8 conv2
//   EPI_POWER     W rows interleaved (cos_j, sin_j) as EPI_GLU's: re*re +
//                 im*im, each product and the sum rounded on its own
//                                                            K3 DFT
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

// ─── LayerNorm statistics: one warp per row ────────────────────────────────

template <typename T>
__global__ void row_stats_kernel(const T* __restrict__ x, float* __restrict__ stats,
                                 int M, int K, float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;  // whole warp leaves together
  const T* xr = x + (size_t)row * K;
  float s = 0.f;
  for (int k = lane; k < K; k += 32) s += ld(xr + k);
  const float mean = warp_sum(s) / (float)K;
  float v = 0.f;
  for (int k = lane; k < K; k += 32) {
    const float d = ld(xr + k) - mean;
    v += d * d;
  }
  const float var = warp_sum(v) / (float)K;
  if (lane == 0) {
    stats[2 * row] = mean;
    stats[2 * row + 1] = 1.f / sqrtf(var + eps);
  }
}

template <typename T>
cudaError_t launch_row_stats(const void* x, float* stats, int M, int K, float eps,
                             cudaStream_t stream) {
  const int threads = 256, rows_per_block = threads / 32;
  row_stats_kernel<T><<<(M + rows_per_block - 1) / rows_per_block, threads, 0, stream>>>(
      static_cast<const T*>(x), stats, M, K, eps);
  return cudaGetLastError();
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
constexpr int EPI_PLAIN = 0, EPI_QKV = 1, EPI_SILU = 2, EPI_HALF_RES = 3, EPI_GLU = 4,
              EPI_ACT_NCHW = 5, EPI_POWER = 6, EPI_LOG = 7;
constexpr int ACT_RELU = 0, ACT_SILU = 1;

struct GemmArgs {
  const void* a;                 // (M, K) with rows lda apart, activation dtype
  const void* w[3];              // weight segments, torch layout (nseg, K) each;
                                 // EPI_GLU: w[0] the a rows, w[1] the g rows;
                                 // EPI_POWER: w[0] the cos rows, w[1] the sin rows
  const void* bias[3];           // per-segment bias (nseg,) or null
  const float* ln_stats;         // (M, 2) mean, 1/std; null = no LN prologue
  const float* ln_w;             // (K,) f32
  const float* ln_b;             // (K,) f32
  const void* residual;          // (M, N) or null (EPI_PLAIN, EPI_HALF_RES)
  void* out[4];                  // out[0] (M, N), (M, N/2) for EPI_GLU, (B, N, T) for
                                 // EPI_ACT_NCHW, (M, N/2) for EPI_POWER;
                                 // QKV: qu, qv, k, v (B, H, T, hd)
  const void* bias_u;            // (D,) EPI_QKV
  const void* bias_v;            // (D,) EPI_QKV
  const int* lengths;            // (B,) valid rows per item, EPI_GLU
  int M, N, K, nseg;
  int lda;                       // A's row stride in elements; 0 = K
  int T, H, HD;                  // T: rows per batch item (EPI_QKV, EPI_GLU, EPI_ACT_NCHW)
  float scale;
  int act;                       // ACT_RELU or ACT_SILU (EPI_ACT_NCHW)
};

template <typename T, int EPI, bool LN, int BM>
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
  // its rows, their LN statistics and W segments are fixed for the whole loop
  const int lr = tid >> 2, lc = (tid & 3) * 4;
  const int am = m0 + lr;
  const bool a_ok = am < g.M;
  const T* a_row = A + (size_t)(a_ok ? am : 0) * (g.lda > 0 ? g.lda : g.K);
  float mean = 0.f, rstd = 0.f;
  if (LN && a_ok) {
    mean = g.ln_stats[2 * am];
    rstd = g.ln_stats[2 * am + 1];
  }
  const T* w_row[WPASS];
  bool w_ok[WPASS];
#pragma unroll
  for (int p = 0; p < WPASS; ++p) {
    const int n = n0 + lr + p * LROWS;
    w_ok[p] = n < g.N;
    int seg = 0, row = 0;
    if (w_ok[p]) {
      if constexpr (EPI == EPI_GLU || EPI == EPI_POWER) {
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
      float a = 0.f;
      if (a_ok && k < g.K) {
        a = ld(a_row + k);
        if (LN) a = round_to<T>((a - mean) * rstd * g.ln_w[k] + g.ln_b[k]);
      }
      a_reg[j] = a;
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
    if constexpr (EPI == EPI_GLU) {
      // columns (2c, 2c+1) of this thread are GLU pair c: a and g
      const int b = m / g.T, t = m - b * g.T;
      const bool valid = t < min(g.lengths[b], g.T);
      const T* ba = static_cast<const T*>(g.bias[0]);
      const T* bg = static_cast<const T*>(g.bias[1]);
      const int half = g.N >> 1;
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        const int n = n0 + tx * 4 + j;
        if (n >= g.N) continue;
        const int c = n >> 1;
        const float av = round_to<T>(acc[i][j] + ld(ba + c));
        const float gv = round_to<T>(acc[i][j + 1] + ld(bg + c));
        st(static_cast<T*>(g.out[0]) + (size_t)m * half + c, valid ? av * sigmoid_f32(gv) : 0.f);
      }
      continue;
    }
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
      const int seg = n / g.nseg, nn = n - seg * g.nseg;
      float val = acc[i][j];
      if (g.bias[seg] != nullptr) val += ld(static_cast<const T*>(g.bias[seg]) + nn);
      if constexpr (EPI == EPI_PLAIN) {
        const size_t o = (size_t)m * g.N + n;
        if (g.residual != nullptr) val = ld(static_cast<const T*>(g.residual) + o) + val;
        st(static_cast<T*>(g.out[0]) + o, val);
      } else if constexpr (EPI == EPI_SILU) {
        const float h = round_to<T>(val);
        st(static_cast<T*>(g.out[0]) + (size_t)m * g.N + n, h * sigmoid_f32(h));
      } else if constexpr (EPI == EPI_HALF_RES) {
        const size_t o = (size_t)m * g.N + n;
        st(static_cast<T*>(g.out[0]) + o, ld(static_cast<const T*>(g.residual) + o) + 0.5f * val);
      } else if constexpr (EPI == EPI_ACT_NCHW) {
        const int b = m / g.T, r = m - b * g.T;
        const float z = g.act == ACT_RELU ? fmaxf(val, 0.f) : val * sigmoid_f32(val);
        st(static_cast<T*>(g.out[0]) + ((size_t)b * g.N + n) * g.T + r, z);
      } else if constexpr (EPI == EPI_LOG) {
        st(static_cast<T*>(g.out[0]) + (size_t)m * g.N + n, logf(val + 5.96046448e-8f));
      } else if constexpr (EPI == EPI_QKV) {
        const int b = m / g.T, t = m - b * g.T;
        const int h = nn / g.HD, c = nn - h * g.HD;
        const size_t o = (((size_t)b * g.H + h) * g.T + t) * g.HD + c;
        if (seg == 0) {
          // 1/sqrt(hd) folded into q and the u/v biases, each rounded to T
          // as the reference kernel rounds them
          const float qs = round_to<T>(val * g.scale);
          const float us = round_to<T>(ld(static_cast<const T*>(g.bias_u) + nn) * g.scale);
          const float vs = round_to<T>(ld(static_cast<const T*>(g.bias_v) + nn) * g.scale);
          st(static_cast<T*>(g.out[0]) + o, qs + us);
          st(static_cast<T*>(g.out[1]) + o, qs + vs);
        } else {
          st(static_cast<T*>(g.out[seg + 1]) + o, val);
        }
      }
    }
  }
}

template <typename T, int EPI, int BM>
void launch_gemm_tiles(const GemmArgs& g, cudaStream_t stream) {
  dim3 grid((g.N + GBN - 1) / GBN, (g.M + BM - 1) / BM);
  if (g.ln_stats != nullptr)
    gemm_nt_kernel<T, EPI, true, BM><<<grid, BM * 4, 0, stream>>>(g);
  else
    gemm_nt_kernel<T, EPI, false, BM><<<grid, BM * 4, 0, stream>>>(g);
}

template <typename T, int EPI>
cudaError_t launch_gemm(const GemmArgs& g, cudaStream_t stream) {
  // 64-row tiles unless they leave the card's 132 SMs with under two blocks
  // each (K1's out-projection, K6's fc2 and K5's pw2 at N = D = 512)
  const long blocks64 = (long)((g.N + GBN - 1) / GBN) * ((g.M + GBM - 1) / GBM);
  if (blocks64 >= 256)
    launch_gemm_tiles<T, EPI, GBM>(g, stream);
  else
    launch_gemm_tiles<T, EPI, GBM / 2>(g, stream);
  return cudaGetLastError();
}

}  // namespace
