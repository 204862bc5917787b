// Device code and launch sequence of K5, the fused conformer conv module
// (see conv_module.cu for what it computes and what bounds it): the
// depthwise + BN + SiLU kernel and run_conv, which launches LN statistics,
// pw1 with the GLU, the depthwise pass and pw2 on the caller's stream.
// Included by conv_module.cu and conv_ffn_final.cu.
#pragma once

#include "gemm.cuh"

namespace {

// One thread per (b, t, c). Rows outside [0, T) are the zero padding; rows
// past an item's length were already zeroed by the GLU epilogue.
template <typename T>
__global__ void depthwise_bn_silu_kernel(const T* __restrict__ h, const T* __restrict__ wd,
                                         const T* __restrict__ bd, const float* __restrict__ bn_w,
                                         const float* __restrict__ bn_b,
                                         const float* __restrict__ bn_mean,
                                         const float* __restrict__ bn_var, T* __restrict__ out,
                                         int B, int Tn, int D, int K) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * Tn * D) return;
  const int c = (int)(idx % D);
  const size_t bt = idx / D;
  const int t = (int)(bt % Tn);
  const size_t row0 = bt - t;  // (b * Tn)
  const int pad = (K - 1) / 2;
  float acc = 0.f;
  for (int k = 0; k < K; ++k) {
    const int tt = t + k - pad;
    if (tt >= 0 && tt < Tn) acc = fmaf(ld(h + (row0 + tt) * D + c), ld(wd + (size_t)c * K + k), acc);
  }
  acc += ld(bd + c);
  // fold_batch_norm: scale = w / sqrt(var + 1e-5), bias = b - mean * inv * w,
  // both rounded to T; __fmul_rn/__fsub_rn keep the reference's rounding
  const float inv = 1.f / sqrtf(bn_var[c] + 1e-5f);
  const float scale = round_to<T>(__fmul_rn(bn_w[c], inv));
  const float bias = round_to<T>(__fsub_rn(bn_b[c], __fmul_rn(__fmul_rn(bn_mean[c], inv), bn_w[c])));
  const float y = round_to<T>(__fadd_rn(__fmul_rn(acc, scale), bias));
  st(out + idx, y * sigmoid_f32(y));
}

template <typename T>
int run_conv(const void* x, const float* nw, const float* nb, const void* w1, const void* b1,
             const void* wd, const void* bd, const float* bn_w, const float* bn_b,
             const float* bn_mean, const float* bn_var, const void* w2, const void* b2,
             const int* lengths, float eps, float* stats, void* h, void* h2, void* out, int B,
             int Tn, int D, int K, cudaStream_t stream) {
  const int M = B * Tn;
  cudaError_t err;
  if ((err = launch_row_stats<T>(x, stats, M, D, eps, stream)) != cudaSuccess) return (int)err;

  GemmArgs up = {};
  up.a = x;
  up.w[0] = w1;
  up.w[1] = static_cast<const T*>(w1) + (size_t)D * D;
  up.bias[0] = b1;
  up.bias[1] = static_cast<const T*>(b1) + D;
  up.ln_stats = stats;
  up.ln_w = nw;
  up.ln_b = nb;
  up.lengths = lengths;
  up.out[0] = h;
  up.M = M; up.N = 2 * D; up.K = D; up.nseg = D;
  up.T = Tn;
  if ((err = launch_gemm<T, EPI_GLU>(up, stream)) != cudaSuccess) return (int)err;

  const size_t total = (size_t)M * D;
  const int threads = 256;
  depthwise_bn_silu_kernel<T><<<(unsigned)((total + threads - 1) / threads), threads, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(wd), static_cast<const T*>(bd), bn_w, bn_b,
      bn_mean, bn_var, static_cast<T*>(h2), B, Tn, D, K);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  GemmArgs down = {};
  down.a = h2;
  down.w[0] = w2;
  down.bias[0] = b2;
  down.residual = x;
  down.out[0] = out;
  down.M = M; down.N = D; down.K = D; down.nseg = D;
  if ((err = launch_gemm<T, EPI_PLAIN>(down, stream)) != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace
