// Fused conformer conv module for Hopper (sm_90a).
//
// Replaces the TPU kernel parakeet_tpu/ops/pallas_conv.py::fused_conv_module
// (_conv_module_kernel, body pallas_utils.py::conv_module_body): per layer
//
//   h = LN(x)                                  f32 statistics, rounded to T
//   a | g = round(h W1^T + b1)                 pointwise d -> 2d
//   h = round(a * sigmoid(g))                  GLU, f32 sigmoid
//   h[t] = 0 for t >= min(len_b, T)            pad rows cannot leak inward
//   y = sum_k h[t + k - (K-1)/2] wd[:, k] + bd depthwise over time, f32
//   y = round(round(y * s + c) * sigmoid(.))   folded inference BN, SiLU;
//                                              s, c rounded to T
//   out = round(x + (y W2^T + b2))             pointwise d -> d, residual f32
//
// Kernels, in order on the caller's stream (the first and the GEMMs live in
// gemm.cuh):
//   row_stats_kernel        LN mean and 1/std per row of x
//   gemm_nt_kernel<GLU>     pw1 with the LN applied to A as it is loaded;
//                           W1's a and g rows are interleaved as the tile is
//                           loaded, so each thread holds both halves of its
//                           GLU pairs and writes the gated, row-masked h
//                           (M, D): the (M, 2D) pw1 output never reaches
//                           device memory
//   depthwise_bn_silu_kernel  the K taps over time, bias, BN folded from the
//                           running statistics in the kernel, SiLU
//   gemm_nt_kernel<PLAIN>   pw2 with bias and the residual x
//
// What bounds it on the card: the two pointwise GEMMs (2*M*D*2D and
// 2*M*D*D FLOPs, 1.6 GFLOP together at B=8, T'=126, D=512) run on the CUDA
// cores in IEEE f32 FMA; the depthwise pass is memory-bound (one read of h,
// one write, the K-row halo from L1/L2). The design removes the plain
// layers' transposes and their LN, GLU, mask, BN and SiLU passes. On an
// H100 80GB HBM3 at 700 W a call took 0.10 ms of device time at B=8,
// T'=126 and 0.50 ms at T'=751, against 0.19 and 0.72 ms for the plain
// version. wgmma tiles for bf16 and a depthwise pass fused into pw2's
// prologue are later work.
//
// Plain C interface, loaded with ctypes. Returns cudaGetLastError() (0 =
// success).

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

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x (B, T, D); w1 (2D, D), b1 (2D,),
// wd (D, K), bd (D,), w2 (D, D), b2 (D,) in the activation dtype; nw, nb and
// the four BN vectors (D,) f32; lengths (B,) int32 valid rows. K odd.
// Scratch (allocated by the caller): stats (B*T, 2) f32, h and h2 (B, T, D).
int pk_conv_module(int dtype, const void* x, const float* nw, const float* nb, const void* w1,
                   const void* b1, const void* wd, const void* bd, const float* bn_w,
                   const float* bn_b, const float* bn_mean, const float* bn_var, const void* w2,
                   const void* b2, const int* lengths, float eps, float* stats, void* h, void* h2,
                   void* out, int B, int T, int D, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_conv<float>(x, nw, nb, w1, b1, wd, bd, bn_w, bn_b, bn_mean, bn_var, w2, b2,
                           lengths, eps, stats, h, h2, out, B, T, D, K, s);
  if (dtype == 1)
    return run_conv<__nv_bfloat16>(x, nw, nb, w1, b1, wd, bd, bn_w, bn_b, bn_mean, bn_var, w2,
                                   b2, lengths, eps, stats, h, h2, out, B, T, D, K, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
