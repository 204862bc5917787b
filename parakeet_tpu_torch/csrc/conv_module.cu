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
// gemm.cuh; the depthwise kernel and the launch sequence, run_conv, in
// conv_module.cuh, which K4 includes as well):
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

#include "conv_module.cuh"

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
