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
// Kernels, in order on the caller's stream (the LayerNorm in gemm.cuh, the
// GEMMs and the closing pass in ffn_gemm.cuh; the depthwise kernel and the
// launch sequence, run_conv, in conv_module.cuh, which K4 includes as
// well):
//   layer_norm_rows_kernel  h = round(LN(x)) once, so that pw1 takes A by
//                           cp.async
//   ffn_gemm<GLU>           pw1 on 64-, 96- or 128-row tiles (plan): the
//                           loader maps tile rows to W1's a and g rows so
//                           that each thread holds both halves of its GLU
//                           pairs and writes the gated, row-masked h
//                           (M, D): the (M, 2D) pw1 output never reaches
//                           device memory
//   depthwise_bn_silu_kernel  a 32-row x 64-channel block loads its slab of
//                           h (plus the K-1 halo rows) and its taps into
//                           shared memory once, folds the BN per channel
//                           once, and computes the K taps, bias, BN, SiLU
//   ffn_gemm<PARTIAL>       pw2 in k slices by the plan, and
//   gemm_reduce_kernel      its closing pass: in-order slice sum, + b2,
//                           + x, round once
//
// What bounds it on the card: the two pointwise GEMMs (2*M*D*2D and
// 2*M*D*D FLOPs, 1.6 GFLOP together at B=8, T'=126, D=512: a 0.024 ms
// bound at the f32 FMA peak of 67 TFLOP/s) in IEEE f32 FMA on the CUDA
// cores; the depthwise pass is memory-bound (one read of h, one write).
// The design runs both GEMMs on ffn_gemm.cuh's register-blocked tiles
// (8 x 8 f32 outputs per thread, 0.25 shared-memory words per FMA; tensor
// cores through mma.sync in bf16), fed by cp.async now that the LayerNorm
// is applied once; pw2 (N = D, 32 tiles at T'=126) is split along k so
// that its blocks fill the 132 SMs; the depthwise pass reads h once
// through shared memory. It removes the plain layers' transposes and
// their LN, GLU, mask, BN and SiLU passes. Fusing the depthwise pass into
// pw2's A loads is later work.
//
// Measured (device time, B=8, 110m widths, mixed lengths, kernel / plain
// version; NVIDIA H100 80GB HBM3, 700.00 W): f32 0.074 / 0.186 ms at
// T'=126 (pw1 0.037 on 64-row tiles, pw2 in 8 k slices 0.019, closing pass
// 0.006, depthwise 0.006, LayerNorm 0.004) and 0.324 / 0.719 ms at T'=751;
// bf16 0.048 / 0.271 and 0.131 / 0.874 ms. The design before it (64x64
// GEMM tiles with the LayerNorm on the A loads, one thread per depthwise
// output reading its taps from device memory) took 0.104 and 0.497 ms in
// f32.
//
// Plain C interface, loaded with ctypes. Returns cudaGetLastError() (0 =
// success).

#include "conv_module.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x (B, T, D); w1 (2D, D), b1 (2D,),
// wd (D, K), bd (D,), w2 (D, D), b2 (D,) in the activation dtype; nw, nb and
// the four BN vectors (D,) f32; lengths (B,) int32 valid rows. K odd.
// Scratch (allocated by the caller): part, pw2's f32 partials (pw2_splits,
// B*T, D); h and h2 (B, T, D). pw1_rows,
// pw2_splits: the launch plan (ops/conv_module.py conv_plan).
int pk_conv_module(int dtype, const void* x, const float* nw, const float* nb, const void* w1,
                   const void* b1, const void* wd, const void* bd, const float* bn_w,
                   const float* bn_b, const float* bn_mean, const float* bn_var, const void* w2,
                   const void* b2, const int* lengths, float eps, float* part, void* h, void* h2,
                   void* out, int B, int T, int D, int K, int pw1_rows, int pw2_splits,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_conv<float>(x, nw, nb, w1, b1, wd, bd, bn_w, bn_b, bn_mean, bn_var, w2, b2,
                           lengths, eps, part, h, h2, out, B, T, D, K, pw1_rows, pw2_splits, s);
  if (dtype == 1)
    return run_conv<__nv_bfloat16>(x, nw, nb, w1, b1, wd, bd, bn_w, bn_b, bn_mean, bn_var, w2,
                                   b2, lengths, eps, part, h, h2, out, B, T, D, K, pw1_rows,
                                   pw2_splits, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
