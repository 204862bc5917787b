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
// Two routes, one per plan (ops/conv_module.py conv_plan), each a launch
// sequence in conv_module.cuh that K4 runs for its conv half too:
//
// bf16 at D <= 1024, the Hopper design, three launches:
//   1. pw1 + GLU on ffn_gemm.cuh's hopper_gemm_kernel with the LayerNorm on
//      its A path (the rows normalised once a cluster of column tiles, as
//      in K6's fc1); the B tile holds 64 a rows and their
//      64 g rows, so the gated, row-masked h (M, D) is written directly
//   2. depthwise_bn_silu_kernel (conv_module.cuh): a 32-row x 64-channel
//      block loads its slab of h (plus the K-1 halo rows) and its taps into
//      shared memory once, folds the BN per channel once, and computes the
//      K taps, bias, BN, SiLU
//   3. pw2, k split over a thread-block cluster summed in distributed
//      shared memory: round(x + y + b2)
// No LayerNorm launch, no f32 partials and no closing pass.
//
// f32, and bf16 rows wider than a cluster (D > 1024), the tiled GEMM, five
// launches: layer_norm_rows_kernel (h2 = round(LN(x)) once); ffn_gemm<GLU>
// (pw1 on the plan's 64-, 96- or 128-row tiles, the loader pairing each
// output's a and g rows); the depthwise pass; ffn_gemm<PARTIAL> (pw2 in k
// slices) and gemm_reduce_kernel (in-order slice sum, + b2, + x, round).
//
// What bounds it on the card: the two pointwise GEMMs (2*M*D*2D and 2*M*D*D
// FLOPs, 1.6 GFLOP at B=8, T'=126, D=512); the depthwise pass is
// memory-bound (one read of h, one write). In bf16 the GEMMs take 0.0016 ms
// at the tensor cores' peak, so the launches and passes through device
// memory decide the time, which the Hopper design cuts from five launches
// to three. In f32 the FMAs on the CUDA cores bound the GEMMs (0.024 ms at
// 67 TFLOP/s); the tiled GEMM's register-blocked tiles and split-K pw2 fill
// the 132 SMs. A Hopper design for f32 lost and was withdrawn
// (ffn_gemm.cuh's note).
//
// Measured (device time, B=8, 110m widths, mixed lengths, kernel / plain
// version; NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py): f32 0.072 /
// 0.187 ms at T'=126 (pw1 0.037 on 64-row tiles, pw2 in 8 k slices 0.019,
// closing pass 0.006, depthwise 0.006, LayerNorm 0.004) and 0.298-0.319 /
// 0.730 ms at T'=751; bf16 0.0305 / 0.270 ms at T'=126 (pw1 with the
// LayerNorm on its A path 0.0152, depthwise 0.0060, pw2 in clusters of 2 k
// slices 0.0091) and 0.106 / 0.874 ms at T'=751, in turns with the mma.sync
// sequence it replaces 0.0475-0.0478 and 0.129.
//
// Plain C interface, loaded with ctypes. Returns cudaGetLastError() (0 =
// success).

#include "conv_module.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x (B, T, D); w1 (2D, D), b1 (2D,),
// wd (D, K), bd (D,), w2 (D, D), b2 (D,) in the activation dtype; nw, nb and
// the four BN vectors (D,) f32; lengths (B,) int32 valid rows (min(len, T)
// is taken in the kernels). K odd. Scratch (allocated by the caller): h and
// h2 (B, T, D); the tiled route's part, pw2's f32 partials (pw2_splits,
// B*T, D). The plan (ops/conv_module.py conv_plan): hopper (1: the Hopper
// design, bf16 only), pw1_rows (pw1's block rows on the tiled route; the
// Hopper design's LayerNorm cluster of column tiles), pw2_splits (pw2's k
// slices).
int pk_conv_module(int dtype, const void* x, const float* nw, const float* nb, const void* w1,
                   const void* b1, const void* wd, const void* bd, const float* bn_w,
                   const float* bn_b, const float* bn_mean, const float* bn_var, const void* w2,
                   const void* b2, const int* lengths, float eps, float* part, void* h, void* h2,
                   void* out, int B, int T, int D, int K, int hopper, int pw1_rows, int pw2_splits,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hopper)
    return dtype != 1 ? (int)cudaErrorInvalidValue
                      : run_conv_hopper(x, nw, nb, w1, b1, wd, bd, bn_w, bn_b, bn_mean, bn_var, w2, b2, lengths, eps,
                                        h, h2, out, nullptr, nullptr, nullptr, B, T, D, K, pw1_rows, pw2_splits, s);
  if (dtype == 0)
    return run_conv<float>(x, nw, nb, w1, b1, wd, bd, bn_w, bn_b, bn_mean, bn_var, w2, b2, lengths, eps, part, h, h2,
                           out, B, T, D, K, pw1_rows, pw2_splits, s);
  if (dtype == 1)
    return run_conv<__nv_bfloat16>(x, nw, nb, w1, b1, wd, bd, bn_w, bn_b, bn_mean, bn_var, w2, b2, lengths, eps, part,
                                   h, h2, out, B, T, D, K, pw1_rows, pw2_splits, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
