// The second half of a conformer block for Hopper (sm_90a): K4.
//
// Replaces the TPU kernel parakeet_tpu/ops/pallas_block.py::
// fused_conv_ffn_final (_conv_ffn_kernel), which the reference's encoder
// runs for every block under set_fused_block2(True) (bench.py
// --fused-block2). Per layer, on the attention output x:
//
//   x2  = x + ConvModule(x)           conv_module_body: LN, pw1, GLU, pad
//                                     rows zeroed, depthwise, folded BN,
//                                     SiLU, pw2, residual; rounded to T
//   x3  = x2 + 0.5 * FFN(x2)          ffn_body: LN, fc1, SiLU, fc2; rounded
//   out = round(LN(x3))               the block's final LayerNorm
//
// Both bodies return T in the reference (pallas_utils.py), so K4 is K5
// followed by K6 with the final LayerNorm, exactly: the launch sequences of
// conv_module.cuh (run_conv) and feed_forward.cuh (run_ffn) run one after
// the other on the caller's stream (eight to nine launches, by the plans);
// the FFN's LayerNorm output reuses the conv half's h. Only the conv half masks rows by length.
//
// What bounds it on the card: the four GEMMs (pw1, pw2, fc1, fc2: 2*M*D*
// (3D + 2F) FLOPs, 5.8 GFLOP at B=8, T'=126, D=512, F=2048) in IEEE f32 FMA
// on the CUDA cores, all on ffn_gemm.cuh's tiles, as in K5 and K6. The TPU kernel's gain was
// one VMEM-resident program per item; on the card the saving is one Python
// call and its argument checks per block, and the intermediate x2 stays in
// L2 (8 x 126 x 512 x 4 = 2 MB) between the halves. Keeping x2 and the FFN
// hidden on chip is later work.
//
// Plain C interface, loaded with ctypes. Returns cudaGetLastError() (0 =
// success).

#include "conv_module.cuh"
#include "feed_forward.cuh"

namespace {

template <typename T>
int run_conv_ffn_final(const void* x, const float* cnw, const float* cnb, const void* w1,
                       const void* b1, const void* wd, const void* bd, const float* bn_w,
                       const float* bn_b, const float* bn_mean, const float* bn_var,
                       const void* w2, const void* b2, const int* lengths, const float* fnw,
                       const float* fnb, const void* f1, const void* g1, const void* f2,
                       const void* g2, const float* onw, const float* onb, float eps,
                       void* h, void* h2, void* x2, void* hf, float* part, void* out, int B,
                       int Tn, int D, int K, int F, int splits, int pw1_rows, int pw2_splits,
                       cudaStream_t stream) {
  // part serves both halves' split GEMMs
  int err = run_conv<T>(x, cnw, cnb, w1, b1, wd, bd, bn_w, bn_b, bn_mean, bn_var, w2, b2, lengths,
                        eps, part, h, h2, x2, B, Tn, D, K, pw1_rows, pw2_splits, stream);
  if (err != 0) return err;
  // the conv half is done with h: it holds the FFN's LayerNorm output
  return run_ffn<T>(x2, fnw, fnb, f1, g1, f2, g2, onw, onb, eps, h, hf, part, out, B * Tn, D, F,
                    splits, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x (B, T, D); conv: w1 (2D, D), b1 (2D,),
// wd (D, K), bd (D,), w2 (D, D), b2 (D,); ffn: f1 (F, D), g1 (F,), f2 (D, F),
// g2 (D,) — all in the activation dtype; the conv, BN, ffn and final norm
// vectors (D,) f32; lengths (B,) int32 valid rows. K odd. Scratch
// (allocated by the caller): h, h2, x2 (B, T, D), hf (B*T, F), part (f32,
// the larger of the two halves' split partials). splits (fc2's k slices,
// dividing ceil(F / 32)), pw1_rows, pw2_splits: the launch plans of K6 and
// K5.
int pk_conv_ffn_final(int dtype, const void* x, const float* cnw, const float* cnb,
                      const void* w1, const void* b1, const void* wd, const void* bd,
                      const float* bn_w, const float* bn_b, const float* bn_mean,
                      const float* bn_var, const void* w2, const void* b2, const int* lengths,
                      const float* fnw, const float* fnb, const void* f1, const void* g1,
                      const void* f2, const void* g2, const float* onw, const float* onb,
                      float eps, void* h, void* h2, void* x2, void* hf, float* part, void* out,
                      int B, int T, int D, int K, int F, int splits, int pw1_rows, int pw2_splits,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_conv_ffn_final<float>(x, cnw, cnb, w1, b1, wd, bd, bn_w, bn_b, bn_mean, bn_var, w2,
                                     b2, lengths, fnw, fnb, f1, g1, f2, g2, onw, onb, eps, h, h2,
                                     x2, hf, part, out, B, T, D, K, F, splits, pw1_rows,
                                     pw2_splits, s);
  if (dtype == 1)
    return run_conv_ffn_final<__nv_bfloat16>(x, cnw, cnb, w1, b1, wd, bd, bn_w, bn_b, bn_mean,
                                             bn_var, w2, b2, lengths, fnw, fnb, f1, g1, f2, g2,
                                             onw, onb, eps, h, h2, x2, hf, part, out, B, T, D,
                                             K, F, splits, pw1_rows, pw2_splits, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
