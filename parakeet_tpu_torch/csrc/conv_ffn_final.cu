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
// Both bodies return T in the reference (pallas_utils.py); those are the
// rounding points kept here. Only the conv half masks rows by length.
//
// What bounds it on the card: the four GEMMs (pw1, pw2, fc1, fc2: 2*M*D*
// (3D + 2F) FLOPs, 5.8 GFLOP at B=8, T'=126, D=512, F=2048). In bf16 they
// take microseconds on the tensor cores, so the launches between them and
// the passes of intermediates through device memory decide the time, and
// the plan (ops/conv_ffn_final.py k4_plan) runs the Hopper design: five
// launches, every GEMM on ffn_gemm.cuh's hopper_gemm_kernel (wgmma fed by
// TMA), no LayerNorm launch, no f32 partials and no closing pass:
//
//   1. pw1 + GLU on LN_conv(x): the LayerNorm on the GEMM's A path (each
//      cluster of column tiles normalises the rows once, into h2); rows at
//      or past min(len, T) (taken in the kernel) written as 0
//   2. K5's depthwise + folded BN + SiLU pass (conv_module.cuh)
//   3. pw2, k split over a thread-block cluster that also spans the row's
//      column tiles: x2 = round(x + y + b2) and, from the row statistics
//      exchanged in the cluster, xn = round(LN_ffn(x2))
//   4. fc1 + SiLU on xn
//   5. fc2 over a cluster the same way: out = round(LN_final(round(x2 +
//      0.5 (y + g2))))
//
// The depthwise pass stays a launch of its own: folded into pw2's A path it
// would be computed again by every column tile of a row (four at D = 512)
// inside the GEMM's critical path, against one launch boundary saved.
//
// In f32 the GEMMs are IEEE FMA on the CUDA cores, where the tiled GEMM's
// 128-row tiles and its split-K closing pass beat a whole-row cluster, and
// in bf16 a row wider than a cluster's 8 column tiles (D > 1024) cannot be
// LayerNorm'd in one: there the plan runs K5's launch sequence
// (conv_module.cuh run_conv) and then K6's with the final LayerNorm
// (feed_forward.cuh run_ffn) on the caller's stream, nine launches; the
// FFN's LayerNorm output reuses the conv half's h.
//
// Plain C interface, loaded with ctypes. Returns cudaGetLastError() (0 =
// success).

#include "conv_module.cuh"
#include "feed_forward.cuh"

namespace {

// The Hopper design, bf16: K5's Hopper sequence writing x2 and, from the
// cluster that closes pw2, LN_ffn(x2) into h, then K6's on those rows (fc1
// takes them as they are) with the final LayerNorm. pw1_cols: the column
// tiles that share pw1's LayerNorm; fc2_splits, pw2_splits: the k slices of
// fc2 and pw2.
int run_hopper(const void* x, const float* cnw, const float* cnb, const void* w1, const void* b1, const void* wd,
               const void* bd, const float* bn_w, const float* bn_b, const float* bn_mean, const float* bn_var,
               const void* w2, const void* b2, const int* lengths, const float* fnw, const float* fnb,
               const void* f1, const void* g1, const void* f2, const void* g2, const float* onw, const float* onb,
               float eps, void* h, void* h2, void* x2, void* hf, void* out, int B, int Tn, int D, int K, int F,
               int pw1_cols, int fc2_splits, int pw2_splits, cudaStream_t stream) {
  // the depthwise pass is done with h when pw2 writes LN_ffn(x2) there
  int rc = run_conv_hopper(x, cnw, cnb, w1, b1, wd, bd, bn_w, bn_b, bn_mean, bn_var, w2, b2, lengths, eps, h, h2, x2,
                           fnw, fnb, h, B, Tn, D, K, pw1_cols, pw2_splits, stream);
  if (rc != 0) return rc;
  return run_ffn_hopper(h, nullptr, nullptr, f1, g1, f2, g2, eps, x2, nullptr, onw, onb, out, nullptr, hf, B * Tn, D,
                        F, 0, fc2_splits, stream);
}

// K5's launch sequence, then K6's with the final LayerNorm: splits (fc2's
// k slices), pw1_rows, pw2_splits, their plans'. part serves both halves'
// split GEMMs.
template <typename T>
int run_tiled(const void* x, const float* cnw, const float* cnb, const void* w1, const void* b1, const void* wd,
              const void* bd, const float* bn_w, const float* bn_b, const float* bn_mean, const float* bn_var,
              const void* w2, const void* b2, const int* lengths, const float* fnw, const float* fnb,
              const void* f1, const void* g1, const void* f2, const void* g2, const float* onw, const float* onb,
              float eps, void* h, void* h2, void* x2, void* hf, float* part, void* out, int B, int Tn, int D, int K,
              int F, int splits, int pw1_rows, int pw2_splits, cudaStream_t stream) {
  int err = run_conv<T>(x, cnw, cnb, w1, b1, wd, bd, bn_w, bn_b, bn_mean, bn_var, w2, b2, lengths, eps, part, h, h2,
                        x2, B, Tn, D, K, pw1_rows, pw2_splits, stream);
  if (err != 0) return err;
  // the conv half is done with h: it holds the FFN's LayerNorm output
  return run_ffn<T>(x2, fnw, fnb, f1, g1, f2, g2, onw, onb, eps, h, hf, part, out, B * Tn, D, F, splits, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x (B, T, D); conv: w1 (2D, D), b1 (2D,),
// wd (D, K), bd (D,), w2 (D, D), b2 (D,); ffn: f1 (F, D), g1 (F,), f2 (D, F),
// g2 (D,) — all in the activation dtype; the conv, BN, ffn and final norm
// vectors (D,) f32; lengths (B,) int32 valid rows (min(len, T) is taken in
// the kernels). K odd. Scratch (allocated by the caller): h, h2, x2 (B, T,
// D), hf (B*T, F), part (f32, the tiled sequences' split partials; null for
// the Hopper design). The plan (ops/conv_ffn_final.py k4_plan): hopper (1:
// the Hopper design, bf16 only), splits (fc2's k slices), pw2_splits (pw2's),
// and for the Hopper design pw1_cols (pw1's LayerNorm cluster), for the
// tiled sequences pw1_rows (K5's plan).
int pk_conv_ffn_final(int dtype, const void* x, const float* cnw, const float* cnb,
                      const void* w1, const void* b1, const void* wd, const void* bd,
                      const float* bn_w, const float* bn_b, const float* bn_mean,
                      const float* bn_var, const void* w2, const void* b2, const int* lengths,
                      const float* fnw, const float* fnb, const void* f1, const void* g1,
                      const void* f2, const void* g2, const float* onw, const float* onb,
                      float eps, void* h, void* h2, void* x2, void* hf, float* part, void* out,
                      int B, int T, int D, int K, int F, int hopper, int splits, int pw1_rows,
                      int pw2_splits, int pw1_cols, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hopper)
    return dtype != 1 ? (int)cudaErrorInvalidValue
                      : run_hopper(x, cnw, cnb, w1, b1, wd, bd, bn_w, bn_b, bn_mean, bn_var, w2, b2, lengths, fnw,
                                   fnb, f1, g1, f2, g2, onw, onb, eps, h, h2, x2, hf, out, B, T, D, K, F, pw1_cols,
                                   splits, pw2_splits, s);
  if (dtype == 0)
    return run_tiled<float>(x, cnw, cnb, w1, b1, wd, bd, bn_w, bn_b, bn_mean, bn_var, w2, b2, lengths, fnw, fnb, f1,
                            g1, f2, g2, onw, onb, eps, h, h2, x2, hf, part, out, B, T, D, K, F, splits, pw1_rows,
                            pw2_splits, s);
  if (dtype == 1)
    return run_tiled<__nv_bfloat16>(x, cnw, cnb, w1, b1, wd, bd, bn_w, bn_b, bn_mean, bn_var, w2, b2, lengths, fnw,
                                    fnb, f1, g1, f2, g2, onw, onb, eps, h, h2, x2, hf, part, out, B, T, D, K, F,
                                    splits, pw1_rows, pw2_splits, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
