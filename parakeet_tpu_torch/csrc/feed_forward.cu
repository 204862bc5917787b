// Fused macaron feed-forward for Hopper (sm_90a).
//
// Replaces the TPU kernel parakeet_tpu/ops/pallas_ffn.py::fused_feed_forward
// (_ffn_kernel, body pallas_utils.py::ffn_body): per conformer FFN
//
//   h   = LN(x)                      f32 statistics, rounded to T
//   h   = round(SiLU(round(h W1^T + b1)))    f32 accumulation, f32 sigmoid
//   out = round(x + 0.5 * (h W2^T + b2))     residual and half step in f32
//   out = round(LN(out))             optional: the block's final LayerNorm
//
// Kernels, in order on the caller's stream (row_stats_kernel, gemm_nt_kernel
// and layer_norm_rows_kernel live in gemm.cuh; the launch sequence, run_ffn,
// in feed_forward.cuh, which K4 and K7 include as well):
//   row_stats_kernel        LN mean and 1/std per row of x
//   gemm_nt_kernel<SILU>    fc1 with the LN applied to A as it is loaded
//                           (the normed x never reaches device memory) and
//                           bias + SiLU in the epilogue; writes h (M, F)
//   gemm_nt_kernel<HALF_RES> fc2 with bias, x + 0.5 y in the epilogue
//   layer_norm_rows_kernel  the final LayerNorm (only when it is fused)
//
// What bounds it on the card: the two GEMMs, 4*M*D*F FLOPs (2.1 GFLOP each
// at B=8, T'=126, D=512, F=2048), run on the CUDA cores in IEEE f32 FMA, so
// the f32 SIMT rate bounds them, not memory: x, h and the weights are 4-16
// MB and are read once per tile row or column from L2. On an H100 80GB HBM3
// at 700 W a call took 0.24 ms of device time at B=8, T'=126 and 1.17 ms at
// T'=751, against 0.18 and 0.92 ms for the plain version, whose cuBLAS GEMMs
// run at a higher f32 rate (gemm.cuh). The design removes
// the separate LN, bias, SiLU, half-step and residual passes of the plain
// layers (each a round trip of a (M, D) or (M, F) tensor) by folding them
// into the GEMMs' prologue and epilogues. h (M, F) still goes through
// device memory; keeping it on chip, and wgmma tiles for bf16, are later
// work.
//
// Plain C interface, loaded with ctypes. Returns cudaGetLastError() (0 =
// success).

#include "feed_forward.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x (M, D), w1 (F, D), b1 (F,), w2 (D, F),
// b2 (D,) in the activation dtype; nw, nb, fw, fb (D,) f32. fw == null
// skips the final LayerNorm. Scratch (allocated by the caller): stats
// (M, 2) f32, h (M, F), y (M, D) (used only with the final LayerNorm).
int pk_feed_forward(int dtype, const void* x, const float* nw, const float* nb, const void* w1,
                    const void* b1, const void* w2, const void* b2, const float* fw,
                    const float* fb, float eps, float* stats, void* h, void* y, void* out, int M,
                    int D, int F, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_ffn<float>(x, nw, nb, w1, b1, w2, b2, fw, fb, eps, stats, h, y, out, M, D, F, s);
  if (dtype == 1)
    return run_ffn<__nv_bfloat16>(x, nw, nb, w1, b1, w2, b2, fw, fb, eps, stats, h, y, out, M,
                                  D, F, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
