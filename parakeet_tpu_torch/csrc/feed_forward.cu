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
// Kernels, in order on the caller's stream (layer_norm_rows_kernel lives in
// gemm.cuh, the GEMMs and the closing pass in ffn_gemm.cuh; the launch
// sequence, run_ffn, in feed_forward.cuh, which K4 and K7 include as well):
//   layer_norm_rows_kernel   xn = round(LN(x)), once, so that both GEMMs
//                            take A by asynchronous copy
//   ffn_gemm<SILU>           fc1 + b1, SiLU in the epilogue; writes h (M, F)
//   ffn_gemm<PARTIAL>        fc2 in S k slices (blockIdx.z), f32 partials
//                            (S, M, D), S chosen by the caller's plan
//                            (ops/feed_forward.py ffn_plan) so that fc2's
//                            tiles fill the card's 132 SMs
//   ffn_reduce_kernel        sums the slices in a fixed order (no atomics,
//                            so runs repeat bit for bit), + b2, x + 0.5 y,
//                            round, and the final LayerNorm when it is fused
//
// What bounds it on the card: the two GEMMs, 4*M*D*F FLOPs (2.1 GFLOP each
// at B=8, T'=126, D=512, F=2048). In f32 they run in IEEE FMA on the CUDA
// cores (67 TFLOP/s peak). An SM's shared memory serves 32 words per clock
// against 128 FMAs, so the 4x4 outputs per thread of gemm.cuh (0.5 words
// per FMA) cap a GEMM at half the FMA rate; x, h and the weights (4-16 MB)
// stay in L2. The design: 128x128 tiles of 8x8 outputs per thread (0.25
// words per FMA), a 3-stage cp.async ring, the LayerNorm applied once so
// that A arrives by cp.async too, and split-K for fc2, whose 32 output
// tiles at T'=126 would leave 100 of 132 SMs idle (the f32 partials, 16
// MB, stay in L2). The closing pass sums them in a fixed order and carries
// the final LayerNorm. In bf16 the GEMMs run on the tensor cores (mma.sync
// m16n8k16, f32 accumulators), and the LayerNorm and the closing pass,
// which move x, weigh more.
//
// Measured (device time, B=8, 110m widths, kernel / plain version; NVIDIA
// H100 80GB HBM3, 700.00 W): f32 0.135 / 0.177 ms at T'=126 (fc1 0.065,
// fc2 in 8 k slices 0.058, closing pass 0.007, LayerNorm 0.004: the GEMMs
// at 32-36 TFLOP/s) and 0.713 / 0.921 ms at T'=751 (fc2 in 2 slices);
// bf16 0.056 / 0.228 and 0.191 / 1.143 ms. The 64x64-tile design before
// it took 0.244 and 1.174 ms in f32.
//
// Plain C interface, loaded with ctypes. Returns cudaGetLastError() (0 =
// success).

#include "feed_forward.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x (M, D), w1 (F, D), b1 (F,), w2 (D, F),
// b2 (D,) in the activation dtype; nw, nb, fw, fb (D,) f32. fw == null
// skips the final LayerNorm. Scratch (allocated by the caller): xn (M, D)
// and h (M, F) in the activation dtype, part (splits, M, D) f32. splits
// divides ceil(F / 32) (cudaErrorInvalidValue otherwise).
int pk_feed_forward(int dtype, const void* x, const float* nw, const float* nb, const void* w1,
                    const void* b1, const void* w2, const void* b2, const float* fw,
                    const float* fb, float eps, void* xn, void* h, float* part, void* out, int M,
                    int D, int F, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_ffn<float>(x, nw, nb, w1, b1, w2, b2, fw, fb, eps, xn, h, part, out, M, D, F,
                          splits, s);
  if (dtype == 1)
    return run_ffn<__nv_bfloat16>(x, nw, nb, w1, b1, w2, b2, fw, fb, eps, xn, h, part, out, M, D,
                                  F, splits, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
