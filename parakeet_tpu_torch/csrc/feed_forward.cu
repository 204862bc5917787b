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
// Two routes, one per plan (ops/feed_forward.py ffn_plan), each a launch
// sequence in feed_forward.cuh that K7 and K4 run for their FFN halves too:
//
// bf16 at D <= 1024, the Hopper design, two launches on ffn_gemm.cuh's
// hopper_gemm_kernel (wgmma fed by TMA):
//   1. fc1 + b1 + SiLU with the LayerNorm on its A path: each block of a
//      cluster of column tiles takes the statistics of a k slice of the
//      rows, the cluster merges them in distributed shared memory, writes
//      the normalised rows to a scratch once and reads them by TMA; the
//      first stages' W tiles load meanwhile
//   2. fc2, k split over a thread-block cluster summed in distributed
//      shared memory: round(x + 0.5 (y + b2)), or with the final LayerNorm
//      (the cluster then spans the row's column tiles) round(LN(...))
// No LayerNorm launch, no f32 partials and no closing pass.
//
// f32, and bf16 rows wider than a cluster (D > 1024), the tiled GEMM (f32
// IEEE FMA on the CUDA cores; bf16 mma.sync), four launches:
//   layer_norm_rows_kernel   xn = round(LN(x)), once, so that both GEMMs
//                            take A by asynchronous copy (gemm.cuh)
//   ffn_gemm<SILU>           fc1 + b1, SiLU in the epilogue; writes h (M, F)
//   ffn_gemm<PARTIAL>        fc2 in S k slices (blockIdx.z), f32 partials
//                            (S, M, D), S from the plan so that fc2's tiles
//                            fill the card's 132 SMs
//   gemm_reduce_kernel       sums the slices in a fixed order (no atomics,
//                            so runs repeat bit for bit), + b2, x + 0.5 y,
//                            round, and the final LayerNorm when it is fused
//
// What bounds it on the card: the two GEMMs, 4*M*D*F FLOPs (2.1 GFLOP at
// B=8, T'=126, D=512, F=2048). In bf16 that is 0.0043 ms at the tensor
// cores' peak, so the launches, the passes through device memory and each
// block's prologue decide the time; the Hopper design removes the
// LayerNorm launch, the partials and the closing pass. In f32 the FMAs on
// the CUDA cores bound it (67 TFLOP/s peak): 128 x 128 tiles of 8 x 8
// outputs per thread (0.25 shared-memory words per FMA), a 3-stage cp.async
// ring, split-K for fc2, whose 32 output tiles at T'=126 would leave 100 of
// 132 SMs idle. A Hopper design for f32 (ffn_gemm.cuh's note) lost to it
// and was withdrawn.
//
// Measured (device time, B=8, 110m widths, kernel / plain version; NVIDIA
// H100 80GB HBM3, 700.00 W; chip_smoke.py): f32 0.135 / 0.177 ms at T'=126
// (fc1 0.066, fc2 in 8 k slices 0.058, closing pass 0.008, LayerNorm
// 0.005: the GEMMs at 32-36 TFLOP/s) and 0.708 / 0.941 ms at T'=751; bf16
// 0.0399 / 0.228 ms at T'=126 (fc1 with the LayerNorm on its A path
// 0.0274, fc2 in clusters of 2 k slices 0.0125) and 0.182 / 1.141 ms at
// T'=751, in turns with the mma.sync sequence it replaces 0.0550-0.0561
// and 0.189. The LayerNorm on fc1's A path still costs more than a
// LayerNorm launch before a plain fc1 (0.0267 against 0.0037 + 0.0139 ms
// at T'=126): each cluster takes its rows' statistics and writes and
// reads them back before its first k step.
//
// Plain C interface, loaded with ctypes. Returns cudaGetLastError() (0 =
// success).

#include "feed_forward.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x (M, D), w1 (F, D), b1 (F,), w2 (D, F),
// b2 (D,) in the activation dtype; nw, nb, fw, fb (D,) f32. fw == null
// skips the final LayerNorm. Scratch (allocated by the caller): xn (M, D)
// and h (M, F) in the activation dtype; the tiled route's part (splits, M,
// D) f32. The plan (ops/feed_forward.py ffn_plan): hopper (1: the Hopper
// design, bf16 only), fc1_cols (the Hopper design's LayerNorm cluster of
// column tiles), splits (fc2's k slices; on the tiled route they must
// divide ceil(F / 32)); a plan the launches refuse returns
// cudaErrorInvalidValue.
int pk_feed_forward(int dtype, const void* x, const float* nw, const float* nb, const void* w1,
                    const void* b1, const void* w2, const void* b2, const float* fw,
                    const float* fb, float eps, void* xn, void* h, float* part, void* out, int M,
                    int D, int F, int hopper, int fc1_cols, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hopper)
    return dtype != 1 ? (int)cudaErrorInvalidValue
                      : run_ffn_hopper(x, nw, nb, w1, b1, w2, b2, eps, x, fw != nullptr ? nullptr : out, fw, fb, out,
                                       xn, h, M, D, F, fc1_cols, splits, s);
  if (dtype == 0)
    return run_ffn<float>(x, nw, nb, w1, b1, w2, b2, fw, fb, eps, xn, h, part, out, M, D, F, splits, s);
  if (dtype == 1)
    return run_ffn<__nv_bfloat16>(x, nw, nb, w1, b1, w2, b2, fw, fb, eps, xn, h, part, out, M, D, F, splits, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
