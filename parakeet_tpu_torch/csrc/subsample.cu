// Fused front of the conv subsampling for Hopper (sm_90a): conv1 -> act ->
// depthwise dw1 -> pointwise conv2 -> act.
//
// Replaces the TPU kernel parakeet_tpu/ops/pallas_subsample.py::
// fused_subsample_block1 (_subsample_kernel): on mel x (B, T, F)
//
//   y1[t2, f2, c] = act(b1[c] + sum_{3x3} w1[c] x[2 t2 + i - 1, 2 f2 + j - 1])
//                   f32, not rounded; exactly 0 outside [0, T2) x [0, F2)
//   y2[t4, f4, c] = round(bd[c] + sum_{3x3} wd[c] y1[2 t4 + i - 1, 2 f4 + j - 1])
//   out[c, t4, f4] = round(act(b2[c] + sum_c' w2[c, c'] y2[t4, f4, c']))
//
// with x outside [0, T) x [0, F) zero, T2 = (T-1)/2 + 1, T4 = (T2-1)/2 + 1
// (and the same for F), w1, b1, w2, b2 in the activation dtype T and wd, bd
// as given (f32 here). The output is NCHW (B, C, T4, F4), the layout the
// port's dw2 takes.
//
// Two kernels on the caller's stream:
//   conv1_dw1_kernel        one block per (t4, b, channel tile): the 7 mel
//                           rows the block's conv1 taps reach go to shared
//                           memory; each thread owns one channel and walks
//                           f4, loading the 7x7 mel window into registers
//                           and computing the 9 conv1 values dw1 needs
//                           (81 FMAs, 9 activations) before dw1's 9 FMAs.
//                           The conv1 output (B, T2, F2, C), the largest
//                           tensor of the encoder, never reaches device
//                           memory; y2 is written (B*T4*F4, C).
//   gemm_nt_kernel<ACT_NCHW> conv2 as a GEMM over C with bias + act in the
//                           epilogue, stored channel-major (gemm.cuh)
//
// What bounds it on the card: the direct kernel recomputes each conv1 value
// for each dw1 output that reads it (about 2.25 times on average) and issues
// one shared-memory or register read per FMA; at B=8, T=1001, F=80, C=256 it
// is ~1 GFLOP of f32 FMA against the 164 MB conv1 tensor (written and read
// once) that the plain layers move through device memory. conv2 is a
// (B*T4*F4, C) x (C, C) GEMM on the CUDA cores: 2*B*T4*F4*C^2 = 5.26 GFLOP
// at that shape (B=8, T4=251, F4=20, C=256), most of the call's 6.2 GFLOP
// (0.092 ms at the 67 TFLOP/s f32 peak).
// On an H100 80GB HBM3 at 700 W a call took 0.37 ms of device time at that
// shape and 2.05 ms at T=6001, against 0.69-0.73 and 4.01 ms for the plain
// version.
// The TPU kernel's blocked im2col and parity row order are layout tricks
// for the TPU's tiles and are not carried over: the direct form takes any T
// and any F, odd F2 included.
//
// Plain C interface, loaded with ctypes. Returns cudaGetLastError() (0 =
// success).

#include "gemm.cuh"

namespace {

constexpr int SUB_THREADS = 128;

__device__ __forceinline__ float act_f32(float v, int act) {
  return act == ACT_RELU ? fmaxf(v, 0.f) : v * sigmoid_f32(v);
}

template <typename T>
__global__ void __launch_bounds__(SUB_THREADS) conv1_dw1_kernel(
    const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ b1,
    const float* __restrict__ wd, const float* __restrict__ bd, T* __restrict__ y2, int Tn,
    int F, int T2, int F2, int T4, int F4, int C, int act) {
  extern __shared__ float xs[];  // 7 rows x (F + 2) cols; col j holds mel column j - 1
  const int t4 = blockIdx.x, b = blockIdx.y;
  const int c = blockIdx.z * SUB_THREADS + threadIdx.x;
  const int W = F + 2;
  const int row0 = 4 * t4 - 3;  // first mel row the conv1 taps of this t4 reach
  for (int i = threadIdx.x; i < 7 * W; i += SUB_THREADS) {
    const int r = i / W, j = i - r * W;
    const int t = row0 + r, f = j - 1;
    xs[i] = (t >= 0 && t < Tn && f >= 0 && f < F) ? ld(x + ((size_t)b * Tn + t) * F + f) : 0.f;
  }
  __syncthreads();
  if (c >= C) return;

  float w1r[9], wdr[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    w1r[k] = ld(w1 + (size_t)c * 9 + k);
    wdr[k] = wd[(size_t)c * 9 + k];
  }
  const float b1c = ld(b1 + c), bdc = bd[c];

  for (int f4 = 0; f4 < F4; ++f4) {
    // mel window: rows row0..row0+6, columns 4 f4 - 3 .. 4 f4 + 3 (xs col +1)
    float win[7][7];
#pragma unroll
    for (int r = 0; r < 7; ++r)
#pragma unroll
      for (int q = 0; q < 7; ++q) {
        const int j = 4 * f4 - 2 + q;
        win[r][q] = (j >= 0 && j < W) ? xs[r * W + j] : 0.f;
      }
    float acc = bdc;
#pragma unroll
    for (int dt = 0; dt < 3; ++dt) {
      const int t2 = 2 * t4 - 1 + dt;
#pragma unroll
      for (int df = 0; df < 3; ++df) {
        const int f2 = 2 * f4 - 1 + df;
        float y = 0.f;
        if (t2 >= 0 && t2 < T2 && f2 >= 0 && f2 < F2) {
          // conv1 at (t2, f2) reads mel rows 2 t2 - 1 .. 2 t2 + 1 = window
          // rows 2 dt .. 2 dt + 2, columns 2 f2 - 1 .. = window cols 2 df ..
          float s = 0.f;
#pragma unroll
          for (int et = 0; et < 3; ++et)
#pragma unroll
            for (int ef = 0; ef < 3; ++ef) s = fmaf(win[2 * dt + et][2 * df + ef], w1r[et * 3 + ef], s);
          y = act_f32(s + b1c, act);
        }
        acc = fmaf(y, wdr[dt * 3 + df], acc);
      }
    }
    st(y2 + (((size_t)b * T4 + t4) * F4 + f4) * C + c, acc);
  }
}

template <typename T>
int run_subsample(const void* x, const void* w1, const void* b1, const float* wd, const float* bd,
                  const void* w2, const void* b2, int act, void* y2, void* out, int B, int Tn,
                  int F, int C, cudaStream_t stream) {
  const int T2 = (Tn - 1) / 2 + 1, T4 = (T2 - 1) / 2 + 1;
  const int F2 = (F - 1) / 2 + 1, F4 = (F2 - 1) / 2 + 1;
  const int smem = 7 * (F + 2) * (int)sizeof(float);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(conv1_dw1_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(T4, B, (C + SUB_THREADS - 1) / SUB_THREADS);
  conv1_dw1_kernel<T><<<grid, SUB_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(b1), wd, bd,
      static_cast<T*>(y2), Tn, F, T2, F2, T4, F4, C, act);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  GemmArgs g = {};
  g.a = y2;
  g.w[0] = w2;
  g.bias[0] = b2;
  g.out[0] = out;
  g.M = B * T4 * F4; g.N = C; g.K = C; g.nseg = C;
  g.T = T4 * F4;
  g.act = act;
  if ((err = launch_gemm<T, EPI_ACT_NCHW>(g, stream)) != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x (B, T, F); w1 (C, 9), b1 (C,),
// w2 (C, C), b2 (C,) in the activation dtype; wd (C, 9), bd (C,) f32.
// act: 0 = ReLU, 1 = SiLU. Scratch (allocated by the caller): y2
// (B*T4*F4, C). out (B, C, T4, F4).
int pk_subsample_block1(int dtype, const void* x, const void* w1, const void* b1, const float* wd,
                        const float* bd, const void* w2, const void* b2, int act, void* y2,
                        void* out, int B, int T, int F, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (act != ACT_RELU && act != ACT_SILU) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return run_subsample<float>(x, w1, b1, wd, bd, w2, b2, act, y2, out, B, T, F, C, s);
  if (dtype == 1)
    return run_subsample<__nv_bfloat16>(x, w1, b1, wd, bd, w2, b2, act, y2, out, B, T, F, C, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
