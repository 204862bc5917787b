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
//   conv1_dw1_kernel   one block per 4 rows of t4, item and 32 channels
//                      (a warp's lanes): the 19 mel rows its conv1 taps
//                      reach go to shared memory, then the 9 x (F2 + 2) x
//                      32 conv1 values its dw1 taps read are computed once
//                      each into a shared slab, 8 columns per warp step
//                      from 16-byte broadcast reads of the mel rows, and
//                      dw1 computes 4 outputs per warp step from 9 slab
//                      columns. The conv1 output (B, T2, F2, C), the
//                      largest tensor of the encoder, never reaches device
//                      memory; y2 is written (B*T4*F4, C).
//   conv2              ffn_gemm.cuh's tiled GEMM (B*T4*F4, C) x (C, C)^T
//                      with the FE_ACT_NCHW epilogue: + b2, act, one
//                      rounding, stored channel-major through a
//                      shared-memory tile; block rows from the plan
//                      (ops/subsample.py subsample_plan), no k split
//
// What bounds it on the card: operations. At B=8, T=1001, F=80, C=256
// conv2 is 2*B*T4*F4*C^2 = 5.26 GFLOP of the call's 6.19 (conv1 0.74, dw1
// 0.19): 0.092 ms at the 67 TFLOP/s f32 peak, against 0.025 ms for the
// 41 MB of y2 written and read and 41 MB of output. conv2 therefore runs
// on the GEMM that reaches 32-36 TFLOP/s in K6 (bf16: mma.sync on the
// tensor cores), and its channel-major stores go out in runs of 32
// positions. conv1_dw1 computed each conv1 value once for every dw1
// output that read it (about 2.25 times, from a 7 x 7 window in
// registers) and took 0.103 of 0.281 ms at T=1001 in f32 and 0.104 of
// 0.168 in bf16 once conv2 had moved; the slab computes each value 9/8
// times (a block's first conv1 row is its neighbour's last). Its shared
// reads and instructions set its time: a slab read one value per FMA
// (0.148 ms, slower than the window), so each warp step shares its reads
// across 8 conv1 columns (0.21 reads per FMA) or 4 dw1 outputs (0.75).
// Before this
// design conv2 ran on a 64x64 SIMT GEMM at 17-21 TFLOP/s: the whole call
// took 0.3687 ms at T=1001 and 2.0779 at T=6001 (NVIDIA H100 80GB HBM3,
// 700 W).
// The TPU kernel's blocked im2col and parity row order are layout tricks
// for the TPU's tiles and are not carried over: the direct form takes any T
// and any F, odd F2 included.
//
// Plain C interface, loaded with ctypes. Returns cudaGetLastError() (0 =
// success).

#include "ffn_gemm.cuh"

namespace {

// conv1_dw1_kernel's block: SUB_R4 rows of t4 of one item and SUB_CT = 32
// channels (a warp's lanes), SUB_THREADS threads; each warp step computes
// SUB_G1 neighbouring conv1 columns or SUB_G dw1 outputs
constexpr int SUB_THREADS = 256, SUB_CT = 32, SUB_R4 = 4, SUB_G1 = 8, SUB_G = 4;

__device__ __forceinline__ float act_f32(float v, int act) {
  return act == ACT_RELU ? fmaxf(v, 0.f) : v * sigmoid_f32(v);
}

// Row stride of the mel rows in shared memory: the 2 SUB_G1 groups + 1
// columns that conv1's column groups read, in 16-byte rows
__host__ __device__ inline int sub_xs_ld(int F2) { return 2 * SUB_G1 * ((F2 + SUB_G1 - 1) / SUB_G1) + 4; }

// the 4 R4 + 3 mel rows its conv1 taps reach and the conv1 slab of
// 2 R4 + 1 rows x (F2 + 2) columns x SUB_CT channels
inline int conv1_dw1_smem_bytes(int F2) {
  return ((4 * SUB_R4 + 3) * sub_xs_ld(F2) + (2 * SUB_R4 + 1) * (F2 + 2) * SUB_CT) * (int)sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(SUB_THREADS) conv1_dw1_kernel(
    const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ b1,
    const float* __restrict__ wd, const float* __restrict__ bd, T* __restrict__ y2, int Tn,
    int F, int T2, int F2, int T4, int F4, int C, int act) {
  constexpr int WARPS = SUB_THREADS / 32;
  static_assert(SUB_CT == 32 && SUB_G == 4 && SUB_G1 % 2 == 0, "a warp's lanes are the channels");
  extern __shared__ __align__(16) float sub_smem[];
  const int W = sub_xs_ld(F2), W2 = F2 + 2;
  const int G1 = (F2 + SUB_G1 - 1) / SUB_G1, G4 = (F4 + SUB_G - 1) / SUB_G;
  float* xs = sub_smem;                   // mel rows; column j holds mel column j - 1
  float* ys = xs + (4 * SUB_R4 + 3) * W;  // conv1 slab (row, column q = f2 + 1, channel)
  const int t40 = blockIdx.x * SUB_R4, b = blockIdx.y;
  const int cl = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.z * SUB_CT + cl;
  const int row0 = 4 * t40 - 3;  // first mel row the block's conv1 taps reach
  const int t20 = 2 * t40 - 1;   // first conv1 row its dw1 taps reach
  for (int i = threadIdx.x; i < (4 * SUB_R4 + 3) * W; i += SUB_THREADS) {
    const int r = i / W, j = i - r * W;
    const int t = row0 + r, f = j - 1;
    xs[i] = (t >= 0 && t < Tn && f >= 0 && f < F) ? ld(x + ((size_t)b * Tn + t) * F + f) : 0.f;
  }
  // dw1's padding: conv1 columns f2 = -1 and F2 are exact zeros
  for (int i = threadIdx.x; i < (2 * SUB_R4 + 1) * 2 * SUB_CT; i += SUB_THREADS) {
    const int rr = i / (2 * SUB_CT), side = (i / SUB_CT) & 1;
    ys[(rr * W2 + side * (W2 - 1)) * SUB_CT + (i & 31)] = 0.f;
  }
  float w1r[9], wdr[9], b1c = 0.f, bdc = 0.f;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    w1r[k] = c < C ? ld(w1 + (size_t)c * 9 + k) : 0.f;
    wdr[k] = c < C ? wd[(size_t)c * 9 + k] : 0.f;
  }
  if (c < C) {
    b1c = ld(b1 + c);
    bdc = bd[c];
  }
  __syncthreads();

  // conv1 + act, each value once, SUB_G1 columns f2 = 8g .. 8g + 7 of one
  // row per step: the 17 mel columns they read come as four 16-byte
  // broadcast reads and one 4-byte read per mel row
  for (int u = warp; u < (2 * SUB_R4 + 1) * G1; u += WARPS) {
    const int rr = u / G1, g = u - rr * G1, t2 = t20 + rr;
    const bool row_ok = t2 >= 0 && t2 < T2;  // outside: exact zeros
    float acc[SUB_G1];
#pragma unroll
    for (int k = 0; k < SUB_G1; ++k) acc[k] = 0.f;
    if (row_ok) {
#pragma unroll
      for (int et = 0; et < 3; ++et) {
        // mel row 2 t2 - 1 + et (xs row 2 rr + et), columns 16 g - 1 .. 16 g + 15
        const float* xr = xs + (2 * rr + et) * W + 2 * SUB_G1 * g;
        float v[2 * SUB_G1 + 1];
#pragma unroll
        for (int q = 0; q < SUB_G1 / 2; ++q) {
          const float4 c4 = *reinterpret_cast<const float4*>(xr + 4 * q);
          v[4 * q] = c4.x; v[4 * q + 1] = c4.y; v[4 * q + 2] = c4.z; v[4 * q + 3] = c4.w;
        }
        v[2 * SUB_G1] = xr[2 * SUB_G1];
#pragma unroll
        for (int k = 0; k < SUB_G1; ++k)
#pragma unroll
          for (int ef = 0; ef < 3; ++ef) acc[k] = fmaf(v[2 * k + ef], w1r[et * 3 + ef], acc[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < SUB_G1; ++k) {
      const int f2 = SUB_G1 * g + k;
      if (f2 < F2) ys[(rr * W2 + f2 + 1) * SUB_CT + cl] = row_ok ? act_f32(acc[k] + b1c, act) : 0.f;
    }
  }
  __syncthreads();
  if (c >= C) return;

  // dw1 from the slab, SUB_G outputs f4 = 4g .. 4g + 3 of one row per
  // step: conv1 rows 2 t4 - 1 .. (slab rows 2 r4 ..), columns f2 = 8 g - 1
  // .. 8 g + 7 (slab columns 8 g ..)
  for (int u = warp; u < SUB_R4 * G4; u += WARPS) {
    const int r4 = u / G4, g = u - r4 * G4, t4 = t40 + r4;
    if (t4 >= T4) break;
    float acc[SUB_G] = {bdc, bdc, bdc, bdc};
#pragma unroll
    for (int dt = 0; dt < 3; ++dt) {
      const float* yr = ys + ((2 * r4 + dt) * W2 + 8 * g) * SUB_CT + cl;
      float v[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) v[i] = 8 * g + i < W2 ? yr[i * SUB_CT] : 0.f;  // past W2: unstored outputs
#pragma unroll
      for (int k = 0; k < SUB_G; ++k)
#pragma unroll
        for (int df = 0; df < 3; ++df) acc[k] = fmaf(v[2 * k + df], wdr[dt * 3 + df], acc[k]);
    }
#pragma unroll
    for (int k = 0; k < SUB_G; ++k) {
      const int f4 = SUB_G * g + k;
      if (f4 < F4) st(y2 + (((size_t)b * T4 + t4) * F4 + f4) * C + c, acc[k]);
    }
  }
}

template <typename T>
int run_subsample(const void* x, const void* w1, const void* b1, const float* wd, const float* bd,
                  const void* w2, const void* b2, int act, void* y2, void* out, int B, int Tn,
                  int F, int C, int conv2_rows, cudaStream_t stream) {
  const int T2 = (Tn - 1) / 2 + 1, T4 = (T2 - 1) / 2 + 1;
  const int F2 = (F - 1) / 2 + 1, F4 = (F2 - 1) / 2 + 1;
  const int smem = conv1_dw1_smem_bytes(F2);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(conv1_dw1_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((T4 + SUB_R4 - 1) / SUB_R4, B, (C + SUB_CT - 1) / SUB_CT);
  conv1_dw1_kernel<T><<<grid, SUB_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(b1), wd, bd,
      static_cast<T*>(y2), Tn, F, T2, F2, T4, F4, C, act);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  FfnGemmArgs g = {};
  g.a = y2;
  g.w[0] = w2;
  g.bias[0] = b2;
  g.out[0] = out;
  g.M = B * T4 * F4; g.N = C; g.K = C;
  g.T = T4 * F4;
  g.act = act;
  return (int)launch_tiled_gemm_rows<T, FE_ACT_NCHW>(g, conv2_rows, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x (B, T, F); w1 (C, 9), b1 (C,),
// w2 (C, C), b2 (C,) in the activation dtype; wd (C, 9), bd (C,) f32.
// act: 0 = ReLU, 1 = SiLU. Scratch (allocated by the caller): y2
// (B*T4*F4, C). out (B, C, T4, F4). conv2_rows: conv2's block rows (64,
// 96 or 128) from the launch plan.
int pk_subsample_block1(int dtype, const void* x, const void* w1, const void* b1, const float* wd,
                        const float* bd, const void* w2, const void* b2, int act, void* y2,
                        void* out, int B, int T, int F, int C, int conv2_rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (act != ACT_RELU && act != ACT_SILU) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return run_subsample<float>(x, w1, b1, wd, bd, w2, b2, act, y2, out, B, T, F, C, conv2_rows, s);
  if (dtype == 1)
    return run_subsample<__nv_bfloat16>(x, w1, b1, wd, bd, w2, b2, act, y2, out, B, T, F, C, conv2_rows, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
