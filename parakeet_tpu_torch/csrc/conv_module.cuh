// Device code and launch sequences of K5, the fused conformer conv module
// (see conv_module.cu for what it computes and what bounds it): the tiled
// depthwise + BN + SiLU kernel, and one launch sequence for each route of
// the plan (ops/conv_module.py conv_plan) on the caller's stream:
// run_conv_hopper (bf16 rows within a cluster) and run_conv (the tiled
// GEMM). The GEMMs are ffn_gemm.cuh's. Included by conv_module.cu and conv_ffn_final.cu: K4
// runs these sequences for its conv half.
#pragma once

#include "ffn_gemm.cuh"

namespace {

// ─── Depthwise conv over time + folded BN + SiLU ───────────────────────────
// Block: DW_ROWS rows of one item and DW_CH channels, 256 threads. The
// (DW_ROWS + K - 1) x DW_CH slab of h the block's taps read (zero outside
// [0, T): the conv's padding) and the K taps of its channels are loaded
// into shared memory once; thread (ty, c) then computes rows ty, ty + 4, ...
// of channel c from there, with the BN scale and bias folded once per
// thread. Rows past an item's length were zeroed by the GLU epilogue.

constexpr int DW_CH = 64, DW_ROWS = 32, DW_TY = 4;

inline int depthwise_smem_bytes(int K) { return (DW_ROWS + 2 * K - 1) * DW_CH * (int)sizeof(float); }

template <typename T>
__global__ void __launch_bounds__(DW_CH * DW_TY) depthwise_bn_silu_kernel(
    const T* __restrict__ h, const T* __restrict__ wd, const T* __restrict__ bd,
    const float* __restrict__ bn_w, const float* __restrict__ bn_b, const float* __restrict__ bn_mean,
    const float* __restrict__ bn_var, T* __restrict__ out, int Tn, int D, int K) {
  extern __shared__ float dw_smem[];
  float* slab = dw_smem;                            // (DW_ROWS + K - 1) x DW_CH
  float* taps = slab + (DW_ROWS + K - 1) * DW_CH;   // K x DW_CH
  const int b = blockIdx.z, t0 = blockIdx.y * DW_ROWS, c0 = blockIdx.x * DW_CH;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * DW_CH + tx;
  const int pad = (K - 1) / 2;
  const T* hb = h + (size_t)b * Tn * D;
  for (int i = tid; i < (DW_ROWS + K - 1) * DW_CH; i += DW_CH * DW_TY) {
    const int r = i / DW_CH, c = c0 + i - r * DW_CH, t = t0 - pad + r;
    slab[i] = (t >= 0 && t < Tn && c < D) ? ld(hb + (size_t)t * D + c) : 0.f;
  }
  for (int i = tid; i < K * DW_CH; i += DW_CH * DW_TY) {
    const int k = i / DW_CH, c = c0 + i - k * DW_CH;
    taps[i] = c < D ? ld(wd + (size_t)c * K + k) : 0.f;
  }
  __syncthreads();
  const int c = c0 + tx;
  if (c >= D) return;
  // fold_batch_norm: scale = w / sqrt(var + 1e-5), bias = b - mean * inv * w,
  // both rounded to T; __fmul_rn/__fsub_rn keep the reference's rounding
  const float inv = 1.f / sqrtf(bn_var[c] + 1e-5f);
  const float scale = round_to<T>(__fmul_rn(bn_w[c], inv));
  const float bias = round_to<T>(__fsub_rn(bn_b[c], __fmul_rn(__fmul_rn(bn_mean[c], inv), bn_w[c])));
  const float bdc = ld(bd + c);
  for (int r = ty; r < DW_ROWS && t0 + r < Tn; r += DW_TY) {
    // the taps in order k = 0 .. K-1; a padding tap adds an exact 0
    float acc = 0.f;
    for (int k = 0; k < K; ++k) acc = fmaf(slab[(r + k) * DW_CH + tx], taps[k * DW_CH + tx], acc);
    acc += bdc;
    const float y = round_to<T>(__fadd_rn(__fmul_rn(acc, scale), bias));
    st(out + ((size_t)b * Tn + t0 + r) * D + c, y * sigmoid_f32(y));
  }
}

template <typename T>
cudaError_t launch_depthwise(const void* h, const void* wd, const void* bd, const float* bn_w,
                             const float* bn_b, const float* bn_mean, const float* bn_var, void* out,
                             int B, int Tn, int D, int K, cudaStream_t stream) {
  const int smem = depthwise_smem_bytes(K);
  cudaError_t err = cudaFuncSetAttribute(depthwise_bn_silu_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((D + DW_CH - 1) / DW_CH, (Tn + DW_ROWS - 1) / DW_ROWS, B);
  depthwise_bn_silu_kernel<T><<<grid, dim3(DW_CH, DW_TY), smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(wd), static_cast<const T*>(bd), bn_w, bn_b,
      bn_mean, bn_var, static_cast<T*>(out), Tn, D, K);
  return cudaGetLastError();
}

// bf16, D <= 1024: three launches. pw1 + GLU on hopper_gemm_kernel with
// the LayerNorm on its A path (once a cluster of pw1_cols column tiles,
// into h2 until the depthwise pass writes it), rows at or past min(len, T)
// written as 0 (h); the depthwise pass (h2); pw2, k split over a thread-block cluster
// (pw2_splits, the plan's): v = round(x + y + b2) into out when out is set,
// and round(LN(v)) (on_w, on_b) into out_ln when on_w is set (the cluster
// then spans every column tile of the rows; K4's LN_ffn).
inline int run_conv_hopper(const void* x, const float* nw, const float* nb, const void* w1, const void* b1,
                           const void* wd, const void* bd, const float* bn_w, const float* bn_b, const float* bn_mean,
                           const float* bn_var, const void* w2, const void* b2, const int* lengths, float eps,
                           void* h, void* h2, void* out, const float* on_w, const float* on_b, void* out_ln, int B,
                           int Tn, int D, int K, int pw1_cols, int pw2_splits, cudaStream_t stream) {
  const int M = B * Tn;
  if (M == 0) return 0;
  HgArgs up = {};
  up.g[0].a = x;
  up.g[0].w[0] = w1;
  up.g[0].bias[0] = b1;
  up.g[0].lengths = lengths;
  up.g[0].out[0] = h;
  up.g[0].M = M; up.g[0].N = 2 * D; up.g[0].K = D; up.g[0].nseg = D;
  up.g[0].T = Tn;
  up.ln_w = nw; up.ln_b = nb; up.eps = eps;
  up.cn = pw1_cols;
  up.xn = h2;  // LN(x) until the depthwise pass writes h2
  cudaError_t err;
  if ((err = launch_hopper_gemm<HE_GLU, true>(up, stream)) != cudaSuccess) return (int)err;
  if ((err = launch_depthwise<bf16>(h, wd, bd, bn_w, bn_b, bn_mean, bn_var, h2, B, Tn, D, K, stream)) != cudaSuccess)
    return (int)err;
  return (int)launch_cluster_linear(h2, w2, b2, x, 1.f, out, on_w, on_b, eps, out_ln, M, D, D, pw2_splits, stream);
}

// f32, and bf16 rows wider than a cluster's column tiles (D > 1024): the
// tiled GEMM, five launches (the LayerNorm, pw1, the depthwise pass, pw2
// and its closing pass). The launch plan (ops/conv_module.py conv_plan): pw1_rows, pw1's block
// rows (64, 96 or 128); pw2_splits, pw2's k slices. part holds pw2_splits
// x B*T x D f32 partials. The LayerNorm's output borrows h2 until the
// depthwise pass writes it.
template <typename T>
int run_conv(const void* x, const float* nw, const float* nb, const void* w1, const void* b1,
             const void* wd, const void* bd, const float* bn_w, const float* bn_b,
             const float* bn_mean, const float* bn_var, const void* w2, const void* b2,
             const int* lengths, float eps, float* part, void* h, void* h2, void* out, int B,
             int Tn, int D, int K, int pw1_rows, int pw2_splits, cudaStream_t stream) {
  const int M = B * Tn;
  if (M == 0) return 0;
  cudaError_t err;
  if ((err = launch_layer_norm_rows<T>(x, nw, nb, h2, M, D, eps, stream)) != cudaSuccess) return (int)err;

  FfnGemmArgs up = {};
  up.a = h2;
  up.w[0] = w1;
  up.bias[0] = b1;
  up.lengths = lengths;
  up.out[0] = h;
  up.M = M; up.N = 2 * D; up.K = D; up.nseg = D;
  up.T = Tn;
  if ((err = launch_tiled_gemm_rows<T, FE_GLU>(up, pw1_rows, stream)) != cudaSuccess) return (int)err;

  if ((err = launch_depthwise<T>(h, wd, bd, bn_w, bn_b, bn_mean, bn_var, h2, B, Tn, D, K, stream)) !=
      cudaSuccess)
    return (int)err;

  return (int)launch_linear<T>(h2, w2, b2, x, out, part, M, D, D, pw2_splits, stream);
}

}  // namespace
