// Launch sequence of K6, the fused macaron feed-forward (see
// feed_forward.cu for what it computes and what bounds it): run_ffn
// launches LN statistics, fc1 with SiLU, fc2 with the half-step residual
// and the optional final LayerNorm on the caller's stream. Included by
// feed_forward.cu, conv_ffn_final.cu and ffn_attention.cu.
#pragma once

#include "gemm.cuh"

namespace {

template <typename T>
int run_ffn(const void* x, const float* nw, const float* nb, const void* w1, const void* b1,
            const void* w2, const void* b2, const float* fw, const float* fb, float eps,
            float* stats, void* h, void* y, void* out, int M, int D, int F, cudaStream_t stream) {
  cudaError_t err;
  if ((err = launch_row_stats<T>(x, stats, M, D, eps, stream)) != cudaSuccess) return (int)err;

  GemmArgs up = {};
  up.a = x;
  up.w[0] = w1;
  up.bias[0] = b1;
  up.ln_stats = stats;
  up.ln_w = nw;
  up.ln_b = nb;
  up.out[0] = h;
  up.M = M; up.N = F; up.K = D; up.nseg = F;
  if ((err = launch_gemm<T, EPI_SILU>(up, stream)) != cudaSuccess) return (int)err;

  GemmArgs down = {};
  down.a = h;
  down.w[0] = w2;
  down.bias[0] = b2;
  down.residual = x;
  down.out[0] = fw != nullptr ? y : out;
  down.M = M; down.N = D; down.K = F; down.nseg = D;
  if ((err = launch_gemm<T, EPI_HALF_RES>(down, stream)) != cudaSuccess) return (int)err;

  if (fw != nullptr &&
      (err = launch_layer_norm_rows<T>(y, fw, fb, out, M, D, eps, stream)) != cudaSuccess)
    return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace
