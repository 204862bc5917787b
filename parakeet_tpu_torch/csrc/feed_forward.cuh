// Launch sequence of K6, the fused macaron feed-forward (see
// feed_forward.cu for what it computes and what bounds it): run_ffn
// launches the LayerNorm, fc1 with SiLU, fc2 in k slices and the pass that
// sums the slices into the half-step residual and the optional final
// LayerNorm, on the caller's stream. Included by feed_forward.cu,
// conv_ffn_final.cu and ffn_attention.cu.
#pragma once

#include "ffn_gemm.cuh"

namespace {

// Scratch (allocated by the caller): xn (M, D) and h (M, F) in T, part
// (splits, M, D) f32. splits must divide fc2's k steps, ceil(F / 32).
template <typename T>
int run_ffn(const void* x, const float* nw, const float* nb, const void* w1, const void* b1,
            const void* w2, const void* b2, const float* fw, const float* fb, float eps, void* xn,
            void* h, float* part, void* out, int M, int D, int F, int splits,
            cudaStream_t stream) {
  if (M == 0) return 0;
  cudaError_t err;
  if ((err = launch_layer_norm_rows<T>(x, nw, nb, xn, M, D, eps, stream)) != cudaSuccess)
    return (int)err;

  FfnGemmArgs up = {};
  up.a = xn;
  up.w[0] = w1;
  up.bias[0] = b1;
  up.out[0] = h;
  up.M = M; up.N = F; up.K = D;
  if ((err = launch_tiled_gemm<T, FE_SILU, 128>(up, 1, stream)) != cudaSuccess) return (int)err;

  FfnGemmArgs down = {};
  down.a = h;
  down.w[0] = w2;
  down.out[0] = part;
  down.M = M; down.N = D; down.K = F;
  if ((err = launch_tiled_gemm<T, FE_PARTIAL, 128>(down, splits, stream)) != cudaSuccess) return (int)err;

  return (int)launch_gemm_reduce<T>(part, splits, x, 0.5f, b2, fw, fb, eps, out, M, D, stream);
}

}  // namespace
