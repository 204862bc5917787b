// Launch sequences of K6, the fused macaron feed-forward (see
// feed_forward.cu for what it computes and what bounds it), one for each
// route of the plan (ops/feed_forward.py ffn_plan), on the caller's stream:
// run_ffn_hopper (bf16 rows within a cluster) and run_ffn (the tiled GEMM).
// Included by feed_forward.cu, conv_ffn_final.cu and ffn_attention.cu: K7
// and K4 run these sequences for their FFN halves.
#pragma once

#include "ffn_gemm.cuh"

namespace {

// bf16, D <= 1024: two launches on hopper_gemm_kernel. fc1 + SiLU into h,
// with the LayerNorm (nw, nb) on its A path, once a cluster of fc1_cols
// column tiles into xn ((M, D) scratch; nw null: a is already LayerNormed,
// as K4's pw2 leaves it); fc2, k split over a thread-block cluster (splits,
// the plan's): v = round(res + 0.5 (y + b2)) into out when out is set, and
// round(LN(v)) (on_w, on_b) into out_ln when on_w is set (the cluster then
// spans every column tile of the rows).
inline int run_ffn_hopper(const void* a, const float* nw, const float* nb, const void* w1, const void* b1,
                          const void* w2, const void* b2, float eps, const void* res, void* out, const float* on_w,
                          const float* on_b, void* out_ln, void* xn, void* h, int M, int D, int F, int fc1_cols,
                          int splits, cudaStream_t stream) {
  if (M == 0) return 0;
  HgArgs up = {};
  up.g[0].a = a;
  up.g[0].w[0] = w1;
  up.g[0].bias[0] = b1;
  up.g[0].out[0] = h;
  up.g[0].M = M; up.g[0].N = F; up.g[0].K = D;
  up.ln_w = nw; up.ln_b = nb; up.eps = eps;
  up.cn = fc1_cols;
  up.xn = xn;
  cudaError_t err = launch_hopper_gemm_ln<HE_SILU>(up, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_cluster_linear(h, w2, b2, res, 0.5f, out, on_w, on_b, eps, out_ln, M, D, F, splits, stream);
}

// f32, and bf16 rows wider than a cluster's column tiles (D > 1024): the
// tiled GEMM (f32 IEEE FMA on the CUDA cores; bf16 mma.sync), four launches:
// the LayerNorm, fc1 + SiLU, fc2 in k slices of f32 partials, and the
// closing pass (+ b2, x + 0.5 y, the optional final LayerNorm). Scratch (allocated by the caller): xn (M, D) and h (M, F) in T, part
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
