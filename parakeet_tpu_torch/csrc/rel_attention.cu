// Fused relative-position attention block for Hopper (sm_90a).
//
// Replaces the TPU kernel parakeet_tpu/ops/pallas_attention.py::
// fused_rel_attention_block (_attn_block_kernel / _attention_core): per
// conformer layer
//
//   x' = LN(x)                          (optional, f32 statistics)
//   q, k, v = x' Wq^T + bq, x' Wk^T + bk, x' Wv^T + bv
//   qu = q/sqrt(hd) + u/sqrt(hd),  qv = q/sqrt(hd) + v/sqrt(hd)
//   P  = pe Wpos^T                      (2T-1, D), row r = relative position T-1-r
//   score[t,s] = qu[t].k[s] + qv[t].P[T-1-t+s]     (-1e9 where s >= len)
//   ctx = softmax(score) v              (f32 softmax, normalised after AV)
//   y = ctx Wo^T + bo (+ x when LN is fused)
//
// Three hand-written kernels, five launches in order on the caller's stream
// (the first two live in gemm.cuh, shared with the other kernels; the
// core and the launch sequence, run_block, in rel_attention.cuh, which K7
// includes as well):
//   row_stats_kernel   per-row LayerNorm mean and 1/std (only with LN)
//   gemm_nt_kernel     tiled shared-memory GEMM, f32 accumulation; an LN
//                      prologue on the A tile and two epilogues: QKV
//                      (bias, scale fold, head-major qu/qv/k/v) and plain
//                      (bias, optional residual). Launched for QKV, for
//                      P and for the out-projection.
//   rel_attn_kernel    flash-style attention core: grid (T/64, B*H), key
//                      tiles of 32 with an online f32 softmax, so any T
//                      runs without a length cap; the rel-pos term reads a
//                      band of projected P rows from shared memory.
//
// What bounds it on the card: at the 110m widths (D=512, T'=126..751) the
// projections are the FLOPs (2*B*T*D*4D) and the attention core is
// O(B*H*T^2*hd). Both run on the CUDA cores in IEEE f32 FMA (no TF32, no
// tensor cores), far below the tensor-core roofline. The design keeps every
// score and probability in registers and shared memory (nothing of size
// T^2 reaches device memory) and loads each key tile's P band once. On an
// H100 80GB HBM3 at 700 W the attention core reached ~8 TFLOP/s of the 67
// TFLOP/s f32 peak; it issues one shared-memory load per FMA, which is its
// bound, and takes most of a call at T'=751. A call at B=8 took 0.23 ms of
// device time at T'=126 and 2.18 ms at T'=751 (the plain version 0.21 and
// 1.84 ms). Register blocking, and wgmma/TMA tiles for bf16, are later work.
//
// Plain C interface, loaded with ctypes. Each entry returns
// cudaGetLastError() (0 = success).

#include "rel_attention.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. ln_w == null skips the LayerNorm
// prologue and the residual; otherwise out = x + attention(LN(x)).
// Scratch (allocated by the caller): stats (B*T, 2) f32; qu, qv, kh, vh
// (B, H, T, hd); pos (2T-1, D); ctx (B, T, D) — all in the activation dtype
// except stats.
int pk_rel_attention_block(int dtype, const void* x, const float* ln_w, const float* ln_b,
                           float eps, const void* wq, const void* bq, const void* wk,
                           const void* bk, const void* wv, const void* bv, const void* bias_u,
                           const void* bias_v, const void* pe, const void* pos_w, const void* wo,
                           const void* bo, const int* lengths, float* stats, void* qu, void* qv,
                           void* kh, void* vh, void* pos, void* ctx, void* out, int B, int T,
                           int D, int H, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_block<float>(x, ln_w, ln_b, eps, wq, bq, wk, bk, wv, bv, bias_u, bias_v, pe,
                            pos_w, wo, bo, lengths, stats, qu, qv, kh, vh, pos, ctx, out, B, T, D,
                            H, s);
  if (dtype == 1)
    return run_block<__nv_bfloat16>(x, ln_w, ln_b, eps, wq, bq, wk, bk, wv, bv, bias_u, bias_v,
                                    pe, pos_w, wo, bo, lengths, stats, qu, qv, kh, vh, pos, ctx,
                                    out, B, T, D, H, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
