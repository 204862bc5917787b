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
// Hand-written kernels, in order on the caller's stream (the LayerNorm in
// gemm.cuh, the GEMMs and the closing pass in ffn_gemm.cuh, shared with the
// other kernels; the core and the launch sequence, run_block, in
// rel_attention.cuh, which K7 includes as well):
//   layer_norm_rows_kernel  x' = round(LN(x)) once (only with the LN), so
//                           that the QKV GEMM takes A by cp.async
//   ffn_gemm<QKV>           x' [wq | wk | wv]^T: bias, the 1/sqrt(hd) fold
//                           and the head-major qu, qv, k, v stores; 64-, 96-
//                           or 128-row tiles by the launch plan
//   ffn_gemm<PARTIAL>       P = pe Wpos^T in k slices by the plan, and
//   gemm_reduce_kernel      its closing pass: in-order slice sum, round
//   rel_attn_kernel         the register-blocked flash core: grid (T/BM,
//                           B*H); key tiles with their values and P band
//                           through a double-buffered cp.async ring; any T
//                           runs with one kernel
//   ffn_gemm<PARTIAL>       ctx Wo^T in k slices by the plan, and
//   gemm_reduce_kernel      its closing pass: in-order slice sum, + bo,
//                           + x with the LN, round once
//
// What bounds it on the card: the FLOPs, in IEEE f32 FMA on the CUDA cores
// (no TF32: f32 parity needs it; 67 TFLOP/s peak): the projections
// (2*B*T*D*4D + 2*(2T-1)*D*D) and the core (6*hd*H*T*sum of valid keys).
// At B=8, T'=126, D=512 that is 2.51 GFLOP, a 0.037 ms bound, against ~10
// MB of operands (0.003 ms). An SM's shared memory serves 32 words per
// clock against 128 FMAs, so a design that feeds each FMA from shared
// memory runs at a fraction of the FMA rate. The design: the GEMMs on
// ffn_gemm.cuh's register-blocked tiles, 8 x 8 f32 outputs per thread on
// 128-row tiles (0.25 shared words per FMA; mma.sync tensor cores in bf16),
// split along k where N = D leaves SMs idle, and the QKV GEMM, which cannot
// split, on the 64-, 96- or 128-row tiles that load the busiest SM least;
// a core where each thread owns a 4 x 8 patch of
// scores (4 x 4 at f32, hd = 128) and reads q rows, 8 key rows and the 11
// band rows the rel_shift maps its patch to, 4 values per read (0.42 words
// per FMA), and AV blocked over 4 rows x hd/8 head dims (0.31-0.5 words per
// FMA); the online max and sum are reduced over the 8 threads of a row;
// nothing of size T^2 reaches device memory, and keys at or past the
// length are skipped. bf16 runs the core in f32 SIMT on bf16 loads; tensor
// cores for the core are later work.
//
// Measured (device time, B=8, 110m widths, mixed lengths, kernel / plain
// version; NVIDIA H100 80GB HBM3, 700.00 W): f32 0.136 / 0.214 ms at
// T'=126 (QKV GEMM 0.070, position and out-projection GEMMs 0.027, their
// closing passes 0.012, core 0.021, LayerNorm 0.004) and 0.873 / 1.850 ms
// at T'=751 (QKV 0.311, core 0.398: 21 TFLOP/s over the valid keys, GEMMs
// 0.115, closing passes 0.029); bf16 0.094 / 0.318 and 0.534 / 2.042 ms.
// The design before it (64x64 GEMM tiles with the LayerNorm on the A
// loads, a core of one shared-memory load per FMA) took 0.232 and 2.184 ms
// in f32.
//
// Head-sharded mode (pk_rel_attention_block_heads), for tensor parallelism
// over heads: the same launch sequence over one 'model' rank's heads (the
// QKV GEMM N = 3 * H_local * hd, the position GEMM N = H_local * hd, the
// out-projection K = H_local * hd), ending in an f32 closing pass with no
// bias and no residual; the caller sums the ranks' partials, then adds both
// once. Measured (device time, B=8, T'=126, 4 of 8 heads, f32; NVIDIA H100
// 80GB HBM3, 700.00 W): 0.0998 / 0.1547 ms at D=512 and 0.2200 / 0.2706 ms
// at D=1024 (hd 128), kernel / plain version.
//
// Plain C interface, loaded with ctypes. Each entry returns
// cudaGetLastError() (0 = success).

#include "rel_attention.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. ln_w == null skips the LayerNorm
// and the residual; otherwise out = x + attention(LN(x)). Scratch
// (allocated by the caller): part, the f32 partials of the position GEMM
// and the out-projection (the larger of the two); qu, qv, kh, vh (B, H, T, hd); pos (2T-1, D);
// ctx (B, T, D), all in the activation dtype. qkv_rows, pos_splits,
// out_splits: the launch plan (ops/rel_attention.py block_plan).
int pk_rel_attention_block(int dtype, const void* x, const float* ln_w, const float* ln_b,
                           float eps, const void* wq, const void* bq, const void* wk,
                           const void* bk, const void* wv, const void* bv, const void* bias_u,
                           const void* bias_v, const void* pe, const void* pos_w, const void* wo,
                           const void* bo, const int* lengths, float* part, void* qu, void* qv,
                           void* kh, void* vh, void* pos, void* ctx, void* out, int B, int T,
                           int D, int H, int qkv_rows, int pos_splits, int out_splits,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_block<float>(x, ln_w, ln_b, eps, wq, bq, wk, bk, wv, bv, bias_u, bias_v, pe,
                            pos_w, wo, bo, lengths, part, qu, qv, kh, vh, pos, ctx, out, B, T, D,
                            H, qkv_rows, pos_splits, out_splits, s);
  if (dtype == 1)
    return run_block<__nv_bfloat16>(x, ln_w, ln_b, eps, wq, bq, wk, bk, wv, bv, bias_u, bias_v,
                                    pe, pos_w, wo, bo, lengths, part, qu, qv, kh, vh, pos, ctx,
                                    out, B, T, D, H, qkv_rows, pos_splits, out_splits, s);
  return (int)cudaErrorInvalidValue;
}

// K1 head-sharded, for tensor parallelism over heads: the weights hold H
// heads of head dim HD of a layer D wide (wq, wk, wv, pos_w (H*HD, D); wo
// (D, H*HD); bias_u, bias_v (H, HD)); x, the LayerNorm and pe are the whole
// layer's. Writes partial, the (B*T, D) f32 out-projection of the local
// heads, no bias and no residual (the caller sums it over the 'model' ranks,
// then adds the bias and the residual once). ctx is (B*T, D), as it holds
// the LayerNorm output first.
int pk_rel_attention_block_heads(int dtype, const void* x, const float* ln_w, const float* ln_b,
                                 float eps, const void* wq, const void* bq, const void* wk,
                                 const void* bk, const void* wv, const void* bv,
                                 const void* bias_u, const void* bias_v, const void* pe,
                                 const void* pos_w, const void* wo, const int* lengths,
                                 float* part, void* qu, void* qv, void* kh, void* vh, void* pos,
                                 void* ctx, float* partial, int B, int T, int D, int H, int HD,
                                 int qkv_rows, int pos_splits, int out_splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (partial == nullptr || H * HD > D) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return run_block<float>(x, ln_w, ln_b, eps, wq, bq, wk, bk, wv, bv, bias_u, bias_v, pe,
                            pos_w, wo, nullptr, lengths, part, qu, qv, kh, vh, pos, ctx, nullptr, B,
                            T, D, H, qkv_rows, pos_splits, out_splits, s, HD, partial);
  if (dtype == 1)
    return run_block<__nv_bfloat16>(x, ln_w, ln_b, eps, wq, bq, wk, bk, wv, bv, bias_u, bias_v,
                                    pe, pos_w, wo, nullptr, lengths, part, qu, qv, kh, vh, pos,
                                    ctx, nullptr, B, T, D, H, qkv_rows, pos_splits, out_splits, s,
                                    HD, partial);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
