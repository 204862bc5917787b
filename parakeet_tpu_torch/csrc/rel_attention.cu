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
//   ctx = softmax(score) v              (f32 softmax, normalised after AV;
//                                        bf16: e rounded to bf16 before AV)
//   y = ctx Wo^T + bo (+ x when LN is fused)
//
// Two launch sequences on the caller's stream (run_block, rel_attention.cuh,
// which K7 includes as well; the plan, ops/rel_attention.py block_plan,
// picks one):
//   bf16 at D <= 1024 (the Hopper design), 3 launches, the GEMMs on
//   ffn_gemm.cuh's hopper_gemm_kernel (wgmma fed by TMA):
//     1. QKV (bias, the 1/sqrt(hd) fold, head-major qu, qv, k and v
//        transposed) on LN(x), the LayerNorm on the A path once a cluster
//        of column tiles, and in the same launch the position GEMM P
//        (blocks that skip the LayerNorm)
//     2. the bf16 core, rel_attn_wgmma_kernel
//     3. the out-projection, k split over a thread-block cluster closed in
//        distributed shared memory: round(x + y + bo)
//   f32, bf16 at D > 1024 and the head-sharded mode (the tiled design), 7
//   launches with the LayerNorm: layer_norm_rows_kernel, the tiled QKV
//   GEMM, the position GEMM and its closing pass, the core of the dtype,
//   the out-projection and its closing pass (ffn_gemm.cuh).
//
// What bounds it on the card: the FLOPs (2*B*T*D*4D + 2*(2T-1)*D*D for the
// projections, 6*hd*H*T*(valid keys) for the core; 2.51 GFLOP at B=8,
// T'=126, D=512). In f32 they run in IEEE FMA on the CUDA cores (no TF32:
// f32 parity needs it; 67 TFLOP/s, a 0.0378 ms bound); an SM's shared
// memory serves 32 words a clock against 128 FMAs, so the f32 core is a
// register-blocked flash kernel that reads few words an FMA, and it needs
// warps to hide the loads. In bf16 the tensor cores bound it at 0.0025 ms,
// so the launches, the passes of intermediates through device memory and
// the core's softmax decide the time.
//
// The cores (rel_attention.cuh): both take 64 (f32 at hd 64: 128) query
// rows of one (b, h) a block, walk the keys in tiles with an online f32
// softmax, skip keys at or past the length, and keep nothing of size T^2
// in device memory. bf16: one consumer warpgroup and a producer warp; TMA
// brings q_u, q_v, then per 64-key tile the keys, the 128-row band of P
// and the values (stored transposed by the QKV epilogue) into a 2-stage
// ring under mbarriers; S = q_u K^T and R = q_v Band^T on wgmma (m64n64,
// m64n128), R skewed onto S through shared memory (S[i][j] += R[i][j - i +
// 63]), the probabilities rounded to bf16 straight from the accumulator
// registers into wgmma's A registers for O += P V. f32: 8 warps a block (4
// and 2 at hd 64 and 128 before), 4-row patches of scores (hd 128: over
// half the head dims each, summed by a shuffle), a double-buffered cp.async
// ring for keys and values and one band buffer refilled during AV. Where
// the grid fills less than a wave, the plan splits the keys of each query
// tile over a cluster of 2-8 blocks that merge their max, sum and output
// through distributed shared memory in split order (one launch, no
// partials in device memory, bit for bit repeatable).
//
// Measured (device time, mixed lengths, kernel / plain version; NVIDIA H100
// 80GB HBM3, 700.00 W; chip_smoke.py): B=8, D=512, f32 0.1345 / 0.2172 ms
// at T'=126 (QKV GEMM 0.0704, position and out-projection GEMMs 0.0278,
// closing passes 0.0126, core 0.0212, LayerNorm 0.0044) and 0.7886 /
// 1.8481 at T'=751 (core 0.3222, was 0.398); bf16 0.0420 / 0.3437 at
// T'=126 (QKV+P with the LayerNorm 0.0255, core 0.0072, out-projection
// 0.0092) and 0.2123 / 2.4723 at T'=751 (0.1077, 0.0535, 0.0299). D=1024,
// B=1, T'=1188 (4 key splits): f32 1.0269 / 1.0290 (core 0.5133, was
// 1.196), bf16 0.2050 / 1.3412. Against the design before (the cores of
// 4 and 2 warps, 7 launches in bf16), in turns on one card (old, new, new,
// old): f32 0.1356, 0.1336, 0.1332, 0.1345 ms at T'=126 and 0.8655,
// 0.7876, 0.7819, 0.8596 at T'=751; bf16 0.0924, 0.0435, 0.0421, 0.0920
// and 0.5305, 0.2124, 0.2123, 0.5292; T'=1188 f32 1.7225, 1.0692, 1.0266,
// 1.7105 (plain 1.035-1.040), bf16 0.9620, 0.2057, 0.2059, 0.9615.
//
// Head-sharded mode (pk_rel_attention_block_heads), for tensor parallelism
// over heads: the tiled design over one 'model' rank's heads (the QKV GEMM
// N = 3 * H_local * hd, the position GEMM N = H_local * hd, the
// out-projection K = H_local * hd) with the core of the dtype, ending in an
// f32 closing pass with no bias and no residual; the caller sums the ranks'
// partials, then adds both once.
//
// Plain C interface, loaded with ctypes. Each entry returns
// cudaGetLastError() (0 = success).

#include "rel_attention.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. ln_w == null skips the LayerNorm
// and the residual; otherwise out = x + attention(LN(x)). Scratch
// (allocated by the caller): part, the f32 partials of the tiled position
// GEMM and out-projection (the larger of the two; unused by the Hopper
// design); qu, qv, kh (B, H, T, hd); vh (B, H, T, hd) in f32, (B, H, hd, T
// rounded up to 8) in bf16; pos (2T-1, D); ctx (B, T, D), all in the
// activation dtype. hopper, qkv, pos_splits, out_splits, core_splits: the
// launch plan (ops/rel_attention.py block_plan; see run_block).
int pk_rel_attention_block(int dtype, const void* x, const float* ln_w, const float* ln_b,
                           float eps, const void* wq, const void* bq, const void* wk,
                           const void* bk, const void* wv, const void* bv, const void* bias_u,
                           const void* bias_v, const void* pe, const void* pos_w, const void* wo,
                           const void* bo, const int* lengths, float* part, void* qu, void* qv,
                           void* kh, void* vh, void* pos, void* ctx, void* out, int B, int T,
                           int D, int H, int hopper, int qkv, int pos_splits, int out_splits,
                           int core_splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_block<float>(x, ln_w, ln_b, eps, wq, bq, wk, bk, wv, bv, bias_u, bias_v, pe,
                            pos_w, wo, bo, lengths, part, qu, qv, kh, vh, pos, ctx, out, B, T, D,
                            H, hopper, qkv, pos_splits, out_splits, core_splits, s);
  if (dtype == 1)
    return run_block<__nv_bfloat16>(x, ln_w, ln_b, eps, wq, bq, wk, bk, wv, bv, bias_u, bias_v,
                                    pe, pos_w, wo, bo, lengths, part, qu, qv, kh, vh, pos, ctx,
                                    out, B, T, D, H, hopper, qkv, pos_splits, out_splits, core_splits, s);
  return (int)cudaErrorInvalidValue;
}

// K1 head-sharded, for tensor parallelism over heads: the weights hold H
// heads of head dim HD of a layer D wide (wq, wk, wv, pos_w (H*HD, D); wo
// (D, H*HD); bias_u, bias_v (H, HD)); x, the LayerNorm and pe are the whole
// layer's. Writes partial, the (B*T, D) f32 out-projection of the local
// heads, no bias and no residual (the caller sums it over the 'model' ranks,
// then adds the bias and the residual once). ctx is (B*T, D), as it holds
// the LayerNorm output first. The tiled design with the core of the dtype
// (qkv_rows, pos_splits, out_splits, core_splits: heads_plan's).
int pk_rel_attention_block_heads(int dtype, const void* x, const float* ln_w, const float* ln_b,
                                 float eps, const void* wq, const void* bq, const void* wk,
                                 const void* bk, const void* wv, const void* bv,
                                 const void* bias_u, const void* bias_v, const void* pe,
                                 const void* pos_w, const void* wo, const int* lengths,
                                 float* part, void* qu, void* qv, void* kh, void* vh, void* pos,
                                 void* ctx, float* partial, int B, int T, int D, int H, int HD,
                                 int qkv_rows, int pos_splits, int out_splits, int core_splits,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (partial == nullptr || H * HD > D) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return run_block<float>(x, ln_w, ln_b, eps, wq, bq, wk, bk, wv, bv, bias_u, bias_v, pe,
                            pos_w, wo, nullptr, lengths, part, qu, qv, kh, vh, pos, ctx, nullptr, B,
                            T, D, H, 0, qkv_rows, pos_splits, out_splits, core_splits, s, HD, partial);
  if (dtype == 1)
    return run_block<__nv_bfloat16>(x, ln_w, ln_b, eps, wq, bq, wk, bk, wv, bv, bias_u, bias_v,
                                    pe, pos_w, wo, nullptr, lengths, part, qu, qv, kh, vh, pos,
                                    ctx, nullptr, B, T, D, H, 0, qkv_rows, pos_splits, out_splits,
                                    core_splits, s, HD, partial);
  return (int)cudaErrorInvalidValue;
}

// Blocks of the attention core of (dtype, hd) that one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus the CUDA error:
// what ops/rel_attention.py core_plan's `resident` says for an H100.
int pk_rel_attention_core_resident(int dtype, int hd) { return core_resident(dtype, hd); }

}  // extern "C"
