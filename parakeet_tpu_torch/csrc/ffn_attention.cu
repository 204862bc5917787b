// ffn1 and the attention sublayer of a conformer block for Hopper
// (sm_90a): K7 ("mega").
//
// Replaces the TPU kernel parakeet_tpu/ops/pallas_attention.py::
// fused_ffn_attention (_ffn_attn_kernel), which the reference's encoder
// runs for every block under set_fused_attention("mega"). Per layer, on the
// block input x:
//
//   x2  = round(x + 0.5 * FFN(LN(x)))     ffn_body, no final LayerNorm
//   out = round(x2 + Attention(LN(x2)))   K1's block with the pre-LN fused
//                                         and the residual of x2, not x
//
// ffn_body returns T (pallas_utils.py) and the reference's attention core
// takes LN(x2) rounded to T; those are the rounding points kept here. The
// reference's core scores the position term by the angle-addition
// factorisation of the sinusoidal table; K1's core, which K7 runs, gathers
// projected table rows instead (the function is the same, the rounding of
// the table in bf16 is not: see rel_attention.cu).
//
// What bounds it on the card: the GEMMs (2*M*D*(2F + 4D) FLOPs plus the
// position GEMM; 6.5 GFLOP at B=8, T'=126, D=512, F=2048). In bf16 they
// take microseconds on the tensor cores, so the launches between them and
// the passes of intermediates through device memory decide the time, and
// the plan (ops/ffn_attention.py k7_plan) runs the Hopper design: five
// launches, every GEMM on ffn_gemm.cuh's hopper_gemm_kernel (wgmma fed by
// TMA), no LayerNorm launch, no f32 partials and no closing pass:
//
//   1. fc1 + SiLU on LN_ffn(x): the LayerNorm on the GEMM's A path (each
//      cluster of column tiles normalises the rows once, into ctx)
//   2. fc2, k split over a thread-block cluster that also spans the row's
//      column tiles: x2 = round(x + 0.5 (y + b2)) and, from the row
//      statistics exchanged in the cluster, xn = round(LN_attn(x2))
//   3. QKV on xn (the head-major fold, v stored transposed for the core's
//      wgmma) and, in the same launch, the position GEMM P = round(pe
//      pos_w^T)
//   4. K1's bf16 attention core (rel_attention.cuh rel_attn_wgmma_kernel:
//      wgmma fed by TMA, keys split over a cluster where the plan says),
//      which takes min(len, T) itself
//   5. the out-projection, k split over a cluster: out = round(x2 + y + bo)
//
// In f32 the GEMMs are IEEE FMA on the CUDA cores, where the tiled GEMM's
// 128-row tiles and its split-K closing pass beat a whole-row cluster, and
// in bf16 a row wider than a cluster's 8 column tiles (D > 1024) cannot be
// LayerNorm'd in one: there the plan runs K6's launch sequence
// (feed_forward.cuh run_ffn) and then K1's tiled one (rel_attention.cuh
// run_block, with K1's core of the dtype) on the caller's stream, eleven
// launches; the FFN's LayerNorm output borrows ctx before the attention
// half needs it.
//
// Measured (device time, B=8, D=512, F=2048, mixed lengths; NVIDIA H100
// 80GB HBM3, 700.00 W; chip_smoke.py), in turns on one card with K1's
// core before (f32 FMA on bf16 loads; old, new, new, old): bf16 0.0894,
// 0.0820, 0.0817, 0.0893 ms at T'=126 and 0.7443, 0.3821, 0.3337, 0.7436 at
// T'=751 (K1's wgmma core 0.0069 and 0.0754 of the new); f32 0.2686,
// 0.2695, 0.2694, 0.2700 and 1.6756, 1.6021, 1.6044, 1.6765 (the tiled
// sequences, with K1's 8-warp core in the new).
//
// Plain C interface, loaded with ctypes. Returns cudaGetLastError() (0 =
// success).

#include "feed_forward.cuh"
#include "rel_attention.cuh"

namespace {

// The Hopper design, bf16: K6's Hopper sequence writing x2 and, from the
// cluster that closes fc2, LN_attn(x2) into ctx, then QKV with the position
// GEMM, K1's core and the out-projection. fc1_cols: the column tiles that
// share fc1's LayerNorm; fc2_splits, out_splits: the k slices of fc2 and
// the out-projection.
int run_hopper(const void* x, const float* fnw, const float* fnb, const void* f1, const void* g1, const void* f2,
               const void* g2, const float* anw, const float* anb, float eps, const void* wq, const void* bq,
               const void* wk, const void* bk, const void* wv, const void* bv, const void* bias_u,
               const void* bias_v, const void* pe, const void* pos_w, const void* wo, const void* bo,
               const int* lengths, void* hf, void* x2, void* qu, void* qv, void* kh, void* vh, void* pos, void* ctx,
               void* out, int B, int Tn, int D, int H, int F, int fc1_cols, int fc2_splits, int out_splits,
               int core_splits, cudaStream_t stream) {
  const int M = B * Tn, HD = D / H;
  if (M == 0) return 0;
  // ctx holds LN_ffn(x) for fc1, then LN_attn(x2) until the core writes it
  int rc = run_ffn_hopper(x, fnw, fnb, f1, g1, f2, g2, eps, x, x2, anw, anb, ctx, ctx, hf, M, D, F, fc1_cols,
                          fc2_splits, stream);
  if (rc != 0) return rc;
  cudaError_t err;

  HgArgs q = {};
  FfnGemmArgs& g = q.g[0];
  g.a = ctx;
  g.w[0] = wq; g.w[1] = wk; g.w[2] = wv;
  g.bias[0] = bq; g.bias[1] = bk; g.bias[2] = bv;
  g.out[0] = qu; g.out[1] = qv; g.out[2] = kh; g.out[3] = vh;
  g.bias_u = bias_u; g.bias_v = bias_v;
  g.M = M; g.N = 3 * D; g.K = D; g.nseg = D;
  g.T = Tn; g.H = H; g.HD = HD;
  g.scale = 1.f / sqrtf((float)HD);
  g.vt_ld = (Tn + 7) & ~7;  // v transposed, for the core's wgmma
  FfnGemmArgs& p = q.g[1];
  p.a = pe;
  p.w[0] = pos_w;
  p.out[0] = pos;
  p.M = 2 * Tn - 1; p.N = D; p.K = D;
  if ((err = launch_hopper_gemm<HE_QKV_POS, false>(q, stream)) != cudaSuccess) return (int)err;

  if ((err = launch_attn<bf16>(qu, qv, kh, vh, pos, lengths, ctx, B, Tn, H, HD, core_splits, stream)) !=
      cudaSuccess)
    return (int)err;

  return (int)launch_cluster_linear(ctx, wo, bo, x2, 1.f, out, nullptr, nullptr, 0.f, nullptr, M, D, D, out_splits,
                                    stream);
}

// K6's launch sequence, then K1's: splits (fc2's k slices), qkv_rows,
// pos_splits, out_splits, their plans'. part serves both halves' split
// GEMMs; ctx holds the FFN's LayerNorm output, then the attention's.
template <typename T>
int run_tiled(const void* x, const float* fnw, const float* fnb, const void* f1, const void* g1, const void* f2,
              const void* g2, const float* anw, const float* anb, float eps, const void* wq, const void* bq,
              const void* wk, const void* bk, const void* wv, const void* bv, const void* bias_u,
              const void* bias_v, const void* pe, const void* pos_w, const void* wo, const void* bo,
              const int* lengths, void* hf, float* part, void* x2, void* qu, void* qv, void* kh, void* vh,
              void* pos, void* ctx, void* out, int B, int Tn, int D, int H, int F, int splits, int qkv_rows,
              int pos_splits, int out_splits, int core_splits, cudaStream_t stream) {
  int err = run_ffn<T>(x, fnw, fnb, f1, g1, f2, g2, nullptr, nullptr, eps, ctx, hf, part, x2, B * Tn, D, F, splits,
                       stream);
  if (err != 0) return err;
  return run_block<T>(x2, anw, anb, eps, wq, bq, wk, bk, wv, bv, bias_u, bias_v, pe, pos_w, wo, bo, lengths, part,
                      qu, qv, kh, vh, pos, ctx, out, B, Tn, D, H, 0, qkv_rows, pos_splits, out_splits, core_splits,
                      stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x (B, T, D); ffn: f1 (F, D), g1 (F,),
// f2 (D, F), g2 (D,); attention: wq, wk, wv, pos_w, wo (D, D), bq, bk, bv,
// bo, bias_u, bias_v (D,), pe (2T-1, D) — all in the activation dtype; fnw,
// fnb, anw, anb (D,) f32; lengths (B,) int32 valid keys (min(len, T) is
// taken in the kernels). Scratch (allocated by the caller): hf (B*T, F),
// x2 and ctx (B, T, D), qu, qv, kh, vh (B, H, T, hd), pos (2T-1, D), part
// (f32, the tiled sequences' split partials; null for the Hopper design).
// The plan (ops/ffn_attention.py k7_plan): hopper (1: the Hopper design,
// bf16 only), splits (fc2's k slices), out_splits (the out-projection's),
// and for the Hopper design fc1_cols (fc1's LayerNorm cluster), for the
// tiled sequences qkv_rows and pos_splits (K1's plan).
int pk_ffn_attention(int dtype, const void* x, const float* fnw, const float* fnb, const void* f1,
                     const void* g1, const void* f2, const void* g2, const float* anw,
                     const float* anb, float eps, const void* wq, const void* bq, const void* wk,
                     const void* bk, const void* wv, const void* bv, const void* bias_u,
                     const void* bias_v, const void* pe, const void* pos_w, const void* wo,
                     const void* bo, const int* lengths, void* hf, float* part, void* x2, void* qu,
                     void* qv, void* kh, void* vh, void* pos, void* ctx, void* out, int B, int T, int D,
                     int H, int F, int hopper, int splits, int qkv_rows, int pos_splits, int out_splits,
                     int fc1_cols, int core_splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hopper)
    return dtype != 1 ? (int)cudaErrorInvalidValue
                      : run_hopper(x, fnw, fnb, f1, g1, f2, g2, anw, anb, eps, wq, bq, wk, bk, wv, bv, bias_u,
                                   bias_v, pe, pos_w, wo, bo, lengths, hf, x2, qu, qv, kh, vh, pos, ctx, out, B, T,
                                   D, H, F, fc1_cols, splits, out_splits, core_splits, s);
  if (dtype == 0)
    return run_tiled<float>(x, fnw, fnb, f1, g1, f2, g2, anw, anb, eps, wq, bq, wk, bk, wv, bv, bias_u, bias_v, pe,
                            pos_w, wo, bo, lengths, hf, part, x2, qu, qv, kh, vh, pos, ctx, out, B, T, D, H, F,
                            splits, qkv_rows, pos_splits, out_splits, core_splits, s);
  if (dtype == 1)
    return run_tiled<__nv_bfloat16>(x, fnw, fnb, f1, g1, f2, g2, anw, anb, eps, wq, bq, wk, bk, wv, bv, bias_u,
                                    bias_v, pe, pos_w, wo, bo, lengths, hf, part, x2, qu, qv, kh, vh, pos, ctx, out,
                                    B, T, D, H, F, splits, qkv_rows, pos_splits, out_splits, core_splits, s);
  return (int)cudaErrorInvalidValue;
}

// Clusters of `size` blocks of the Hopper GEMM that the card holds at once
// (cudaOccupancyMaxActiveClusters), or minus the CUDA error: what the
// plans' table (ops/gemm_plan.py HOPPER_ACTIVE_CLUSTERS) is checked against.
int pk_hopper_active_clusters(int size) { return hopper_active_clusters(size); }

}  // extern "C"
