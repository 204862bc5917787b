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
// takes LN(x2) rounded to T, so K7 is K6 (no final LayerNorm) followed by
// K1 with the fused pre-LN, exactly: the launch sequences of
// feed_forward.cuh (run_ffn) and rel_attention.cuh (run_block) run one
// after the other on the caller's stream (nine to eleven launches, by the
// plans); the FFN's LayerNorm output borrows ctx before the attention half
// needs it. The
// reference's core scores the position term by
// the angle-addition factorisation of the sinusoidal table; K1 gathers
// projected table rows instead (the function is the same, the rounding of
// the table in bf16 is not: see rel_attention.cu).
//
// What bounds it on the card: the FFN's two GEMMs and the attention's
// projections (2*M*D*(2F + 4D) FLOPs plus the position GEMM), all on
// ffn_gemm.cuh's tiles, and at long T the attention core, in IEEE f32 FMA
// on the CUDA cores, as in K6 and K1. x2 (2 MB at B=8, T'=126, D=512) stays
// in L2 between the halves; the saving on the card is one Python call and
// its argument checks per block.
//
// Plain C interface, loaded with ctypes. Returns cudaGetLastError() (0 =
// success).

#include "feed_forward.cuh"
#include "rel_attention.cuh"

namespace {

template <typename T>
int run_ffn_attention(const void* x, const float* fnw, const float* fnb, const void* f1,
                      const void* g1, const void* f2, const void* g2, const float* anw,
                      const float* anb, float eps, const void* wq, const void* bq, const void* wk,
                      const void* bk, const void* wv, const void* bv, const void* bias_u,
                      const void* bias_v, const void* pe, const void* pos_w, const void* wo,
                      const void* bo, const int* lengths, void* hf, float* part, void* x2,
                      void* qu, void* qv, void* kh, void* vh, void* pos, void* ctx, void* out,
                      int B, int Tn, int D, int H, int F, int splits, int qkv_rows,
                      int pos_splits, int out_splits, cudaStream_t stream) {
  // ctx is free until the attention half: it holds the FFN's LayerNorm
  // output, then the attention's; part serves both halves' split GEMMs
  int err = run_ffn<T>(x, fnw, fnb, f1, g1, f2, g2, nullptr, nullptr, eps, ctx, hf, part, x2,
                       B * Tn, D, F, splits, stream);
  if (err != 0) return err;
  return run_block<T>(x2, anw, anb, eps, wq, bq, wk, bk, wv, bv, bias_u, bias_v, pe, pos_w, wo, bo,
                      lengths, part, qu, qv, kh, vh, pos, ctx, out, B, Tn, D, H, qkv_rows,
                      pos_splits, out_splits, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x (B, T, D); ffn: f1 (F, D), g1 (F,),
// f2 (D, F), g2 (D,); attention: wq, wk, wv, pos_w, wo (D, D), bq, bk, bv,
// bo, bias_u, bias_v (D,), pe (2T-1, D) — all in the activation dtype; fnw,
// fnb, anw, anb (D,) f32; lengths (B,) int32 valid keys. Scratch (allocated
// by the caller): hf (B*T, F), part (f32, the larger of the two halves'
// split partials), x2 and ctx (B, T, D), qu, qv, kh, vh (B, H, T, hd), pos
// (2T-1, D). splits (fc2's k slices, dividing ceil(F / 32)), qkv_rows,
// pos_splits, out_splits: the launch plans of K6 and K1.
int pk_ffn_attention(int dtype, const void* x, const float* fnw, const float* fnb, const void* f1,
                     const void* g1, const void* f2, const void* g2, const float* anw,
                     const float* anb, float eps, const void* wq, const void* bq, const void* wk,
                     const void* bk, const void* wv, const void* bv, const void* bias_u,
                     const void* bias_v, const void* pe, const void* pos_w, const void* wo,
                     const void* bo, const int* lengths, void* hf, float* part, void* x2,
                     void* qu, void* qv, void* kh, void* vh, void* pos, void* ctx, void* out,
                     int B, int T, int D, int H, int F, int splits, int qkv_rows, int pos_splits,
                     int out_splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_ffn_attention<float>(x, fnw, fnb, f1, g1, f2, g2, anw, anb, eps, wq, bq, wk, bk,
                                    wv, bv, bias_u, bias_v, pe, pos_w, wo, bo, lengths, hf, part,
                                    x2, qu, qv, kh, vh, pos, ctx, out, B, T, D, H, F, splits,
                                    qkv_rows, pos_splits, out_splits, s);
  if (dtype == 1)
    return run_ffn_attention<__nv_bfloat16>(x, fnw, fnb, f1, g1, f2, g2, anw, anb, eps, wq, bq, wk,
                                            bk, wv, bv, bias_u, bias_v, pe, pos_w, wo, bo, lengths,
                                            hf, part, x2, qu, qv, kh, vh, pos, ctx, out, B, T, D,
                                            H, F, splits, qkv_rows, pos_splits, out_splits, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
