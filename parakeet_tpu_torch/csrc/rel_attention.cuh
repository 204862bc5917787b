// Device code and launch sequence of K1, the fused rel-pos attention block
// (see rel_attention.cu for what it computes and what bounds it): the
// flash-style attention core and run_block, which launches LN statistics,
// the QKV GEMM, the position GEMM, the core and the out-projection on the
// caller's stream. Included by rel_attention.cu and ffn_attention.cu.
#pragma once

#include "gemm.cuh"

namespace {

// ─── Attention core ─────────────────────────────────────────────────────────
// Block: 64 query rows of one (b, h), 4 threads per row, each thread owning
// HD/4 of the head dims. Keys stream in tiles of 32 through shared memory
// with the matching band of BM+BN-1 projected position rows.

constexpr int ABM = 64, ABN = 32, ATHREADS = 256;

template <int HD>
constexpr int attn_smem_bytes() {
  return (2 * ABN + ABM + ABN - 1) * (HD + 4) * (int)sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(ATHREADS) rel_attn_kernel(
    const T* __restrict__ qu, const T* __restrict__ qv, const T* __restrict__ kh,
    const T* __restrict__ vh, const T* __restrict__ pos, const int* __restrict__ lengths,
    T* __restrict__ ctx, int Tn, int H) {
  constexpr int DPT = HD / 4, LDS = HD + 4;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + ABN * LDS;
  float* Ps = Vs + ABN * LDS;

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int t0 = blockIdx.x * ABM;
  const int tid = threadIdx.x, row = tid >> 2, part = tid & 3;
  const int t = t0 + row;
  const int D = H * HD;
  const bool row_ok = t < Tn;
  const int kv_len = min(lengths[b], Tn);
  // keys past kv_len carry -1e9 and add exactly 0 once a valid key is seen;
  // an item with no valid key averages all Tn keys, as the reference does
  const int n_keys = kv_len > 0 ? kv_len : Tn;

  const size_t head = (size_t)bh * Tn * HD;
  float q_u[DPT], q_v[DPT], acc[DPT];
#pragma unroll
  for (int d = 0; d < DPT; ++d) {
    const size_t o = head + (size_t)t * HD + part * DPT + d;
    q_u[d] = row_ok ? ld(qu + o) : 0.f;
    q_v[d] = row_ok ? ld(qv + o) : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int s0 = 0; s0 < n_keys; s0 += ABN) {
    for (int i = tid; i < ABN * HD; i += ATHREADS) {
      const int r = i / HD, c = i - r * HD;
      const int s = s0 + r;
      float kx = 0.f, vx = 0.f;
      if (s < Tn) {
        kx = ld(kh + head + (size_t)s * HD + c);
        vx = ld(vh + head + (size_t)s * HD + c);
      }
      Ks[r * LDS + c] = kx;
      Vs[r * LDS + c] = vx;
    }
    // band row j holds P[r_lo + j]; row (tr, ks) reads j = ks + ABM-1-tr
    const int r_lo = Tn - ABM - t0 + s0;
    for (int i = tid; i < (ABM + ABN - 1) * HD; i += ATHREADS) {
      const int j = i / HD, c = i - j * HD;
      const int r = r_lo + j;
      Ps[j * LDS + c] = (r >= 0 && r < 2 * Tn - 1) ? ld(pos + (size_t)r * D + h * HD + c) : 0.f;
    }
    __syncthreads();

    float sc[ABN];
    float tile_max = -INFINITY;
#pragma unroll
    for (int ks = 0; ks < ABN; ++ks) {
      const float* kr = Ks + ks * LDS + part * DPT;
      const float* pr = Ps + (ks + ABM - 1 - row) * LDS + part * DPT;
      float a = 0.f;
#pragma unroll
      for (int d = 0; d < DPT; ++d) a = fmaf(q_u[d], kr[d], fmaf(q_v[d], pr[d], a));
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      const int s = s0 + ks;
      if (s >= n_keys) a = -INFINITY;
      else if (s >= kv_len) a = -1e9f;
      sc[ks] = a;
      tile_max = fmaxf(tile_max, a);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[d] *= alpha;
#pragma unroll
    for (int ks = 0; ks < ABN; ++ks) {
      const float p = expf(sc[ks] - m_new);
      l += p;
      const float* vr = Vs + ks * LDS + part * DPT;
#pragma unroll
      for (int d = 0; d < DPT; ++d) acc[d] = fmaf(p, vr[d], acc[d]);
    }
    m = m_new;
    __syncthreads();
  }

  if (row_ok) {
    const float inv = 1.f / l;
    T* o = ctx + ((size_t)b * Tn + t) * D + h * HD + part * DPT;
#pragma unroll
    for (int d = 0; d < DPT; ++d) st(o + d, acc[d] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch_attn(const void* qu, const void* qv, const void* kh, const void* vh,
                        const void* pos, const int* lengths, void* ctx, int B, int Tn, int H,
                        cudaStream_t stream) {
  constexpr int smem = attn_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(rel_attn_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tn + ABM - 1) / ABM, B * H);
  rel_attn_kernel<T, HD><<<grid, ATHREADS, smem, stream>>>(
      static_cast<const T*>(qu), static_cast<const T*>(qv), static_cast<const T*>(kh),
      static_cast<const T*>(vh), static_cast<const T*>(pos), lengths, static_cast<T*>(ctx),
      Tn, H);
  return cudaGetLastError();
}

template <typename T>
int run_block(const void* x, const float* ln_w, const float* ln_b, float eps, const void* wq,
              const void* bq, const void* wk, const void* bk, const void* wv, const void* bv,
              const void* bias_u, const void* bias_v, const void* pe, const void* pos_w,
              const void* wo, const void* bo, const int* lengths, float* stats, void* qu,
              void* qv, void* kh, void* vh, void* pos, void* ctx, void* out, int B, int Tn,
              int D, int H, cudaStream_t stream) {
  const int M = B * Tn, HD = D / H;
  cudaError_t err;
  if (ln_w != nullptr && (err = launch_row_stats<T>(x, stats, M, D, eps, stream)) != cudaSuccess)
    return (int)err;

  GemmArgs g = {};
  g.a = x;
  g.w[0] = wq; g.w[1] = wk; g.w[2] = wv;
  g.bias[0] = bq; g.bias[1] = bk; g.bias[2] = bv;
  g.ln_stats = ln_w != nullptr ? stats : nullptr;
  g.ln_w = ln_w; g.ln_b = ln_b;
  g.out[0] = qu; g.out[1] = qv; g.out[2] = kh; g.out[3] = vh;
  g.bias_u = bias_u; g.bias_v = bias_v;
  g.M = M; g.N = 3 * D; g.K = D; g.nseg = D;
  g.T = Tn; g.H = H; g.HD = HD;
  g.scale = 1.f / sqrtf((float)HD);
  if ((err = launch_gemm<T, EPI_QKV>(g, stream)) != cudaSuccess) return (int)err;

  GemmArgs p = {};
  p.a = pe;
  p.w[0] = pos_w;
  p.out[0] = pos;
  p.M = 2 * Tn - 1; p.N = D; p.K = D; p.nseg = D;
  if ((err = launch_gemm<T, EPI_PLAIN>(p, stream)) != cudaSuccess) return (int)err;

  switch (HD) {
    case 32: err = launch_attn<T, 32>(qu, qv, kh, vh, pos, lengths, ctx, B, Tn, H, stream); break;
    case 64: err = launch_attn<T, 64>(qu, qv, kh, vh, pos, lengths, ctx, B, Tn, H, stream); break;
    case 128: err = launch_attn<T, 128>(qu, qv, kh, vh, pos, lengths, ctx, B, Tn, H, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;

  GemmArgs o = {};
  o.a = ctx;
  o.w[0] = wo;
  o.bias[0] = bo;
  o.residual = ln_w != nullptr ? x : nullptr;
  o.out[0] = out;
  o.M = M; o.N = D; o.K = D; o.nseg = D;
  if ((err = launch_gemm<T, EPI_PLAIN>(o, stream)) != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace
