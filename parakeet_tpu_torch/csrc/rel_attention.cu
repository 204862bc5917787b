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
// Three hand-written kernels, five launches in order on the caller's stream:
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
// H100 80GB HBM3 at 700 W the GEMMs reached ~12 TFLOP/s and the attention
// core ~8 TFLOP/s of the 67 TFLOP/s f32 peak; the core issues one
// shared-memory load per FMA, which is its bound. Register blocking, and
// wgmma/TMA tiles for bf16, are later work.
//
// Plain C interface, loaded with ctypes. Each entry returns
// cudaGetLastError() (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Round a float32 value to the storage type T and back (identity for f32).
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ─── LayerNorm statistics: one warp per row ────────────────────────────────

template <typename T>
__global__ void row_stats_kernel(const T* __restrict__ x, float* __restrict__ stats,
                                 int M, int K, float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;  // whole warp leaves together
  const T* xr = x + (size_t)row * K;
  float s = 0.f;
  for (int k = lane; k < K; k += 32) s += ld(xr + k);
  const float mean = warp_sum(s) / (float)K;
  float v = 0.f;
  for (int k = lane; k < K; k += 32) {
    const float d = ld(xr + k) - mean;
    v += d * d;
  }
  const float var = warp_sum(v) / (float)K;
  if (lane == 0) {
    stats[2 * row] = mean;
    stats[2 * row + 1] = 1.f / sqrtf(var + eps);
  }
}

// ─── GEMM: C[M, N] = A[M, K] @ W[N, K]^T ───────────────────────────────────

constexpr int GBM = 64, GBN = 64, GBK = 16, GTHREADS = 256;
constexpr int EPI_PLAIN = 0, EPI_QKV = 1;

struct GemmArgs {
  const void* a;                 // (M, K), activation dtype
  const void* w[3];              // weight segments, torch layout (nseg, K) each
  const void* bias[3];           // per-segment bias (nseg,) or null
  const float* ln_stats;         // (M, 2) mean, 1/std; null = no LN prologue
  const float* ln_w;             // (K,) f32
  const float* ln_b;             // (K,) f32
  const void* residual;          // (M, N) or null (EPI_PLAIN)
  void* out[4];                  // PLAIN: out[0] (M, N); QKV: qu, qv, k, v (B, H, T, hd)
  const void* bias_u;            // (D,) EPI_QKV
  const void* bias_v;            // (D,) EPI_QKV
  int M, N, K, nseg;
  int T, H, HD;
  float scale;
};

template <typename T, int EPI, bool LN>
__global__ void __launch_bounds__(GTHREADS) gemm_nt_kernel(GemmArgs g) {
  __shared__ __align__(16) float As[GBK][GBM + 4];
  __shared__ __align__(16) float Ws[GBK][GBN + 4];
  const T* A = static_cast<const T*>(g.a);
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < g.K; k0 += GBK) {
    for (int i = tid; i < GBM * GBK; i += GTHREADS) {
      const int r = i / GBK, c = i % GBK;
      const int m = m0 + r, k = k0 + c;
      float a = 0.f;
      if (m < g.M && k < g.K) {
        a = ld(A + (size_t)m * g.K + k);
        if (LN) {
          const float mean = g.ln_stats[2 * m], rstd = g.ln_stats[2 * m + 1];
          a = round_to<T>((a - mean) * rstd * g.ln_w[k] + g.ln_b[k]);
        }
      }
      As[c][r] = a;
    }
    for (int i = tid; i < GBN * GBK; i += GTHREADS) {
      const int r = i / GBK, c = i % GBK;
      const int n = n0 + r, k = k0 + c;
      float w = 0.f;
      if (n < g.N && k < g.K) {
        const int seg = n / g.nseg;
        const T* W = static_cast<const T*>(g.w[seg]);
        w = ld(W + (size_t)(n - seg * g.nseg) * g.K + k);
      }
      Ws[c][r] = w;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GBK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 w4 = *reinterpret_cast<const float4*>(&Ws[kk][tx * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= g.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= g.N) continue;
      const int seg = n / g.nseg, nn = n - seg * g.nseg;
      float val = acc[i][j];
      if (g.bias[seg] != nullptr) val += ld(static_cast<const T*>(g.bias[seg]) + nn);
      if (EPI == EPI_PLAIN) {
        const size_t o = (size_t)m * g.N + n;
        if (g.residual != nullptr) val = ld(static_cast<const T*>(g.residual) + o) + val;
        st(static_cast<T*>(g.out[0]) + o, val);
      } else {
        const int b = m / g.T, t = m - b * g.T;
        const int h = nn / g.HD, c = nn - h * g.HD;
        const size_t o = (((size_t)b * g.H + h) * g.T + t) * g.HD + c;
        if (seg == 0) {
          // 1/sqrt(hd) folded into q and the u/v biases, each rounded to T
          // as the reference kernel rounds them
          const float qs = round_to<T>(val * g.scale);
          const float us = round_to<T>(ld(static_cast<const T*>(g.bias_u) + nn) * g.scale);
          const float vs = round_to<T>(ld(static_cast<const T*>(g.bias_v) + nn) * g.scale);
          st(static_cast<T*>(g.out[0]) + o, qs + us);
          st(static_cast<T*>(g.out[1]) + o, qs + vs);
        } else {
          st(static_cast<T*>(g.out[seg + 1]) + o, val);
        }
      }
    }
  }
}

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

template <typename T, int EPI>
cudaError_t launch_gemm(const GemmArgs& g, cudaStream_t stream) {
  dim3 grid((g.N + GBN - 1) / GBN, (g.M + GBM - 1) / GBM);
  if (g.ln_stats != nullptr)
    gemm_nt_kernel<T, EPI, true><<<grid, GTHREADS, 0, stream>>>(g);
  else
    gemm_nt_kernel<T, EPI, false><<<grid, GTHREADS, 0, stream>>>(g);
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
  if (ln_w != nullptr) {
    const int threads = 256, rows_per_block = threads / 32;
    row_stats_kernel<T><<<(M + rows_per_block - 1) / rows_per_block, threads, 0, stream>>>(
        static_cast<const T*>(x), stats, M, D, eps);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }

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
