// Device code and launch sequence of K1, the fused rel-pos attention block
// (see rel_attention.cu for what it computes and what bounds it): the
// register-blocked flash attention core and run_block, which launches the
// LayerNorm, the QKV GEMM, the position GEMM, the core and the
// out-projection (with its closing pass when split) on the caller's stream.
// The GEMMs are ffn_gemm.cuh's. Included by rel_attention.cu and
// ffn_attention.cu.
#pragma once

#include "ffn_gemm.cuh"

namespace {

// ─── Attention core ─────────────────────────────────────────────────────────
// Block: BM query rows of one (b, h), 2 * BM threads: BM/4 row groups of 8
// threads. Thread (ty, tx) owns the 4 x PN patch of scores of rows ty*4 + i
// and keys tx*PN + j of each key tile (PN = BN/8), and the running output
// of the same 4 rows over head dims (tx + 8g)*4 .. +3 (g < HD/32). Key
// tiles of BN rows stream with their values and their band of BM + BN - 1
// projected position rows through a double-buffered cp.async ring.

// (BM, BN) per activation type and head dim: the largest of 64 x 64 whose
// ring fits the card's shared memory (f32 at hd = 128 takes 32 x 32)
template <typename T, int HD>
struct CoreTile {
  static constexpr int BM = (sizeof(T) == 4 && HD == 128) ? 32 : 64;
  static constexpr int BN = BM;
};

template <typename T, int HD>
constexpr int core_smem_bytes() {
  constexpr int BM = CoreTile<T, HD>::BM, BN = CoreTile<T, HD>::BN;
  return 4 * BM * (BN + 4) + (int)sizeof(T) * HD * (2 * BM + 2 * (2 * BN + BM + BN - 1));
}

// Element offset of (row r, element e) in a shared tile of HD-wide rows
// whose 16-byte chunks are XOR-swizzled by r/8, so that the rows 8 apart
// that neighbouring threads read fall in distinct bank groups.
template <typename T, int HD>
__device__ __forceinline__ int core_swz(int r, int e) {
  constexpr int CH = 16 / (int)sizeof(T), NC = HD / CH;
  constexpr int MASK = (NC < 8 ? NC : 8) - 1;
  return r * HD + (((e / CH) ^ ((r >> 3) & MASK)) * CH) + e % CH;
}

__device__ __forceinline__ float4 core_ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 core_ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// Rows row0 .. row0 + n - 1 of src (HD-wide rows `stride` elements apart)
// into a swizzled tile, zero for rows outside [0, hi), by 16-byte cp.async.
template <typename T, int HD, int THREADS>
__device__ __forceinline__ void core_copy_rows(T* dst, const T* src, size_t stride, int row0, int n,
                                               int hi, int tid) {
  constexpr int CH = 16 / (int)sizeof(T), NC = HD / CH;
  for (int i = tid; i < n * NC; i += THREADS) {
    const int j = i / NC, c = (i - j * NC) * CH;
    const int r = row0 + j;
    const bool ok = r >= 0 && r < hi;
    cp_async16(dst + core_swz<T, HD>(j, c), ok ? src + (size_t)r * stride + c : src, ok);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(2 * CoreTile<T, HD>::BM) rel_attn_kernel(
    const T* __restrict__ qu, const T* __restrict__ qv, const T* __restrict__ kh,
    const T* __restrict__ vh, const T* __restrict__ pos, const int* __restrict__ lengths,
    T* __restrict__ ctx, int Tn, int H) {
  constexpr int BM = CoreTile<T, HD>::BM, BN = CoreTile<T, HD>::BN;
  constexpr int THREADS = 2 * BM, PN = BN / 8, PB = BM + BN - 1, G = HD / 32;
  constexpr int LDP = BN + 4;                   // f32 probabilities per shared row
  constexpr int STAGE = (2 * BN + PB) * HD;     // keys, values, position band
  extern __shared__ __align__(16) unsigned char core_smem[];
  float* ps = reinterpret_cast<float*>(core_smem);
  T* q_u = reinterpret_cast<T*>(ps + BM * LDP);
  T* q_v = q_u + BM * HD;
  T* ring = q_v + BM * HD;

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int t0 = blockIdx.x * BM;
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int D = H * HD;
  const int kv_len = min(lengths[b], Tn);
  // keys past kv_len carry -1e9 and add exactly 0 once a valid key is seen;
  // an item with no valid key averages all Tn keys, as the reference does
  const int n_keys = kv_len > 0 ? kv_len : Tn;
  const int tiles = (n_keys + BN - 1) / BN;
  const size_t head = (size_t)bh * Tn * HD;
  const T* ph = pos + (size_t)h * HD;

  // band row j of key tile s0 holds P[Tn - BM - t0 + s0 + j]; score (row
  // tr, key ks) reads band row ks - tr + BM - 1
  auto load_tile = [&](int it) {
    T* stage = ring + (it & 1) * STAGE;
    core_copy_rows<T, HD, THREADS>(stage, kh + head, HD, it * BN, BN, Tn, tid);
    core_copy_rows<T, HD, THREADS>(stage + BN * HD, vh + head, HD, it * BN, BN, Tn, tid);
    core_copy_rows<T, HD, THREADS>(stage + 2 * BN * HD, ph, D, Tn - BM - t0 + it * BN, PB, 2 * Tn - 1, tid);
  };
  core_copy_rows<T, HD, THREADS>(q_u, qu + head, HD, t0, BM, Tn, tid);
  core_copy_rows<T, HD, THREADS>(q_v, qv + head, HD, t0, BM, Tn, tid);
  load_tile(0);
  cp_async_commit();

  float acc[4][4 * G], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < 4 * G; ++d) acc[i][d] = 0.f;
  }
  const int band0 = tx * PN - ty * 4 + BM - 4;  // the patch reads band rows band0 .. band0 + PN + 2

  for (int it = 0; it < tiles; ++it) {
    cp_async_wait<0>();
    // tile it has landed for every thread; every thread is done with tile
    // it - 1 (its stage and the probabilities)
    __syncthreads();
    if (it + 1 < tiles) load_tile(it + 1);
    cp_async_commit();
    const T* ks = ring + (it & 1) * STAGE;
    const T* vs = ks + BN * HD;
    const T* pb = vs + BN * HD;

    // scores: content (q_u . k) and position (q_v . P band) over hd in
    // order, 4 values per shared read
    float s[4][PN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < PN; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int e = 0; e < HD; e += 4) {
      float4 a[4], k[PN];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = core_ld4(q_u + core_swz<T, HD>(ty * 4 + i, e));
#pragma unroll
      for (int j = 0; j < PN; ++j) k[j] = core_ld4(ks + core_swz<T, HD>(tx * PN + j, e));
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PN; ++j) {
          s[i][j] = fmaf(a[i].x, k[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, k[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, k[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, k[j].w, s[i][j]);
        }
      float4 band[PN + 3];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = core_ld4(q_v + core_swz<T, HD>(ty * 4 + i, e));
#pragma unroll
      for (int q = 0; q < PN + 3; ++q) band[q] = core_ld4(pb + core_swz<T, HD>(band0 + q, e));
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PN; ++j) {
          const float4 r = band[j - i + 3];
          s[i][j] = fmaf(a[i].x, r.x, s[i][j]);
          s[i][j] = fmaf(a[i].y, r.y, s[i][j]);
          s[i][j] = fmaf(a[i].z, r.z, s[i][j]);
          s[i][j] = fmaf(a[i].w, r.w, s[i][j]);
        }
    }

    // online softmax: the tile's row max over the 8 threads of a row group,
    // the running sums and outputs rescaled, the probabilities to shared
    const int s_base = it * BN + tx * PN;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < PN; ++j) {
        const int key = s_base + j;
        if (key >= n_keys) s[i][j] = -INFINITY;
        else if (key >= kv_len) s[i][j] = -1e9f;
        tmax = fmaxf(tmax, s[i][j]);
      }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 4));
      const float m_new = fmaxf(m[i], tmax);
      const float alpha = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int d = 0; d < 4 * G; ++d) acc[i][d] *= alpha;
      float* prow = ps + (ty * 4 + i) * LDP + tx * PN;
#pragma unroll
      for (int j = 0; j < PN; j += 4) {
        float4 p4;
        p4.x = expf(s[i][j] - m_new);
        p4.y = expf(s[i][j + 1] - m_new);
        p4.z = expf(s[i][j + 2] - m_new);
        p4.w = expf(s[i][j + 3] - m_new);
        l[i] += p4.x + p4.y + p4.z + p4.w;
        *reinterpret_cast<float4*>(prow + j) = p4;
      }
    }
    __syncthreads();  // the tile's probabilities are complete

    // AV: 4 rows x 4G head dims per thread, 4 keys per step; keys at or
    // past n_keys have probability 0 and are skipped in whole steps of 4
    const int lim = min(BN, (n_keys - it * BN + 3) & ~3);
    for (int kk = 0; kk < lim; kk += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = *reinterpret_cast<const float4*>(ps + (ty * 4 + i) * LDP + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          const float4 v = core_ld4(vs + core_swz<T, HD>(kk + q, (tx + 8 * gi) * 4));
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = q == 0 ? pr[i].x : q == 1 ? pr[i].y : q == 2 ? pr[i].z : pr[i].w;
            acc[i][gi * 4 + 0] = fmaf(p, v.x, acc[i][gi * 4 + 0]);
            acc[i][gi * 4 + 1] = fmaf(p, v.y, acc[i][gi * 4 + 1]);
            acc[i][gi * 4 + 2] = fmaf(p, v.z, acc[i][gi * 4 + 2]);
            acc[i][gi * 4 + 3] = fmaf(p, v.w, acc[i][gi * 4 + 3]);
          }
        }
      }
    }
  }

  // normalise after AV: the row sum over the 8 threads of the row group
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    li += __shfl_xor_sync(0xffffffffu, li, 4);
    const int t = t0 + ty * 4 + i;
    if (t >= Tn) continue;
    const float inv = 1.f / li;
    T* o = ctx + ((size_t)b * Tn + t) * D + h * HD;
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int d = 0; d < 4; ++d) st(o + (tx + 8 * gi) * 4 + d, acc[i][gi * 4 + d] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch_attn(const void* qu, const void* qv, const void* kh, const void* vh,
                        const void* pos, const int* lengths, void* ctx, int B, int Tn, int H,
                        cudaStream_t stream) {
  constexpr int smem = core_smem_bytes<T, HD>(), BM = CoreTile<T, HD>::BM;
  static_assert(smem <= 232448, "an H100 block's shared memory");
  cudaError_t err = cudaFuncSetAttribute(rel_attn_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tn + BM - 1) / BM, B * H);
  rel_attn_kernel<T, HD><<<grid, 2 * BM, smem, stream>>>(
      static_cast<const T*>(qu), static_cast<const T*>(qv), static_cast<const T*>(kh),
      static_cast<const T*>(vh), static_cast<const T*>(pos), lengths, static_cast<T*>(ctx),
      Tn, H);
  return cudaGetLastError();
}

// The launch plan (ops/rel_attention.py block_plan, heads_plan): qkv_rows,
// the QKV GEMM's block rows (64, 96 or 128); pos_splits and out_splits, the
// k slices of the position GEMM and the out-projection. D is the model
// width (x's rows); the weights hold H heads of HD (HD = 0: D / H), DL =
// H * HD wide. part holds max(pos_splits * (2T-1) * DL, out_splits * B*T *
// D) f32 partials. With the LayerNorm, its output borrows ctx ((B*T, D))
// until the core writes ctx ((B*T, DL)).
//
// Head-sharded (partial != null): the weights are one 'model' rank's H
// heads of a wider layer (wq, wk, wv, pos_w (DL, D); wo (D, DL)), and the
// out-projection over them, with no bias and no residual, goes to partial
// ((B*T, D) f32, its k slices summed in order, not rounded): the caller sums
// the ranks' partials, then adds the bias and the residual once.
template <typename T>
int run_block(const void* x, const float* ln_w, const float* ln_b, float eps, const void* wq,
              const void* bq, const void* wk, const void* bk, const void* wv, const void* bv,
              const void* bias_u, const void* bias_v, const void* pe, const void* pos_w,
              const void* wo, const void* bo, const int* lengths, float* part, void* qu,
              void* qv, void* kh, void* vh, void* pos, void* ctx, void* out, int B, int Tn,
              int D, int H, int qkv_rows, int pos_splits, int out_splits, cudaStream_t stream,
              int HD = 0, float* partial = nullptr) {
  if (HD == 0) HD = D / H;
  const int M = B * Tn, DL = H * HD;
  if (M == 0) return 0;
  cudaError_t err;
  const void* a = x;
  if (ln_w != nullptr) {
    if ((err = launch_layer_norm_rows<T>(x, ln_w, ln_b, ctx, M, D, eps, stream)) != cudaSuccess)
      return (int)err;
    a = ctx;
  }

  FfnGemmArgs g = {};
  g.a = a;
  g.w[0] = wq; g.w[1] = wk; g.w[2] = wv;
  g.bias[0] = bq; g.bias[1] = bk; g.bias[2] = bv;
  g.out[0] = qu; g.out[1] = qv; g.out[2] = kh; g.out[3] = vh;
  g.bias_u = bias_u; g.bias_v = bias_v;
  g.M = M; g.N = 3 * DL; g.K = D; g.nseg = DL;
  g.T = Tn; g.H = H; g.HD = HD;
  g.scale = 1.f / sqrtf((float)HD);
  // D = H * hd with hd in {32, 64, 128}: rows are 16-byte aligned
  if ((err = launch_tiled_gemm_rows<T, FE_QKV, false>(g, qkv_rows, stream)) != cudaSuccess) return (int)err;

  if ((err = launch_linear<T, false>(pe, pos_w, nullptr, nullptr, pos, part, 2 * Tn - 1, DL, D,
                                     pos_splits, stream)) != cudaSuccess)
    return (int)err;

  switch (HD) {
    case 32: err = launch_attn<T, 32>(qu, qv, kh, vh, pos, lengths, ctx, B, Tn, H, stream); break;
    case 64: err = launch_attn<T, 64>(qu, qv, kh, vh, pos, lengths, ctx, B, Tn, H, stream); break;
    case 128: err = launch_attn<T, 128>(qu, qv, kh, vh, pos, lengths, ctx, B, Tn, H, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;

  if (partial == nullptr)
    return (int)launch_linear<T, false>(ctx, wo, bo, ln_w != nullptr ? x : nullptr, out, part, M, D, D,
                                        out_splits, stream);
  FfnGemmArgs o = {};
  o.a = ctx;
  o.w[0] = wo;
  o.out[0] = part;
  o.M = M; o.N = D; o.K = DL;
  if ((err = launch_tiled_gemm<T, FE_PARTIAL, 128, false>(o, out_splits, stream)) != cudaSuccess) return (int)err;
  // the f32 closing pass: the slices summed in order, nothing added, no rounding
  return (int)launch_gemm_reduce<float>(part, out_splits, nullptr, 1.f, nullptr, nullptr, nullptr, 0.f, partial,
                                        M, D, stream);
}

}  // namespace
