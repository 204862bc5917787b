// The GEMMs of K6, the fused feed-forward (see feed_forward.cu), and the
// pass that closes it: C[M, N] = A[M, K] @ W[N, K]^T (W in torch Linear
// layout) in 128x128 block tiles, k in steps of 32, fed by a ring of
// shared-memory stages that 16-byte cp.async copies fill while the block
// computes on an earlier stage.
//
//   f32   IEEE FMA on the CUDA cores (no TF32): 256 threads, 8x8 outputs
//         each (rows ty + 16i, columns tx + 16j), 3 stages of k-contiguous
//         rows padded to 36 floats so that the float4 reads of 8 threads
//         fall in 8 distinct bank groups; 4 k per float4 read, 0.25
//         shared-memory words per FMA.
//   bf16  tensor cores through mma.sync m16n8k16 (bf16 operands, f32
//         accumulators), fragments read with ldmatrix: 8 warps of 64x32
//         outputs each, 4 stages of rows padded to 40 values (80 bytes,
//         conflict-free for ldmatrix). The products of bf16 values are
//         exact in f32, as in the plain version; wgmma is later work.
//
// Each output sums its k in order within its k slice. Epilogues:
//   FE_SILU     + bias, round to T, SiLU with an f32 sigmoid, round (fc1)
//   FE_PARTIAL  the f32 sum of k slice blockIdx.z into part[z] (fc2)
// ffn_reduce_kernel then sums fc2's slices in a fixed order, adds b2,
// forms round(x + 0.5 * y) and applies the optional final LayerNorm.
//
// Rows and columns past M and N, and k past K, are zero-filled on load and
// not stored. When K * sizeof(T) is not a multiple of 16 the rows are not
// 16-byte aligned, and the same tiles are loaded element by element.
#pragma once

#include "async_copy.cuh"
#include "gemm.cuh"

namespace {

constexpr int FBM = 128, FBN = 128, FBK = 32, FFN_THREADS = 256;
constexpr int F32_STAGES = 3, F32_LDS = FBK + 4;    // floats per shared row
constexpr int BF16_STAGES = 4, BF16_LDS = FBK + 8;  // bf16 values per shared row
constexpr int F32_GEMM_SMEM = F32_STAGES * (FBM + FBN) * F32_LDS * 4;     // 110,592 B
constexpr int BF16_GEMM_SMEM = BF16_STAGES * (FBM + FBN) * BF16_LDS * 2;  // 81,920 B
constexpr int FE_SILU = 0, FE_PARTIAL = 1;

struct FfnGemmArgs {
  const void* a;     // (M, K), activation dtype
  const void* w;     // (N, K)
  const void* bias;  // (N,) FE_SILU
  void* out;         // FE_SILU: (M, N) activation dtype; FE_PARTIAL: (splits, M, N) f32
  int M, N, K;
  int steps;         // k steps of FBK per k slice
};

// Rows [r0, r0 + ROWS) and k [k0, k0 + FBK) of X (R x K, row-major) into a
// shared tile of ROWS rows LD apart, zero past R and K.
template <typename T, int ROWS, int LD, bool VEC>
__device__ __forceinline__ void ffn_load_tile(T* s, const T* X, int R, int K, int r0, int k0,
                                              int tid) {
  constexpr int CH = 16 / (int)sizeof(T), CPR = FBK / CH, N = ROWS * CPR;
  static_assert(N % FFN_THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < N / FFN_THREADS; ++i) {
    const int c = tid + i * FFN_THREADS;
    const int r = c / CPR, kc = (c - r * CPR) * CH;
    const int gr = r0 + r, gk = k0 + kc;
    T* dst = s + r * LD + kc;
    if constexpr (VEC) {
      const bool ok = gr < R && gk < K;  // K is a multiple of CH: all or nothing
      cp_async16(dst, ok ? X + (size_t)gr * K + gk : X, ok);
    } else {
#pragma unroll
      for (int e = 0; e < CH; ++e)
        st(dst + e, (gr < R && gk + e < K) ? ld(X + (size_t)gr * K + gk + e) : 0.f);
    }
  }
}

template <typename T, int EPI>
__device__ __forceinline__ void ffn_store(const FfnGemmArgs& g, int m, int n, float acc) {
  if (m >= g.M || n >= g.N) return;
  if constexpr (EPI == FE_SILU) {
    const float h = round_to<T>(acc + ld(static_cast<const T*>(g.bias) + n));
    st(static_cast<T*>(g.out) + (size_t)m * g.N + n, h * sigmoid_f32(h));
  } else {
    static_cast<float*>(g.out)[((size_t)blockIdx.z * g.M + m) * g.N + n] = acc;
  }
}

// ─── f32: 8x8 outputs per thread on the CUDA cores ─────────────────────────

template <int EPI, bool VEC>
__global__ void __launch_bounds__(FFN_THREADS, 1) ffn_gemm_f32_kernel(FfnGemmArgs g) {
  extern __shared__ __align__(16) unsigned char ffn_smem[];
  float* smem = reinterpret_cast<float*>(ffn_smem);
  const float* A = static_cast<const float*>(g.a);
  const float* W = static_cast<const float*>(g.w);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * FBM, n0 = blockIdx.x * FBN;
  const int step0 = blockIdx.z * g.steps;
  const int nsteps = min(g.steps, (g.K + FBK - 1) / FBK - step0);

  auto a_tile = [&](int stage) { return smem + stage * (FBM + FBN) * F32_LDS; };
  auto load = [&](int step) {
    float* s = a_tile(step % F32_STAGES);
    const int k0 = (step0 + step) * FBK;
    ffn_load_tile<float, FBM, F32_LDS, VEC>(s, A, g.M, g.K, m0, k0, tid);
    ffn_load_tile<float, FBN, F32_LDS, VEC>(s + FBM * F32_LDS, W, g.N, g.K, n0, k0, tid);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < F32_STAGES - 1; ++s) {
    if (s < nsteps) load(s);
    cp_async_commit();
  }
  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<F32_STAGES - 2>();
    // tile `step` has landed for every thread, and the stage refilled
    // below was last read in the previous iteration, before this barrier
    __syncthreads();
    if (step + F32_STAGES - 1 < nsteps) load(step + F32_STAGES - 1);
    cp_async_commit();
    const float* as = a_tile(step % F32_STAGES);
    const float* ws = as + FBM * F32_LDS;
#pragma unroll
    for (int kq = 0; kq < FBK; kq += 4) {
      float a[8][4], w[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(as + (ty + 16 * i) * F32_LDS + kq);
        a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(ws + (tx + 16 * j) * F32_LDS + kq);
        w[j][0] = v.x; w[j][1] = v.y; w[j][2] = v.z; w[j][3] = v.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i][e], w[j][e], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) ffn_store<float, EPI>(g, m0 + ty + 16 * i, n0 + tx + 16 * j, acc[i][j]);
}

// ─── bf16: mma.sync m16n8k16 on the tensor cores ───────────────────────────

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int EPI, bool VEC>
__global__ void __launch_bounds__(FFN_THREADS) ffn_gemm_bf16_kernel(FfnGemmArgs g) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char ffn_smem[];
  bf16* smem = reinterpret_cast<bf16*>(ffn_smem);
  const bf16* A = static_cast<const bf16*>(g.a);
  const bf16* W = static_cast<const bf16*>(g.w);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;  // 2 x 4 warps of 64 x 32 outputs
  const int m0 = blockIdx.y * FBM, n0 = blockIdx.x * FBN;
  const int step0 = blockIdx.z * g.steps;
  const int nsteps = min(g.steps, (g.K + FBK - 1) / FBK - step0);

  auto a_tile = [&](int stage) { return smem + stage * (FBM + FBN) * BF16_LDS; };
  auto load = [&](int step) {
    bf16* s = a_tile(step % BF16_STAGES);
    const int k0 = (step0 + step) * FBK;
    ffn_load_tile<bf16, FBM, BF16_LDS, VEC>(s, A, g.M, g.K, m0, k0, tid);
    ffn_load_tile<bf16, FBN, BF16_LDS, VEC>(s + FBM * BF16_LDS, W, g.N, g.K, n0, k0, tid);
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < BF16_STAGES - 1; ++s) {
    if (s < nsteps) load(s);
    cp_async_commit();
  }
  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<BF16_STAGES - 2>();
    __syncthreads();
    if (step + BF16_STAGES - 1 < nsteps) load(step + BF16_STAGES - 1);
    cp_async_commit();
    const bf16* as = a_tile(step % BF16_STAGES);
    const bf16* ws = as + FBM * BF16_LDS;
#pragma unroll
    for (int kk = 0; kk < FBK; kk += 16) {
      // A: lanes 0-15 address rows 0-15 at k, lanes 16-31 the same rows at
      // k + 8 (fragments a0..a3). W: lanes 0-7 and 8-15 address n rows 0-7
      // at k and k + 8, lanes 16-31 rows 8-15 (b0, b1 of two n8 tiles).
      uint32_t af[4][4], bfr[2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(af[mt], as + (wm * 64 + mt * 16 + (lane & 15)) * BF16_LDS + kk + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldmatrix_x4(bfr[np], ws + (wn * 32 + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * BF16_LDS +
                                 kk + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16_16816(acc[mt][nt], af[mt], bfr[nt >> 1][(nt & 1) * 2], bfr[nt >> 1][(nt & 1) * 2 + 1]);
    }
  }

  // accumulator e of tile (mt, nt): row lane/4 (+8 for e >= 2), column 2*(lane%4) + e%2
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ffn_store<bf16, EPI>(g, m0 + wm * 64 + mt * 16 + (lane >> 2) + (e >> 1) * 8,
                             n0 + wn * 32 + nt * 8 + (lane & 3) * 2 + (e & 1), acc[mt][nt][e]);
}

template <typename T, int EPI, bool VEC>
cudaError_t start_ffn_gemm(const FfnGemmArgs& g, dim3 grid, cudaStream_t stream) {
  if constexpr (sizeof(T) == 4) {
    auto kernel = ffn_gemm_f32_kernel<EPI, VEC>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F32_GEMM_SMEM);
    if (err != cudaSuccess) return err;
    kernel<<<grid, FFN_THREADS, F32_GEMM_SMEM, stream>>>(g);
  } else {
    auto kernel = ffn_gemm_bf16_kernel<EPI, VEC>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BF16_GEMM_SMEM);
    if (err != cudaSuccess) return err;
    kernel<<<grid, FFN_THREADS, BF16_GEMM_SMEM, stream>>>(g);
  }
  return cudaGetLastError();
}

// C = A @ W^T with k cut into `splits` slices of whole k steps (blockIdx.z);
// splits must divide the k steps.
template <typename T, int EPI>
cudaError_t launch_ffn_gemm(FfnGemmArgs g, int splits, cudaStream_t stream) {
  const int steps = (g.K + FBK - 1) / FBK;
  if (splits < 1 || steps % splits != 0) return cudaErrorInvalidValue;
  g.steps = steps / splits;
  const dim3 grid((g.N + FBN - 1) / FBN, (g.M + FBM - 1) / FBM, splits);
  if ((g.K * (int)sizeof(T)) % 16 == 0) return start_ffn_gemm<T, EPI, true>(g, grid, stream);
  return start_ffn_gemm<T, EPI, false>(g, grid, stream);
}

// ─── fc2's closing pass: one block of 128 threads per row ──────────────────
// out = round(x + 0.5 * (sum_z part[z] + b2)), the slices summed in order
// z = 0, 1, ...; then, when fw is given, out = round(LN(out)) with f32
// statistics over the rounded row. A pass over the partials is bound by
// how many loads are in flight, so each row gets a block of 128 threads
// (at B=8, T'=126 all 1,008 blocks are resident at once) and each thread
// issues its slices' loads ahead of the in-order adds.

constexpr int REDUCE_THREADS = 128;

__device__ __forceinline__ float block_sum(float v, float* red) {
  constexpr int WARPS = REDUCE_THREADS / 32;
  v = warp_sum(v);
  __syncthreads();  // red is free (the previous sum has been read)
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += red[w];
  return s;
}

template <typename T>
__global__ void __launch_bounds__(REDUCE_THREADS) ffn_reduce_kernel(
    const float* __restrict__ part, int splits, const T* __restrict__ x, const T* __restrict__ b2,
    const float* __restrict__ fw, const float* __restrict__ fb, float eps, T* __restrict__ out,
    int M, int D) {
  __shared__ float red[REDUCE_THREADS / 32];
  const size_t slice = (size_t)M * D, r0 = (size_t)blockIdx.x * D;
  T* o = out + r0;
  float s = 0.f;
  for (int c = threadIdx.x; c < D; c += REDUCE_THREADS) {
    const float* pz = part + r0 + c;
    float y = 0.f;
#pragma unroll 4
    for (int z = 0; z < splits; ++z) y += pz[z * slice];
    const float v = round_to<T>(ld(x + r0 + c) + 0.5f * (y + ld(b2 + c)));
    st(o + c, v);
    s += v;
  }
  if (fw == nullptr) return;
  // each thread reads back only the values it wrote
  const float mean = block_sum(s, red) / (float)D;
  float v = 0.f;
  for (int c = threadIdx.x; c < D; c += REDUCE_THREADS) {
    const float d = ld(o + c) - mean;
    v += d * d;
  }
  const float rstd = 1.f / sqrtf(block_sum(v, red) / (float)D + eps);
  for (int c = threadIdx.x; c < D; c += REDUCE_THREADS)
    st(o + c, (ld(o + c) - mean) * rstd * fw[c] + fb[c]);
}

template <typename T>
cudaError_t launch_ffn_reduce(const float* part, int splits, const void* x, const void* b2,
                              const float* fw, const float* fb, float eps, void* out, int M, int D,
                              cudaStream_t stream) {
  ffn_reduce_kernel<T><<<M, REDUCE_THREADS, 0, stream>>>(
      part, splits, static_cast<const T*>(x), static_cast<const T*>(b2), fw, fb, eps,
      static_cast<T*>(out), M, D);
  return cudaGetLastError();
}

}  // namespace
