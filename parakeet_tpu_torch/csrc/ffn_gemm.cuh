// The port's one GEMM design, and the pass that closes a split-K product:
// C[M, N] = A[M, K] @ W[N, K]^T (W in torch Linear layout, A's rows lda
// apart) in BM x 128 block tiles (BM = 128, 96 or 64, as the launch plan
// says), k in steps of 32, fed by a ring of shared-memory stages that
// 16-byte cp.async copies fill while the block computes on an earlier
// stage. Every kernel's GEMMs run on it: K6 (fc1, fc2), K1 (QKV, position,
// out-projection), K5 (pw1, pw2), K8 (conv2), K3 (the DFT), and through
// K6, K1 and K5 also K4 and K7.
//
// What bounds it: a GEMM of these shapes is bound by operations (K = 256
// to 2048 against 4-byte elements), so the design keeps the FMA units fed:
// 4 k per shared-memory read and 8 columns per thread put 0.25-0.375
// shared-memory words under each f32 FMA, and the ring hides the device
// memory latency. On an NVIDIA H100 80GB HBM3 at 700 W it ran K6's fc1 at
// 32-36 TFLOP/s in f32 (the CUDA cores' peak is 67).
//
//   f32   IEEE FMA on the CUDA cores (no TF32): 256 threads, BM/16 x 8
//         outputs each (rows ty + 16i, columns tx + 16j), 3 stages of
//         k-contiguous rows padded to 36 floats so that the float4 reads of
//         8 threads fall in 8 distinct bank groups; 4 k per float4 read,
//         0.25 shared-memory words per FMA at BM = 128 (0.29 at 96, 0.375
//         at 64).
//   bf16  tensor cores through mma.sync m16n8k16 (bf16 operands, f32
//         accumulators), fragments read with ldmatrix: 8 warps of BM/2 x 32
//         outputs each, 4 stages of rows padded to 40 values (80 bytes,
//         conflict-free for ldmatrix). The products of bf16 values are
//         exact in f32, as in the plain versions; wgmma is later work.
//
// Each output sums its k in order within its k slice. Epilogues:
//   FE_SILU     + bias, round to T, SiLU with an f32 sigmoid, round (K6 fc1)
//   FE_PARTIAL  the f32 sum of k slice blockIdx.z into part[z] (K6 fc2, K1
//               position and out-projection, K5 pw2; one slice or several)
//   FE_QKV      W is wq | wk | wv: + the segment's bias; q is scaled by
//               1/sqrt(hd) and rounded, and the u/v biases are scaled and
//               rounded, as the reference kernel does; qu, qv, k and v are
//               stored head-major (B, H, T, hd) (K1)
//   FE_GLU      W is W1 (2D rows: a, then g). The loader maps tile rows to
//               W1 rows so that one thread holds a_j and g_j: in the f32
//               layout tile rows 0-63 are the a rows of 64 outputs and rows
//               64-127 their g rows (a thread's columns j and j + 4); in the
//               bf16 layout a and g alternate (the accumulator pairs e, e+1).
//               round(a + b_a), round(g + b_g), round(a * sigmoid(g)); rows
//               at or past min(len_b, T) are written as 0 (K5 pw1)
//   FE_ACT_NCHW + bias, ReLU or SiLU (act), rounded once to T, stored
//               channel-major (B, N, T) with T rows per item (K8 conv2). A
//               warp's accumulators span 16 channels, so the block's tile
//               goes through the ring's shared memory (free after the last
//               k step) and each warp then stores 32 consecutive positions
//               of one channel
//   FE_POWER    f32 only. W holds 64 cos rows then their 64 sin rows per
//               128-column tile (the same pairing as FE_GLU's f32 loader,
//               laid out by the caller), so a thread holds re and im of
//               bin n0/2 + c in columns j and j + 4: re*re + im*im, each
//               product and the sum rounded on its own, into (M, nseg) (K3)
// gemm_reduce_kernel then sums the slices in a fixed order, adds the bias,
// forms round(x + c * y) (or round(y) without a residual) and applies the
// optional final LayerNorm.
//
// Rows and columns past M and N, and k past K, are zero-filled on load and
// not stored. When K * sizeof(T) or lda * sizeof(T) is not a multiple of 16
// the rows are not 16-byte aligned, and the same tiles are loaded element
// by element.
#pragma once

#include "async_copy.cuh"
#include "gemm.cuh"

namespace {

constexpr int FBN = 128, FBK = 32, FFN_THREADS = 256;
constexpr int F32_STAGES = 3, F32_LDS = FBK + 4;    // floats per shared row
constexpr int BF16_STAGES = 4, BF16_LDS = FBK + 8;  // bf16 values per shared row
// shared memory per block (BM = 128, 96, 64): f32 110,592 / 96,768 / 82,944 B;
// bf16 81,920 / 71,680 / 61,440 B
template <typename T, int BM>
__host__ __device__ constexpr int tiled_gemm_smem() {
  return sizeof(T) == 4 ? F32_STAGES * (BM + FBN) * F32_LDS * 4 : BF16_STAGES * (BM + FBN) * BF16_LDS * 2;
}
constexpr int FE_SILU = 0, FE_PARTIAL = 1, FE_QKV = 2, FE_GLU = 3, FE_ACT_NCHW = 4, FE_POWER = 5;
constexpr int ACT_RELU = 0, ACT_SILU = 1;  // FE_ACT_NCHW's act
// FE_ACT_NCHW's channel-major tile: 128 channels of BM + 2 floats, a row
// stride = 2 (mod 32) so that the f32 layout's stores miss each other's banks
template <int BM>
__host__ __device__ constexpr int nchw_ld() { return BM + 2; }

struct FfnGemmArgs {
  const void* a;         // (M, K) with rows lda apart, activation dtype
  const void* w[3];      // weight segments of nseg rows each, (nseg, K); FE_GLU: w[0] = W1
  const void* bias[3];   // per-segment bias (nseg,); FE_GLU: bias[0] = b1 (2 nseg,)
  void* out[4];          // FE_PARTIAL: (splits, M, N) f32; FE_QKV: qu, qv, k, v (B, H, T, hd);
                         // FE_GLU, FE_POWER: (M, nseg); FE_ACT_NCHW: (B, N, T); otherwise (M, N)
  const void* bias_u;    // FE_QKV: (D,)
  const void* bias_v;
  const int* lengths;    // FE_GLU: (B,) valid rows per item
  int M, N, K;
  int lda;               // A's row stride in elements (0: K). K3's DFT reads
                         // overlapping frames straight from the waveform
  int nseg;              // rows per weight segment (0: one segment of N rows);
                         // FE_POWER: bins stored per row
  int T, H, HD;          // FE_QKV, FE_GLU, FE_ACT_NCHW: rows per item; FE_QKV: heads, head dim
  int act;               // FE_ACT_NCHW: ACT_RELU or ACT_SILU
  float scale;           // FE_QKV: 1 / sqrt(hd)
  int steps;             // k steps of FBK per k slice
};

// Tile row r of the W tile whose first GEMM column is n0, or null past the
// edge. FE_GLU's N counts W1's rows (2 nseg); its tile covers outputs n0/2
// .. n0/2 + 63. FE_QKV's three segments are told apart by comparisons, the
// one-segment epilogues need none: the loader's cost stays a multiply-add.
template <typename T, int EPI>
__device__ __forceinline__ const T* w_row(const FfnGemmArgs& g, int n0, int r) {
  if constexpr (EPI == FE_GLU) {
    const bool f32 = sizeof(T) == 4;
    const int gate = f32 ? (r >= FBN / 2) : (r & 1);
    const int o = (n0 >> 1) + (f32 ? r - gate * (FBN / 2) : r >> 1);
    if (o >= g.nseg) return nullptr;
    return static_cast<const T*>(g.w[0]) + ((size_t)gate * g.nseg + o) * g.K;
  } else if constexpr (EPI == FE_QKV) {
    const int n = n0 + r;
    if (n >= g.N) return nullptr;
    const int seg = (n >= g.nseg) + (n >= 2 * g.nseg);
    return static_cast<const T*>(g.w[seg]) + (size_t)(n - seg * g.nseg) * g.K;
  } else {
    const int n = n0 + r;
    return n < g.N ? static_cast<const T*>(g.w[0]) + (size_t)n * g.K : nullptr;
  }
}

// Tile rows [0, ROWS) and k [k0, k0 + FBK) into a shared tile of rows LD
// apart; row(r) gives the source row or null (zero-filled), as does k >= K.
// any: a valid device address for the copies that write zeros.
template <typename T, int ROWS, int LD, bool VEC, typename RowFn>
__device__ __forceinline__ void gemm_load_tile(T* s, RowFn row, int K, int k0, int tid, const T* any) {
  constexpr int CH = 16 / (int)sizeof(T), CPR = FBK / CH, N = ROWS * CPR;
#pragma unroll
  for (int i = 0; i < (N + FFN_THREADS - 1) / FFN_THREADS; ++i) {
    const int c = tid + i * FFN_THREADS;
    if (N % FFN_THREADS != 0 && c >= N) break;  // bf16 96-row tiles: 1.5 chunks per thread
    const int r = c / CPR, kc = (c - r * CPR) * CH;
    const int gk = k0 + kc;
    const T* src = row(r);
    T* dst = s + r * LD + kc;
    if constexpr (VEC) {
      const bool ok = src != nullptr && gk < K;  // K is a multiple of CH: all or nothing
      cp_async16(dst, ok ? src + gk : any, ok);
    } else {
#pragma unroll
      for (int e = 0; e < CH; ++e) st(dst + e, (src != nullptr && gk + e < K) ? ld(src + gk + e) : 0.f);
    }
  }
}

template <typename T, int EPI>
__device__ __forceinline__ void gemm_store(const FfnGemmArgs& g, int m, int n, float acc) {
  if (m >= g.M || n >= g.N) return;
  if constexpr (EPI == FE_SILU) {
    const float h = round_to<T>(acc + ld(static_cast<const T*>(g.bias[0]) + n));
    st(static_cast<T*>(g.out[0]) + (size_t)m * g.N + n, h * sigmoid_f32(h));
  } else if constexpr (EPI == FE_PARTIAL) {
    static_cast<float*>(g.out[0])[((size_t)blockIdx.z * g.M + m) * g.N + n] = acc;
  } else if constexpr (EPI == FE_QKV) {
    const int seg = (n >= g.nseg) + (n >= 2 * g.nseg), nn = n - seg * g.nseg;
    const float v = acc + ld(static_cast<const T*>(g.bias[seg]) + nn);
    const int b = m / g.T, t = m - b * g.T;
    const int h = nn / g.HD, c = nn - h * g.HD;
    const size_t o = (((size_t)b * g.H + h) * g.T + t) * g.HD + c;
    if (seg == 0) {
      const float qs = round_to<T>(v * g.scale);
      const float us = round_to<T>(ld(static_cast<const T*>(g.bias_u) + nn) * g.scale);
      const float vs = round_to<T>(ld(static_cast<const T*>(g.bias_v) + nn) * g.scale);
      st(static_cast<T*>(g.out[0]) + o, qs + us);
      st(static_cast<T*>(g.out[1]) + o, qs + vs);
    } else {
      st(static_cast<T*>(g.out[seg + 1]) + o, v);
    }
  }
}

// FE_ACT_NCHW: the tile's output at tile row ml, column nl into the
// channel-major staging tile (bias and activation in f32, rounded at the
// store)
template <typename T, int BM>
__device__ __forceinline__ void nchw_stage(const FfnGemmArgs& g, float* stage, int n0, int ml, int nl,
                                           float acc) {
  float v = 0.f;
  if (n0 + nl < g.N) {
    v = acc + ld(static_cast<const T*>(g.bias[0]) + n0 + nl);
    v = g.act == ACT_RELU ? fmaxf(v, 0.f) : v * sigmoid_f32(v);
  }
  stage[nl * nchw_ld<BM>() + ml] = v;
}

// FE_ACT_NCHW: the staged tile to (B, N, T), consecutive threads on
// consecutive positions of one channel; a tile may straddle items
template <typename T, int BM>
__device__ __forceinline__ void nchw_store(const FfnGemmArgs& g, const float* stage, int m0, int n0,
                                           int tid) {
  const int b0 = m0 / g.T, r0 = m0 - b0 * g.T;
  T* out = static_cast<T*>(g.out[0]);
  for (int i = tid; i < FBN * BM; i += FFN_THREADS) {
    const int nl = i / BM, ml = i - nl * BM;
    if (m0 + ml >= g.M || n0 + nl >= g.N) continue;
    int b = b0, r = r0 + ml;
    while (r >= g.T) {
      r -= g.T;
      ++b;
    }
    st(out + ((size_t)b * g.N + n0 + nl) * g.T + r, stage[nl * nchw_ld<BM>() + ml]);
  }
}

// FE_GLU: output column o of row m from its a and g sums
template <typename T>
__device__ __forceinline__ void glu_store(const FfnGemmArgs& g, int m, int o, float a, float gt) {
  if (m >= g.M || o >= g.nseg) return;
  const int b = m / g.T, t = m - b * g.T;
  float v = 0.f;
  if (t < min(g.lengths[b], g.T)) {
    const T* b1 = static_cast<const T*>(g.bias[0]);
    const float av = round_to<T>(a + ld(b1 + o));
    const float gv = round_to<T>(gt + ld(b1 + g.nseg + o));
    v = av * sigmoid_f32(gv);
  }
  st(static_cast<T*>(g.out[0]) + (size_t)m * g.nseg + o, v);
}

// ─── f32: BM/16 x 8 outputs per thread on the CUDA cores ────────────────────

template <int EPI, int BM, bool VEC>
__global__ void __launch_bounds__(FFN_THREADS, 1) ffn_gemm_f32_kernel(FfnGemmArgs g) {
  constexpr int MI = BM / 16;
  extern __shared__ __align__(16) unsigned char ffn_smem[];
  float* smem = reinterpret_cast<float*>(ffn_smem);
  const float* A = static_cast<const float*>(g.a);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * FBN;
  const int step0 = blockIdx.z * g.steps;
  const int nsteps = min(g.steps, (g.K + FBK - 1) / FBK - step0);
  auto a_row = [&](int r) -> const float* { return m0 + r < g.M ? A + (size_t)(m0 + r) * g.lda : nullptr; };
  auto b_row = [&](int r) { return w_row<float, EPI>(g, n0, r); };

  auto a_tile = [&](int stage) { return smem + stage * (BM + FBN) * F32_LDS; };
  auto load = [&](int step) {
    float* s = a_tile(step % F32_STAGES);
    const int k0 = (step0 + step) * FBK;
    gemm_load_tile<float, BM, F32_LDS, VEC>(s, a_row, g.K, k0, tid, A);
    gemm_load_tile<float, FBN, F32_LDS, VEC>(s + BM * F32_LDS, b_row, g.K, k0, tid, A);
  };

  float acc[MI][8];
#pragma unroll
  for (int i = 0; i < MI; ++i)
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
    const float* ws = as + BM * F32_LDS;
#pragma unroll
    for (int kq = 0; kq < FBK; kq += 4) {
      float a[MI][4], w[8][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
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
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i][e], w[j][e], acc[i][j]);
    }
  }

  if constexpr (EPI == FE_ACT_NCHW) {
    static_assert(FBN * nchw_ld<BM>() * 4 <= tiled_gemm_smem<float, BM>(), "staging tile fits the ring");
    cp_async_wait<0>();
    __syncthreads();  // every thread is past its last read of the ring
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) nchw_stage<float, BM>(g, smem, n0, ty + 16 * i, tx + 16 * j, acc[i][j]);
    __syncthreads();
    nchw_store<float, BM>(g, smem, m0, n0, tid);
  } else {
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int m = m0 + ty + 16 * i;
      if constexpr (EPI == FE_GLU) {
#pragma unroll
        for (int j = 0; j < 4; ++j) glu_store<float>(g, m, (n0 >> 1) + tx + 16 * j, acc[i][j], acc[i][j + 4]);
      } else if constexpr (EPI == FE_POWER) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int bin = (n0 >> 1) + tx + 16 * j;
          if (m >= g.M || bin >= g.nseg) continue;
          const float re = acc[i][j], im = acc[i][j + 4];
          static_cast<float*>(g.out[0])[(size_t)m * g.nseg + bin] =
              __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) gemm_store<float, EPI>(g, m, n0 + tx + 16 * j, acc[i][j]);
      }
    }
  }
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

template <int EPI, int BM, bool VEC>
__global__ void __launch_bounds__(FFN_THREADS) ffn_gemm_bf16_kernel(FfnGemmArgs g) {
  static_assert(EPI != FE_POWER, "FE_POWER is f32 only");
  using bf16 = __nv_bfloat16;
  constexpr int MT = BM / 32;  // m16 tiles per warp
  extern __shared__ __align__(16) unsigned char ffn_smem[];
  bf16* smem = reinterpret_cast<bf16*>(ffn_smem);
  const bf16* A = static_cast<const bf16*>(g.a);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;  // 2 x 4 warps of BM/2 x 32 outputs
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * FBN;
  const int step0 = blockIdx.z * g.steps;
  const int nsteps = min(g.steps, (g.K + FBK - 1) / FBK - step0);
  auto a_row = [&](int r) -> const bf16* { return m0 + r < g.M ? A + (size_t)(m0 + r) * g.lda : nullptr; };
  auto b_row = [&](int r) { return w_row<bf16, EPI>(g, n0, r); };

  auto a_tile = [&](int stage) { return smem + stage * (BM + FBN) * BF16_LDS; };
  auto load = [&](int step) {
    bf16* s = a_tile(step % BF16_STAGES);
    const int k0 = (step0 + step) * FBK;
    gemm_load_tile<bf16, BM, BF16_LDS, VEC>(s, a_row, g.K, k0, tid, A);
    gemm_load_tile<bf16, FBN, BF16_LDS, VEC>(s + BM * BF16_LDS, b_row, g.K, k0, tid, A);
  };

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
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
    const bf16* ws = as + BM * BF16_LDS;
#pragma unroll
    for (int kk = 0; kk < FBK; kk += 16) {
      // A: lanes 0-15 address rows 0-15 at k, lanes 16-31 the same rows at
      // k + 8 (fragments a0..a3). W: lanes 0-7 and 8-15 address n rows 0-7
      // at k and k + 8, lanes 16-31 rows 8-15 (b0, b1 of two n8 tiles).
      uint32_t af[MT][4], bfr[2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(af[mt], as + (wm * (BM / 2) + mt * 16 + (lane & 15)) * BF16_LDS + kk + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldmatrix_x4(bfr[np], ws + (wn * 32 + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * BF16_LDS +
                                 kk + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16_16816(acc[mt][nt], af[mt], bfr[nt >> 1][(nt & 1) * 2], bfr[nt >> 1][(nt & 1) * 2 + 1]);
    }
  }

  // accumulator e of tile (mt, nt): row lane/4 (+8 for e >= 2), column 2*(lane%4) + e%2
  if constexpr (EPI == FE_ACT_NCHW) {
    static_assert(FBN * nchw_ld<BM>() * 4 <= tiled_gemm_smem<bf16, BM>(), "staging tile fits the ring");
    float* stage = reinterpret_cast<float*>(ffn_smem);
    cp_async_wait<0>();
    __syncthreads();  // every thread is past its last read of the ring
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          nchw_stage<bf16, BM>(g, stage, n0, wm * (BM / 2) + mt * 16 + (lane >> 2) + (e >> 1) * 8,
                               wn * 32 + nt * 8 + (lane & 3) * 2 + (e & 1), acc[mt][nt][e]);
    __syncthreads();
    nchw_store<bf16, BM>(g, stage, m0, n0, tid);
  } else {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + wm * (BM / 2) + mt * 16 + (lane >> 2) + (e >> 1) * 8;
          const int n = n0 + wn * 32 + nt * 8 + (lane & 3) * 2 + (e & 1);
          if constexpr (EPI == FE_GLU) {
            // columns n (even: a) and n + 1 (odd: g) are output n / 2
            if ((e & 1) == 0) glu_store<bf16>(g, m, n >> 1, acc[mt][nt][e], acc[mt][nt][e + 1]);
          } else {
            gemm_store<bf16, EPI>(g, m, n, acc[mt][nt][e]);
          }
        }
  }
}

template <typename T, int EPI, int BM, bool VEC>
cudaError_t start_ffn_gemm(const FfnGemmArgs& g, dim3 grid, cudaStream_t stream) {
  constexpr int smem = tiled_gemm_smem<T, BM>();
  if constexpr (sizeof(T) == 4) {
    auto kernel = ffn_gemm_f32_kernel<EPI, BM, VEC>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, FFN_THREADS, smem, stream>>>(g);
  } else {
    auto kernel = ffn_gemm_bf16_kernel<EPI, BM, VEC>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, FFN_THREADS, smem, stream>>>(g);
  }
  return cudaGetLastError();
}

// C = A @ W^T in BM-row tiles with k cut into `splits` slices of whole k
// steps (blockIdx.z; splits > 1 only with FE_PARTIAL); splits must divide
// the k steps. ANY_K = false leaves out the element-wise loader for callers
// whose K and lda times sizeof(T) are always multiples of 16 (and refuses
// others).
template <typename T, int EPI, int BM, bool ANY_K = true>
cudaError_t launch_tiled_gemm(FfnGemmArgs g, int splits, cudaStream_t stream) {
  static_assert(BM == 64 || BM == 96 || BM == 128, "block tiles of 64, 96 or 128 rows");
  const int steps = (g.K + FBK - 1) / FBK;
  if (splits < 1 || steps % splits != 0 || (splits > 1 && EPI != FE_PARTIAL)) return cudaErrorInvalidValue;
  if (g.nseg == 0) g.nseg = g.N;
  if (g.lda == 0) g.lda = g.K;
  g.steps = steps / splits;
  const dim3 grid((g.N + FBN - 1) / FBN, (g.M + BM - 1) / BM, splits);
  if ((g.K * (int)sizeof(T)) % 16 == 0 && (g.lda * (int)sizeof(T)) % 16 == 0)
    return start_ffn_gemm<T, EPI, BM, true>(g, grid, stream);
  if constexpr (ANY_K) return start_ffn_gemm<T, EPI, BM, false>(g, grid, stream);
  return cudaErrorInvalidValue;
}

// ─── The closing pass of a split product: one block of 128 threads per row ──
// out = round(x + c * (sum_z part[z] + b)), the slices summed in order
// z = 0, 1, ...; round(sum + b) when x is null; b = 0 when null. Then, when
// fw is given, out = round(LN(out)) with f32 statistics over the rounded
// row. A pass over the partials is bound by how many loads are in flight,
// so each row gets a block of 128 threads (at B=8, T'=126 all 1,008 blocks
// are resident at once) and each thread issues its slices' loads ahead of
// the in-order adds.

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
__global__ void __launch_bounds__(REDUCE_THREADS) gemm_reduce_kernel(
    const float* __restrict__ part, int splits, const T* __restrict__ x, float coef,
    const T* __restrict__ b2, const float* __restrict__ fw, const float* __restrict__ fb, float eps,
    T* __restrict__ out, int M, int D) {
  __shared__ float red[REDUCE_THREADS / 32];
  const size_t slice = (size_t)M * D, r0 = (size_t)blockIdx.x * D;
  T* o = out + r0;
  float s = 0.f;
  for (int c = threadIdx.x; c < D; c += REDUCE_THREADS) {
    const float* pz = part + r0 + c;
    float y = 0.f;
#pragma unroll 4
    for (int z = 0; z < splits; ++z) y += pz[z * slice];
    if (b2 != nullptr) y += ld(b2 + c);
    const float v = round_to<T>(x != nullptr ? ld(x + r0 + c) + coef * y : y);
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
cudaError_t launch_gemm_reduce(const float* part, int splits, const void* x, float coef,
                               const void* b2, const float* fw, const float* fb, float eps, void* out,
                               int M, int D, cudaStream_t stream) {
  if (M == 0) return cudaSuccess;
  gemm_reduce_kernel<T><<<M, REDUCE_THREADS, 0, stream>>>(
      part, splits, static_cast<const T*>(x), coef, static_cast<const T*>(b2), fw, fb, eps,
      static_cast<T*>(out), M, D);
  return cudaGetLastError();
}

// A GEMM on the plan's block rows: no split with a nonlinear epilogue.
template <typename T, int EPI, bool ANY_K = true>
cudaError_t launch_tiled_gemm_rows(const FfnGemmArgs& g, int rows, cudaStream_t stream, int splits = 1) {
  switch (rows) {
    case 64: return launch_tiled_gemm<T, EPI, 64, ANY_K>(g, splits, stream);
    case 96: return launch_tiled_gemm<T, EPI, 96, ANY_K>(g, splits, stream);
    case 128: return launch_tiled_gemm<T, EPI, 128, ANY_K>(g, splits, stream);
    default: return cudaErrorInvalidValue;
  }
}

// A GEMM whose epilogue is linear, on 128-row tiles: the f32 sums of its
// `splits` k slices into part (splits, M, N), then the closing pass, which
// rounds x + (y + b) once (y + b without x; no b when null). One slice
// takes the same two launches, so every plan runs one path.
template <typename T, bool ANY_K = true>
cudaError_t launch_linear(const void* a, const void* w, const void* bias, const void* residual,
                          void* out, float* part, int M, int N, int K, int splits, cudaStream_t stream) {
  if (M == 0) return cudaSuccess;
  FfnGemmArgs g = {};
  g.a = a;
  g.w[0] = w;
  g.out[0] = part;
  g.M = M; g.N = N; g.K = K;
  cudaError_t err = launch_tiled_gemm<T, FE_PARTIAL, 128, ANY_K>(g, splits, stream);
  if (err != cudaSuccess) return err;
  return launch_gemm_reduce<T>(part, splits, residual, 1.f, bias, nullptr, nullptr, 0.f, out, M, N, stream);
}

}  // namespace
