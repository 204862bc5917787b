// The port's one GEMM header, with two designs selected per launch. The
// tiled GEMM and the pass that closes a split-K product (this part):
// C[M, N] = A[M, K] @ W[N, K]^T (W in torch Linear layout, A's rows lda
// apart) in BM x 128 block tiles (BM = 128, 96 or 64, as the launch plan
// says), k in steps of 32, fed by a ring of shared-memory stages that
// 16-byte cp.async copies fill while the block computes on an earlier
// stage. Every f32 GEMM runs on it: K6 (fc1, fc2), K5 (pw1, pw2), K1 (QKV,
// position, out-projection), K8 (conv2), K3 (the DFT), and K7 and K4
// through K6's, K1's and K5's sequences; in bf16 only rows wider than a
// cluster's column tiles (D > 1024), K1 head-sharded and K8's conv2 (on
// mma.sync). The Hopper GEMM (wgmma fed by TMA, thread-block clusters) is
// the second part, hopper_gemm_kernel, below: every bf16 GEMM of K6, K5,
// K7, K4 and K1 at D <= 1024, with the port's wrappers of those Hopper
// instructions (K1's bf16 attention core, rel_attention.cuh, uses them
// too).
//
// What bounds the f32 GEMM on this card: its operations, in IEEE FMA on the
// CUDA cores (K = 256 to 2048 against 4-byte elements; 67 TFLOP/s peak).
// The design keeps the FMA units fed: 4 k per shared-memory read and 8
// columns per thread put 0.25-0.375 shared-memory words under each f32
// FMA, and the ring hides the device memory latency. On an NVIDIA H100
// 80GB HBM3 at 700.00 W it runs K6's fc1 at 32-36 TFLOP/s, 85% of
// torch.matmul's 38 (0.0555 ms for fc1 at B=8, T'=126). A redesign for
// Hopper (TMA-fed stages in the 128-byte swizzle with thread 0 issuing the
// copies, fragments double-buffered in registers, two blocks an SM for
// 64-row tiles, the LayerNorm on the A path and split-K closed in a
// cluster through distributed shared memory) lost to it at every shape on
// the same card: K1's QKV GEMM 0.0735 against 0.070 ms, K6's fc1 with the
// LayerNorm 0.092 against 0.069 with its LayerNorm launch, fc2 in clusters
// 0.122 against 0.065 with its closing pass, K8's conv2 and K3's DFT 5-7%
// slower; it was withdrawn (PERF.md §6).
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
//         exact in f32, as in the plain versions (K7 and K4 run bf16 on
//         wgmma, in the second part, where their rows fit a cluster).
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

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums (types only: libcuda is reached through the runtime)

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
  int vt_ld;             // FE_QKV, HE_QKV_POS: 0, or v stored transposed, (B, H, hd, vt_ld) with keys
                         // contiguous (K1's bf16 core reads it as wgmma's K-major B)
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
    } else if (sizeof(T) == 2 && seg == 2 && g.vt_ld > 0) {  // bf16 only: the f32 core reads v as stored
      st(static_cast<T*>(g.out[3]) + (((size_t)b * g.H + h) * g.HD + c) * g.vt_ld + t, v);
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

// ─── The bf16 sublayer GEMMs of K7 and K4 on Hopper ─────────────────────────
// One kernel template, hopper_gemm_kernel<EPI, LNA, VEC>, runs every GEMM of
// K7 and K4 in bf16 in 64 x 128 output tiles (in f32, and in bf16 where a
// row spans more than a cluster's column tiles, K7 and K4 run K6's, K1's
// and K5's launch sequences on the tiled GEMM). The GEMMs are bound by operations, but at
// these sizes (M = B T' = 1008 at 10 s clips) the fixed costs around them
// decide the time: launches, passes of intermediates through device memory,
// and each block's prologue and epilogue. So the design takes what Hopper
// adds, and keeps the epilogues off the critical path: wgmma.mma_async
// m64n128k16 (f32 accumulators in registers) on tiles that TMA
// (cp.async.bulk.tensor, 128-byte swizzle) brings into a 4-stage ring with
// full/empty mbarriers per stage; 160 threads, one consumer warpgroup and
// one producer warp; a stage is released when the next stage's products are
// issued (wgmma.wait_group 1). Both operands are K-major (activations (M,
// K), weights in torch's (N, K)), wgmma's own layout; the shared-memory
// descriptors name the same 128-byte swizzle as the tensor maps. Where a
// row stride or base is not a multiple of 16 bytes (or a QKV segment is not
// a whole number of 64-row boxes), the producer warp fills the same
// swizzled stages element by element (VEC = false).
//
// LNA: the A rows are LayerNorm'd on their way in. The launch runs as
// clusters of (up to 8) column tiles of a row tile; each block takes the
// f32 statistics of one k slice of the rows, the cluster merges them
// through distributed shared memory, and each block writes its slice of
// round(LN(x)) to a scratch copy of the rows that the cluster's TMA loads
// then read (hg_ln_rows): every row is normalised once a cluster instead
// of once a column tile, and the products read plain tiles. The producer
// starts the W tiles of the first stages before the LayerNorm phase. Two
// other designs lost to it on an NVIDIA H100 80GB HBM3 at 700.00 W:
// each block taking its own 64 rows' statistics with no cluster, and the
// cluster's statistics with each block normalising its A tiles in the ring
// (fc1 of K6 at B=8, T'=751: 0.203 and 0.173 ms against 0.127). All three
// lose to a LayerNorm launch followed by the plain GEMM (0.084 ms there).
//
// The accumulators go through shared memory before any epilogue, so that
// every thread of the block forms outputs eight (or four) columns at a
// time and stores them with 16-byte stores. Epilogues:
//   HE_SILU     fc1: + bias, round, SiLU, round (FE_SILU's arithmetic)
//   HE_GLU      pw1: the B tile holds 64 a rows and their 64 g rows; pad
//               rows (t >= min(len, T), the min taken here) are written as
//               0 (FE_GLU's arithmetic)
//   HE_QKV_POS  problem 0 the QKV fold (FE_QKV's arithmetic), problem 1 (the
//               blocks past problem 0's tiles) the position GEMM, rounded
//   HE_LINEAR   k cut into `splits` slices that run as one thread-block
//               cluster with `cn` column tiles of the same rows: each block
//               leaves its f32 sums in shared memory, and the cluster adds the
//               slices in order z = 0, 1, ... through distributed shared
//               memory, + bias, round(res + coef * y) (round(y) without res)
//               into out[0] when set, and, with on_w, round(LN(v)) into
//               out_ln, the row statistics exchanged between the cluster's
//               column tiles through distributed shared memory (cn is then
//               every column tile of the row). No partials reach device
//               memory and no closing launch runs.
//
// The launch runs the plan it is given (ops/gemm_plan.py hopper_plan: the k
// slices and the cluster widths) and refuses one that breaks these rules.

using bf16 = __nv_bfloat16;
constexpr int HG_BM = 64, HG_BN = 128, HG_BK = 64, HG_STAGES = 4;  // k: one 128-byte swizzle row a stage
constexpr int HG_THREADS = 160;
constexpr int HG_RLD = HG_BN + 4;  // f32 staging tile row
constexpr int HG_MAX_CLUSTER = 8;
constexpr int HE_SILU = 0, HE_GLU = 1, HE_QKV_POS = 2, HE_LINEAR = 3;
constexpr int HG_STAGE = (HG_BM + HG_BN) * HG_BK;  // bf16 values per stage
constexpr int HG_TX = HG_STAGE * 2;                 // bytes a stage's TMA loads bring
constexpr int HG_RING = HG_STAGES * HG_TX;
// dynamic shared memory: 1 KB to align the ring to the swizzle's 1,024-byte
// period, the ring (which also holds the f32 staging tile after the last k
// step), 4 x 64 f32 row values (LayerNorm statistics, the cluster's row
// exchange), 3 x 128 column values (an epilogue's biases) and 16
// mbarriers: 102,016 B, two blocks an SM
constexpr int HG_SMEM = 1024 + HG_RING + (4 * HG_BM + 3 * HG_BN) * 4 + 16 * 8;
static_assert(HG_BM * HG_RLD * 4 <= HG_RING, "the staging tile fits the ring");
static_assert(HG_SMEM <= 232448, "an H100 block's shared memory");

struct HgArgs {
  FfnGemmArgs g[2];      // the launch's GEMMs: one, or (HE_QKV_POS) QKV then the position GEMM
  int tiles_n[2], tiles[2];
  const float* ln_w;     // LNA: the LayerNorm of g[0].a's rows
  const float* ln_b;
  float eps;
  const void* res;       // HE_LINEAR: residual (M, N) or null
  float coef;
  const float* on_w;     // HE_LINEAR: LayerNorm of the result into out_ln, or null
  const float* on_b;
  void* out_ln;
  int cn, splits;        // HE_LINEAR: column tiles and k slices per cluster; LNA: column tiles per cluster
  void* xn;              // LNA: the (M, K) LayerNorm'd rows
};

struct HgMaps {
  CUtensorMap a[2];      // activations of each problem
  CUtensorMap b[2][3];   // weight segments of each problem
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
// Bytes the phase's TMA loads will bring, without an arrival: loads issued
// ahead of the arrival that completes the phase (mbar_expect_tx)
__device__ __forceinline__ void mbar_expect_tx_only(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// Wait for the phase of the given parity to complete. A stage that never
// arrives is a fault, not a hang: after 2^30 polls (seconds) the block traps.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred P1;\nmbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\nselp.u32 %0, 1, 0, P1;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (i == (1u << 30)) __trap();
  }
}
// generic-proxy writes to shared memory, made visible to wgmma and TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile of 128-byte rows under
// the 128-byte swizzle: 8-row groups 1,024 bytes apart (the leading offset
// is not read in this mode); k16 step j starts 32 j bytes further
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
      "%61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// The same product at N = 64 (K1's content scores)
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),
        "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// D += A B with A (64 x 16 bf16) from registers, four b32 a thread in the
// layout of a m64 accumulator's 16 columns (the attention cores'
// probabilities times their values), B from shared memory, K-major (TB =
// 0: K1's values stored transposed) or MN-major (TB = 1: K2's value rows as
// they come, wgmma's transposed B)
template <int TB = 0>
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),
        "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

template <int TB = 0>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),
        "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

template <int TB = 0>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, "
      "%59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),
        "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]),
        "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map, int c0, int c1, int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Weight row r of column tile tn (null past the edge): HE_GLU's tile is 64
// a rows then their 64 g rows of W1 (2 nseg rows); otherwise N rows over
// up to three segments of nseg rows.
template <int EPI>
__device__ __forceinline__ const bf16* hg_w_row(const FfnGemmArgs& g, int tn, int r) {
  if constexpr (EPI == HE_GLU) {
    const int gate = r >= HG_BN / 2, o = tn * (HG_BN / 2) + (r & (HG_BN / 2 - 1));
    if (o >= g.nseg) return nullptr;
    return static_cast<const bf16*>(g.w[0]) + ((size_t)gate * g.nseg + o) * g.K;
  } else {
    const int n = tn * HG_BN + r;
    if (n >= g.N) return nullptr;
    const int seg = (n >= g.nseg) + (n >= 2 * g.nseg);
    return static_cast<const bf16*>(g.w[seg]) + (size_t)(n - seg * g.nseg) * g.K;
  }
}

// Element (r, kk) of a stage tile of 64-value rows under the 128-byte swizzle
__device__ __forceinline__ int sw128_at(int r, int kk) { return r * 64 + ((((kk >> 3) ^ (r & 7))) << 3) + (kk & 7); }

// The element-wise fill of a stage (rows past the edge and k past K are 0)
template <typename RowFn>
__device__ __forceinline__ void sw128_fill(bf16* s, int rows, RowFn row, int K, int k0, int lane) {
  for (int i = lane; i < rows * HG_BK; i += 32) {
    const int r = i / HG_BK, kk = i - r * HG_BK, k = k0 + kk;
    const bf16* src = row(r);
    s[sw128_at(r, kk)] = (src != nullptr && k < K) ? src[k] : __float2bfloat16(0.f);
  }
}

// 16 bytes at p (16-byte aligned) as eight floats
__device__ __forceinline__ void ld16(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Eight outputs v[0..7] to dst[0..7] (n of them valid): one 16-byte store
// when all eight are valid and dst is 16-byte aligned
__device__ __forceinline__ void st8(bf16* dst, const float (&v)[8], int n) {
  if (n >= 8 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&p);
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (e < n) st(dst + e, v[e]);
  }
}

// The tile's column vectors of a non-linear epilogue into colv (3 x 128
// floats), so that the outputs read them from shared memory: HE_SILU its
// bias; HE_GLU the a and g biases of its 64 outputs; QKV each column's
// segment bias and, in the q segment, the u and v biases scaled by
// 1/sqrt(hd) and rounded, as the reference kernel does
template <int EPI>
__device__ __forceinline__ void hg_column_vectors(const HgArgs& a, int prob, int tn, float* colv, int tid) {
  const FfnGemmArgs& g = a.g[prob];
  for (int c = tid; c < HG_BN; c += HG_THREADS) {
    if constexpr (EPI == HE_GLU) {
      const int o = tn * (HG_BN / 2) + (c & (HG_BN / 2 - 1)), gate = c >= HG_BN / 2;
      colv[c] = o < g.nseg ? ld(static_cast<const bf16*>(g.bias[0]) + gate * g.nseg + o) : 0.f;
    } else if constexpr (EPI == HE_SILU) {
      const int n = tn * HG_BN + c;
      colv[c] = n < g.N ? ld(static_cast<const bf16*>(g.bias[0]) + n) : 0.f;
    } else if (prob == 0) {
      const int n = tn * HG_BN + c;
      if (n >= g.N) continue;
      const int seg = (n >= g.nseg) + (n >= 2 * g.nseg), nn = n - seg * g.nseg;
      colv[c] = ld(static_cast<const bf16*>(g.bias[seg]) + nn);
      if (seg == 0) {
        colv[HG_BN + c] = round_to<bf16>(ld(static_cast<const bf16*>(g.bias_u) + nn) * g.scale);
        colv[2 * HG_BN + c] = round_to<bf16>(ld(static_cast<const bf16*>(g.bias_v) + nn) * g.scale);
      }
    }
  }
}

// A non-linear epilogue from the f32 staging tile (64 x HG_RLD) and the
// column vectors: every thread takes chunks of eight output columns of one
// row
template <int EPI>
__device__ __forceinline__ void hg_store(const HgArgs& a, int prob, const float* red, const float* colv, int m0,
                                         int tn, int tid) {
  const FfnGemmArgs& g = a.g[prob];
  constexpr int W = EPI == HE_GLU ? HG_BN / 2 : HG_BN, CPR = W / 8;
  constexpr int IPT = (HG_BM * CPR + HG_THREADS - 1) / HG_THREADS;
  // every chunk of the thread in one unrolled pass, so that their arithmetic overlaps
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    const int i = tid + j * HG_THREADS;
    const int r = i / CPR, c0 = (i - r * CPR) * 8, m = m0 + r;
    if (i >= HG_BM * CPR || m >= g.M) continue;
    const float* src = red + r * HG_RLD + c0;
    float v[8];
    if constexpr (EPI == HE_GLU) {
      const int o0 = tn * W + c0, n = min(8, g.nseg - o0);
      if (n <= 0) continue;
      const int b = m / g.T, t = m - b * g.T;
      const bool live = t < min(g.lengths[b], g.T);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float av = round_to<bf16>(src[e] + colv[c0 + e]);
        const float gv = round_to<bf16>(src[e + W] + colv[W + c0 + e]);
        v[e] = live ? av * sigmoid_f32(gv) : 0.f;
      }
      st8(static_cast<bf16*>(g.out[0]) + (size_t)m * g.nseg + o0, v, n);
    } else {
      const int n0 = tn * W + c0, n = min(8, g.N - n0);
      if (n <= 0) continue;
      if (EPI == HE_QKV_POS && prob == 0) {
        // a chunk of 8 lies in one segment and one head: nseg and hd are multiples of 8
        const int seg = (n0 >= g.nseg) + (n0 >= 2 * g.nseg), nn = n0 - seg * g.nseg;
        const int b = m / g.T, t = m - b * g.T, h = nn / g.HD, c = nn - h * g.HD;
        const size_t o = (((size_t)b * g.H + h) * g.T + t) * g.HD + c;
        if (seg == 0) {
          float u[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float qs = round_to<bf16>((src[e] + colv[c0 + e]) * g.scale);
            v[e] = qs + colv[HG_BN + c0 + e];
            u[e] = qs + colv[2 * HG_BN + c0 + e];
          }
          st8(static_cast<bf16*>(g.out[0]) + o, v, n);
          st8(static_cast<bf16*>(g.out[1]) + o, u, n);
        } else if (seg == 2 && g.vt_ld > 0) {
          bf16* vt = static_cast<bf16*>(g.out[3]) + (((size_t)b * g.H + h) * g.HD + c) * g.vt_ld + t;
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (e < n) st(vt + (size_t)e * g.vt_ld, src[e] + colv[c0 + e]);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = src[e] + colv[c0 + e];
          st8(static_cast<bf16*>(g.out[seg + 1]) + o, v, n);
        }
      } else if (EPI == HE_QKV_POS) {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = src[e];
        st8(static_cast<bf16*>(g.out[0]) + (size_t)m * g.N + n0, v, n);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float h = round_to<bf16>(src[e] + colv[c0 + e]);
          v[e] = h * sigmoid_f32(h);
        }
        st8(static_cast<bf16*>(g.out[0]) + (size_t)m * g.N + n0, v, n);
      }
    }
  }
}

// Four values at p as floats, and back (one 8-byte access when p is aligned
// for it, else one by one; n of them valid)
__device__ __forceinline__ void ld4(const bf16* p, float (&v)[4], int n) {
  if (n >= 4 && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(u.x << 16); v[1] = __uint_as_float(u.x & 0xffff0000u);
    v[2] = __uint_as_float(u.y << 16); v[3] = __uint_as_float(u.y & 0xffff0000u);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = e < n ? ld(p + e) : 0.f;
  }
}
__device__ __forceinline__ void st4(bf16* p, const float (&v)[4], int n) {
  if (n >= 4 && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]), b = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                                              *reinterpret_cast<const uint32_t*>(&b));
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < n) st(p + e, v[e]);
  }
}

// Merge (nb, mb, qb) into (n, mu, m2): Chan's pairwise formula for the
// count, mean and sum of squared deviations of two disjoint sets
__device__ __forceinline__ void chan_merge(float& n, float& mu, float& m2, float nb, float mb, float qb) {
  const float nn = n + nb;
  if (nb <= 0.f) return;
  const float d = mb - mu;
  mu += d * (nb / nn);
  m2 += qb + d * d * (n * nb / nn);
  n = nn;
}

// Up to 8 values of row xr at [k, k + 8) below k_hi as floats; the count
template <bool VEC>
__device__ __forceinline__ int hg_chunk(const bf16* xr, int k, int k_hi, float (&v)[8]) {
  if constexpr (VEC) {
    ld16(xr + k, v);
    return 8;
  } else {
    const int n = min(8, k_hi - k);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = e < n ? ld(xr + k + e) : 0.f;
    return n;
  }
}

// LNA: the A rows LayerNorm'd into xn before the GEMM reads them. The
// launch's clusters span `C` column tiles of one row tile, and block q of a
// cluster takes k slice q of the 64 rows: each thread's sum of its chunks
// of the slice, then (from L1) the squared deviations from its own mean,
// one division a thread; the two threads of a row and then the cluster's
// slices merged by Chan's formula, the slices read through distributed
// shared memory all at once and merged in the order q = 0, 1, ... (the same
// in every block); then its slice of round((x - mean) rstd w + b), w and b
// read 16 bytes at a time, written to xn. Every cluster of the row tile
// writes the rows, the same bytes: a cluster reads them only once its own
// blocks have written all of them, so another cluster's writes leave what
// it reads as it was. The 128 consumer threads take part, two to a row. On
// return the cluster's xn rows are complete and visible to its TMA loads.
template <bool VEC>
__device__ __forceinline__ void hg_ln_rows(const HgArgs& a, bf16* xn, int m0, int C, int q, float* pmu, float* pm2,
                                           float* mean, float* rstd, int tid) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int LT = 128, TPR = LT / HG_BM, E = 8;
  const FfnGemmArgs& g = a.g[0];
  const int K = g.K, ks = ((K + C - 1) / C + E - 1) / E * E;  // slice length, whole chunks
  const int k_lo = min(K, q * ks), k_hi = min(K, k_lo + ks);
  const bf16* A = static_cast<const bf16*>(g.a);
  const int r = tid / TPR, p = tid - r * TPR, m = m0 + r;
  const bool work = tid < LT && m < g.M;
  const bf16* xr = A + (size_t)m * g.lda;
  float n = 0.f, mu = 0.f, m2 = 0.f;
  if (work) {
    float s = 0.f;
#pragma unroll 4
    for (int k = k_lo + p * E; k < k_hi; k += TPR * E) {
      float v[E];
      n += (float)hg_chunk<VEC>(xr, k, k_hi, v);
#pragma unroll
      for (int e = 0; e < E; ++e) s += v[e];  // a chunk's values past k_hi read as 0
    }
    mu = n > 0.f ? s / n : 0.f;
#pragma unroll 4
    for (int k = k_lo + p * E; k < k_hi; k += TPR * E) {
      float v[E];
      const int cnt = hg_chunk<VEC>(xr, k, k_hi, v);
#pragma unroll
      for (int e = 0; e < E; ++e) m2 += e < cnt ? (v[e] - mu) * (v[e] - mu) : 0.f;
    }
  }
  if (tid < LT) {
    // the row's two threads: the lower one's share first, so that both agree
    const float nb = __shfl_xor_sync(0xffffffffu, n, 1), mb = __shfl_xor_sync(0xffffffffu, mu, 1);
    const float qb = __shfl_xor_sync(0xffffffffu, m2, 1);
    if (p == 0) {
      chan_merge(n, mu, m2, nb, mb, qb);
      pmu[r] = mu;
      pm2[r] = m2;
    }
  }
  cluster.sync();  // every slice's partial statistics are in place
  if (tid < HG_BM) {
    float rmu[HG_MAX_CLUSTER], rm2[HG_MAX_CLUSTER];
#pragma unroll
    for (int j = 0; j < HG_MAX_CLUSTER; ++j)
      if (j < C) {
        rmu[j] = cluster.map_shared_rank(pmu, j)[tid];
        rm2[j] = cluster.map_shared_rank(pm2, j)[tid];
      }
    float tn = 0.f, tmu = 0.f, tm2 = 0.f;
#pragma unroll
    for (int j = 0; j < HG_MAX_CLUSTER; ++j)
      if (j < C) {
        const int lo = min(K, j * ks);
        chan_merge(tn, tmu, tm2, (float)(min(K, lo + ks) - lo), rmu[j], rm2[j]);
      }
    mean[tid] = tmu;
    rstd[tid] = 1.f / sqrtf(tm2 / (float)K + a.eps);
  }
  __syncthreads();
  if (work) {
    bf16* dst = xn + (size_t)m * K;
    const float mu_r = mean[r], rs = rstd[r];
    const bool wb16 = ((reinterpret_cast<uintptr_t>(a.ln_w) | reinterpret_cast<uintptr_t>(a.ln_b)) & 15) == 0;
#pragma unroll 4
    for (int k = k_lo + p * E; k < k_hi; k += TPR * E) {
      float v[E], w[E], b[E];
      const int cnt = hg_chunk<VEC>(xr, k, k_hi, v);
      if (VEC && wb16) {
        const float4 w0 = __ldg(reinterpret_cast<const float4*>(a.ln_w + k));
        const float4 w1 = __ldg(reinterpret_cast<const float4*>(a.ln_w + k + 4));
        const float4 b0 = __ldg(reinterpret_cast<const float4*>(a.ln_b + k));
        const float4 b1 = __ldg(reinterpret_cast<const float4*>(a.ln_b + k + 4));
        w[0] = w0.x; w[1] = w0.y; w[2] = w0.z; w[3] = w0.w; w[4] = w1.x; w[5] = w1.y; w[6] = w1.z; w[7] = w1.w;
        b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w; b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          w[e] = e < cnt ? a.ln_w[k + e] : 0.f;
          b[e] = e < cnt ? a.ln_b[k + e] : 0.f;
        }
      }
      float y[E];
#pragma unroll
      for (int e = 0; e < E; ++e) y[e] = (v[e] - mu_r) * rs * w[e] + b[e];
      st8(dst + k, y, cnt);
    }
  }
  // the rows go to TMA (the async proxy) in the other blocks of the cluster
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  cluster.sync();
}

// HE_LINEAR's closing epilogue, run by every thread of every block of the
// cluster once the block's f32 sums are in `red` (64 x HG_RLD). Each block
// closes rows [slice, slice + 1) * 64 / splits of its column tile: a thread
// takes four columns of a row (a warp, one row), four such items at a
// time, every load of the four (residuals, the other blocks' sums) issued
// before any store. The results go back into the block's own rows of
// `red`, which no other block reads. With a LayerNorm of the result, each
// block takes its tile's count, mean and squared deviations of every row
// (two passes over the tile's values), the cluster exchanges them once,
// and every block merges the cn tiles' in order j = 0, 1, ... by Chan's
// formula. colv holds the tile's bias and LayerNorm vectors; mean[] and
// rstd[] the rows' statistics (no LNA here).
__device__ __forceinline__ void hg_cluster_close(const HgArgs& a, float* red, float* colv, float* mean, float* rstd,
                                                 float* rowx, float* rowy, int m0, int tn, int slice, int tid) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int U = 4, G = HG_BN / 4;  // items in flight per thread; items a row
  const FfnGemmArgs& g = a.g[0];
  const int cnl = tn % a.cn, rows = HG_BM / a.splits, r_lo = slice * rows, lane = tid & 31;
  const bool ln = a.on_w != nullptr;
  const bf16* bias = static_cast<const bf16*>(g.bias[0]);
  const bf16* res = static_cast<const bf16*>(a.res);
  bf16* out = static_cast<bf16*>(g.out[0]);
  const int items = rows * G;
  for (int c = tid; c < HG_BN; c += HG_THREADS) {
    const int n = tn * HG_BN + c;
    colv[c] = bias != nullptr && n < g.N ? ld(bias + n) : 0.f;
    if (ln) {
      colv[HG_BN + c] = n < g.N ? a.on_w[n] : 0.f;
      colv[2 * HG_BN + c] = n < g.N ? a.on_b[n] : 0.f;
    }
  }
  cluster.sync();  // every slice's sums are in place
  for (int i0 = tid; i0 < items; i0 += U * HG_THREADS) {
    float x[U][4];
    float4 y[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * HG_THREADS, r = r_lo + i / G, c = (i % G) * 4, m = m0 + r, n0 = tn * HG_BN + c;
      const int nv = i < items && m < g.M ? min(4, g.N - n0) : 0;
      y[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      x[u][0] = x[u][1] = x[u][2] = x[u][3] = 0.f;
      if (res != nullptr && nv > 0) ld4(res + (size_t)m * g.N + n0, x[u], nv);
    }
    for (int z = 0; z < a.splits; ++z) {
      const float* src = cluster.map_shared_rank(red, z * a.cn + cnl);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * HG_THREADS;
        if (i < items) {
          const float4 p = *reinterpret_cast<const float4*>(src + (r_lo + i / G) * HG_RLD + (i % G) * 4);
          y[u].x += p.x; y[u].y += p.y; y[u].z += p.z; y[u].w += p.w;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * HG_THREADS;
      if (i >= items) break;  // warp-uniform: items is a multiple of 32
      const int r = r_lo + i / G, c = (i % G) * 4, m = m0 + r, n0 = tn * HG_BN + c;
      const int nv = m < g.M ? min(4, g.N - n0) : 0;
      float v[4] = {y[u].x, y[u].y, y[u].z, y[u].w};
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float s = v[e] + colv[c + e];
        v[e] = e < nv ? round_to<bf16>(res != nullptr ? x[u][e] + a.coef * s : s) : 0.f;
        sum += v[e];
      }
      if (out != nullptr && nv > 0) st4(out + (size_t)m * g.N + n0, v, nv);
      *reinterpret_cast<float4*>(red + r * HG_RLD + c) = make_float4(v[0], v[1], v[2], v[3]);
      if (ln) {
        const float cnt = warp_sum((float)max(nv, 0)), tmean = cnt > 0.f ? warp_sum(sum) / cnt : 0.f;
        float d2 = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) d2 += e < nv ? (v[e] - tmean) * (v[e] - tmean) : 0.f;
        d2 = warp_sum(d2);
        if (lane == 0) {
          rowx[r] = tmean;
          rowy[r] = d2;
        }
      }
    }
  }
  if (ln) {
    cluster.sync();  // every column tile's row statistics are in place
    if (tid < rows) {
      const int r = r_lo + tid;
      float n = 0.f, mu = 0.f, m2 = 0.f;
      for (int j = 0; j < a.cn; ++j) {
        const float cnt = (float)max(0, min(HG_BN, g.N - j * HG_BN));
        chan_merge(n, mu, m2, cnt, cluster.map_shared_rank(rowx, slice * a.cn + j)[r],
                   cluster.map_shared_rank(rowy, slice * a.cn + j)[r]);
      }
      mean[r] = mu;
      rstd[r] = 1.f / sqrtf(m2 / (float)g.N + a.eps);
    }
    __syncthreads();
    bf16* out_ln = static_cast<bf16*>(a.out_ln);
    for (int i = tid; i < items; i += HG_THREADS) {
      const int r = r_lo + i / G, c = (i % G) * 4, m = m0 + r, n0 = tn * HG_BN + c;
      const int nv = m < g.M ? min(4, g.N - n0) : 0;
      if (nv <= 0) continue;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = (red[r * HG_RLD + c + e] - mean[r]) * rstd[r] * colv[HG_BN + c + e] + colv[2 * HG_BN + c + e];
      st4(out_ln + (size_t)m * g.N + n0, v, nv);
    }
  }
  cluster.sync();  // no block leaves while another still reads its shared memory
}

// The register cap of three blocks an SM: two blocks (ten warps, three on
// some of the SM's four register files; shared memory holds no third) need
// at most 136 registers a thread, which 3 x 160 threads sets.
template <int EPI, bool LNA, bool VEC>
__global__ void __launch_bounds__(HG_THREADS, 3)
    hopper_gemm_kernel(const __grid_constant__ HgArgs a, const __grid_constant__ HgMaps maps) {
  static_assert(!LNA || EPI == HE_SILU || EPI == HE_GLU || EPI == HE_QKV_POS, "a LayerNorm'd A of problem 0");
  extern __shared__ unsigned char hg_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(hg_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* mean = reinterpret_cast<float*>(base + HG_RING);
  float* rstd = mean + HG_BM;
  float* rowx = rstd + HG_BM;
  float* rowy = rowx + HG_BM;
  float* colv = rowy + HG_BM;  // 3 x HG_BN
  uint64_t* full = reinterpret_cast<uint64_t*>(colv + 3 * HG_BN);
  uint64_t* empty = full + 8;
  float* red = reinterpret_cast<float*>(base);  // the staging tile, once the ring is free
  bf16* ring = reinterpret_cast<bf16*>(base);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // which tile of which problem, which k slice. With LNA, problem 0's
  // blocks come first in clusters of cn column tiles; HE_QKV_POS's problem
  // 1 (the position GEMM, no LayerNorm) follows in as many blocks as its
  // tiles, padded to whole clusters, each cluster all of one problem
  int prob = 0, tm, tn, slice = 0;
  const int p0_blocks = LNA ? a.tiles[0] / a.tiles_n[0] * ((a.tiles_n[0] + a.cn - 1) / a.cn) * a.cn : a.tiles[0];
  if (LNA && EPI == HE_QKV_POS && blockIdx.x >= p0_blocks) {
    const int tile = blockIdx.x - p0_blocks;
    if (tile >= a.tiles[1]) return;  // a cluster's padding
    prob = 1;
    tm = tile / a.tiles_n[1];
    tn = tile - tm * a.tiles_n[1];
  } else if constexpr (EPI == HE_LINEAR || LNA) {
    const int size = EPI == HE_LINEAR ? a.cn * a.splits : a.cn;
    const int cid = blockIdx.x / size, rank = blockIdx.x - cid * size;
    const int groups = (a.tiles_n[0] + a.cn - 1) / a.cn;
    tm = cid / groups;
    tn = (cid - tm * groups) * a.cn + rank % a.cn;
    slice = EPI == HE_LINEAR ? rank / a.cn : 0;
  } else {
    int tile = blockIdx.x;
    if (EPI == HE_QKV_POS && tile >= a.tiles[0]) {
      prob = 1;
      tile -= a.tiles[0];
    }
    tm = tile / a.tiles_n[prob];
    tn = tile - tm * a.tiles_n[prob];
  }
  const FfnGemmArgs& g = a.g[prob];
  const int m0 = tm * HG_BM;
  const int step0 = slice * g.steps;
  const int nsteps = min(g.steps, (g.K + HG_BK - 1) / HG_BK - step0);
  // the GEMM's A: the activations, or with LNA problem 0's LayerNorm'd rows
  const bool lna = LNA && prob == 0;
  const bf16* A = static_cast<const bf16*>(lna ? a.xn : g.a);
  const int lda = lna ? g.K : g.lda;
  auto a_row = [&](int r) -> const bf16* { return m0 + r < g.M ? A + (size_t)(m0 + r) * lda : nullptr; };
  auto b_row = [&](int r) { return hg_w_row<EPI>(g, tn, r); };

  if (tid == 0) {
    for (int s = 0; s < HG_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // W's boxes of a stage (the weight tiles do not depend on the LayerNorm)
  auto load_w = [&](int step) {
    const int s = step % HG_STAGES, k0 = (step0 + step) * HG_BK;
    bf16* bs = ring + s * HG_STAGE + HG_BM * HG_BK;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      int seg = 0, row;
      if constexpr (EPI == HE_GLU) {
        row = j * g.nseg + tn * (HG_BN / 2);
      } else {
        // only QKV has segments; another problem's rows past N read as 0
        const int n = tn * HG_BN + j * (HG_BN / 2);
        if (EPI == HE_QKV_POS && prob == 0) seg = min(n / g.nseg, 2);
        row = n - seg * g.nseg;
      }
      tma_2d(bs + j * (HG_BN / 2) * HG_BK, &maps.b[prob][seg], k0, row, &full[s]);
    }
  };
  // LNA with TMA: the first stages' W tiles are in flight during the
  // LayerNorm phase (their bytes expected without an arrival; the A tile's
  // arrival completes each stage's phase)
  const int w_ahead = LNA && VEC && lna && tn < a.tiles_n[0] ? min(HG_STAGES, nsteps) : 0;
  if (warp == 4 && lane == 0)
    for (int step = 0; step < w_ahead; ++step) {
      mbar_expect_tx_only(&full[step], HG_BN * HG_BK * 2);
      load_w(step);
    }
  if constexpr (LNA) {
    if (lna) {
      hg_ln_rows<VEC>(a, static_cast<bf16*>(a.xn), m0, a.cn, tn % a.cn, rowx, rowy, mean, rstd, tid);
      if (tn >= a.tiles_n[0]) return;  // a block that only LayerNorms its slice
    }
  }
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  if (warp == 4) {
    // producer
    for (int step = 0; step < nsteps; ++step) {
      const int s = step % HG_STAGES, k0 = (step0 + step) * HG_BK;
      if (step >= HG_STAGES) mbar_wait(&empty[s], ((step / HG_STAGES) - 1) & 1);
      bf16* as = ring + s * HG_STAGE;
      bf16* bs = as + HG_BM * HG_BK;
      if constexpr (VEC) {
        if (lane == 0) {
          mbar_expect_tx(&full[s], step < w_ahead ? HG_BM * HG_BK * 2 : HG_TX);
          tma_2d(as, &maps.a[prob], k0, m0, &full[s]);
          if (step >= w_ahead) load_w(step);
        }
      } else {
        sw128_fill(as, HG_BM, a_row, g.K, k0, lane);
        sw128_fill(bs, HG_BN, b_row, g.K, k0, lane);
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(&full[s]);
      }
    }
  } else {
    // consumers
    for (int step = 0; step < nsteps; ++step) {
      const int s = step % HG_STAGES;
      mbar_wait(&full[s], (step / HG_STAGES) & 1);
      const bf16* as = ring + s * HG_STAGE;
      const bf16* bs = as + HG_BM * HG_BK;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      const uint64_t da = sw128_desc(as), db = sw128_desc(bs);
#pragma unroll
      for (int kk = 0; kk < HG_BK / 16; ++kk) wgmma_m64n128k16(acc, da + 2 * kk, db + 2 * kk);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // the previous step's products are done: its stage goes back to the producer
      wgmma_wait<1>();
      if (step > 0 && lane == 0) mbar_arrive(&empty[(step - 1) % HG_STAGES]);
    }
    wgmma_wait<0>();
  }

  __syncthreads();  // every product is done and the ring is free
  if (warp < 4) {
    // accumulator i: row 16 warp + lane/4 (+8 for i%4 >= 2), column 8 (i/4) + 2 (lane%4) + i%2
    const int rb = 16 * warp + (lane >> 2), cb = 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < 64; i += 2)
      *reinterpret_cast<float2*>(red + (rb + 8 * ((i >> 1) & 1)) * HG_RLD + 8 * (i >> 2) + cb) =
          make_float2(acc[i], acc[i + 1]);
  }

  if constexpr (EPI == HE_LINEAR) {
    hg_cluster_close(a, red, colv, mean, rstd, rowx, rowy, m0, tn, slice, tid);
  } else {
    hg_column_vectors<EPI>(a, prob, tn, colv, tid);
    __syncthreads();
    hg_store<EPI>(a, prob, red, colv, m0, tn, tid);
  }
}

// ─── Host side: tensor maps and launches ───────────────────────────────────

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// (the libraries link no libcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q) != cudaSuccess)
      return static_cast<EncodeTiledFn>(nullptr);
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) != cudaSuccess)
      return static_cast<EncodeTiledFn>(nullptr);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// A (rows, cols) bf16 tensor with rows ld elements apart, in boxes of 64
// rows x 64 values under the 128-byte swizzle
inline bool encode_bf16_rows(CUtensorMap* map, const void* ptr, int rows, int cols, int ld) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {HG_BK, HG_BN / 2};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The launch configuration of `blocks` blocks in clusters of `cluster`
struct HgLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  HgLaunch(int blocks, int cluster, cudaStream_t stream) {
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(HG_THREADS);
    cfg.dynamicSmemBytes = HG_SMEM;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// Clusters of `size` blocks of hopper_gemm_kernel that the card holds at
// once (cudaOccupancyMaxActiveClusters; every instantiation takes the same
// threads and shared memory, which hold two blocks an SM), or minus the
// error. The plans' table (ops/gemm_plan.py HOPPER_ACTIVE_CLUSTERS) is
// checked against it on the card.
inline int hopper_active_clusters(int size) {
  auto kernel = hopper_gemm_kernel<HE_LINEAR, false, true>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, HG_SMEM);
  HgLaunch l(size * 64, size, nullptr);
  int n = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&n, kernel, &l.cfg);
  return err == cudaSuccess ? n : -(int)err;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Launch one hopper_gemm_kernel: a.g[0] (and with HE_QKV_POS a.g[1]) with
// M, N, K, nseg and lda set (0: N and K); HE_LINEAR with a.cn and a.splits;
// LNA with a.ln_w, a.ln_b, a.eps, a.cn and a.xn ((M, K) bf16). Fills in
// the tiles and k steps, picks the loader (TMA where every row is 16-byte
// aligned, element by element otherwise) and encodes the tensor maps. The
// k slices and cluster widths are the plan's, as given: a plan they break
// (k slices that do not divide the k steps or the 64 rows, a cluster of
// more than 8 blocks, a LayerNorm'd result whose row leaves the cluster) is
// refused with cudaErrorInvalidValue.
template <int EPI, bool LNA>
cudaError_t launch_hopper_gemm(HgArgs a, cudaStream_t stream) {
  const int nprob = EPI == HE_QKV_POS ? 2 : 1;
  const int splits = EPI == HE_LINEAR ? a.splits : 1;
  bool vec = true;
  for (int p = 0; p < nprob; ++p) {
    FfnGemmArgs& g = a.g[p];
    if (g.nseg == 0) g.nseg = g.N;
    if (g.lda == 0) g.lda = g.K;
    const int steps = (g.K + HG_BK - 1) / HG_BK;
    if (splits < 1 || steps % splits != 0 || HG_BM % splits != 0) return cudaErrorInvalidValue;
    g.steps = steps / splits;
    a.tiles_n[p] = EPI == HE_GLU ? (g.nseg + HG_BN / 2 - 1) / (HG_BN / 2) : (g.N + HG_BN - 1) / HG_BN;
    a.tiles[p] = a.tiles_n[p] * ((g.M + HG_BM - 1) / HG_BM);
    const int segs = EPI == HE_QKV_POS && p == 0 ? 3 : 1;
    vec = vec && (g.K * 2) % 16 == 0 && (g.lda * 2) % 16 == 0 && aligned16(g.a);
    for (int s = 0; s < segs; ++s) vec = vec && aligned16(g.w[s]);
    if (segs == 3) vec = vec && g.nseg % (HG_BN / 2) == 0;
  }
  if (a.g[0].M == 0) return cudaSuccess;
  // QKV's chunks of eight stay inside one segment and one head
  if (EPI == HE_QKV_POS && (a.g[0].nseg % 8 != 0 || a.g[0].HD % 8 != 0)) return cudaErrorInvalidValue;
  const int row_tiles = a.tiles[0] / a.tiles_n[0];
  int blocks = a.tiles[0] + (nprob == 2 ? a.tiles[1] : 0), cluster = 1;
  if (EPI == HE_LINEAR) {
    if (a.cn < 1 || a.tiles_n[0] % a.cn != 0 || a.cn * splits > HG_MAX_CLUSTER) return cudaErrorInvalidValue;
    if (a.on_w != nullptr && a.cn != a.tiles_n[0]) return cudaErrorInvalidValue;
    cluster = a.cn * splits;
    blocks = a.tiles[0] * splits;
  }
  if (LNA) {
    if (a.xn == nullptr || a.ln_w == nullptr || a.ln_b == nullptr || a.cn < 1 ||
        a.cn > min(HG_MAX_CLUSTER, a.tiles_n[0]))
      return cudaErrorInvalidValue;
    cluster = a.cn;
    blocks = row_tiles * ((a.tiles_n[0] + a.cn - 1) / a.cn) * a.cn;
    if (nprob == 2) blocks += (a.tiles[1] + a.cn - 1) / a.cn * a.cn;
  }
  auto kernel = vec ? hopper_gemm_kernel<EPI, LNA, true> : hopper_gemm_kernel<EPI, LNA, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, HG_SMEM);
  if (err != cudaSuccess) return err;
  HgMaps maps{};
  if (vec) {
    for (int p = 0; p < nprob; ++p) {
      const FfnGemmArgs& g = a.g[p];
      const int segs = EPI == HE_QKV_POS && p == 0 ? 3 : 1;
      const int wrows = EPI == HE_GLU ? 2 * g.nseg : (segs == 3 ? g.nseg : g.N);
      bool ok = LNA && p == 0 ? encode_bf16_rows(&maps.a[p], a.xn, g.M, g.K, g.K)
                              : encode_bf16_rows(&maps.a[p], g.a, g.M, g.K, g.lda);
      for (int s = 0; s < segs; ++s) ok = ok && encode_bf16_rows(&maps.b[p][s], g.w[s], wrows, g.K, g.K);
      if (!ok) return cudaErrorInvalidValue;
    }
  }
  HgLaunch l(blocks, cluster, stream);
  l.cfg.numAttrs = EPI == HE_LINEAR || LNA ? 1 : 0;
  err = cudaLaunchKernelEx(&l.cfg, kernel, a, maps);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// One hopper_gemm_kernel launch with problem 0's A LayerNormed (LNA) when
// a.ln_w is set, as given otherwise
template <int EPI>
cudaError_t launch_hopper_gemm_ln(const HgArgs& a, cudaStream_t stream) {
  return a.ln_w != nullptr ? launch_hopper_gemm<EPI, true>(a, stream) : launch_hopper_gemm<EPI, false>(a, stream);
}

// HE_LINEAR on (M, N, K): sum + bias, round(res + coef * y) into out (when
// set), round(LN(v)) into out_ln (when on_w is set; every column tile in
// the cluster). splits: k slices, the plan's.
inline cudaError_t launch_cluster_linear(const void* act, const void* w, const void* bias, const void* res,
                                         float coef, void* out, const float* on_w, const float* on_b, float eps,
                                         void* out_ln, int M, int N, int K, int splits, cudaStream_t stream) {
  HgArgs a = {};
  a.g[0].a = act;
  a.g[0].w[0] = w;
  a.g[0].bias[0] = bias;
  a.g[0].out[0] = out;
  a.g[0].M = M; a.g[0].N = N; a.g[0].K = K;
  a.res = res;
  a.coef = coef;
  a.on_w = on_w;
  a.on_b = on_b;
  a.eps = eps;
  a.out_ln = out_ln;
  a.splits = splits;
  a.cn = on_w != nullptr ? (N + HG_BN - 1) / HG_BN : 1;
  return launch_hopper_gemm<HE_LINEAR, false>(a, stream);
}

}  // namespace
