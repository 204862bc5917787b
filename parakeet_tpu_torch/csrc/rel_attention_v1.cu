// Relative-position attention with the projections outside ("v1") for
// Hopper (sm_90a): K2.
//
// Replaces the TPU kernel parakeet_tpu/ops/pallas_attention.py::
// fused_rel_attention (_attn_kernel), which the reference's encoder runs
// under set_fused_attention("v1") (models/encoder.py rel_position_attention).
// Per (b, h), on q_u = q + u, q_v = q + v, k, v (B, H, T, hd) and the
// projected position table P (H, 2T-1, hd), row r = relative position T-1-r:
//
//   score[t,s] = ((q_u[t].k[s]) + (q_v[t].P[T-1-t+s])) / sqrt(hd)
//                                       the scale after the sum; -1e9 where
//                                       s >= len (the reference's order)
//   prob = round(exp(score - max) / sum)  f32 softmax normalised BEFORE AV,
//                                       the probabilities rounded to T
//   out[t] = round(sum_s prob[t,s] v[s]) f32 accumulation
//
// Two kernels, chosen per call by the caller's launch plan
// (ops/rel_attention.py v1_plan), both hand-written for the card:
//
// One pass (rel_attn_v1_onepass_kernel), whenever a block's score rows fit
// in shared memory: a block takes (b, h) and BM = 64, 32 or 16 query rows
// (the largest that fits 227 KB) and BM * BN / 16 threads. Key tiles of BN
// rows, with the band of BM + BN - 1 P rows their scores read (the
// rel_shift becomes an index), stream through a double-buffered ring of
// 16-byte cp.async copies; each thread computes a 4x4 patch of content and
// position sums, register-blocked, and writes (c + p) * scale, or -1e9
// past the length, into a BM x T f32 row buffer. The max, exp(s - max),
// the sum and round(e / sum) then run in place, one warp per row, and the
// value tiles stream through the same ring for AV, 4 rows per thread. K,
// the P band and V are each read once: 3 * B*H*T^2*hd FMAs with one exp
// per score. At hd = 64 in f32 one pass covers T up to 2,360; at hd = 128
// up to 1,086 (bf16: more).
//
// Two passes (rel_attn_v1_kernel), past that: 64 query rows, 4 threads per
// row, each owning hd/4 of the head dims; key tiles of 32 are read twice,
// pass 1 for the running max and rescaled sum, pass 2 for round(exp(score
// - max) / sum) times v, so nothing of size T^2 is held and there is no
// length cap (the reference's v1 path stops at T = 768 for VMEM; above it
// the reference runs XLA attention, which computes the same function).
//
// What bounds it on the card: the FMAs, IEEE f32 on the CUDA cores in both
// dtypes (bf16 values are widened as they are read), and the
// shared-memory reads that feed them. The two-pass kernel costs 5 units of
// B*H*T^2*hd FMAs at one shared-memory load per FMA; the one-pass kernel 3
// units at 19 four-wide reads per 128 FMAs in the score patch and 4 + DPT/4
// per 16 DPT in AV. Its one block per SM (the row buffer) leaves latency to
// the patch's 32 independent sums. Tensor cores for the bf16 AV product
// (the probabilities are already rounded to bf16) are later work.
//
// Measured (device time, B=8, H=8, hd=64, mixed lengths, kernel / plain
// version; NVIDIA H100 80GB HBM3, 700.00 W): one pass, f32 0.038 / 0.090
// ms at T'=126, 0.758 / 1.758 at T'=751, 1.276 / 3.011 at T'=1001; bf16
// 0.040 / 0.120, 0.679 / 2.002, 1.136 / 3.399. The two-pass kernel alone
// took 0.118, 2.83 and 4.09 ms in f32 at the same shapes.
//
// Plain C interface, loaded with ctypes. Returns cudaGetLastError() (0 =
// success).

#include "async_copy.cuh"
#include "gemm.cuh"

namespace {

constexpr int VBM = 64, VBN = 32, VTHREADS = 256;

template <int HD>
constexpr int v1_smem_bytes() {
  return (2 * VBN + VBM + VBN - 1) * (HD + 4) * (int)sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(VTHREADS) rel_attn_v1_kernel(
    const T* __restrict__ qu, const T* __restrict__ qv, const T* __restrict__ kh,
    const T* __restrict__ vh, const T* __restrict__ pos, const int* __restrict__ lengths,
    T* __restrict__ out, int Tn, int H, float scale) {
  constexpr int DPT = HD / 4, LDS = HD + 4;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + VBN * LDS;
  float* Ps = Vs + VBN * LDS;

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int t0 = blockIdx.x * VBM;
  const int tid = threadIdx.x, row = tid >> 2, part = tid & 3;
  const int t = t0 + row;
  const bool row_ok = t < Tn;
  const int kv_len = min(lengths[b], Tn);
  // keys past kv_len carry -1e9 and get probability exactly 0 once a valid
  // key is seen; an item with no valid key averages all Tn keys
  const int n_keys = kv_len > 0 ? kv_len : Tn;
  const size_t head = (size_t)bh * Tn * HD;
  const T* ph = pos + (size_t)h * (2 * Tn - 1) * HD;

  float q_u[DPT], q_v[DPT], acc[DPT];
#pragma unroll
  for (int d = 0; d < DPT; ++d) {
    const size_t o = head + (size_t)t * HD + part * DPT + d;
    q_u[d] = row_ok ? ld(qu + o) : 0.f;
    q_v[d] = row_ok ? ld(qv + o) : 0.f;
    acc[d] = 0.f;
  }

  auto load_tile = [&](int s0, bool with_v) {
    for (int i = tid; i < VBN * HD; i += VTHREADS) {
      const int r = i / HD, c = i - r * HD;
      const int s = s0 + r;
      const size_t o = head + (size_t)s * HD + c;
      Ks[r * LDS + c] = s < Tn ? ld(kh + o) : 0.f;
      if (with_v) Vs[r * LDS + c] = s < Tn ? ld(vh + o) : 0.f;
    }
    // band row j holds P[r_lo + j]; row (tr, ks) reads j = ks + VBM-1-tr
    const int r_lo = Tn - VBM - t0 + s0;
    for (int i = tid; i < (VBM + VBN - 1) * HD; i += VTHREADS) {
      const int j = i / HD, c = i - j * HD;
      const int r = r_lo + j;
      Ps[j * LDS + c] = (r >= 0 && r < 2 * Tn - 1) ? ld(ph + (size_t)r * HD + c) : 0.f;
    }
  };
  // every lane of the warp calls this for the same ks (the shuffles)
  auto score = [&](int s0, int ks) -> float {
    const float* kr = Ks + ks * LDS + part * DPT;
    const float* pr = Ps + (ks + VBM - 1 - row) * LDS + part * DPT;
    float c = 0.f, p = 0.f;
#pragma unroll
    for (int d = 0; d < DPT; ++d) {
      c = fmaf(q_u[d], kr[d], c);
      p = fmaf(q_v[d], pr[d], p);
    }
    c += __shfl_xor_sync(0xffffffffu, c, 1);
    c += __shfl_xor_sync(0xffffffffu, c, 2);
    p += __shfl_xor_sync(0xffffffffu, p, 1);
    p += __shfl_xor_sync(0xffffffffu, p, 2);
    const int s = s0 + ks;
    if (s >= n_keys) return -INFINITY;
    if (s >= kv_len) return -1e9f;
    return (c + p) * scale;
  };

  // pass 1: row max and the sum of exp(score - max), rescaled as the max grows
  float m = -INFINITY, l = 0.f;
  for (int s0 = 0; s0 < n_keys; s0 += VBN) {
    load_tile(s0, false);
    __syncthreads();
    float sc[VBN];
    float tile_max = -INFINITY;
#pragma unroll
    for (int ks = 0; ks < VBN; ++ks) {
      sc[ks] = score(s0, ks);
      tile_max = fmaxf(tile_max, sc[ks]);
    }
    const float m_new = fmaxf(m, tile_max);
    l *= expf(m - m_new);
#pragma unroll
    for (int ks = 0; ks < VBN; ++ks) l += expf(sc[ks] - m_new);
    m = m_new;
    __syncthreads();
  }

  // pass 2: the normalised probabilities, rounded to T, times v
  for (int s0 = 0; s0 < n_keys; s0 += VBN) {
    load_tile(s0, true);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < VBN; ++ks) {
      const float p = round_to<T>(expf(score(s0, ks) - m) / l);
      const float* vr = Vs + ks * LDS + part * DPT;
#pragma unroll
      for (int d = 0; d < DPT; ++d) acc[d] = fmaf(p, vr[d], acc[d]);
    }
    __syncthreads();
  }

  if (row_ok) {
    T* o = out + head + (size_t)t * HD + part * DPT;
#pragma unroll
    for (int d = 0; d < DPT; ++d) st(o + d, acc[d]);
  }
}

template <typename T, int HD>
cudaError_t launch_v1(const void* qu, const void* qv, const void* kh, const void* vh,
                      const void* pos, const int* lengths, void* out, int B, int Tn, int H,
                      cudaStream_t stream) {
  constexpr int smem = v1_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(rel_attn_v1_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tn + VBM - 1) / VBM, B * H);
  rel_attn_v1_kernel<T, HD><<<grid, VTHREADS, smem, stream>>>(
      static_cast<const T*>(qu), static_cast<const T*>(qv), static_cast<const T*>(kh),
      static_cast<const T*>(vh), static_cast<const T*>(pos), lengths, static_cast<T*>(out), Tn, H,
      1.f / sqrtf((float)HD));
  return cudaGetLastError();
}

// ─── One pass: a block's score rows held in shared memory ──────────────────

// Element offset of (row r, element e) in a shared tile of HD-wide rows
// whose 16-byte chunks are XOR-swizzled by r/4, so that rows 4 apart (the
// rows that neighbouring threads read) fall in distinct bank groups.
template <typename T, int HD>
__device__ __forceinline__ int v1_swz(int r, int e) {
  constexpr int CH = 16 / (int)sizeof(T), NC = HD / CH;
  constexpr int MASK = (NC < 8 ? NC : 8) - 1;
  return r * HD + (((e / CH) ^ ((r >> 2) & MASK)) * CH) + e % CH;
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Rows row0 .. row0 + n - 1 of src (HD-wide rows) into a swizzled tile,
// zero for rows outside [0, hi), by 16-byte cp.async copies.
template <typename T, int HD, int THREADS>
__device__ __forceinline__ void v1_copy_rows(T* dst, const T* src, int row0, int n, int hi, int tid) {
  constexpr int CH = 16 / (int)sizeof(T), NC = HD / CH;
  for (int i = tid; i < n * NC; i += THREADS) {
    const int j = i / NC, c = (i - j * NC) * CH;
    const int r = row0 + j;
    const bool ok = r >= 0 && r < hi;
    cp_async16(dst + v1_swz<T, HD>(j, c), ok ? src + (size_t)r * HD + c : src, ok);
  }
}

// Shared memory of the one-pass kernel: the score rows (BM x round4(T)
// f32), q_u and q_v (BM x HD) and two ring stages, each a key tile (BN x
// HD) with its band of BM + BN - 1 position rows (a value tile in the AV
// phase), in the activation dtype. ops/rel_attention.py v1_plan computes
// the same number.
template <typename T, int HD, int BM, int BN>
size_t v1_onepass_smem(int Tn) {
  return (size_t)4 * BM * ((Tn + 3) & ~3) +
         sizeof(T) * HD * (size_t)(2 * BM + 2 * (2 * BN + BM - 1));
}

// Block: (b, h) and BM query rows, BM * BN / 16 threads.
//   scores  per key tile: thread (ty, tx) owns the 4x4 patch of rows
//           ty*4 + i and keys tx*4 + j; its content and position sums run
//           over hd in order, 4 values per shared read, and the position
//           rows it needs are the 7 band rows tx*4 - ty*4 + BM-4 .. +6
//           (the rel_shift as an index); (c + p) * scale, or -1e9 past the
//           length, goes into the row buffer
//   softmax one warp per row: max, exp(s - max) and its sum, then
//           round(e / sum) in place; zero up to a multiple of 4 keys
//   AV      thread owns 4 rows x DPT head dims (interleaved 4-wide groups);
//           the value tiles stream through the same ring
template <typename T, int HD, int BM, int BN>
__global__ void __launch_bounds__(BM * BN / 16) rel_attn_v1_onepass_kernel(
    const T* __restrict__ qu, const T* __restrict__ qv, const T* __restrict__ kh,
    const T* __restrict__ vh, const T* __restrict__ pos, const int* __restrict__ lengths,
    T* __restrict__ out, int Tn, int H, float scale) {
  constexpr int THREADS = BM * BN / 16, TX = BN / 4, PB = BM + BN - 1;
  constexpr int STAGE = (BN + PB) * HD;
  extern __shared__ __align__(16) unsigned char v1_smem[];
  const int ldc = (Tn + 3) & ~3;
  float* sc = reinterpret_cast<float*>(v1_smem);
  T* q_u = reinterpret_cast<T*>(sc + BM * ldc);
  T* q_v = q_u + BM * HD;
  T* ring = q_v + BM * HD;

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int t0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int kv_len = min(lengths[b], Tn);
  // keys past kv_len carry -1e9 and get probability exactly 0 once a valid
  // key is seen; an item with no valid key averages all Tn keys
  const int n_keys = kv_len > 0 ? kv_len : Tn;
  const int n4 = (n_keys + 3) & ~3;
  const int tiles = (n_keys + BN - 1) / BN;
  const size_t head = (size_t)bh * Tn * HD;
  const T* ph = pos + (size_t)h * (2 * Tn - 1) * HD;

  // band row j of key tile s0 holds P[Tn - BM - t0 + s0 + j]
  auto load_keys = [&](int it) {
    T* stage = ring + (it & 1) * STAGE;
    v1_copy_rows<T, HD, THREADS>(stage, kh + head, it * BN, BN, Tn, tid);
    v1_copy_rows<T, HD, THREADS>(stage + BN * HD, ph, Tn - BM - t0 + it * BN, PB, 2 * Tn - 1, tid);
  };
  auto load_values = [&](int it) {
    v1_copy_rows<T, HD, THREADS>(ring + (it & 1) * STAGE, vh + head, it * BN, BN, Tn, tid);
  };

  v1_copy_rows<T, HD, THREADS>(q_u, qu + head, t0, BM, Tn, tid);
  v1_copy_rows<T, HD, THREADS>(q_v, qv + head, t0, BM, Tn, tid);
  load_keys(0);
  cp_async_commit();

  const int ty = tid / TX, tx = tid - ty * TX;
  const int band0 = tx * 4 - ty * 4 + BM - 4;
  for (int it = 0; it < tiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile it is in; every thread is done with tile it - 1's stage
    if (it + 1 < tiles) load_keys(it + 1);
    cp_async_commit();
    const T* ks = ring + (it & 1) * STAGE;
    const T* pb = ks + BN * HD;
    float c[4][4], p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = p[i][j] = 0.f;
#pragma unroll 2
    for (int e = 0; e < HD; e += 4) {
      float4 a[4], k[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ld4(q_u + v1_swz<T, HD>(ty * 4 + i, e));
#pragma unroll
      for (int j = 0; j < 4; ++j) k[j] = ld4(ks + v1_swz<T, HD>(tx * 4 + j, e));
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          c[i][j] = fmaf(a[i].x, k[j].x, c[i][j]);
          c[i][j] = fmaf(a[i].y, k[j].y, c[i][j]);
          c[i][j] = fmaf(a[i].z, k[j].z, c[i][j]);
          c[i][j] = fmaf(a[i].w, k[j].w, c[i][j]);
        }
      float4 band[7];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ld4(q_v + v1_swz<T, HD>(ty * 4 + i, e));
#pragma unroll
      for (int q = 0; q < 7; ++q) band[q] = ld4(pb + v1_swz<T, HD>(band0 + q, e));
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 r = band[j - i + 3];
          p[i][j] = fmaf(a[i].x, r.x, p[i][j]);
          p[i][j] = fmaf(a[i].y, r.y, p[i][j]);
          p[i][j] = fmaf(a[i].z, r.z, p[i][j]);
          p[i][j] = fmaf(a[i].w, r.w, p[i][j]);
        }
    }
    const int s = it * BN + tx * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = s + j < kv_len ? (c[i][j] + p[i][j]) * scale : -1e9f;
      float* row = sc + (ty * 4 + i) * ldc;
      if (s + 4 <= n_keys) {
        *reinterpret_cast<float4*>(row + s) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (s + j < n_keys) row[s + j] = v[j];
      }
    }
  }
  __syncthreads();  // all scores written; the ring is free
  load_values(0);
  cp_async_commit();

  constexpr int WARPS = THREADS / 32;
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < BM; r += WARPS) {
    float* row = sc + r * ldc;
    float m = -INFINITY;
    for (int s = lane; s < n_keys; s += 32) m = fmaxf(m, row[s]);
    m = warp_max(m);
    float l = 0.f;
    for (int s = lane; s < n_keys; s += 32) {
      const float e = expf(row[s] - m);
      row[s] = e;
      l += e;
    }
    l = warp_sum(l);
    for (int s = lane; s < n_keys; s += 32) row[s] = round_to<T>(row[s] / l);
    if (lane < n4 - n_keys) row[n_keys + lane] = 0.f;
  }

  constexpr int DPT = HD * BM / (4 * THREADS) > 4 ? HD * BM / (4 * THREADS) : 4;
  constexpr int CG = HD / DPT, G = DPT / 4;
  const int rg = tid / CG, cg = tid - rg * CG;
  const bool active = rg < BM / 4;
  float acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[i][d] = 0.f;
  for (int it = 0; it < tiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // values of tile it are in (and, first, every probability)
    if (it + 1 < tiles) load_values(it + 1);
    cp_async_commit();
    const T* vs = ring + (it & 1) * STAGE;
    const int s0 = it * BN, lim = min(BN, n4 - s0);
    if (active) {
      for (int k = 0; k < lim; k += 4) {
        float pr[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 v = ld4(sc + (rg * 4 + i) * ldc + s0 + k);
          pr[i][0] = v.x; pr[i][1] = v.y; pr[i][2] = v.z; pr[i][3] = v.w;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float4 v = ld4(vs + v1_swz<T, HD>(k + q, (cg + CG * g) * 4));
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[i][g * 4 + 0] = fmaf(pr[i][q], v.x, acc[i][g * 4 + 0]);
              acc[i][g * 4 + 1] = fmaf(pr[i][q], v.y, acc[i][g * 4 + 1]);
              acc[i][g * 4 + 2] = fmaf(pr[i][q], v.z, acc[i][g * 4 + 2]);
              acc[i][g * 4 + 3] = fmaf(pr[i][q], v.w, acc[i][g * 4 + 3]);
            }
          }
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + rg * 4 + i;
    if (t >= Tn) continue;
    T* o = out + head + (size_t)t * HD;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int d = 0; d < 4; ++d) st(o + (cg + CG * g) * 4 + d, acc[i][g * 4 + d]);
  }
}

template <typename T, int HD, int BM, int BN>
cudaError_t launch_v1_onepass(const void* qu, const void* qv, const void* kh, const void* vh,
                              const void* pos, const int* lengths, void* out, int B, int Tn, int H,
                              int smem, cudaStream_t stream) {
  // the caller's plan must agree with this kernel's layout
  if ((size_t)smem != v1_onepass_smem<T, HD, BM, BN>(Tn)) return cudaErrorInvalidValue;
  auto kernel = rel_attn_v1_onepass_kernel<T, HD, BM, BN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tn + BM - 1) / BM, B * H);
  kernel<<<grid, BM * BN / 16, smem, stream>>>(
      static_cast<const T*>(qu), static_cast<const T*>(qv), static_cast<const T*>(kh),
      static_cast<const T*>(vh), static_cast<const T*>(pos), lengths, static_cast<T*>(out), Tn, H,
      1.f / sqrtf((float)HD));
  return cudaGetLastError();
}

// rows: the plan's query rows per block, 64, 32 or 16 (key tiles of 32, 64
// and 64), or 0 for the two-pass kernel
template <typename T, int HD>
cudaError_t launch_v1_planned(const void* qu, const void* qv, const void* kh, const void* vh,
                              const void* pos, const int* lengths, void* out, int B, int Tn, int H,
                              int rows, int smem, cudaStream_t stream) {
  switch (rows) {
    case 0: return launch_v1<T, HD>(qu, qv, kh, vh, pos, lengths, out, B, Tn, H, stream);
    case 64:
      return launch_v1_onepass<T, HD, 64, 32>(qu, qv, kh, vh, pos, lengths, out, B, Tn, H, smem, stream);
    case 32:
      return launch_v1_onepass<T, HD, 32, 64>(qu, qv, kh, vh, pos, lengths, out, B, Tn, H, smem, stream);
    case 16:
      return launch_v1_onepass<T, HD, 16, 64>(qu, qv, kh, vh, pos, lengths, out, B, Tn, H, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int run_v1(const void* qu, const void* qv, const void* kh, const void* vh, const void* pos,
           const int* lengths, void* out, int B, int H, int Tn, int HD, int rows, int smem,
           cudaStream_t stream) {
  switch (HD) {
    case 32:
      return (int)launch_v1_planned<T, 32>(qu, qv, kh, vh, pos, lengths, out, B, Tn, H, rows, smem, stream);
    case 64:
      return (int)launch_v1_planned<T, 64>(qu, qv, kh, vh, pos, lengths, out, B, Tn, H, rows, smem, stream);
    case 128:
      return (int)launch_v1_planned<T, 128>(qu, qv, kh, vh, pos, lengths, out, B, Tn, H, rows, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. qu, qv, kh, vh, out (B, H, T, hd); pos
// (H, 2T-1, hd), all in the activation dtype; lengths (B,) int32 valid keys.
// hd in {32, 64, 128}. rows, smem: the launch plan (ops/rel_attention.py
// v1_plan): query rows per block of the one-pass kernel and its shared
// memory in bytes, or rows 0 for the two-pass kernel (smem unused).
int pk_rel_attention_v1(int dtype, const void* qu, const void* qv, const void* kh, const void* vh,
                        const void* pos, const int* lengths, void* out, int B, int H, int T,
                        int HD, int rows, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_v1<float>(qu, qv, kh, vh, pos, lengths, out, B, H, T, HD, rows, smem, s);
  if (dtype == 1)
    return run_v1<__nv_bfloat16>(qu, qv, kh, vh, pos, lengths, out, B, H, T, HD, rows, smem, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
