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
// One kernel, grid (T/64, B*H), 256 threads: 64 query rows of one (b, h),
// 4 threads per row, each owning hd/4 of the head dims. Keys stream through
// shared memory in tiles of 32 with the band of 64+32-1 P rows the tile's
// scores read (the rel_shift becomes an index, as in K1). Because the
// reference rounds the normalised probabilities to T before AV, the row
// max and sum must be known before any probability is formed, so the key
// tiles are read twice: pass 1 keeps a running max and rescaled sum, pass 2
// recomputes each score, rounds exp(score - max) / sum and accumulates AV.
// Nothing of size T^2 reaches device memory and there is no length cap
// (the reference's v1 path stops at T = 768 for VMEM; above it the
// reference runs XLA attention, which computes the same function).
//
// What bounds it on the card: the scores cost 2 * 2 * B*H*T^2*hd FMAs
// (two passes) and AV B*H*T^2*hd, all IEEE f32 FMA on the CUDA cores with
// one shared-memory load per FMA, so shared-memory bandwidth bounds it, as
// it bounds K1's core. Register blocking and a single pass that keeps the
// unnormalised scores on chip are later work.
//
// Plain C interface, loaded with ctypes. Returns cudaGetLastError() (0 =
// success).

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

template <typename T>
int run_v1(const void* qu, const void* qv, const void* kh, const void* vh, const void* pos,
           const int* lengths, void* out, int B, int H, int Tn, int HD, cudaStream_t stream) {
  switch (HD) {
    case 32: return (int)launch_v1<T, 32>(qu, qv, kh, vh, pos, lengths, out, B, Tn, H, stream);
    case 64: return (int)launch_v1<T, 64>(qu, qv, kh, vh, pos, lengths, out, B, Tn, H, stream);
    case 128: return (int)launch_v1<T, 128>(qu, qv, kh, vh, pos, lengths, out, B, Tn, H, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. qu, qv, kh, vh, out (B, H, T, hd); pos
// (H, 2T-1, hd), all in the activation dtype; lengths (B,) int32 valid keys.
// hd in {32, 64, 128}.
int pk_rel_attention_v1(int dtype, const void* qu, const void* qv, const void* kh, const void* vh,
                        const void* pos, const int* lengths, void* out, int B, int H, int T,
                        int HD, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run_v1<float>(qu, qv, kh, vh, pos, lengths, out, B, H, T, HD, s);
  if (dtype == 1) return run_v1<__nv_bfloat16>(qu, qv, kh, vh, pos, lengths, out, B, H, T, HD, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
