// Shared device helpers of the port's hand-written kernels (sm_90a): dtype
// loads and stores, rounding to the activation dtype, the f32 sigmoid, a
// warp sum, and the whole-row LayerNorm that K6, K1 and K5 (and K4, K7
// through them in f32) run once before their first GEMM; in bf16 K7 and K4
// LayerNorm inside their GEMMs. The GEMMs are ffn_gemm.cuh's, the only GEMM
// header in the port.
//
// What bounds the LayerNorm: its bytes (one read of x for the statistics,
// one more for the output, one write); a warp per row keeps each row's
// reads in one warp's registers and caches, and needs no shared memory.
//
// Every source that includes this header is hashed with it by
// ops/_build.py, so an edit here rebuilds each library that uses it.

#pragma once

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

// 1 / (1 + exp(-x)) in f32, as the reference kernels' sigmoid_f32.
__device__ __forceinline__ float sigmoid_f32(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ─── Whole LayerNorm over rows: one warp per row ───────────────────────────
// out = round_T((x - mean) * rstd * w + b), f32 statistics, w and b f32.

template <typename T>
__global__ void layer_norm_rows_kernel(const T* __restrict__ x, const float* __restrict__ w,
                                       const float* __restrict__ b, T* __restrict__ out, int M,
                                       int K, float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const T* xr = x + (size_t)row * K;
  float s = 0.f;
  for (int k = lane; k < K; k += 32) s += ld(xr + k);
  const float mean = warp_sum(s) / (float)K;
  float v = 0.f;
  for (int k = lane; k < K; k += 32) {
    const float d = ld(xr + k) - mean;
    v += d * d;
  }
  const float rstd = 1.f / sqrtf(warp_sum(v) / (float)K + eps);
  T* o = out + (size_t)row * K;
  for (int k = lane; k < K; k += 32) st(o + k, (ld(xr + k) - mean) * rstd * w[k] + b[k]);
}

template <typename T>
cudaError_t launch_layer_norm_rows(const void* x, const float* w, const float* b, void* out,
                                   int M, int K, float eps, cudaStream_t stream) {
  const int threads = 256, rows_per_block = threads / 32;
  layer_norm_rows_kernel<T><<<(M + rows_per_block - 1) / rows_per_block, threads, 0, stream>>>(
      static_cast<const T*>(x), w, b, static_cast<T*>(out), M, K, eps);
  return cudaGetLastError();
}

}  // namespace
