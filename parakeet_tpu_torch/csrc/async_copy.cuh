// 16-byte asynchronous copies from device memory to shared memory
// (cp.async, sm_80 and later) for the kernels that stream tiles through a
// ring of shared-memory stages: the shared GEMM (ffn_gemm.cuh), K1's f32 core
// (rel_attention.cuh) and K2's one-pass core (rel_attention_v1.cu).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Copy 16 bytes from gmem to smem, or write 16 zero bytes when !valid
// (gmem is then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace
