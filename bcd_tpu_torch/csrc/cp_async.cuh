// Asynchronous copies from device to shared memory (cp.async), shared by
// the kernels of csrc/probes.cu and csrc/bisect.cu.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// an asynchronous copy of kBytes (4, 8 or 16) from device to shared memory;
// the bytes past src_bytes (0 or kBytes) are zero-filled
template <int kBytes>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src),
               "n"(kBytes), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

}  // namespace
