// cp.async helpers shared by the kernels that stage global memory into
// shared memory asynchronously (conv1_recompute.cuh for K1/K4, gru_bwd.cu).
#pragma once

#include <cuda_runtime.h>

namespace {

// cp.async of one float into shared memory; zero-filled when !valid (src is
// then any valid address and is not read).
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

}  // namespace
