// Asynchronous copies from global to shared memory (cp.async, sm_80 on),
// used by the rings of tiles of mamba_scan_bwd.cu and ich_moe_bwd.cu. A
// copy with ok == false reads nothing and writes zeros (src-size 0), so a
// tile's edge needs no other path. Copies join a group at cp_commit;
// cp_wait<N> returns once at most N of this thread's groups are still in
// flight, and a __syncthreads after it makes every thread's landed copies
// visible to the whole CTA.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ich {

// 16 bytes; both addresses 16-byte aligned
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes; both addresses 4-byte aligned
__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

}  // namespace ich
