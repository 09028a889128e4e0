// Hopper warpgroup products (wgmma), shared by the two K1 kernels
// (fused_transmlp.cu in 3xTF32, fused_transmlp_bf16.cu in bf16): the
// shared-memory descriptor of a K-major operand in the 128-byte swizzle, the
// fence, commit and wait of the asynchronous products, a register fence that
// keeps the compiler from moving accesses of the accumulators across a wait,
// and the proxy fence a thread's generic writes of shared memory need before
// wgmma or TMA read them.

#pragma once

#include <stdint.h>

namespace {

// The shared-memory descriptor of a K-major operand in the 128-byte swizzle:
// 8-row groups 1024 bytes apart (SBO), the leading offset unused; the tile
// starts 1024-byte aligned, and a step of 32 bytes of k adds 32 to the start.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keeps the compiler from moving accesses of the accumulators across a wait
template <int NA>
__device__ __forceinline__ void fence_acc(float (&d)[NA]) {
#pragma unroll
  for (int i = 0; i < NA; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Orders this thread's generic writes of shared memory anywhere in the
// cluster before later async-proxy (wgmma, TMA) accesses of it.
__device__ __forceinline__ void fence_proxy_async_cluster() {
  asm volatile("fence.proxy.async.shared::cluster;" ::: "memory");
}

}  // namespace
