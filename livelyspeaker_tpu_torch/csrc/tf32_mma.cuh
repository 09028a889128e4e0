// Device helpers of the 3xTF32 tensor-core products and of the staging that
// feeds them, shared by K1 and K2 (fused_transmlp.cu and
// fused_transmlp_train.cu, through transmlp_common.cuh) and K3
// (fused_wav.cu):
// - shared-memory addresses, and cp.async copies from device memory into
//   shared memory (16 bytes, or 4), zero-filled when the source is out of
//   range, with their commit groups and mbarrier arrivals; mbarriers'
//   initialisation, arrivals and waits; the 1-D bulk (TMA) copy and the
//   proxy fence it needs after generic reads of its destination;
// - f32 split into two TF32 halves rounded to nearest, ties away from zero;
// - the m16n8k8 TF32 mma.sync with f32 accumulators.
//
// 3xTF32: each operand is split, x = hi + lo with hi = rna_tf32(x) and
// lo = rna_tf32(x - hi), and each product runs as lo.hi + hi.lo + hi.hi
// (lo.lo is below f32's rounding). One pass of TF32 leaves relative errors
// of about 3e-4. The tensor cores do not round their sums to nearest, so a
// caller sums each short stage of rows in a fresh accumulator and adds it
// into its running f32 sum with an ordinary add.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero; the low 13 bits cleared), in two integer operations: half a
// TF32 ulp added to the magnitude, then truncated. The instruction itself
// becomes about four (a NaN test and a select besides); the operands here
// are finite, and a NaN still reaches the product through lo.
__device__ __forceinline__ float to_tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// x = hi + lo, both TF32
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - hi);
}

// d += a b, a 16 x 8 (row) and b 8 x 8 (col) TF32 fragments, d 16 x 8 f32
__device__ __forceinline__ void mma_tf32(float (&d)[4], const float (&a)[4], const float (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])), "r"(__float_as_uint(a[2])),
        "r"(__float_as_uint(a[3])), "r"(__float_as_uint(b[0])), "r"(__float_as_uint(b[1])));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !in
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

// 4 bytes from global to shared memory, or a zero when !in
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

// closes this thread's group of cp.async copies issued since the last one
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// waits until at most N of this thread's groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// an arrival on bar once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// One arrival that also expects `bytes` of bulk copies on the barrier.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Makes the initialised mbarriers visible to the async proxy (the TMA copies).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Orders this thread's view of shared memory, including what other threads
// released to it through an mbarrier, before its later async-proxy (TMA)
// accesses: a bulk copy into a buffer that generic loads have just read
// must come after it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// A TMA copy of `bytes` contiguous bytes (a multiple of 16, both ends
// 16-byte aligned) into this CTA's shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_1d(float* dst, const float* src, uint32_t bytes,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

}  // namespace
