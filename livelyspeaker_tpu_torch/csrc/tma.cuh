// The Tensor Memory Accelerator's 2-D copies, shared by K1 and K2 (through
// transmlp_common.cuh) and the grouped SwiGLU (grouped_swiglu.cu): the
// encoder of a tensor map, reached through the runtime (nothing links
// libcuda), and the copy of one box into shared memory completing on an
// mbarrier.

#pragma once

#include <cuda.h>  // CUtensorMap
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"  // smem_addr

namespace {

// A TMA copy of the box of `map` at (column x0, row y0) into this CTA's
// shared memory (128-byte aligned), completing on `bar`.
__device__ __forceinline__ void tma_load_2d(float* dst, const CUtensorMap* map, int x0, int y0,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)),
        "r"(x0), "r"(y0)
      : "memory");
}

// cuTensorMapEncodeTiled, reached through the runtime (nothing links libcuda)
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(sym);
  }
  return fn;
}

}  // namespace
