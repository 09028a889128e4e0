// Fused TransMLP stack for NVIDIA Hopper (sm_90a), f32.
//
// Replaces livelyspeaker_tpu/ops/pallas/fused_mlp.py: fused_transmlp (the
// Pallas TPU kernel `_kernel`). For each of L blocks, on one [S, D] sequence:
//   x += emb
//   x += act(token_w @ LN1(x) + token_b)        token mix [S, S] over rows
//   x += act(LN2(x) @ ch_w + ch_b)              channel mix [D, D]
// then optionally the pose projection y = x @ out_w + out_b, of which only
// the F real columns are written. With ln2_scale == nullptr the LN2 affine is
// taken as folded into ch_w / ch_b (pack_transmlp_params(fold_ln2=True)).
//
// What bounds it on the card: at the serving shapes (S = 35 or 36, D = 512,
// L = 8) the channel mix is 97% of the FLOPs; the activation is small
// (36 x 512 x 4 B = 72 KB) but the per-layer weight is 1 MB, far more than a
// block's shared memory. This design keeps the whole activation of one
// sequence resident in shared memory for all L blocks (no device-memory
// round trip between the 2L mixes and 2L layer norms), and streams ch_w
// from L2 through shared memory in K-tiles of 16 rows. Each of the 256
// threads owns a 9-row x 8-column register tile of the [36, 512] output,
// so one K step costs 17 shared-memory reads for 72 FMAs. All arithmetic
// is f32 FMA with f32 accumulation (no tensor cores, no TF32): the kernel
// is bound by the FP32 pipe and by shared-memory bandwidth. One block per
// sequence means a small batch leaves most SMs idle; wgmma, TMA and
// splitting a sequence across a cluster are later work.
//
// The device code is in transmlp_common.cuh, shared with the training
// kernels of fused_transmlp_train.cu; this file is the stash-free launch.

#include "transmlp_common.cuh"

namespace {

__global__ void __launch_bounds__(kThreads, 1)
fused_transmlp_kernel(const StackParams p) {
  extern __shared__ float smem[];
  stack_forward(p, smem);
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the attribute call or the
// launch (0 on success). ln2_s/ln2_b null: LN2 folded. ow/ob null: no pose
// projection, out is [B, S, D].
extern "C" int fused_transmlp_launch(
    const float* x, const float* emb, const float* ln1_s, const float* ln1_b,
    const float* tw, const float* tb, const float* ln2_s, const float* ln2_b,
    const float* cw, const float* cb, const float* ow, const float* ob,
    float* out, int B, int S, int D, int L, int F, int act, void* stream) {
  if (B < 0 || S < 1 || S > kSPad || D < kKTile || D > kMaxN || D % kKTile != 0 ||
      L < 1 || act < kSilu || act > kLrelu02 ||
      (ow != nullptr && (F < 1 || F > kMaxN)) || ((ln2_s == nullptr) != (ln2_b == nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = stack_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      fused_transmlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return 0;
  StackParams p{x, emb, ln1_s, ln1_b, tw, tb, ln2_s, ln2_b, cw, cb, ow, ob, out,
                nullptr, B, S, D, L, F, act};
  fused_transmlp_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
