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

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowGroups = 4;                         // thread rows of the tile
constexpr int kColGroups = kThreads / kRowGroups;     // 64 thread columns
constexpr int kRowsPerThread = 9;
constexpr int kSPad = kRowGroups * kRowsPerThread;    // 36: largest S
constexpr int kColsPerThread = 8;
constexpr int kMaxN = kColGroups * kColsPerThread;    // 512: largest D and F
constexpr int kKTile = 16;
constexpr float kEps = 1e-5f;

enum Act { kSilu = 0, kRelu = 1, kGelu = 2 };

struct Params {
  const float* x;       // [B, S, D]
  const float* emb;     // [B, D]
  const float* ln1_s;   // [L, D]
  const float* ln1_b;   // [L, D]
  const float* tw;      // [L, S, S]
  const float* tb;      // [L, S]
  const float* ln2_s;   // [L, D] or nullptr (folded)
  const float* ln2_b;   // [L, D] or nullptr (folded)
  const float* cw;      // [L, D, D], [in, out]
  const float* cb;      // [L, D]
  const float* ow;      // [D, F] or nullptr (no pose projection)
  const float* ob;      // [F]
  float* out;           // [B, S, F] with ow, else [B, S, D]
  int S, D, L, F, act;
};

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kSilu) return v / (1.0f + expf(-v));
  if (act == kRelu) return fmaxf(v, 0.0f);
  // jax.nn.gelu's default: the tanh approximation
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * v * (1.0f + tanhf(c * (v + 0.044715f * v * v * v)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// dst[r] = LN(src[r]) (* g + b when g != nullptr), rows r < S; one warp a row,
// two-pass statistics in f32.
__device__ void layer_norm_rows(const float* src, float* dst, int S, int D,
                                const float* __restrict__ g,
                                const float* __restrict__ b) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < S; r += kWarps) {
    const float* row = src + r * D;
    float s = 0.0f;
    for (int k = lane; k < D; k += 32) s += row[k];
    const float mean = warp_sum(s) / D;
    float v = 0.0f;
    for (int k = lane; k < D; k += 32) {
      const float d = row[k] - mean;
      v += d * d;
    }
    const float inv = 1.0f / sqrtf(warp_sum(v) / D + kEps);
    for (int k = lane; k < D; k += 32) {
      float y = (row[k] - mean) * inv;
      if (g != nullptr) y = y * __ldg(g + k) + __ldg(b + k);
      dst[r * D + k] = y;
    }
  }
}

// x[i, d] += act(sum_j tw[i, j] h[j, d] + tb[i]) for i < S. tw_s is the
// [kSPad, kSPad] token mix, zero outside [S, S]; h rows >= S are zero.
__device__ void token_mix(const float* h_s, const float* tw_s,
                          const float* __restrict__ tb, float* x_s, int S,
                          int D, int act) {
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float col[kSPad];
#pragma unroll
    for (int j = 0; j < kSPad; ++j) col[j] = h_s[j * D + d];
    for (int i = 0; i < S; ++i) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < kSPad; ++j) acc = fmaf(tw_s[i * kSPad + j], col[j], acc);
      x_s[i * D + d] += activate(acc + __ldg(tb + i), act);
    }
  }
}

// acc[i][c] = sum_k a_s[row_i, k] w[k, col_c] over k < K, for this thread's
// rows row_i = rg * kRowsPerThread + i and columns col_c = cg + kColGroups*c;
// w is [K, N] in device memory, staged in K-tiles through w_s.
__device__ void matmul_tile(const float* a_s, const float* __restrict__ w,
                            int K, int N, float* w_s,
                            float (&acc)[kRowsPerThread][kColsPerThread]) {
  const int tid = threadIdx.x;
  const int rg = tid / kColGroups, cg = tid % kColGroups;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) acc[i][c] = 0.0f;
  const float* a_row = a_s + rg * kRowsPerThread * K;
  for (int k0 = 0; k0 < K; k0 += kKTile) {
    __syncthreads();  // the previous tile is consumed and a_s is complete
    for (int idx = tid; idx < kKTile * kMaxN; idx += kThreads) {
      const int r = idx / kMaxN, c = idx % kMaxN, k = k0 + r;
      w_s[idx] = (k < K && c < N) ? __ldg(w + (size_t)k * N + c) : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kKTile; ++kk) {
      float av[kRowsPerThread], wv[kColsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) av[i] = a_row[i * K + k0 + kk];
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c)
        wv[c] = w_s[kk * kMaxN + cg + kColGroups * c];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c)
          acc[i][c] = fmaf(av[i], wv[c], acc[i][c]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
fused_transmlp_kernel(const Params p) {
  extern __shared__ float smem[];
  const int S = p.S, D = p.D;
  float* x_s = smem;                    // [kSPad, D] activation
  float* h_s = x_s + kSPad * D;         // [kSPad, D] normalised activation
  float* w_s = h_s + kSPad * D;         // [kKTile, kMaxN] weight tile
  float* tw_s = w_s + kKTile * kMaxN;   // [kSPad, kSPad] token mix

  const int tid = threadIdx.x;
  const int rg = tid / kColGroups, cg = tid % kColGroups;
  const size_t b = blockIdx.x;
  const float* __restrict__ xg = p.x + b * S * D;
  const float* __restrict__ eg = p.emb + b * D;

  // rows >= S stay zero for the whole kernel: they only feed rows >= S
  for (int idx = tid; idx < kSPad * D; idx += kThreads) {
    x_s[idx] = idx < S * D ? __ldg(xg + idx) : 0.0f;
    h_s[idx] = 0.0f;
  }
  __syncthreads();

  float acc[kRowsPerThread][kColsPerThread];
  for (int l = 0; l < p.L; ++l) {
    for (int idx = tid; idx < S * D; idx += kThreads) x_s[idx] += __ldg(eg + idx % D);
    const float* tw = p.tw + (size_t)l * S * S;
    for (int idx = tid; idx < kSPad * kSPad; idx += kThreads) {
      const int i = idx / kSPad, j = idx % kSPad;
      tw_s[idx] = (i < S && j < S) ? __ldg(tw + i * S + j) : 0.0f;
    }
    __syncthreads();
    layer_norm_rows(x_s, h_s, S, D, p.ln1_s + l * D, p.ln1_b + l * D);
    __syncthreads();
    token_mix(h_s, tw_s, p.tb + l * S, x_s, S, D, p.act);
    __syncthreads();
    const bool folded = p.ln2_s == nullptr;
    layer_norm_rows(x_s, h_s, S, D, folded ? nullptr : p.ln2_s + l * D,
                    folded ? nullptr : p.ln2_b + l * D);
    matmul_tile(h_s, p.cw + (size_t)l * D * D, D, D, w_s, acc);
    const float* cb = p.cb + l * D;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = rg * kRowsPerThread + i;
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) {
        const int col = cg + kColGroups * c;
        if (row < S && col < D)
          x_s[row * D + col] += activate(acc[i][c] + __ldg(cb + col), p.act);
      }
    }
    __syncthreads();
  }

  if (p.ow != nullptr) {
    matmul_tile(x_s, p.ow, D, p.F, w_s, acc);
    float* og = p.out + b * S * p.F;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = rg * kRowsPerThread + i;
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) {
        const int col = cg + kColGroups * c;
        if (row < S && col < p.F) og[row * p.F + col] = acc[i][c] + __ldg(p.ob + col);
      }
    }
  } else {
    float* og = p.out + b * S * D;
    for (int idx = tid; idx < S * D; idx += kThreads) og[idx] = x_s[idx];
  }
}

size_t smem_bytes(int D) {
  return (size_t)(2 * kSPad * D + kKTile * kMaxN + kSPad * kSPad) * sizeof(float);
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
      L < 1 || act < kSilu || act > kGelu ||
      (ow != nullptr && (F < 1 || F > kMaxN)) || ((ln2_s == nullptr) != (ln2_b == nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      fused_transmlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return 0;
  Params p{x, emb, ln1_s, ln1_b, tw, tb, ln2_s, ln2_b, cw, cb, ow, ob, out,
           S, D, L, F, act};
  fused_transmlp_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
