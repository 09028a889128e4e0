// Device code shared by the fused TransMLP forward (fused_transmlp.cu) and
// its training forward and backward (fused_transmlp_train.cu): the block
// shape, the activations and their derivatives, the row LayerNorm, the
// token mix and the register-tiled channel-mix product, and the whole
// L-block forward of one sequence with an optional stash of block inputs.
//
// One block of kThreads threads works on one [S, D] sequence held in shared
// memory, S <= kSPad = 36 and D <= kMaxN = 512. Rows S..kSPad-1 of every
// shared tile are kept zero, so they only ever feed rows that are not
// written back.

#pragma once

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

// Activation codes, as the Python wrappers number them. gelu has no
// derivative here: the training kernels reject it, as the JAX package does.
enum Act { kSilu = 0, kRelu = 1, kGelu = 2, kLrelu = 3, kLrelu01 = 4, kLrelu02 = 5 };

__device__ __forceinline__ float leak_slope(int act) {
  return act == kLrelu ? 0.01f : (act == kLrelu01 ? 0.1f : 0.2f);
}

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kSilu) return v / (1.0f + expf(-v));
  if (act == kRelu) return fmaxf(v, 0.0f);
  if (act == kGelu) {
    // jax.nn.gelu's default: the tanh approximation
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * v * (1.0f + tanhf(c * (v + 0.044715f * v * v * v)));
  }
  return v > 0.0f ? v : leak_slope(act) * v;
}

// d act / d v for silu, relu and the leaky relus.
__device__ __forceinline__ float dactivate(float v, int act) {
  if (act == kSilu) {
    const float s = 1.0f / (1.0f + expf(-v));
    return s * (1.0f + v * (1.0f - s));
  }
  if (act == kRelu) return v > 0.0f ? 1.0f : 0.0f;
  return v > 0.0f ? 1.0f : leak_slope(act);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// dst[r] = LN(src[r]) (* g + b when g != nullptr), rows r < S; one warp a row,
// two-pass statistics in f32. Optionally also records each row's mean and
// 1/std (shared memory) and writes the normalised row xhat and the result to
// device memory ([S, D] row-major).
__device__ void layer_norm_rows(const float* src, float* dst, int S, int D,
                                const float* __restrict__ g,
                                const float* __restrict__ b,
                                float* mean_out = nullptr, float* inv_out = nullptr,
                                float* xhat_g = nullptr, float* y_g = nullptr) {
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
    if (lane == 0 && mean_out != nullptr) mean_out[r] = mean;
    if (lane == 0 && inv_out != nullptr) inv_out[r] = inv;
    for (int k = lane; k < D; k += 32) {
      const float xh = (row[k] - mean) * inv;
      float y = xh;
      if (g != nullptr) y = y * __ldg(g + k) + __ldg(b + k);
      dst[r * D + k] = y;
      if (xhat_g != nullptr) xhat_g[r * D + k] = xh;
      if (y_g != nullptr) y_g[r * D + k] = y;
    }
  }
}

// x[i, d] += act(sum_j tw[i, j] h[j, d] + tb[i]) for i < S. tw_s is the
// [kSPad, kSPad] token mix, zero outside [S, S]; h rows >= S are zero. With
// m_g != nullptr the pre-activation is also written there ([S, D]).
__device__ void token_mix(const float* h_s, const float* tw_s,
                          const float* __restrict__ tb, float* x_s, int S,
                          int D, int act, float* m_g = nullptr) {
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float col[kSPad];
#pragma unroll
    for (int j = 0; j < kSPad; ++j) col[j] = h_s[j * D + d];
    for (int i = 0; i < S; ++i) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < kSPad; ++j) acc = fmaf(tw_s[i * kSPad + j], col[j], acc);
      const float m = acc + __ldg(tb + i);
      if (m_g != nullptr) m_g[i * D + d] = m;
      x_s[i * D + d] += activate(m, act);
    }
  }
}

// acc[i][c] = sum_k a_s[row_i, k] w[k, col_c] over k < K, for this thread's
// rows row_i = rg * kRowsPerThread + i and columns col_c = cg + kColGroups*c;
// w is [K, N] in device memory, staged in K-tiles through w_s. Starts with a
// __syncthreads(), so a_s may have been written just before the call.
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

struct StackParams {
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
  float* stash;         // [L, B, S, D] block inputs, or nullptr
  int B, S, D, L, F, act;
};

// Dynamic shared memory of stack_forward.
inline size_t stack_smem_bytes(int D) {
  return (size_t)(2 * kSPad * D + kKTile * kMaxN + kSPad * kSPad) * sizeof(float);
}

// The L-block stack (and the pose projection) for sequence blockIdx.x.
__device__ void stack_forward(const StackParams& p, float* smem) {
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

  for (int idx = tid; idx < kSPad * D; idx += kThreads) {
    x_s[idx] = idx < S * D ? __ldg(xg + idx) : 0.0f;
    h_s[idx] = 0.0f;
  }
  __syncthreads();

  float acc[kRowsPerThread][kColsPerThread];
  for (int l = 0; l < p.L; ++l) {
    float* sg = p.stash != nullptr ? p.stash + ((size_t)l * p.B + b) * S * D : nullptr;
    for (int idx = tid; idx < S * D; idx += kThreads) {
      const float v = x_s[idx];
      if (sg != nullptr) __stcs(sg + idx, v);  // streamed: keep ch_w in L2
      x_s[idx] = v + __ldg(eg + idx % D);
    }
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

}  // namespace
