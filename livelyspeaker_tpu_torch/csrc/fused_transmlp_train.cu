// Fused TransMLP stack for training on NVIDIA Hopper (sm_90a), f32: the
// forward with a stash of every block input, and its backward.
//
// Replaces livelyspeaker_tpu/ops/pallas/fused_mlp_train.py:
// fused_transmlp_train, the Pallas TPU kernels `_fwd_kernel` (forward and
// stash) and `_bwd_kernel` (backward). Per block, on one [S, D] sequence:
//   a  = x + emb
//   m1 = token_w @ LN1(a) + token_b,   r1 = a + act(m1)
//   m2 = LN2(r1) @ ch_w + ch_b,        y  = r1 + act(m2)
//
// Forward (fused_transmlp_train_fwd_kernel): K1's stack_forward, which also
// writes each block input to stash [L, B, S, D] (no padding; K1's layout).
//
// Backward, one layer at a time from the last, three launches per layer:
// 1. bwd_block_kernel, one block of 256 threads per sequence: recomputes
//    the block from its stashed input (LN statistics, m1, r1, h2, m2), and
//    walks it back: g_m2 = g * act'(m2), g_h2 = g_m2 @ ch_w^T, the LN2
//    backward, g_m1, g_h1 = token_w^T @ g_m1, the LN1 backward. It writes
//    the input cotangent g_a (in place over g), adds sum_s g_a to d(emb),
//    writes h2 and g_m2 to device memory for the channel-mix weight
//    gradient, and writes this sequence's share of every other parameter
//    gradient to a per-sequence row of `part`.
// 2. wgrad_kernel: d ch_w = h2^T g_m2 over all B*S rows, a [D, B*S] x
//    [B*S, D] product in 64 x 64 output tiles, the rows split into chunks
//    whose partial sums go to `wpart`.
// 3. reduce_kernel: sums `wpart` over the chunks and `part` over the batch,
//    in a fixed order, into this layer's rows of the gradients.
//
// What differs from the TPU kernel, and why:
// - The TPU kernel adds each batch tile's weight gradients into one output
//   block, which is safe there only because grid steps run in order. Blocks
//   on this card run in parallel, so each sequence (and each row chunk of
//   the channel-mix product) writes its own partial and a second pass sums
//   them: no atomics, and the sums are the same from run to run.
// - The TPU kernel keeps some 20 [S, D] tiles of one batch tile in VMEM. A
//   block here has 227 KB of shared memory, three such tiles. Two tiles
//   live in shared memory at a time; m1, xhat2, g_r1, h2 and g_m2 go to
//   device memory ([B, S, D] scratch each, mostly L2-resident while a layer
//   runs), and h1 and xhat1 are recomputed from the stash.
//
// What bounds it: at TED training shapes (B = 512, S = 35, D = 512, L = 8)
// the two [S, D] x [D, D] products per sequence and the [D, B*S] x [B*S, D]
// weight-gradient product are some 28 GFLOP per layer, all f32 FMA without
// tensor cores: the FP32 pipe is the bound. The scratch traffic is five
// [B, S, D] tiles a layer (37 MB each). wgmma and TMA are later work.

#include "transmlp_common.cuh"

namespace {

constexpr int kWT = 64;  // wgrad output tile (rows and columns)
constexpr int kWK = 16;  // wgrad rows staged per step

__global__ void __launch_bounds__(kThreads, 1)
fused_transmlp_train_fwd_kernel(const StackParams p) {
  extern __shared__ float smem[];
  stack_forward(p, smem);
}

struct BwdParams {
  const float* stash;   // [B, S, D] block inputs of this layer
  const float* emb;     // [B, D]
  const float* g_in;    // [B, S, D] cotangent of this layer's output
  float* g_out;         // [B, S, D] cotangent of its input; may alias g_in
  float* gemb;          // [B, D], summed over the layers
  int first;            // 1 on the first layer walked: gemb is set, not added
  const float* ln1_s;   // [D] of this layer, likewise below
  const float* ln1_b;
  const float* tw;      // [S, S]
  const float* tb;      // [S]
  const float* ln2_s;
  const float* ln2_b;
  const float* cw;      // [D, D], [in, out]
  const float* cw_t;    // [D, D], cw transposed
  const float* cb;
  float* m1_g;          // [B, S, D] scratch: token-mix pre-activation
  float* xhat2_g;       // [B, S, D] scratch: LN2's normalised input
  float* gr1_g;         // [B, S, D] scratch: cotangent of r1
  float* h2_g;          // [B, S, D] LN2 output, for the weight gradient
  float* gm2_g;         // [B, S, D] g_m2, for the weight gradient
  float* part;          // [B, P] per-sequence gradient partials
  int S, D, act;
};

// Offsets into one row of `part`.
__host__ __device__ inline int part_size(int S, int D) { return 5 * D + S + S * S; }
enum PartOff { kDs1 = 0, kDb1 = 1, kDs2 = 2, kDb2 = 3, kDcb = 4 };  // times D
__host__ __device__ inline int dtb_off(int D) { return 5 * D; }
__host__ __device__ inline int dtw_off(int S, int D) { return 5 * D + S; }

inline size_t bwd_smem_bytes(int D) {
  return (size_t)(2 * kSPad * D + kKTile * kMaxN + kSPad * kSPad + 3 * kSPad) *
         sizeof(float);
}

// The LayerNorm backward of the rows i < S, one warp a row: for g_y in
// gy_s, scale s, and the normalised input xhat(i, k) given by `xhat`,
//   out[i] = resid[i] + inv[i] * (g_y*s - mean(g_y*s) - xhat * mean(g_y*s*xhat)).
template <typename XhatFn>
__device__ void ln_backward_rows(const float* gy_s, const float* __restrict__ s,
                                 const float* inv, XhatFn xhat,
                                 const float* resid_g, float* out_s, int S, int D) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < S; r += kWarps) {
    float s1 = 0.0f, s2 = 0.0f;
    for (int k = lane; k < D; k += 32) {
      const float gx = gy_s[r * D + k] * __ldg(s + k);
      s1 += gx;
      s2 += gx * xhat(r, k);
    }
    const float m1 = warp_sum(s1) / D, m2 = warp_sum(s2) / D;
    for (int k = lane; k < D; k += 32) {
      const float gx = gy_s[r * D + k] * __ldg(s + k);
      out_s[r * D + k] = resid_g[r * D + k] + inv[r] * (gx - m1 - xhat(r, k) * m2);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
bwd_block_kernel(const BwdParams p) {
  extern __shared__ float smem[];
  const int S = p.S, D = p.D, P = part_size(S, D);
  float* t0 = smem;                     // [kSPad, D]
  float* t1 = t0 + kSPad * D;           // [kSPad, D]
  float* w_s = t1 + kSPad * D;          // [kKTile, kMaxN] weight tile
  float* tw_s = w_s + kKTile * kMaxN;   // [kSPad, kSPad] token mix
  float* mean1 = tw_s + kSPad * kSPad;  // [kSPad] LN1 statistics
  float* inv1 = mean1 + kSPad;
  float* inv2 = inv1 + kSPad;           // [kSPad] LN2's 1/std

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = tid / kColGroups, cg = tid % kColGroups;
  const size_t b = blockIdx.x, off = b * S * D;
  const float* __restrict__ xg = p.stash + off;
  const float* __restrict__ eg = p.emb + b * D;
  const float* g_in = p.g_in + off;
  float* part = p.part + b * P;
  auto xhat1 = [&](int r, int k) {
    return (__ldg(xg + r * D + k) + __ldg(eg + k) - mean1[r]) * inv1[r];
  };
  auto xhat2 = [&](int r, int k) { return p.xhat2_g[off + r * D + k]; };

  // t0 = a = x + emb, t1 = 0, tw_s = token mix (zero outside [S, S])
  for (int idx = tid; idx < kSPad * D; idx += kThreads) {
    t0[idx] = idx < S * D ? __ldg(xg + idx) + __ldg(eg + idx % D) : 0.0f;
    t1[idx] = 0.0f;
  }
  for (int idx = tid; idx < kSPad * kSPad; idx += kThreads) {
    const int i = idx / kSPad, j = idx % kSPad;
    tw_s[idx] = (i < S && j < S) ? __ldg(p.tw + i * S + j) : 0.0f;
  }
  __syncthreads();
  // t1 = h1 = LN1(a); then m1 to scratch and t0 = r1 = a + act(m1)
  layer_norm_rows(t0, t1, S, D, p.ln1_s, p.ln1_b, mean1, inv1);
  __syncthreads();
  token_mix(t1, tw_s, p.tb, t0, S, D, p.act, p.m1_g + off);
  __syncthreads();
  // t1 = h2 = LN2(r1), with xhat2 and h2 to device memory
  layer_norm_rows(t0, t1, S, D, p.ln2_s, p.ln2_b, nullptr, inv2, p.xhat2_g + off,
                  p.h2_g + off);
  // m2 = h2 @ cw + cb; t0 = g_m2 = g * act'(m2), also to device memory
  float acc[kRowsPerThread][kColsPerThread];
  matmul_tile(t1, p.cw, D, D, w_s, acc);
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = rg * kRowsPerThread + i;
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const int col = cg + kColGroups * c;
      if (row < S && col < D) {
        const float gm = g_in[row * D + col] * dactivate(acc[i][c] + __ldg(p.cb + col), p.act);
        t0[row * D + col] = gm;
        p.gm2_g[off + row * D + col] = gm;
      }
    }
  }
  __syncthreads();
  for (int d = tid; d < D; d += kThreads) {
    float s = 0.0f;
    for (int i = 0; i < S; ++i) s += t0[i * D + d];
    part[kDcb * D + d] = s;
  }
  // t1 = g_h2 = g_m2 @ cw^T
  matmul_tile(t0, p.cw_t, D, D, w_s, acc);
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = rg * kRowsPerThread + i;
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const int col = cg + kColGroups * c;
      if (row < S && col < D) t1[row * D + col] = acc[i][c];
    }
  }
  __syncthreads();
  // LN2 backward: d ln2 partials, and t0 = g_r1 = g + LN2'(g_h2)
  for (int d = tid; d < D; d += kThreads) {
    float ss = 0.0f, sb = 0.0f;
    for (int i = 0; i < S; ++i) {
      const float gy = t1[i * D + d];
      ss += gy * xhat2(i, d);
      sb += gy;
    }
    part[kDs2 * D + d] = ss;
    part[kDb2 * D + d] = sb;
  }
  ln_backward_rows(t1, p.ln2_s, inv2, xhat2, g_in, t0, S, D);
  __syncthreads();
  // g_r1 to device memory; t1 = g_m1 = g_r1 * act'(m1); t0 = h1 (recomputed)
  for (int idx = tid; idx < S * D; idx += kThreads) {
    const int r = idx / D, k = idx % D;
    const float gr1 = t0[idx];
    p.gr1_g[off + idx] = gr1;
    t1[idx] = gr1 * dactivate(p.m1_g[off + idx], p.act);
    t0[idx] = xhat1(r, k) * __ldg(p.ln1_s + k) + __ldg(p.ln1_b + k);
  }
  __syncthreads();
  // d token_b: row sums of g_m1. d token_w[i, j] = sum_d g_m1[i, d] h1[j, d],
  // one warp per 6 x 6 output tile, the lanes over d.
  for (int r = warp; r < S; r += kWarps) {
    float s = 0.0f;
    for (int k = lane; k < D; k += 32) s += t1[r * D + k];
    s = warp_sum(s);
    if (lane == 0) part[dtb_off(D) + r] = s;
  }
  constexpr int kT = 6, kTiles = kSPad / kT;
  for (int tile = warp; tile < kTiles * kTiles; tile += kWarps) {
    const int i0 = (tile / kTiles) * kT, j0 = (tile % kTiles) * kT;
    if (i0 >= S || j0 >= S) continue;
    float a6[kT][kT];
#pragma unroll
    for (int i = 0; i < kT; ++i)
#pragma unroll
      for (int j = 0; j < kT; ++j) a6[i][j] = 0.0f;
    for (int k = lane; k < D; k += 32) {
      float gi[kT], hj[kT];
#pragma unroll
      for (int i = 0; i < kT; ++i) gi[i] = t1[(i0 + i) * D + k];
#pragma unroll
      for (int j = 0; j < kT; ++j) hj[j] = t0[(j0 + j) * D + k];
#pragma unroll
      for (int i = 0; i < kT; ++i)
#pragma unroll
        for (int j = 0; j < kT; ++j) a6[i][j] = fmaf(gi[i], hj[j], a6[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kT; ++i)
#pragma unroll
      for (int j = 0; j < kT; ++j) {
        const float s = warp_sum(a6[i][j]);
        if (lane == 0 && i0 + i < S && j0 + j < S)
          part[dtw_off(S, D) + (i0 + i) * S + (j0 + j)] = s;
      }
  }
  __syncthreads();
  // t0 = g_h1 = token_w^T @ g_m1
  for (int d = tid; d < D; d += kThreads) {
    float col[kSPad];
#pragma unroll
    for (int j = 0; j < kSPad; ++j) col[j] = t1[j * D + d];
    for (int i = 0; i < S; ++i) {
      float acc1 = 0.0f;
#pragma unroll
      for (int j = 0; j < kSPad; ++j) acc1 = fmaf(tw_s[j * kSPad + i], col[j], acc1);
      t0[i * D + d] = acc1;
    }
  }
  __syncthreads();
  // LN1 backward: d ln1 partials, and t1 = g_a = g_r1 + LN1'(g_h1)
  for (int d = tid; d < D; d += kThreads) {
    float ss = 0.0f, sb = 0.0f;
    for (int i = 0; i < S; ++i) {
      const float gy = t0[i * D + d];
      ss += gy * xhat1(i, d);
      sb += gy;
    }
    part[kDs1 * D + d] = ss;
    part[kDb1 * D + d] = sb;
  }
  ln_backward_rows(t0, p.ln1_s, inv1, xhat1, p.gr1_g + off, t1, S, D);
  __syncthreads();
  // d emb += sum_s g_a; the input cotangent over g
  float* ge = p.gemb + b * D;
  for (int d = tid; d < D; d += kThreads) {
    float s = 0.0f;
    for (int i = 0; i < S; ++i) s += t1[i * D + d];
    ge[d] = p.first ? s : ge[d] + s;
  }
  float* g_out = p.g_out + off;
  for (int idx = tid; idx < S * D; idx += kThreads) g_out[idx] = t1[idx];
}

// out[split, k, n] = sum over rows r of this split of a[r, k] * c[r, n];
// a and c are [R, D]. 256 threads, each a 4 x 4 tile of the 64 x 64 output.
__global__ void __launch_bounds__(kThreads)
wgrad_kernel(const float* __restrict__ a, const float* __restrict__ c,
             float* __restrict__ out, int R, int D, int rows_per_split) {
  __shared__ __align__(16) float a_s[kWK][kWT];
  __shared__ __align__(16) float c_s[kWK][kWT];
  const int k0 = blockIdx.x * kWT, n0 = blockIdx.y * kWT;
  const int r_begin = blockIdx.z * rows_per_split;
  const int r_end = min(R, r_begin + rows_per_split);
  const int tid = threadIdx.x, tk = tid / 16, tn = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int r0 = r_begin; r0 < r_end; r0 += kWK) {
    for (int idx = tid; idx < kWK * kWT; idx += kThreads) {
      const int rr = idx / kWT, cc = idx % kWT, r = r0 + rr;
      const bool in = r < r_end;
      a_s[rr][cc] = (in && k0 + cc < D) ? __ldg(a + (size_t)r * D + k0 + cc) : 0.0f;
      c_s[rr][cc] = (in && n0 + cc < D) ? __ldg(c + (size_t)r * D + n0 + cc) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kWK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&a_s[kk][tk * 4]);
      const float4 cv = *reinterpret_cast<const float4*>(&c_s[kk][tn * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], cr[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* o = out + (size_t)blockIdx.z * D * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + tk * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tn * 4 + j;
      if (k < D && n < D) o[(size_t)k * D + n] = acc[i][j];
    }
  }
}

// One thread per gradient element of the layer: d ch_w from `wpart` summed
// over the splits, every other gradient from `part` summed over the batch.
__global__ void reduce_kernel(const float* __restrict__ wpart, int nsplit,
                              const float* __restrict__ part, int B, int S, int D,
                              float* dcw, float* dcb, float* ds1, float* db1,
                              float* ds2, float* db2, float* dtw, float* dtb) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int DD = D * D, P = part_size(S, D);
  if (idx < DD) {
    float s = 0.0f;
    for (int k = 0; k < nsplit; ++k) s += wpart[(size_t)k * DD + idx];
    dcw[idx] = s;
    return;
  }
  const int q = idx - DD;
  if (q >= P) return;
  float s = 0.0f;
  for (int b = 0; b < B; ++b) s += part[(size_t)b * P + q];
  if (q >= dtw_off(S, D)) {
    dtw[q - dtw_off(S, D)] = s;
  } else if (q >= dtb_off(D)) {
    dtb[q - dtb_off(D)] = s;
  } else {
    float* dst[5] = {ds1, db1, ds2, db2, dcb};
    dst[q / D][q % D] = s;
  }
}

bool shape_ok(int B, int S, int D) {
  return B >= 0 && S >= 1 && S <= kSPad && D >= kKTile && D <= kMaxN && D % kKTile == 0;
}

bool train_act_ok(int act) { return act == kSilu || act == kRelu || (act >= kLrelu && act <= kLrelu02); }

}  // namespace

// Each launch function enqueues on `stream` and returns the cudaError_t of
// its attribute call or launch (0 on success).

// The stack with the stash: out [B, S, D], stash [L, B, S, D].
extern "C" int fused_transmlp_train_fwd_launch(
    const float* x, const float* emb, const float* ln1_s, const float* ln1_b,
    const float* tw, const float* tb, const float* ln2_s, const float* ln2_b,
    const float* cw, const float* cb, float* out, float* stash,
    int B, int S, int D, int L, int act, void* stream) {
  if (!shape_ok(B, S, D) || L < 1 || !train_act_ok(act) || ln2_s == nullptr ||
      ln2_b == nullptr || stash == nullptr)
    return (int)cudaErrorInvalidValue;
  const size_t smem = stack_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      fused_transmlp_train_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return 0;
  StackParams p{x, emb, ln1_s, ln1_b, tw, tb, ln2_s, ln2_b, cw, cb, nullptr, nullptr,
                out, stash, B, S, D, L, D, act};
  fused_transmlp_train_fwd_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// Step 1 of one layer's backward. Weight pointers are this layer's; the
// scratch buffers are [B, S, D] each and part is [B, 5D + S + S*S].
extern "C" int fused_transmlp_train_bwd_block_launch(
    const float* stash, const float* emb, const float* g_in, float* g_out, float* gemb,
    int first, const float* ln1_s, const float* ln1_b, const float* tw, const float* tb,
    const float* ln2_s, const float* ln2_b, const float* cw, const float* cw_t,
    const float* cb, float* m1, float* xhat2, float* gr1, float* h2, float* gm2,
    float* part, int B, int S, int D, int act, void* stream) {
  if (!shape_ok(B, S, D) || !train_act_ok(act)) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return 0;
  BwdParams p{stash, emb, g_in, g_out, gemb, first, ln1_s, ln1_b, tw, tb, ln2_s, ln2_b,
              cw, cw_t, cb, m1, xhat2, gr1, h2, gm2, part, S, D, act};
  bwd_block_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// Step 2: wpart [nsplit, D, D] from h2, gm2 [R, D], R = B*S rows in
// chunks of rows_per_split (a multiple of 16).
extern "C" int fused_transmlp_train_wgrad_launch(
    const float* h2, const float* gm2, float* wpart, int R, int D, int nsplit,
    int rows_per_split, void* stream) {
  if (R < 1 || D < 1 || nsplit < 1 || rows_per_split < 1 || rows_per_split % kWK != 0 ||
      (long long)nsplit * rows_per_split < R)
    return (int)cudaErrorInvalidValue;
  dim3 grid((D + kWT - 1) / kWT, (D + kWT - 1) / kWT, nsplit);
  wgrad_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(h2, gm2, wpart, R, D,
                                                            rows_per_split);
  return (int)cudaGetLastError();
}

// Step 3: this layer's gradients from wpart and part.
extern "C" int fused_transmlp_train_reduce_launch(
    const float* wpart, int nsplit, const float* part, int B, int S, int D,
    float* dcw, float* dcb, float* ds1, float* db1, float* ds2, float* db2,
    float* dtw, float* dtb, void* stream) {
  if (B < 1 || !shape_ok(B, S, D) || nsplit < 1) return (int)cudaErrorInvalidValue;
  const int n = D * D + part_size(S, D);
  reduce_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      wpart, nsplit, part, B, S, D, dcw, dcb, ds1, db1, ds2, db2, dtw, dtb);
  return (int)cudaGetLastError();
}
