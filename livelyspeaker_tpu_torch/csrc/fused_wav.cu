// The WavEncoder conv stack on NVIDIA Hopper (sm_90a), f32, forward and
// backward:
//   conv0 (k15, stride 5, padded 1600 a side, 1 -> 32) -> IN -> LReLU
//   -> conv1 (stride 6, 32 -> 64) -> IN -> LReLU -> conv2 (64 -> 128) -> IN
//   -> LReLU -> conv3 (128 -> 256),
// InstanceNorm without affine, eps 1e-5, statistics in f32 (one pass each,
// shifted, combined by Chan's formula).
//
// Replaces livelyspeaker_tpu/ops/pallas/fused_wav.py: fused_wav_encoder, the
// Pallas TPU kernels `_fwd_a/_fwd_b/_fwd_c` and `_bwd_a/_bwd_b/_bwd_c`.
//
// Layouts: the waveform is [B, L]; the kernels read torch's Conv1d weights
// as they are, [C_out, C_in, 15], and the biases [C_out]; every activation
// they keep is time-major, [B, T, C]; the InstanceNorm statistics are
// [B, 2, C] (mean, then 1/std).
//
// conv0's output, [B, T1, 32] (517 MB at B = 512 on TED), is never written.
// conv0 has one input channel and 15 taps, so each kernel that needs an
// element of it recomputes it from the waveform (15 taps, each a rounded
// product and a rounded sum), and the normalisation and LeakyReLU are
// applied on load. Forward, nine launches:
//   wav_stats0_kernel        IN0 statistics, one pass over recomputed conv0;
//   wav_wsplit_fwd_kernel    w1 split into TF32 halves, in the order the
//                            forward conv reads it;
//   wav_conv_fwd_kernel<1>   conv1 over lrelu(IN0(conv0)) on the tensor cores
//                            (3xTF32), one product a residue of the stride:
//                            m1 [B, T2, 64];
//   wav_stats_kernel         IN1 statistics of m1;
//   wav_wsplit_fwd_kernel, wav_conv_fwd_kernel<0>   conv2 over
//                            lrelu(IN1(m1)): m2 [B, T3, 128];
//   wav_stats_kernel         IN2 statistics of m2;
//   wav_wsplit_fwd_kernel, wav_conv_fwd_kernel<0>   conv3 over
//                            lrelu(IN2(m2)): the output [B, T4, 256].
// The backward keeps the waveform, m1, m2 and the three statistics, and
// walks the stages back, per conv i = 3, 2, 1:
//   wav_wgrad_kernel         dW_i and db_i partials over row chunks of the
//                            (b, t) product on the tensor cores (3xTF32),
//                            the input activation recomputed on load;
//   wav_reduce_kernel        the chunks summed in a fixed grouping;
//   wav_wsplit_kernel        w_i split into TF32 halves, in the order the
//                            data gradient reads it;
//   wav_bwd_data_kernel      g_a = conv_i^T g on the tensor cores (3xTF32),
//                            one product a residue of the stride, times
//                            lrelu', written as gy [B, T, C], with per-tile
//                            partial sums of gy and gy * xhat;
//   wav_in_bwd_kernel        (i = 3, 2) the InstanceNorm backward in place:
//                            g_m = inv (gy - mean(gy) - xhat mean(gy xhat));
// and for conv0 wav_wgrad0_kernel (a sequence's times split over warps:
// g_m0 from gy1 on the fly, dW0 and db0 partials a CTA, and d_wav as the
// overlap-add of at most three times a sample), then wav_reduce_kernel.
// IN0's backward needs the
// sums of gy1 over all 7,891 times before any g_m0 exists, so gy1
// [B, T1, 32] is written once by bwd_data and read once by wgrad0;
// recomputing conv1^T g_m1 instead would cost another 41 GFLOP at B = 512.
//
// What differs from the TPU kernel: its weight gradients add every batch
// tile into one VMEM block, safe only because its grid runs in order. Here
// each block writes its own partial and wav_reduce_kernel sums them in a
// fixed order: no float atomics, the gradients are the same from run to
// run. The TPU's row layout, padded time axes and 0/1 masks exist for
// Mosaic's lane rules and are not carried over.
//
// What bounds it: about 90 GFLOP forward and twice that backward at B = 512
// on TED. The forward convs and the weight and data gradients run on the
// tensor cores in 3xTF32 (mma.sync, tf32_mma.cuh); the statistics of m1
// and m2 and the reduce are bound by the bytes they read; the two conv0
// kernels by conv0's recompute on the FP32 pipe, two instructions a tap
// under the rounding rule (conv0_tap), and wgrad0 also by reading gy1; the
// InstanceNorm backward by its bytes. wgmma is later work.

#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

#include "tf32_mma.cuh"  // cp.async, the 3xTF32 mma.sync
#include "cluster.cuh"   // the cluster barrier halves, cluster_launch_config

namespace {

constexpr int kK = 15;        // taps of every conv
constexpr int kS0 = 5;        // conv0 stride
constexpr int kPad0 = 1600;   // conv0 padding a side
constexpr int kS = 6;         // stride of conv1..conv3
constexpr int kC0 = 32;       // conv0 output channels
constexpr float kEps = 1e-5f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float lrelu(float x, float leak) { return x > 0.0f ? x : leak * x; }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The input activation of a stage, a = lrelu(xhat), xhat = (pre - mean) * inv:
// `pre` from a stored pre-norm tensor [B, T, C], or (kFromWav) conv0's
// output recomputed from the waveform, T = T1 and C = 32.
struct Src {
  const float* pre;  // [B, T, C] (unused from the waveform)
  const float* st;   // [B, 2, C] mean, 1/std
  const float* wav;  // [B, L]
  const float* w0;   // [32, 1, 15]
  const float* b0;   // [32]
  int L, T, C;
};

// One tap of conv0, m + w x, with the product and the sum each rounded (no
// FMA contraction). conv0 is summed bias first, then the taps k = 0..14 in
// order, everywhere it is computed, and the plain version sums it the same
// way: so all of them round every conv0 output to the same bits and take
// the same LeakyReLU branch at the kink (the gradient jumps there).
__device__ __forceinline__ float conv0_tap(float m, float w, float x) {
  return __fadd_rn(m, __fmul_rn(w, x));
}

// ---------------------------------------------------------------- conv0
//
// Shared by wav_stats0_kernel and wav_wgrad0_kernel: conv0 recomputed with
// a lane a channel. A warp walks its times in batches of kC0Batch; the
// waveform samples under a batch reach the warp's own shared buffer by
// cp.async (4 bytes each, zero-filled in conv0's padding) one batch ahead,
// and each lane keeps its channel's 15 weights and the samples of a group
// of four times (30) in registers. A group reads its 30 samples as one
// 8-byte and seven 16-byte loads that every lane of the warp makes at the
// same address (one broadcast each): no shared-memory load per tap. The
// four times' sums are independent, so four chains of conv0_tap are in
// flight a lane.

constexpr int kC0Batch = 32;  // times a warp batch
constexpr int kC0Group = 4;   // times a group
constexpr int kC0GroupX = kS0 * (kC0Group - 1) + kK;     // 30 samples under a group
constexpr int kC0Samples = kS0 * kC0Batch + kK - kS0;   // 170 samples under a batch
constexpr int kC0XOff = 2;    // buffer index of a batch's sample 0: a group's samples 2 .. 29 are 16-byte aligned
constexpr int kC0XBuf = 176;  // a batch's sample buffer, floats
static_assert(kC0XOff + kC0Samples <= kC0XBuf && kC0XBuf % 4 == 0, "sample buffer");
static_assert((kC0XOff + 2) % 4 == 0, "a group's samples after its first two are 16-byte aligned");
constexpr int kT0Lo = (kPad0 - kK) / kS0 + 1;  // 318: the first time whose window reaches a sample

// The end of conv0's live times: times at or past it, and before kT0Lo,
// see only padding, and conv0 there is b0 exactly (a tap adds w * 0).
__host__ __device__ __forceinline__ int conv0_hi(int L, int T1) {
  return min(T1, (L + kPad0 + kS0 - 1) / kS0);
}

// The samples under the batch of times t0 .. t0 + 31 of one waveform row
// into xb[kC0XOff ..], 4-byte cp.async copies by the warp's lanes.
__device__ __forceinline__ void stage_samples(float* xb, const float* row, int L, int t0, int lane) {
  const int p0 = kS0 * t0 - kPad0;
#pragma unroll
  for (int j = lane; j < kC0Samples + 32 - kC0Samples % 32; j += 32) {
    const int wi = p0 + j;
    const bool in = j < kC0Samples && wi >= 0 && wi < L;
    if (j < kC0Samples) cp_async4(xb + kC0XOff + j, row + (in ? wi : 0), in);
  }
}

// x[0 .. 29]: the samples under group g of a batch, one 8-byte and seven
// 16-byte loads (reloading the 10 it shares with group g - 1 costs fewer
// instructions than moving them between registers)
__device__ __forceinline__ void group_samples(const float* xb, int g, float (&x)[kC0GroupX]) {
  const float* p = xb + kC0XOff + kS0 * kC0Group * g;
  const float2 a = ld2(p);
  x[0] = a.x, x[1] = a.y;
#pragma unroll
  for (int v = 0; v < 7; ++v) {
    const float4 q = ld4(p + 2 + 4 * v);
    x[2 + 4 * v] = q.x, x[3 + 4 * v] = q.y, x[4 + 4 * v] = q.z, x[5 + 4 * v] = q.w;
  }
}

// conv0 of one channel at the four times of a group, bias first, taps in
// order (conv0_tap)
__device__ __forceinline__ void conv0_group(const float (&w)[kK], float bias,
                                            const float (&x)[kC0GroupX], float (&m)[kC0Group]) {
#pragma unroll
  for (int i = 0; i < kC0Group; ++i) m[i] = bias;
#pragma unroll
  for (int k = 0; k < kK; ++k)
#pragma unroll
    for (int i = 0; i < kC0Group; ++i) m[i] = conv0_tap(m[i], w[k], x[kS0 * i + k]);
}

// ---------------------------------------------------------------- statistics

constexpr int kStatsSMs = 132;   // the CTAs that fill an H100, one an SM
constexpr int kStatsCluster = 8; // the portable cluster size

struct Moments {
  float n, mean, m2;
};

// Chan's combine of the moments of two sets of rows, a's before b's.
__device__ __forceinline__ Moments chan(Moments a, Moments b) {
  const float n = __fadd_rn(a.n, b.n);
  if (n == 0.0f) return a;
  const float d = __fsub_rn(b.mean, a.mean), f = __fdiv_rn(b.n, n);
  return {n, __fadd_rn(a.mean, __fmul_rn(d, f)),
          __fadd_rn(__fadd_rn(a.m2, b.m2), __fmul_rn(__fmul_rn(d, d), __fmul_rn(a.n, f)))};
}

// (n, s1 / n, s2 - s1 mean) of n rows from their sums s1 and s2 of squares
__device__ __forceinline__ Moments moments(float n, float s1, float s2) {
  const float mean = __fdiv_rn(s1, n);
  return {n, mean, fmaxf(__fsub_rn(s2, __fmul_rn(s1, mean)), 0.0f)};
}

// IN0's mean and 1/std, st0 [B, 2, 32], over conv0's output, which is
// never stored. Replaces the IN0 statistics of livelyspeaker_tpu/ops/
// pallas/fused_wav.py:254 _fwd_a (conv0 as the im2col product, the
// statistics by _in_lrelu, :224; the JAX formula: models/audio_encoder.py:42
// _instance_norm over conv0, :68-69). What bounds it: conv0's FP32 work.
// Every tap is a rounded product and a rounded sum (conv0_tap: the same
// bits in every K3 kernel), two instructions, so one pass over the 7,256
// live times of TED's 7,891 takes 1.78 G taps, 3.57 G instructions, at
// B = 512: 0.11 ms at 132 SMs x 128 lanes x 1.98 GHz. Its bytes (the
// waveform, 74 MB) take 0.022 ms. Design:
// - One pass: conv0 is computed once. The sums are shifted by row 0 of
//   conv0, which is b0 exactly (time 0 sees only padding), so every CTA
//   has the shift without work, and the times that see only padding (635
//   of TED's 7,891) have d = 0: they are skipped and enter at the end as
//   moments (n_pad, 0, 0).
// - A sequence's live times [kT0Lo, conv0_hi) are split over a cluster of N
//   CTAs (ops/fused_wav.py: stats0_geometry, from (B, L) only: N as large as B N needs to
//   fill the card, at most 8), rank r owning [kT0Lo + r per, ...). Warp w
//   of a CTA takes its batches of 32 times at offsets 32 w, 32 w + 256, ...
//   and lane c is channel c (the conv0 design above).
// - A lane sums d = conv0 - b0 and d^2 over a batch, turns the sums into
//   the batch's (n, mean, M2), and combines the batches in order by Chan's
//   formula; then the warps in order, through shared memory, the CTAs in
//   rank order in rank 0's shared memory (distributed shared memory), and
//   last the padding's moments. Every add, product, quotient and root is
//   rounded on its own, so a CPU emulation in f32 gives the same bits. No
//   atomics: the same bits every run.
__global__ void __launch_bounds__(kThreads)
wav_stats0_kernel(Src s, int per, float* __restrict__ st) {
  __shared__ __align__(16) float xbuf[kWarps][2][kC0XBuf];
  __shared__ Moments warp_m[kWarps][kC0];
  __shared__ Moments cta_m[kStatsCluster][kC0];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), N = (int)cluster.num_blocks();
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, b = blockIdx.x / N;
  cluster_arrive();  // rank 0's shared memory is written only once every CTA runs
  const float* row = s.wav + (size_t)b * s.L;
  const int hi = conv0_hi(s.L, s.T);
  const int lo = kT0Lo + rank * per, end = min(hi, lo + per);
  float w[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) w[k] = __ldg(s.w0 + lane * kK + k);
  const float bias = __ldg(s.b0 + lane);
  constexpr int kStep = kWarps * kC0Batch;
  int t0 = lo + kC0Batch * warp, buf = 0;
  if (t0 < end) stage_samples(xbuf[warp][0], row, s.L, t0, lane);
  cp_async_commit();
  Moments run{0.0f, 0.0f, 0.0f};
  for (; t0 < end; t0 += kStep, buf ^= 1) {
    if (t0 + kStep < end) stage_samples(xbuf[warp][buf ^ 1], row, s.L, t0 + kStep, lane);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();  // every lane's copies of this batch have landed
    const float* xb = xbuf[warp][buf];
    const int n = min(kC0Batch, end - t0);
    float x[kC0GroupX];
    float s1 = 0.0f, s2 = 0.0f;
    for (int g = 0; g * kC0Group < n; ++g) {
      group_samples(xb, g, x);
      float m[kC0Group];
      conv0_group(w, bias, x, m);
#pragma unroll
      for (int i = 0; i < kC0Group; ++i) {
        if (g * kC0Group + i < n) {
          const float d = __fsub_rn(m[i], bias);
          s1 = __fadd_rn(s1, d);
          s2 = __fadd_rn(s2, __fmul_rn(d, d));
        }
      }
    }
    run = chan(run, moments((float)n, s1, s2));
    __syncwarp();  // the buffer is read before the next batch's copies refill it
  }
  cp_async_wait<0>();
  warp_m[warp][lane] = run;
  __syncthreads();
  Moments c{0.0f, 0.0f, 0.0f};
  if (tid < kC0) {
    c = warp_m[0][tid];
#pragma unroll
    for (int q = 1; q < kWarps; ++q) c = chan(c, warp_m[q][tid]);
  }
  cluster_wait();
  if (tid < kC0) cluster.map_shared_rank(&cta_m[0][0], 0)[rank * kC0 + tid] = c;
  cluster.sync();
  if (rank != 0 || tid >= kC0) return;
  c = cta_m[0][tid];
  for (int q = 1; q < N; ++q) c = chan(c, cta_m[q][tid]);
  c = chan(Moments{(float)(s.T - (hi - kT0Lo)), 0.0f, 0.0f}, c);
  float* stb = st + (size_t)b * 2 * kC0;
  stb[tid] = __fadd_rn(__ldg(s.b0 + tid), c.mean);
  stb[kC0 + tid] = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(__fdiv_rn(c.m2, (float)s.T), kEps)));
}

// The InstanceNorm statistics of a stored pre-norm tensor x [B, T, C]
// (m1 or m2), C = 32, 64 or 128. Replaces the statistics of
// livelyspeaker_tpu/ops/pallas/fused_wav.py:224 _in_lrelu for IN1 and IN2
// (the JAX formula: models/audio_encoder.py:42 _instance_norm). What bounds
// it: reading x once, 229 MB for m1 and m2 at TED B = 512 (0.068 ms at
// 3.35 TB/s). Design:
// - One pass over x. A sequence's T rows are split over a cluster of N
//   CTAs (stats_geometry: N as large as B N needs to fill the card, at most
//   8), CTA rank r owning the rows [r per, min(T, (r + 1) per)), per a
//   multiple of the kR rows a CTA step covers.
// - Thread tid = slot kG + g holds channels 4g..4g+3 (one float4 of a
//   row) and reads the rows r per + slot + k kR, kU 16-byte loads in flight.
// - It sums d = x - x[b, 0, c] and d^2: the sequence's row 0, which every
//   CTA reads, is the shift. These pre-norm conv outputs carry a bias that
//   can dwarf their spread, and unshifted sums of squares would lose its
//   digits. Each thread turns its sums into (n, mean - x0, M2), and those
//   are combined by Chan's formula in a fixed order: the lanes of a warp
//   that hold one channel group (shuffles, halving), the warps in order,
//   then the CTAs in rank order in rank 0's shared memory, written through
//   distributed shared memory. No atomics: the same bits every run.
// - Every add, product, quotient and root is rounded on its own (no FMA
//   contraction), so a CPU emulation in f32 gives the same bits.
constexpr int kStatsU = 4;       // 16-byte loads in flight a thread

__device__ __forceinline__ Moments shfl_down(Moments m, int o) {
  return {__shfl_down_sync(0xffffffffu, m.n, o), __shfl_down_sync(0xffffffffu, m.mean, o),
          __shfl_down_sync(0xffffffffu, m.m2, o)};
}

template <int kC>
__global__ void __launch_bounds__(kThreads)
wav_stats_kernel(const float* __restrict__ x, int T, int per, float* __restrict__ st) {
  constexpr int kG = kC / 4;          // float4 channel groups of a row
  constexpr int kR = kThreads / kG;   // rows a CTA step covers
  __shared__ Moments warp_m[kWarps][kC];
  __shared__ Moments cta_m[kStatsCluster][kC];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), N = (int)cluster.num_blocks();
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, g = tid % kG, slot = tid / kG;
  const float* xb = x + (size_t)(blockIdx.x / N) * T * kC;
  cluster_arrive();  // rank 0's shared memory is written only once every CTA runs
  const float4 x0 = __ldg(reinterpret_cast<const float4*>(xb) + g);
  const float k0[4] = {x0.x, x0.y, x0.z, x0.w};
  float s1[4] = {0.0f, 0.0f, 0.0f, 0.0f}, s2[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int cnt = 0;
  const int end = min(T, (rank + 1) * per);
  for (int r = rank * per + slot; r < end; r += kStatsU * kR) {
    float4 v[kStatsU];
#pragma unroll
    for (int u = 0; u < kStatsU; ++u)
      if (r + u * kR < end) v[u] = __ldg(reinterpret_cast<const float4*>(xb + (size_t)(r + u * kR) * kC) + g);
#pragma unroll
    for (int u = 0; u < kStatsU; ++u) {
      if (r + u * kR >= end) break;
      const float e[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float d = __fsub_rn(e[j], k0[j]);
        s1[j] = __fadd_rn(s1[j], d);
        s2[j] = __fadd_rn(s2[j], __fmul_rn(d, d));
      }
      ++cnt;
    }
  }
  const float n = (float)cnt;
  Moments m[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float mean = cnt ? __fdiv_rn(s1[j], n) : 0.0f;
    m[j] = {n, mean, cnt ? fmaxf(__fsub_rn(s2[j], __fmul_rn(s1[j], mean)), 0.0f) : 0.0f};
  }
  // the lanes of one channel group: lane l takes lane l + o's rows after its own
#pragma unroll
  for (int o = 16; o >= kG; o >>= 1)
#pragma unroll
    for (int j = 0; j < 4; ++j) m[j] = chan(m[j], shfl_down(m[j], o));
  if (lane < kG)
#pragma unroll
    for (int j = 0; j < 4; ++j) warp_m[warp][4 * lane + j] = m[j];
  __syncthreads();
  Moments c{0.0f, 0.0f, 0.0f};
  if (tid < kC) {
    c = warp_m[0][tid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) c = chan(c, warp_m[w][tid]);
  }
  cluster_wait();
  if (tid < kC) cluster.map_shared_rank(&cta_m[0][0], 0)[rank * kC + tid] = c;
  cluster.sync();
  if (rank != 0 || tid >= kC) return;
  c = cta_m[0][tid];
  for (int q = 1; q < N; ++q) c = chan(c, cta_m[q][tid]);
  float* stb = st + (size_t)(blockIdx.x / N) * 2 * kC;
  stb[tid] = __fadd_rn(__ldg(xb + tid), c.mean);
  stb[kC + tid] = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(__fdiv_rn(c.m2, (float)T), kEps)));
}

// The statistics kernel's split (ops/fused_wav.py: stats_geometry): N CTAs
// a sequence, `per` rows a CTA.
struct StatsGeo {
  int cluster, per;
};

StatsGeo stats_geometry(int B, int T, int C) {
  const int rows = kThreads * 4 / C, steps = (T + rows - 1) / rows;
  const int n = max(1, min(min(kStatsCluster, (kStatsSMs + B - 1) / B), steps));
  const int per = (steps + n - 1) / n * rows;
  return {(T + per - 1) / per, per};
}

// ------------------------------------------------------------------ forward
//
// conv1..conv3 on the tensor cores in 3xTF32. Replaces the forward convs of
// livelyspeaker_tpu/ops/pallas/fused_wav.py: _conv_rows (:208) called from
// _fwd_a, _fwd_b and _fwd_c.
//
// out[b, t, o] = bias[o] + sum_{c, k} w[o, c, k] a[b, 6t + k, c], with
// a = lrelu(IN(pre)). With input time tau = 6q + r and tap k = r + 6j, and
// a_r[q] = a[6q + r]:
//   out[b, t, o] = bias[o] + sum_{r < 6} sum_{j: r + 6j < 15} sum_c
//                  a_r[b, t + j, c] w[o, c, r + 6j],
// fifteen products of a phase-split window shifted by j rows, whose rows
// are the output times, whose reduction runs over the input channels and
// whose columns are the output channels. The taps (j = 2, r >= 3) do not
// exist and are skipped. What bounds it: the tensor cores, 3 x 2 B T_out 15
// C_in C_out TF32 FLOP at 495 TFLOP/s (0.52 ms for the three convs at TED
// B = 512), plus conv1's recompute of conv0 on the FP32 pipe (0.06 ms).
//
// Design:
// - A CTA owns a tile of 64 output rows by 64 output channels. Rows are the
//   flattened (b, t) of the B T_out outputs, so a tile may span up to four
//   sequences (conv3's 34 rows a sequence fill every m16 fragment); where a
//   sequence is shorter than 21 rows, tiles stay inside one sequence
//   (fwd_tiles). out [B, T_out, C_out] is time-major, so a tile's rows are
//   consecutive rows of out.
// - The reduction walks stages of one residue r and 16 input channels (two
//   k8 steps a tap, two or three taps). Each product warp sums a stage's
//   k8 steps for each of its fragments in a fresh accumulator that is then
//   added into the running f32 sum. No atomics: the same bits every run.
// - The A operand is the stage's normalised window of a_r, not an im2col:
//   each segment of n rows holds its sequence's n + 2 window rows once, and
//   row m at tap j reads window row off(m) + j. A k8 step's k = tq and
//   tq + 4 are the adjacent input channels 2tq and 2tq + 1, one 8-byte
//   load a row; rows are 24 floats apart (no bank conflicts in a half
//   warp). Each value is split into TF32 halves as it is loaded, and the
//   next k8 step's fragments load while the current step's products run.
// - The B operand is the weights, split into TF32 halves once a forward by
//   wav_wsplit_fwd_kernel in the order the fragments read them: a stage's
//   block is contiguous, one bulk (TMA) copy. Each float4 holds (hi(c),
//   hi(c + 1), lo(c), lo(c + 1)) of output channel o at the k8 step's
//   input channels c = 2tq and 2tq + 1: b0 and b1 with both halves in one
//   16-byte load; output channels are 16 floats apart, so a quarter warp
//   covers the 32 banks once.
// - Warp specialisation, no CTA barrier in the loop. A weight producer
//   (lane 0) fills a ring of kFWRing weight stages ("wfull"/"wempty"); it
//   fences the async proxy after each "wempty" wait, or the bulk copy could
//   overwrite weights the product warps' loads have not yet read, and it
//   issues no cp.async, so the fence has no copies of its own to order. A
//   window producer warp copies each stage's raw window into a ring of
//   kFRing (cp.async: the pre-norm values of the 16 channels at times
//   6q + r, zero-filled past T_in) and signals "full"; conv1 has none: its
//   weight producer's other lanes stage the tile's waveform samples once.
//   Transform warps normalise each window value in place with its
//   sequence's statistics and put it through the LeakyReLU in f32 (the
//   plain version's branch at the kink; conv1 first sums conv0 from the
//   samples, four channels from each sample loaded, bias first, taps in
//   order, no contraction: the bits of every other K3 kernel) and signal
//   "split"; 2 x 2 product warps, each 32 rows by 32 channels, run the
//   products and signal "empty" and "wempty". Two CTAs an SM.
// - The epilogue adds the bias and writes two adjacent channels a store.

constexpr int kFN = 64;        // output channels of a tile
constexpr int kFC = 16;        // input channels of a stage: two k8 steps
constexpr int kFRing = 6;      // window stages in flight
constexpr int kFWRing = 2;     // weight stages in flight
constexpr int kFWM = 2, kFWN = 2;  // product warps across a tile's 64 rows and 64 channels
constexpr int kFMF = 2;        // m16 fragments of a product warp: 32 rows
constexpr int kFNF = kFN / (8 * kFWN);  // n-fragments of a product warp
constexpr int kFSub = kFN * 2 * 8;       // the split weights of one k8 step of a tap
constexpr int kFTap = kFC / 8 * kFSub;   // a tap's split weights in a stage
constexpr int kFW = 3 * kFTap;           // a stage's split weights at most
constexpr int kFWRow = kFC + 8;          // a window row: 16 channels, padded
constexpr int kFBarBytes = 256;
static_assert((3 * kFRing + 2 * kFWRing + 1) * sizeof(uint64_t) <= kFBarBytes,
              "the rings' mbarriers");

// A tile of 64 output rows spanning up to four sequences. conv1
// (kFromWav) has three transform warps and no window producer, the others
// two and one.
template <bool kFromWav>
struct FGeo {
  static constexpr int kMma = kFWM * kFWN;                  // product warps
  static constexpr int kRows = 16 * kFMF * kFWM;
  static constexpr int kSeg = 4;
  static constexpr int kWin = kRows + 2 * kSeg;            // window rows of a stage at most
  static constexpr int kSlot = kWin * kFWRow;              // a window stage
  static constexpr int kSamples = kFromWav ? kS0 * kS * kWin + (kK - kS0) * kSeg : 0;
  static constexpr int kXform = kFromWav ? 3 : 2;
  static constexpr int kProducers = kFromWav ? 1 : 2;      // weights (and windows)
  static constexpr int kThreads = 32 * (kMma + kProducers + kXform);
  static constexpr size_t kBytes =
      kFBarBytes + (size_t)(kFWRing * kFW + kFRing * kSlot + kSamples) * sizeof(float);
};

// taps of a stage of residue r: 3 for r < 3, else 2; its first slot in a
// split block of 15 taps ordered (r, j): k = 0 6 12 1 7 13 2 8 14 3 9 4 10 5 11
__host__ __device__ __forceinline__ int fwd_taps(int r) { return r < 3 ? 3 : 2; }
__host__ __device__ __forceinline__ int fwd_first(int r) { return r < 3 ? 3 * r : 9 + 2 * (r - 3); }

// wsp[c / 16][o / 64][slot][h][o % 64][tq][4] = (hi w[o, c, k],
// hi w[o, c + 1, k], lo w[o, c, k], lo w[o, c + 1, k]) for
// c = 16 (c / 16) + 8 h + 2 tq, tq < 4, and the tap k of the slot: a stage
// (c / 16, r) of an output tile is one contiguous block of fwd_taps(r)
// slots.
__global__ void wav_wsplit_fwd_kernel(const float* __restrict__ w, int Cin, int Cout,
                                      float4* __restrict__ wsp) {
  const int n = Cin / kFC * (Cout / kFN) * kK * kFTap / 4;
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < n; idx += gridDim.x * blockDim.x) {
    const int tq = idx % 4, o = idx / 4 % kFN, h = idx / (4 * kFN) % (kFC / 8);
    const int q = idx / (kFTap / 4) % kK, rest = idx / (kFTap / 4 * kK);
    const int nt = rest % (Cout / kFN), cg = rest / (Cout / kFN);
    const int r = q < 9 ? q / 3 : 3 + (q - 9) / 2, j = q < 9 ? q % 3 : (q - 9) % 2;
    const int k = r + kS * j, oo = nt * kFN + o, c = cg * kFC + 8 * h + 2 * tq;
    float h0, l0, h1, l1;
    split_tf32(__ldg(w + ((size_t)oo * Cin + c) * kK + k), h0, l0);
    split_tf32(__ldg(w + ((size_t)oo * Cin + c + 1) * kK + k), h1, l1);
    wsp[idx] = make_float4(h0, h1, l0, l1);
  }
}

// A run of a tile's rows in one sequence: sequence b, times t .. t + n - 1,
// tile rows j .. j + n - 1, window rows u .. u + n + 1.
struct FSeg {
  int b, t, n, j, u;
};

// The tile's segments: rows r0 .. r0 + nrows - 1 of the flattened (b, t)
// rows, split at sequence ends (at most kSeg, as fwd_tiles guarantees).
template <int kSeg>
__device__ __forceinline__ int fwd_segs(int r0, int nrows, int T, FSeg (&seg)[kSeg]) {
  int r = r0, u = 0, ns = 0;
  const int end = r0 + nrows;
#pragma unroll
  for (int s = 0; s < kSeg; ++s) {
    if (r >= end) break;
    const int b = r / T, t = r - b * T, n = min(T - t, end - r);
    seg[s] = FSeg{b, t, n, r - r0, u};
    u += n + 2;
    r += n;
    ns = s + 1;
  }
  return ns;
}

// out [B, Tout, Cout] for tile blockIdx.x / (Cout / 64), output channels
// 64 (blockIdx.x % (Cout / 64)) ..; tiles_per_seq as fwd_tiles sets it.
template <bool kFromWav>
__global__ void __launch_bounds__(FGeo<kFromWav>::kThreads, 2)
wav_conv_fwd_kernel(Src src, const float* __restrict__ wsp, const float* __restrict__ bias,
                    float* __restrict__ out, int B, int Tout, int Cout, float leak,
                    int tiles_per_seq) {
  using G = FGeo<kFromWav>;
  constexpr int kRows = G::kRows, kSeg = G::kSeg, kXform = G::kXform, kFMma = G::kMma;
  constexpr int kXw = kFMma + G::kProducers;  // the first transform warp
  extern __shared__ __align__(128) unsigned char fsmem[];
  uint64_t* const full = reinterpret_cast<uint64_t*>(fsmem);  // a raw window landed
  uint64_t* const split = full + kFRing;                      // a window normalised
  uint64_t* const empty = split + kFRing;                     // every product warp is done with it
  uint64_t* const wfull = empty + kFRing;                     // a stage's weights landed
  uint64_t* const wempty = wfull + kFWRing;                   // every product warp is done with them
  uint64_t* const samples = wempty + kFWRing;                 // conv1: the samples landed
  float* const wring = reinterpret_cast<float*>(fsmem + kFBarBytes);  // kFWRing weight stages
  float* const ring = wring + kFWRing * kFW;                          // kFRing window stages
  float* const xs = ring + kFRing * G::kSlot;  // conv1: the tile's waveform samples
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ntn = Cout / kFN, tile = blockIdx.x / ntn, nt = blockIdx.x % ntn;
  const int Cin = src.C, Tin = src.T, nst = kS * (Cin / kFC);
  int r0, nrows;
  if (tiles_per_seq > 0) {
    const int b = tile / tiles_per_seq, k = tile % tiles_per_seq;
    r0 = b * Tout + k * kRows;
    nrows = min(kRows, Tout - k * kRows);
  } else {
    r0 = tile * kRows;
    nrows = min(kRows, B * Tout - r0);
  }
  FSeg seg[kSeg];
  const int ns = fwd_segs<kSeg>(r0, nrows, Tout, seg);
  if (tid < kFRing) {
    mbar_init(&full[tid], 32);       // every window producer lane's cp.async arrival
    mbar_init(&split[tid], kXform);  // every transform warp's
    mbar_init(&empty[tid], kFMma);   // every product warp's
  }
  if (tid < kFWRing) {
    mbar_init(&wfull[tid], 1);       // the bulk copy's
    mbar_init(&wempty[tid], kFMma);  // every product warp's
  }
  if (tid == 0) mbar_init(samples, 31);  // lanes 1..31 of the weight producer
  mbar_init_fence();
  __syncthreads();

  if (warp == kFMma) {  // the weight producer; for conv1 also the samples
    if constexpr (kFromWav) {
      if (lane > 0) {  // each segment's samples 30t - 1600 .. under conv0 times 6t .. 6(t + n + 1) + 5
        for (int s = 0; s < ns; ++s) {
          const float* row = src.wav + (size_t)seg[s].b * src.L;
          const int p0 = kS0 * kS * seg[s].t - kPad0, count = kS0 * kS * (seg[s].n + 2) + kK - kS0;
          float* dst = xs + kS0 * kS * seg[s].u + (kK - kS0) * s;
          for (int j = lane - 1; j < count; j += 31) {
            const int wi = p0 + j;
            const bool in = wi >= 0 && wi < src.L;
            cp_async4(dst + j, row + (in ? wi : 0), in);
          }
        }
        cp_async_arrive(samples);
      }
    }
    // Lane 0 issues the bulk copies and no cp.async: its proxy fence then
    // has no copies of its own in flight to order.
    if (lane == 0) {
      for (int s = 0; s < nst; ++s) {
        const int ws = s % kFWRing, cg = s / kS, r = s % kS;
        if (s >= kFWRing) {
          mbar_wait(&wempty[ws], (uint32_t)((s / kFWRing - 1) & 1));
          // the product warps' loads of the slot's last stage come before
          // the bulk copy overwrites it
          fence_proxy_async();
        }
        const uint32_t bytes = fwd_taps(r) * kFTap * sizeof(float);
        mbar_expect_tx(&wfull[ws], bytes);
        tma_load_1d(wring + ws * kFW, wsp + ((size_t)(cg * ntn + nt) * kK + fwd_first(r)) * kFTap,
                    bytes, &wfull[ws]);
      }
    }
  } else if (!kFromWav && warp == kFMma + 1) {  // the window producer
    for (int s = 0; s < nst; ++s) {
      const int slot = s % kFRing, cg = s / kS, r = s % kS;
      if (s >= kFRing) mbar_wait(&empty[slot], (uint32_t)((s / kFRing - 1) & 1));
      float* const dst = ring + slot * G::kSlot;
      for (int q = 0; q < ns; ++q) {  // the 16 channels at times 6(t + u) + r, u < n + 2
        const float* base = src.pre + ((size_t)seg[q].b * Tin) * Cin + cg * kFC;
        for (int j = lane; j < kFC / 4 * (seg[q].n + 2); j += 32) {
          const int u = j / (kFC / 4), v = j % (kFC / 4), tau = kS * (seg[q].t + u) + r;
          const bool in = tau < Tin;
          cp_async16(dst + (seg[q].u + u) * kFWRow + 4 * v,
                     in ? base + (size_t)tau * Cin + 4 * v : src.pre, in);
        }
      }
      cp_async_arrive(&full[slot]);
    }
  } else if (warp >= kXw) {  // the transform warps: raw window -> normalised window
    // a thread's kCT channels c0 .. c0 + kCT - 1 of every kStep-th window
    // row: conv1 sums conv0 for four channels from each sample it loads
    constexpr int kCT = kFromWav ? 4 : 1, kStep = kXform * 32 * kCT / kFC;
    const int xt = tid - 32 * kXw, c0 = xt % (kFC / kCT) * kCT;
    if constexpr (kFromWav) mbar_wait(samples, 0);
    float w0c[kCT][kK], b0c[kCT];
    for (int s = 0; s < nst; ++s) {
      const int slot = s % kFRing, cg = s / kS, r = s % kS, ch = cg * kFC + c0;
      if constexpr (kFromWav) {
        if (r == 0) {
#pragma unroll
          for (int e = 0; e < kCT; ++e) {
#pragma unroll
            for (int k = 0; k < kK; ++k) w0c[e][k] = __ldg(src.w0 + (ch + e) * kK + k);
            b0c[e] = __ldg(src.b0 + ch + e);
          }
        }
      }
      if constexpr (kFromWav) {  // the slot is free once its last stage's products are done
        if (s >= kFRing) mbar_wait(&empty[slot], (uint32_t)((s / kFRing - 1) & 1));
      } else {
        mbar_wait(&full[slot], (uint32_t)((s / kFRing) & 1));
      }
      float* const win = ring + slot * G::kSlot;  // [window row][16 channels, padded]
      for (int q = 0; q < ns; ++q) {
        const float* st = src.st + (size_t)seg[q].b * 2 * Cin + ch;
        float mean[kCT], inv[kCT];
#pragma unroll
        for (int e = 0; e < kCT; ++e) mean[e] = __ldg(st + e), inv[e] = __ldg(st + Cin + e);
        const int nu = seg[q].n + 2;
        if constexpr (kFromWav) {
          for (int u = xt / (kFC / kCT); u < nu; u += kStep) {
            const int tau = kS * (seg[q].t + u) + r;
            const float* xw = xs + kS0 * kS * seg[q].u + (kK - kS0) * q + kS0 * (kS * u + r);
            float v[kCT];
#pragma unroll
            for (int e = 0; e < kCT; ++e) v[e] = b0c[e];
#pragma unroll
            for (int k = 0; k < kK; ++k) {
              const float x = xw[k];
#pragma unroll
              for (int e = 0; e < kCT; ++e) v[e] = conv0_tap(v[e], w0c[e][k], x);
            }
#pragma unroll
            for (int e = 0; e < kCT; ++e)
              win[(seg[q].u + u) * kFWRow + c0 + e] =
                  tau < Tin ? lrelu((v[e] - mean[e]) * inv[e], leak) : 0.0f;
          }
        } else {
          // in place, two window rows at a time, so that their loads overlap
          for (int u0 = xt / kFC; u0 < nu; u0 += 2 * kStep) {
            float val[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int u = min(u0 + e * kStep, nu - 1), tau = kS * (seg[q].t + u) + r;
              const float v = win[(seg[q].u + u) * kFWRow + c0];
              val[e] = tau < Tin ? lrelu((v - mean[0]) * inv[0], leak) : 0.0f;
            }
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int u = u0 + e * kStep;
              if (u < nu) win[(seg[q].u + u) * kFWRow + c0] = val[e];
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&split[slot]);
    }
  } else {  // the product warps
    const int wm = warp / kFWN, wn = warp % kFWN, gq = lane / 4, tq = lane % 4;
    // window rows of tap 0 for the warp's rows 16 (kFMF wm + x) + gq (+ 8); 0
    // past the tile
    int off[kFMF][2];
#pragma unroll
    for (int x = 0; x < kFMF; ++x)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 16 * (kFMF * wm + x) + gq + 8 * h;
        off[x][h] = 0;
#pragma unroll
        for (int q = 0; q < kSeg; ++q)
          if (q < ns && m >= seg[q].j && m < seg[q].j + seg[q].n)
            off[x][h] = seg[q].u + m - seg[q].j;
      }
    float acc[kFMF][kFNF][4], p[kFMF][kFNF][4];
#pragma unroll
    for (int x = 0; x < kFMF; ++x)
#pragma unroll
      for (int f = 0; f < kFNF; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[x][f][e] = 0.0f;
    // A fragments of k8 step h of tap j from the normalised window: a0..a3
    // = (row gq, k tq), (gq + 8, tq), (gq, tq + 4), (gq + 8, tq + 4), where
    // k = tq and tq + 4 are the input channels 8h + 2tq and 8h + 2tq + 1 of
    // the stage (the split weights pair them the same way): one 8-byte
    // load a row
    auto load_a = [&](const float* win, int j, int h, float (&a)[kFMF][4]) {
#pragma unroll
      for (int x = 0; x < kFMF; ++x) {
        const float2 v0 = ld2(win + (off[x][0] + j) * kFWRow + 8 * h + 2 * tq);
        const float2 v8 = ld2(win + (off[x][1] + j) * kFWRow + 8 * h + 2 * tq);
        a[x][0] = v0.x, a[x][1] = v8.x, a[x][2] = v0.y, a[x][3] = v8.y;
      }
    };
    auto split_a = [&](const float (&a)[kFMF][4], float (&hi)[kFMF][4], float (&lo)[kFMF][4]) {
#pragma unroll
      for (int x = 0; x < kFMF; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(a[x][e], hi[x][e], lo[x][e]);
    };
    // k8 step h of tap j: its products into the stage's fresh sums p
    auto products = [&](const float* ws, int j, int h, const float (&ahi)[kFMF][4],
                        const float (&alo)[kFMF][4]) {
#pragma unroll
      for (int f = 0; f < kFNF; ++f) {
        // b0, b1 = (k tq, output gq), (tq + 4, gq) at tap r + 6j
        const float4 v = ld4(ws + j * kFTap + h * kFSub + (32 * wn + 8 * f + gq) * 16 + 4 * tq);
        const float bhi[2] = {v.x, v.y}, blo[2] = {v.z, v.w};
#pragma unroll
        for (int x = 0; x < kFMF; ++x) {
          mma_tf32(p[x][f], alo[x], bhi);
          mma_tf32(p[x][f], ahi[x], blo);
          mma_tf32(p[x][f], ahi[x], bhi);
        }
      }
    };
    // stage s's first k8 step into a: waits until the stage is there
    auto first_step = [&](int s, float (&a)[kFMF][4]) {
      const int slot = s % kFRing;
      mbar_wait(&wfull[s % kFWRing], (uint32_t)((s / kFWRing) & 1));
      mbar_wait(&split[slot], (uint32_t)((s / kFRing) & 1));
      load_a(ring + slot * G::kSlot, 0, 0, a);
    };
    // Each k8 step's A fragments are split, then the next step's (or the
    // next stage's first) are loaded into the same registers while the
    // step's products run.
    float a[kFMF][4], hi[kFMF][4], lo[kFMF][4];
    first_step(0, a);
    for (int s = 0; s < nst; ++s) {
      const int slot = s % kFRing, r = s % kS, taps = fwd_taps(r);
      const float* const ws = wring + (s % kFWRing) * kFW;
      const float* const win = ring + slot * G::kSlot;
#pragma unroll
      for (int x = 0; x < kFMF; ++x)
#pragma unroll
        for (int f = 0; f < kFNF; ++f)
#pragma unroll
          for (int e = 0; e < 4; ++e) p[x][f][e] = 0.0f;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        if (j == taps) break;
#pragma unroll
        for (int h = 0; h < kFC / 8; ++h) {
          split_a(a, hi, lo);
          if (h + 1 < kFC / 8)
            load_a(win, j, h + 1, a);
          else if (j + 1 < taps)
            load_a(win, j + 1, 0, a);
          else if (s + 1 < nst)
            first_step(s + 1, a);
          products(ws, j, h, hi, lo);
        }
      }
      __syncwarp();  // every load of the stage's slots is done
      if (lane == 0) {
        mbar_arrive(&empty[slot]);
        mbar_arrive(&wempty[s % kFWRing]);
      }
#pragma unroll
      for (int x = 0; x < kFMF; ++x)
#pragma unroll
        for (int f = 0; f < kFNF; ++f)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[x][f][e] += p[x][f][e];
    }
    // acc[x][f][e]: tile row 16 (kFMF wm + x) + gq + 8 (e / 2), output
    // channel 64 nt + 32 wn + 8 f + 2 tq + e % 2
#pragma unroll
    for (int f = 0; f < kFNF; ++f) {
      const int o = nt * kFN + 32 * wn + 8 * f + 2 * tq;
      const float b0 = __ldg(bias + o), b1 = __ldg(bias + o + 1);
#pragma unroll
      for (int x = 0; x < kFMF; ++x)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = 16 * (kFMF * wm + x) + gq + 8 * h;
          if (m < nrows)
            *reinterpret_cast<float2*>(out + (size_t)(r0 + m) * Cout + o) =
                make_float2(acc[x][f][2 * h] + b0, acc[x][f][2 * h + 1] + b1);
        }
    }
  }
}

// ----------------------------------------------------------------- backward

// The InstanceNorm backward of one sequence a block, in place over gy:
// g_m = inv (gy - mean_t(gy) - xhat mean_t(gy xhat)), the means from the
// tiles' partial sums (in tile order); 2 C <= 256.
__global__ void __launch_bounds__(kThreads)
wav_in_bwd_kernel(const float* __restrict__ pre, const float* __restrict__ st,
              const float* __restrict__ part, int ntq, int T, int C, float* g) {
  __shared__ float mean_s[2][kThreads / 2];
  __shared__ float st_s[2][kThreads / 2];
  const int tid = threadIdx.x, b = blockIdx.x;
  if (tid < 2 * C) {
    const int which = tid / C, c = tid % C;
    float tot = 0.0f;
    for (int i = 0; i < ntq; ++i) tot += __ldg(part + (((size_t)b * ntq + i) * 2 + which) * C + c);
    mean_s[which][c] = tot / T;
    st_s[which][c] = __ldg(st + (size_t)b * 2 * C + which * C + c);
  }
  __syncthreads();
  const float* xb = pre + (size_t)b * T * C;
  float* gb = g + (size_t)b * T * C;
  for (int idx = tid; idx < T * C; idx += kThreads) {
    const int c = idx % C;
    const float inv = st_s[1][c];
    const float xh = (__ldg(xb + idx) - st_s[0][c]) * inv;
    gb[idx] = inv * (gb[idx] - mean_s[0][c] - xh * mean_s[1][c]);
  }
}

// ---- the weight gradient of conv1..3 on the tensor cores in 3xTF32 ----
//
// Replaces the weight-gradient sums of livelyspeaker_tpu/ops/pallas/
// fused_wav.py: _conv_rows_bwd (dw_ref[c] += ..., :326), called from
// _bwd_c, _bwd_b and _bwd_a.
//
// dW[o, c, k] = sum_{b, t} a[b, 6t + k, c] g[b, t, o] and db[o] = sum g[b, t, o]:
// a [15 C_in, R] x [R, C_out] product whose reduction runs over the R = B T
// rows (b, t), a = lrelu(IN(pre)) recomputed on load. What bounds it: the
// tensor cores, 3 x 2 R 15 C_in C_out TF32 FLOP at 495 TFLOP/s (0.47 ms for
// the three convs at TED B = 512), plus conv1's recompute of conv0 on the
// FP32 pipe (0.06 ms). The split into TF32 halves and the three products
// are tf32_mma.cuh's; the row order of the sums is fixed by the shapes.
//
// Design:
// - A CTA owns an output tile of 16 input channels x 15 taps (240 rows,
//   exactly 15 m16 fragments: fragment x is tap x, its rows the 16
//   channels) by 64 output channels, and a range of rows fixed by
//   rows_per_split (ops/fused_wav.py: wgrad_geometry): one wave of the
//   card, its partial written to part[split] and summed by
//   wav_reduce_kernel in split order. No atomics, the same bits every run.
// - Rows go in stages of up to 32. A stage may span up to kGSeg sequence
//   segments (every segment of n rows stages the 6n + 9 input times under
//   it once), so a stage ends early only past kGSeg segments, i.e. when
//   T_out < 11. No im2col: each row keeps the window offset of its tap 0.
// - Raw stages arrive by cp.async in a ring of kGRing, kGRing - 1 stages
//   ahead: the pre-norm window [times][16 channels] (conv1: the waveform
//   samples under it, 4-byte copies zero-filled in conv0's padding), g
//   [32][64], zero-filled past the stage's rows, and each segment's
//   statistics of the tile's channels.
// - In the same interval as the products of stage i, the warps turn raw
//   stage i + 1 into a split stage (two buffers, so one barrier a stage;
//   one row of warps does it before its products, the others after, so
//   the tensor cores have work while the splits run): conv1 first computes
//   conv0 from the staged samples (bias first, taps in order, no
//   contraction: the bits of every other K3 kernel), then each value is
//   normalised, put through the LeakyReLU and split into TF32 hi and lo,
//   once; g is split once. The tiles of channel group 0 add g's columns
//   into db in four row groups, summed in order at the end.
// - 12 warps, 3 (taps 5w .. 5w + 4) x 4 (16 output channels each). A's
//   rows g and g + 8 are the channels 2g and 2g + 1 (one 8-byte load), B's
//   column g of the warp's two n-fragments the tile columns 2g and 2g + 1
//   (one 8-byte load); window times are 20 floats apart (6 x 20 = 24 mod
//   32) and g rows 72 (8 mod 32): no bank conflicts within a segment.
//   Each stage's products go into a fresh accumulator that is then added
//   into the running f32 sum.

constexpr int kGC = 16;          // input channels of a tile: 15 m16 fragments of 16 rows
constexpr int kGN = 64;          // output channels of a tile
constexpr int kGRows = 32;       // rows (b, t) of a stage
constexpr int kGSeg = 4;         // sequence segments a stage may span
constexpr int kGWin = kS * kGRows + (kK - kS) * kGSeg;  // 228 window times a stage at most
constexpr int kGRing = 3;        // raw stages in flight
constexpr int kGWarpsM = 3, kGWarpsN = 4, kGThreads = 32 * kGWarpsM * kGWarpsN;
constexpr int kGTaps = kK / kGWarpsM;  // taps (m-fragments) of a warp
constexpr int kGWinStride = 20;  // a time of the split window: 16 channels, padded
constexpr int kGGStride = 72;    // a row of the split g: 64 columns, padded
constexpr int kGRawFloats = kGWin * kGC + kGRows * kGN + kGSeg * 2 * kGC;  // window, g, stats
constexpr int kGSplitFloats = 2 * kGWin * kGWinStride + 2 * kGRows * kGGStride + kGRows;
constexpr size_t kGSmemBytes = (size_t)(kGRing * kGRawFloats + 2 * kGSplitFloats) * sizeof(float);
static_assert(kS0 * kGWin + (kK - kS0) * kGSeg <= kGWin * kGC,
              "conv1's samples fit the raw window");
static_assert(kGThreads % kGC == 0, "a thread keeps one channel in the window pass");
constexpr int kGBiasParts = 4;   // row groups of the bias sums, added in order at the end
static_assert(kGBiasParts * kGN <= kGThreads && kGRows % kGBiasParts == 0, "bias sums");

// A run of rows of one sequence in a stage: sequence b, times t .. t + n - 1,
// rows j .. j + n - 1 of the stage, window times u .. u + 6n + 8.
struct Seg {
  int b, t, n, j, u;
};

// The segments of the stage that starts at row r0: up to 32 rows, at most
// kGSeg sequences, not past hi. Returns their count; the stage ends at
// r0 + seg[count - 1].j + seg[count - 1].n.
__device__ __forceinline__ int stage_segs(int r0, int hi, int T, Seg (&seg)[kGSeg]) {
  const int lim = min(r0 + kGRows, hi);
  int r = r0, u = 0, ns = 0;
#pragma unroll
  for (int s = 0; s < kGSeg; ++s) {
    if (r >= lim) break;
    const int b = r / T, t = r - b * T, n = min(T - t, lim - r);
    seg[s] = Seg{b, t, n, r - r0, u};
    u += kS * n + kK - kS;
    r += n;
    ns = s + 1;
  }
  return ns;
}

// part[split] = [dW in torch's layout, db] over the rows of one split; the
// grid is (tiles, splits), tile = channel group * (C_out / 64) + column group.
template <bool kFromWav>
__global__ void __launch_bounds__(kGThreads, 1)
wav_wgrad_kernel(Src src, const float* __restrict__ g, int B, int Tout, int Cout, float leak,
                 float* __restrict__ part, int rows_per_split) {
  extern __shared__ __align__(16) float smem[];
  float* const raw = smem;                               // kGRing raw stages
  float* const split = smem + kGRing * kGRawFloats;      // two split stages
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int Cin = src.C, T = Tout, tiles_n = Cout / kGN;
  const int c0 = blockIdx.x / tiles_n * kGC, n0 = blockIdx.x % tiles_n * kGN;
  const int lo = blockIdx.y * rows_per_split, hi = min(B * Tout, lo + rows_per_split);
  const bool bias_cta = c0 == 0;

  // the window pass: this thread's channel and, for conv1, its conv0 weights
  const int wc = tid % kGC;
  float w0r[kK], b0r = 0.0f;
  if constexpr (kFromWav) {
#pragma unroll
    for (int k = 0; k < kK; ++k) w0r[k] = __ldg(src.w0 + (c0 + wc) * kK + k);
    b0r = __ldg(src.b0 + c0 + wc);
  }

  // raw stage at r0 into slot; returns the next stage's first row
  auto issue = [&](int r0, float* slot) {
    Seg seg[kGSeg];
    const int ns = stage_segs(r0, hi, T, seg);
    float* win = slot;
    for (int s = 0; s < ns; ++s) {
      const Seg& q = seg[s];
      if constexpr (kFromWav) {  // samples 30t - 1600 .. under conv0 times 6t .. 6(t + n - 1) + 14
        const int count = kS0 * (kS * q.n + kK - kS - 1) + kK;
        const float* row = src.wav + (size_t)q.b * src.L;
        const int p0 = kS0 * kS * q.t - kPad0;
        float* dst = win + kS0 * q.u + (kK - kS0) * s;
        for (int j = tid; j < count; j += kGThreads) {
          const int wi = p0 + j;
          const bool in = wi >= 0 && wi < src.L;
          cp_async4(dst + j, row + (in ? wi : 0), in);
        }
      } else {
        const int chunks = (kS * q.n + kK - kS) * (kGC / 4);
        const float* base = src.pre + ((size_t)q.b * src.T + kS * q.t) * Cin + c0;
        for (int j = tid; j < chunks; j += kGThreads) {
          const int u = j / (kGC / 4), v = j % (kGC / 4);
          cp_async16(win + (q.u + u) * kGC + 4 * v, base + (size_t)u * Cin + 4 * v, true);
        }
      }
    }
    const int end = r0 + seg[ns - 1].j + seg[ns - 1].n;
    float* gs = slot + kGWin * kGC;
    for (int j = tid; j < kGRows * kGN / 4; j += kGThreads) {
      const int row = j / (kGN / 4), v = j % (kGN / 4), r = r0 + row;
      const bool in = r < end;
      cp_async16(gs + row * kGN + 4 * v, g + (in ? (size_t)r * Cout + n0 + 4 * v : 0), in);
    }
    // each segment's mean and 1/std of the tile's channels: [kGSeg][2][16]
    if (tid < ns * 2 * kGC / 4) {
      const int s = tid / (2 * kGC / 4), which = tid / (kGC / 4) % 2, v = tid % (kGC / 4);
      cp_async16(gs + kGRows * kGN + (s * 2 + which) * kGC + 4 * v,
                 src.st + ((size_t)seg[s].b * 2 + which) * Cin + c0 + 4 * v, true);
    }
    return end;
  };

  float bsum = 0.0f;
  // raw stage at r0 in slot -> split stage sb; returns the next stage's first row
  auto transform = [&](int r0, const float* slot, float* sb) {
    Seg seg[kGSeg];
    const int ns = stage_segs(r0, hi, T, seg);
    float* whi = sb;
    float* wlo = whi + kGWin * kGWinStride;
    float* ghi = wlo + kGWin * kGWinStride;
    float* glo = ghi + kGRows * kGGStride;
    int* off = reinterpret_cast<int*>(glo + kGRows * kGGStride);
    const float* win = slot;
    for (int s = 0; s < ns; ++s) {
      const Seg& q = seg[s];
      const float* st = slot + kGWin * kGC + kGRows * kGN + s * 2 * kGC + wc;
      const float mean = st[0], inv = st[kGC];
      const int nu = kS * q.n + kK - kS;
      for (int u = tid / kGC; u < nu; u += kGThreads / kGC) {
        float x;
        if constexpr (kFromWav) {
          const float* xs = win + kS0 * (q.u + u) + (kK - kS0) * s;
          x = b0r;
#pragma unroll
          for (int k = 0; k < kK; ++k) x = conv0_tap(x, w0r[k], xs[k]);
        } else {
          x = win[(q.u + u) * kGC + wc];
        }
        float h, l;
        split_tf32(lrelu((x - mean) * inv, leak), h, l);
        whi[(q.u + u) * kGWinStride + wc] = h;
        wlo[(q.u + u) * kGWinStride + wc] = l;
      }
    }
    if (tid < kGRows) {  // row tid's window time of tap 0 (0 for rows past the stage)
      int o = 0;
      for (int s = 0; s < ns; ++s)
        if (tid >= seg[s].j && tid < seg[s].j + seg[s].n) o = seg[s].u + kS * (tid - seg[s].j);
      off[tid] = o;
    }
    const float* gs = slot + kGWin * kGC;
    for (int j = tid; j < kGRows * kGN; j += kGThreads) {
      const int row = j / kGN, col = j % kGN;
      float h, l;
      split_tf32(gs[j], h, l);
      ghi[row * kGGStride + col] = h;
      glo[row * kGGStride + col] = l;
    }
    if (bias_cta && tid < kGBiasParts * kGN) {  // rows past the stage are zeros
      const float* col = gs + tid / kGN * (kGRows / kGBiasParts) * kGN + tid % kGN;
      float v = 0.0f;
#pragma unroll
      for (int row = 0; row < kGRows / kGBiasParts; ++row) v += col[row * kGN];
      bsum += v;
    }
    return r0 + seg[ns - 1].j + seg[ns - 1].n;
  };

  // warp (wm, wn): taps kGTaps wm + x, tile columns 16 wn + 2q + y for its
  // n-fragment y's column q
  const int wm = warp / kGWarpsN, wn = warp % kGWarpsN, gq = lane / 4, tq = lane % 4;
  float acc[kGTaps][2][4];
#pragma unroll
  for (int x = 0; x < kGTaps; ++x)
#pragma unroll
    for (int y = 0; y < 2; ++y)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[x][y][e] = 0.0f;

  auto products = [&](const float* sb) {
    const float* whi = sb;
    const float* wlo = whi + kGWin * kGWinStride;
    const float* ghi = wlo + kGWin * kGWinStride;
    const float* glo = ghi + kGRows * kGGStride;
    const int* off = reinterpret_cast<const int*>(glo + kGRows * kGGStride);
    float p[kGTaps][2][4];
#pragma unroll
    for (int x = 0; x < kGTaps; ++x)
#pragma unroll
      for (int y = 0; y < 2; ++y)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[x][y][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kGRows; kk += 8) {
      // b0 = (row kk + tq, column gq), b1 = (kk + tq + 4, gq); a0..a3 =
      // (channel 2gq, row kk + tq), (2gq + 1, kk + tq), (2gq, kk + tq + 4),
      // (2gq + 1, kk + tq + 4) at the fragment's tap
      const int r0 = kk + tq, r4 = kk + tq + 4;
      const int col = wn * 16 + 2 * gq;
      const float2 bh0 = ld2(ghi + r0 * kGGStride + col), bh4 = ld2(ghi + r4 * kGGStride + col);
      const float2 bl0 = ld2(glo + r0 * kGGStride + col), bl4 = ld2(glo + r4 * kGGStride + col);
      const float bhi[2][2] = {{bh0.x, bh4.x}, {bh0.y, bh4.y}};
      const float blo[2][2] = {{bl0.x, bl4.x}, {bl0.y, bl4.y}};
      const int a0 = (off[r0] + kGTaps * wm) * kGWinStride + 2 * gq;
      const int a4 = (off[r4] + kGTaps * wm) * kGWinStride + 2 * gq;
#pragma unroll
      for (int x = 0; x < kGTaps; ++x) {
        const float2 h0 = ld2(whi + a0 + x * kGWinStride), h4 = ld2(whi + a4 + x * kGWinStride);
        const float2 l0 = ld2(wlo + a0 + x * kGWinStride), l4 = ld2(wlo + a4 + x * kGWinStride);
        const float ahi[4] = {h0.x, h0.y, h4.x, h4.y};
        const float alo[4] = {l0.x, l0.y, l4.x, l4.y};
#pragma unroll
        for (int y = 0; y < 2; ++y) {
          mma_tf32(p[x][y], alo, bhi[y]);
          mma_tf32(p[x][y], ahi, blo[y]);
          mma_tf32(p[x][y], ahi, bhi[y]);
        }
      }
    }
#pragma unroll
    for (int x = 0; x < kGTaps; ++x)
#pragma unroll
      for (int y = 0; y < 2; ++y)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[x][y][e] += p[x][y][e];
  };

  int r_issue = lo;
  for (int j = 0; j < kGRing; ++j) {
    if (r_issue < hi) r_issue = issue(r_issue, raw + j * kGRawFloats);
    cp_async_commit();
  }
  cp_async_wait<kGRing - 1>();
  __syncthreads();
  int r_next = transform(lo, raw, split);  // the first row of stage i + 1
  // The warps of tap row 1 split the next stage before their products, the
  // others after theirs: each scheduler has products to issue while the
  // splits run.
  const bool split_first = wm == 1;
  for (int i = 0;; ++i) {
    // stage i + 1 has landed; every warp is done with split stage i - 1 and
    // with raw stage i
    cp_async_wait<kGRing - 2>();
    __syncthreads();
    if (r_issue < hi) r_issue = issue(r_issue, raw + (i % kGRing) * kGRawFloats);
    cp_async_commit();
    const bool more = r_next < hi;
    const int r_this = r_next;
    if (more && split_first)
      r_next = transform(r_this, raw + ((i + 1) % kGRing) * kGRawFloats,
                         split + ((i + 1) % 2) * kGSplitFloats);
    products(split + (i % 2) * kGSplitFloats);
    if (more && !split_first)
      r_next = transform(r_this, raw + ((i + 1) % kGRing) * kGRawFloats,
                         split + ((i + 1) % 2) * kGSplitFloats);
    if (!more) break;
  }

  // acc[x][y][e]: tap kGTaps wm + x, channel c0 + 2gq + e / 2, column
  // n0 + 16 wn + 4tq + 2 (e % 2) + y
  const int M = kK * Cin;
  float* o = part + (size_t)blockIdx.y * ((size_t)M * Cout + Cout);
#pragma unroll
  for (int x = 0; x < kGTaps; ++x)
#pragma unroll
    for (int y = 0; y < 2; ++y)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + 16 * wn + 4 * tq + 2 * (e % 2) + y, c = c0 + 2 * gq + e / 2;
        o[(size_t)n * M + c * kK + kGTaps * wm + x] = acc[x][y][e];
      }
  if (bias_cta) {  // the row groups' bias sums, in order
    cp_async_wait<0>();
    __syncthreads();
    if (tid < kGBiasParts * kGN) raw[tid] = bsum;
    __syncthreads();
    if (tid < kGN) {
      float v = raw[tid];
      for (int q = 1; q < kGBiasParts; ++q) v += raw[q * kGN + tid];
      o[(size_t)M * Cout + n0 + tid] = v;
    }
  }
}

// ---- the data gradient of conv1..3 on the tensor cores in 3xTF32 ----
//
// Replaces the data gradient of livelyspeaker_tpu/ops/pallas/fused_wav.py:
// _conv_rows_bwd (:329-:334) and the gy and sums part of _in_bwd
// (:303-:313), called from _bwd_c, _bwd_b and _bwd_a.
//
// gy[b, tau, c] = lrelu'(xhat[b, tau, c]) sum_{t, k: 6t + k = tau} sum_o
// w[o, c, k] g[b, t, o]. With tau = 6q + r (r = 0..5) and k = r + 6j
// (j = 0..2, k < 15):
//   gy[b, 6q + r, c] = lrelu'(xhat) sum_j sum_o g[b, q - j, o] w[o, c, r + 6j],
// one product whose rows are (b, q), whose reduction runs over (j, o),
// K = 3 C_out, and whose columns are (r, c), N = 6 C_in: for a fixed
// (b, q) those columns are the 6 C_in consecutive floats of gy at times
// 6q .. 6q + 5, so a tile is written in gy's own layout. The blocks
// (j = 2, r >= 3) are zero (k > 14) and are skipped. What bounds it: the
// tensor cores, 3 x 2 B T_out 15 C_in C_out TF32 FLOP at 495 TFLOP/s (0.52
// ms for the three convs at TED B = 512), plus conv1's recompute of conv0
// on the FP32 pipe (0.06 ms).
//
// Design:
// - A CTA owns one tile: kRows = 16 kDWM q rows of one sequence (64, or 48
//   when a sequence has at most 48, as conv3's 37 on TED) by all six
//   residues of 16 input channels, and walks the reduction in stages of 8
//   output channels o (one k8 step), each summed in a fresh accumulator
//   that is then added into the running f32 sum. No atomics: every sum in
//   a fixed order, the same bits every run.
// - The A operand is a window of the cotangent, not an im2col: a stage
//   holds g's rows q0 - 2 .. q0 + kRows - 1 of its 8 columns once (rows
//   outside 0 .. T_out - 1 zero-filled by cp.async); fragment j reads it
//   shifted by j rows and splits its four values into TF32 halves.
// - The B operand is the weights, split once a backward by
//   wav_wsplit_kernel in the order the fragments read them: a tile's stage
//   is one contiguous 15 KB block, one bulk (TMA) copy. Each of its float4s
//   holds (hi(o), hi(o + 4), lo(o), lo(o + 4)) for the o = tq and tq + 4 of
//   an m16n8k8 fragment, one 16-byte load for b0 and b1 with both halves;
//   channels are 16 floats apart, so each quarter of a warp covers the 32
//   banks once, as the window's rows, 12 floats apart, do.
// - Warp specialisation: one producer warp fills a ring of kDRing stages,
//   each with a "full" mbarrier (every lane's cp.async arrival and the bulk
//   copy's bytes) and an "empty" one (every product warp); the product
//   warps never meet at a CTA barrier until the epilogue. The producer
//   fences the async proxy after each "empty" wait: the bulk copy must not
//   overwrite weights the product warps' loads have not yet read.
// - Product warps: kDWM rows of 2, warp (wm, wn) the fragment of rows
//   16 wm .. and the 8 channels 8 wn .. of every residue; 2 CTAs an SM.
// - The epilogue multiplies by lrelu'(xhat), writes gy, and sums gy and
//   gy xhat per channel over the tile (per thread in order, then across the
//   lanes by a fixed shuffle tree, then across the warp rows in order) into
//   part [B, ntq, 2, C_in]. xhat has the plain version's bits: (pre - mean)
//   inv from the stored pre-norm tensor (all of a thread's values loaded
//   before any is used) or, for conv1, conv0 recomputed from the tile's
//   waveform samples, staged once (bias first, taps in order, no
//   contraction). Times that no window reaches get gy = 0.

constexpr int kDO = 8;        // output channels o of a stage (one k8 step)
constexpr int kDRing = 5;     // stages in flight
constexpr int kDWN = 2;       // product warps across a tile's channels
constexpr int kDCW = 8 * kDWN;   // input channels of a tile
constexpr int kDWinStride = 12;  // a row of the raw window: 8 floats, padded
constexpr int kDBarBytes = 128;  // the ring's mbarriers, ahead of the floats

// a tile of kRows q rows (6 kRows input times) by kDCW input channels
template <int kRows>
struct DGeo {
  static constexpr int kWin = kRows + 2;                      // window rows q0 - 2 ..
  static constexpr int kW = kK * kDCW * 2 * kDO;              // a stage's split weights
  static constexpr int kSlot = kW + kWin * kDWinStride;       // split weights, raw window
  static constexpr int kSamples = (kS0 * kS * kRows + kK - kS0 + 3) / 4 * 4;  // conv1's
};
static_assert(2 * kDRing * sizeof(uint64_t) <= kDBarBytes, "the ring's mbarriers");

// wsp[o / 8][c / 16][k][c % 16][4 p .. 4 p + 3] = (hi w[o, c, k],
// hi w[o + 4, c, k], lo w[o, c, k], lo w[o + 4, c, k]) for o = 8 (o / 8) + p,
// p < 4: a tile's stage is one contiguous block.
__global__ void wav_wsplit_kernel(const float* __restrict__ w, int Cin, int Cout,
                                  float4* __restrict__ wsp) {
  const int n = Cout / kDO * kK * Cin * 4;
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < n; idx += gridDim.x * blockDim.x) {
    const int p = idx % 4, cl = idx / 4 % kDCW, k = idx / (4 * kDCW) % kK;
    const int cg = idx / (4 * kDCW * kK) % (Cin / kDCW), ob = idx / (4 * kK * Cin);
    const int o = ob * kDO + p, c = cg * kDCW + cl;
    float h0, l0, h1, l1;
    split_tf32(__ldg(w + ((size_t)o * Cin + c) * kK + k), h0, l0);
    split_tf32(__ldg(w + ((size_t)(o + 4) * Cin + c) * kK + k), h1, l1);
    wsp[idx] = make_float4(h0, h1, l0, l1);
  }
}

// gy [B, T_in, C_in] and part [B, ntq, 2, C_in] for the tile of q rows
// kRows blockIdx.x .. of sequence blockIdx.z, channels 16 blockIdx.y ..:
// kDWM x kDWN product warps, then the producer warp.
template <bool kFromWav, int kDWM>
__global__ void __launch_bounds__(32 * (kDWM * kDWN + 1), 2)
wav_bwd_data_kernel(Src src, const float* __restrict__ wsp, const float* __restrict__ g, int Tout,
                    int Cout, float leak, float* __restrict__ gy, float* __restrict__ part) {
  constexpr int kRows = 16 * kDWM, kCW = kDCW, kMma = kDWM * kDWN;
  using G = DGeo<kRows>;
  extern __shared__ __align__(128) unsigned char dsmem[];
  uint64_t* const full = reinterpret_cast<uint64_t*>(dsmem);  // a stage has landed
  uint64_t* const empty = full + kDRing;                      // every product warp is done with it
  float* const ring = reinterpret_cast<float*>(dsmem + kDBarBytes);  // kDRing slots
  float* const red = ring + kDRing * G::kSlot;       // [kDWM][2][kCW] tile sums
  float* const xs = red + kDWM * 2 * kCW;            // conv1: the tile's waveform samples
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * kRows, c0 = blockIdx.y * kCW, b = blockIdx.z;
  const int Cin = src.C, Tin = src.T, nst = Cout / kDO;
  if (tid < kDRing) {
    mbar_init(&full[tid], 33);     // every producer lane's cp.async arrival, the bulk copy's
    mbar_init(&empty[tid], kMma);  // every product warp's
  }
  mbar_init_fence();
  __syncthreads();

  float acc[kS][4];
#pragma unroll
  for (int r = 0; r < kS; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = 0.0f;
  const int wm = warp / kDWN, wn = warp % kDWN, gq = lane / 4, tq = lane % 4;

  if (warp == kMma) {  // the producer: stage s (output channels 8s .. 8s + 7) into its slot
    if constexpr (kFromWav) {  // samples 30 q0 - 1600 .. under conv0 times 6 q0 .. 6 (q0 + kRows) - 1
      const float* row = src.wav + (size_t)b * src.L;
      const int p0 = kS0 * kS * q0 - kPad0;
      for (int j = lane; j < G::kSamples; j += 32) {
        const int wi = p0 + j;
        const bool in = wi >= 0 && wi < src.L;
        cp_async4(xs + j, row + (in ? wi : 0), in);
      }
    }
    for (int s = 0; s < nst; ++s) {
      const int slot = s % kDRing;
      if (s >= kDRing) {
        // the product warps' loads of the slot's last stage come before the
        // bulk copy overwrites it: without the fence, they read some of the
        // next stage's weights (seen on the card at B = 512)
        mbar_wait(&empty[slot], (uint32_t)((s / kDRing - 1) & 1));
        fence_proxy_async();
      }
      float* const dst = ring + slot * G::kSlot;
      if (lane == 0) {  // the stage's split weights, one bulk copy
        mbar_expect_tx(&full[slot], G::kW * sizeof(float));
        tma_load_1d(dst, wsp + ((size_t)s * (Cin / kCW) + blockIdx.y) * G::kW,
                    G::kW * sizeof(float), &full[slot]);
      }
      for (int j = lane; j < G::kWin * 2; j += 32) {
        const int u = j / 2, v = j % 2, t = q0 - 2 + u;
        const bool in = t >= 0 && t < Tout;
        cp_async16(dst + G::kW + u * kDWinStride + 4 * v,
                   g + (in ? ((size_t)b * Tout + t) * Cout + s * kDO + 4 * v : 0), in);
      }
      cp_async_arrive(&full[slot]);
    }
  } else {  // the product warps: acc[r] += each stage's products, in a fresh sum
    for (int s = 0; s < nst; ++s) {
      const int slot = s % kDRing;
      mbar_wait(&full[slot], (uint32_t)((s / kDRing) & 1));
      const float* const ws = ring + slot * G::kSlot;
      const float* const win = ws + G::kW;
      float p[kS][4];
#pragma unroll
      for (int r = 0; r < kS; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[r][e] = 0.0f;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        // a0..a3 = (row gq, o tq), (gq + 8, tq), (gq, tq + 4), (gq + 8, tq + 4),
        // read at window row m + 2 - j and split here
        const float* a = win + (16 * wm + gq + 2 - j) * kDWinStride + tq;
        const float av[4] = {a[0], a[8 * kDWinStride], a[4], a[8 * kDWinStride + 4]};
        float ahi[4], alo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(av[e], ahi[e], alo[e]);
        // b0, b1 = (o tq, channel gq), (tq + 4, gq) at tap r + 6j
        constexpr int kR = 3;  // residues with a tap r + 12 < 15
#pragma unroll
        for (int r = 0; r < kS; ++r) {
          if (j == 2 && r >= kR) continue;
          const float4 v = ld4(ws + ((r + kS * j) * kCW + 8 * wn + gq) * 2 * kDO + 4 * tq);
          const float bhi[2] = {v.x, v.y}, blo[2] = {v.z, v.w};
          mma_tf32(p[r], alo, bhi);
          mma_tf32(p[r], ahi, blo);
          mma_tf32(p[r], ahi, bhi);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
#pragma unroll
      for (int r = 0; r < kS; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][e] += p[r][e];
    }
  }

  // acc[r][e]: q row 16 wm + gq + 8 (e / 2), residue r, channel
  // c0 + 8 wn + 2 tq + e % 2
  float s1[2] = {0.0f, 0.0f}, s2[2] = {0.0f, 0.0f};
  const int ch = c0 + 8 * wn + 2 * tq;
  if (warp < kMma) {
    const float* st = src.st + (size_t)b * 2 * Cin;
    const float mean[2] = {__ldg(st + ch), __ldg(st + ch + 1)};
    const float inv[2] = {__ldg(st + Cin + ch), __ldg(st + Cin + ch + 1)};
    // the stored pre-norm values of the thread's times, all loaded before
    // any is used
    float2 pre[2][kS];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < kS; ++r) {
        const int tau = kS * (q0 + 16 * wm + gq + 8 * h) + r;
        pre[h][r] = make_float2(0.0f, 0.0f);
        if (!kFromWav && tau < Tin)
          pre[h][r] = __ldg(reinterpret_cast<const float2*>(
              src.pre + ((size_t)b * Tin + tau) * Cin + ch));
      }
    float w0r[2][kK], b0r[2];
    if constexpr (kFromWav) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        b0r[e] = __ldg(src.b0 + ch + e);
#pragma unroll
        for (int k = 0; k < kK; ++k) w0r[e][k] = __ldg(src.w0 + (ch + e) * kK + k);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ql = 16 * wm + gq + 8 * h;
#pragma unroll
      for (int r = 0; r < kS; ++r) {
        const int tau = kS * (q0 + ql) + r;
        if (tau >= Tin) continue;
        float x2[2] = {pre[h][r].x, pre[h][r].y};
        if constexpr (kFromWav) {
          const float* x = xs + kS0 * (kS * ql + r);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float m = b0r[e];
#pragma unroll
            for (int k = 0; k < kK; ++k) m = conv0_tap(m, w0r[e][k], x[k]);
            x2[e] = m;
          }
        }
        float out[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float xh = (x2[e] - mean[e]) * inv[e];
          out[e] = acc[r][2 * h + e] * (xh > 0.0f ? 1.0f : leak);
          s1[e] += out[e];
          s2[e] = fmaf(out[e], xh, s2[e]);
        }
        *reinterpret_cast<float2*>(gy + ((size_t)b * Tin + tau) * Cin + ch) =
            make_float2(out[0], out[1]);
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s1[e] += __shfl_xor_sync(0xffffffffu, s1[e], o);
        s2[e] += __shfl_xor_sync(0xffffffffu, s2[e], o);
      }
    if (gq == 0) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        red[(wm * 2 + 0) * kCW + 8 * wn + 2 * tq + e] = s1[e];
        red[(wm * 2 + 1) * kCW + 8 * wn + 2 * tq + e] = s2[e];
      }
    }
  }
  __syncthreads();  // the producer too: it leaves only once every stage has landed
  if (tid < 2 * kCW) {
    const int which = tid / kCW, c = tid % kCW;
    float tot = red[which * kCW + c];
    for (int m = 1; m < kDWM; ++m) tot += red[(m * 2 + which) * kCW + c];
    part[(((size_t)b * gridDim.x + blockIdx.x) * 2 + which) * Cin + c0 + c] = tot;
  }
}

// q rows of a data-gradient tile: 64, or 48 for a stored input whose
// sequences have at most 48 (conv1's have at least 101)
int bwd_data_rows(int from_wav, int T_in) {
  const int q = (T_in + kS - 1) / kS;
  return from_wav || q > 48 ? 64 : 48;
}

constexpr int kW0Part = kC0 * kK + kC0;  // 512: dW0 [32, 1, 15], then db0
constexpr int kW0Row = kC0 + 4;  // a staged row of gy1 (then g_m0): 32 channels, padded
constexpr int kW0GyBuf = kC0Batch * kW0Row;
constexpr int kW0Carry = 2 * (kK - kS0);  // d_wav's carries of a warp: h[t, 5 ..] of the batch's last two times
constexpr int kW0HRow = kC0Batch + 4;      // a row (one tap) of h in the freed gy1 buffer: two carried times, 32, padded
constexpr int kW0Split = 4 * 2 * 32 * 4;   // w0 split into TF32 halves as d_wav's B fragments
constexpr size_t kW0SplitAt = (size_t)kWarps * (2 * (kC0XBuf + kW0GyBuf) + kW0Carry);
constexpr size_t kW0Smem = (kW0SplitAt + kW0Split) * sizeof(float);
static_assert(kS0 * kC0Batch <= kC0XBuf, "a batch's d_wav samples fit its sample buffer");
static_assert(16 * kW0HRow <= kW0GyBuf, "h fits the batch's gy1 buffer");
static_assert(kW0SplitAt % 4 == 0, "the split weights are 16-byte aligned");
static_assert(kW0Smem >= (size_t)kWarps * kW0Part * sizeof(float), "the CTA's sums fit");

// x = hi + lo with hi the top 11 significant bits of x (TF32, truncated)
// and lo the rest, exact; the tensor cores read lo's top 11 bits, so a
// product keeps about 21 bits of x: two integer or float instructions, not
// split_tf32's rounding.
__device__ __forceinline__ void split_tf32_trunc(float x, float& hi, float& lo) {
  hi = __uint_as_float(__float_as_uint(x) & 0xffffe000u);
  lo = x - hi;
}

// conv0's backward through IN0. Replaces the conv0 part of
// livelyspeaker_tpu/ops/pallas/fused_wav.py:370 _bwd_a: IN0's backward
// through _in_bwd (:303), db0_ref += _sum_bias(g_m0), dw0_ref +=
// _dotT(x2d, g_m0), and the dx45 product folded into d_wav. For a time t
// and channel c:
//   g_m0[t, c] = inv0 (gy1[t, c] - mean_t(gy1) - xhat0[t, c] mean_t(gy1 xhat0)),
// xhat0 = (conv0 - mean0) inv0 with conv0 recomputed, the two means from
// conv1's data-gradient tile sums (in tile order); then
//   dW0[c, k] += g_m0[t, c] x[5t + k],  db0[c] += g_m0[t, c],
//   d_wav[5t + j] = sum_{i < 3} h[t - i, j + 5i],  h[t, k] = sum_c w0[c, k] g_m0[t, c].
// What bounds it: reading gy1 [B, T1, 32] once (517 MB at TED B = 512,
// 0.154 ms at 3.35 TB/s), and the FP32 work under the rounding rule: conv0
// at two instructions a tap (0.11 ms) and one FMA a product of dW0 (0.05
// ms); h's products run on the tensor cores. Design:
// - Each sequence's T1 times are split over `splits` warps
//   (ops/fused_wav.py: wgrad0_geometry, from (B, L) only: about two CTAs
//   of 8 warps an SM at once), warp k of the grid owning sequence
//   k / splits, times [j per, (j + 1) per), j = k % splits. A lane is a
//   channel (the conv0 design above): its 15 weights and a group's 30
//   samples in registers; gy1 and the samples of
//   a batch of 32 times reach the warp's shared buffers by cp.async one
//   batch ahead (gy1 in 16-byte copies, rows padded to 36 floats). The
//   dW0 products take the samples and g_m0 from registers, 15 FMAs a time
//   (on the tensor cores, measured, a batch's 48 mma.sync took as long as
//   its 480 FMAs, and the register cap made it spill). The times that see
//   only padding skip conv0 (it is b0) and dW0 (their samples are 0); they
//   still give g_m0, for db0.
// - d_wav: a lane writes its g_m0 over the staged gy1 of its channel; then
//   the warp computes h = g_m0 w0 for the batch, [32 times x 32 channels]
//   x [32 x 16 taps (the 16th 0)], on the tensor cores in 3xTF32 (mma.sync
//   m16n8k8, tf32_mma.cuh): A read from the g_m0 rows (36 floats apart: no
//   bank conflict) and split as it is loaded, B (w0's halves) from shared
//   memory, split once a launch. h goes to the freed gy1 buffer tap-major,
//   beside the two times before the batch (carried), and a lane, now a
//   time, adds its five samples h[t, j] + h[t - 1, j + 5] + h[t - 2, j + 10];
//   they leave through the batch's sample buffer, 32 consecutive samples a
//   store. A warp first runs the four times before its range (the halo)
//   without summing them, so each sample is written once, by the warp that
//   owns time p / 5.
// - Each CTA adds its warps' dW0 and db0 in warp order and writes one
//   partial row, part [ctas, 512]; wav_reduce_kernel sums the rows in its
//   fixed grouping. No atomics: the same bits every run.
__global__ void __launch_bounds__(kThreads, 2)
wav_wgrad0_kernel(Src s, const float* __restrict__ gy, const float* __restrict__ sums, int ntq,
                  int B, int splits, int per, float* __restrict__ part,
                  float* __restrict__ dwav) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, T1 = s.T;
  float* const xbuf = smem + warp * 2 * kC0XBuf;
  float* const gbuf = smem + kWarps * 2 * kC0XBuf + warp * 2 * kW0GyBuf;
  float* const carry = smem + kWarps * 2 * (kC0XBuf + kW0GyBuf) + warp * kW0Carry;
  float* const wsp = smem + kW0SplitAt;
  if (dwav != nullptr) {  // w0 into TF32 halves as the B fragments of h's product
    const int ks = tid / 64, nt = tid / 32 % 2, gq = lane / 4, tq = lane % 4, q = 8 * nt + gq;
    float h0, l0, h1, l1;
    split_tf32(q < kK ? __ldg(s.w0 + (8 * ks + tq) * kK + q) : 0.0f, h0, l0);
    split_tf32(q < kK ? __ldg(s.w0 + (8 * ks + tq + 4) * kK + q) : 0.0f, h1, l1);
    reinterpret_cast<float4*>(wsp)[tid] = make_float4(h0, h1, l0, l1);
    __syncthreads();
  }
  const int k = blockIdx.x * kWarps + warp, b = k / splits;
  float acc[kK], db = 0.0f;
#pragma unroll
  for (int q = 0; q < kK; ++q) acc[q] = 0.0f;
  if (b < B) {
    const int c = lane, t_begin = (k % splits) * per, t_end = min(T1, t_begin + per);
    const float mean0 = __ldg(s.st + (size_t)b * 2 * kC0 + c);
    const float inv0 = __ldg(s.st + (size_t)b * 2 * kC0 + kC0 + c);
    float m1 = 0.0f, m2 = 0.0f;
    for (int i = 0; i < ntq; ++i) {
      m1 += __ldg(sums + (((size_t)b * ntq + i) * 2 + 0) * kC0 + c);
      m2 += __ldg(sums + (((size_t)b * ntq + i) * 2 + 1) * kC0 + c);
    }
    // g_m0 = inv0 (gy1 - m1 - xhat0 m2) = inv0 gy1 + gd (conv0 - mean0) + gk
    const float gd = -inv0 * inv0 * (m2 / T1), gk = -inv0 * (m1 / T1);
    float w[kK];
#pragma unroll
    for (int q = 0; q < kK; ++q) w[q] = __ldg(s.w0 + c * kK + q);
    const float bias = __ldg(s.b0 + c);
    const int hi = conv0_hi(s.L, T1);
    const float* row = s.wav + (size_t)b * s.L;
    const float* gyb = gy + (size_t)b * T1 * kC0;
    // the batches start at the halo when there is one: four times, of which
    // d_wav needs the last two
    const bool halo = dwav != nullptr && t_begin > 0;
    const int first = halo ? t_begin - kC0Group : t_begin;
    auto stage = [&](int t0, int into) {
      stage_samples(xbuf + into * kC0XBuf, row, s.L, t0, lane);
      float* dst = gbuf + into * kW0GyBuf;
#pragma unroll
      for (int v = 0; v < kC0Batch * kC0 / 4 / 32; ++v) {
        const int q = lane + 32 * v, r = q / (kC0 / 4), col = 4 * (q % (kC0 / 4));
        const bool in = t0 + r < t_end;
        cp_async16(dst + r * kW0Row + col, gyb + (in ? (size_t)(t0 + r) * kC0 + col : 0), in);
      }
    };
    stage(first, 0);
    cp_async_commit();
    // h[t0 - 2, k] and h[t0 - 1, k], k = 5 .. 14: what the batch's first two
    // times need from the two before them
    if (lane < kW0Carry) carry[lane] = 0.0f;
    int buf = 0;
    for (int t0 = first; t0 < t_end; t0 += kC0Batch, buf ^= 1) {
      if (t0 + kC0Batch < t_end) stage(t0 + kC0Batch, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncwarp();  // every lane's copies of this batch have landed
      float* xb = xbuf + buf * kC0XBuf;
      float* gb = gbuf + buf * kW0GyBuf;
      const int n = min(kC0Batch, t_end - t0);
      float x[kC0GroupX];
      float* gr = gb + c;  // this lane's channel of the group's first row
      for (int g = 0; g * kC0Group < n; ++g, gr += kC0Group * kW0Row) {
        group_samples(xb, g, x);
        const int tg = t0 + g * kC0Group;
        float m[kC0Group];
        const bool live = tg + kC0Group > kT0Lo && tg < hi;
        if (live) {
          conv0_group(w, bias, x, m);
        } else {
#pragma unroll
          for (int i = 0; i < kC0Group; ++i) m[i] = bias;
        }
        float v[kC0Group];  // g_m0
#pragma unroll
        for (int i = 0; i < kC0Group; ++i)
          v[i] = fmaf(inv0, gr[i * kW0Row], fmaf(gd, m[i] - mean0, gk));
        if (g * kC0Group + kC0Group > n) {  // the last group of a short batch
#pragma unroll
          for (int i = 0; i < kC0Group; ++i)
            if (g * kC0Group + i >= n) v[i] = 0.0f;
        }
        if (dwav != nullptr) {
#pragma unroll
          for (int i = 0; i < kC0Group; ++i) gr[i * kW0Row] = v[i];
        }
        if (tg >= t_begin) {  // not the halo, which is one whole group
#pragma unroll
          for (int i = 0; i < kC0Group; ++i) db += v[i];
          if (live) {
#pragma unroll
            for (int i = 0; i < kC0Group; ++i)
#pragma unroll
              for (int q = 0; q < kK; ++q) acc[q] = fmaf(v[i], x[kS0 * i + q], acc[q]);
          }
        }
      }
      if (dwav != nullptr) {
        __syncwarp();  // the batch's g_m0 rows are written
        const int gq = lane / 4, tq = lane % 4;
        float acc_h[2][2][4];  // [m-tile of 16 times][n-tile of 8 taps][fragment]
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc_h[mt][nt][e] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < kC0 / 8; ++ks) {
          float ahi[2][4], alo[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              split_tf32_trunc(gb[(16 * mt + gq + 8 * (e & 1)) * kW0Row + 8 * ks + tq + 4 * (e >> 1)],
                               ahi[mt][e], alo[mt][e]);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const float4 w4 = ld4(wsp + ((ks * 2 + nt) * 32 + lane) * 4);
            const float bhi[2] = {w4.x, w4.y}, blo[2] = {w4.z, w4.w};
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              mma_tf32(acc_h[mt][nt], alo[mt], bhi);
              mma_tf32(acc_h[mt][nt], ahi[mt], blo);
              mma_tf32(acc_h[mt][nt], ahi[mt], bhi);
            }
          }
        }
        __syncwarp();  // the g_m0 rows are read: h takes their place
        float* hs = gb;  // hs[k * kW0HRow + 2 + t]: h[t0 + t, k], t = -2 .. 31
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              hs[(8 * nt + 2 * tq + (e & 1)) * kW0HRow + 2 + 16 * mt + gq + 8 * (e >> 1)] =
                  acc_h[mt][nt][e];
        if (lane < kW0Carry) hs[(kS0 + lane / 2) * kW0HRow + lane % 2] = carry[lane];
        __syncwarp();
        // a lane is a time t0 + lane now: its five samples 5 (t0 + lane) + j,
        // h[t, j] + h[t - 1, j + 5] + h[t - 2, j + 10], into the batch's
        // sample buffer, which phase 1 has read
#pragma unroll
        for (int j = 0; j < kS0; ++j)
          xb[kS0 * lane + j] = (hs[j * kW0HRow + 2 + lane] + hs[(j + kS0) * kW0HRow + 1 + lane])
                               + hs[(j + 2 * kS0) * kW0HRow + lane];
        if (lane < kW0Carry) carry[lane] = hs[(kS0 + lane / 2) * kW0HRow + kC0Batch + lane % 2];
        __syncwarp();  // the samples are written
        // the samples to device memory, 32 consecutive ones a store
#pragma unroll
        for (int i = 0; i < kS0; ++i) {
          const int q = lane + 32 * i, t = t0 + q / kS0, p = kS0 * t0 + q - kPad0;
          if (t >= t_begin && t < t_end && p >= 0 && p < s.L) dwav[(size_t)b * s.L + p] = xb[q];
        }
      }
      __syncwarp();  // the buffers are read before the next batch's copies refill them
    }
    cp_async_wait<0>();
  }
  __syncthreads();  // every warp is done with its buffers: they hold the sums now
  float* red = smem;  // [kWarps][512]
#pragma unroll
  for (int q = 0; q < kK; ++q) red[warp * kW0Part + lane * kK + q] = acc[q];
  red[warp * kW0Part + kC0 * kK + lane] = db;
  __syncthreads();
#pragma unroll
  for (int h = 0; h < kW0Part / kThreads; ++h) {
    const int q = tid + h * kThreads;
    float tot = red[q];
#pragma unroll
    for (int v = 1; v < kWarps; ++v) tot += red[v * kW0Part + q];
    part[(size_t)blockIdx.x * kW0Part + q] = tot;
  }
}

// out[i] = sum_j part[j, i]: the weight-gradient partials [n, width] summed.
// Replaces the in-order accumulation of the TPU kernel's weight gradients
// in VMEM (livelyspeaker_tpu/ops/pallas/fused_wav.py:326 `dw_ref[c] += ...`,
// and conv0's sums in _bwd_a, :370). What bounds it: reading part once (25
// MB over a backward's four launches at TED B = 512, 7.4 us at 3.35 TB/s);
// at conv0's [rows, 512] the loads one thread makes one after another. Design
// (reduce_geometry, mirrored by ops/fused_wav.py, which sums the CPU's
// plain version in the same grouping): vectors of V = 4 columns (float4)
// where width is a multiple of 4, else single columns; a CTA of 256
// threads owns q adjacent vectors and 256 / q row groups, group k the rows
// [k rows, (k + 1) rows) summed in order with kRedU loads in flight, the
// groups' sums added in group order through shared memory, kRedU loaded
// before they are added (one group: no shared memory). q halves from 256
// while the CTAs are fewer than two an SM and there are rows for twice
// the groups. The grouping depends on (n, width) only: the same bits
// every run.
constexpr int kRedU = 8;       // loads in flight a thread
constexpr int kRedCtas = 264;  // two CTAs an SM of an H100
constexpr int kRedMinQ = 4;    // vectors a CTA at least: 64-byte row segments

struct RedGeo {
  int vec, q, rows, ctas;
};

RedGeo reduce_geometry(int n, int width) {
  const int vec = width % 4 == 0 ? 4 : 1, cols = width / vec;
  int q = kThreads;
  while (q > kRedMinQ && (cols + q - 1) / q < kRedCtas && 2 * (kThreads / q) <= n) q /= 2;
  const int groups = kThreads / q;
  return {vec, q, (n + groups - 1) / groups, (cols + q - 1) / q};
}

__device__ __forceinline__ float vadd(float a, float b) { return a + b; }
__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
wav_reduce_kernel(const V* __restrict__ part, int n, int cols, int q, int rows,
                  V* __restrict__ out) {
  __shared__ V red[kThreads];
  const int tid = threadIdx.x, col = tid % q, grp = tid / q, c = blockIdx.x * q + col;
  const int j0 = min(n, grp * rows), j1 = min(n, j0 + rows);
  V s{};
  if (c < cols) {
    for (int j = j0; j < j1; j += kRedU) {
      V v[kRedU];
#pragma unroll
      for (int u = 0; u < kRedU; ++u)
        if (j + u < j1) v[u] = __ldg(part + (size_t)(j + u) * cols + c);
#pragma unroll
      for (int u = 0; u < kRedU; ++u)
        if (j + u < j1) s = j + u == j0 ? v[u] : vadd(s, v[u]);
    }
  }
  if (rows >= n) {  // one group
    if (c < cols) out[c] = s;
    return;
  }
  red[tid] = s;
  __syncthreads();
  if (grp != 0 || c >= cols) return;
  const int groups = (n + rows - 1) / rows;
  for (int k = 1; k < groups; k += kRedU) {
    V v[kRedU];
#pragma unroll
    for (int u = 0; u < kRedU; ++u)
      if (k + u < groups) v[u] = red[(k + u) * q + col];
#pragma unroll
    for (int u = 0; u < kRedU; ++u)
      if (k + u < groups) s = vadd(s, v[u]);
  }
  out[c] = s;
}

Src make_src(const float* pre, const float* st, int T, int C, const float* wav,
             const float* w0, const float* b0, int L) {
  return Src{pre, st, wav, w0, b0, L, T, C};
}

// A stage input the kernels take: conv0's output (from_wav, C = 32), or a
// stored tensor with C = 32, 64 or 128.
bool src_ok(int from_wav, const float* pre, int T, int C) {
  if (T < 1) return false;
  if (from_wav) return C == kC0;
  return pre != nullptr && (C == 32 || C == 64 || C == 128);
}

// The forward conv's tiles of `rows` rows for B sequences of T output rows:
// tiles of flattened (b, t) rows (tiles_per_seq = 0) where any `rows`
// consecutive rows span at most `segs` sequences, else ceil(T / rows)
// tiles inside each sequence.
void fwd_tiles(int rows, int segs, int B, int T, long long* tiles, int* tiles_per_seq) {
  if (1 + (rows - 1 + T - 1) / T <= segs) {
    *tiles_per_seq = 0;
    *tiles = ((long long)B * T + rows - 1) / rows;
  } else {
    *tiles_per_seq = (T + rows - 1) / rows;
    *tiles = (long long)B * *tiles_per_seq;
  }
}

template <bool kFromWav>
cudaError_t conv_fwd(const Src& s, const float* wsp, const float* bias, float* out, int B,
                     int Tout, int Cout, float leak, cudaStream_t stream) {
  using G = FGeo<kFromWav>;
  long long tiles;
  int tps;
  fwd_tiles(G::kRows, G::kSeg, B, Tout, &tiles, &tps);
  if (tiles * (Cout / kFN) > INT_MAX) return cudaErrorInvalidValue;
  const auto kernel = wav_conv_fwd_kernel<kFromWav>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::kBytes);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)(tiles * (Cout / kFN)), G::kThreads, G::kBytes, stream>>>(
      s, wsp, bias, out, B, Tout, Cout, leak, tps);
  return cudaGetLastError();
}

template <bool kFromWav, int kDWM>
cudaError_t bwd_data(const Src& s, const float* wsp, const float* g, int B, int Tout, int Cout,
                     float leak, float* gy, float* part, cudaStream_t stream) {
  constexpr int kRows = 16 * kDWM;
  using G = DGeo<kRows>;
  constexpr size_t bytes = kDBarBytes + (size_t)(kDRing * G::kSlot + kDWM * 2 * kDCW +
                                                 (kFromWav ? G::kSamples : 0)) * sizeof(float);
  const auto kernel = wav_bwd_data_kernel<kFromWav, kDWM>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  const int q = (s.T + kS - 1) / kS;
  const dim3 grid((q + kRows - 1) / kRows, s.C / kDCW, B);
  kernel<<<grid, 32 * (kDWM * kDWN + 1), bytes, stream>>>(s, wsp, g, Tout, Cout, leak, gy, part);
  return cudaGetLastError();
}

}  // namespace

// Each launch function enqueues on `stream` and returns the cudaError_t of
// its launch (0 on success); cudaErrorInvalidValue for shapes it does not take.
// A stage input is (from_wav, pre, st, T_in, C_in) and the waveform with
// conv0's parameters (wav, w0, b0, L), as Src describes.

// st0 [B, 2, 32] (IN0's mean and 1/std over time) of conv0 over wav [B, L];
// T1 must be conv0's length for L. The split of a sequence's live times,
// `cluster` CTAs of `per` times (ops/fused_wav.py: stats0_geometry), must
// cover them, every CTA some, `per` a whole number of CTA steps of 8 warps
// x 32 times.
extern "C" int fused_wav_stats0_launch(const float* wav, const float* w0, const float* b0, int L,
                                       int T1, int B, int cluster, int per, float* st0,
                                       void* stream) {
  if (wav == nullptr || w0 == nullptr || b0 == nullptr || st0 == nullptr || B < 1 ||
      B > INT_MAX / kStatsCluster || L < 1 || L > INT_MAX - 2 * kPad0 ||
      T1 != (L + 2 * kPad0 - kK) / kS0 + 1 || T1 >= (1 << 24) || cluster < 1 ||
      cluster > kStatsCluster || per < 1 || per % (kWarps * kC0Batch) != 0)
    return (int)cudaErrorInvalidValue;
  const long long live = conv0_hi(L, T1) - kT0Lo;
  if ((long long)(cluster - 1) * per >= live || (long long)cluster * per < live)
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  cluster_launch_config(&cfg, attr, kThreads, B, cluster, 0);
  cfg.stream = (cudaStream_t)stream;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, wav_stats0_kernel, make_src(nullptr, nullptr, T1, kC0, wav, w0, b0, L), per, st0);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// st [B, 2, C] (mean, 1/std over time) of x [B, T, C], C = 32, 64 or 128,
// x 16-byte aligned.
extern "C" int fused_wav_stats_launch(const float* x, int B, int T, int C, float* st,
                                      void* stream) {
  if (x == nullptr || st == nullptr || B < 1 || B > INT_MAX / kStatsCluster || T < 1 ||
      T >= (1 << 24) || (C != 32 && C != 64 && C != 128) || (uintptr_t)x % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const StatsGeo g = stats_geometry(B, T, C);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  cluster_launch_config(&cfg, attr, kThreads, B, g.cluster, 0);
  cfg.stream = (cudaStream_t)stream;
  const cudaError_t err =
      C == 32    ? cudaLaunchKernelEx(&cfg, wav_stats_kernel<32>, x, T, g.per, st)
      : C == 64  ? cudaLaunchKernelEx(&cfg, wav_stats_kernel<64>, x, T, g.per, st)
                 : cudaLaunchKernelEx(&cfg, wav_stats_kernel<128>, x, T, g.per, st);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// wsp [C_in / 16, C_out / 64, 15, 2, 64, 4, 4]: conv i's weights [C_out,
// C_in, 15] split into TF32 halves in the forward conv kernel's order; C_in
// a multiple of 16, C_out of 64.
extern "C" int fused_wav_wsplit_fwd_launch(const float* w, int C_in, int C_out, float* wsp,
                                           void* stream) {
  if (w == nullptr || wsp == nullptr || C_in < kFC || C_in % kFC != 0 || C_out < kFN ||
      C_out % kFN != 0 || (uintptr_t)wsp % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int n = C_in / kFC * (C_out / kFN) * kK * kFTap / 4;
  wav_wsplit_fwd_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      w, C_in, C_out, reinterpret_cast<float4*>(wsp));
  return (int)cudaGetLastError();
}

// out [B, Tout, Cout] = conv over lrelu(IN(input)) plus bias, from the split
// weights w (fused_wav_wsplit_fwd_launch's wsp); C_out a multiple of 64.
extern "C" int fused_wav_conv_fwd_launch(
    int from_wav, const float* pre, const float* st, int T_in, int C_in, const float* wav,
    const float* w0, const float* b0, int L, const float* w, const float* bias, float* out,
    int B, int Tout, int Cout, float leak, void* stream) {
  if (!src_ok(from_wav, pre, T_in, C_in) || B < 1 || B > 65535 || Tout < 1 || Cout < kFN ||
      Cout % kFN != 0 || kS * (Tout - 1) + kK > T_in || (long long)B * Tout > INT_MAX ||
      w == nullptr || bias == nullptr || out == nullptr ||
      ((uintptr_t)w | (uintptr_t)pre) % 16 != 0 || (uintptr_t)out % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const Src s = make_src(pre, st, T_in, C_in, wav, w0, b0, L);
  const cudaStream_t st_ = (cudaStream_t)stream;
  if (from_wav) return (int)conv_fwd<true>(s, w, bias, out, B, Tout, Cout, leak, st_);
  return (int)conv_fwd<false>(s, w, bias, out, B, Tout, Cout, leak, st_);
}

// wsp [C_out / 8, C_in / 16, 15, 16, 8, 2]: conv i's weights [C_out, C_in, 15]
// split into TF32 halves in the data-gradient kernel's order; C_out a
// multiple of 8, C_in of 16.
extern "C" int fused_wav_wsplit_launch(const float* w, int C_in, int C_out, float* wsp,
                                       void* stream) {
  if (w == nullptr || wsp == nullptr || C_in < kDCW || C_in % kDCW != 0 || C_out < kDO ||
      C_out % kDO != 0 || (uintptr_t)wsp % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int n = C_out / kDO * kK * C_in * 4;
  wav_wsplit_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      w, C_in, C_out, reinterpret_cast<float4*>(wsp));
  return (int)cudaGetLastError();
}

// gy [B, T_in, C_in] and part [B, ntq, 2, C_in] from the split weights wsp
// (fused_wav_wsplit_launch): ntq = ceil(ceil(T_in / 6) / rows), rows = 64,
// or 48 for a stored input with ceil(T_in / 6) <= 48; C_out a multiple of 8.
extern "C" int fused_wav_bwd_data_launch(
    int from_wav, const float* pre, const float* st, int T_in, int C_in, const float* wav,
    const float* w0, const float* b0, int L, const float* wsp, const float* g, int B, int Tout,
    int Cout, float leak, float* gy, float* part, void* stream) {
  if (!src_ok(from_wav, pre, T_in, C_in) || B < 1 || B > 65535 || Tout < 1 || Cout < kDO ||
      Cout % kDO != 0 || kS * (Tout - 1) + kK > T_in || wsp == nullptr || g == nullptr ||
      gy == nullptr || part == nullptr ||
      ((uintptr_t)wsp | (uintptr_t)g | (uintptr_t)pre | (uintptr_t)gy) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const Src s = make_src(pre, st, T_in, C_in, wav, w0, b0, L);
  const cudaStream_t st_ = (cudaStream_t)stream;
  if (from_wav)
    return (int)bwd_data<true, 4>(s, wsp, g, B, Tout, Cout, leak, gy, part, st_);
  if (bwd_data_rows(from_wav, T_in) == 64)
    return (int)bwd_data<false, 4>(s, wsp, g, B, Tout, Cout, leak, gy, part, st_);
  return (int)bwd_data<false, 3>(s, wsp, g, B, Tout, Cout, leak, gy, part, st_);
}

extern "C" int fused_wav_in_bwd_launch(const float* pre, const float* st, const float* part,
                                       int ntq, int B, int T, int C, float* g, void* stream) {
  if (B < 1 || T < 1 || C < 1 || 2 * C > kThreads || ntq < 1) return (int)cudaErrorInvalidValue;
  wav_in_bwd_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(pre, st, part, ntq, T, C, g);
  return (int)cudaGetLastError();
}

// part [nsplit, C_out * C_in * 15 + C_out]; rows (b, t) in chunks of
// rows_per_split, a multiple of 32 (ops/fused_wav.py: wgrad_geometry), the
// last chunk ending at B * Tout; C_out a multiple of 64.
extern "C" int fused_wav_wgrad_launch(
    int from_wav, const float* pre, const float* st, int T_in, int C_in, const float* wav,
    const float* w0, const float* b0, int L, const float* g, int B, int Tout, int Cout,
    float leak, float* part, int nsplit, int rows_per_split, void* stream) {
  const long long rows = (long long)B * Tout;
  if (!src_ok(from_wav, pre, T_in, C_in) || B < 1 || Tout < 1 || Cout < kGN || Cout % kGN != 0 ||
      nsplit < 1 || nsplit > 65535 || rows_per_split < 1 || rows_per_split % kGRows != 0 ||
      rows > INT_MAX || (long long)nsplit * rows_per_split < rows ||
      (long long)(nsplit - 1) * rows_per_split >= rows || kS * (Tout - 1) + kK > T_in ||
      g == nullptr || part == nullptr || ((uintptr_t)g | (uintptr_t)pre) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const Src s = make_src(pre, st, T_in, C_in, wav, w0, b0, L);
  const auto kernel = from_wav ? wav_wgrad_kernel<true> : wav_wgrad_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kGSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(C_in / kGC * (Cout / kGN), nsplit);
  kernel<<<grid, kGThreads, kGSmemBytes, (cudaStream_t)stream>>>(s, g, B, Tout, Cout, leak, part,
                                                                 rows_per_split);
  return (int)cudaGetLastError();
}

// part [nparts, 512] (dW0 then db0 partials) and dwav [B, L], or null for
// no waveform gradient, from gy1 [B, T1, 32] (16-byte aligned) and its tile
// sums part_in [B, ntq, 2, 32]; T1 must be conv0's length for L. The split
// of a sequence's times, `splits` warps of `per` times (ops/fused_wav.py:
// wgrad0_geometry), must cover them, every warp some, `per` a multiple of
// 4; nparts is then the CTAs of 8 warps that B splits warps make.
extern "C" int fused_wav_wgrad0_launch(const float* wav, const float* w0, const float* b0, int L,
                                       const float* st0, const float* gy1, const float* part_in,
                                       int ntq, int B, int T1, int splits, int per, float* part,
                                       int nparts, float* dwav, void* stream) {
  if (wav == nullptr || w0 == nullptr || b0 == nullptr || st0 == nullptr || gy1 == nullptr ||
      part_in == nullptr || part == nullptr || B < 1 || B > 65535 || L < 1 ||
      L > INT_MAX - 2 * kPad0 || T1 != (L + 2 * kPad0 - kK) / kS0 + 1 || ntq < 1 ||
      (uintptr_t)gy1 % 16 != 0 || splits < 1 || per < kC0Group || per % kC0Group != 0 ||
      (long long)(splits - 1) * per >= T1 || (long long)splits * per < T1 ||
      nparts != ((long long)B * splits + kWarps - 1) / kWarps)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      wav_wgrad0_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kW0Smem);
  if (err != cudaSuccess) return (int)err;
  wav_wgrad0_kernel<<<nparts, kThreads, kW0Smem, (cudaStream_t)stream>>>(
      make_src(nullptr, st0, T1, kC0, wav, w0, b0, L), gy1, part_in, ntq, B, splits, per,
      part, dwav);
  return (int)cudaGetLastError();
}

// out [width] = part [n, width] summed over its rows in reduce_geometry's
// grouping; for a width that is a multiple of 4, part and out 16-byte
// aligned.
extern "C" int fused_wav_reduce_launch(const float* part, int n, int width, float* out,
                                       void* stream) {
  if (part == nullptr || out == nullptr || n < 1 || width < 1) return (int)cudaErrorInvalidValue;
  const RedGeo g = reduce_geometry(n, width);
  const cudaStream_t st = (cudaStream_t)stream;
  if (g.vec == 4) {
    if (((uintptr_t)part | (uintptr_t)out) % 16 != 0) return (int)cudaErrorInvalidValue;
    wav_reduce_kernel<float4><<<g.ctas, kThreads, 0, st>>>(
        reinterpret_cast<const float4*>(part), n, width / 4, g.q, g.rows,
        reinterpret_cast<float4*>(out));
  } else {
    wav_reduce_kernel<float><<<g.ctas, kThreads, 0, st>>>(part, n, width, g.q, g.rows, out);
  }
  return (int)cudaGetLastError();
}
