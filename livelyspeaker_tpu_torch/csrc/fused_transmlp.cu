// Fused TransMLP stack for NVIDIA Hopper (sm_90a), f32: one sequence split
// across a thread-block cluster.
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
// The same kernel is the training forward (the Pallas `_fwd_kernel` of
// livelyspeaker_tpu/ops/pallas/fused_mlp_train.py: fused_transmlp_train):
// with a stash pointer, CTA r also writes its columns of every block's input
// to stash [L, B, S, D], with streaming stores that keep ch_w in L2.
//
// What bounds it: the FP32 pipe. The contract is f32 FMA with f32
// accumulation (no tensor cores, no TF32), 67 TFLOP/s on an H100 SXM at
// 700 W. At the serving call (2B = 16 sequences, S = 35, D = 512, L = 8,
// LN2 folded, pose F = 27) that is 2.52 GFLOP, 37.7 us; the 9.7 MB it moves
// would take 2.9 us at 3.35 TB/s. The channel mix is 97% of the FLOPs.
//
// The design, and what it does about that:
// - Cluster split. A sequence is spread over a cluster of N CTAs (the
//   wrapper's transmlp_geometry picks N from the batch and the clusters the
//   card holds at once). CTA r owns columns [r*Dc, (r+1)*Dc) of the
//   activation, Dc = D/N, which stay in its shared memory for all L blocks.
//   One CTA per sequence put the serving batch on 16 of 132 SMs; at N = 4
//   it takes 64, at N = 8 (a batch of up to 15 clusters: an H100 SXM holds
//   15 clusters of 8 at once, not 16) 120.
// - The token mix is column-local: each CTA runs it on its own columns.
// - LayerNorm needs whole rows. Each CTA takes two-pass statistics (mean,
//   then the centred sum of squares M2) over its Dc columns, pushes them to
//   every CTA of the cluster through distributed shared memory, and after
//   one cluster barrier each CTA combines the N pairs with Chan's formula:
//   mean = avg(mean_r), M2 = sum(M2_r) + Dc * sum((mean_r - mean)^2). Never
//   E[x^2] - E[x]^2, which cancels once the bias lifts the mean.
// - The channel mix needs whole rows of LN2(x): each CTA normalises its
//   columns and stores them into every CTA's [S, D] copy; after a cluster
//   barrier each CTA multiplies the full rows by its [D, Dc] slice of ch_w,
//   so no CTA streams more than 1/N of ch_w.
// - The product: each thread owns a 9-row x 8-column register tile; the
//   threads of one [36, Dc] tile form a K-slice (whole warps when Dc >= 64),
//   and the ns <= 8 K-slices split K in contiguous ranges. A warp's reads of
//   ch_w are one 128-byte row segment shared by its four row groups, its
//   reads of LN2(x) four float4 in distinct banks: per four K rows 17 shared
//   loads for 288 FMAs, the next quad's loads spread over the current one's
//   FMAs. The K-slices' partial tiles are summed through shared memory in a
//   fixed order: the same bits every run.
// - The weight stream is asynchronous: each K-slice has its own ring of
//   kRing stages of kKt = 16 rows of its ch_w range. One 2-D TMA copy a
//   stage (a tensor map over ch_w as an [L * D, D] matrix; per-row bulk
//   copies cost a request each and starved the FMAs) completes on the
//   stage's "full" mbarrier; the slice's threads arrive, a warp at a time,
//   on its "empty" mbarrier when done, and the slice's first thread then
//   refills it kRing tiles ahead, into the next layer at a layer's end, so
//   the first tiles of a layer load during the LayerNorms and the token
//   mix. The slices run apart: nothing waits for the whole CTA until the
//   partial tiles are summed.
// - The pose projection: after one more exchange of x, CTA r computes
//   output columns [r*Fc, (r+1)*Fc) of F, Fc = ceil(F / N).
// Per layer: 3 cluster barriers (LN1 statistics, LN2 statistics, the LN2
// rows); 2 more for the pose projection.
//
// Limits: S <= 36, 16 <= D <= 512 with D % 16 == 0, F <= 512, f32 only;
// N in {1, 2, 4, 8} with Dc = D/N a multiple of 4 and at most 128.
// Anything else returns cudaErrorInvalidValue, and a refused launch returns
// its own error; the wrapper raises on either.

#include "transmlp_common.cuh"

namespace {

constexpr int kKt = 16;                    // ch_w rows per K-tile
constexpr int kRing = 3;                   // ring stages of one K-slice
constexpr int kStagesMax = kSlicesMax * kRing;
constexpr int kRingFloats = 24576;         // the ring, 96 KB: >= kStagesMax * kKt * ws
                                           // for every ws (ns * ws <= 512)
constexpr int kBars = 2 * kStagesMax + 3;  // full and empty per stage, two parameter
                                           // buffers, staging
constexpr int kBarBytes = (kBars * 8 + 127) / 128 * 128;  // the ring starts 128-byte aligned

// one layer's token mix [kSPad, kSPad], its bias [kSPad], and this CTA's
// columns of the LN1 scale and bias, the LN2 scale and bias, the channel-mix bias
__host__ __device__ inline int prm_floats(int dc) { return kSPad * kSPad + kSPad + 5 * dc; }

struct ClusterParams {
  CUtensorMap cw_map;   // ch_w as a [L * D, D] matrix, boxes of [kKt, ring_stride]
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
  int S, D, L, F, N;
};

// Layout of the dynamic shared memory, in floats after the mbarriers.
struct Smem {
  int dp, dc;  // row stride of the full rows (D + 4: a warp's four row
               // groups fall in different banks), Dc
  __host__ __device__ Smem(int D, int N) : dp(D + 4), dc(D / N) {}
  __host__ __device__ int ring() const { return 0; }  // kRing stages a K-slice
  // [kSPad, dp] full rows; also LN1(x) [kSPad, dc] and the partial tiles
  __host__ __device__ int a() const { return ring() + kRingFloats; }
  __host__ __device__ int x() const {  // [kSPad, dc]
    return a() + (kSPad * dp > kRedFloats ? kSPad * dp : kRedFloats);
  }
  __host__ __device__ int prm() const { return x() + kSPad * dc; }  // 2 buffers
  __host__ __device__ int emb() const { return prm() + 2 * prm_floats(dc); }  // [dc]
  __host__ __device__ int stats() const { return emb() + dc; }  // [2, kMaxCluster, kSPad, 2]
  __host__ __device__ int rowstat() const { return stats() + 2 * kMaxCluster * kSPad * 2; }
  __host__ __device__ int floats() const { return rowstat() + 2 * kSPad; }  // mean, 1/std
  __host__ __device__ size_t bytes() const {
    return kBarBytes + (size_t)floats() * sizeof(float);
  }
};

struct Ctx {
  const ClusterParams& p;
  int rank, c0, dc, dp, ws;  // ws: ring row stride
  size_t seq;
  float *a_s, *x_s, *ring, *prm, *emb_s, *st, *mean_s, *inv_s;
  // [0, kStagesMax): full; [kStagesMax, 2 kStagesMax): empty; then the two
  // parameter buffers and the staging of the pose projection
  uint64_t* bars;
};

// Queues layer l's small parameters into parameter buffer l % 2 (every
// thread). The token mix's padding outside [S, S] was zeroed once and is
// never written.
__device__ __forceinline__ void issue_params(const Ctx& c, int l) {
  if (l >= c.p.L) return;
  const ClusterParams& p = c.p;
  const int S = p.S, dc = c.dc, q4 = dc / 4;
  float* b = c.prm + (l % 2) * prm_floats(dc);
  const float* tw = p.tw + (size_t)l * S * S;
  for (int i = threadIdx.x / 32; i < S; i += kT / 32)  // a warp a row
    for (int j = threadIdx.x % 32; j < S; j += 32) cp_async4(b + i * kSPad + j, tw + i * S + j, true);
  if (threadIdx.x < S) cp_async4(b + kSPad * kSPad + threadIdx.x, p.tb + (size_t)l * S + threadIdx.x, true);
  float* v = b + kSPad * kSPad + kSPad;
  for (int idx = threadIdx.x; idx < 5 * q4; idx += kT) {
    const int which = idx / q4, col = (idx % q4) * 4;
    const float* src = which == 0 ? p.ln1_s : which == 1 ? p.ln1_b : which == 2 ? p.ln2_s
                     : which == 3 ? p.ln2_b : p.cb;
    if (src != nullptr) cp_async16(v + which * dc + col, src + (size_t)l * p.D + c.c0 + col, true);
  }
  cp_async_arrive(&c.bars[2 * kStagesMax + l % 2]);
}

// Row statistics of src [kSPad, dc] over the whole D columns of the cluster,
// into mean_s / inv_s, through exchange buffer `which` (one cluster barrier).
__device__ __forceinline__ void row_stats(const Ctx& c, const float* src, int which) {
  cluster_row_stats(src, c.p.S, c.p.N, c.p.D, c.dc, c.rank,
                    c.st + which * kMaxCluster * kSPad * 2, c.mean_s, c.inv_s);
}

// x[i, c] += act(sum_j tw[i, j] h[j, c] + tb[i]) on this CTA's columns;
// tw is zero outside [S, S] and h rows >= S are zero. A thread takes two
// adjacent columns, so each read of tw feeds two FMAs.
template <int kAct>
__device__ __forceinline__ void token_mix_cols(const Ctx& c, const float* h_s, const float* tw,
                                               const float* tb) {
  const int pairs = c.dc / 2, groups = kT / pairs;
  if (threadIdx.x >= groups * pairs) return;
  const int col = 2 * (threadIdx.x % pairs), grp = threadIdx.x / pairs;
  float2 h[kSPad];
#pragma unroll
  for (int j = 0; j < kSPad; ++j) h[j] = *reinterpret_cast<const float2*>(h_s + j * c.dc + col);
  for (int i = grp; i < c.p.S; i += groups) {
    const float4* t4 = reinterpret_cast<const float4*>(tw + i * kSPad);
    float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
    for (int j = 0; j < kSPad / 4; ++j) {
      const float4 t = t4[j];
      a0 = fmaf(t.x, h[4 * j].x, a0);
      a1 = fmaf(t.x, h[4 * j].y, a1);
      a0 = fmaf(t.y, h[4 * j + 1].x, a0);
      a1 = fmaf(t.y, h[4 * j + 1].y, a1);
      a0 = fmaf(t.z, h[4 * j + 2].x, a0);
      a1 = fmaf(t.z, h[4 * j + 2].y, a1);
      a0 = fmaf(t.w, h[4 * j + 3].x, a0);
      a1 = fmaf(t.w, h[4 * j + 3].y, a1);
    }
    float2* xr = reinterpret_cast<float2*>(c.x_s + i * c.dc + col);
    float2 x = *xr;
    x.x += activate(a0 + tb[i], kAct);
    x.y += activate(a1 + tb[i], kAct);
    *xr = x;
  }
}

// One thread of K-slice t.slice: queues the slice's K-tile u (numbered
// across layers) into its ring stage u % kRing as one TMA box of [kKt, ws]
// of ch_w (columns past Dc are the next CTA's, or zeros past D; never read).
__device__ __forceinline__ void issue_tile(const Ctx& c, const Tiling& t, const SliceRows& r,
                                           int u) {
  if (u >= c.p.L * r.tiles) return;
  const int stage = t.slice * kRing + u % kRing, l = u / r.tiles;
  const int k0 = r.k0 + (u % r.tiles) * kKt;
  uint64_t* full = &c.bars[stage];
  mbar_expect_tx(full, kKt * c.ws * sizeof(float));
  tma_load_2d(c.ring + stage * kKt * c.ws, &c.p.cw_map, c.c0, l * c.p.D + k0, full);
}

// The first kRing K-tiles of every K-slice (the first thread of each).
__device__ __forceinline__ void issue_first_tiles(const Ctx& c) {
  const Tiling t(c.ws);
  if (!t.active || t.p != 0) return;
  const SliceRows r(t, c.p.D, kKt);
  for (int u = 0; u < kRing; ++u) issue_tile(c, t, r, u);
}

// The channel mix of layer l on this CTA's columns: x += act(a_s[:, :D] @
// ch_w slice + cb). Each K-slice multiplies its own rows of ch_w, kKt at a
// time, from its own ring of kRing stages: its threads arrive on the
// stage's empty barrier, a warp at a time, when done with it, and the
// slice's first thread then refills it kRing tiles ahead (into the next
// layer at the end of this one). The slices run apart; nothing waits for the whole CTA until
// the partial tiles are summed.
template <int kAct>
__device__ __forceinline__ void channel_mix(const Ctx& c, int l, const float* cb) {
  const Tiling t(c.ws);
  float acc[kTileRows][kTileCols];
  zero(acc);
  if (t.active) {
    const SliceRows r(t, c.p.D, kKt);
    const float* a_rows = c.a_s + t.rg * kTileRows * c.dp;
    for (int j = 0; j < r.tiles; ++j) {
      const int u = l * r.tiles + j, stage = t.slice * kRing + u % kRing;
      const uint32_t parity = (uint32_t)((u / kRing) & 1);
      mbar_wait(&c.bars[stage], parity);
      mma_quads(acc, a_rows, c.dp, c.ring + stage * kKt * c.ws + t.col, c.ws, t.half,
                r.k0 + j * kKt, 0, kKt / 4, 1);
      arrive_slice(t, &c.bars[kStagesMax + stage]);  // these threads are done with it
      if (t.p == 0 && u + kRing < c.p.L * r.tiles) {
        mbar_wait(&c.bars[kStagesMax + stage], parity);
        issue_tile(c, t, r, u + kRing);
      }
    }
  }
  float* x_s = c.x_s;
  const int dc = c.dc;
  reduce_slices(t, acc, c.a_s, c.p.S, [&](int row, int col, float4 s) {
    if (col >= dc) return;  // a padding quad of the ring's rows
    float4* xr = reinterpret_cast<float4*>(x_s + row * dc + col);
    const float4 b = *reinterpret_cast<const float4*>(cb + col);
    float4 x = *xr;
    x.x += activate(s.x + b.x, kAct);
    x.y += activate(s.y + b.y, kAct);
    x.z += activate(s.z + b.z, kAct);
    x.w += activate(s.w + b.w, kAct);
    *xr = x;
  });
}

// out[row, f0 + j] = x[row, :] @ ow[:, f0 + j] + ob[f0 + j] for this CTA's
// nf = min(Fc, F - f0) output columns, Fc = ceil(F / N), with the full rows
// of x in a_s, in blocks of up to 128 columns. A block's [D, nb] slice of
// ow is staged through the idle ring in K-chunks (4-byte copies: its rows
// are not 16-byte aligned), its columns padded with zeros to a multiple of
// 8, and multiplied as the channel mix is; the partial tiles are summed in
// the ring.
__device__ __forceinline__ void pose_projection(const Ctx& c, float* og) {
  const int F = c.p.F, D = c.p.D, S = c.p.S;
  const int fc = (F + c.p.N - 1) / c.p.N, f0 = c.rank * fc;
  const int nf = min(F, f0 + fc) - f0;
  uint64_t* bar = &c.bars[2 * kStagesMax + 2];
  int phase = 0;
  for (int j0 = 0; j0 < nf; j0 += kMaxCols) {  // uniform over the CTA
    const int nb = min(kMaxCols, nf - j0), ncols = (nb + kTileCols - 1) / kTileCols * kTileCols;
    const int kc = min(D, kRingFloats / ncols / 4 * 4);
    const Tiling t(ncols);
    float acc[kTileRows][kTileCols];
    zero(acc);
    const float* a_rows = c.a_s + t.rg * kTileRows * c.dp;
    for (int k0 = 0; k0 < D; k0 += kc, ++phase) {
      const int rows = min(kc, D - k0);
      for (int idx = threadIdx.x; idx < rows * ncols; idx += kT) {
        const int r = idx / ncols, j = idx % ncols;
        const bool in = j < nb;
        cp_async4(c.ring + idx, in ? c.p.ow + (size_t)(k0 + r) * F + f0 + j0 + j : c.p.ow, in);
      }
      cp_async_arrive(bar);
      mbar_wait(bar, (uint32_t)(phase & 1));
      if (t.active)
        mma_quads(acc, a_rows, c.dp, c.ring + t.col, ncols, t.half, k0, t.slice, rows / 4, t.ns);
      __syncthreads();  // the chunk is consumed
    }
    const float* ob = c.p.ob + f0 + j0;
    float* o = og + f0 + j0;
    reduce_slices(t, acc, c.ring, S, [&](int row, int col, float4 s) {
      const float v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col + j < nb) o[(size_t)row * F + col + j] = v[j] + __ldg(ob + col + j);
    });
    __syncthreads();  // the ring is free again
  }
}

// One instance per activation, picked at launch: the once-a-layer code
// (token mix, K-slice sums) holds only its own activation's instructions.
template <int kAct>
__global__ void __launch_bounds__(kT, 1)
fused_transmlp_cluster_kernel(const __grid_constant__ ClusterParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Smem lay(p.D, p.N);
  float* base = reinterpret_cast<float*>(smem_raw + kBarBytes);
  const int dc = lay.dc;
  Ctx c{p, 0, 0, dc, lay.dp, ring_stride(dc), 0,
        base + lay.a(), base + lay.x(), base + lay.ring(), base + lay.prm(),
        base + lay.emb(), base + lay.stats(), base + lay.rowstat(), base + lay.rowstat() + kSPad,
        reinterpret_cast<uint64_t*>(smem_raw)};
  c.rank = (int)cg::this_cluster().block_rank();
  c.c0 = c.rank * dc;
  c.seq = blockIdx.x / p.N;
  const int tid = threadIdx.x, S = p.S, D = p.D, q4 = dc / 4;
  const int pf = prm_floats(dc);

  if (tid < kStagesMax) {
    mbar_init(&c.bars[tid], 1);  // full: the issuing thread's expect_tx
    const Tiling t(c.ws);
    mbar_init(&c.bars[kStagesMax + tid], t.per);  // empty: every thread of the slice
  } else if (tid < kStagesMax + 3) {
    mbar_init(&c.bars[kStagesMax + tid], kT);  // parameters, staging: every thread's cp.async
  }
  mbar_init_fence();
  // the token mix's padding, this CTA's columns of x, the padding rows
  for (int idx = tid; idx < 2 * pf; idx += kT) c.prm[idx] = 0.0f;
  const float* xg = p.x + c.seq * S * D + c.c0;
  for (int idx = tid; idx < kSPad * dc; idx += kT) {
    const int r = idx / dc, col = idx % dc;
    c.x_s[idx] = r < S ? __ldg(xg + r * D + col) : 0.0f;
  }
  for (int idx = tid; idx < lay.x() - lay.a(); idx += kT) c.a_s[idx] = 0.0f;
  for (int idx = tid; idx < dc; idx += kT) c.emb_s[idx] = __ldg(p.emb + c.seq * D + c.c0 + idx);
  __syncthreads();  // barriers initialised, padding zeroed
  issue_first_tiles(c);
  issue_params(c, 0);
  // the first exchange writes into the other CTAs' shared memory: they
  // must have started and zeroed it
  cg::this_cluster().sync();

  const bool folded = p.ln2_s == nullptr;
  float* h_s = c.a_s;  // LN1(x) [kSPad, dc]: a_s is idle until the LN2 rows arrive
  for (int l = 0; l < p.L; ++l) {
    const float* prm = c.prm + (l % 2) * pf;
    const float *tw = prm, *tb = prm + kSPad * kSPad, *g1 = tb + kSPad, *b1 = g1 + dc,
                *g2 = b1 + dc, *b2 = g2 + dc, *cb = b2 + dc;
    float* sg = p.stash == nullptr
                    ? nullptr
                    : p.stash + (((size_t)l * (gridDim.x / p.N) + c.seq) * S) * D + c.c0;
    for (int idx = tid; idx < S * q4; idx += kT) {
      float4* xr = reinterpret_cast<float4*>(c.x_s) + idx;
      const float4 e = reinterpret_cast<const float4*>(c.emb_s)[idx % q4];
      const float4 x = *xr;
      if (sg != nullptr)
        __stcs(reinterpret_cast<float4*>(sg + (size_t)(idx / q4) * D) + idx % q4, x);
      *xr = make_float4(x.x + e.x, x.y + e.y, x.z + e.z, x.w + e.w);
    }
    mbar_wait(&c.bars[2 * kStagesMax + l % 2], (uint32_t)((l / 2) & 1));
    __syncthreads();
    issue_params(c, l + 1);  // its buffer was last read in layer l - 1

    // LN1 on this CTA's columns (padding rows zero), then the token mix
    row_stats(c, c.x_s, 0);
    for (int idx = tid; idx < kSPad * q4; idx += kT) {
      const int r = idx / q4, col = (idx % q4) * 4;
      float4 h = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (r < S) {
        const float4 x = reinterpret_cast<const float4*>(c.x_s)[idx];
        const float4 g = *reinterpret_cast<const float4*>(g1 + col);
        const float4 b = *reinterpret_cast<const float4*>(b1 + col);
        const float m = c.mean_s[r], inv = c.inv_s[r];
        h = make_float4((x.x - m) * inv * g.x + b.x, (x.y - m) * inv * g.y + b.y,
                        (x.z - m) * inv * g.z + b.z, (x.w - m) * inv * g.w + b.w);
      }
      reinterpret_cast<float4*>(h_s)[idx] = h;
    }
    __syncthreads();
    token_mix_cols<kAct>(c, h_s, tw, tb);
    __syncthreads();

    // LN2: statistics, then this CTA's normalised columns into every CTA's
    // full rows (no CTA still reads its a_s: all passed the barrier in
    // row_stats after their last channel mix and token mix)
    row_stats(c, c.x_s, 1);
    for (int r = tid / q4; r < S; r += kT / q4) {
      if (tid >= kT / q4 * q4) break;
      const int col = (tid % q4) * 4;
      const float4 xv = *reinterpret_cast<const float4*>(c.x_s + r * dc + col);
      const float m = c.mean_s[r], inv = c.inv_s[r];
      float4 v = make_float4((xv.x - m) * inv, (xv.y - m) * inv, (xv.z - m) * inv,
                             (xv.w - m) * inv);
      if (!folded) {
        v.x = v.x * g2[col] + b2[col];
        v.y = v.y * g2[col + 1] + b2[col + 1];
        v.z = v.z * g2[col + 2] + b2[col + 2];
        v.w = v.w * g2[col + 3] + b2[col + 3];
      }
      for (int j = 0; j < p.N; ++j) {
        float* dst = cg::this_cluster().map_shared_rank(c.a_s, j);
        *reinterpret_cast<float4*>(dst + r * c.dp + c.c0 + col) = v;
      }
    }
    cg::this_cluster().sync();

    channel_mix<kAct>(c, l, cb);
    __syncthreads();
  }

  if (p.ow != nullptr) {
    cg::this_cluster().sync();  // every CTA is done with its a_s
    for (int r = tid / q4; r < S; r += kT / q4) {
      if (tid >= kT / q4 * q4) break;
      const int col = (tid % q4) * 4;
      const float4 v = *reinterpret_cast<const float4*>(c.x_s + r * dc + col);
      for (int j = 0; j < p.N; ++j) {
        float* dst = cg::this_cluster().map_shared_rank(c.a_s, j);
        *reinterpret_cast<float4*>(dst + r * c.dp + c.c0 + col) = v;
      }
    }
    cg::this_cluster().sync();
    pose_projection(c, p.out + c.seq * S * p.F);
  } else {
    float* og = p.out + c.seq * S * D + c.c0;
    for (int idx = tid; idx < S * dc; idx += kT) og[(idx / dc) * D + idx % dc] = c.x_s[idx];
  }
}

bool shape_ok(int D, int cluster) { return cluster_ok(D, cluster); }

using Kernel = void (*)(const ClusterParams);

Kernel kernel_for(int act) {
  switch (act) {
    case kSilu: return fused_transmlp_cluster_kernel<kSilu>;
    case kRelu: return fused_transmlp_cluster_kernel<kRelu>;
    case kGelu: return fused_transmlp_cluster_kernel<kGelu>;
    case kLrelu: return fused_transmlp_cluster_kernel<kLrelu>;
    case kLrelu01: return fused_transmlp_cluster_kernel<kLrelu01>;
    default: return fused_transmlp_cluster_kernel<kLrelu02>;
  }
}

// Launches on `stream` as B clusters of `cluster` CTAs; returns the
// cudaError_t of the attribute call or the launch (0 on success).
int launch(const float* x, const float* emb, const float* ln1_s, const float* ln1_b,
           const float* tw, const float* tb, const float* ln2_s, const float* ln2_b,
           const float* cw, const float* cb, const float* ow, const float* ob, float* out,
           float* stash, int B, int S, int D, int L, int F, int act, int cluster,
           void* stream) {
  if (B < 0 || S < 1 || S > kSPad || !shape_ok(D, cluster) || L < 1 || act < kSilu ||
      act > kLrelu02 || (ow != nullptr && (F < 1 || F > kMaxN)) ||
      ((ln2_s == nullptr) != (ln2_b == nullptr)) || !aligned16(cw) || !aligned16(cb) ||
      !aligned16(ln1_s) || !aligned16(ln1_b) || !aligned16(ln2_s) || !aligned16(ln2_b) ||
      !aligned16(stash))
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  cluster_launch_config(&cfg, attr, kT, B, cluster, Smem(D, cluster).bytes());
  const Kernel kernel = kernel_for(act);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)cfg.dynamicSmemBytes);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return 0;
  cfg.stream = (cudaStream_t)stream;
  ClusterParams p{{}, x, emb, ln1_s, ln1_b, tw, tb, ln2_s, ln2_b, cw, cb, ow, ob, out, stash,
                  S, D, L, F, cluster};
  if (!weight_map(&p.cw_map, cw, (long long)L * D, D, D / cluster, kKt))
    return (int)cudaErrorInvalidValue;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one CTA, or 0 for a geometry the kernel refuses.
extern "C" long long fused_transmlp_smem_bytes(int D, int cluster) {
  return shape_ok(D, cluster) ? (long long)Smem(D, cluster).bytes() : 0;
}

// Clusters of `cluster` CTAs at width D the current card holds at once
// (cudaOccupancyMaxActiveClusters), or minus the cudaError_t.
extern "C" int fused_transmlp_max_clusters(int D, int cluster) {
  if (!shape_ok(D, cluster)) return -(int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  cluster_launch_config(&cfg, attr, kT, cluster, cluster, Smem(D, cluster).bytes());
  const Kernel kernel = kernel_for(kSilu);  // every instance has the same resources' shape
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)cfg.dynamicSmemBytes);
  int n = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// The sampling forward. ln2_s/ln2_b null: LN2 folded. ow/ob null: no pose
// projection, out is [B, S, D].
extern "C" int fused_transmlp_launch(
    const float* x, const float* emb, const float* ln1_s, const float* ln1_b,
    const float* tw, const float* tb, const float* ln2_s, const float* ln2_b,
    const float* cw, const float* cb, const float* ow, const float* ob,
    float* out, int B, int S, int D, int L, int F, int act, int cluster, void* stream) {
  return launch(x, emb, ln1_s, ln1_b, tw, tb, ln2_s, ln2_b, cw, cb, ow, ob, out, nullptr,
                B, S, D, L, F, act, cluster, stream);
}

// The training forward: the stack with the LN2 affine and no pose
// projection, out [B, S, D], and every block's input to stash [L, B, S, D].
extern "C" int fused_transmlp_stash_launch(
    const float* x, const float* emb, const float* ln1_s, const float* ln1_b,
    const float* tw, const float* tb, const float* ln2_s, const float* ln2_b,
    const float* cw, const float* cb, float* out, float* stash,
    int B, int S, int D, int L, int act, int cluster, void* stream) {
  if (ln2_s == nullptr || ln2_b == nullptr || stash == nullptr || act == kGelu)
    return (int)cudaErrorInvalidValue;
  return launch(x, emb, ln1_s, ln1_b, tw, tb, ln2_s, ln2_b, cw, cb, nullptr, nullptr, out,
                stash, B, S, D, L, D, act, cluster, stream);
}
