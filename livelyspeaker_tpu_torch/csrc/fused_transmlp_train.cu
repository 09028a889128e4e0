// The backward of the fused TransMLP stack for training on NVIDIA Hopper
// (sm_90a), f32: one sequence split across a thread-block cluster, every
// intermediate of a block kept on chip.
//
// Replaces the backward of livelyspeaker_tpu/ops/pallas/fused_mlp_train.py:
// fused_transmlp_train, the Pallas TPU kernel `_bwd_kernel`. (Its forward,
// `_fwd_kernel`, is the cluster kernel of fused_transmlp.cu with a stash
// pointer.) Per block, on one [S, D] sequence:
//   a  = x + emb
//   m1 = token_w @ LN1(a) + token_b,   r1 = a + act(m1)
//   m2 = LN2(r1) @ ch_w + ch_b,        y  = r1 + act(m2)
//
// One layer at a time from the last, three launches per layer:
// 1. bwd_block_kernel, one cluster of N CTAs per sequence: recomputes the
//    block from its stashed input and walks it back: g_m2 = g * act'(m2),
//    g_h2 = g_m2 @ ch_w^T, the LN2 backward, g_m1, g_h1 = token_w^T @ g_m1,
//    the LN1 backward. It writes the input cotangent g_a (in place over g),
//    adds sum_s g_a to d(emb), writes h2 and g_m2 to device memory for the
//    channel-mix weight gradient, and writes this sequence's share of every
//    other parameter gradient to a per-sequence row of `part`.
// 2. wgrad_kernel: d ch_w = h2^T g_m2 over all B*S rows, a [D, B*S] x
//    [B*S, D] product on the tensor cores in 3xTF32 (f32-accurate), each
//    128 x 128 output tile split by rows over a cluster whose CTAs add their
//    partial tiles in CTA order through distributed shared memory and write
//    d ch_w once.
// 3. reduce_kernel: sums `part` over the batch, in a fixed order, into this
//    layer's other gradients.
//
// What bounds the block kernel: the FP32 pipe (f32 FMA, f32 accumulation,
// no tensor cores, no TF32; 67 TFLOP/s on an H100 SXM at 700 W). At TED training
// shapes (B = 512, S = 35, D = 512, L = 8) the block kernel's two
// [S, D] x [D, D] products per sequence are 18.8 GFLOP a layer, 0.28 ms;
// what it must move (stash, g, g_a, h2, g_m2) is 188 MB a layer, 0.056 ms.
//
// The design of the block kernel, and what it does about that:
// - Cluster split, as in fused_transmlp.cu: CTA r owns the columns
//   [r*Dc, (r+1)*Dc), Dc = D/N, of every [S, D] intermediate. At Dc = 128 a
//   [36, Dc] tile is 18 KB, so a, xhat1, act'(m1), r1, xhat2, g_m2, g_h2,
//   g_r1, g_m1, h1 and g_h1 all live in four tiles and the full-rows buffer
//   of shared memory, each computed once; only h2 and g_m2 go to device
//   memory, once, for wgrad_kernel.
// - Both products stream their weights (ch_w, then its transpose) through
//   one ring of kBRing stages of kBKt rows per K-slice: 2-D TMA copies with
//   full/empty mbarriers and warp-level arrivals, into 9 x 8 register tiles
//   (transmlp_common.cuh). The tiles are numbered across the two products,
//   so the second product's first tiles load during the first one's
//   epilogue. Each product needs whole rows of its left operand (h2, then
//   g_m2): every CTA stores its columns into every CTA's [S, D + 4] buffer
//   through distributed shared memory.
// - One CTA an SM leaves nothing to hide the latency of device memory
//   behind, so all that is read from it before the products is requested
//   together at the start: the first weight tiles, the block input, this
//   CTA's columns of g (TMA copies; g waits in the tile that g_m2 takes over)
//   and the small parameters.
// - Row reductions cross the cluster: LN2's forward statistics with the
//   two-pass (mean, M2) exchange and Chan's combine; the LayerNorm
//   backward's sum_k gx and sum_k gx * xhat as one pair per row and CTA,
//   added in CTA order.
// - The token mix, g_m1, g_h1 and the column sums (d ln1, d ln2, d ch_b,
//   d emb) are column-local. d token_w and d token_b sum over columns: each
//   CTA computes its partial (a thread a 3 x 3 tile of outputs over Dc, the
//   start of its walk over Dc skewed so that a quarter-warp's float4 reads
//   fall in different banks) and pushes slice j of it to CTA j, which adds
//   the N slices in CTA order and writes its part of the row of `part`:
//   one row a sequence, as reduce_kernel reads it, and the same bits from
//   run to run.
// - The partial tiles of a product's K-slices are summed through the
//   full-rows buffer, so a cluster barrier stands between a product's
//   epilogue and the next gather into that buffer. Per launch: 7 cluster
//   barriers (the start, whose wait stands behind LN1 and the token mix;
//   LN2's statistics, the h2 rows, the end of the first epilogue, the g_m2
//   rows, the two LayerNorm backwards). LN1's statistics need none: every
//   CTA fetches the sequence's whole block input (one TMA copy into the
//   idle full rows) and takes the statistics of whole rows.
//
// What differs from the TPU kernel, and why: the TPU kernel adds each batch
// tile's weight gradients into one output block, which is safe there only
// because grid steps run in order. Blocks on this card run in parallel, so
// each sequence writes its own partial and a second pass sums them, and the
// channel-mix product's row splits are summed inside their cluster: no
// atomics.
//
// Limits: S <= 36, 16 <= D <= 512 with D % 16 == 0, f32, silu / relu / the
// leaky relus; N in {1, 2, 4, 8} with Dc = D/N a multiple of 4 and at most
// 128. Anything else returns cudaErrorInvalidValue.
//
// With -DK2_PHASES (k2_phases.py) thread 0 of every CTA adds the cycles of
// each phase into a per-CTA record; the shipped build has none of it.

#include <initializer_list>

#include "transmlp_common.cuh"

namespace {

constexpr int kBKt = 8;                         // weight rows per K-tile
constexpr int kBRing = 3;                       // ring stages of one K-slice
constexpr int kBStages = kSlicesMax * kBRing;
constexpr int kBRingFloats = kBStages * kBKt * 64;  // 48 KB: >= kBStages * kBKt * ws
                                                    // for every ws (ns * ws <= 512)
constexpr int kBBarBytes = ((2 * kBStages + 2) * 8 + 127) / 128 * 128;  // full and empty per
                                                                        // stage, x, g
constexpr int kTwp = kSPad * kSPad + kSPad;     // a CTA's padded d token_w, then d token_b
constexpr int kTwgFloats = kTwp + 4 * kMaxCluster;  // >= N * twp_chunk(N)
constexpr int kPhases = 24;                     // counters a CTA with -DK2_PHASES

// CTA j of the cluster sums the flat range [j * chunk, (j + 1) * chunk) of
// the N partial (d token_w, d token_b).
__host__ __device__ inline int twp_chunk(int N) { return ((kTwp + N - 1) / N + 3) / 4 * 4; }

struct BwdParams {
  CUtensorMap cw_map;   // this layer's ch_w [D, D] ([in, out]), boxes of [kBKt, ring_stride]
  CUtensorMap cwt_map;  // its transpose
  const float* stash;   // [B, S, D] block inputs of this layer
  const float* emb;     // [B, D]
  const float* g_in;    // [B, S, D] cotangent of this layer's output
  float* g_out;         // [B, S, D] cotangent of its input; may alias g_in
  float* gemb;          // [B, D], summed over the layers
  const float* ln1_s;   // [D] of this layer, likewise below
  const float* ln1_b;
  const float* tw;      // [S, S]
  const float* tb;      // [S]
  const float* ln2_s;
  const float* ln2_b;
  const float* cb;
  float* h2_g;          // [B, S, D] LN2 output, for the weight gradient
  float* gm2_g;         // [B, S, D] g_m2, for the weight gradient
  float* part;          // [B, P] per-sequence gradient partials
  long long* prof;      // [CTAs, kPhases] with -DK2_PHASES, else unused
  int first;            // 1 on the first layer walked: gemb is set, not added
  int S, D, N;
};

#ifdef K2_PHASES
#define PROF(i)                                  \
  do {                                           \
    if (threadIdx.x == 0) {                      \
      const long long _t = clock64();            \
      p.prof[blockIdx.x * kPhases + (i)] += _t - _tl; \
      _tl = _t;                                  \
    }                                            \
  } while (0)
#define PROF_LAP(var)              \
  do {                             \
    const long long _t = clock64(); \
    var += _t - _q;                \
    _q = _t;                       \
  } while (0)
#else
#define PROF(i)
#define PROF_LAP(var)
#endif

// Offsets into one row of `part`.
__host__ __device__ inline int part_size(int S, int D) { return 5 * D + S + S * S; }
enum PartOff { kDs1 = 0, kDb1 = 1, kDs2 = 2, kDb2 = 3, kDcb = 4 };  // times D
__host__ __device__ inline int dtb_off(int D) { return 5 * D; }
__host__ __device__ inline int dtw_off(int S, int D) { return 5 * D + S; }

// Layout of the block kernel's dynamic shared memory, in floats after the
// mbarriers.
struct BwdSmem {
  int dp, dc;  // row stride of the full rows (D + 4), Dc
  __host__ __device__ BwdSmem(int D, int N) : dp(D + 4), dc(D / N) {}
  __host__ __device__ int ring() const { return 0; }
  // [kSPad, dp] full rows of h2, then g_m2; also h1 and g_h1 [kSPad, dc]
  // and the K-slices' partial tiles
  __host__ __device__ int full() const { return ring() + kBRingFloats; }
  __host__ __device__ int tile(int i) const {  // four [kSPad, dc] tiles
    return full() + (kSPad * dp > kRedFloats ? kSPad * dp : kRedFloats) + i * kSPad * dc;
  }
  __host__ __device__ int tw() const { return tile(4); }          // [kSPad, kSPad]
  __host__ __device__ int twt() const { return tw() + kSPad * kSPad; }  // transposed
  // token_b [kSPad], then this CTA's columns of the LN1 scale and bias, the
  // LN2 scale and bias and the channel-mix bias
  __host__ __device__ int vec() const { return twt() + kSPad * kSPad; }
  __host__ __device__ int stats() const { return vec() + kSPad + 5 * dc; }  // [2, kMaxCluster, kSPad, 2]
  // mean1, 1/std1, mean2, 1/std2 and the LayerNorm backward's two row means
  __host__ __device__ int rowstat() const { return stats() + 2 * kMaxCluster * kSPad * 2; }
  __host__ __device__ int twg() const { return rowstat() + 6 * kSPad; }  // [N, twp_chunk]
  __host__ __device__ int floats() const { return twg() + kTwgFloats; }
  __host__ __device__ size_t bytes() const {
    return kBBarBytes + (size_t)floats() * sizeof(float);
  }
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

// f(r, col) for the rows r < nrows and this thread's four columns col ..
// col + 3 of a [*, 4 * q4] tile: the column is fixed per thread, kT / q4
// rows go at once.
template <class F>
__device__ __forceinline__ void for_rows(int q4, int nrows, F f) {
  const int per = kT / q4;
  if ((int)threadIdx.x >= per * q4) return;
  const int col = (threadIdx.x % q4) * 4;
  for (int r = threadIdx.x / q4; r < nrows; r += per) f(r, col);
}

// f(i, col, sum_j w[i, j] src[j, col], sum_j w[i, j] src[j, col + 1]) for
// this thread's column pair and the rows i < S of its group; w is
// [kSPad, kSPad], zero outside [S, S], and src [kSPad, dc] with finite rows
// >= S.
template <class F>
__device__ __forceinline__ void token_dot(const float* src, const float* w, int S, int dc, F f) {
  const int pairs = dc / 2, groups = kT / pairs;
  if ((int)threadIdx.x >= groups * pairs) return;
  const int col = 2 * (threadIdx.x % pairs), grp = threadIdx.x / pairs;
  float2 h[kSPad];
#pragma unroll
  for (int j = 0; j < kSPad; ++j) h[j] = *reinterpret_cast<const float2*>(src + j * dc + col);
  for (int i = grp; i < S; i += groups) {
    const float4* w4 = reinterpret_cast<const float4*>(w + i * kSPad);
    float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
    for (int j = 0; j < kSPad / 4; ++j) {
      const float4 t = w4[j];
      a0 = fmaf(t.x, h[4 * j].x, a0);
      a1 = fmaf(t.x, h[4 * j].y, a1);
      a0 = fmaf(t.y, h[4 * j + 1].x, a0);
      a1 = fmaf(t.y, h[4 * j + 1].y, a1);
      a0 = fmaf(t.z, h[4 * j + 2].x, a0);
      a1 = fmaf(t.z, h[4 * j + 2].y, a1);
      a0 = fmaf(t.w, h[4 * j + 3].x, a0);
      a1 = fmaf(t.w, h[4 * j + 3].y, a1);
    }
    f(i, col, a0, a1);
  }
}

// For each row r < S the two sums over this CTA's columns of f(r, col) (a
// float2 for the four columns col .. col + 3), eight lanes a row, pushed to
// slot `rank` of every CTA's st [kMaxCluster, kSPad, 2].
template <class F>
__device__ __forceinline__ void push_row_sums(int S, int N, int q4, int rank, float* st, F f) {
  const int sub = threadIdx.x % 8;
  for (int r = threadIdx.x / 8; r < (kSPad + kT / 8 - 1) / (kT / 8) * (kT / 8); r += kT / 8) {
    const int rr = min(r, kSPad - 1);
    float a = 0.0f, b = 0.0f;
    for (int k4 = sub; k4 < q4; k4 += 8) {
      const float2 v = f(rr, 4 * k4);
      a += v.x;
      b += v.y;
    }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      b += __shfl_xor_sync(0xffffffffu, b, o);
    }
    if (r < S && sub < N) {
      float* dst = cg::this_cluster().map_shared_rank(st, sub);
      *reinterpret_cast<float2*>(dst + (rank * kSPad + r) * 2) = make_float2(a, b);
    }
  }
}

// After the cluster barrier: the N pairs of each row added in CTA order and
// divided by D.
__device__ __forceinline__ void combine_row_sums(int S, int N, int D, const float* st,
                                                 float* mean_a, float* mean_b) {
  if ((int)threadIdx.x < S) {
    const float* pr = st + threadIdx.x * 2;
    float a = 0.0f, b = 0.0f;
    for (int j = 0; j < N; ++j) {
      a += pr[j * kSPad * 2];
      b += pr[j * kSPad * 2 + 1];
    }
    mean_a[threadIdx.x] = a / D;
    mean_b[threadIdx.x] = b / D;
  }
  __syncthreads();
}

// store(w, d, sum over the rows r < S of f(w, r, d)) for each of the nsum
// sums w and each column d < dc: a thread a (sum, column), four partial
// sums over the rows.
template <class F, class G>
__device__ __forceinline__ void col_sums(int nsum, int S, int dc, F f, G store) {
  const int groups = kT / dc;
  if ((int)threadIdx.x >= groups * dc) return;
  const int d = threadIdx.x % dc;
  for (int w = threadIdx.x / dc; w < nsum; w += groups) {
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
    int r = 0;
    for (; r + 3 < S; r += 4) {
      s0 += f(w, r, d);
      s1 += f(w, r + 1, d);
      s2 += f(w, r + 2, d);
      s3 += f(w, r + 3, d);
    }
    for (; r < S; ++r) s0 += f(w, r, d);
    store(w, d, (s0 + s1) + (s2 + s3));
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// LN1's statistics of the rows of a = x + emb over all D columns, a warp a
// row, two-pass, from this sequence's whole [S, D] block input in shared
// memory (xs, one TMA copy); this CTA's columns [c0, c0 + dc) of a go to
// a_tile. Every CTA of the cluster reads the whole rows: that costs L2
// reads and saves an exchange and a cluster barrier.
constexpr int kRowFloat4s = kMaxN / 4 / 32;  // float4 of a row a lane holds

__device__ __forceinline__ void ln1_from_rows(const float* xs, const float4 (&e)[kRowFloat4s],
                                              int S, int D, float* mean_s, float* inv_s,
                                              float* a_tile, int c0, int dc) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, n4 = D / 4;
  for (int r = warp; r < S; r += kT / 32) {
    float4 v[kRowFloat4s];
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < kRowFloat4s; ++k) {
      const int c4 = lane + 32 * k;
      if (c4 >= n4) continue;
      const float4 x = ld4(xs + r * D + 4 * c4);
      v[k] = make_float4(x.x + e[k].x, x.y + e[k].y, x.z + e[k].z, x.w + e[k].w);
      s += (v[k].x + v[k].y) + (v[k].z + v[k].w);
      const int col = 4 * c4 - c0;
      if (col >= 0 && col < dc) st4(a_tile + r * dc + col, v[k]);
    }
    const float mean = warp_sum(s) / D;
    float m2 = 0.0f;
#pragma unroll
    for (int k = 0; k < kRowFloat4s; ++k) {
      if (lane + 32 * k >= n4) continue;
      const float dx = v[k].x - mean, dy = v[k].y - mean, dz = v[k].z - mean,
                  dw = v[k].w - mean;
      m2 += (dx * dx + dy * dy) + (dz * dz + dw * dw);
    }
    m2 = warp_sum(m2);
    if (lane == 0) {
      mean_s[r] = mean;
      inv_s[r] = 1.0f / sqrtf(m2 / D + kEps);
    }
  }
}

// (act(v), d act / d v)
__device__ __forceinline__ float2 act_pair(float v, int act) {
  if (act == kSilu) {
    const float s = 1.0f / (1.0f + expf(-v));
    return make_float2(v * s, s * (1.0f + v * (1.0f - s)));
  }
  return make_float2(activate(v, act), dactivate(v, act));
}

struct Ring {
  const BwdParams& p;
  float* ring;
  uint64_t* bars;  // [0, kBStages): full; [kBStages, 2 kBStages): empty
  int ws, c0;      // ring row stride, this CTA's first column
};

// One thread of K-slice t.slice: queues the slice's K-tile u into its ring
// stage u % kBRing as one TMA box of [kBKt, ws]; the tiles of ch_w (the
// first product) are numbered before those of its transpose (the second).
__device__ __forceinline__ void issue_tile(const Ring& g, const Tiling& t, const SliceRows& r,
                                           int u) {
  if (u >= 2 * r.tiles) return;
  const int stage = t.slice * kBRing + u % kBRing;
  const bool second = u >= r.tiles;
  const int k0 = r.k0 + (second ? u - r.tiles : u) * kBKt;
  uint64_t* full = &g.bars[stage];
  mbar_expect_tx(full, kBKt * g.ws * sizeof(float));
  tma_load_2d(g.ring + stage * kBKt * g.ws, second ? &g.p.cwt_map : &g.p.cw_map, g.c0, k0, full);
}

// acc = a[:, :D] @ w[:, this CTA's columns], w = ch_w (which = 0) or its
// transpose (1), a the full rows [kSPad, dp]. Each K-slice multiplies its
// own rows of w, kBKt at a time, from its own ring: its threads arrive on
// the stage's empty barrier, a warp at a time, when done with it, and the
// slice's first thread then refills it kBRing tiles ahead.
__device__ __forceinline__ void product(const Ring& g, const Tiling& t, const SliceRows& r,
                                        int which, const float* a, int dp,
                                        float (&acc)[kTileRows][kTileCols], long long* lap) {
  zero(acc);
  if (!t.active) return;
#ifdef K2_PHASES
  long long _q = clock64();
#endif
  const float* a_rows = a + t.rg * kTileRows * dp;
  for (int j = 0; j < r.tiles; ++j) {
    const int u = which * r.tiles + j, stage = t.slice * kBRing + u % kBRing;
    const uint32_t parity = (uint32_t)((u / kBRing) & 1);
    mbar_wait(&g.bars[stage], parity);
    PROF_LAP(lap[0]);
    mma_quads(acc, a_rows, dp, g.ring + stage * kBKt * g.ws + t.col, g.ws, t.half,
              r.k0 + j * kBKt, 0, kBKt / 4, 1);
    PROF_LAP(lap[1]);
    arrive_slice(t, &g.bars[kBStages + stage]);  // these threads are done with it
    if (t.p == 0 && u + kBRing < 2 * r.tiles) {
      mbar_wait(&g.bars[kBStages + stage], parity);
      issue_tile(g, t, r, u + kBRing);
    }
    PROF_LAP(lap[2]);
  }
}

// One instance per activation, picked at launch.
template <int kAct>
__global__ void __launch_bounds__(kT, 1)
bwd_block_kernel(const __grid_constant__ BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const BwdSmem lay(p.D, p.N);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  float* base = reinterpret_cast<float*>(smem_raw + kBBarBytes);
  const int S = p.S, D = p.D, N = p.N, dc = lay.dc, dp = lay.dp, q4 = dc / 4;
  const int tid = threadIdx.x;
  const int rank = (int)cg::this_cluster().block_rank(), c0 = rank * dc;
  const size_t b = blockIdx.x / N, off = b * S * D + c0;  // this CTA's columns of sequence b
  float* ring = base + lay.ring();
  float* full = base + lay.full();
  float* hs = full;                  // h1, later g_h1: [kSPad, dc] while the rows are idle
  float* t1 = base + lay.tile(0);    // a, r1, xhat2, h1
  float* t2 = base + lay.tile(1);    // xhat1
  float* t3 = base + lay.tile(2);    // act'(m1), g_m1
  float* t4 = base + lay.tile(3);    // g_m2, g_h2, g_r1, g_a
  float* tw_s = base + lay.tw();
  float* twt_s = base + lay.twt();
  float* tb_s = base + lay.vec();
  float *g1 = tb_s + kSPad, *b1 = g1 + dc, *g2 = b1 + dc, *b2 = g2 + dc, *cb = b2 + dc;
  float* st0 = base + lay.stats();
  float* st1 = st0 + kMaxCluster * kSPad * 2;
  float* mean1 = base + lay.rowstat();
  float *inv1 = mean1 + kSPad, *mean2 = inv1 + kSPad, *inv2 = mean2 + kSPad, *ra = inv2 + kSPad,
        *rb = ra + kSPad;
  float* twg = base + lay.twg();
  float* part = p.part + b * part_size(S, D);
  const Tiling t(ring_stride(dc));
  const SliceRows sr(t, D, kBKt);
  const Ring rg{p, ring, bars, ring_stride(dc), c0};
#ifdef K2_PHASES
  long long _tl = clock64();
#endif
  long long lap[3] = {0, 0, 0};

  // the start barrier's arrival: its wait stands before the first store
  // into another CTA's shared memory (each must have started by then)
  cluster_arrive();
  uint64_t *xbar = &bars[2 * kBStages], *gbar = xbar + 1;
  if (tid < kBStages) {
    mbar_init(&bars[tid], 1);                  // full: the issuing thread's expect_tx
    mbar_init(&bars[kBStages + tid], t.per);   // empty: every thread of the slice
  } else if (tid == kBStages) {
    mbar_init(xbar, 1);
    mbar_init(gbar, 1);
  }
  mbar_init_fence();
  __syncthreads();
  // Everything read from device memory before the products, issued together
  // (one latency, not four): the first weight tiles; the sequence's whole
  // block input, one TMA copy into the idle full rows as [S, D]; this CTA's
  // columns of the cotangent g, a TMA copy a row into t4, where the first
  // epilogue finds it; the token mix (a warp a row, zero outside [S, S]),
  // its bias, this CTA's columns of the vectors, emb.
  if (t.active && t.p == 0)
    for (int u = 0; u < kBRing; ++u) issue_tile(rg, t, sr, u);
  if (tid == 0) {
    mbar_expect_tx(xbar, S * D * sizeof(float));
    tma_load_1d(full, p.stash + b * S * D, S * D * sizeof(float), xbar);
    mbar_expect_tx(gbar, S * dc * sizeof(float));
  }
  if (tid < S)
    tma_load_1d(t4 + tid * dc, p.g_in + off + (size_t)tid * D, dc * sizeof(float), gbar);
  PROF(18);

  constexpr int kTwRounds = (kSPad + kT / 32 - 1) / (kT / 32);
  float twv[kTwRounds][2];
#pragma unroll
  for (int i = 0; i < kTwRounds; ++i)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int row = tid / 32 + (kT / 32) * i, j = tid % 32 + 32 * jj;
      twv[i][jj] = (row < S && j < S) ? __ldg(p.tw + row * S + j) : 0.0f;
    }
  const float tbv = tid < S ? __ldg(p.tb + tid) : 0.0f;
  float4 vec = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (tid < 5 * q4) {  // q4 <= 32: one float4 a thread
    const int which = tid / q4, col = (tid % q4) * 4;
    const float* src = which == 0 ? p.ln1_s : which == 1 ? p.ln1_b : which == 2 ? p.ln2_s
                     : which == 3 ? p.ln2_b : p.cb;
    vec = __ldg(reinterpret_cast<const float4*>(src + c0 + col));
  }
  float4 e[kRowFloat4s];
#pragma unroll
  for (int k = 0; k < kRowFloat4s; ++k) {
    const int c4 = tid % 32 + 32 * k;
    e[k] = c4 < D / 4 ? __ldg(reinterpret_cast<const float4*>(p.emb + b * D) + c4)
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  // what is read before it is written: rows >= S of the four tiles (of h1:
  // below; rows >= S of the full rows only feed product rows never read)
  for (int idx = tid; idx < (kSPad - S) * dc; idx += kT) {
    t1[S * dc + idx] = 0.0f;
    t2[S * dc + idx] = 0.0f;
    t3[S * dc + idx] = 0.0f;
    t4[S * dc + idx] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < kTwRounds; ++i)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int row = tid / 32 + (kT / 32) * i, j = tid % 32 + 32 * jj;
      if (row < kSPad && j < kSPad) {
        tw_s[row * kSPad + j] = twv[i][jj];
        twt_s[j * kSPad + row] = twv[i][jj];
      }
    }
  if (tid < kSPad) tb_s[tid] = tbv;
  if (tid < 5 * q4) st4(g1 + (tid / q4) * dc + (tid % q4) * 4, vec);
  // LN1's statistics, and t1 = a = x + emb
  mbar_wait(xbar, 0);
  ln1_from_rows(full, e, S, D, mean1, inv1, t1, c0, dc);
  __syncthreads();
  PROF(0);

  // LN1: t2 = xhat1, hs = h1 (zero in its rows >= S, over the block input);
  // then the token mix: t1 = r1, t3 = act'(m1)
  for_rows(q4, kSPad, [&](int r, int col) {
    if (r >= S) {
      st4(hs + r * dc + col, make_float4(0.0f, 0.0f, 0.0f, 0.0f));
      return;
    }
    const float4 a = ld4(t1 + r * dc + col), g = ld4(g1 + col), be = ld4(b1 + col);
    const float m = mean1[r], inv = inv1[r];
    const float4 xh = make_float4((a.x - m) * inv, (a.y - m) * inv, (a.z - m) * inv,
                                  (a.w - m) * inv);
    st4(t2 + r * dc + col, xh);
    st4(hs + r * dc + col, make_float4(xh.x * g.x + be.x, xh.y * g.y + be.y, xh.z * g.z + be.z,
                                       xh.w * g.w + be.w));
  });
  __syncthreads();
  PROF(1);
  token_dot(hs, tw_s, S, dc, [&](int i, int col, float a0, float a1) {
    const float2 u0 = act_pair(a0 + tb_s[i], kAct), u1 = act_pair(a1 + tb_s[i], kAct);
    float2* xr = reinterpret_cast<float2*>(t1 + i * dc + col);
    const float2 x = *xr;
    *xr = make_float2(x.x + u0.x, x.y + u1.x);
    *reinterpret_cast<float2*>(t3 + i * dc + col) = make_float2(u0.y, u1.y);
  });
  __syncthreads();
  PROF(2);

  // LN2: t1 = xhat2; h2 to device memory and into every CTA's full rows (no
  // CTA still reads its hs: all passed the barrier in the statistics)
  cluster_wait();  // the start barrier
  cluster_row_stats(t1, S, N, D, dc, rank, st1, mean2, inv2);
  PROF(3);
  for_rows(q4, S, [&](int r, int col) {
    const float4 x = ld4(t1 + r * dc + col), g = ld4(g2 + col), be = ld4(b2 + col);
    const float m = mean2[r], inv = inv2[r];
    const float4 xh = make_float4((x.x - m) * inv, (x.y - m) * inv, (x.z - m) * inv,
                                  (x.w - m) * inv);
    st4(t1 + r * dc + col, xh);
    const float4 h = make_float4(xh.x * g.x + be.x, xh.y * g.y + be.y, xh.z * g.z + be.z,
                                 xh.w * g.w + be.w);
    st4(p.h2_g + off + (size_t)r * D + col, h);
    for (int j = 0; j < N; ++j)
      st4(cg::this_cluster().map_shared_rank(full, j) + r * dp + c0 + col, h);
  });
  cg::this_cluster().sync();
  PROF(4);

  // m2 = h2 @ ch_w + ch_b on this CTA's columns; t4 = g_m2 = g * act'(m2)
  // over g, also to device memory
  float acc[kTileRows][kTileCols];
  product(rg, t, sr, 0, full, dp, acc, lap);
  PROF(5);
  mbar_wait(gbar, 0);
  reduce_slices(t, acc, full, S, [&](int row, int col, float4 s) {
    if (col >= dc) return;  // a padding quad of the ring's rows
    const float4 bi = ld4(cb + col), g = ld4(t4 + row * dc + col);
    const float4 gm = make_float4(g.x * dactivate(s.x + bi.x, kAct), g.y * dactivate(s.y + bi.y, kAct),
                                  g.z * dactivate(s.z + bi.z, kAct), g.w * dactivate(s.w + bi.w, kAct));
    st4(t4 + row * dc + col, gm);
    st4(p.gm2_g + off + (size_t)row * D + col, gm);
  });
  PROF(19);
  // every CTA is done with its partial tiles before any g_m2 row arrives
  cg::this_cluster().sync();
  PROF(6);
  for_rows(q4, S, [&](int r, int col) {
    const float4 v = ld4(t4 + r * dc + col);
    for (int j = 0; j < N; ++j)
      st4(cg::this_cluster().map_shared_rank(full, j) + r * dp + c0 + col, v);
  });
  col_sums(1, S, dc, [&](int, int r, int d) { return t4[r * dc + d]; },
           [&](int, int d, float s) { part[kDcb * D + c0 + d] = s; });
  cg::this_cluster().sync();
  PROF(7);

  // t4 = g_h2 = g_m2 @ ch_w^T on this CTA's columns
  product(rg, t, sr, 1, full, dp, acc, lap);
  PROF(8);
  reduce_slices(t, acc, full, S, [&](int row, int col, float4 s) {
    if (col < dc) st4(t4 + row * dc + col, s);
  });
  __syncthreads();
  PROF(9);

  // LN2 backward: d ln2; t4 = g_r1 = g + LN2'(g_h2), t3 = g_m1 = g_r1 *
  // act'(m1), t1 = h1
  push_row_sums(S, N, q4, rank, st0, [&](int r, int col) {
    const float4 gy = ld4(t4 + r * dc + col), g = ld4(g2 + col), xh = ld4(t1 + r * dc + col);
    const float4 gx = make_float4(gy.x * g.x, gy.y * g.y, gy.z * g.z, gy.w * g.w);
    return make_float2((gx.x + gx.y) + (gx.z + gx.w),
                       (gx.x * xh.x + gx.y * xh.y) + (gx.z * xh.z + gx.w * xh.w));
  });
  col_sums(2, S, dc,
           [&](int w, int r, int d) {
             const float gy = t4[r * dc + d];
             return w == 0 ? gy * t1[r * dc + d] : gy;
           },
           [&](int w, int d, float s) { part[(w == 0 ? kDs2 : kDb2) * D + c0 + d] = s; });
  cg::this_cluster().sync();
  combine_row_sums(S, N, D, st0, ra, rb);
  PROF(10);
  for_rows(q4, S, [&](int r, int col) {
    const float4 gy = ld4(t4 + r * dc + col), g = ld4(g2 + col), xh = ld4(t1 + r * dc + col);
    const float4 go = ld4(p.g_in + off + (size_t)r * D + col), d1 = ld4(t3 + r * dc + col);
    const float inv = inv2[r], ma = ra[r], mb = rb[r];
    const float4 gr = make_float4(go.x + inv * (gy.x * g.x - ma - xh.x * mb),
                                  go.y + inv * (gy.y * g.y - ma - xh.y * mb),
                                  go.z + inv * (gy.z * g.z - ma - xh.z * mb),
                                  go.w + inv * (gy.w * g.w - ma - xh.w * mb));
    st4(t4 + r * dc + col, gr);
    st4(t3 + r * dc + col, make_float4(gr.x * d1.x, gr.y * d1.y, gr.z * d1.z, gr.w * d1.w));
    const float4 x1 = ld4(t2 + r * dc + col), s1 = ld4(g1 + col), be = ld4(b1 + col);
    st4(t1 + r * dc + col, make_float4(x1.x * s1.x + be.x, x1.y * s1.y + be.y,
                                       x1.z * s1.z + be.z, x1.w * s1.w + be.w));
  });
  __syncthreads();
  PROF(11);

  // d token_w[i, j] = sum_d g_m1[i, d] h1[j, d] and d token_b[i] = sum_d
  // g_m1[i, d] over this CTA's columns, each value pushed to the CTA that
  // sums its flat index
  const int chunk = twp_chunk(N);
  auto push_twp = [&](int f, float v) {
    const int owner = f / chunk;
    cg::this_cluster().map_shared_rank(twg, owner)[rank * chunk + f - owner * chunk] = v;
  };
  if (tid < 144) {  // 12 x 12 threads, a 3 x 3 tile of outputs each
    const int ti = tid / 12, tj = tid % 12;
    float a[3][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
    const float* gp = t3 + 3 * ti * dc;
    const float* hp = t1 + 3 * tj * dc;
    int d = (4 * tj) % dc;  // skewed: a quarter-warp's reads fall in different banks
    for (int n = 0; n < q4; ++n) {
      float4 gv[3], hv[3];
#pragma unroll
      for (int x = 0; x < 3; ++x) {
        gv[x] = ld4(gp + x * dc + d);
        hv[x] = ld4(hp + x * dc + d);
      }
#pragma unroll
      for (int x = 0; x < 3; ++x)
#pragma unroll
        for (int y = 0; y < 3; ++y) {
          a[x][y] = fmaf(gv[x].x, hv[y].x, a[x][y]);
          a[x][y] = fmaf(gv[x].y, hv[y].y, a[x][y]);
          a[x][y] = fmaf(gv[x].z, hv[y].z, a[x][y]);
          a[x][y] = fmaf(gv[x].w, hv[y].w, a[x][y]);
        }
      d += 4;
      if (d >= dc) d = 0;
    }
#pragma unroll
    for (int x = 0; x < 3; ++x)
#pragma unroll
      for (int y = 0; y < 3; ++y) push_twp((3 * ti + x) * kSPad + 3 * tj + y, a[x][y]);
  } else if (tid < 144 + kSPad) {
    const int i = tid - 144;
    float s = 0.0f;
    int d = (4 * i) % dc;
    for (int n = 0; n < q4; ++n) {
      const float4 v = ld4(t3 + i * dc + d);
      s += (v.x + v.y) + (v.z + v.w);
      d += 4;
      if (d >= dc) d = 0;
    }
    push_twp(kSPad * kSPad + i, s);
  }
  PROF(20);
  // hs = g_h1 = token_w^T @ g_m1 (the full rows are idle from here on)
  token_dot(t3, twt_s, S, dc, [&](int i, int col, float a0, float a1) {
    *reinterpret_cast<float2*>(hs + i * dc + col) = make_float2(a0, a1);
  });
  __syncthreads();
  PROF(12);

  // LN1 backward: d ln1; t4 = g_a = g_r1 + LN1'(g_h1), to device memory
  push_row_sums(S, N, q4, rank, st1, [&](int r, int col) {
    const float4 gy = ld4(hs + r * dc + col), g = ld4(g1 + col), xh = ld4(t2 + r * dc + col);
    const float4 gx = make_float4(gy.x * g.x, gy.y * g.y, gy.z * g.z, gy.w * g.w);
    return make_float2((gx.x + gx.y) + (gx.z + gx.w),
                       (gx.x * xh.x + gx.y * xh.y) + (gx.z * xh.z + gx.w * xh.w));
  });
  col_sums(2, S, dc,
           [&](int w, int r, int d) {
             const float gy = hs[r * dc + d];
             return w == 0 ? gy * t2[r * dc + d] : gy;
           },
           [&](int w, int d, float s) { part[(w == 0 ? kDs1 : kDb1) * D + c0 + d] = s; });
  cg::this_cluster().sync();
  combine_row_sums(S, N, D, st1, ra, rb);
  PROF(13);
  for_rows(q4, S, [&](int r, int col) {
    const float4 gy = ld4(hs + r * dc + col), g = ld4(g1 + col), xh = ld4(t2 + r * dc + col);
    const float4 gr = ld4(t4 + r * dc + col);
    const float inv = inv1[r], ma = ra[r], mb = rb[r];
    const float4 ga = make_float4(gr.x + inv * (gy.x * g.x - ma - xh.x * mb),
                                  gr.y + inv * (gy.y * g.y - ma - xh.y * mb),
                                  gr.z + inv * (gy.z * g.z - ma - xh.z * mb),
                                  gr.w + inv * (gy.w * g.w - ma - xh.w * mb));
    st4(t4 + r * dc + col, ga);
    st4(p.g_out + off + (size_t)r * D + col, ga);
  });
  // this CTA's range of d token_w and d token_b: the N partials in CTA order
  for (int e = tid; e < chunk; e += kT) {
    const int f = rank * chunk + e;
    if (f >= kTwp) break;
    float s = 0.0f;
    for (int j = 0; j < N; ++j) s += twg[j * chunk + e];
    if (f >= kSPad * kSPad) {
      if (f - kSPad * kSPad < S) part[dtb_off(D) + f - kSPad * kSPad] = s;
    } else {
      const int i = f / kSPad, j = f % kSPad;
      if (i < S && j < S) part[dtw_off(S, D) + i * S + j] = s;
    }
  }
  __syncthreads();
  // d emb += sum_s g_a
  float* ge = p.gemb + b * D + c0;
  const int first = p.first;
  col_sums(1, S, dc, [&](int, int r, int d) { return t4[r * dc + d]; },
           [&](int, int d, float s) { ge[d] = first ? s : ge[d] + s; });
  PROF(14);
#ifdef K2_PHASES
  if (tid == 0)
    for (int i = 0; i < 3; ++i) p.prof[blockIdx.x * kPhases + 15 + i] += lap[i];
#endif
}

// ---- the channel-mix weight gradient: d ch_w = h2^T g_m2 in 3xTF32 ----
//
// dcw[m, n] = sum_r a[r, m] * c[r, n] over the R rows of a = h2 and c = g_m2
// ([R, D] each, row-major): a product whose reduction runs over the rows.
// What bounds it: the tensor cores, 3 * 2 R D^2 TF32 FLOP at 495 TFLOP/s
// (0.057 ms a layer at TED B = 512, R = 17,920), far above its 73 MB of
// reads at 3.35 TB/s (0.022 ms). The FP32 pipe would cap the same product at
// 67 TFLOP/s (0.14 ms a layer).
//
// 3xTF32: each operand is split, x = hi + lo with hi = rna_tf32(x) and lo =
// rna_tf32(x - hi) (split_tf32), and each 16 x 8 x 8 step runs the three
// mma.sync products lo.hi + hi.lo + hi.hi (lo.lo is below f32's rounding).
// One pass of TF32 would leave relative errors of about 3e-4. Every 32-row
// stage is summed in a fresh accumulator and then added into the running f32
// sum with an ordinary (round-to-nearest) add, so no long chain of sums
// stays inside the tensor cores' accumulation.
//
// Design:
// - A CTA owns a 128 x 128 tile of dcw (16 warps of 32 x 32: four warps a
//   scheduler to hide the loads and splits behind the other warps' mma)
//   and a range of rows. The N CTAs of a cluster share the tile and split
//   the rows at boundaries fixed by R and N: CTA j takes the 32-row steps
//   [j * steps / N, (j + 1) * steps / N), steps = ceil(R / 32).
// - Rows stream through a ring of kWStages stages of 32 rows of both
//   operands' tile columns, kWStages - 1 steps ahead: 16-byte cp.async
//   copies, zero-filled past R and past D (the ragged edges add zeros),
//   each thread arriving on the stage's full mbarrier when its copies land
//   (noinc); each warp arrives on the stage's empty mbarrier when done with
//   it, and the stage is refilled once all have. The split is done in
//   registers as the fragments are loaded.
// - A stage row is 136 floats (= 8 mod 32). The fragments' rows and
//   columns are permuted against the tile's so that a thread's elements lie
//   side by side: A's rows g and g + 8 are the tile columns 2g and 2g + 1
//   (one 8-byte load), B's column g of its four n-fragments the columns
//   4g .. 4g + 3 (one 16-byte load); a warp's loads hit every bank once.
// - After the last stage each CTA leaves its partial tile in its own shared
//   memory; after a cluster barrier CTA j adds the N partials of its stripe
//   of rows of the tile in CTA order through distributed shared memory and
//   writes dcw once. No atomics, no partials in device memory, the same
//   bits every run.

constexpr int kWThreads = 512;                // 16 warps
constexpr int kWTile = 128;                   // output tile, rows and columns
constexpr int kWStep = 32;                    // rows a ring stage holds
constexpr int kWStages = 4;
constexpr int kWStride = kWTile + 8;          // a stage row, padded (= 8 mod 32)
constexpr int kWStageFloats = 2 * kWStep * kWStride;      // a's rows, then c's
constexpr int kWChunks = 2 * kWStep * kWTile / 4 / kWThreads;  // 16-byte copies a thread
constexpr int kWBarBytes = 128;               // full and empty per stage
constexpr size_t kWSmemBytes = kWBarBytes + (size_t)kWStages * kWStageFloats * sizeof(float);
static_assert(kWTile * kWStride <= kWStages * kWStageFloats, "the partial tile reuses the ring");

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

// an arrival on bar once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__global__ void __launch_bounds__(kWThreads, 1)
wgrad_kernel(const float* __restrict__ a, const float* __restrict__ c, float* __restrict__ dcw,
             int R, int D, int N) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + kWStages;
  float* ring = reinterpret_cast<float*>(smem_raw + kWBarBytes);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rank = (int)cg::this_cluster().block_rank();
  const int tiles_n = (D + kWTile - 1) / kWTile, tile = blockIdx.x / N;
  const int m0 = tile / tiles_n * kWTile, n0 = tile % tiles_n * kWTile;
  const int steps = (R + kWStep - 1) / kWStep;
  const int s_begin = (int)((long long)rank * steps / N);
  const int nsteps = (int)((long long)(rank + 1) * steps / N) - s_begin;
  if (tid < kWStages) {
    mbar_init(&full[tid], kWThreads);      // every thread's cp.async arrival
    mbar_init(&empty[tid], kWThreads / 32);  // every warp's
  }
  mbar_init_fence();
  __syncthreads();

  // Step i of this CTA into its stage: thread tid copies the 16-byte chunks
  // tid + kWThreads * k, k < kWChunks: a's 32 x 128 tile columns, then c's.
  auto issue = [&](int i) {
    float* st = ring + (i % kWStages) * kWStageFloats;
    const int r0 = (s_begin + i) * kWStep;
#pragma unroll
    for (int k = 0; k < kWChunks; ++k) {
      const int chunk = tid + k * kWThreads, which = chunk / (kWStep * kWTile / 4);
      const int row = chunk / (kWTile / 4) % kWStep, col = chunk % (kWTile / 4) * 4;
      const int r = r0 + row, gc = (which ? n0 : m0) + col;
      const bool in = r < R && gc < D;
      const float* src = (which ? c : a) + (in ? (size_t)r * D + gc : 0);
      cp_async16(st + (which * kWStep + row) * kWStride + col, src, in);
    }
    cp_async_arrive(&full[i % kWStages]);
  };

  // warp (wm, wn) owns rows wm * 32 + [0, 32) and columns wn * 32 + [0, 32)
  // of the tile: 2 x 4 fragments of 16 x 8. Fragment x's row r is the tile
  // row wm * 32 + 16 x + (r < 8 ? 2r : 2(r - 8) + 1); fragment y's column q
  // the tile column wn * 32 + 4q + y.
  const int wm = warp / 4, wn = warp % 4, g = lane / 4, t = lane % 4;
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  for (int i = 0; i < kWStages - 1 && i < nsteps; ++i) issue(i);
  for (int i = 0; i < nsteps; ++i) {
    // refill the stage of step i - 1 once every warp is done with it
    const int j = i + kWStages - 1;
    if (j < nsteps) {
      if (j >= kWStages) mbar_wait(&empty[j % kWStages], (uint32_t)((j / kWStages - 1) & 1));
      issue(j);
    }
    mbar_wait(&full[i % kWStages], (uint32_t)((i / kWStages) & 1));
    const float* st = ring + (i % kWStages) * kWStageFloats;
    const float* as = st + wm * 32 + 2 * g;
    const float* bs = st + kWStep * kWStride + wn * 32 + 4 * g;
    float part[2][4][4];
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[x][y][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kWStep; kk += 8) {
      // b0 = (k t, column q = g), b1 = (k t + 4, g) of each n-fragment;
      // a0..a3 = (row g, k t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
      const int k0 = (kk + t) * kWStride, k4 = (kk + t + 4) * kWStride;
      const float4 b0 = ld4(bs + k0), b1 = ld4(bs + k4);
      const float bv[4][2] = {{b0.x, b1.x}, {b0.y, b1.y}, {b0.z, b1.z}, {b0.w, b1.w}};
      float bhi[4][2], blo[4][2];
#pragma unroll
      for (int y = 0; y < 4; ++y)
#pragma unroll
        for (int e = 0; e < 2; ++e) split_tf32(bv[y][e], bhi[y][e], blo[y][e]);
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const float2 a01 = ld2(as + k0 + 16 * x), a23 = ld2(as + k4 + 16 * x);
        const float av[4] = {a01.x, a01.y, a23.x, a23.y};
        float ahi[4], alo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(av[e], ahi[e], alo[e]);
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          mma_tf32(part[x][y], alo, bhi[y]);
          mma_tf32(part[x][y], ahi, blo[y]);
          mma_tf32(part[x][y], ahi, bhi[y]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[i % kWStages]);
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[x][y][e] += part[x][y][e];
  }

  // the partial tile [kWTile, kWStride] over the ring (every copy issued
  // was waited for; the barrier is for the other warps' reads). acc[x][y][e]
  // is the tile's (wm * 32 + 16 x + 2g + e / 2, wn * 32 + 8t + 4 (e % 2) + y).
  __syncthreads();
  float* ct = ring;
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      st4(ct + (wm * 32 + 16 * x + 2 * g + e / 2) * kWStride + wn * 32 + 8 * t + 4 * (e % 2),
          make_float4(acc[x][0][e], acc[x][1][e], acc[x][2][e], acc[x][3][e]));
  cg::this_cluster().sync();
  // CTA rank's stripe of rows, the N partials added in CTA order
  const int stripe = (kWTile + N - 1) / N, lo = rank * stripe;
  const int hi = min(min(kWTile, lo + stripe), D - m0), c4s = min(kWTile, D - n0) / 4;
  for (int e = tid; e < max(0, hi - lo) * (kWTile / 4); e += kWThreads) {
    const int row = lo + e / (kWTile / 4), c4 = e % (kWTile / 4);
    if (c4 >= c4s) continue;
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int q = 0; q < N; ++q) {
      const float4 v = ld4(cg::this_cluster().map_shared_rank(ct, q) + row * kWStride + 4 * c4);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    st4(dcw + (size_t)(m0 + row) * D + n0 + 4 * c4, s);
  }
  cg::this_cluster().sync();  // no CTA leaves while another reads its tile
}

// ---- the other gradients of the layer: part [B, P] summed over the batch ----
//
// What bounds it: reading part once (7.8 MB at TED B = 512, 2.3 us at
// 3.35 TB/s). A CTA owns 32 adjacent columns (a lane each: a warp's loads
// are one 128-byte row segment); warp w of 16 sums the rows [w * per,
// (w + 1) * per), per = ceil(B / 16), eight loads in flight a lane; the
// warps' sums are added in warp order. The same bits every run.
constexpr int kRCols = 32, kRThreads = 512;

__global__ void __launch_bounds__(kRThreads)
reduce_kernel(const float* __restrict__ part, int B, int S, int D, float* ds1, float* db1,
              float* ds2, float* db2, float* dcb, float* dtb, float* dtw) {
  __shared__ float red[kRThreads / 32][kRCols];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, P = part_size(S, D);
  const int q = blockIdx.x * kRCols + lane;
  const int per = (B + kRThreads / 32 - 1) / (kRThreads / 32);
  const int b0 = min(B, warp * per), b1 = min(B, b0 + per);
  float s[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (q < P) {
    const float* col = part + q;
    int b = b0;
    for (; b + 8 <= b1; b += 8)
#pragma unroll
      for (int u = 0; u < 8; ++u) s[u] += __ldg(col + (size_t)(b + u) * P);
    for (; b < b1; ++b) s[0] += __ldg(col + (size_t)b * P);
  }
  red[warp][lane] = ((s[0] + s[1]) + (s[2] + s[3])) + ((s[4] + s[5]) + (s[6] + s[7]));
  __syncthreads();
  if (warp != 0 || q >= P) return;
  float v = 0.0f;
#pragma unroll
  for (int w = 0; w < kRThreads / 32; ++w) v += red[w][lane];
  if (q >= dtw_off(S, D)) {
    dtw[q - dtw_off(S, D)] = v;
  } else if (q >= dtb_off(D)) {
    dtb[q - dtb_off(D)] = v;
  } else {
    float* dst[5] = {ds1, db1, ds2, db2, dcb};
    dst[q / D][q % D] = v;
  }
}

bool train_act_ok(int act) { return act == kSilu || act == kRelu || (act >= kLrelu && act <= kLrelu02); }

using BwdKernel = void (*)(const BwdParams);

BwdKernel bwd_kernel_for(int act) {
  switch (act) {
    case kSilu: return bwd_block_kernel<kSilu>;
    case kRelu: return bwd_block_kernel<kRelu>;
    case kLrelu: return bwd_block_kernel<kLrelu>;
    case kLrelu01: return bwd_block_kernel<kLrelu01>;
    default: return bwd_block_kernel<kLrelu02>;
  }
}

}  // namespace

// Each launch function enqueues on `stream` and returns the cudaError_t of
// its attribute call or launch (0 on success).

// Dynamic shared memory of one CTA of the block kernel, or 0 for a geometry
// it refuses.
extern "C" long long fused_transmlp_train_bwd_smem_bytes(int D, int cluster) {
  return cluster_ok(D, cluster) ? (long long)BwdSmem(D, cluster).bytes() : 0;
}

// Clusters of `cluster` CTAs of the block kernel at width D the current
// card holds at once (cudaOccupancyMaxActiveClusters), or minus the
// cudaError_t.
extern "C" int fused_transmlp_train_bwd_max_clusters(int D, int cluster) {
  if (!cluster_ok(D, cluster)) return -(int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  cluster_launch_config(&cfg, attr, cluster, cluster, BwdSmem(D, cluster).bytes());
  const BwdKernel kernel = bwd_kernel_for(kSilu);  // every instance takes the same resources
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)cfg.dynamicSmemBytes);
  int n = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// Step 1 of one layer's backward, as B clusters of `cluster` CTAs. Weight
// pointers are this layer's (cw_t: ch_w transposed); h2 and gm2 are
// [B, S, D] each and part is [B, 5D + S + S*S].
extern "C" int fused_transmlp_train_bwd_block_launch(
    const float* stash, const float* emb, const float* g_in, float* g_out, float* gemb,
    int first, const float* ln1_s, const float* ln1_b, const float* tw, const float* tb,
    const float* ln2_s, const float* ln2_b, const float* cw, const float* cw_t,
    const float* cb, float* h2, float* gm2, float* part, int B, int S, int D, int act,
    int cluster, void* stream
#ifdef K2_PHASES
    , long long* prof
#endif
) {
  if (B < 0 || S < 1 || S > kSPad || !cluster_ok(D, cluster) || !train_act_ok(act))
    return (int)cudaErrorInvalidValue;
  for (const void* q : {(const void*)stash, (const void*)emb, (const void*)g_in,
                        (const void*)g_out, (const void*)ln1_s, (const void*)ln1_b,
                        (const void*)ln2_s, (const void*)ln2_b, (const void*)cw,
                        (const void*)cw_t, (const void*)cb, (const void*)h2, (const void*)gm2})
    if (q == nullptr || !aligned16(q)) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  cluster_launch_config(&cfg, attr, B, cluster, BwdSmem(D, cluster).bytes());
  const BwdKernel kernel = bwd_kernel_for(act);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)cfg.dynamicSmemBytes);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return 0;
  cfg.stream = (cudaStream_t)stream;
  BwdParams p{{}, {}, stash, emb, g_in, g_out, gemb, ln1_s, ln1_b, tw, tb, ln2_s, ln2_b, cb,
              h2, gm2, part, nullptr, first, S, D, cluster};
#ifdef K2_PHASES
  p.prof = prof;
#endif
  if (!weight_map(&p.cw_map, cw, D, D, D / cluster, kBKt) ||
      !weight_map(&p.cwt_map, cw_t, D, D, D / cluster, kBKt))
    return (int)cudaErrorInvalidValue;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Clusters of `cluster` CTAs of the weight-gradient kernel the current card
// holds at once (cudaOccupancyMaxActiveClusters), or minus the cudaError_t.
extern "C" int fused_transmlp_train_wgrad_max_clusters(int cluster) {
  if (cluster < 1 || cluster > kMaxCluster) return -(int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  cluster_launch_config(&cfg, attr, 1, cluster, kWSmemBytes);
  cfg.blockDim = dim3(kWThreads, 1, 1);
  cudaError_t err = cudaFuncSetAttribute(wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kWSmemBytes);
  int n = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&n, wgrad_kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// Step 2: dcw [D, D] = h2^T gm2 over the R rows of h2, gm2 [R, D], as
// ceil(D / 128)^2 clusters of `cluster` CTAs that split the rows.
extern "C" int fused_transmlp_train_wgrad_launch(const float* h2, const float* gm2, float* dcw,
                                                 int R, int D, int cluster, void* stream) {
  if (R < 1 || D < kKTile || D > kMaxN || D % kKTile != 0 || cluster < 1 ||
      cluster > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  for (const void* q : {(const void*)h2, (const void*)gm2, (const void*)dcw})
    if (q == nullptr || !aligned16(q)) return (int)cudaErrorInvalidValue;
  const int tiles = (D + kWTile - 1) / kWTile;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  cluster_launch_config(&cfg, attr, tiles * tiles, cluster, kWSmemBytes);
  cfg.blockDim = dim3(kWThreads, 1, 1);
  cudaError_t err = cudaFuncSetAttribute(wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kWSmemBytes);
  if (err != cudaSuccess) return (int)err;
  cfg.stream = (cudaStream_t)stream;
  err = cudaLaunchKernelEx(&cfg, wgrad_kernel, h2, gm2, dcw, R, D, cluster);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Step 3: this layer's other gradients, part [B, 5D + S + S*S] summed over B,
// in the order of part's row.
extern "C" int fused_transmlp_train_reduce_launch(
    const float* part, int B, int S, int D, float* ds1, float* db1, float* ds2, float* db2,
    float* dcb, float* dtb, float* dtw, void* stream) {
  if (B < 1 || S < 1 || S > kSPad || D < kKTile || D > kMaxN || D % kKTile != 0)
    return (int)cudaErrorInvalidValue;
  for (const void* q : {(const void*)part, (const void*)ds1, (const void*)db1, (const void*)ds2,
                        (const void*)db2, (const void*)dcb, (const void*)dtb, (const void*)dtw})
    if (q == nullptr) return (int)cudaErrorInvalidValue;
  const int ctas = (part_size(S, D) + kRCols - 1) / kRCols;
  reduce_kernel<<<ctas, kRThreads, 0, (cudaStream_t)stream>>>(part, B, S, D, ds1, db1, ds2, db2,
                                                              dcb, dtb, dtw);
  return (int)cudaGetLastError();
}
