// Device code shared by the fused TransMLP stack (fused_transmlp.cu: the
// sampling forward and the training forward with its stash) and the
// training backward (fused_transmlp_train.cu). Both spread one [S, D]
// sequence over a thread-block cluster of N CTAs of kT threads, CTA r owning
// the columns [r * D/N, (r + 1) * D/N). What is here:
// - the limits (S <= kSPad = 36, D <= kMaxN = 512), the activations and
//   their derivatives;
// - the 2-D TMA copy (shared-memory addresses, cp.async, the mbarriers,
//   the 1-D bulk copy and the TF32 helpers are in tf32_mma.cuh), and the
//   encoder of a 2-D tensor map over a row-major weight matrix;
// - the [kSPad, K] x [K, ncols] product in 9 x 8 register tiles whose
//   threads form K-slices (Tiling, SliceRows, mma_quads), the slices'
//   warp-level arrival on an mbarrier, and the fixed-order sum of the
//   slices' partial tiles through shared memory (reduce_slices);
// - the LayerNorm row statistics across the cluster (two-pass per CTA, one
//   exchange through distributed shared memory, Chan's combine); the
//   cluster barrier's halves and the launch configuration are in
//   cluster.cuh.
//
// Rows S..kSPad-1 of every shared tile only ever feed rows that are not
// written back.

#pragma once

#include <cuda.h>  // CUtensorMap; the encoder is reached through the runtime
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "cluster.cuh"  // the cluster barrier halves, cluster_launch_config
#include "tf32_mma.cuh"  // smem_addr, cp.async, the 3xTF32 mma.sync

namespace {

constexpr int kT = 256;                               // threads of a CTA: 8 warps
constexpr int kThreads = kT;
constexpr int kRowGroups = 4;                         // thread rows of a product tile
constexpr int kRowsPerThread = 9;
constexpr int kSPad = kRowGroups * kRowsPerThread;    // 36: largest S
constexpr int kMaxN = 512;                            // largest D and F
constexpr int kKTile = 16;                            // D is a multiple of this
constexpr float kEps = 1e-5f;

constexpr int kMaxCluster = 8;             // the portable cluster size
constexpr int kMaxCols = 128;              // Dc: columns of the activation per CTA
constexpr int kSlicesMax = 8;              // K-slices of a product
constexpr int kTileRows = kRowsPerThread;  // 9 rows of a thread's product tile,
constexpr int kTileCols = 8;               // 8 columns
constexpr int kTileFloats = kTileRows * kTileCols;
constexpr int kRedStride = kTileFloats + 4;   // a thread's partial tile, padded: the
                                              // float4 reads of 8 lanes miss each other
constexpr int kRedFloats = kT * kRedStride;   // the K-slices' partial tiles

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

// Row stride of a ring stage: Dc padded to whole register tiles. The
// padding columns hold the next CTA's columns (or zeros past D); they only
// feed outputs that are not kept.
__host__ __device__ inline int ring_stride(int dc) {
  return (dc + kTileCols - 1) / kTileCols * kTileCols;
}

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


// A product [kSPad, K] x [K, ncols] over the CTA's threads, ncols a multiple
// of 8, at most kMaxCols. Thread p of a K-slice's 4 * ncols / 8 owns rows
// rg * 9 .. rg * 9 + 8 (rg = p % 4) and the columns col .. col + 3 and
// half + col .. half + col + 3 (col = 4 * (p / 4), half = ncols / 2); the
// ns <= 8 K-slices split K. Threads past ns slices idle.
struct Tiling {
  int per, ns, slice, p, rg, col, half;
  bool active;
  __device__ explicit Tiling(int ncols) {
    per = kRowGroups * (ncols / kTileCols);
    ns = min(kSlicesMax, kT / per);
    slice = threadIdx.x / per;
    p = threadIdx.x % per;
    rg = p % kRowGroups;
    col = (p / kRowGroups) * 4;
    half = ncols / 2;
    active = threadIdx.x < ns * per;
  }
};

__device__ __forceinline__ void zero(float (&acc)[kTileRows][kTileCols]) {
#pragma unroll
  for (int i = 0; i < kTileRows; ++i)
#pragma unroll
    for (int j = 0; j < kTileCols; ++j) acc[i][j] = 0.0f;
}

__device__ __forceinline__ void load_w(float4 (&lo)[4], float4 (&hi)[4], const float* wq,
                                       int wstride, int half) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    lo[r] = *reinterpret_cast<const float4*>(wq + r * wstride);
    hi[r] = *reinterpret_cast<const float4*>(wq + r * wstride + half);
  }
}

__device__ __forceinline__ void fma_row(float (&acc)[kTileCols], float4 av, const float4 (&lo)[4],
                                        const float4 (&hi)[4]) {
  const float a[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    acc[0] = fmaf(a[r], lo[r].x, acc[0]);
    acc[1] = fmaf(a[r], lo[r].y, acc[1]);
    acc[2] = fmaf(a[r], lo[r].z, acc[2]);
    acc[3] = fmaf(a[r], lo[r].w, acc[3]);
    acc[4] = fmaf(a[r], hi[r].x, acc[4]);
    acc[5] = fmaf(a[r], hi[r].y, acc[5]);
    acc[6] = fmaf(a[r], hi[r].z, acc[6]);
    acc[7] = fmaf(a[r], hi[r].w, acc[7]);
  }
}

// One quad of K rows: acc += a_rows[:, k .. k+3] x (lo | hi), with the
// next quad's weight rows read into (nlo | nhi) meanwhile, one float4 after
// each of the first eight rows' FMAs, and each row of the left operand read
// one row ahead: the shared-memory reads spread over the FMA stream instead
// of stalling every warp at the top of the quad.
__device__ __forceinline__ void quad_step(float (&acc)[kTileRows][kTileCols], const float* ak,
                                          int dp, const float4 (&lo)[4], const float4 (&hi)[4],
                                          float4 (&nlo)[4], float4 (&nhi)[4], const float* wn,
                                          int wstride, int half) {
  float4 av = *reinterpret_cast<const float4*>(ak);
#pragma unroll
  for (int i = 0; i < kTileRows; ++i) {
    float4 an = av;
    if (i + 1 < kTileRows) an = *reinterpret_cast<const float4*>(ak + (i + 1) * dp);
    fma_row(acc[i], av, lo, hi);
    if (i < 4) nlo[i] = *reinterpret_cast<const float4*>(wn + i * wstride);
    else if (i < 8) nhi[i - 4] = *reinterpret_cast<const float4*>(wn + (i - 4) * wstride + half);
    av = an;
  }
}

// acc += a_rows[:, kbase + 4q .. +3] x w[4q .. 4q+3, {0..3, half..half+3}]
// over the quads q = q0, q0 + step, ... < nq: per quad 8 + 9 float4 reads,
// 288 FMAs. Two register buffers of weight rows take turns; the read past
// the last quad re-reads it (nothing is left out of bounds or branched on).
__device__ __forceinline__ void mma_quads(float (&acc)[kTileRows][kTileCols], const float* a_rows,
                                          int dp, const float* w, int wstride, int half,
                                          int kbase, int q0, int nq, int step) {
  if (q0 >= nq) return;
  const int last = q0 + (nq - 1 - q0) / step * step;
  float4 lo[4], hi[4], lo2[4], hi2[4];
  load_w(lo, hi, w + 4 * q0 * wstride, wstride, half);
  for (int q = q0;;) {
    int qn = min(q + step, last);
    quad_step(acc, a_rows + kbase + 4 * q, dp, lo, hi, lo2, hi2, w + 4 * qn * wstride, wstride,
              half);
    q += step;
    if (q >= nq) break;
    qn = min(q + step, last);
    quad_step(acc, a_rows + kbase + 4 * q, dp, lo2, hi2, lo, hi, w + 4 * qn * wstride, wstride,
              half);
    q += step;
    if (q >= nq) break;
  }
}

// Sums the K-slices' tiles through red (kRedFloats; thread t's tile at
// red + t * kRedStride, row i's eight columns at + 8i) in slice order, four
// columns at a time, and calls out(row, col, sums of col .. col + 3) for
// each output row < S. Every thread calls it after the last product; red
// may be what the product read: the first barrier is for that.
template <class Out>
__device__ __forceinline__ void reduce_slices(const Tiling& t,
                                              const float (&acc)[kTileRows][kTileCols],
                                              float* red, int S, Out out) {
  __syncthreads();
  if (t.active) {
    float4* mine = reinterpret_cast<float4*>(red + threadIdx.x * kRedStride);
#pragma unroll
    for (int i = 0; i < kTileRows; ++i) {
      mine[2 * i] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      mine[2 * i + 1] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
  __syncthreads();
  // e runs over (tile position p, quad q): row i = q / 2 of p's tile, half q % 2
  for (int e = threadIdx.x; e < t.per * 2 * kTileRows; e += kT) {
    const int p = e % t.per, q = e / t.per;
    const int row = (p % kRowGroups) * kTileRows + q / 2;
    if (row >= S) continue;
    const float* src = red + p * kRedStride + 4 * q;
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int k = 0; k < t.ns; ++k) {
      const float4 v = *reinterpret_cast<const float4*>(src + k * t.per * kRedStride);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    out(row, (q % 2 ? t.half : 0) + (p / kRowGroups) * 4, s);
  }
}

// K-slice s of a product over K = D rows of a weight matrix takes the rows
// [s * rps, (s + 1) * rps), rps = D / ns rounded up to whole K-tiles of kt
// rows, as `tiles` K-tiles (fewer for the last slices when D is not a
// multiple of ns K-tiles).
struct SliceRows {
  int k0, tiles;
  __device__ SliceRows(const Tiling& t, int D, int kt) {
    const int rps = (D + kt * t.ns - 1) / (kt * t.ns) * kt;
    k0 = t.slice * rps;
    tiles = max(0, min(rps, D - k0)) / kt;
  }
};

// The threads of K-slice t.slice in this warp arrive on `bar` as one: the
// slice's first lane in the warp, once they all have passed here.
__device__ __forceinline__ void arrive_slice(const Tiling& t, uint64_t* bar) {
  const int lane = threadIdx.x % 32, base = threadIdx.x - lane;
  const int lo = max(t.slice * t.per, base), hi = min((t.slice + 1) * t.per, base + 32);
  const unsigned mask = (hi - lo == 32 ? 0xffffffffu : ((1u << (hi - lo)) - 1)) << (lo - base);
  __syncwarp(mask);
  if ((int)threadIdx.x == lo)
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
                 "r"(hi - lo)
                 : "memory");
}

// Row statistics of src [kSPad, dc] (rows < S) over the whole D columns of
// the cluster, into mean_s / inv_s: eight lanes a row take the local
// two-pass (mean, M2), lane j of the eight pushes it to CTA j's st (slot
// `rank` of [kMaxCluster, kSPad, 2]); after one cluster barrier each CTA
// combines the N pairs (Chan).
__device__ __forceinline__ void cluster_row_stats(const float* src, int S, int N, int D, int dc,
                                                  int rank, float* st, float* mean_s,
                                                  float* inv_s) {
  const int sub = threadIdx.x % 8;
  for (int r = threadIdx.x / 8; r < (kSPad + kT / 8 - 1) / (kT / 8) * (kT / 8); r += kT / 8) {
    const float* row = src + min(r, kSPad - 1) * dc;
    float s = 0.0f;
    for (int k = sub; k < dc; k += 8) s += row[k];
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mean = s / dc;
    float v = 0.0f;
    for (int k = sub; k < dc; k += 8) {
      const float d = row[k] - mean;
      v += d * d;
    }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (r < S && sub < N) {
      float* dst = cg::this_cluster().map_shared_rank(st, sub);
      *reinterpret_cast<float2*>(dst + (rank * kSPad + r) * 2) = make_float2(mean, v);
    }
  }
  cg::this_cluster().sync();
  if (threadIdx.x < S) {
    const float* pr = st + threadIdx.x * 2;  // rank j: + j * kSPad * 2
    float m = 0.0f;
    for (int j = 0; j < N; ++j) m += pr[j * kSPad * 2];
    m /= N;
    float m2 = 0.0f, spread = 0.0f;
    for (int j = 0; j < N; ++j) {
      const float d = pr[j * kSPad * 2] - m;
      m2 += pr[j * kSPad * 2 + 1];
      spread += d * d;
    }
    m2 += dc * spread;
    mean_s[threadIdx.x] = m;
    inv_s[threadIdx.x] = 1.0f / sqrtf(m2 / D + kEps);
  }
  __syncthreads();
}

// the 16-byte copies read these at 16-byte offsets (null: unused)
inline bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

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

// A row-major f32 [rows, D] weight matrix as the 2-D map a ring's TMA
// copies read, in boxes of [box_rows, ring_stride(dc)].
inline bool weight_map(CUtensorMap* map, const float* w, long long rows, int D, int dc,
                       int box_rows) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)ring_stride(dc), (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(w), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The cluster sizes a kernel takes at width D: N in {1, 2, 4, 8}, Dc = D/N
// a whole number of 16-byte loads and at most kMaxCols.
inline bool cluster_ok(int D, int N) {
  return D >= kKTile && D <= kMaxN && D % kKTile == 0 &&
         (N == 1 || N == 2 || N == 4 || N == 8) && D % (4 * N) == 0 && D / N <= kMaxCols;
}

}  // namespace
