// Grouped SwiGLU for NVIDIA Hopper (sm_90a), f32 in and out: every
// feed-forward product of the language-model text tower
// (models/moe_text.py), the routed experts of a layer as G groups of rows,
// the shared experts and the dense layer's SwiGLU as one group each.
//
// Replaces no TPU kernel: the JAX package has no language-model tower. It
// was added because the tower's experts ran as three cuBLAS f32 products
// an expert (64 experts x 26 layers), on the FP32 pipe and not the tensor
// cores, after a wait for the experts' sizes in every layer.
//
// Two kernels, each a persistent grid over (group, row tile, column tile):
//   gate-up:  h[p] = silu(x[p] Wg[g]^T) * (x[p] Wu[g]^T)      [P, N]
//   down:     out[dest[p]] = scale[dest[p]] * (h[p] Wd[g]^T)  [*, D]
// for the rows p of group g, which are rows [offsets[g], offsets[g + 1]) of
// x (sorted by group). The weights are the stacked packs as the model holds
// them, [G, N, K] for the gate and up projections and [G, D, N] for the
// down projection: K-major, read in place. The offsets stay on the card and
// each CTA reads them itself, so the host enqueues a routed layer without
// learning the groups' sizes. The down kernel writes each row to its
// destination (a routed row's (token, slot) place) scaled by its routing
// weight; the caller adds a token's k rows in a fixed order. No atomics:
// the same inputs give the same bits on every run.
//
// The arithmetic contract: f32 in, f32 out. The products run on the tensor
// cores in 3xTF32: each operand is split x = hi + lo (tf32_mma.cuh:
// split_tf32) and every k8 step runs lo.hi + hi.lo + hi.hi. Each stage of
// 32 k is summed in a fresh accumulator that is then added into the
// running f32 sum with an ordinary add (the tensor cores truncate their
// sums). The SwiGLU and the scaling are f32 on the CUDA cores.
//
// What bounds it on an H100 SXM (700 W): at the Moonlight cell's routed
// layer (P ~ 41.4k rows over 64 experts, K = 2,048, N = 1,408) the three
// products are 0.72 TFLOP; three TF32 passes take 4.3 ms at 495 TFLOP/s.
// The expert weights are 2.2 GB, 0.66 ms at 3.35 TB/s if each weight tile
// is read from device memory once. A tile's weight slice serves its ~5
// row tiles (about 650 rows an expert): some 325 FLOP a byte, so the
// products bound it, and the stages' shared-memory traffic (the weights'
// split besides wgmma's reads) comes next.
//
// The design, and what it does about that:
// - A tile is 128 rows x 128 wgmma columns: two consumer warpgroups take
//   64 rows each (m64n128k8). For gate-up the 128 columns are 64 gate and
//   the same 64 up columns, so the SwiGLU runs on a thread's registers and
//   only h is written; for down they are 128 output columns.
// - A, the rows, comes from registers: each thread loads its fragment from
//   the stage (TMA, 128-byte swizzle: conflict-free) and splits it. B, the
//   weights, is read by wgmma from shared memory, so it is split there: the
//   TMA box lands raw, and three warps of the producer warpgroup write its
//   hi half in place and its lo half beside it, then release the stage to
//   the consumers. The weights are never split or repacked in memory.
// - A producer warp issues the TMA boxes of a ring of 4 stages (32 k each:
//   the rows' box and one or two weight boxes) as soon as the consumers
//   release a stage; the ring runs on across tiles, so the next tile's
//   loads overlap a tile's epilogue. The producer warpgroup gives its
//   registers to the consumers (setmaxnreg).
// - A consumer warpgroup loads and splits the next stage's fragment while
//   the current stage's wgmma run, and reads the accumulator only after
//   they are done (ptxas serialises every wgmma of a function that reads an
//   accumulator with a group in flight); the other warpgroup's wgmma fill
//   the tensor cores meanwhile.
// - The walk: groups in order; inside a group, bands of up to 8 row tiles;
//   inside a band, column tiles outer and row tiles inner. Consecutive
//   tiles, which run at once on neighbouring CTAs, share one weight slice,
//   so each weight tile is read from device memory about once a layer, and
//   a band's rows (at most 8 MB) stay in L2 across its column tiles. A
//   group of more rows (the shared and dense groups: every token) is walked
//   band by band, so its rows are not streamed from memory once a column.
//
// Limits: 1 <= G <= 256 (offsets null: one group of all rows); at least
// one row (a success is always a launch); K a multiple of 32; N a
// multiple of 64 (gate-up) and D of 128 (down); every pointer 16-byte
// aligned. Anything else returns cudaErrorInvalidValue, and a refused
// launch returns its own error; the wrapper raises on either.

#include "tma.cuh"       // the tensor-map encoder, the 2-D TMA copy
#include "tf32_mma.cuh"  // smem_addr, the mbarriers, split_tf32, fence_proxy_async
#include "wgmma.cuh"     // descriptors, fences, commit and wait

namespace {

constexpr int kBM = 128;                 // rows of a tile: two warpgroups of 64
constexpr int kBN = 128;                 // wgmma's N: the columns of a tile
constexpr int kGateCols = kBN / 2;       // output columns of a gate-up tile
constexpr int kChunk = 32;               // k of a stage: one 128-byte swizzled row of f32
constexpr int kStages = 4;
constexpr int kBand = 8;                 // row tiles of a band
constexpr int kMaxGroups = 256;
constexpr int kThreads = 384;            // two consumer warpgroups, then the producer's
constexpr int kSplitters = 3;            // producer warps that split the weights
constexpr int kAcc = 64;                 // accumulators of an m64n128 tile, a thread
constexpr int kFrag = 16;                // a thread's A fragment of one stage
constexpr int kTileBytes = kBM * 128;    // the rows' box, and the weights' (kBN rows)
constexpr int kStageBytes = 3 * kTileBytes;  // rows, weights hi (landed raw), weights lo
// the dynamic shared memory from a 1024-aligned base: the stages, the
// groups' offsets, their first tiles, then the stages' mbarriers
constexpr size_t kOffsAt = (size_t)kStages * kStageBytes;
constexpr size_t kTilesAt = kOffsAt + 8 * (kMaxGroups + 1);
constexpr size_t kBarsAt = (kTilesAt + 4 * (kMaxGroups + 1) + 7) / 8 * 8;
constexpr size_t kSmemBytes = 1024 + kBarsAt + 3 * kStages * 8;

enum Mode { kGateUp = 0, kDown = 1 };

struct Params {
  CUtensorMap a_map;         // the rows [rows, K], boxes [32 k, 128 rows]
  CUtensorMap b_map;         // gate (or down) weights [G * Nw, K], boxes [32, 64 (128)]
  CUtensorMap u_map;         // up weights [G * Nw, K], boxes [32, 64]; gate-up only
  const long long* offsets;  // [G + 1], or null: one group of `rows` rows
  const long long* dest;     // down: row p's output row, or null (row p)
  const float* scale;        // down: an output row's scale, indexed by dest, or null
  float* out;                // [*, Nw]: h (gate-up) or out (down)
  long long rows;
  int G, K, Nw;              // groups, depth, a group's weight rows (N, or D for down)
};

// The walk (see the head of the file), from the groups' offsets in shared
// memory: tiles[g] is the first tile of group g, tiles[G] the number.
struct Walk {
  const long long* offs;
  const int* tiles;
  int G, cols;  // column tiles a group
  __device__ int total() const { return tiles[G]; }
};

struct Tile {
  long long row0, row_end;  // the tile's first row, its group's end
  int g, col;               // group, column tile
};

__device__ __forceinline__ Tile decode(const Walk& w, int t) {
  int lo = 0, hi = w.G;  // the last group whose first tile is <= t (never an empty one)
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (w.tiles[mid] <= t) lo = mid; else hi = mid;
  }
  const int g = lo, local = t - w.tiles[g];
  const long long n = w.offs[g + 1] - w.offs[g];
  const int rt = (int)((n + kBM - 1) / kBM), band = local / (kBand * w.cols);
  const int within = local - band * kBand * w.cols, rb = min(kBand, rt - band * kBand);
  Tile tile;
  tile.g = g;
  tile.col = within / rb;
  tile.row0 = w.offs[g] + (long long)(band * kBand + within % rb) * kBM;
  tile.row_end = w.offs[g + 1];
  return tile;
}

// Byte offset of element k of row `row` in a stage's 128-byte swizzled box:
// the row's 128 bytes, whose 16-byte chunks the swizzle permutes by the
// row's index mod 8.
__device__ __forceinline__ uint32_t sw_offset(int row, int k) {
  return (uint32_t)(row * 128 + ((((k >> 2) ^ (row & 7))) << 4) + ((k & 3) << 2));
}

// d (+)= A[64, 8] . B[128, 8]^T in TF32 with f32 sums: A this thread's four
// fragment registers (rows g, g + 8 at k q, then at k q + 4), B K-major in
// shared memory; scale_d = 0 starts from zero.
__device__ __forceinline__ void wgmma_tf32(float (&d)[kAcc], const uint32_t* a, uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// A stage's fragment (four k8 steps of four values), split into TF32 halves.
struct Frag {
  uint32_t hi[kFrag], lo[kFrag];
};

// keeps a fragment's registers alive (and unmoved) until here: the wgmma
// that read them run asynchronously until their wait
__device__ __forceinline__ void fence_frag(Frag& f) {
#pragma unroll
  for (int i = 0; i < kFrag; ++i) asm volatile("" : "+r"(f.hi[i]), "+r"(f.lo[i])::"memory");
}

struct Ring {
  unsigned char* base;  // stage s at base + s * kStageBytes: rows, weights hi, weights lo
  uint64_t *full, *ready, *empty;
};

__device__ __forceinline__ unsigned char* stage(const Ring& r, int s) {
  return r.base + (size_t)s * kStageBytes;
}

// This consumer thread's fragment of ring chunk u: its rows r0 and r0 + 8
// of the stage's rows, k q and q + 4 of each k8 step, split.
__device__ __forceinline__ void load_frag(const Ring& r, int u, int r0, Frag& f) {
  const int s = u % kStages;
  const uint32_t parity = (uint32_t)((u / kStages) & 1);
  mbar_wait(&r.full[s], parity);   // the rows' box has landed
  mbar_wait(&r.ready[s], parity);  // the weights are split
  const unsigned char* a = stage(r, s);
  const int q = threadIdx.x % 4;
#pragma unroll
  for (int kk = 0; kk < kChunk / 8; ++kk) {
    float v[4];
    v[0] = *reinterpret_cast<const float*>(a + sw_offset(r0, 8 * kk + q));
    v[1] = *reinterpret_cast<const float*>(a + sw_offset(r0 + 8, 8 * kk + q));
    v[2] = *reinterpret_cast<const float*>(a + sw_offset(r0, 8 * kk + q + 4));
    v[3] = *reinterpret_cast<const float*>(a + sw_offset(r0 + 8, 8 * kk + q + 4));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float hi, lo;
      split_tf32(v[i], hi, lo);
      f.hi[4 * kk + i] = __float_as_uint(hi);
      f.lo[4 * kk + i] = __float_as_uint(lo);
    }
  }
}

// The wgmma of ring chunk u (fragment f), committed as one group: for each
// of its four k8 steps, lo.hi + hi.lo + hi.hi into d, from zero.
__device__ __forceinline__ void chunk_mma(const Ring& r, float (&d)[kAcc], Frag& f, int u) {
  fence_frag(f);  // the split is done before the fence, not sunk past it
  __syncwarp();
  wgmma_fence();
  const uint32_t bh = smem_addr(stage(r, u % kStages) + kTileBytes), bl = bh + kTileBytes;
#pragma unroll
  for (int kk = 0; kk < kChunk / 8; ++kk) {
    wgmma_tf32(d, f.lo + 4 * kk, sw128_desc(bh + 32 * kk), kk == 0 ? 0 : 1);
    wgmma_tf32(d, f.hi + 4 * kk, sw128_desc(bl + 32 * kk), 1);
    wgmma_tf32(d, f.hi + 4 * kk, sw128_desc(bh + 32 * kk), 1);
  }
  wgmma_commit();
}

// Waits for chunk u's wgmma, adds its sum into run and releases its stage:
// one arrival a consuming warp.
__device__ __forceinline__ void chunk_done(const Ring& r, float (&run)[kAcc], float (&d)[kAcc],
                                           Frag& f, int u) {
  wgmma_wait<0>();
  fence_acc(d);
  fence_frag(f);
#pragma unroll
  for (int i = 0; i < kAcc; ++i) run[i] += d[i];
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(&r.empty[u % kStages]);
}

// run = this warpgroup's 64 rows of the tile times its 128 weight rows over
// the n chunks from ring chunk u0. Each chunk is summed in a fresh
// accumulator, then added into run; the next chunk's fragment is loaded and
// split while a chunk's wgmma run.
__device__ __forceinline__ void product(const Ring& r, int u0, int n, int r0, float (&run)[kAcc]) {
  float d[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) run[i] = d[i] = 0.0f;
  Frag fa, fb;
  load_frag(r, u0, r0, fa);
  for (int j = 0;; j += 2) {
    chunk_mma(r, d, fa, u0 + j);
    if (j + 1 < n) load_frag(r, u0 + j + 1, r0, fb);
    chunk_done(r, run, d, fa, u0 + j);
    if (j + 1 >= n) break;
    chunk_mma(r, d, fb, u0 + j + 1);
    if (j + 2 < n) load_frag(r, u0 + j + 2, r0, fa);
    chunk_done(r, run, d, fb, u0 + j + 1);
    if (j + 2 >= n) break;
  }
}

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

// Writes this thread's rows of the tile. The accumulator pairs: run[4j + 2h
// + {0, 1}] is row r0 + 8h (of the tile), columns 8j + 2q + {0, 1}.
template <int kMode>
__device__ __forceinline__ void epilogue(const Params& p, const Tile& t, int r0,
                                         const float (&run)[kAcc]) {
  const int q = threadIdx.x % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = t.row0 + r0 + 8 * h;
    if (row >= t.row_end) continue;
    if (kMode == kGateUp) {
      float* o = p.out + (size_t)row * p.Nw + t.col * kGateCols + 2 * q;
#pragma unroll
      for (int j = 0; j < kBN / 16; ++j) {  // gate columns j, up columns j + 8
        const float* g = run + 4 * j + 2 * h;
        const float* u = run + 4 * (j + kBN / 16) + 2 * h;
        *reinterpret_cast<float2*>(o + 8 * j) = make_float2(silu(g[0]) * u[0], silu(g[1]) * u[1]);
      }
    } else {
      const long long dst = p.dest != nullptr ? p.dest[row] : row;
      const float sc = p.scale != nullptr ? p.scale[dst] : 1.0f;
      float* o = p.out + (size_t)dst * p.Nw + t.col * kBN + 2 * q;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const float* v = run + 4 * j + 2 * h;
        *reinterpret_cast<float2*>(o + 8 * j) = make_float2(sc * v[0], sc * v[1]);
      }
    }
  }
}

// The producer's copy thread: ring chunk u (chunk j of tile t) into its
// stage once the consumers have released the chunk a ring before it.
template <int kMode>
__device__ __forceinline__ void issue(const Params& p, const Ring& r, const Tile& t, int j, int u) {
  const int s = u % kStages;
  if (u >= kStages) mbar_wait(&r.empty[s], (uint32_t)((u / kStages - 1) & 1));
  fence_proxy_async();  // the consumers' and splitters' generic reads of the stage first
  unsigned char* st = stage(r, s);
  mbar_expect_tx(&r.full[s], 2 * kTileBytes);
  tma_load_2d(reinterpret_cast<float*>(st), &p.a_map, j * kChunk, (int)t.row0, &r.full[s]);
  float* b = reinterpret_cast<float*>(st + kTileBytes);
  if (kMode == kGateUp) {
    const int y = t.g * p.Nw + t.col * kGateCols;
    tma_load_2d(b, &p.b_map, j * kChunk, y, &r.full[s]);
    tma_load_2d(b + kGateCols * kChunk, &p.u_map, j * kChunk, y, &r.full[s]);
  } else {
    tma_load_2d(b, &p.b_map, j * kChunk, t.g * p.Nw + t.col * kBN, &r.full[s]);
  }
}

// A splitting thread (one of kSplitters warps): ring chunk u's weights,
// landed raw in the hi half, split into hi in place and lo beside it; then
// the proxy fence the wgmma reads need, and one arrival a warp.
__device__ __forceinline__ void split_stage(const Ring& r, int u, int lane) {
  const int s = u % kStages;
  mbar_wait(&r.full[s], (uint32_t)((u / kStages) & 1));
  float4* hi = reinterpret_cast<float4*>(stage(r, s) + kTileBytes);
  float4* lo = reinterpret_cast<float4*>(stage(r, s) + 2 * kTileBytes);
  for (int i = lane; i < kTileBytes / 16; i += 32 * kSplitters) {
    const float4 v = hi[i];
    float4 h, l;
    split_tf32(v.x, h.x, l.x);
    split_tf32(v.y, h.y, l.y);
    split_tf32(v.z, h.z, l.z);
    split_tf32(v.w, h.w, l.w);
    hi[i] = h;
    lo[i] = l;
  }
  fence_proxy_async();
  __syncwarp();
  if (lane % 32 == 0) mbar_arrive(&r.ready[s]);
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 1) grouped_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw_a = smem_addr(smem_raw);
  unsigned char* base = smem_raw + ((1024 - raw_a % 1024) % 1024);
  Ring r;
  r.base = base;
  long long* offs = reinterpret_cast<long long*>(base + kOffsAt);
  int* tiles = reinterpret_cast<int*>(base + kTilesAt);
  r.full = reinterpret_cast<uint64_t*>(base + kBarsAt);
  r.ready = r.full + kStages;
  r.empty = r.ready + kStages;
  const int tid = threadIdx.x;
  const int cols = kMode == kGateUp ? p.Nw / kGateCols : p.Nw / kBN;

  if (tid < kStages) {
    mbar_init(&r.full[tid], 1);               // the copy thread's expect_tx
    mbar_init(&r.ready[tid], kSplitters);     // a splitting warp each
    mbar_init(&r.empty[tid], 8);              // a consuming warp each
  }
  for (int g = tid; g <= p.G; g += kThreads)
    offs[g] = p.offsets != nullptr ? p.offsets[g] : (g == 0 ? 0 : p.rows);
  mbar_init_fence();
  __syncthreads();
  if (tid == 0) {  // each group's first tile
    int acc = 0;
    for (int g = 0; g < p.G; ++g) {
      tiles[g] = acc;
      acc += (int)((offs[g + 1] - offs[g] + kBM - 1) / kBM) * cols;
    }
    tiles[p.G] = acc;
  }
  __syncthreads();
  const Walk walk{offs, tiles, p.G, cols};
  const int kc = p.K / kChunk;

  if (tid >= 256) {  // the producer warpgroup: a copy warp, then kSplitters splitting warps
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    const int warp = (tid - 256) / 32;
    int u = 0;
    if (warp == 0) {
      if (tid == 256)
        for (int t = blockIdx.x; t < walk.total(); t += gridDim.x) {
          const Tile tile = decode(walk, t);
          for (int j = 0; j < kc; ++j, ++u) issue<kMode>(p, r, tile, j, u);
        }
    } else {
      const int lane = tid - 256 - 32;
      for (int t = blockIdx.x; t < walk.total(); t += gridDim.x)
        for (int j = 0; j < kc; ++j, ++u) split_stage(r, u, lane);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");

  // this thread's fragment rows of a tile: warpgroup w takes rows 64w ..
  const int r0 = 64 * (tid / 128) + 16 * ((tid % 128) / 32) + (tid % 32) / 4;
  int u = 0;
  for (int t = blockIdx.x; t < walk.total(); t += gridDim.x, u += kc) {
    const Tile tile = decode(walk, t);
    float run[kAcc];
    product(r, u, kc, r0, run);
    epilogue<kMode>(p, tile, r0, run);
  }
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

// A row-major f32 [rows, K] matrix as a 2-D map of boxes [32 k, box_rows],
// each 128-byte row of a box permuted by the 128-byte swizzle (what wgmma
// and the fragment loads read). Rows past `rows` read as zeros.
bool kmajor_map(CUtensorMap* map, const float* m, long long rows, int K, int box_rows) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr || rows < 1) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)kChunk, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(m), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kMode>
int launch(Params& p, const float* x, const float* w, const float* w2, int grid, void* stream) {
  const int box = kMode == kGateUp ? kGateCols : kBN;
  if (p.G < 1 || p.G > kMaxGroups || (p.offsets == nullptr && p.G != 1) || p.rows < 1 ||
      p.K < kChunk || p.K % kChunk != 0 || p.Nw < box || p.Nw % box != 0 || grid < 1 ||
      !aligned16(x) || !aligned16(w) || !aligned16(w2) || !aligned16(p.out))
    return (int)cudaErrorInvalidValue;
  const auto kernel = grouped_kernel<kMode>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const long long wrows = (long long)p.G * p.Nw;
  if (!kmajor_map(&p.a_map, x, p.rows, p.K, kBM) || !kmajor_map(&p.b_map, w, wrows, p.K, box) ||
      (kMode == kGateUp && !kmajor_map(&p.u_map, w2, wrows, p.K, box)))
    return (int)cudaErrorInvalidValue;
  kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one CTA.
extern "C" long long grouped_swiglu_smem_bytes() { return (long long)kSmemBytes; }

// The tiling the wrapper reads: the rows of a tile (a group's rows are
// computed in whole tiles of them), the columns of a gate-up and of a down
// tile (N and D must be multiples of them), and the most groups a launch.
extern "C" void grouped_swiglu_tiling(int* out) {
  out[0] = kBM;
  out[1] = kGateCols;
  out[2] = kBN;
  out[3] = kMaxGroups;
}

// h [rows, N] = silu(x Wg[g]^T) * (x Wu[g]^T) for the rows of each group g:
// x [rows, K], w_gate and w_up [G, N, K], offsets [G + 1] (int64, on the
// card) or null for one group; `grid` persistent CTAs on `stream`. Returns
// the cudaError_t of the attribute call or the launch (0 on success).
extern "C" int grouped_swiglu_gate_up(const float* x, const float* w_gate, const float* w_up,
                                      const long long* offsets, float* h, long long rows, int G,
                                      int K, int N, int grid, void* stream) {
  Params p{};
  p.offsets = offsets;
  p.out = h;
  p.rows = rows;
  p.G = G;
  p.K = K;
  p.Nw = N;
  return launch<kGateUp>(p, x, w_gate, w_up, grid, stream);
}

// out[dest[p]] = scale[dest[p]] * (h[p] Wd[g]^T) for the rows p of each
// group g: h [rows, N], w_down [G, D, N], dest [rows] (int64) or null for
// row p itself, scale (indexed by dest) or null for 1; out [*, D].
extern "C" int grouped_swiglu_down(const float* h, const float* w_down,
                                   const long long* offsets, const long long* dest,
                                   const float* scale, float* out, long long rows, int G, int N,
                                   int D, int grid, void* stream) {
  Params p{};
  p.offsets = offsets;
  p.dest = dest;
  p.scale = scale;
  p.out = out;
  p.rows = rows;
  p.G = G;
  p.K = N;
  p.Nw = D;
  return launch<kDown>(p, h, w_down, w_down, grid, stream);
}
