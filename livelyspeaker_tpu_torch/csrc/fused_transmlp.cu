// Fused TransMLP stack for NVIDIA Hopper (sm_90a), f32 in and out: one
// sequence split across a thread-block cluster, the channel mix and the pose
// projection as 3xTF32 wgmma fed by a TMA weight ring.
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
// The arithmetic contract: f32 in, f32 out, f32 residual stream. The
// LayerNorms (two-pass statistics, Chan's combine), the activations and the
// token mix are f32 on the CUDA cores. The two products run on the tensor
// cores in 3xTF32 (as the TPU's MXU at precision=HIGHEST): each operand is
// split x = hi + lo, hi = rna_tf32(x), lo = rna_tf32(x - hi) (tf32_mma.cuh:
// split_tf32), and every k8 step runs lo.hi + hi.lo + hi.hi (lo.lo is below
// f32's rounding). Each K-chunk of 32 k is summed in a fresh accumulator
// that is then added into the running f32 sum with an ordinary add. One pass
// of TF32 (relative errors of about 3e-4) is never taken. The sums run in a
// fixed order: every run gives the same bits.
//
// What bounds it on an H100 SXM (700 W): at BEAT's sampling call (2B = 512,
// S = 36, D = 512, L = 8, F = 282) the products are 83 GFLOP, so three TF32
// passes over 40-row tiles take 0.56 ms at 495 TFLOP/s; the token mix, 5.4
// GFLOP on the FP32 pipe, 0.08 ms at 67 TFLOP/s. But one sequence a cluster
// means every cluster reads all of ch_w (8.4 MB for 8 layers) from L2 for
// its 36 rows, 4.3 GB a call, and a layer is a chain of dependent steps
// (three cluster barriers, two LayerNorms, the token mix, the partial sums'
// exchange, the epilogue) that each CTA pays once a layer in every wave of
// clusters: at clusters of four, some 16 us a layer, 17 waves.
//
// The design, and what it does about that:
// - Cluster split: a sequence over N CTAs (the wrapper's transmlp_geometry
//   picks N from the batch and the clusters the card holds at once; two
//   for a large batch, which halves the waves of four); CTA r owns columns
//   [r*Dc, (r+1)*Dc), Dc = D/N <= 256, of x, kept in its shared memory for
//   all L blocks. The token mix is column-local, on the CUDA cores; the
//   LayerNorm statistics take one exchange through distributed shared
//   memory and one cluster barrier each.
// - The channel mix is split over K: CTA r multiplies its own columns of
//   the LN2 rows by its rows of ch_w, all D outputs, and sends each other
//   CTA the partial sums of that CTA's columns through distributed shared
//   memory; after a cluster barrier each CTA adds the N partials of its
//   columns in rank order. So a CTA's LN2 rows never leave it, and it holds
//   only Dc of the D columns that wgmma reads (TF32 wgmma reads B from
//   shared memory only, K-major, here split into a hi and a lo copy: 80 KB
//   at Dc = 256 where all D would take 160 KB and leave no ring).
// - Swap-AB wgmma: out^T [64 columns, rows] = W [64, K] . h^T [K, rows]. The
//   rows of the sequence sit in wgmma's N, 40 for S <= 36 (not the 64 an M
//   of rows would pad to). The D outputs are taken a slice at a time (each
//   other CTA's first, its own last, whose sums go to its B rows once every
//   product is done), in passes of two 64-column M-tiles, one a warpgroup
//   (one M-tile, the first warpgroup's, when Dc <= 64).
// - A, the weights, comes from registers: ch_w stays [L, D_in, D_out] (the
//   training pack re-packs nothing), so its slice is M-major, which TF32
//   wgmma cannot read from shared memory. A TMA ring of up to 8 stages of
//   [32 k, 136 columns] (72 when Dc <= 64; a row stride of 8 mod 32: a
//   warp's 8-byte reads hit every bank once) streams the CTA's rows of ch_w
//   across passes and layers; each thread loads its fragment (the
//   fragment's rows g and g + 8 are the tile's columns 2g and 2g + 1: one
//   8-byte load a k row), splits it in registers and releases the stage at
//   once, one count a consuming warp on a shared counter. The SM's copy
//   engine takes one box at a time (some 700 cycles a box) and holds the
//   issuing thread 200-500 cycles, so the copies come from a producer
//   warpgroup, whose first thread issues each stage once every consuming
//   warp has released it (the next layer's first stages load during the
//   LayerNorms and the token mix) and whose warps otherwise only keep the
//   compute warps' barriers; it gives its registers to the compute
//   warpgroups (setmaxnreg).
// - A warpgroup loads and splits the next K-chunk's fragment while the
//   current chunk's wgmma run, one K-chunk a ring stage. K runs in whole
//   32-k chunks with no branch around a wgmma: past Dc, the fragment is
//   zeroed.
// - The pose projection is split over K the same way: CTA r multiplies its
//   columns of x (split, in place of the LN2 rows) by its rows of out_w for
//   every 64-column tile of F and sends each tile's partials to the tile's
//   owner (tile i: CTA i mod N), which adds them in rank order. out_w [D, F]
//   rows are not 16-byte aligned for TMA, so each thread copies its own
//   fragment of each K-chunk (cp.async, zero past Dc and past F) three
//   chunks ahead into its own slots of the idle ring. (Rows padded in the
//   pack and fed through the weight ring gave the same bits 1-3% slower at
//   TED and BEAT, 2B = 16 to 512.)
// - The epilogue (sum of the partials, bias, activation, residual) is one
//   loop over this CTA's columns: code that runs once a layer, unrolled
//   over a thread's accumulators, missed in the instruction cache.
// Per layer: 3 cluster barriers (LN1 statistics, LN2 statistics, the
// partial sums); 2 more for the pose projection.
//
// Limits: S <= 36, 16 <= D <= 512 with D % 16 == 0, F <= 512, f32 only;
// N in {1, 2, 4, 8} with Dc = D/N a multiple of 4, at most 256, and a
// layout that leaves the ring at least two stages. Anything else returns
// cudaErrorInvalidValue, and a refused launch returns its own error; the
// wrapper raises on either.

#include "transmlp_common.cuh"
#include "wgmma.cuh"  // descriptors, fences, commit and wait

namespace {

constexpr int kR = 40;                     // rows of a sequence in wgmma's N (S <= 36)
constexpr int kChunk = 32;                 // k of one 128-byte swizzled row of f32
constexpr int kRowBytes = 128;
constexpr int kChunkBytes = kR * kRowBytes;  // one K-chunk of the B rows
constexpr int kStageK = kChunk;            // k rows of a ring stage: a K-chunk, four k8 steps
constexpr int kMaxStages = 8;              // the weight ring's stages, as many as fit
constexpr int kMaxSlice = 256;             // Dc: columns of x a CTA owns
constexpr int kPoseStages = 3;             // the pose's stages in flight, a thread
constexpr int kFrag = 16;                  // a thread's fragment of one ring stage
constexpr int kAcc = 20;                   // accumulators of an m64n40 tile, a thread
constexpr int kBlock = kT + 128;           // threads: two compute warpgroups, then the producer's
constexpr int kTile = 64;                  // columns of an M-tile
constexpr int kTileBytes = kSPad * kTile * 4;  // one rank's partials of a pose tile
constexpr int kPoseBufBytes = (kMaxN / kTile) * kTileBytes;  // every pose tile's, F <= 512
constexpr size_t kSmemLimit = 232448;      // dynamic shared memory a CTA may take (H100)

// one layer's token mix [kSPad, kSPad], its bias [kSPad] and this CTA's
// columns of the LN1 scale and bias and the LN2 scale and bias (read until
// the LN2 rows are written, then refilled with the next layer's), then two
// buffers of its columns of the channel-mix bias (read in the epilogue)
__host__ __device__ inline int prm_floats(int dc) { return kSPad * kSPad + kSPad + 6 * dc; }
__host__ __device__ inline size_t up(size_t v, size_t a) { return (v + a - 1) / a * a; }

// Layout of the dynamic shared memory, in bytes from a 1024-aligned base:
// the ring takes what the rest leaves, up to kMaxStages stages. The pose
// projection's partials reuse recv, x and prm, which lie together.
struct Layout {
  int dc, mt, bw, kc, pps, stages;  // Dc; M-tiles a pass (1, 2); ring row (floats);
                                    // K-chunks of Dc; passes a slice; ring stages
  size_t recv_bytes;
  __host__ __device__ Layout(int D, int N)
      : dc(D / N), mt(D / N > kTile ? 2 : 1), bw(kTile * (D / N > kTile ? 2 : 1) + 8),
        kc((D / N + kChunk - 1) / kChunk), pps((D / N + 2 * kTile - 1) / (2 * kTile)), stages(0) {
    // the partials of N - 1 CTAs, or what the pose's need beyond x and prm
    const size_t part = (size_t)(N - 1) * kSPad * dc * 4, rest = x_bytes() + prm_bytes();
    const size_t pose = kPoseBufBytes > rest ? kPoseBufBytes - rest : 0;
    recv_bytes = up(part > pose ? part : pose, 16);
    const size_t used = bytes();  // everything but the ring
    const size_t fit = used < kSmemLimit ? (kSmemLimit - used) / stage_bytes() : 0;
    stages = fit < (size_t)kMaxStages ? (int)fit : kMaxStages;
  }
  __host__ __device__ size_t stage_bytes() const { return (size_t)kStageK * bw * 4; }
  __host__ __device__ size_t x_bytes() const { return (size_t)kSPad * dc * 4; }
  __host__ __device__ size_t prm_bytes() const { return (size_t)prm_floats(dc) * 4; }
  // this CTA's columns of the LN2 rows (or of x, for the pose), hi [kc][kR][32]
  // then lo, 128-byte swizzled; also the LN1 rows [kSPad][dc] of the token mix
  __host__ __device__ size_t h() const { return 0; }
  __host__ __device__ size_t h_bytes() const { return (size_t)2 * kc * kChunkBytes; }
  // the other CTAs' partial sums of this CTA's columns [N - 1][kSPad][dc]
  __host__ __device__ size_t recv() const { return h() + h_bytes(); }
  __host__ __device__ size_t x() const { return recv() + recv_bytes; }  // [kSPad][dc]
  __host__ __device__ size_t prm() const { return x() + x_bytes(); }
  __host__ __device__ size_t ring() const { return up(prm() + prm_bytes(), 128); }
  __host__ __device__ size_t ring_bytes() const { return (size_t)stages * stage_bytes(); }
  __host__ __device__ size_t emb() const { return ring() + ring_bytes(); }  // [dc]
  __host__ __device__ size_t st() const {  // [2][kMaxCluster][kSPad][2]
    return emb() + (size_t)dc * 4;
  }
  __host__ __device__ size_t rowstat() const {  // mean, 1/std
    return st() + (size_t)2 * kMaxCluster * kSPad * 2 * 4;
  }
  // the stages' "full" mbarriers, the two parameter buffers' mbarriers, then
  // the stages' release counters
  __host__ __device__ size_t bars() const { return rowstat() + (size_t)2 * kSPad * 4; }
  __host__ __device__ size_t bytes() const {
    return bars() + (kMaxStages + 2) * 8 + kMaxStages * 4 + 1024;
  }
  // the ring holds the pose projection's slots: kPoseStages x a thread's fragment
  __host__ __device__ bool ok() const {
    return dc <= kMaxSlice && stages >= 2 &&
           ring_bytes() >= (size_t)kPoseStages * kFrag * kT * 4;
  }
};

struct ClusterParams {
  CUtensorMap cw_map;   // ch_w as a [L * D, D] matrix, boxes of [kStageK, bw]
  const float* x;       // [B, S, D]
  const float* emb;     // [B, D]
  const float* ln1_s;   // [L, D]
  const float* ln1_b;   // [L, D]
  const float* tw;      // [L, S, S]
  const float* tb;      // [L, S]
  const float* ln2_s;   // [L, D] or nullptr (folded)
  const float* ln2_b;   // [L, D] or nullptr (folded)
  const float* cb;      // [L, D]
  const float* ow;      // [D, F] or nullptr (no pose projection)
  const float* ob;      // [F]
  float* out;           // [B, S, F] with ow, else [B, S, D]
  float* stash;         // [L, B, S, D] block inputs, or nullptr
  int S, D, L, F, N;
};

struct Ctx {
  const ClusterParams& p;
  Layout lay;
  int rank, c0, dc, T, passes, tiles;  // T: ring stages of a pass (kc); passes a
                                       // layer (N pps); tiles: L passes T
  size_t seq;
  unsigned char* h;            // the B rows, hi then lo
  uint32_t h_a, l_a;           // their shared-memory addresses
  float *recv, *ring, *x_s, *prm, *emb_s, *st, *mean_s, *inv_s;
  uint64_t* full;  // [kMaxStages] a stage's TMA bytes; then the two parameter buffers'
  uint32_t* cnt;   // [kMaxStages] a stage's releases, a warp a tile, never reset
};

// Byte offset of element k of row `row` in the B rows (hi or lo): K-chunk
// k / 32, then the row's 128 bytes, whose 16-byte chunks the 128-byte
// swizzle permutes by the row's index mod 8 (what wgmma reads).
__device__ __forceinline__ uint32_t h_offset(int row, int k) {
  return (uint32_t)((k >> 5) * kChunkBytes + row * kRowBytes +
                    ((((k & 31) >> 2) ^ (row & 7)) << 4) + ((k & 3) << 2));
}

// d (+)= A[64, 8] . B[40, 8]^T in TF32 with f32 sums: A this thread's four
// fragment registers (rows g, g + 8 at k q, then at k q + 4), B K-major in
// shared memory; scale_d = 0 starts from zero.
__device__ __forceinline__ void wgmma_tf32(float (&d)[kAcc], const uint32_t* a, uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      " %10, %11, %12, %13, %14, %15, %16, %17, %18, %19}, "
      "{%20, %21, %22, %23}, %24, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// A stage's fragment (two k8 steps of four values), split into TF32 halves.
struct Frag {
  uint32_t hi[kFrag], lo[kFrag];
};

__device__ __forceinline__ void split_frag(const float (&v)[kFrag], Frag& f) {
#pragma unroll
  for (int i = 0; i < kFrag; ++i) {
    float hi, lo;
    split_tf32(v[i], hi, lo);
    f.hi[i] = __float_as_uint(hi);
    f.lo[i] = __float_as_uint(lo);
  }
}

// keeps a fragment's registers alive (and unmoved) until here: the wgmma
// that read them run asynchronously until their wait
__device__ __forceinline__ void fence_frag(Frag& f) {
#pragma unroll
  for (int i = 0; i < kFrag; ++i) asm volatile("" : "+r"(f.hi[i]), "+r"(f.lo[i])::"memory");
}

// The wgmma of K-chunk j (fragment f), committed as one group: for each of
// its four k8 steps, lo.hi + hi.lo + hi.hi into d, from zero.
__device__ __forceinline__ void chunk_mma(const Ctx& c, float (&d)[kAcc], Frag& f, int j) {
  fence_frag(f);  // the split is done before the fence, not sunk past it
  __syncwarp();
  wgmma_fence();
  const uint32_t off = (uint32_t)(j * kChunkBytes);
#pragma unroll
  for (int kk = 0; kk < kStageK / 8; ++kk) {
    const uint64_t bh = sw128_desc(c.h_a + off + 32 * kk), bl = sw128_desc(c.l_a + off + 32 * kk);
    wgmma_tf32(d, f.lo + 4 * kk, bh, kk == 0 ? 0 : 1);
    wgmma_tf32(d, f.hi + 4 * kk, bl, 1);
    wgmma_tf32(d, f.hi + 4 * kk, bh, 1);
  }
  wgmma_commit();
}

// Waits for the chunk's wgmma, then adds its sum into run.
__device__ __forceinline__ void chunk_done(float (&run)[kAcc], float (&d)[kAcc], Frag& f) {
  wgmma_wait<0>();
  fence_acc(d);
  fence_frag(f);
#pragma unroll
  for (int i = 0; i < kAcc; ++i) run[i] += d[i];
}

// run = A . B^T over the c.T K-chunks of this CTA's K: load(j, frag) gives
// chunk j's fragment (one ring stage). Each chunk is summed in a fresh
// accumulator, then added into run; the next chunk's fragment is loaded
// and split while a chunk's wgmma run, and the accumulator is read only
// once its wgmma are all done (ptxas serialises every wgmma of a function
// that reads an accumulator with a group still in flight).
template <class Load>
__device__ __forceinline__ void product(const Ctx& c, Load load, float (&run)[kAcc]) {
  float d[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) run[i] = d[i] = 0.0f;
  Frag fa, fb;
  load(0, fa);
  for (int j = 0;; j += 2) {
    chunk_mma(c, d, fa, j);
    if (j + 1 < c.T) load(j + 1, fb);
    chunk_done(run, d, fa);
    if (j + 1 >= c.T) break;
    chunk_mma(c, d, fb, j + 1);
    if (j + 2 < c.T) load(j + 2, fa);
    chunk_done(run, d, fb);
    if (j + 2 >= c.T) break;
  }
}

// f(col, n, v0, v1) for this thread's accumulator pairs: v0 and v1 are the
// M-tile's columns col and col + 1 (the fragment's rows g and g + 8), n the
// sequence row.
template <class F>
__device__ __forceinline__ void for_each_pair(const float (&d)[kAcc], F f) {
  const int t = threadIdx.x % 128, wq = t / 32, lane = t % 32;
  const int col = 16 * wq + 2 * (lane / 4);
#pragma unroll
  for (int j = 0; j < kAcc; ++j)
    if (((j >> 1) & 1) == 0) f(col, 8 * (j >> 2) + 2 * (lane & 3) + (j & 1), d[j], d[j + 2]);
}

// This thread's column of a fragment pair in an M-tile (see for_each_pair).
__device__ __forceinline__ int frag_col() {
  return 16 * ((threadIdx.x % 128) / 32) + 2 * ((threadIdx.x % 32) / 4);
}

// The slice of the D outputs that pass p of a layer takes: each other CTA's
// in turn from the next rank, this CTA's own last.
__device__ __forceinline__ int pass_slice(const Ctx& c, int p) {
  return (c.rank + 1 + p / c.lay.pps) % c.p.N;
}

// One thread: ring tile u (numbered across layers and passes: pass u / T of
// its layer, stage u % T of K) into stage u % stages as one TMA box of
// [kStageK, bw] of ch_w: this CTA's rows, the pass's columns (past the
// slice, the next CTA's columns, or zeros past D; rows past L * D zeros).
__device__ __forceinline__ void issue_tile(const Ctx& c, int u) {
  const int s = u % c.lay.stages, q = u / c.T, j = u - q * c.T, l = q / c.passes;
  const int pass = q - l * c.passes;
  uint64_t* full = &c.full[s];
  mbar_expect_tx(full, (uint32_t)c.lay.stage_bytes());
  tma_load_2d(c.ring + (size_t)s * kStageK * c.lay.bw, &c.p.cw_map,
              pass_slice(c, pass) * c.dc + 2 * kTile * (pass % c.lay.pps),
              l * c.p.D + c.c0 + j * kStageK, full);
}

// This consuming warp is done with ring tile u: its fragment is split in
// registers, so every load of the stage has returned (in-order issue). Lane
// 0 counts it on the stage's counter; the producer warp refills the stage
// once every consuming warp has.
__device__ __forceinline__ void release_tile(const Ctx& c, int u) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) atomicAdd(&c.cnt[u % c.lay.stages], 1u);
}

// The producer: its first thread issues ring tiles [u, end), each into its
// stage once every consuming warp has released the tile a ring before it.
// A TMA issue holds the issuing thread some 200-500 cycles (the SM's copy
// engine takes one box at a time): a consuming warp that issued would hold
// up every warp waiting for its release. Returns end.
__device__ __forceinline__ int produce(const Ctx& c, int u, int end) {
  if (threadIdx.x == kT) {
    const uint32_t consumers = 4 * c.lay.mt;
    for (; u < end; ++u) {
      const int s = u % c.lay.stages;
      const uint32_t released = consumers * (uint32_t)(u / c.lay.stages);
      while (*reinterpret_cast<volatile uint32_t*>(&c.cnt[s]) < released) __nanosleep(32);
      fence_proxy_async();  // the consumers' generic reads of the stage before the copy
      issue_tile(c, u);
    }
  }
  __syncwarp();
  return end;
}

// Queues layer l's small parameters (every thread): token_w, token_b, the
// LN1 and LN2 affines, and the channel-mix bias into its buffer l % 2. The
// token mix's padding outside [S, S] was zeroed once and is never written.
__device__ __forceinline__ void issue_params(const Ctx& c, int l) {
  if (l >= c.p.L) return;
  const ClusterParams& p = c.p;
  const int S = p.S, dc = c.dc, q4 = dc / 4;
  float* b = c.prm;
  const float* tw = p.tw + (size_t)l * S * S;
  for (int i = threadIdx.x / 32; i < S; i += kT / 32)  // a warp a row
    for (int j = threadIdx.x % 32; j < S; j += 32) cp_async4(b + i * kSPad + j, tw + i * S + j, true);
  if (threadIdx.x < S) cp_async4(b + kSPad * kSPad + threadIdx.x, p.tb + (size_t)l * S + threadIdx.x, true);
  float* v = b + kSPad * kSPad + kSPad;
  for (int idx = threadIdx.x; idx < 5 * q4; idx += kT) {
    const int which = idx / q4, col = (idx % q4) * 4;
    const float* src = which == 0 ? p.ln1_s : which == 1 ? p.ln1_b : which == 2 ? p.ln2_s
                     : which == 3 ? p.ln2_b : p.cb;
    float* dst = v + (which < 4 ? which : 4 + l % 2) * dc + col;
    if (src != nullptr) cp_async16(dst, src + (size_t)l * p.D + c.c0 + col, true);
  }
  cp_async_arrive(&c.full[kMaxStages + l % 2]);
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

// This CTA's columns of the rows < S of x (LN2(x) when ln, with the affine
// g2, b2 unless null), split into TF32 halves, into its B rows, four columns
// a store; then the proxy fence the wgmma reads need.
__device__ __forceinline__ void write_rows(const Ctx& c, bool ln, const float* g2,
                                           const float* b2) {
  const int q4 = c.dc / 4, lo = c.lay.kc * kChunkBytes;
  for (int idx = threadIdx.x; idx < c.p.S * q4; idx += kT) {
    const int r = idx / q4, col = 4 * (idx - r * q4);
    const float4 xv = *reinterpret_cast<const float4*>(c.x_s + r * c.dc + col);
    float v[4] = {xv.x, xv.y, xv.z, xv.w};
    if (ln) {
      const float m = c.mean_s[r], inv = c.inv_s[r];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[i] = (v[i] - m) * inv;
        if (g2 != nullptr) v[i] = v[i] * g2[col + i] + b2[col + i];
      }
    }
    float hi[4], lw[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(v[i], hi[i], lw[i]);
    const uint32_t off = h_offset(r, col);
    *reinterpret_cast<uint4*>(c.h + off) =
        make_uint4(__float_as_uint(hi[0]), __float_as_uint(hi[1]), __float_as_uint(hi[2]),
                   __float_as_uint(hi[3]));
    *reinterpret_cast<uint4*>(c.h + lo + off) =
        make_uint4(__float_as_uint(lw[0]), __float_as_uint(lw[1]), __float_as_uint(lw[2]),
                   __float_as_uint(lw[3]));
  }
  fence_proxy_async();
}

// This warpgroup's product of ring pass p of layer l: its M-tile of the
// pass's columns over this CTA's K rows, from the ring.
__device__ __forceinline__ void ring_pass(const Ctx& c, int l, int p, float (&run)[kAcc]) {
  const int bw = c.lay.bw, q = threadIdx.x % 4, col = kTile * (threadIdx.x / 128) + frag_col();
  const int dc = c.dc, u0 = (l * c.passes + p) * c.T;
  product(c, [&](int j, Frag& f) {
    const int u = u0 + j, s = u % c.lay.stages;
    mbar_wait(&c.full[s], (uint32_t)((u / c.lay.stages) & 1));
    const float* t = c.ring + (size_t)s * kStageK * bw + q * bw + col;
    float v[kFrag];
#pragma unroll
    for (int kk = 0; kk < kStageK / 8; ++kk) {
      const float2 a = *reinterpret_cast<const float2*>(t + 8 * kk * bw);
      const float2 b = *reinterpret_cast<const float2*>(t + (8 * kk + 4) * bw);
      v[4 * kk] = a.x;
      v[4 * kk + 1] = a.y;
      v[4 * kk + 2] = b.x;
      v[4 * kk + 3] = b.y;
    }
    if ((j + 1) * kStageK > dc) {  // past this CTA's rows: the next CTA's, or zeros
      const int k0 = j * kStageK + q;
#pragma unroll
      for (int i = 0; i < kFrag; ++i)
        if (k0 + 8 * (i / 4) + 4 * ((i >> 1) & 1) >= dc) v[i] = 0.0f;
    }
    split_frag(v, f);
    release_tile(c, u);
  }, run);
}

// The partial sums of slice `sl`, pass column base `cb0`, into CTA sl's
// receive buffer, slot rank (rank - 1 past sl).
__device__ __forceinline__ void send_partials(const Ctx& c, int sl, int cb0,
                                              const float (&run)[kAcc]) {
  const int S = c.p.S, dc = c.dc;
  float* dst = cg::this_cluster().map_shared_rank(c.recv, sl) +
               (size_t)(c.rank < sl ? c.rank : c.rank - 1) * kSPad * dc;
  for_each_pair(run, [&](int mc, int r, float v0, float v1) {
    const int col = cb0 + mc;
    if (r < S && col < dc) *reinterpret_cast<float2*>(dst + r * dc + col) = make_float2(v0, v1);
  });
}

// This warpgroup's partial sums of this CTA's own columns cb0 + [0, 64)
// into the idle B rows, as [kSPad][dc] (the layout of a receive slot).
__device__ __forceinline__ void stage_own(const Ctx& c, int cb0, const float (&run)[kAcc]) {
  const int S = c.p.S, dc = c.dc;
  float* dst = reinterpret_cast<float*>(c.h);
  for_each_pair(run, [&](int mc, int r, float v0, float v1) {
    const int col = cb0 + mc;
    if (r < S && col < dc) *reinterpret_cast<float2*>(dst + r * dc + col) = make_float2(v0, v1);
  });
}

// The channel mix of layer l: x += act(LN2 rows @ ch_w + cb) on this CTA's
// columns. Every pass multiplies this CTA's LN2 columns (K) by its rows of
// ch_w for two M-tiles of a slice of the D outputs; the other CTAs' slices'
// partials go to them, this CTA's (the last passes) to its B rows once
// every product is done; after one cluster barrier each column's N partials
// are added in rank order. The epilogue is one loop over the columns, not
// code unrolled over a thread's accumulators: it runs once a layer, and
// straight-line code that long misses in the instruction cache.
template <int kAct>
__device__ __forceinline__ void channel_mix(const Ctx& c, int l, const float* cb) {
  const int w = threadIdx.x / 128, pps = c.lay.pps, own0 = c.passes - pps;
  float ra[kAcc], rb[kAcc];
  if (w < c.lay.mt) {  // warpgroup-uniform
    for (int p = 0; p < c.passes; ++p) {
      float run[kAcc];
      ring_pass(c, l, p, run);
      if (p < own0) {
        send_partials(c, pass_slice(c, p), 2 * kTile * (p % pps) + kTile * w, run);
      } else {
#pragma unroll
        for (int i = 0; i < kAcc; ++i) (p == own0 ? ra[i] : rb[i]) = run[i];
      }
    }
  }
  __syncthreads();  // every product is done with the B rows
  if (w < c.lay.mt) {
    stage_own(c, kTile * w, ra);
    if (pps == 2) stage_own(c, 2 * kTile + kTile * w, rb);
  }
  cg::this_cluster().sync();  // every CTA's partials of this CTA's columns are in
  const int S = c.p.S, dc = c.dc, N = c.p.N, rank = c.rank, q4 = dc / 4;
  const float* own = reinterpret_cast<const float*>(c.h);
  for (int idx = threadIdx.x; idx < S * q4; idx += kT) {
    const int r = idx / q4, col = 4 * (idx - r * q4);
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int i = 0; i < N; ++i) {
      const float* src = i == rank ? own : c.recv + (size_t)(i < rank ? i : i - 1) * kSPad * dc;
      const float4 v = *reinterpret_cast<const float4*>(src + r * dc + col);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const float4 b = *reinterpret_cast<const float4*>(cb + col);
    float4* px = reinterpret_cast<float4*>(c.x_s + r * dc + col);
    float4 x = *px;
    x.x += activate(s.x + b.x, kAct);
    x.y += activate(s.y + b.y, kAct);
    x.z += activate(s.z + b.z, kAct);
    x.w += activate(s.w + b.w, kAct);
    *px = x;
  }
}

// out = x @ ow + ob, split over K as the channel mix is: this CTA's columns
// of x (split, in the B rows) times its rows of ow for every 64-column tile
// of F, one tile a warpgroup at a time; each tile's partials go to its owner
// (tile i: CTA i % N) at pose buffer [i / N][rank], which after a cluster
// barrier adds the N in rank order. Each thread copies its own fragment of
// each stage (zero past Dc and past F) kPoseStages ahead into its slots of
// the idle ring: slot s, value i at ring[(s * 8 + i) * kT + thread].
__device__ __forceinline__ void pose_projection(const Ctx& c, float* og) {
  const int F = c.p.F, S = c.p.S, N = c.p.N, dc = c.dc;
  const int tiles = (F + kTile - 1) / kTile, w = threadIdx.x / 128, q = threadIdx.x % 4;
  float* slots = c.ring + threadIdx.x;
  const float* ow = c.p.ow + (size_t)c.c0 * F;  // this CTA's rows
  for (int i = w; i < tiles; i += 2) {
    const int col = kTile * i + frag_col();
    auto issue = [&](int j) {  // stage j's fragment into slot j % kPoseStages
      if (j < c.T) {
        float* dst = slots + (j % kPoseStages) * kFrag * kT;
#pragma unroll
        for (int e = 0; e < kFrag; ++e) {
          const int k = j * kStageK + 8 * (e / 4) + q + 4 * ((e >> 1) & 1), cc = col + (e & 1);
          const bool in = k < dc && cc < F;
          cp_async4(dst + e * kT, in ? ow + (size_t)k * F + cc : ow, in);
        }
      }
      cp_async_commit();
    };
    for (int j = 0; j < kPoseStages; ++j) issue(j);
    float run[kAcc];
    product(c, [&](int j, Frag& f) {
      cp_async_wait<kPoseStages - 1>();  // stage j's copies, this thread's own
      const float* src = slots + (j % kPoseStages) * kFrag * kT;
      float v[kFrag];
#pragma unroll
      for (int e = 0; e < kFrag; ++e) v[e] = src[e * kT];
      split_frag(v, f);
      issue(j + kPoseStages);
    }, run);
    cp_async_wait<0>();
    float* dst = cg::this_cluster().map_shared_rank(c.recv, i % N) +
                 ((size_t)(i / N) * N + c.rank) * (kTileBytes / 4);
    for_each_pair(run, [&](int mc, int r, float v0, float v1) {
      if (r < S) *reinterpret_cast<float2*>(dst + r * kTile + mc) = make_float2(v0, v1);
    });
  }
  cg::this_cluster().sync();  // every CTA's partials of this CTA's tiles are in
  for (int i = c.rank, t = 0; i < tiles; i += N, ++t) {
    const float* buf = c.recv + (size_t)t * N * (kTileBytes / 4);
    for (int idx = threadIdx.x; idx < S * kTile; idx += kT) {
      const int r = idx / kTile, col = idx - r * kTile, f = kTile * i + col;
      if (f >= F) continue;
      float s = 0.0f;
      for (int k = 0; k < N; ++k) s += buf[(size_t)k * (kTileBytes / 4) + idx];
      og[(size_t)r * F + f] = s + __ldg(c.p.ob + f);
    }
  }
}

// One instance per activation, picked at launch: the once-a-layer code
// (token mix, epilogues) holds only its own activation's instructions.
template <int kAct>
__global__ void __launch_bounds__(kBlock, 1)
fused_transmlp_cluster_kernel(const __grid_constant__ ClusterParams p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw_a = smem_addr(smem_raw);
  unsigned char* base = smem_raw + ((1024 - raw_a % 1024) % 1024);
  const Layout lay(p.D, p.N);
  Ctx c{p, lay};
  c.rank = (int)cg::this_cluster().block_rank();
  c.dc = lay.dc;
  c.c0 = c.rank * c.dc;
  c.T = lay.kc;
  c.passes = p.N * lay.pps;
  c.tiles = p.L * c.passes * c.T;
  c.seq = blockIdx.x / p.N;
  c.h = base + lay.h();
  c.h_a = smem_addr(c.h);
  c.l_a = c.h_a + lay.kc * kChunkBytes;
  c.recv = reinterpret_cast<float*>(base + lay.recv());
  c.ring = reinterpret_cast<float*>(base + lay.ring());
  c.x_s = reinterpret_cast<float*>(base + lay.x());
  c.prm = reinterpret_cast<float*>(base + lay.prm());
  c.emb_s = reinterpret_cast<float*>(base + lay.emb());
  c.st = reinterpret_cast<float*>(base + lay.st());
  c.mean_s = reinterpret_cast<float*>(base + lay.rowstat());
  c.inv_s = c.mean_s + kSPad;
  c.full = reinterpret_cast<uint64_t*>(base + lay.bars());
  c.cnt = reinterpret_cast<uint32_t*>(c.full + kMaxStages + 2);
  const int tid = threadIdx.x, S = p.S, D = p.D, dc = c.dc, q4 = dc / 4;
  const int pf = prm_floats(dc);
  const bool producer = tid >= kT;  // warp-uniform

  if (tid < kMaxStages) {
    mbar_init(&c.full[tid], 1);  // the issuing thread's expect_tx
    c.cnt[tid] = 0;
  } else if (tid < kMaxStages + 2) {
    mbar_init(&c.full[tid], kT);  // parameters: every thread's cp.async
  }
  mbar_init_fence();
  // the token mix's padding, the B rows (their padding rows and columns feed
  // only outputs that are not kept, or zero fragments: never NaN), this
  // CTA's columns of x and its padding rows, emb
  if (!producer) {
    for (int idx = tid; idx < pf; idx += kT) c.prm[idx] = 0.0f;
    for (int idx = tid; idx < (int)(lay.h_bytes() / 16); idx += kT)
      reinterpret_cast<uint4*>(c.h)[idx] = make_uint4(0u, 0u, 0u, 0u);
    const float* xg = p.x + c.seq * S * D + c.c0;
    for (int idx = tid; idx < kSPad * dc; idx += kT) {
      const int r = idx / dc, col = idx % dc;
      c.x_s[idx] = r < S ? __ldg(xg + r * D + col) : 0.0f;
    }
    for (int idx = tid; idx < dc; idx += kT) c.emb_s[idx] = __ldg(p.emb + c.seq * D + c.c0 + idx);
  }
  __syncthreads();  // barriers initialised, padding zeroed
  int next = 0;     // the producer's next ring tile
  if (producer)
    next = produce(c, 0, min(lay.stages, c.tiles));
  else
    issue_params(c, 0);
  // the first exchange writes into the other CTAs' shared memory: they
  // must have started
  cg::this_cluster().sync();

  // The producer warpgroup gives registers to the compute warpgroups (it
  // needs few): 168 a thread at launch, 40 and 232 after.
  if (producer) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    // the ring's tiles, and the compute warps' CTA and cluster barriers in
    // their order: per layer, the parameters' wait, the LN1 statistics (a
    // cluster barrier, then the CTA's), LN1, the token mix, the LN2
    // statistics, the LN2 rows; the passes, when the producer issues the
    // layer's tiles and the next layer's first; the partial sums, the end
    for (int l = 0; l < p.L; ++l) {
      __syncthreads();
      cg::this_cluster().sync();
      __syncthreads();
      __syncthreads();
      __syncthreads();
      cg::this_cluster().sync();
      __syncthreads();
      __syncthreads();
      next = produce(c, next, min(c.tiles, (l + 1) * c.passes * c.T + lay.stages));
      __syncthreads();
      cg::this_cluster().sync();
      __syncthreads();
    }
    if (p.ow != nullptr) {  // the pose projection's two cluster barriers
      cg::this_cluster().sync();
      cg::this_cluster().sync();
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");

  const bool folded = p.ln2_s == nullptr;
  float* h_s = reinterpret_cast<float*>(c.h);  // LN1(x) [kSPad, dc]: the B rows are idle
  for (int l = 0; l < p.L; ++l) {
    const float *tw = c.prm, *tb = tw + kSPad * kSPad, *g1 = tb + kSPad, *b1 = g1 + dc,
                *g2 = b1 + dc, *b2 = g2 + dc, *cb = b2 + dc * (1 + l % 2);
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
    mbar_wait(&c.full[kMaxStages + l % 2], (uint32_t)((l / 2) & 1));
    __syncthreads();

    // LN1 on this CTA's columns (padding rows zero), then the token mix (the
    // products of the last layer are done with the B rows)
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

    // LN2: statistics, then this CTA's normalised columns, split, into its
    // B rows (the token mix is done with the LN1 rows there)
    row_stats(c, c.x_s, 1);
    write_rows(c, true, folded ? nullptr : g2, folded ? nullptr : b2);
    __syncthreads();
    issue_params(c, l + 1);  // all but the channel-mix bias are read; its other
                             // buffer was last read in layer l - 1

    channel_mix<kAct>(c, l, cb);
    __syncthreads();
  }

  if (p.ow != nullptr) {
    write_rows(c, false, nullptr, nullptr);
    // every CTA is done with its x and its receive buffer, where the pose's
    // partials land, and its B rows are in
    cg::this_cluster().sync();
    pose_projection(c, p.out + c.seq * S * p.F);
  } else {
    float* og = p.out + c.seq * S * D + c.c0;
    for (int idx = tid; idx < S * dc; idx += kT) og[(idx / dc) * D + idx % dc] = c.x_s[idx];
  }
}

bool shape_ok(int D, int cluster) {
  return D >= kKTile && D <= kMaxN && D % kKTile == 0 &&
         (cluster == 1 || cluster == 2 || cluster == 4 || cluster == kMaxCluster) &&
         D % (4 * cluster) == 0 && Layout(D, cluster).ok();
}

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

// ch_w as the [L * D, D] matrix the ring's TMA copies read, in boxes of
// [kStageK, bw]; columns past D and rows past L * D read as zeros.
bool ring_map(CUtensorMap* map, const float* cw, long long rows, int D, int bw) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)bw, (cuuint32_t)kStageK};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(cw), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launches on `stream` as B clusters of `cluster` CTAs; returns the
// cudaError_t of the attribute call or the launch (0 on success).
int launch(const float* x, const float* emb, const float* ln1_s, const float* ln1_b,
           const float* tw, const float* tb, const float* ln2_s, const float* ln2_b,
           const float* cw, const float* cb, const float* ow, const float* ob, float* out,
           float* stash, int B, int S, int D, int L, int F, int act, int cluster,
           void* stream) {
  if (B < 0 || S < 1 || S > kSPad || !shape_ok(D, cluster) || L < 1 || act < kSilu ||
      act > kLrelu02 || (ow != nullptr && (F < 1 || F > kMaxN || ob == nullptr)) ||
      ((ln2_s == nullptr) != (ln2_b == nullptr)) || !aligned16(cw) || !aligned16(cb) ||
      !aligned16(ln1_s) || !aligned16(ln1_b) || !aligned16(ln2_s) || !aligned16(ln2_b) ||
      !aligned16(stash))
    return (int)cudaErrorInvalidValue;
  const Layout lay(D, cluster);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  cluster_launch_config(&cfg, attr, kBlock, B, cluster, lay.bytes());
  const Kernel kernel = kernel_for(act);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)cfg.dynamicSmemBytes);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return 0;
  cfg.stream = (cudaStream_t)stream;
  ClusterParams p{{}, x, emb, ln1_s, ln1_b, tw, tb, ln2_s, ln2_b, cb, ow, ob, out, stash,
                  S, D, L, F, cluster};
  if (!ring_map(&p.cw_map, cw, (long long)L * D, D, lay.bw)) return (int)cudaErrorInvalidValue;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one CTA, or 0 for a geometry the kernel refuses.
extern "C" long long fused_transmlp_smem_bytes(int D, int cluster) {
  return shape_ok(D, cluster) ? (long long)Layout(D, cluster).bytes() : 0;
}

// Clusters of `cluster` CTAs at width D the current card holds at once
// (cudaOccupancyMaxActiveClusters), or minus the cudaError_t.
extern "C" int fused_transmlp_max_clusters(int D, int cluster) {
  if (!shape_ok(D, cluster)) return -(int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  cluster_launch_config(&cfg, attr, kBlock, cluster, cluster, Layout(D, cluster).bytes());
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
