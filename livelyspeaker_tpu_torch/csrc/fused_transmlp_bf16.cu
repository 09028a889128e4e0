// Fused TransMLP stack for NVIDIA Hopper (sm_90a), bf16: a sequence (or two)
// split across a thread-block cluster, the channel mix and the pose
// projection on wgmma fed by a TMA weight ring.
//
// Replaces the bf16 option of livelyspeaker_tpu/ops/pallas/fused_mlp.py:
// fused_transmlp (the Pallas `_kernel` with x.dtype == bfloat16, its weights
// from pack_transmlp_params(dtype=bfloat16) and pack_out_proj(dtype=...)).
// For each of L blocks, on one [S, D] sequence, rounding where the Pallas
// kernel does:
//   x = bf16(x + emb)                                  the residual is bf16
//   h = bf16(LN1(x))                                   statistics and affine in f32
//   x = bf16(x + bf16(act(token_w @ h + token_b)))     bf16 products, f32 sums
//   h = bf16(LN2(x))                                   affine, or folded into ch_w
//   x = bf16(x + bf16(act(h @ ch_w + ch_b)))
// then optionally y = bf16(x @ out_w + out_b), of which the F real columns
// are written; without it the bf16 x is. LayerNorm parameters and biases are
// f32; token_w [L, S, S], ch_w [L, D_out, D_in] and out_w [F, D] are bf16.
// Every elementwise step is one correctly rounded f32 operation in the order
// the plain version (ops/fused_mlp.py: fused_transmlp_bf16_reference) takes
// them, so the two differ only where the sums of the LayerNorms and the
// products are taken in another order, which can move a bf16 rounding.
//
// What bounds it: the tensor cores by the table, a chain of short steps in
// practice. The products are 98% of the work; at TED's serving call (2B =
// 16, S = 35, D = 512, L = 8, F = 27) that is 2.5 GFLOP, 2.5 us at the bf16
// dense peak of 989 TFLOP/s (H100 SXM, 700 W), against 4.4 MB moved, 1.3 us
// at 3.35 TB/s. But a layer is some fifteen dependent steps (three cluster
// barriers, two LayerNorms, the token mix, the row exchange, the channel
// mix and its epilogue), each latency-bound on 8 warps, and every cluster
// reads all of ch_w (4.19 MB for 8 layers) from L2 for only 35 rows a
// sequence: about 35 FLOP a byte of L2 traffic.
//
// The design, and what it does about that:
// - Cluster split, as the f32 kernel (fused_transmlp.cu) does. A group of
//   G (1 or 2) sequences is spread over a cluster of N CTAs; CTA r owns
//   columns [r*Dc, (r+1)*Dc) of their bf16 residual, Dc = D/N <= 256, kept
//   in its shared memory for all L blocks. The wrapper's
//   transmlp_bf16_geometry picks (N, G) from the batch and the clusters the
//   card holds at once: many small CTAs while the batch is one wave, wide
//   slices and two sequences (more work a barrier) when it is many. One CTA
//   a sequence put the serving batch on 16 of 132 SMs.
// - LayerNorm statistics: two-pass per CTA over its columns (f32 from the
//   bf16 values), one exchange through distributed shared memory, Chan's
//   combine (as transmlp_common.cuh's cluster_row_stats). The normalised
//   LN2 rows (bf16) are pushed into every CTA's full-row copy. Three
//   cluster barriers a layer. A layer's LayerNorm parameters and biases
//   are staged by cp.async a layer ahead, token_w through registers across
//   the first barrier: no element waits on a global load.
// - The token mix stays column-local, on mma.sync m16n8k16 (6% of the
//   FLOPs): token_w staged, the LN1 rows read by ldmatrix.trans, S padded
//   to 48.
// - The channel mix and the pose projection run on wgmma, swap-AB: out^T
//   [Dc, rows] = W_slice [Dc, K] . h^T [K, rows]. A is the CTA's slice of
//   ch_w in the pack's [D_out, D_in] layout (K-major), 64 output columns a
//   warpgroup, in passes of two M-tiles; B is the LN2 rows [rows, K]
//   (K-major too). The sequence sits in wgmma's N: 40 rows a sequence (S <=
//   36), not the 48 that 16-row tiles padded to; two sequences make N = 80.
//   A slice that is not a multiple of 64 (Dc = 68 at D = 272, F / N for
//   the pose) pads M with rows TMA fills with zeros or that belong to the
//   next CTA or layer; they only feed columns that are never written back.
//   K runs in whole chunks of 64 with no branch around a wgmma (one made
//   ptxas wait for every chunk): past D, A reads TMA's zeros and B zeros
//   written at the start.
// - A TMA weight ring: up to 8 stages of [64 or 128 rows, 64 k], as many as
//   the shared memory holds, each one 2-D TMA box of the CTA's slice of
//   ch_w (or of out_w) in the 128-byte swizzle the wgmma descriptors name.
//   "Full" mbarriers take the copies' bytes; a shared counter a stage takes
//   one count from every warp once its wgmma on the stage are done, and the
//   warp that counts last refills the stage a ring ahead (no thread waits
//   for the others), across layers: the next layer's first tiles load
//   during the epilogue, the LayerNorms and the token mix. The threads
//   write the LN2 rows in the same swizzle, then fence.proxy.async before
//   wgmma reads them.
// - Weight reuse: with G = 2 every weight tile in shared memory feeds two
//   sequences (one warpgroup each when Dc <= 64, else N = 80 in one
//   wgmma), which halves the L2 reads of a large batch (TED 2B = 512: 2.15
//   GB a call at G = 1, 1.07 GB at G = 2).
//
// Limits: S <= 36, 16 <= D <= 512 with D % 16 == 0, F <= 512; N in {1, 2,
// 4, 8} with Dc = D/N a multiple of 4 and at most 256; G in {1, 2}.
// Anything else returns cudaErrorInvalidValue, and a refused launch returns
// its own error; the wrapper raises on either. The sums are taken in a
// fixed order: every run gives the same bits.

#include <cuda_bf16.h>

#include "transmlp_common.cuh"
#include "wgmma.cuh"  // descriptors, fences, commit and wait

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kR = 40;                    // rows of a sequence in wgmma's N (S <= 36)
constexpr int kTokRows = 48;              // the token mix's rows and K: S in 16-row tiles
constexpr int kTokStride = kTokRows + 8;  // token_w's staged rows (bf16)
constexpr int kWarps = kT / 32;
constexpr int kMaxSlice = 256;            // Dc: columns of the residual a CTA owns
constexpr int kTokTiles = 2;  // 8-column tiles of the token mix a warp takes at a time
constexpr int kChunk = 64;                // k of one 128-byte swizzled row
constexpr int kRowBytes = 128;
constexpr int kMaxStages = 8;             // the weight ring's stages, as many as fit
constexpr int kMaxGroup = 2;              // sequences a cluster holds
constexpr size_t kSmemLimit = 232448;     // dynamic shared memory a CTA may take (H100)

__host__ __device__ inline int round8(int v) { return (v + 7) / 8 * 8; }

// Layout of the dynamic shared memory, in bytes from a 1024-aligned base:
// the weight ring first, as many stages (up to kMaxStages) as the rest
// leaves room for.
struct Layout {
  int dc, xst, hst, kc, G;  // Dc; row strides of x and of the LN1 rows (bf16); K-chunks of D
  int srows, stages;        // rows of a ring stage (a warpgroup's M-tile of 64 each), stages
  __host__ __device__ Layout(int D, int N, int g)
      : dc(D / N), xst(round8(D / N) + 8), hst(round8(D / N) + 8),
        kc((D + kChunk - 1) / kChunk), G(g), srows(D / N > 64 ? 128 : 64), stages(0) {
    const size_t rest = bytes();  // everything but the ring
    const size_t fit = rest < kSmemLimit ? (kSmemLimit - rest) / stage_bytes() : 0;
    stages = fit < (size_t)kMaxStages ? (int)fit : kMaxStages;
  }
  __host__ __device__ size_t stage_bytes() const { return (size_t)srows * kRowBytes; }
  // one K-chunk of the full rows: G * kR rows of 128 bytes
  __host__ __device__ size_t chunk_bytes() const { return (size_t)G * kR * kRowBytes; }
  __host__ __device__ size_t ring() const { return 0; }  // stages x stage_bytes()
  // the full rows (LN2, or x for the pose projection), swizzled, in K-chunks;
  // also the LN1 rows [G][kTokRows][hst] of the token mix
  __host__ __device__ size_t h() const { return (size_t)stages * stage_bytes(); }
  __host__ __device__ size_t h_bytes() const {
    const size_t full = kc * chunk_bytes(), ln1 = (size_t)G * kTokRows * hst * 2;
    return full > ln1 ? full : ln1;
  }
  __host__ __device__ size_t x() const { return h() + h_bytes(); }  // [G][kR][xst]
  __host__ __device__ size_t tok() const { return x() + (size_t)G * kR * xst * 2; }
  __host__ __device__ size_t st() const {  // [2][kMaxCluster][G * kR][2] f32
    return tok() + (size_t)kTokRows * kTokStride * 2;
  }
  __host__ __device__ size_t rowstat() const {  // mean, 1/std [G * kR] each
    return st() + (size_t)2 * kMaxCluster * G * kR * 2 * 4;
  }
  __host__ __device__ size_t emb() const {  // [G][Dc8] bf16, staged once
    return rowstat() + (size_t)2 * G * kR * 4;
  }
  // two buffers of one layer's LN1 scale and bias, LN2 scale and bias and
  // channel-mix bias on this CTA's columns, and the token-mix bias [40]
  __host__ __device__ size_t prm() const { return emb() + (size_t)G * round8(dc) * 2; }
  __host__ __device__ int prm_floats() const { return 5 * dc + kR; }
  // the stages' "full" mbarriers [kMaxStages], then their release counters
  __host__ __device__ size_t bars() const { return prm() + (size_t)2 * prm_floats() * 4; }
  __host__ __device__ size_t bytes() const { return bars() + kMaxStages * 12 + 1024; }
};

struct Params {
  CUtensorMap cw_map;  // ch_w as [L * D, D], boxes [64 * Mc, 64]
  CUtensorMap ow_map;  // out_w [F, D], boxes [64 * min(2, Mp), 64]
  const bf16* x;       // [B, S, D]
  const bf16* emb;     // [B, D]
  const float* ln1_s;  // [L, D]
  const float* ln1_b;
  const bf16* tw;      // [L, S, S]
  const float* tb;     // [L, S]
  const float* ln2_s;  // [L, D], or null: folded
  const float* ln2_b;
  const float* cb;     // [L, D]
  const float* ob;     // [F], or null: no pose projection
  bf16* out;           // [B, S, F] or [B, S, D]
  int B, S, D, L, F, N, G;
};

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16_rn(v); }
// a + b of two bf16 values: the f32 sum, rounded once
__device__ __forceinline__ bf16 bf_add(bf16 a, float b_rounded) {
  return f2bf(__fadd_rn(bf2f(a), b_rounded));
}
// four bf16 at p (8-byte aligned) as f32
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ uint2 pack4(bf16 a, bf16 b, bf16 c, bf16 d) {
  return make_uint2(
      (uint32_t)__bfloat16_as_ushort(a) | ((uint32_t)__bfloat16_as_ushort(b) << 16),
      (uint32_t)__bfloat16_as_ushort(c) | ((uint32_t)__bfloat16_as_ushort(d) << 16));
}

// Byte offset of element k of row `row` in the full rows: K-chunk k / 64,
// then the row's 128 bytes, whose 16-byte chunks the 128-byte swizzle
// permutes by the row's index mod 8 (what TMA writes and wgmma reads).
__host__ __device__ __forceinline__ uint32_t h_offset(int G, int row, int k) {
  return (uint32_t)((k >> 6) * G * kR * kRowBytes + row * kRowBytes +
                    ((((k & 63) >> 3) ^ (row & 7)) << 4) + ((k & 7) << 1));
}

// --- wgmma ------------------------------------------------------------------

// d (+)= A[64, 16] . B[N, 16]^T, A and B K-major in shared memory, f32 sums;
// scale_d = 0 starts from zero.
__device__ __forceinline__ void wgmma_n40(float (&d)[20], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      " %10, %11, %12, %13, %14, %15, %16, %17, %18, %19}, "
      "%20, %21, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n80(float (&d)[40], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      " %10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      " %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "%40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <int NW>
__device__ __forceinline__ void wgmma_step(float (&d)[NW / 2], uint64_t a, uint64_t b,
                                           int scale_d) {
  if constexpr (NW == 40) wgmma_n40(d, a, b, scale_d);
  else wgmma_n80(d, a, b, scale_d);
}

// The four steps of 16 k of one K-chunk: A [64 rows] at a_addr, B [NW rows]
// at b_addr, both 128-byte swizzled rows of 64 k. Straight-line code: a
// branch around a wgmma makes ptxas wait for the accumulators there. Past
// D, A's columns are TMA's zeros and B's were zeroed at the start (and are
// only ever overwritten with finite values).
template <int NW>
__device__ __forceinline__ void chunk_mma(float (&d)[NW / 2], uint32_t a_addr, uint32_t b_addr,
                                          int scale_d) {
  wgmma_step<NW>(d, sw128_desc(a_addr), sw128_desc(b_addr), scale_d);
#pragma unroll
  for (int k = 1; k < 4; ++k)
    wgmma_step<NW>(d, sw128_desc(a_addr + 32 * k), sw128_desc(b_addr + 32 * k), 1);
}

// f(m, n, value) for each accumulator of this thread: m the row of the
// 64-row M-tile (an output column), n the row of B (a sequence row).
template <int NW, class F>
__device__ __forceinline__ void for_each_acc(const float (&d)[NW / 2], F f) {
  const int t = threadIdx.x % 128, wq = t / 32, lane = t % 32;
#pragma unroll
  for (int j = 0; j < NW / 2; ++j) {
    const int m = 16 * wq + lane / 4 + 8 * ((j >> 1) & 1);
    const int n = 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
    f(m, n, d[j]);
  }
}

// --- mma.sync for the token mix ---------------------------------------------

__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void tma_load_2d_bf16(uint32_t dst, const CUtensorMap* map, int x0,
                                                 int y0, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(x0), "r"(y0)
      : "memory");
}

// 8 bytes from global to shared memory, or 8 zero bytes when !in
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(in ? 8 : 0)
               : "memory");
}

struct Ctx {
  const Params& p;
  Layout lay;
  int rank, c0, dc, q4, seq0, kc;
  int mc;        // M-tiles of the channel mix: ceil(Dc / 64), 1 to 4
  int f0, nf;    // the pose columns [f0, f0 + nf) this CTA writes
  int stages, srows;  // the ring's stages and the rows of one
  int passes_c;  // passes of the channel mix over its M-tiles, srows / 64 a pass
  int tiles_c;   // ring tiles of the channel mix, L * passes_c * kc; the pose's follow
  int tiles;     // every ring tile of this CTA
  uint32_t ring_a, h_a;
  unsigned char* h;
  bf16 *x, *tok, *emb;
  float *st, *mean, *inv, *prm;
  uint64_t* full;  // a stage's TMA bytes
  uint32_t* cnt;   // a stage's releases, a warp a tile, never reset
};

// One thread: ring tile u (numbered across layers, then the pose's
// passes) into stage u % stages as one TMA box of [srows, 64].
__device__ __forceinline__ void issue_tile(const Ctx& c, int u) {
  const int s = u % c.stages;
  uint64_t* full = &c.full[s];
  const uint32_t dst = c.ring_a + s * c.srows * kRowBytes;
  mbar_expect_tx(full, c.srows * kRowBytes);
  if (u < c.tiles_c) {
    const int per_layer = c.passes_c * c.kc, l = u / per_layer, v = u - l * per_layer;
    const int pass = v / c.kc, j = v - pass * c.kc;
    tma_load_2d_bf16(dst, &c.p.cw_map, j * kChunk, l * c.p.D + c.c0 + pass * c.srows, full);
  } else {
    const int v = u - c.tiles_c, pass = v / c.kc, j = v % c.kc;
    tma_load_2d_bf16(dst, &c.p.ow_map, j * kChunk, c.f0 + pass * c.srows, full);
  }
}

// This warp is done with ring tile u (its wgmma on it have completed): its
// lane 0 counts it on the stage's counter, and the warp that counts last
// refills the stage `stages` tiles ahead. Nobody waits for the others.
__device__ __forceinline__ void release_tile(const Ctx& c, int u) {
  if (threadIdx.x % 32 != 0) return;
  const int s = u % c.stages;
  uint32_t prev;
  asm volatile("atom.acq_rel.cta.shared::cta.add.u32 %0, [%1], 1;"
               : "=r"(prev)
               : "r"(smem_addr(&c.cnt[s]))
               : "memory");
  if (prev == (uint32_t)(kWarps * (u / c.stages + 1) - 1) && u + c.stages < c.tiles)
    issue_tile(c, u + c.stages);
}

// acc = A . B^T over D: A the rows [a_row, a_row + 64) of the ring tiles u0
// .. u0 + kc - 1 (one K-chunk each), B the NW full rows at b_addr. Every
// warp waits for each tile and releases it. One chunk's wgmma stays in
// flight while the next is issued.
template <int NW>
__device__ __forceinline__ void ring_product(const Ctx& c, int u0, int a_row, uint32_t b_addr,
                                             float (&acc)[NW / 2]) {
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0.0f;
  fence_acc(acc);
  for (int j = 0; j < c.kc; ++j) {
    const int u = u0 + j, s = u % c.stages;
    mbar_wait(&c.full[s], (uint32_t)((u / c.stages) & 1));
    __syncwarp();
    wgmma_fence();
    chunk_mma<NW>(acc, c.ring_a + s * c.srows * kRowBytes + a_row * kRowBytes,
                  b_addr + j * (uint32_t)c.lay.chunk_bytes(), j == 0 ? 0 : 1);
    wgmma_commit();
    wgmma_wait<1>();  // the previous chunk's; this one's stays in flight
    if (j > 0) release_tile(c, u - 1);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  release_tile(c, u0 + c.kc - 1);
}

// The (mean, 1/std) of every row of x ([G][kR][xst], this CTA's Dc
// columns) over the cluster's D columns, into c.mean / c.inv, through
// exchange buffer `which`: eight lanes a row take the local two-pass (mean,
// M2) in f32, lane j of the eight pushes it to CTA j; after one cluster
// barrier each CTA combines the N pairs (Chan).
__device__ __forceinline__ void row_stats(const Ctx& c, int which) {
  const int rows = c.lay.G * kR, sub = threadIdx.x % 8, dc = c.dc, N = c.p.N;
  float* st = c.st + which * kMaxCluster * rows * 2;
  const int span = (rows + kT / 8 - 1) / (kT / 8) * (kT / 8);
  for (int i = threadIdx.x / 8; i < span; i += kT / 8) {
    const bf16* row = c.x + min(i, rows - 1) * c.lay.xst;
    float s = 0.0f;
    for (int k = 4 * sub; k < dc; k += 32) {
      const float4 v = load4(row + k);
      s = __fadd_rn(__fadd_rn(s, __fadd_rn(v.x, v.y)), __fadd_rn(v.z, v.w));
    }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
    const float mean = __fdiv_rn(s, (float)dc);
    float v = 0.0f;
    for (int k = 4 * sub; k < dc; k += 32) {
      const float4 x = load4(row + k);
      const float d0 = __fsub_rn(x.x, mean), d1 = __fsub_rn(x.y, mean);
      const float d2 = __fsub_rn(x.z, mean), d3 = __fsub_rn(x.w, mean);
      v = __fadd_rn(v, __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)),
                                 __fadd_rn(__fmul_rn(d2, d2), __fmul_rn(d3, d3))));
    }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (i < rows && i % kR < c.p.S && sub < N) {
      float* dst = cg::this_cluster().map_shared_rank(st, sub);
      *reinterpret_cast<float2*>(dst + (c.rank * rows + i) * 2) = make_float2(mean, v);
    }
  }
  cg::this_cluster().sync();
  const int i = threadIdx.x;
  if (i < rows && i % kR < c.p.S) {
    const float* pr = st + i * 2;  // rank j: + j * rows * 2
    float m = 0.0f;
    for (int j = 0; j < N; ++j) m = __fadd_rn(m, pr[j * rows * 2]);
    m = __fdiv_rn(m, (float)N);
    float m2 = 0.0f, spread = 0.0f;
    for (int j = 0; j < N; ++j) {
      const float d = __fsub_rn(pr[j * rows * 2], m);
      m2 = __fadd_rn(m2, pr[j * rows * 2 + 1]);
      spread = __fadd_rn(spread, __fmul_rn(d, d));
    }
    m2 = __fadd_rn(m2, __fmul_rn((float)dc, spread));
    c.mean[i] = m;
    c.inv[i] = rsqrtf(__fadd_rn(__fdiv_rn(m2, (float)c.p.D), kEps));
  }
  __syncthreads();
}

// LN(x) of row i at this CTA's columns col .. col + 3, the f32 affine (sc,
// bi in shared memory; null: none), as four bf16 in a uint2
__device__ __forceinline__ uint2 norm4(const Ctx& c, const bf16* xr, int i, int col,
                                       const float* sc, const float* bi) {
  const float4 x = load4(xr);
  const float m = c.mean[i], inv = c.inv[i];
  float y[4] = {__fmul_rn(__fsub_rn(x.x, m), inv), __fmul_rn(__fsub_rn(x.y, m), inv),
                __fmul_rn(__fsub_rn(x.z, m), inv), __fmul_rn(__fsub_rn(x.w, m), inv)};
  if (sc != nullptr) {
    const float4 g = *reinterpret_cast<const float4*>(sc + col);
    const float4 b = *reinterpret_cast<const float4*>(bi + col);
    y[0] = __fadd_rn(__fmul_rn(y[0], g.x), b.x);
    y[1] = __fadd_rn(__fmul_rn(y[1], g.y), b.y);
    y[2] = __fadd_rn(__fmul_rn(y[2], g.z), b.z);
    y[3] = __fadd_rn(__fmul_rn(y[3], g.w), b.w);
  }
  return pack4(f2bf(y[0]), f2bf(y[1]), f2bf(y[2]), f2bf(y[3]));
}

// acc = tok @ h1 of one sequence over the row tiles, on this warp's column
// tiles warp + kWarps * (i0 + i): tok [48, 48] staged (zero past S), h1
// [48, Dc8] (zero rows past S, zero columns past Dc).
__device__ void token_product(float (&acc)[kTokRows / 16][kTokTiles][4], const bf16* tok,
                              const bf16* h1, int hst, int row_tiles, int n_tiles, int i0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int m = 0; m < kTokRows / 16; ++m)
#pragma unroll
    for (int i = 0; i < kTokTiles; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][i][e] = 0.0f;
  for (int ks = 0; ks < row_tiles; ++ks) {
    uint32_t a[kTokRows / 16][4];
#pragma unroll
    for (int m = 0; m < kTokRows / 16; ++m) {
      if (m < row_tiles) {
        const bf16* t0 = tok + (m * 16 + g) * kTokStride + ks * 16 + 2 * q;
        const bf16* t1 = t0 + 8 * kTokStride;
        a[m][0] = *reinterpret_cast<const uint32_t*>(t0);
        a[m][1] = *reinterpret_cast<const uint32_t*>(t1);
        a[m][2] = *reinterpret_cast<const uint32_t*>(t0 + 8);
        a[m][3] = *reinterpret_cast<const uint32_t*>(t1 + 8);
      }
    }
#pragma unroll
    for (int i = 0; i < kTokTiles; ++i) {
      const int t = warp + kWarps * (i0 + i);
      if (t < n_tiles) {
        uint32_t b0, b1;
        ldsm_x2_trans(b0, b1, h1 + (ks * 16 + (lane & 15)) * hst + t * 8);
#pragma unroll
        for (int m = 0; m < kTokRows / 16; ++m)
          if (m < row_tiles) mma(acc[m][i], a[m][0], a[m][1], a[m][2], a[m][3], b0, b1);
      }
    }
  }
}

// This CTA's columns of the G sequences' rows (LN2's, or x itself when ln
// is false) into every CTA's full rows, four columns a store, then the
// proxy fence the wgmma reads need.
__device__ __forceinline__ void push_rows(const Ctx& c, bool ln, const float* sc,
                                          const float* bi) {
  const int S = c.p.S, q4 = c.q4, G = c.lay.G, step = kT / q4, col = 4 * (threadIdx.x % q4);
  if ((int)threadIdx.x < step * q4) {  // a thread a column of four, rows step apart
    for (int g = 0; g < G; ++g) {
      for (int r = threadIdx.x / q4; r < S; r += step) {
        const int i = g * kR + r;
        const bf16* xr = c.x + i * c.lay.xst + col;
        const uint2 packed =
            ln ? norm4(c, xr, i, col, sc, bi) : *reinterpret_cast<const uint2*>(xr);
        const uint32_t off = h_offset(G, i, c.c0 + col);
        for (int j = 0; j < c.p.N; ++j) {
          unsigned char* dst = cg::this_cluster().map_shared_rank(c.h, j);
          *reinterpret_cast<uint2*>(dst + off) = packed;
        }
      }
    }
  }
  fence_proxy_async_cluster();
}

// x = bf16(x + bf16(act(acc + cb))) on the columns [m0, m0 + 64) of this
// CTA's slice, for the sequences g0 .. g0 + NW / 40 - 1 of the group; then,
// before every layer but the first, the next layer's x = bf16(x + emb).
template <int kAct, int NW>
__device__ __forceinline__ void channel_epilogue(const Ctx& c, const float (&acc)[NW / 2],
                                                 int m0, int g0, const float* cb, bool emb) {
  const int S = c.p.S, dc = c.dc, xst = c.lay.xst, dc8 = round8(dc);
  bf16* x = c.x;
  const bf16* es = c.emb;
  for_each_acc<NW>(acc, [&](int m, int n, float v) {
    const int col = m0 + m, r = n % kR, g = g0 + n / kR;
    if (col < dc && r < S) {
      bf16* px = x + (g * kR + r) * xst + col;
      const float y = bf2f(f2bf(activate(__fadd_rn(v, cb[col]), kAct)));
      bf16 out = bf_add(*px, y);
      if (emb) out = bf_add(out, bf2f(es[g * dc8 + col]));
      *px = out;
    }
  });
}

// out = bf16(acc + ob) on this CTA's pose columns f0 + [m0, m0 + 64).
template <int NW>
__device__ __forceinline__ void pose_epilogue(const Ctx& c, const float (&acc)[NW / 2], int m0,
                                              int g0) {
  const int S = c.p.S, F = c.p.F, nf = c.nf, f0 = c.f0;
  const int seq0 = c.seq0, B = c.p.B;
  bf16* out = c.p.out;
  const float* ob = reinterpret_cast<const float*>(c.tok);  // staged: [nf]
  for_each_acc<NW>(acc, [&](int m, int n, float v) {
    const int f = m0 + m, r = n % kR, seq = seq0 + g0 + n / kR;
    if (f < nf && r < S && seq < B)
      out[((size_t)seq * S + r) * F + f0 + f] = f2bf(__fadd_rn(v, ob[f]));
  });
}

// One pass of a ring product over the mt (1 or 2, at most srows / 64)
// M-tiles of a stage, the slice's columns from pass * srows: warpgroup w
// takes M-tile w and every sequence (N = 40 G) when mt == 2; when mt == 1
// it takes sequence w of a group of two, or (G == 1, warpgroup 1) repeats
// warpgroup 0's product and writes nothing.
template <int kAct>
__device__ __forceinline__ void product_pass(const Ctx& c, int u0, int mt, bool pose, int pass,
                                             const float* cb, bool emb) {
  const int w = threadIdx.x / 128, G = c.lay.G;
  if (G == 2 && mt == 2) {
    float acc[40];
    ring_product<80>(c, u0, 64 * w, c.h_a, acc);
    if (pose) pose_epilogue<80>(c, acc, pass * c.srows + 64 * w, 0);
    else channel_epilogue<kAct, 80>(c, acc, pass * c.srows + 64 * w, 0, cb, emb);
    return;
  }
  const int a_row = mt == 2 ? 64 * w : 0, g0 = (mt == 1 && G == 2) ? w : 0;
  float acc[20];
  ring_product<40>(c, u0, a_row, c.h_a + g0 * kR * kRowBytes, acc);
  if (mt == 1 && G == 1 && w == 1) return;
  if (pose) pose_epilogue<40>(c, acc, pass * c.srows + a_row, g0);
  else channel_epilogue<kAct, 40>(c, acc, pass * c.srows + a_row, g0, cb, emb);
}

// Queues layer l's small parameters on this CTA's columns into parameter
// buffer l % 2 (every thread; cp.async, one commit group): the LN1 scale and
// bias, the LN2 scale and bias (unless folded), the channel-mix bias, the
// token-mix bias.
__device__ __forceinline__ void issue_params(const Ctx& c, int l) {
  if (l >= c.p.L) return;
  const Params& p = c.p;
  float* b = c.prm + (l % 2) * c.lay.prm_floats();
  const int q4 = c.q4;
  for (int idx = threadIdx.x; idx < 5 * q4; idx += kT) {
    const int which = idx / q4, col = 4 * (idx - which * q4);
    const float* src = which == 0 ? p.ln1_s : which == 1 ? p.ln1_b : which == 2 ? p.ln2_s
                     : which == 3 ? p.ln2_b : p.cb;
    if (src != nullptr) cp_async16(b + which * c.dc + col, src + (size_t)l * p.D + c.c0 + col, true);
  }
  if (threadIdx.x < p.S) cp_async4(b + 5 * c.dc + threadIdx.x, p.tb + (size_t)l * p.S + threadIdx.x, true);
  cp_async_commit();
}

constexpr int kTokPer = (kTokRows * kTokRows + kT - 1) / kT;  // token_w values a thread stages

template <int kAct>
__global__ void __launch_bounds__(kT, 1) transmlp_bf16_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw_a = smem_addr(smem_raw);
  unsigned char* base = smem_raw + ((1024 - raw_a % 1024) % 1024);
  const Layout lay(p.D, p.N, p.G);
  const int S = p.S, D = p.D, G = p.G, tid = threadIdx.x;
  Ctx c{p, lay};
  c.rank = (int)cg::this_cluster().block_rank();
  c.dc = lay.dc;
  c.q4 = c.dc / 4;
  c.c0 = c.rank * c.dc;
  c.seq0 = (int)(blockIdx.x / p.N) * G;
  c.kc = lay.kc;
  c.mc = (c.dc + 63) / 64;
  const int fc = (p.F + p.N - 1) / p.N;
  c.f0 = c.rank * fc;
  c.nf = p.ob == nullptr ? 0 : max(0, min(p.F, c.f0 + fc) - c.f0);
  c.stages = lay.stages;
  c.srows = lay.srows;
  const int mp = (c.nf + 63) / 64, per = c.srows / 64, passes = (mp + per - 1) / per;
  c.passes_c = (c.mc + per - 1) / per;
  c.tiles_c = p.L * c.passes_c * c.kc;
  c.tiles = c.tiles_c + passes * c.kc;
  c.ring_a = smem_addr(base + lay.ring());
  c.h = base + lay.h();
  c.h_a = smem_addr(c.h);
  c.x = reinterpret_cast<bf16*>(base + lay.x());
  c.tok = reinterpret_cast<bf16*>(base + lay.tok());
  c.st = reinterpret_cast<float*>(base + lay.st());
  c.mean = reinterpret_cast<float*>(base + lay.rowstat());
  c.inv = c.mean + G * kR;
  c.emb = reinterpret_cast<bf16*>(base + lay.emb());
  c.prm = reinterpret_cast<float*>(base + lay.prm());
  c.full = reinterpret_cast<uint64_t*>(base + lay.bars());
  c.cnt = reinterpret_cast<uint32_t*>(c.full + kMaxStages);

  if (tid < kMaxStages) {
    mbar_init(&c.full[tid], 1);  // the issuing thread's expect_tx
    c.cnt[tid] = 0;
  }
  mbar_init_fence();
  const int q4 = c.q4, dc8 = round8(c.dc);
  for (int idx = tid; idx < G * S * q4; idx += kT) {  // this CTA's columns of x (zero:
    const int row = idx / q4, col = 4 * (idx - row * q4), g = row / S, r = row - g * S;
    const int seq = c.seq0 + g;                       // a group's missing sequence)
    const bool in = seq < p.B;
    cp_async8(c.x + (g * kR + r) * lay.xst + col,
              p.x + (in ? ((size_t)seq * S + r) * D + c.c0 + col : 0), in);
  }
  for (int idx = tid; idx < G * q4; idx += kT) {  // and of emb
    const int g = idx / q4, col = 4 * (idx - g * q4), seq = c.seq0 + g;
    const bool in = seq < p.B;
    cp_async8(c.emb + g * dc8 + col, p.emb + (in ? (size_t)seq * D + c.c0 + col : 0), in);
  }
  issue_params(c, 0);
  for (int idx = tid; idx < (int)(lay.h_bytes() / 16); idx += kT)  // K past D reads zeros
    reinterpret_cast<uint4*>(c.h)[idx] = make_uint4(0u, 0u, 0u, 0u);
  cp_async_wait<0>();
  __syncthreads();  // barriers initialised, x, emb and layer 0's parameters in
  if (tid == 0)
    for (int u = 0; u < min(c.stages, c.tiles); ++u) issue_tile(c, u);
  // the first exchange writes into the other CTAs' shared memory: they
  // must have started
  cg::this_cluster().sync();

  const bool affine = p.ln2_s != nullptr;
  const int row_tiles = (S + 15) / 16, n_tiles = dc8 / 8, hq = dc8 / 4, hstep = kT / hq;
  const int tile_sets = (n_tiles + kWarps * kTokTiles - 1) / (kWarps * kTokTiles);
  bf16* h1 = reinterpret_cast<bf16*>(c.h);
  const bf16 zero = __ushort_as_bfloat16((unsigned short)0);
  for (int l = 0; l < p.L; ++l) {
    const float* prm = c.prm + (l % 2) * lay.prm_floats();
    const float *g1 = prm, *b1 = g1 + c.dc, *g2 = b1 + c.dc, *b2 = g2 + c.dc, *cb = b2 + c.dc,
                *tb = cb + c.dc;
    // this layer's token_w into registers; staged after the LN1 statistics
    const bf16* twl = p.tw + (size_t)l * S * S;
    bf16 tw[kTokPer];
#pragma unroll
    for (int i = 0; i < kTokPer; ++i) {
      const int idx = tid + i * kT, r = idx / kTokRows, col = idx - r * kTokRows;
      tw[i] = (r < S && col < S) ? twl[r * S + col] : zero;
    }
    if (l == 0) {  // x += emb; later layers' comes with the channel mix before them
      for (int idx = tid; idx < G * S * q4; idx += kT) {
        const int row = idx / q4, col = 4 * (idx - row * q4), g = row / S;
        bf16* px = c.x + (g * kR + row - g * S) * lay.xst + col;
        const float4 x = load4(px), e = load4(c.emb + g * dc8 + col);
        *reinterpret_cast<uint2*>(px) =
            pack4(f2bf(__fadd_rn(x.x, e.x)), f2bf(__fadd_rn(x.y, e.y)), f2bf(__fadd_rn(x.z, e.z)),
                  f2bf(__fadd_rn(x.w, e.w)));
      }
    }
    cp_async_wait<0>();  // this layer's parameters
    __syncthreads();
    row_stats(c, 0);
    // LN1 rows of this CTA's columns (zero past S and past Dc), token_w staged
    if (tid < hstep * hq) {  // a thread a column of four, rows hstep apart
      const int col = 4 * (tid % hq);
      for (int g = 0; g < G; ++g) {
        for (int r = tid / hq; r < kTokRows; r += hstep) {
          const int i = g * kR + r;
          uint2 v = make_uint2(0u, 0u);
          if (r < S && col < c.dc) v = norm4(c, c.x + i * lay.xst + col, i, col, g1, b1);
          *reinterpret_cast<uint2*>(h1 + (g * kTokRows + r) * lay.hst + col) = v;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kTokPer; ++i) {
      const int idx = tid + i * kT, r = idx / kTokRows;
      if (idx < kTokRows * kTokRows) c.tok[r * kTokStride + idx - r * kTokRows] = tw[i];
    }
    __syncthreads();
    issue_params(c, l + 1);  // its buffer was last read in layer l - 1
    for (int gi = 0; gi < G * tile_sets; ++gi) {  // a sequence, a set of column tiles
      const int g = gi / tile_sets, i0 = kTokTiles * (gi - g * tile_sets);
      float acc[kTokRows / 16][kTokTiles][4];
      token_product(acc, c.tok, h1 + g * kTokRows * lay.hst, lay.hst, row_tiles, n_tiles, i0);
      const int warp = tid / 32, lane = tid % 32, gq = lane >> 2, q = lane & 3;
#pragma unroll
      for (int m = 0; m < kTokRows / 16; ++m) {
        if (m >= row_tiles) continue;
#pragma unroll
        for (int i = 0; i < kTokTiles; ++i) {
          const int t = warp + kWarps * (i0 + i);
          if (t >= n_tiles) continue;
          const int col = t * 8 + 2 * q;
          if (col >= c.dc) continue;  // Dc % 4 == 0: a pair is in or out
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = m * 16 + gq + 8 * half;
            if (r >= S) continue;
            __nv_bfloat162* px =
                reinterpret_cast<__nv_bfloat162*>(c.x + (g * kR + r) * lay.xst + col);
            __nv_bfloat162 xv = *px;
            const float b = tb[r];
            xv.x = bf_add(xv.x, bf2f(f2bf(activate(__fadd_rn(acc[m][i][2 * half], b), kAct))));
            xv.y = bf_add(xv.y, bf2f(f2bf(activate(__fadd_rn(acc[m][i][2 * half + 1], b), kAct))));
            *px = xv;
          }
        }
      }
    }
    __syncthreads();
    // LN2: statistics, then the normalised rows into every CTA's full rows
    // (no CTA still reads its LN1 rows: all passed the barrier in row_stats)
    row_stats(c, 1);
    push_rows(c, true, affine ? g2 : nullptr, affine ? b2 : nullptr);
    cg::this_cluster().sync();
    fence_proxy_async();
    for (int pass = 0; pass < c.passes_c; ++pass)
      product_pass<kAct>(c, (l * c.passes_c + pass) * c.kc, min(per, c.mc - per * pass), false,
                         pass, cb, l + 1 < p.L);
    __syncthreads();
  }

  if (p.ob != nullptr) {
    float* obs = reinterpret_cast<float*>(c.tok);  // this CTA's pose biases (token_w is done)
    for (int j = tid; j < c.nf; j += kT) obs[j] = __ldg(p.ob + c.f0 + j);
    cg::this_cluster().sync();  // every CTA is done reading its full rows
    push_rows(c, false, nullptr, nullptr);
    cg::this_cluster().sync();
    fence_proxy_async();
    for (int pass = 0; pass < passes; ++pass)
      product_pass<kAct>(c, c.tiles_c + pass * c.kc, min(per, mp - per * pass), true, pass, nullptr,
                         false);
  } else {
    for (int idx = tid; idx < G * S * q4; idx += kT) {
      const int row = idx / q4, col = 4 * (idx - row * q4), g = row / S, r = row - g * S;
      const int seq = c.seq0 + g;
      if (seq < p.B)
        *reinterpret_cast<uint2*>(p.out + ((size_t)seq * S + r) * D + c.c0 + col) =
            *reinterpret_cast<const uint2*>(c.x + (g * kR + r) * lay.xst + col);
    }
  }
}

// One wgmma product through the kernel's own operand path, for the unit
// check: A [64, 128] by TMA (weight_map_bf16, two boxes of 64 k), B [n, 128]
// written by threads at h_offset; out [64, n] = A . B^T in f32.
template <int NW>
__global__ void __launch_bounds__(128, 1)
wgmma_check_kernel(const __grid_constant__ CUtensorMap a_map, const bf16* b, float* out) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw_a = smem_addr(smem_raw);
  unsigned char* base = smem_raw + ((1024 - raw_a % 1024) % 1024);
  const uint32_t a_addr = smem_addr(base);
  unsigned char* h = base + 2 * 64 * kRowBytes;
  uint64_t* bar = reinterpret_cast<uint64_t*>(h + 2 * NW * kRowBytes);
  const int G = NW / kR;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, 2 * 64 * kRowBytes);
    tma_load_2d_bf16(a_addr, &a_map, 0, 0, bar);
    tma_load_2d_bf16(a_addr + 64 * kRowBytes, &a_map, kChunk, 0, bar);
  }
  for (int idx = threadIdx.x; idx < NW * 32; idx += 128) {
    const int row = idx / 32, k = 4 * (idx % 32);
    *reinterpret_cast<uint2*>(h + h_offset(G, row, k)) =
        *reinterpret_cast<const uint2*>(b + row * 128 + k);
  }
  fence_proxy_async();
  __syncthreads();
  mbar_wait(bar, 0);
  float acc[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0.0f;
  fence_acc(acc);
  wgmma_fence();
  for (int j = 0; j < 2; ++j)
    chunk_mma<NW>(acc, a_addr + j * 64 * kRowBytes, smem_addr(h) + j * NW * kRowBytes, j);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
  for_each_acc<NW>(acc, [&](int m, int n, float v) { out[m * NW + n] = v; });
}

// The cluster sizes at width D: N in {1, 2, 4, 8}, Dc = D/N a whole number
// of 8-byte loads and at most kMaxSlice columns.
bool shape_ok(int D, int cluster, int group) {
  return D >= 16 && D <= kMaxN && D % 16 == 0 &&
         (cluster == 1 || cluster == 2 || cluster == 4 || cluster == kMaxCluster) &&
         D % (4 * cluster) == 0 && D / cluster <= kMaxSlice &&
         (group == 1 || group == kMaxGroup) && Layout(D, cluster, group).stages >= 2;
}

using Kernel = void (*)(const Params);

Kernel kernel_for(int act) {
  switch (act) {
    case kSilu: return transmlp_bf16_kernel<kSilu>;
    case kRelu: return transmlp_bf16_kernel<kRelu>;
    case kGelu: return transmlp_bf16_kernel<kGelu>;
    case kLrelu: return transmlp_bf16_kernel<kLrelu>;
    case kLrelu01: return transmlp_bf16_kernel<kLrelu01>;
    default: return transmlp_bf16_kernel<kLrelu02>;
  }
}

}  // namespace

// Dynamic shared memory of one CTA, or 0 for a geometry the kernel refuses.
extern "C" long long fused_transmlp_bf16_smem_bytes(int D, int cluster, int group) {
  return shape_ok(D, cluster, group) ? (long long)Layout(D, cluster, group).bytes() : 0;
}

// Clusters of `cluster` CTAs holding `group` sequences at width D the current
// card holds at once (cudaOccupancyMaxActiveClusters), or minus the cudaError_t.
extern "C" int fused_transmlp_bf16_max_clusters(int D, int cluster, int group) {
  if (!shape_ok(D, cluster, group)) return -(int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  cluster_launch_config(&cfg, attr, kT, cluster, cluster, Layout(D, cluster, group).bytes());
  const Kernel kernel = kernel_for(kSilu);  // every instance has the same resources' shape
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)cfg.dynamicSmemBytes);
  int n = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// The bf16 stack as ceil(B / group) clusters of `cluster` CTAs. ln2_s/ln2_b
// null: LN2 folded. ow/ob null: no pose projection, out is [B, S, D].
// Returns a cudaError_t (0: launched).
extern "C" int fused_transmlp_bf16_launch(
    const void* x, const void* emb, const float* ln1_s, const float* ln1_b, const void* tw,
    const float* tb, const float* ln2_s, const float* ln2_b, const void* cw, const float* cb,
    const void* ow, const float* ob, void* out, int B, int S, int D, int L, int F, int act,
    int cluster, int group, void* stream) {
  const bool proj = ow != nullptr;
  if (B < 0 || S < 1 || S > kSPad || !shape_ok(D, cluster, group) || L < 1 || act < kSilu ||
      act > kLrelu02 || (proj && (F < 1 || F > kMaxN || ob == nullptr)) ||
      (ln2_s == nullptr) != (ln2_b == nullptr) || !aligned16(x) || !aligned16(emb) ||
      !aligned16(cw) || !aligned16(ow) || !aligned16(ln1_s) || !aligned16(ln1_b) ||
      !aligned16(ln2_s) || !aligned16(ln2_b) || !aligned16(cb))
    return (int)cudaErrorInvalidValue;
  const Layout lay(D, cluster, group);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  cluster_launch_config(&cfg, attr, kT, (B + group - 1) / group, cluster, lay.bytes());
  const Kernel kernel = kernel_for(act);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)cfg.dynamicSmemBytes);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  Params p{{}, {}, static_cast<const bf16*>(x), static_cast<const bf16*>(emb), ln1_s, ln1_b,
           static_cast<const bf16*>(tw), tb, ln2_s, ln2_b, cb, proj ? ob : nullptr,
           static_cast<bf16*>(out), B, S, D, L, proj ? F : 0, cluster, group};
  if (!weight_map_bf16(&p.cw_map, cw, (long long)L * D, D, lay.srows) ||
      (proj && !weight_map_bf16(&p.ow_map, ow, F, D, lay.srows)))
    return (int)cudaErrorInvalidValue;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The unit check of the wgmma operand path: out [64, n] = a [64, 128] .
// b [n, 128]^T, n in {40, 80}, one warpgroup. Returns a cudaError_t.
extern "C" int fused_transmlp_bf16_wgmma_check(const void* a, const void* b, float* out, int n,
                                               void* stream) {
  if ((n != 40 && n != 80) || !aligned16(a) || !aligned16(b)) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  if (!weight_map_bf16(&map, a, 64, 128, 64)) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * 64 * kRowBytes + 2 * (size_t)n * kRowBytes + 8 + 1024;
  auto kernel = n == 40 ? wgmma_check_kernel<40> : wgmma_check_kernel<80>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(map, static_cast<const bf16*>(b),
                                                             out);
  return (int)cudaGetLastError();
}
