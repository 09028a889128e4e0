// Fused TransMLP stack for NVIDIA Hopper (sm_90a), bf16: one CTA a sequence.
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
// What bounds it: the tensor cores. The products are 98% of the work; at
// TED's serving call (2B = 16, S = 35, D = 512, L = 8, F = 27) that is 2.5
// GFLOP, 2.5 us at the bf16 dense peak of 989 TFLOP/s (H100 SXM, 700 W),
// against 4.4 MB moved, 1.3 us at 3.35 TB/s.
//
// The design (a first, simple one):
// - One CTA of 8 warps a sequence. The bf16 residual x and the bf16
//   normalised rows h stay in shared memory for all L blocks, S padded to
//   whole 16-row tiles (at most 48 rows); padding rows of h are zero and
//   padding rows of x are never written back.
// - The products are mma.sync m16n8k16 bf16 with f32 accumulation. Warp w
//   owns the 8-column tiles w, w + 8, ... of the output (up to 8 tiles, 512
//   columns) over every row tile.
// - Channel mix and pose projection: h @ W^T with W [N, K] (nn.Linear's
//   layout). A lane reads 8 consecutive k of a row of W with one 16-byte
//   load from global memory (ch_w, 4 MB for 8 layers, stays in L2) and
//   8 consecutive k of its rows of h with one 16-byte shared load. The
//   32 k of a chunk are assigned to the two m16n8k16 steps so that a
//   lane's fragments of A and B hold the same k (the sum over k does not
//   depend on which step takes which k). The next chunk's weights are
//   loaded before the current chunk's products.
// - Token mix: token_w @ h, with token_w staged in shared memory and h's
//   fragments read by ldmatrix.trans (K = S padded, zero columns).
// - LayerNorm: a warp a row, two passes in f32 (mean, then the centred sum
//   of squares), a fixed order of sums, so every run gives the same bits.
// One CTA a sequence puts the serving batch (2B = 16) on 16 of 132 SMs; the
// cluster split, TMA ring and wgmma of the f32 kernel are not carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSeq = 36;
constexpr int kMaxRows = 48;         // S padded to whole 16-row tiles
constexpr int kMaxRowTiles = kMaxRows / 16;
constexpr int kMaxDim = 512;         // largest D and F
constexpr int kTiles = kMaxDim / 8 / kWarps;  // 8-column tiles a warp owns
constexpr int kTokStride = kMaxRows + 8;      // token_w's staged rows (bf16)
constexpr float kEps = 1e-5f;

// Activation codes, as ops/fused_mlp.py numbers them (KERNEL_ACT_CODES).
enum Act { kSilu = 0, kRelu = 1, kGelu = 2, kLrelu = 3, kLrelu01 = 4, kLrelu02 = 5 };

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kSilu) return __fdiv_rn(v, __fadd_rn(1.0f, expf(-v)));
  if (act == kRelu) return fmaxf(v, 0.0f);
  if (act == kGelu) {
    // jax.nn.gelu's default: the tanh approximation
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * v * (1.0f + tanhf(c * (v + 0.044715f * v * v * v)));
  }
  const float slope = act == kLrelu ? 0.01f : (act == kLrelu01 ? 0.1f : 0.2f);
  return v > 0.0f ? v : __fmul_rn(slope, v);
}

struct Params {
  const bf16* x;      // [B, S, D]
  const bf16* emb;    // [B, D]
  const float* ln1_s; // [L, D]
  const float* ln1_b;
  const bf16* tw;     // [L, S, S]
  const float* tb;    // [L, S]
  const float* ln2_s; // [L, D], or null: folded
  const float* ln2_b;
  const bf16* cw;     // [L, D_out, D_in]
  const float* cb;    // [L, D]
  const bf16* ow;     // [F, D], or null: no pose projection
  const float* ob;    // [F]
  bf16* out;          // [B, S, F] or [B, S, D]
  int S, D, L, F, act;
};

__host__ __device__ inline int x_stride(int d) { return d + 8; }   // bf16 elements
__host__ __device__ inline int h_stride(int d) { return d + 32; }

__host__ inline size_t smem_bytes(int d) {
  return sizeof(bf16) * ((size_t)kMaxRows * (x_stride(d) + h_stride(d)) +
                         (size_t)kMaxRows * kTokStride + d);
}

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16_rn(v); }
// a + b of two bf16 values: the f32 sum, rounded once
__device__ __forceinline__ bf16 bf_add(bf16 a, float b_rounded) {
  return f2bf(__fadd_rn(bf2f(a), b_rounded));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1, const bf16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
               : "=r"(r0), "=r"(r1) : "r"(a));
}

__device__ __forceinline__ void zero_acc(float (&acc)[kMaxRowTiles][kTiles][4]) {
#pragma unroll
  for (int m = 0; m < kMaxRowTiles; ++m)
#pragma unroll
    for (int i = 0; i < kTiles; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][i][e] = 0.0f;
}

// x += emb (when emb is given), then h = bf16(LN(x)) for the S real rows; a
// warp a row. sc/bi null: no affine (LN2 folded).
__device__ void layer_norm(bf16* xs, bf16* hs, const bf16* es, const float* sc,
                           const float* bi, int S, int D, int warp, int lane) {
  const int xst = x_stride(D), hst = h_stride(D);
  for (int r = warp; r < S; r += kWarps) {
    bf16* xr = xs + r * xst;
    bf16* hr = hs + r * hst;
    float sum = 0.0f;
    for (int c = lane; c < D; c += 32) {
      bf16 v = xr[c];
      if (es != nullptr) {
        v = bf_add(v, bf2f(es[c]));
        xr[c] = v;
      }
      sum += bf2f(v);
    }
    const float mean = __fdiv_rn(warp_sum(sum), (float)D);
    float sq = 0.0f;
    for (int c = lane; c < D; c += 32) {
      const float d = __fsub_rn(bf2f(xr[c]), mean);
      sq = __fadd_rn(sq, __fmul_rn(d, d));
    }
    const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(sq), (float)D), kEps));
    for (int c = lane; c < D; c += 32) {
      float y = __fmul_rn(__fsub_rn(bf2f(xr[c]), mean), rstd);
      if (sc != nullptr) y = __fadd_rn(__fmul_rn(y, sc[c]), bi[c]);
      hr[c] = f2bf(y);
    }
  }
}

// acc = tok @ h over the row tiles: tok [rows, rows] staged (zero past S),
// h [rows, D] in shared memory (zero rows past S).
__device__ void token_product(float (&acc)[kMaxRowTiles][kTiles][4], const bf16* tok,
                              const bf16* hs, int row_tiles, int D, int warp, int lane) {
  const int g = lane >> 2, q = lane & 3, hst = h_stride(D), n_tiles = D / 8;
  zero_acc(acc);
  for (int ks = 0; ks < row_tiles; ++ks) {
    uint32_t a[kMaxRowTiles][4];
#pragma unroll
    for (int m = 0; m < kMaxRowTiles; ++m) {
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
    for (int i = 0; i < kTiles; ++i) {
      const int t = warp + kWarps * i;
      if (t < n_tiles) {
        uint32_t b0, b1;
        ldsm_x2_trans(b0, b1, hs + (ks * 16 + (lane & 15)) * hst + t * 8);
#pragma unroll
        for (int m = 0; m < kMaxRowTiles; ++m)
          if (m < row_tiles) mma(acc[m][i], a[m][0], a[m][1], a[m][2], a[m][3], b0, b1);
      }
    }
  }
}

// A lane's 16-byte slice of row n of W [N, K] at k0, or zeros past N.
__device__ __forceinline__ uint4 load_w16(const bf16* w, int n, int N, int K, int k0) {
  if (n >= N) return make_uint4(0u, 0u, 0u, 0u);
  return __ldg(reinterpret_cast<const uint4*>(w + (size_t)n * K + k0));
}

__device__ __forceinline__ uint2 load_w8(const bf16* w, int n, int N, int K, int k0) {
  if (n >= N) return make_uint2(0u, 0u);
  return __ldg(reinterpret_cast<const uint2*>(w + (size_t)n * K + k0));
}

// acc = a @ W^T over the row tiles: a [rows, K] bf16 in shared memory (row
// stride ast), W [N, K] bf16 in global memory; K a multiple of 16.
__device__ void weight_product(float (&acc)[kMaxRowTiles][kTiles][4], const bf16* as, int ast,
                               const bf16* w, int N, int K, int row_tiles, int warp,
                               int lane) {
  const int g = lane >> 2, q = lane & 3, n_tiles = (N + 7) / 8, k_full = K / 32 * 32;
  zero_acc(acc);
  uint4 cur[kTiles], nxt[kTiles];
  if (k_full > 0) {
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
      const int t = warp + kWarps * i;
      cur[i] = t < n_tiles ? load_w16(w, t * 8 + g, N, K, 8 * q) : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  for (int kc = 0; kc < k_full; kc += 32) {
    if (kc + 32 < k_full) {
#pragma unroll
      for (int i = 0; i < kTiles; ++i) {
        const int t = warp + kWarps * i;
        nxt[i] = t < n_tiles ? load_w16(w, t * 8 + g, N, K, kc + 32 + 8 * q)
                             : make_uint4(0u, 0u, 0u, 0u);
      }
    }
    uint4 a0[kMaxRowTiles], a1[kMaxRowTiles];
#pragma unroll
    for (int m = 0; m < kMaxRowTiles; ++m) {
      if (m < row_tiles) {
        const bf16* p = as + (m * 16 + g) * ast + kc + 8 * q;
        a0[m] = *reinterpret_cast<const uint4*>(p);
        a1[m] = *reinterpret_cast<const uint4*>(p + 8 * ast);
      }
    }
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
      if (warp + kWarps * i < n_tiles) {
#pragma unroll
        for (int m = 0; m < kMaxRowTiles; ++m) {
          if (m < row_tiles) {
            mma(acc[m][i], a0[m].x, a1[m].x, a0[m].y, a1[m].y, cur[i].x, cur[i].y);
            mma(acc[m][i], a0[m].z, a1[m].z, a0[m].w, a1[m].w, cur[i].z, cur[i].w);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kTiles; ++i) cur[i] = nxt[i];
  }
  if (k_full < K) {  // the last 16 k when K % 32 == 16: 4 k a lane
    uint2 a0[kMaxRowTiles], a1[kMaxRowTiles];
#pragma unroll
    for (int m = 0; m < kMaxRowTiles; ++m) {
      if (m < row_tiles) {
        const bf16* p = as + (m * 16 + g) * ast + k_full + 4 * q;
        a0[m] = *reinterpret_cast<const uint2*>(p);
        a1[m] = *reinterpret_cast<const uint2*>(p + 8 * ast);
      }
    }
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
      const int t = warp + kWarps * i;
      if (t < n_tiles) {
        const uint2 b = load_w8(w, t * 8 + g, N, K, k_full + 4 * q);
#pragma unroll
        for (int m = 0; m < kMaxRowTiles; ++m)
          if (m < row_tiles) mma(acc[m][i], a0[m].x, a1[m].x, a0[m].y, a1[m].y, b.x, b.y);
      }
    }
  }
}

// x[r, c] = bf16(x + bf16(act(acc + bias))) for the S real rows; the bias is
// per row (token mix) or per column (channel mix).
__device__ void residual_epilogue(const float (&acc)[kMaxRowTiles][kTiles][4], bf16* xs,
                                  const float* bias, bool row_bias, int S, int D,
                                  int row_tiles, int act, int warp, int lane) {
  const int g = lane >> 2, q = lane & 3, xst = x_stride(D), n_tiles = D / 8;
#pragma unroll
  for (int m = 0; m < kMaxRowTiles; ++m) {
    if (m >= row_tiles) continue;
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
      const int t = warp + kWarps * i;
      if (t >= n_tiles) continue;
      const int c = t * 8 + 2 * q;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m * 16 + g + 8 * half;
        if (r >= S) continue;
        __nv_bfloat162* px = reinterpret_cast<__nv_bfloat162*>(xs + r * xst + c);
        __nv_bfloat162 xv = *px;
        const float b0 = row_bias ? bias[r] : bias[c];
        const float b1 = row_bias ? bias[r] : bias[c + 1];
        const float y0 = bf2f(f2bf(activate(__fadd_rn(acc[m][i][2 * half], b0), act)));
        const float y1 = bf2f(f2bf(activate(__fadd_rn(acc[m][i][2 * half + 1], b1), act)));
        xv.x = bf_add(xv.x, y0);
        xv.y = bf_add(xv.y, y1);
        *px = xv;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) transmlp_bf16_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int S = p.S, D = p.D;
  const int xst = x_stride(D), hst = h_stride(D);
  const int row_tiles = (S + 15) / 16, rows = row_tiles * 16;
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  bf16* hs = xs + kMaxRows * xst;
  bf16* tok = hs + kMaxRows * hst;
  bf16* es = tok + kMaxRows * kTokStride;
  const int b = blockIdx.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16 zero = __ushort_as_bfloat16((unsigned short)0);

  const int vecs = D / 8;  // 16-byte vectors a row
  const bf16* xg = p.x + (size_t)b * S * D;
  for (int i = tid; i < rows * vecs; i += kThreads) {
    const int r = i / vecs, c = (i % vecs) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < S) v = *reinterpret_cast<const uint4*>(xg + (size_t)r * D + c);
    *reinterpret_cast<uint4*>(xs + r * xst + c) = v;
    *reinterpret_cast<uint4*>(hs + r * hst + c) = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int i = tid; i < vecs; i += kThreads)
    *reinterpret_cast<uint4*>(es + i * 8) =
        *reinterpret_cast<const uint4*>(p.emb + (size_t)b * D + i * 8);
  __syncthreads();

  float acc[kMaxRowTiles][kTiles][4];
  for (int l = 0; l < p.L; ++l) {
    const bf16* twl = p.tw + (size_t)l * S * S;
    for (int i = tid; i < rows * rows; i += kThreads) {
      const int r = i / rows, c = i % rows;
      tok[r * kTokStride + c] = (r < S && c < S) ? twl[r * S + c] : zero;
    }
    layer_norm(xs, hs, es, p.ln1_s + (size_t)l * D, p.ln1_b + (size_t)l * D, S, D, warp, lane);
    __syncthreads();
    token_product(acc, tok, hs, row_tiles, D, warp, lane);
    residual_epilogue(acc, xs, p.tb + (size_t)l * S, true, S, D, row_tiles, p.act, warp, lane);
    __syncthreads();
    const bool affine = p.ln2_s != nullptr;
    layer_norm(xs, hs, nullptr, affine ? p.ln2_s + (size_t)l * D : nullptr,
               affine ? p.ln2_b + (size_t)l * D : nullptr, S, D, warp, lane);
    __syncthreads();
    weight_product(acc, hs, hst, p.cw + (size_t)l * D * D, D, D, row_tiles, warp, lane);
    residual_epilogue(acc, xs, p.cb + (size_t)l * D, false, S, D, row_tiles, p.act, warp,
                      lane);
    __syncthreads();
  }

  if (p.ow != nullptr) {
    const int F = p.F, g = lane >> 2, q = lane & 3, n_tiles = (F + 7) / 8;
    weight_product(acc, xs, xst, p.ow, F, D, row_tiles, warp, lane);
    bf16* og = p.out + (size_t)b * S * F;
#pragma unroll
    for (int m = 0; m < kMaxRowTiles; ++m) {
      if (m >= row_tiles) continue;
#pragma unroll
      for (int i = 0; i < kTiles; ++i) {
        const int t = warp + kWarps * i;
        if (t >= n_tiles) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = m * 16 + g + 8 * (e >> 1), c = t * 8 + 2 * q + (e & 1);
          if (r < S && c < F) og[(size_t)r * F + c] = f2bf(__fadd_rn(acc[m][i][e], p.ob[c]));
        }
      }
    }
  } else {
    bf16* og = p.out + (size_t)b * S * D;
    for (int i = tid; i < S * vecs; i += kThreads) {
      const int r = i / vecs, c = (i % vecs) * 8;
      *reinterpret_cast<uint4*>(og + (size_t)r * D + c) =
          *reinterpret_cast<const uint4*>(xs + r * xst + c);
    }
  }
}

}  // namespace

// The bf16 stack. ln2_s/ln2_b null: LN2 folded. ow/ob null (F = 0): no pose
// projection, out is [B, S, D]. Returns a cudaError_t (0: launched).
extern "C" int fused_transmlp_bf16_launch(
    const void* x, const void* emb, const float* ln1_s, const float* ln1_b, const void* tw,
    const float* tb, const float* ln2_s, const float* ln2_b, const void* cw, const float* cb,
    const void* ow, const float* ob, void* out, int B, int S, int D, int L, int F, int act,
    void* stream) {
  const bool proj = ow != nullptr;
  if (B < 0 || S < 1 || S > kMaxSeq || D < 16 || D > kMaxDim || D % 16 != 0 || L < 1 ||
      act < kSilu || act > kLrelu02 || (proj && (F < 1 || F > kMaxDim || ob == nullptr)) ||
      (ln2_s == nullptr) != (ln2_b == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const Params p{static_cast<const bf16*>(x), static_cast<const bf16*>(emb), ln1_s, ln1_b,
                 static_cast<const bf16*>(tw), tb, ln2_s, ln2_b,
                 static_cast<const bf16*>(cw), cb, static_cast<const bf16*>(ow), ob,
                 static_cast<bf16*>(out), S, D, L, proj ? F : 0, act};
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(transmlp_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  transmlp_bf16_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
