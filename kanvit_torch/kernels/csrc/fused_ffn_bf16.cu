// The pre-LN transformer feed-forward on bf16 operands, forward and backward:
//   y = x + relu(LN(x) W1^T + b1) W2^T + b2,
// LN over the last axis with eps 1e-5 and an affine (gamma, beta); torch-
// layout weights W1 (F, D), W2 (D, F); x, y, the weights, the vectors and
// every gradient bf16.
//
// Replaces the TPU kernels of kanvit/kernels/fused_ffn.py on bf16 dots (its
// _dot_dtype, kanvit/kernels/fused_basis.py:759-764, on bf16 x and W1):
//   forward:  _ffn_op (pallas_call at :177, body _ffn_fwd_kernel :62);
//   backward: _ffn_op_bwd (pallas_call at :217, body _ffn_bwd_kernel :80).
// The f32 kernels are fused_ffn.cu's; this file is their bf16 counterpart.
//
// -- Arithmetic (kanvit's bf16 policy, followed exactly): LN statistics and
// LN in f32 from the upcast x, LN rounded to bf16 once; h = bf16(LN) W1^T on
// mma.sync.m16n8k16 bf16 with f32 accumulation (a product of two bf16 is
// exact in f32), + b1 in f32; r = relu(h) rounded to bf16 for the second
// product; y = (r W2^T + b2) + x in f32, rounded once. Backward: LN and h
// recomputed with the forward's bits; dr = g W2, dh = dr [h > 0] in f32;
// r, dh rounded to bf16 where they meet a dot; dln = bf16(dh) W1 in f32; dx
// from the LayerNorm's VJP in f32, rounded once; dW2 = g^T bf16(r), dW1 =
// bf16(dh)^T bf16(LN) in f32 over row splits summed in split order; db1 sums
// the unrounded f32 dh, db2 g, dgamma dln xhat, dbeta dln; each parameter
// gradient rounded to bf16 once. Every product's operands reach the tensor
// cores by ldmatrix from tiles staged with 16-byte cp.async.
//
// What bounds it on the H100: at ViT-S (N = 12,608 rows at batch 64, D 384,
// F 1,536) the forward is 4 N D F = 29.7 GFLOP against 19 MB of x and y (bf16),
// the backward 10 N D F = 74.4 GFLOP: arithmetic, 0.030 and 0.075 ms at the
// 989 TFLOP/s dense bf16 peak, which only wgmma reaches; mma.sync reaches a
// fraction of it. A simple design first: the f32 kernels' tiles and grids with
// bf16 operands, one mma a 16-deep step.
//
// -- Forward, D <= 512 (ffn_fwd_bf16, one launch): a block of 8 warps owns
// BM = 48 rows and all of D (12,608 rows: 263 blocks, two waves at one block
// an SM). LN of its rows in shared memory as bf16 (38 KB at D 384). For each
// chunk of BF = 256 hidden units:
//   h = LN W1c^T + b1, warp w the chunk's units 32w .. 32w+31 of all 48 rows;
//   r = relu(h) rounded to bf16 into shared memory as the next product's A
//   fragments (two n8 tiles of h side by side are one 16-deep A fragment);
//   y_acc += r W2c^T, warp w columns w D/8 .. (w+1) D/8 - 1 of all rows, in
//   registers for the whole kernel.
// W1c's and W2c's tiles, 32 deep, follow each other in one stream,
// double-buffered by cp.async (one barrier a tile). No weight pre-pass: the
// bf16 weights are the mma's operands as they are.
//
// -- Backward, D <= 512: ffn_ln_rows_bf16 (LN as bf16 (N, D) and each row's
// (mean, rstd), the forward's arithmetic); ffn_bwd_hidden_bf16 (a 64-row by
// 128-hidden-unit tile of h = LN W1^T + b1 and dr = g W2, both over D: writes
// r and dh as bf16 and each tile's column sums of the f32 dh for db1);
// ffn_bwd_dx_bf16 (dln = dh W1 for 48 rows and all of D, then dx and the
// block's dgamma, dbeta partials); ffn_dw_bf16 (dW2 = g^T r with db2 as the
// column sums of g, dW1 = dh^T LN: 128 x 128 tiles over row splits into f32
// partials); ffn_sum_parts_bf16 (every partial summed in a fixed order and
// rounded once: no atomics, a second backward gives the same bits).
//
// -- Past D 512 (vit-b's 768, vit-l's 1,024, any D): the forward is
// ffn_ln_rows_bf16, then ffn_gemm_bf16 twice: r = bf16(relu(LN W1^T + b1))
// into device memory, then y = bf16((r W2^T + b2) + x); the backward's dln is
// ffn_gemm_bf16 into f32 device memory and ffn_dx_rows_bf16 takes dx and the
// dgamma, dbeta partials from it. h is the same sum in every kernel that
// makes it (the same LN bits, 32-deep tiles from k = 0, each two mma steps
// into one accumulator), so the forward's ReLU pattern is the backward's.
//
// Rows, D and F past a tile's edge are zero-filled in shared memory. The
// staged operands (W1, W2, g and the scratch) need 16-byte-aligned rows: the
// wrapper passes them at pitches ldd = D and ldf = F rounded up to 8, copying
// an input whose pitch or address is off (zero-padded), and refuses nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tc.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;  // 8 warps
constexpr int BM = 48;        // rows a block of the forward and dx kernels
constexpr int MT = BM / 16;   // their m16 tiles: every warp holds all BM rows
constexpr int KT = 32;        // depth of a staged tile: two mma steps
constexpr int KTP = KT + 8;   // pitch of a (rows, KT) tile: 80 bytes, 8 rows on 8
                              // distinct 16-byte bank groups for ldmatrix
constexpr int BM_H = 64;      // rows a block of the hidden kernel (2 x 4 warps)
constexpr int BN_H = 128;     // hidden units a block of the hidden kernel
constexpr int BW = 128;       // (M, P) tile of the weight-gradient and tiled kernels
constexpr int WP = BW + 8;    // pitch of a (KT, BW) tile: 272 bytes
constexpr float LN_EPS = 1e-5f;
constexpr int FUSED_MAX_D = 512;  // D the fused forward and dx kernels take

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// A row's LayerNorm by one warp: its mean and rstd in f32 (every lane gets
// them) and out[k] = bf16(LN(x)_k) for k < width, zero past d.
__device__ __forceinline__ void ln_row(const bf16* __restrict__ xr,
                                       const bf16* __restrict__ gamma,
                                       const bf16* __restrict__ beta, int d, int width,
                                       int lane, bf16* out, float& mean, float& rstd) {
  float s = 0.f;
  for (int k = lane; k < d; k += 32) s += bf(xr[k]);
  mean = warp_sum(s) / d;
  float v = 0.f;
  for (int k = lane; k < d; k += 32) {
    const float c = bf(xr[k]) - mean;
    v = fmaf(c, c, v);
  }
  rstd = 1.f / sqrtf(warp_sum(v) / d + LN_EPS);
  for (int k = lane; k < width; k += 32)
    out[k] = __float2bfloat16_rn(
        k < d ? fmaf((bf(xr[k]) - mean) * rstd, bf(gamma[k]), bf(beta[k])) : 0.f);
}

// --- ldmatrix fragments ---------------------------------------------------------
//
// m16n8k16 (attention_tc.cuh): A holds (g, 2t..2t+1), (g+8, 2t..2t+1), (g,
// 2t+8..), (g+8, 2t+8..); B (k 2t..2t+1, n g), (k 2t+8.., n g). One ldmatrix
// .x4 loads an A fragment or the B fragments of two n8 tiles; lanes 8q ..
// 8q+7 address the rows of matrix q.

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// The A fragment (rows m0 .. m0+15, k0 .. k0+15) of a tile stored (m, k),
// pitch P.
template <int P>
__device__ __forceinline__ void a_mk(uint32_t (&a)[4], const bf16* tile, int m0, int k0,
                                     int lane) {
  ldsm_x4(a, tile + (m0 + (lane & 15)) * P + k0 + ((lane >> 4) << 3));
}

// The same of a tile stored (k, m).
template <int P>
__device__ __forceinline__ void a_km(uint32_t (&a)[4], const bf16* tile, int m0, int k0,
                                     int lane) {
  ldsm_x4_t(a, tile + (k0 + (lane & 7) + ((lane >> 4) << 3)) * P + m0 +
                   (((lane >> 3) & 1) << 3));
}

// The B fragments of two n8 tiles (n0 .. n0+15; k0 .. k0+15) of a tile
// stored (n, k), pitch P: b[0..1] the first tile's, b[2..3] the second's.
template <int P>
__device__ __forceinline__ void b_nk(uint32_t (&b)[4], const bf16* tile, int n0, int k0,
                                     int lane) {
  ldsm_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * P + k0 +
                 (((lane >> 3) & 1) << 3));
}

// The same of a tile stored (k, n).
template <int P>
__device__ __forceinline__ void b_kn(uint32_t (&b)[4], const bf16* tile, int n0, int k0,
                                     int lane) {
  ldsm_x4_t(b, tile + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * P + n0 +
                   ((lane >> 4) << 3));
}

// d0 += a b[0..1], d1 += a b[2..3]: two n8 tiles of one 16-deep step.
__device__ __forceinline__ void mma_pair(float (&d0)[4], float (&d1)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[4]) {
  const uint32_t lo[2] = {b[0], b[1]}, hi[2] = {b[2], b[3]};
  mma_bf16(d0, a, lo);
  mma_bf16(d1, a, hi);
}

// Rows r0 .. r0+ROWS-1, columns c0 .. c0+COLS-1 of the row-major bf16
// (rows, ld) matrix src into a (ROWS, P) tile by 16-byte cp.async, zero
// outside (rows, ld); ld a multiple of 8.
template <int ROWS, int COLS, int P>
__device__ __forceinline__ void stage(bf16* dst, const bf16* __restrict__ src, int ld,
                                      int rows, int r0, int c0) {
  constexpr int CPR = COLS / 8, CH = ROWS * CPR;  // 16-byte chunks
#pragma unroll
  for (int i = 0; i < (CH + THREADS - 1) / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    if (CH % THREADS != 0 && e >= CH) break;
    const int r = e / CPR, c = (e % CPR) * 8, row = r0 + r, col = c0 + c;
    const bool in = row < rows && col < ld;
    cp_async16(reinterpret_cast<float*>(dst + r * P + c),
               reinterpret_cast<const float*>(in ? src + (long long)row * ld + col : src), in);
  }
}

__device__ __forceinline__ void store_pair(bf16* dst, float a, float b) {
  *reinterpret_cast<uint32_t*>(dst) = pack_bf16(a, b);
}

// --- forward ---------------------------------------------------------------------

template <int JJ>
struct Fwd {
  static constexpr int DP = 128 * JJ;            // D <= DP
  static constexpr int BF = 256;                 // hidden units a chunk
  static constexpr int LNP = DP + 8;             // LN's pitch: 16 bytes mod 128
  static constexpr int RS = BF / 16;             // 16-deep steps of a chunk
  static constexpr int WR = DP > BF ? DP : BF;   // rows of a staged weight tile
  static constexpr int NH = BF / 64;             // n8 tiles of h a warp
  static constexpr int NY = DP / 64;             // n8 tiles of y a warp
  static constexpr size_t SMEM =
      sizeof(bf16) * (BM * LNP + 2 * WR * KTP) + sizeof(uint32_t) * MT * RS * 128;
};

// The forward's stream of weight tiles: for each chunk c0 of hidden units,
// phase 0 walks D (W1c tiles), phase 1 the chunk's hidden units (W2c tiles).
struct Tile {
  int c0, phase, k0;
};

__device__ __forceinline__ Tile next_tile(Tile c, int d, int f, int bf) {
  c.k0 += KT;
  if (c.phase == 0) {
    if (c.k0 >= d) {
      c.phase = 1;
      c.k0 = 0;
    }
  } else if (c.k0 >= bf || c.c0 + c.k0 >= f) {
    c.phase = 0;
    c.k0 = 0;
    c.c0 += bf;
  }
  return c;
}

// One block per BM rows. relu_mask, when not null, gets h > 0 (n, f): the
// ReLU pattern, for a gradient check that holds a reference to the kernel's
// own linear piece. Checks only: the model path passes null.
template <int JJ>
__global__ void __launch_bounds__(THREADS, 1)
ffn_fwd_bf16(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
             const bf16* __restrict__ beta, const bf16* __restrict__ w1,
             const bf16* __restrict__ b1, const bf16* __restrict__ w2,
             const bf16* __restrict__ b2, bf16* __restrict__ y,
             unsigned char* __restrict__ relu_mask, int n, int d, int f, int ldd, int ldf) {
  using S = Fwd<JJ>;
  constexpr int DP = S::DP, BF = S::BF, LNP = S::LNP, RS = S::RS, WR = S::WR;
  constexpr int NH = S::NH, NY = S::NY;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ln = reinterpret_cast<bf16*>(smem);  // (BM, LNP)
  bf16* wt = ln + BM * LNP;                  // 2 x (WR, KTP)
  uint32_t* rs = reinterpret_cast<uint32_t*>(wt + 2 * WR * KTP);  // r: A fragments
  const int wn = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * BM;

  auto fetch = [&](const Tile& c, int buf) {
    bf16* dst = wt + buf * WR * KTP;
    if (c.phase == 0)
      stage<BF, KT, KTP>(dst, w1, ldd, f, c.c0, c.k0);
    else
      stage<DP, KT, KTP>(dst, w2, ldf, d, 0, c.c0 + c.k0);
  };
  Tile cur = {0, 0, 0};
  fetch(cur, 0);
  cp_async_commit();

  for (int r = wn; r < BM; r += THREADS / 32) {
    bf16* lr = ln + r * LNP;
    const int row = r0 + r;
    if (row >= n) {
      for (int k = lane; k < DP; k += 32) lr[k] = __float2bfloat16_rn(0.f);
      continue;
    }
    float mean, rstd;
    ln_row(x + (long long)row * d, gamma, beta, d, DP, lane, lr, mean, rstd);
  }

  float yacc[MT][NY][4], hacc[MT][NH][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NY; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[i][j][e] = 0.f;

  int buf = 0;
  while (cur.c0 < f) {
    const Tile nxt = next_tile(cur, d, f, BF);
    cp_async_wait<0>();
    __syncthreads();  // tile `buf` (and LN, r) visible; tile buf^1 is free
    if (nxt.c0 < f) fetch(nxt, buf ^ 1);
    cp_async_commit();
    const bf16* w = wt + buf * WR * KTP;
    if (cur.phase == 0) {
      if (cur.k0 == 0) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NH; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) hacc[i][j][e] = 0.f;
      }
#pragma unroll
      for (int s = 0; s < KT / 16; ++s) {
        uint32_t a[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) a_mk<LNP>(a[i], ln, 16 * i, cur.k0 + 16 * s, lane);
#pragma unroll
        for (int jp = 0; jp < NH / 2; ++jp) {
          uint32_t b[4];
          b_nk<KTP>(b, w, wn * (BF / 8) + 16 * jp, 16 * s, lane);
#pragma unroll
          for (int i = 0; i < MT; ++i) mma_pair(hacc[i][2 * jp], hacc[i][2 * jp + 1], a[i], b);
        }
      }
      if (nxt.phase == 1) {
        // The chunk's h is complete: r = relu(h + b1) rounded to bf16 into
        // shared memory as the A fragments of the next product. This
        // thread's two n8 tiles 2jp, 2jp+1 are, packed, its A fragment of
        // the chunk's step 2 wn + jp.
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int jp = 0; jp < NH / 2; ++jp) {
            float rv[2][4];
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              const int c = cur.c0 + wn * (BF / 8) + 8 * (2 * jp + h2) + 2 * t;
              const bool in0 = c < f, in1 = c + 1 < f;
              const float bias0 = in0 ? bf(b1[c]) : 0.f, bias1 = in1 ? bf(b1[c + 1]) : 0.f;
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float hv = hacc[i][2 * jp + h2][e] + (e & 1 ? bias1 : bias0);
                const bool in = e & 1 ? in1 : in0;
                rv[h2][e] = in ? fmaxf(hv, 0.f) : 0.f;
                const int row = r0 + 16 * i + 8 * (e >> 1) + g;
                if (relu_mask != nullptr && row < n && in)
                  relu_mask[(long long)row * f + c + (e & 1)] = hv > 0.f;
              }
            }
            const uint4 frag = make_uint4(pack_bf16(rv[0][0], rv[0][1]), pack_bf16(rv[0][2], rv[0][3]),
                                          pack_bf16(rv[1][0], rv[1][1]), pack_bf16(rv[1][2], rv[1][3]));
            *reinterpret_cast<uint4*>(rs + ((i * RS + wn * (NH / 2) + jp) * 32 + lane) * 4) = frag;
          }
      }
    } else {
#pragma unroll
      for (int s = 0; s < KT / 16; ++s) {
        const int step = cur.k0 / 16 + s;
        uint32_t a[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const uint4 v = *reinterpret_cast<const uint4*>(rs + ((i * RS + step) * 32 + lane) * 4);
          a[i][0] = v.x;
          a[i][1] = v.y;
          a[i][2] = v.z;
          a[i][3] = v.w;
        }
#pragma unroll
        for (int jp = 0; jp < NY / 2; ++jp) {
          uint32_t b[4];
          b_nk<KTP>(b, w, wn * (DP / 8) + 16 * jp, 16 * s, lane);
#pragma unroll
          for (int i = 0; i < MT; ++i) mma_pair(yacc[i][2 * jp], yacc[i][2 * jp + 1], a[i], b);
        }
      }
    }
    cur = nxt;
    buf ^= 1;
  }

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + 16 * i + 8 * hh + g;
      if (row >= n) continue;
#pragma unroll
      for (int j = 0; j < NY; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = wn * (DP / 8) + 8 * j + 2 * t + e;
          if (col < d) {
            const long long o = (long long)row * d + col;
            y[o] = __float2bfloat16_rn((yacc[i][j][2 * hh + e] + bf(b2[col])) + bf(x[o]));
          }
        }
    }
}

// --- backward --------------------------------------------------------------------

// LN(x) as bf16 into ln (n, ldd), zero past d, and each row's (mean, rstd)
// into stats (n, 2); one warp a row, the forward's arithmetic.
__global__ void __launch_bounds__(THREADS)
ffn_ln_rows_bf16(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                 const bf16* __restrict__ beta, bf16* __restrict__ ln,
                 float* __restrict__ stats, int n, int d, int ldd) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (row >= n) return;
  float mean, rstd;
  ln_row(x + row * d, gamma, beta, d, ldd, lane, ln + row * ldd, mean, rstd);
  if (lane == 0) {
    stats[2 * row] = mean;
    stats[2 * row + 1] = rstd;
  }
}

// A stage of the hidden kernel (bf16 values): LN and g (BM_H, KTP), W1's
// hidden units (BN_H, KTP) stored (n, k), W2's (KT, WP) stored (k, n).
constexpr int H_STAGE = 2 * BM_H * KTP + BN_H * KTP + KT * WP;
constexpr size_t H_SMEM = sizeof(bf16) * 2 * H_STAGE + sizeof(float) * 2 * BN_H;

// h = LN W1^T + b1 and dr = g W2 over a (BM_H rows, BN_H hidden units) tile,
// both contracting over D; writes r = bf16(relu(h)) and dh = bf16(dr [h > 0])
// (n, ldf), zero at hidden units past f, and the tile's column sums of the
// f32 dh into db1_part[blockIdx.x] (f): this thread's rows, its warp's 8
// row groups, then the two row warps in order. Warp (wm, wn) rows 32 wm ..,
// hidden units 32 wn ...
__global__ void __launch_bounds__(THREADS, 2)
ffn_bwd_hidden_bf16(const bf16* __restrict__ ln, const bf16* __restrict__ g,
                    const bf16* __restrict__ w1, const bf16* __restrict__ w2,
                    const bf16* __restrict__ b1, bf16* __restrict__ r,
                    bf16* __restrict__ dh, float* __restrict__ db1_part, int n, int d, int f,
                    int ldd, int ldf) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* st = reinterpret_cast<bf16*>(smem);
  float* red = reinterpret_cast<float*>(st + 2 * H_STAGE);  // (2, BN_H)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3, wm = warp >> 2, wn = warp & 3;
  const int r0 = blockIdx.x * BM_H, n0 = blockIdx.y * BN_H;

  auto stage_k = [&](int kt, int buf) {
    bf16* s = st + buf * H_STAGE;
    const int k0 = kt * KT;
    stage<BM_H, KT, KTP>(s, ln, ldd, n, r0, k0);
    stage<BM_H, KT, KTP>(s + BM_H * KTP, g, ldd, n, r0, k0);
    stage<BN_H, KT, KTP>(s + 2 * BM_H * KTP, w1, ldd, f, n0, k0);
    stage<KT, BN_H, WP>(s + 2 * BM_H * KTP + BN_H * KTP, w2, ldf, d, k0, n0);
  };

  float hacc[2][4][4], dracc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) hacc[i][j][e] = dracc[i][j][e] = 0.f;

  const int kt_n = (d + KT - 1) / KT;
  stage_k(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<0>();
    __syncthreads();  // stage kt landed; stage kt+1's buffer is free
    if (kt + 1 < kt_n) stage_k(kt + 1, (kt + 1) & 1);
    cp_async_commit();
    const bf16* s = st + (kt & 1) * H_STAGE;
    const bf16 *lnt = s, *gt = s + BM_H * KTP, *w1t = s + 2 * BM_H * KTP;
    const bf16* w2t = w1t + BN_H * KTP;
#pragma unroll
    for (int s16 = 0; s16 < KT / 16; ++s16) {
      uint32_t a[2][4], b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) a_mk<KTP>(a[i], lnt, 32 * wm + 16 * i, 16 * s16, lane);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        b_nk<KTP>(b, w1t, 32 * wn + 16 * jp, 16 * s16, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_pair(hacc[i][2 * jp], hacc[i][2 * jp + 1], a[i], b);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) a_mk<KTP>(a[i], gt, 32 * wm + 16 * i, 16 * s16, lane);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        b_kn<WP>(b, w2t, 32 * wn + 16 * jp, 16 * s16, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_pair(dracc[i][2 * jp], dracc[i][2 * jp + 1], a[i], b);
      }
    }
  }

  float cs[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    cs[j][0] = cs[j][1] = 0.f;
    const int col = n0 + 32 * wn + 8 * j + 2 * t;  // even; ldf % 8 == 0
    const float bias0 = col < f ? bf(b1[col]) : 0.f, bias1 = col + 1 < f ? bf(b1[col + 1]) : 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = r0 + 32 * wm + 16 * i + 8 * hh + gq;
        if (row >= n) continue;
        const float h0 = hacc[i][j][2 * hh] + bias0, h1 = hacc[i][j][2 * hh + 1] + bias1;
        const float d0 = h0 > 0.f ? dracc[i][j][2 * hh] : 0.f;
        const float d1 = h1 > 0.f ? dracc[i][j][2 * hh + 1] : 0.f;
        cs[j][0] += d0;
        cs[j][1] += d1;
        if (col < ldf) {
          const long long o = (long long)row * ldf + col;
          store_pair(r + o, fmaxf(h0, 0.f), fmaxf(h1, 0.f));
          store_pair(dh + o, d0, d1);
        }
      }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = cs[j][e];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (gq == 0) red[wm * BN_H + 32 * wn + 8 * j + 2 * t + e] = v;
    }
  __syncthreads();
  if (threadIdx.x < BN_H && n0 + (int)threadIdx.x < f)
    db1_part[(long long)blockIdx.x * f + n0 + threadIdx.x] =
        red[threadIdx.x] + red[BN_H + threadIdx.x];
}

template <int JJ>
struct Dx {
  static constexpr int DP = 128 * JJ;
  static constexpr int WPD = DP + 8;                   // W1 tile's pitch
  static constexpr int STAGE = BM * KTP + KT * WPD;    // dh (m, k), W1 (k, n)
  static constexpr int NY = DP / 64;                   // n8 tiles of dln a warp
  static constexpr size_t SMEM = sizeof(bf16) * 2 * STAGE;
};

// dln = dh W1 for BM rows and all of D, contracting over F (dh bf16 (n,
// ldf), W1 bf16 (f, ldd) staged (k, n)); then dx = bf16(g + rstd (gs -
// mean gs - xhat mean(gs xhat))), gs = dln gamma, and the block's dgamma,
// dbeta partials dgb_part[block] (2, d) in f32. Warp w holds all BM rows and
// columns w DP/8 .. (w+1) DP/8 - 1.
template <int JJ>
__global__ void __launch_bounds__(THREADS, 1)
ffn_bwd_dx_bf16(const bf16* __restrict__ dh, const bf16* __restrict__ w1,
                const bf16* __restrict__ x, const bf16* __restrict__ g,
                const bf16* __restrict__ gamma, const float* __restrict__ stats,
                bf16* __restrict__ dx, float* __restrict__ dgb_part, int n, int d, int f,
                int ldd, int ldf) {
  using S = Dx<JJ>;
  constexpr int DP = S::DP, WPD = S::WPD, STAGE = S::STAGE, NY = S::NY;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* st = reinterpret_cast<bf16*>(smem);
  const int wn = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * BM;

  auto stage_k = [&](int kt, int buf) {
    bf16* s = st + buf * STAGE;
    stage<BM, KT, KTP>(s, dh, ldf, n, r0, kt * KT);
    stage<KT, DP, WPD>(s + BM * KTP, w1, ldd, f, kt * KT, 0);
  };

  float acc[MT][NY][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NY; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int kt_n = (f + KT - 1) / KT;
  stage_k(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<0>();
    __syncthreads();
    if (kt + 1 < kt_n) stage_k(kt + 1, (kt + 1) & 1);
    cp_async_commit();
    const bf16* s = st + (kt & 1) * STAGE;
#pragma unroll
    for (int s16 = 0; s16 < KT / 16; ++s16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) a_mk<KTP>(a[i], s, 16 * i, 16 * s16, lane);
#pragma unroll
      for (int jp = 0; jp < NY / 2; ++jp) {
        uint32_t b[4];
        b_kn<WPD>(b, s + BM * KTP, wn * (DP / 8) + 16 * jp, 16 * s16, lane);
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_pair(acc[i][2 * jp], acc[i][2 * jp + 1], a[i], b);
      }
    }
  }
  __syncthreads();  // the stages are free

  // The rows' sums of gs = dln gamma and gs xhat: this thread's columns,
  // its quad, then the eight warps in order.
  float* red = reinterpret_cast<float*>(smem);  // (8, BM, 2)
  float mean[MT][2], rstd[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int rr = 16 * i + 8 * hh + gq, row = r0 + rr;
      const bool live = row < n;
      mean[i][hh] = live ? stats[2LL * row] : 0.f;
      rstd[i][hh] = live ? stats[2LL * row + 1] : 0.f;
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int j = 0; j < NY; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = wn * (DP / 8) + 8 * j + 2 * t + e;
          if (live && col < d) {
            const float xh = (bf(x[(long long)row * d + col]) - mean[i][hh]) * rstd[i][hh];
            const float gs = acc[i][j][2 * hh + e] * bf(gamma[col]);
            s1 += gs;
            s2 = fmaf(gs, xh, s2);
          }
        }
      s1 = quad_sum(s1);
      s2 = quad_sum(s2);
      if (t == 0) {
        red[(wn * BM + rr) * 2] = s1;
        red[(wn * BM + rr) * 2 + 1] = s2;
      }
    }
  __syncthreads();
  float m1[MT][2], m2[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int rr = 16 * i + 8 * hh + gq;
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int w = 0; w < THREADS / 32; ++w) {
        s1 += red[(w * BM + rr) * 2];
        s2 += red[(w * BM + rr) * 2 + 1];
      }
      m1[i][hh] = s1 / d;
      m2[i][hh] = s2 / d;
    }

  // dx, and dgamma, dbeta over the block's rows: this thread's rows, then
  // the 8 row groups of its quad column (shuffles).
  float* part = dgb_part + (long long)blockIdx.x * 2 * d;
#pragma unroll
  for (int j = 0; j < NY; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = wn * (DP / 8) + 8 * j + 2 * t + e;
      float pg = 0.f, pb = 0.f;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = r0 + 16 * i + 8 * hh + gq;
          if (row < n && col < d) {
            const long long o = (long long)row * d + col;
            const float dln = acc[i][j][2 * hh + e];
            const float xh = (bf(x[o]) - mean[i][hh]) * rstd[i][hh];
            const float gs = dln * bf(gamma[col]);
            dx[o] = __float2bfloat16_rn(bf(g[(long long)row * ldd + col]) +
                                        rstd[i][hh] * (gs - m1[i][hh] - xh * m2[i][hh]));
            pg = fmaf(dln, xh, pg);
            pb += dln;
          }
        }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        pg += __shfl_xor_sync(0xffffffffu, pg, off);
        pb += __shfl_xor_sync(0xffffffffu, pb, off);
      }
      if (gq == 0 && col < d) {
        part[col] = pg;
        part[d + col] = pb;
      }
    }
}

constexpr int DW_STAGE = 2 * KT * WP;  // A and B, (KT, WP) each, stored (k, m) and (k, p)
constexpr size_t DW_SMEM = sizeof(bf16) * 2 * DW_STAGE;

// out (m, p) [of split blockIdx.z] = sum over that split's rows of
// a[row][m] b[row][p] in f32; a (n, lda), b (n, ldb) bf16 row-major. With
// colsum not null, blocks with blockIdx.x == 0 also write the split's
// column sums of a, colsum (m). Warp tile 64 (m) x 32 (p) of the BW x BW
// block tile.
__global__ void __launch_bounds__(THREADS, 2)
ffn_dw_bf16(const bf16* __restrict__ a, const bf16* __restrict__ b, float* __restrict__ out,
            float* __restrict__ colsum, int n, int m, int p, int lda, int ldb,
            int rows_per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* st = reinterpret_cast<bf16*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3, wm = warp >> 2, wn = warp & 3;
  const int p0 = blockIdx.x * BW, m0 = blockIdx.y * BW, split = blockIdx.z;
  const int lo = split * rows_per_split, hi = min(n, lo + rows_per_split);
  const bool sums = colsum != nullptr && blockIdx.x == 0 && threadIdx.x < BW;

  auto stage_k = [&](int k0, int buf) {
    bf16* s = st + buf * DW_STAGE;
    stage<KT, BW, WP>(s, a, lda, hi, k0, m0);
    stage<KT, BW, WP>(s + KT * WP, b, ldb, hi, k0, p0);
  };

  float acc[4][4][4], cs = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  if (lo < hi) stage_k(lo, 0);
  cp_async_commit();
  int it = 0;
  for (int k0 = lo; k0 < hi; k0 += KT, ++it) {
    cp_async_wait<0>();
    __syncthreads();
    if (k0 + KT < hi) stage_k(k0 + KT, (it + 1) & 1);
    cp_async_commit();
    const bf16* s = st + (it & 1) * DW_STAGE;
    if (sums) {
#pragma unroll 8
      for (int kk = 0; kk < KT; ++kk) cs += bf(s[kk * WP + threadIdx.x]);
    }
#pragma unroll
    for (int s16 = 0; s16 < KT / 16; ++s16) {
      uint32_t af[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a_km<WP>(af[i], s, 64 * wm + 16 * i, 16 * s16, lane);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t bfr[4];
        b_kn<WP>(bfr, s + KT * WP, 32 * wn + 16 * jp, 16 * s16, lane);
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_pair(acc[i][2 * jp], acc[i][2 * jp + 1], af[i], bfr);
      }
    }
  }

  float* dst = out + (long long)split * m * p;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int mm = m0 + 64 * wm + 16 * i + 8 * hh + gq;
      if (mm >= m) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int pp = p0 + 32 * wn + 8 * j + 2 * t + e;
          if (pp < p) dst[(long long)mm * p + pp] = acc[i][j][2 * hh + e];
        }
    }
  if (sums && m0 + (int)threadIdx.x < m)
    colsum[(long long)split * m + m0 + threadIdx.x] = cs;
}

// --- past D 512 ----------------------------------------------------------------

enum { EPI_RELU, EPI_RESID, EPI_RAW };

template <bool KN>
struct Gemm {
  static constexpr int B_TILE = KN ? KT * WP : BW * KTP;
  static constexpr int STAGE = BW * KTP + B_TILE;
  static constexpr size_t SMEM = sizeof(bf16) * 2 * STAGE;
};

// c = a B over k for rows < n: a (n, lda) bf16 row-major (zero past k); B(k,
// c) = b[c][k] of a (p, ldb) matrix (KN false: W1 for h, W2 for y) or
// b[k][c] of a (k, ldb) matrix (KN true: W1 for dln). Epilogue:
//   EPI_RELU:  c (n, ldc) bf16 = bf16(relu(acc + bias)), zero at columns
//              p .. ldc - 1, and relu_mask (n, p) = acc + bias > 0 where not
//              null;
//   EPI_RESID: c (n, p) bf16 = bf16((acc + bias) + resid), resid (n, p) bf16;
//   EPI_RAW:   c (n, ldc) f32 = acc at columns < ldc.
// A block: 128 rows x 128 columns, 2 x 4 warps of 64 x 32.
template <int EPI, bool KN>
__global__ void __launch_bounds__(THREADS, 2)
ffn_gemm_bf16(const bf16* __restrict__ a, const bf16* __restrict__ b,
              const bf16* __restrict__ bias, const bf16* __restrict__ resid, void* c,
              unsigned char* __restrict__ relu_mask, int n, int k, int p, int lda, int ldb,
              int ldc) {
  using S = Gemm<KN>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* st = reinterpret_cast<bf16*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3, wm = warp >> 2, wn = warp & 3;
  const int r0 = blockIdx.y * BW, n0 = blockIdx.x * BW;

  auto stage_k = [&](int kt, int buf) {
    bf16* s = st + buf * S::STAGE;
    stage<BW, KT, KTP>(s, a, lda, n, r0, kt * KT);
    if constexpr (KN)
      stage<KT, BW, WP>(s + BW * KTP, b, ldb, k, kt * KT, n0);
    else
      stage<BW, KT, KTP>(s + BW * KTP, b, ldb, p, n0, kt * KT);
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int kt_n = (k + KT - 1) / KT;
  stage_k(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<0>();
    __syncthreads();
    if (kt + 1 < kt_n) stage_k(kt + 1, (kt + 1) & 1);
    cp_async_commit();
    const bf16* s = st + (kt & 1) * S::STAGE;
    const bf16* sb = s + BW * KTP;
#pragma unroll
    for (int s16 = 0; s16 < KT / 16; ++s16) {
      uint32_t af[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a_mk<KTP>(af[i], s, 64 * wm + 16 * i, 16 * s16, lane);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t bfr[4];
        if constexpr (KN)
          b_kn<WP>(bfr, sb, 32 * wn + 16 * jp, 16 * s16, lane);
        else
          b_nk<KTP>(bfr, sb, 32 * wn + 16 * jp, 16 * s16, lane);
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_pair(acc[i][2 * jp], acc[i][2 * jp + 1], af[i], bfr);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + 32 * wn + 8 * j + 2 * t;  // even
    if (col >= (EPI == EPI_RESID ? p : ldc)) continue;
    float bias0 = 0.f, bias1 = 0.f;
    if constexpr (EPI != EPI_RAW) {
      bias0 = col < p ? bf(bias[col]) : 0.f;
      bias1 = col + 1 < p ? bf(bias[col + 1]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = r0 + 64 * wm + 16 * i + 8 * hh + gq;
        if (row >= n) continue;
        const float v0 = acc[i][j][2 * hh], v1 = acc[i][j][2 * hh + 1];
        if constexpr (EPI == EPI_RELU) {  // ldc % 8 == 0: col + 1 < ldc
          const float h0 = v0 + bias0, h1 = v1 + bias1;
          store_pair(static_cast<bf16*>(c) + (long long)row * ldc + col,
                     col < p ? fmaxf(h0, 0.f) : 0.f, col + 1 < p ? fmaxf(h1, 0.f) : 0.f);
          if (relu_mask != nullptr) {
            const long long mo = (long long)row * p + col;
            if (col < p) relu_mask[mo] = h0 > 0.f;
            if (col + 1 < p) relu_mask[mo + 1] = h1 > 0.f;
          }
        } else if constexpr (EPI == EPI_RESID) {
          bf16* out = static_cast<bf16*>(c);
          const long long o = (long long)row * p + col;
          out[o] = __float2bfloat16_rn((v0 + bias0) + bf(resid[o]));
          if (col + 1 < p) out[o + 1] = __float2bfloat16_rn((v1 + bias1) + bf(resid[o + 1]));
        } else {  // ldc % 8 == 0
          *reinterpret_cast<float2*>(static_cast<float*>(c) + (long long)row * ldc + col) =
              make_float2(v0, v1);
        }
      }
  }
}

// dx and the block's dgamma, dbeta partials dgb_part[block] (2, d) from the
// f32 dln (n, ldd), past D 512: one block per BM rows, as ffn_bwd_dx_bf16's.
// The rows' means of gs = dln gamma and gs xhat, one warp a row, then a
// thread a column over the block's rows.
__global__ void __launch_bounds__(THREADS)
ffn_dx_rows_bf16(const float* __restrict__ dln, const bf16* __restrict__ x,
                 const bf16* __restrict__ g, const bf16* __restrict__ gamma,
                 const float* __restrict__ stats, bf16* __restrict__ dx,
                 float* __restrict__ dgb_part, int n, int d, int ldd) {
  __shared__ float m1[BM], m2[BM];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * BM;
  for (int rr = warp; rr < BM; rr += THREADS / 32) {
    const long long row = r0 + rr;
    float s1 = 0.f, s2 = 0.f;
    if (row < n) {
      const float mean = stats[2 * row], rstd = stats[2 * row + 1];
      for (int col = lane; col < d; col += 32) {
        const float gs = dln[row * ldd + col] * bf(gamma[col]);
        s1 += gs;
        s2 = fmaf(gs, (bf(x[row * d + col]) - mean) * rstd, s2);
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
    }
    if (lane == 0) {
      m1[rr] = s1 / d;
      m2[rr] = s2 / d;
    }
  }
  __syncthreads();
  float* part = dgb_part + (long long)blockIdx.x * 2 * d;
  for (int col = threadIdx.x; col < d; col += THREADS) {
    const float gm = bf(gamma[col]);
    float pg = 0.f, pb = 0.f;
    for (int rr = 0; rr < BM && r0 + rr < n; ++rr) {
      const long long row = r0 + rr;
      const float mean = stats[2 * row], rstd = stats[2 * row + 1];
      const float dl = dln[row * ldd + col];
      const float xh = (bf(x[row * d + col]) - mean) * rstd;
      dx[row * d + col] = __float2bfloat16_rn(bf(g[row * ldd + col]) +
                                              rstd * (dl * gm - m1[rr] - xh * m2[rr]));
      pg = fmaf(dl, xh, pg);
      pb += dl;
    }
    part[col] = pg;
    part[d + col] = pb;
  }
}

// out[e] = bf16(sum over s < parts of part[s * total + e], in order of s).
__global__ void ffn_sum_parts_bf16(const float* __restrict__ part, bf16* __restrict__ out,
                                   long long total, int parts) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int q = 0; q < parts; ++q) s += part[q * total + e];
    out[e] = __float2bfloat16_rn(s);
  }
}

int sum_parts(const float* part, bf16* out, long long total, int parts, cudaStream_t st) {
  const long long blocks = (total + 255) / 256;
  ffn_sum_parts_bf16<<<(unsigned)min(blocks, 4096LL), 256, 0, st>>>(part, out, total, parts);
  return (int)cudaGetLastError();
}

template <class K>
int prepare(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <int JJ>
int launch_fwd(const bf16* x, const bf16* gamma, const bf16* beta, const bf16* w1,
               const bf16* b1, const bf16* w2, const bf16* b2, bf16* y,
               unsigned char* relu_mask, int n, int d, int f, int ldd, int ldf,
               cudaStream_t st) {
  const size_t smem = Fwd<JJ>::SMEM;
  int err = prepare(ffn_fwd_bf16<JJ>, smem);
  if (err != 0) return err;
  ffn_fwd_bf16<JJ><<<(n + BM - 1) / BM, THREADS, smem, st>>>(
      x, gamma, beta, w1, b1, w2, b2, y, relu_mask, n, d, f, ldd, ldf);
  return (int)cudaGetLastError();
}

template <int JJ>
int launch_dx(const bf16* dh, const bf16* w1, const bf16* x, const bf16* g,
              const bf16* gamma, const float* stats, bf16* dx, float* dgb_part, int n,
              int d, int f, int ldd, int ldf, cudaStream_t st) {
  const size_t smem = Dx<JJ>::SMEM;
  int err = prepare(ffn_bwd_dx_bf16<JJ>, smem);
  if (err != 0) return err;
  ffn_bwd_dx_bf16<JJ><<<(n + BM - 1) / BM, THREADS, smem, st>>>(
      dh, w1, x, g, gamma, stats, dx, dgb_part, n, d, f, ldd, ldf);
  return (int)cudaGetLastError();
}

// dW (m, p) rounded to bf16, over `splits` row splits of f32 partials summed
// in split order; with dcol not null also the column sums of a, the same way.
int weight_grad(const bf16* a, const bf16* b, bf16* dw, bf16* dcol, float* dw_part,
                float* col_part, int n, int m, int p, int lda, int ldb, int splits,
                cudaStream_t st) {
  const int per = (n + splits - 1) / splits;
  const dim3 grid((p + BW - 1) / BW, (m + BW - 1) / BW, splits);
  ffn_dw_bf16<<<grid, THREADS, DW_SMEM, st>>>(a, b, dw_part, dcol ? col_part : nullptr, n, m,
                                              p, lda, ldb, per);
  int err = (int)cudaGetLastError();
  if (err == 0) err = sum_parts(dw_part, dw, (long long)m * p, splits, st);
  if (err == 0 && dcol != nullptr) err = sum_parts(col_part, dcol, m, splits, st);
  return err;
}

bool bad_layout(const bf16* w1, const bf16* w2, int d, int f, int ldd, int ldf) {
  return ldd < d || ldf < f || ldd % 8 != 0 || ldf % 8 != 0 ||
         ((uintptr_t)w1 | (uintptr_t)w2) % 16 != 0;
}

// ffn_gemm_bf16 over n rows and ceil(p / BW) column tiles.
template <int EPI, bool KN>
int gemm(const bf16* a, const bf16* b, const bf16* bias, const bf16* resid, void* c,
         unsigned char* relu_mask, int n, int k, int p, int lda, int ldb, int ldc,
         cudaStream_t st) {
  const int row_tiles = (n + BW - 1) / BW;
  if (row_tiles > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = Gemm<KN>::SMEM;
  int err = prepare(ffn_gemm_bf16<EPI, KN>, smem);
  if (err != 0) return err;
  const int cols = EPI == EPI_RESID ? p : ldc;
  ffn_gemm_bf16<EPI, KN><<<dim3((cols + BW - 1) / BW, row_tiles), THREADS, smem, st>>>(
      a, b, bias, resid, c, relu_mask, n, k, p, lda, ldb, ldc);
  return (int)cudaGetLastError();
}

int ln_rows(const bf16* x, const bf16* gamma, const bf16* beta, bf16* ln, float* stats, int n,
            int d, int ldd, cudaStream_t st) {
  ffn_ln_rows_bf16<<<(n + THREADS / 32 - 1) / (THREADS / 32), THREADS, 0, st>>>(
      x, gamma, beta, ln, stats, n, d, ldd);
  return (int)cudaGetLastError();
}

}  // namespace

// The D tiers of the fused forward and dx kernels: D <= 128 * jj.
#define KANVIT_FFN_BF16_JJ(X) X(1) X(2) X(3) X(4)

// Forward, bf16. x (n, d), y (n, d); gamma, beta, b2 (d); w1 (f, ldd) and w2
// (d, ldf) row-major, 16-byte aligned, zero in the pad columns (ldd, ldf: d
// and f rounded up to 8); b1 (f); 1 <= d <= 512; relu_mask (n, f) uint8,
// h > 0, or null. Launches on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int kanvit_ffn_fwd_bf16(const bf16* x, const bf16* gamma, const bf16* beta,
                                   const bf16* w1, const bf16* b1, const bf16* w2,
                                   const bf16* b2, bf16* y, unsigned char* relu_mask, int n,
                                   int d, int f, int ldd, int ldf, void* stream) {
  if (n <= 0 || d <= 0 || f <= 0 || bad_layout(w1, w2, d, f, ldd, ldf))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define KANVIT_CASE(J)                                                                \
  if (d <= 128 * J)                                                                   \
    return launch_fwd<J>(x, gamma, beta, w1, b1, w2, b2, y, relu_mask, n, d, f, ldd, ldf, \
                         st);
  KANVIT_FFN_BF16_JJ(KANVIT_CASE)
#undef KANVIT_CASE
  return (int)cudaErrorInvalidValue;
}

// Forward past D 512 (any d >= 1), bf16: as kanvit_ffn_fwd_bf16, through
// scratch ln (n, ldd) bf16, stats (n, 2) f32 and r (n, ldf) bf16, 16-byte
// aligned.
extern "C" int kanvit_ffn_fwd_wide_bf16(const bf16* x, const bf16* gamma, const bf16* beta,
                                        const bf16* w1, const bf16* b1, const bf16* w2,
                                        const bf16* b2, bf16* y, unsigned char* relu_mask,
                                        bf16* ln, float* stats, bf16* r, int n, int d, int f,
                                        int ldd, int ldf, void* stream) {
  if (n <= 0 || d <= 0 || f <= 0 || bad_layout(w1, w2, d, f, ldd, ldf) ||
      ((uintptr_t)ln | (uintptr_t)r) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int err = ln_rows(x, gamma, beta, ln, stats, n, d, ldd, st);
  if (err == 0)
    err = gemm<EPI_RELU, false>(ln, w1, b1, nullptr, r, relu_mask, n, d, f, ldd, ldd, ldf, st);
  if (err == 0)
    err = gemm<EPI_RESID, false>(r, w2, b2, x, y, nullptr, n, f, d, ldf, ldf, 0, st);
  return err;
}

// Backward of kanvit_ffn_fwd_bf16 and kanvit_ffn_fwd_wide_bf16. x (n, d); g
// (n, ldd), the gradient of y, and w1 (f, ldd), w2 (d, ldf) as the forward
// takes them; b1 (f), gamma, beta (d); all bf16. Writes, in bf16, dx (n, d),
// dgb (2, d) = (dgamma, dbeta), dw1 (f, d), db1 (f), dw2 (d, f), db2 (d).
// Scratch: ln (n, ldd) bf16, stats (n, 2) f32, r and dh (n, ldf) bf16,
// dgb_part (ceil(n / 48), 2, d) f32, db1_part (ceil(n / 64), f) f32; past
// D 512 also dln (n, ldd) f32 (null at d <= 512); dw1_part (splits, f, d),
// dw2_part (splits, d, f), db2_part (splits, d) f32. The staged scratch
// 16-byte aligned, d >= 1, splits >= 1. Launches the LN pass, the hidden, dx
// and weight-gradient kernels and the fixed-order sums on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int kanvit_ffn_bwd_bf16(const bf16* x, const bf16* g, const bf16* gamma,
                                   const bf16* beta, const bf16* w1, const bf16* w2,
                                   const bf16* b1, bf16* dx, bf16* dgb, bf16* dw1, bf16* db1,
                                   bf16* dw2, bf16* db2, bf16* ln, float* stats, bf16* r,
                                   bf16* dh, float* dgb_part, float* db1_part, float* dln,
                                   float* dw1_part, float* dw2_part, float* db2_part, int n,
                                   int d, int f, int ldd, int ldf, int splits, void* stream) {
  const int h_tiles = (f + BN_H - 1) / BN_H;
  if (n <= 0 || d <= 0 || f <= 0 || splits < 1 || splits > 65535 || h_tiles > 65535 ||
      bad_layout(w1, w2, d, f, ldd, ldf) ||
      ((uintptr_t)g | (uintptr_t)ln | (uintptr_t)r | (uintptr_t)dh | (uintptr_t)dln) % 16 != 0 ||
      (d > FUSED_MAX_D && dln == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int row_blocks = (n + BM - 1) / BM, h_blocks = (n + BM_H - 1) / BM_H;
  int err = ln_rows(x, gamma, beta, ln, stats, n, d, ldd, st);
  if (err != 0) return err;
  err = prepare(ffn_bwd_hidden_bf16, H_SMEM);
  if (err != 0) return err;
  ffn_bwd_hidden_bf16<<<dim3(h_blocks, h_tiles), THREADS, H_SMEM, st>>>(
      ln, g, w1, w2, b1, r, dh, db1_part, n, d, f, ldd, ldf);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  if (d > FUSED_MAX_D) {
    err = gemm<EPI_RAW, true>(dh, w1, nullptr, nullptr, dln, nullptr, n, f, d, ldf, ldd, ldd,
                              st);
    if (err != 0) return err;
    ffn_dx_rows_bf16<<<row_blocks, THREADS, 0, st>>>(dln, x, g, gamma, stats, dx, dgb_part, n,
                                                     d, ldd);
    err = (int)cudaGetLastError();
  } else {
    err = (int)cudaErrorInvalidValue;
#define KANVIT_CASE(J)                                                                   \
  if (err == (int)cudaErrorInvalidValue && d <= 128 * J)                                 \
    err = launch_dx<J>(dh, w1, x, g, gamma, stats, dx, dgb_part, n, d, f, ldd, ldf, st);
    KANVIT_FFN_BF16_JJ(KANVIT_CASE)
#undef KANVIT_CASE
  }
  if (err == 0) err = sum_parts(dgb_part, dgb, 2LL * d, row_blocks, st);
  if (err == 0) err = sum_parts(db1_part, db1, f, h_blocks, st);
  if (err == 0)
    err = weight_grad(g, r, dw2, db2, dw2_part, db2_part, n, d, f, ldd, ldf, splits, st);
  if (err == 0)
    err = weight_grad(dh, ln, dw1, nullptr, dw1_part, nullptr, n, f, d, ldf, ldd, splits, st);
  return err;
}
