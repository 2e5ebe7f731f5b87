// The pre-LN transformer feed-forward, forward and backward:
//   y = x + relu(LN(x) W1^T + b1) W2^T + b2,
// LN over the last axis with eps 1e-5, the biased variance and an affine
// (gamma, beta); torch-layout weights W1 (F, D), W2 (D, F).
//
// Replaces the TPU kernels of kanvit/kernels/fused_ffn.py:
//   forward:  _ffn_op (pallas_call at :177, body _ffn_fwd_kernel :62);
//   backward: _ffn_op_bwd (pallas_call at :217, body _ffn_bwd_kernel :80),
// reached from ffn_pre_ln (:277), TransformerBlock's opt-in FF
// (kanvit/layers/transformer.py:31-47).
//
// The backward recomputes LN and h = LN(x) W1^T + b1 from x (nothing is
// saved beyond the inputs), then, with r = relu(h) and g the gradient of y:
//   dW2 = g^T r,  db2 = sum g,  dh = (g W2) [h > 0],  dW1 = dh^T LN(x),
//   db1 = sum dh,  dln = dh W1,  dgamma = sum dln xhat,  dbeta = sum dln,
//   dx = g + rstd (gs - mean(gs) - xhat mean(gs xhat)),  gs = dln gamma.
//
// What bounds it on the H100: at ViT-S (N = 12,608 rows at batch 64, D 384,
// F 1,536) the forward is 4 N D F = 29.7 GFLOP against 39 MB of x and y, the
// backward 10 N D F = 74.4 GFLOP: arithmetic. On the tensor cores in 3xTF32
// (three TF32 products for each f32 one) that is 0.18 ms forward and 0.45 ms
// backward at the published 495 TFLOP/s dense TF32, which only wgmma
// reaches; mma.sync issues ~306 TFLOP/s on an H100 80GB HBM3 at 700 W
// (chip_smoke.py's probe, csrc/mma_rate_probe.cu): 0.29 and 0.73 ms. The
// CUDA cores' f32 (67 TFLOP/s) would take 0.44 and 1.11 ms.
//
// -- Arithmetic: every product runs on mma.sync.m16n8k8 in 3xTF32
// (attention_tc.cuh): each f32 operand split into big = tf32(x) and small =
// tf32(x - big) (split_round), and each 8-deep step of the contracted index
// three mma (small*big, big*small, big*big) into a zeroed accumulator, which
// an f32 add takes into the running sum (mma3). Plain 1xTF32 would put the
// ViT-S forward ~2.4e-4 of max|y| from f64, past the 1e-4 gate; the split
// keeps f32's accuracy (tests/test_torch_port_ffn_tc.py). Inside each 8-deep
// step the contracted index is renumbered (the fragment's t <-> 2t, t+4 <->
// 2t+1) on both operands, so an operand stored along k is one 8-byte load;
// the sum of a step is the mma's own either way. What costs beside the mma
// is the split (4-5 instructions a value) and the f32 adds, so each kernel
// splits a value as few times as it can: once a block where a value is
// shared by several warps, once a call for the weights the backward reads
// from every row block.
//
// -- Forward (ffn_fwd_tc). The Pallas kernel keeps a (rows, F) block on chip;
// here a block of 8 warps owns BM = 48 rows and all of D, so y needs no sum
// across blocks (12,608 rows make 263 blocks: two full waves at one block an
// SM, where 64-row blocks left the second wave half empty). LN of the rows
// stays in shared memory (75 KB at D 384), and for each chunk of BF hidden
// units (256; 128 past D 384, where shared memory is short):
//   h = LN W1c^T + b1, warp w the chunk's units w BF/8 .. (w+1) BF/8 - 1 of
//   all 48 rows;
//   r = relu(h) into shared memory, written split, in the A-fragment order
//   of the next product: a thread's accumulators are that fragment;
//   y_acc += r W2c^T, warp w columns w D/8 .. (w+1) D/8 - 1 of all rows, in
//   registers for the whole kernel (72 floats a thread at D 384).
// The epilogue adds b2 + x. W1c's and W2c's tiles follow each other in one
// stream, in the weights' torch layout, (n, k) tiles 16 deep, by 16-byte
// cp.async, double-buffered (one barrier a tile: the next tile's copy is
// started after it and runs under the products). A tile's two 8-wide halves
// are swapped on every other pair of rows, so a half-warp's 8-byte fragment
// loads hit 32 distinct banks with no padding (the resident LN is padded to
// a pitch of 8 mod 32 instead). Each weight value is split once a block,
// by the one warp that uses it; LN's A fragments are split by every warp.
// 223 KB of shared memory at D 384 (LN, r split, two weight tiles).
//
// -- Backward. The weight gradients sum over all N rows and dx needs all of
// F for each row, and one block cannot hold a row tile's LN and g (196 KB at
// 64 rows and D 384, 262 KB at 512) beside its weight tiles. So the backward
// runs GEMM kernels that keep no more than a tile resident:
//   ffn_ln_rows:        LN(x) (N, D) and each row's (mean, rstd), with the
//                       forward's arithmetic, so h repeats its bits;
//   ffn_split_weights:  W1 and W2 split once into TF32 words, in the tile
//                       layout the next two kernels stage as they are (14 MB
//                       at ViT-S): 197 x 12 hidden blocks and 263 dx blocks
//                       would otherwise split every weight again;
//   ffn_bwd_hidden_tc:  a (64 rows x 128 hidden units) tile, 2 x 4 warps, of
//                       h = LN W1^T + b1 and dr = g W2, both contracting over
//                       D: the LN and g tiles land raw and are split once by
//                       the block, the weight tiles land split; writes
//                       r = relu(h) and dh = dr [h > 0];
//   ffn_bwd_dx_tc:      dln = dh W1 for 48 rows and all of D (as the
//                       forward's y; W1 split, dh split by every warp), then
//                       dx and the block's dgamma, dbeta partials (row means
//                       by quad shuffles and a fixed-order sum of the 8
//                       warps; column sums by shuffles);
//   ffn_dw_tc:          dW2 = g^T r and dW1 = dh^T LN, (128 x 128) tiles, 2 x 4
//                       warps, over row splits (7 at ViT-S), both operands
//                       landing raw and split once a block, with db2 and
//                       db1 as the column sums of A;
//   ffn_sum_parts_kernel: the splits' and row blocks' partials summed in a
//                       fixed order: no atomics, a second backward gives
//                       the same bits.
// Scratch in device memory: LN (N, D), r and dh (N, F), 174 MB at ViT-S
// written once and read once or twice (~0.1 ms at 3.35 TB/s beside a 0.45
// ms bound), the split weights and the split partials (2 x 7 x D F floats).
//
// -- Past D 512 (vit-b D 768, vit-l D 1024, any larger D). The forward and
// dx kernels above hold a 48-row tile's LN (or dln) over all of D in shared
// memory and registers, which stops at D 512. Past it both run as tiled
// products that hold no row over all of D:
//   forward: ffn_ln_rows, W1 and W2 split once (ffn_split_rows), then
//            ffn_gemm_tc twice: r = relu(LN W1^T + b1) into device memory
//            (n, F), then y = x + (r W2^T + b2);
//   backward: as above through the hidden kernel, then ffn_gemm_tc for
//            dln = dh W1 into device memory (n, D), ffn_dx_rows for dx and
//            the 48-row blocks' dgamma, dbeta partials, and the same
//            weight-gradient kernels.
// ffn_gemm_tc is a 128 x 128 tile of 2 x 4 warps (64 x 32 each), A staged raw
// and split once a block, B split once a call. The forward's h takes the
// hidden kernel's split words in the same order, so the forward's ReLU
// pattern is the backward's. What the route costs beside the products: r
// (and dln) written once and read once, 310 MB at vit-b (N 12,608, F 3,072),
// ~0.09 ms at 3.35 TB/s beside a 0.72 ms 3xTF32 forward bound. It has no
// limit on D or F beyond device memory for the scratch.
//
// Rows, D and F past a tile's edge are zero-filled in shared memory. The
// staged operands (W1, W2, g and the scratch) need 16-byte-aligned rows: the
// wrapper passes them at pitches ldd = D and ldf = F rounded up to 4, copying
// an input whose pitch or address is off (zero-padded), and refuses nothing.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tc.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int BM = 48;        // rows a block of the forward and dx kernels
constexpr int MT = BM / 16;   // their m16 tiles: every warp holds all BM rows
constexpr int BM_H = 64;      // rows a block of the hidden kernel (2 x 4 warps)
constexpr int KS = 16;        // depth of a staged tile: two mma steps
constexpr int KP = 4;         // pad of a k-major tile's rows: pitch 4 mod 32
constexpr int BN_H = 128;     // hidden units a block of the hidden kernel
constexpr int BW = 128;       // (M, P) tile of the weight-gradient kernel
constexpr float LN_EPS = 1e-5f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// A row's mean and rstd, by one warp (every lane gets them).
__device__ __forceinline__ void ln_stats(const float* __restrict__ xr, int d,
                                         int lane, float& mean, float& rstd) {
  float s = 0.f;
  for (int k = lane; k < d; k += 32) s += xr[k];
  mean = warp_sum(s) / d;
  float v = 0.f;
  for (int k = lane; k < d; k += 32) {
    const float c = xr[k] - mean;
    v = fmaf(c, c, v);
  }
  rstd = 1.f / sqrtf(warp_sum(v) / d + LN_EPS);
}

__device__ __forceinline__ float ln_value(float xv, float mean, float rstd,
                                          float gm, float bt) {
  return fmaf((xv - mean) * rstd, gm, bt);
}

// --- staged tiles and fragments ---------------------------------------------
//
// A swizzled tile holds (rows, KS) of a matrix stored along k: row r at
// r*KS, its two 8-wide halves swapped when bit 1 of r is set. A fragment
// reads 2 consecutive words (k = 2t, 2t+1 of an 8-wide step) of rows g (and
// g+8); a half-warp's rows g = 0..3 then land on 32 distinct banks.
__device__ __forceinline__ int sw_word(int r, int k) {
  return r * KS + ((((k >> 3) ^ (r >> 1)) & 1) << 3) + (k & 7);
}

// Stage rows r0 .. r0+ROWS-1, columns k0 .. k0+KS-1 of the row-major
// (rows, ld) matrix src into a swizzled tile; zero outside (rows, ld).
template <int ROWS>
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src,
                                           int ld, int rows, int r0, int k0) {
  constexpr int CH = ROWS * KS / 4;  // 16-byte chunks
#pragma unroll
  for (int i = 0; i < (CH + THREADS - 1) / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    if (CH % THREADS != 0 && e >= CH) break;
    const int r = e / (KS / 4), k = (e % (KS / 4)) * 4, row = r0 + r, col = k0 + k;
    const bool in = row < rows && col < ld;
    cp_async16(dst + sw_word(r, k), in ? src + (long long)row * ld + col : src, in);
  }
}

// Stage rows k0 .. k0+KS-1, columns c0 .. c0+COLS-1 of the row-major
// (rows, ld) matrix src into a (KS, COLS + KP) tile; zero outside (rows, ld).
template <int COLS>
__device__ __forceinline__ void stage_kmajor(float* dst, const float* __restrict__ src,
                                             int ld, int rows, int k0, int c0) {
  constexpr int CPR = COLS / 4, CH = KS * CPR;
#pragma unroll
  for (int i = 0; i < (CH + THREADS - 1) / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    if (CH % THREADS != 0 && e >= CH) break;
    const int kk = e / CPR, c = (e % CPR) * 4, row = k0 + kk, col = c0 + c;
    const bool in = row < rows && col < ld;
    cp_async16(dst + kk * (COLS + KP) + c, in ? src + (long long)row * ld + col : src,
               in);
  }
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// A fragment (rows m, m+8; step s) of a swizzled tile stored (m, k).
__device__ __forceinline__ Frag<4> a_tile(const float* tile, int m, int s, int t) {
  const int off = (((s ^ (m >> 1)) & 1) << 3) + 2 * t;  // rows m, m+8 alike
  const float2 lo = ld2(tile + m * KS + off), hi = ld2(tile + (m + 8) * KS + off);
  const float a[4] = {lo.x, hi.x, lo.y, hi.y};
  return split_frag(a);
}

// B fragment (column n; step s) of a swizzled tile stored (n, k).
__device__ __forceinline__ Frag<2> b_tile(const float* tile, int n, int s, int t) {
  const float2 v = ld2(tile + n * KS + (((s ^ (n >> 1)) & 1) << 3) + 2 * t);
  const float b[2] = {v.x, v.y};
  return split_frag(b);
}

// A fragment of a resident row-major block of pitch P (8 mod 32): `at`
// points at row m, the step's first column.
template <int P>
__device__ __forceinline__ Frag<4> a_resident(const float* at, int t) {
  const float2 lo = ld2(at + 2 * t), hi = ld2(at + 8 * P + 2 * t);
  const float a[4] = {lo.x, hi.x, lo.y, hi.y};
  return split_frag(a);
}

// --- split operands ----------------------------------------------------------
//
// The backward's staged tiles land raw by cp.async and are then split once by
// the block into TF32 words laid out per fragment (the forward's r is written
// so from its accumulators), so the product loops load split fragments with
// 16-byte loads and split nothing:
//   afrags: A of m16 tile i, 8-deep step s at (i S + s) * 256 words (S the
//           steps a row of tiles holds):
//           lane l's big words at 4l in the register order (g, 2t),
//           (g+8, 2t), (g, 2t+1), (g+8, 2t+1), its small words at 128 + 4l;
//   bpairs: B of column n, step s at n 2KS + 16 (s ^ (n & 1)) + 4t:
//           big(2t), big(2t+1), small(2t), small(2t+1); the XOR puts the
//           16-byte loads of a quarter-warp (columns g, g+1) on 32 banks.
// A split pass unit is one such 16-byte group; the raw reads and the
// split stores of a warp are conflict-free.

constexpr int KSTEP = KS / 8;  // mma steps a tile

__device__ __forceinline__ int bpairs_word(int n, int s, int t) {
  return n * 2 * KS + 16 * (s ^ (n & 1)) + 4 * t;
}

// afrags of rows 0 .. R-1 from a swizzled raw tile stored (m, k).
template <int R>
__device__ __forceinline__ void split_a_rows(uint32_t* dst, const float* raw) {
  constexpr int UNITS = R / 16 * KSTEP * 32;
#pragma unroll
  for (int q = 0; q < (UNITS + THREADS - 1) / THREADS; ++q) {
    const int u = threadIdx.x + q * THREADS;
    if (UNITS % THREADS != 0 && u >= UNITS) break;
    const int lane = u & 31, blk = u >> 5, s = blk % KSTEP;
    const int m = 16 * (blk / KSTEP) + (lane >> 2);
    const int off = (((s ^ (m >> 1)) & 1) << 3) + 2 * (lane & 3);  // rows m, m+8 alike
    const float2 lo = ld2(raw + m * KS + off), hi = ld2(raw + (m + 8) * KS + off);
    store_a(dst + blk * 256 + 4 * lane, lo.x, hi.x, lo.y, hi.y);
  }
}

// afrags of columns 0 .. C-1 from a raw tile stored (k, m), pitch C + KP.
template <int C>
__device__ __forceinline__ void split_a_kmajor(uint32_t* dst, const float* raw) {
  constexpr int P = C + KP, UNITS = C / 16 * KSTEP * 32;
#pragma unroll
  for (int q = 0; q < (UNITS + THREADS - 1) / THREADS; ++q) {
    const int u = threadIdx.x + q * THREADS;
    if (UNITS % THREADS != 0 && u >= UNITS) break;
    const int lane = u & 31, blk = u >> 5, s = blk % KSTEP;
    const float* r0 =
        raw + (8 * s + 2 * (lane & 3)) * P + 16 * (blk / KSTEP) + (lane >> 2);
    store_a(dst + blk * 256 + 4 * lane, r0[0], r0[8], r0[P], r0[P + 8]);
  }
}

// bpairs of columns 0 .. C-1 from a raw tile stored (k, n), pitch C + KP.
template <int C>
__device__ __forceinline__ void split_b_kmajor(uint32_t* dst, const float* raw) {
  constexpr int P = C + KP, UNITS = C * KSTEP * 4;
#pragma unroll
  for (int q = 0; q < (UNITS + THREADS - 1) / THREADS; ++q) {
    const int u = threadIdx.x + q * THREADS;
    if (UNITS % THREADS != 0 && u >= UNITS) break;
    const int t = u & 3, blk = u >> 5, s = blk % KSTEP;
    const int n = 8 * (blk / KSTEP) + ((u >> 2) & 7);
    const float* r0 = raw + (8 * s + 2 * t) * P + n;
    store_b(dst + bpairs_word(n, s, t), r0[0], r0[P]);
  }
}

// A fragment of m16 tile i, step s of an afrags tile of STEPS steps.
template <int STEPS = KSTEP>
__device__ __forceinline__ Frag<4> a_split(const uint32_t* tile, int i, int s, int lane) {
  return load_a(tile + (i * STEPS + s) * 256 + 4 * lane);
}

// B fragment of column n, step s of a bpairs tile.
__device__ __forceinline__ Frag<2> b_split(const uint32_t* tile, int n, int s, int t) {
  return load_b(tile + bpairs_word(n, s, t));
}

// --- forward -----------------------------------------------------------------

template <int JJ>
struct Fwd {
  static constexpr int DP = 128 * JJ;            // D <= DP
  static constexpr int BF = JJ <= 3 ? 256 : 128;  // hidden units a chunk
  static constexpr int LNP = DP + 8;             // LN's pitch, 8 mod 32
  static constexpr int RS = BF / 8;              // mma steps of a chunk
  static constexpr int WR = DP > BF ? DP : BF;   // rows of a staged weight tile
  static constexpr int NH = BF / 64;             // n8 tiles of h a warp
  static constexpr int NY = DP / 64;             // n8 tiles of y a warp
  static constexpr size_t SMEM =
      sizeof(float) * (BM * LNP + 2 * BM * BF + 2 * WR * KS);
};

// The forward's stream of weight tiles: for each chunk c0 of hidden units,
// phase 0 walks D (W1c tiles), phase 1 the chunk's hidden units (W2c tiles).
struct Tile {
  int c0, phase, k0;
};

__device__ __forceinline__ Tile next_tile(Tile c, int d, int f, int bf) {
  c.k0 += KS;
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
ffn_fwd_tc(const float* __restrict__ x, const float* __restrict__ gamma,
           const float* __restrict__ beta, const float* __restrict__ w1,
           const float* __restrict__ b1, const float* __restrict__ w2,
           const float* __restrict__ b2, float* __restrict__ y,
           unsigned char* __restrict__ relu_mask, int n, int d, int f, int ldd,
           int ldf) {
  using S = Fwd<JJ>;
  constexpr int DP = S::DP, BF = S::BF, LNP = S::LNP, RS = S::RS, WR = S::WR;
  constexpr int NH = S::NH, NY = S::NY;
  extern __shared__ __align__(16) float sm[];
  float* ln = sm;  // (BM, LNP)
  uint32_t* rs = reinterpret_cast<uint32_t*>(ln + BM * LNP);  // r, split: afrags
  float* wt = ln + BM * LNP + 2 * BM * BF;  // 2 x (WR, KS), swizzled
  const int wn = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * BM;

  auto issue = [&](const Tile& c, int buf) {
    float* dst = wt + buf * WR * KS;
    if (c.phase == 0)
      stage_rows<BF>(dst, w1, ldd, f, c.c0, c.k0);
    else
      stage_rows<DP>(dst, w2, ldf, d, 0, c.c0 + c.k0);
  };
  Tile cur = {0, 0, 0};
  issue(cur, 0);
  cp_async_commit();

  for (int r = wn; r < BM; r += THREADS / 32) {
    float* lr = ln + r * LNP;
    const int row = r0 + r;
    if (row >= n) {
      for (int k = lane; k < DP; k += 32) lr[k] = 0.f;
      continue;
    }
    const float* xr = x + (long long)row * d;
    float mean, rstd;
    ln_stats(xr, d, lane, mean, rstd);
    for (int k = lane; k < DP; k += 32)
      lr[k] = k < d ? ln_value(xr[k], mean, rstd, gamma[k], beta[k]) : 0.f;
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
    if (nxt.c0 < f) issue(nxt, buf ^ 1);
    cp_async_commit();
    const float* w = wt + buf * WR * KS;
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
      for (int s = 0; s < 2; ++s) {
        Frag<4> a[MT];
#pragma unroll
        for (int i = 0; i < MT; ++i)
          a[i] = a_resident<LNP>(ln + (16 * i + g) * LNP + cur.k0 + 8 * s, t);
#pragma unroll
        for (int j = 0; j < NH; ++j) {
          const Frag<2> b = b_tile(w, wn * (BF / 8) + 8 * j + g, s, t);
#pragma unroll
          for (int i = 0; i < MT; ++i) mma3(hacc[i][j], a[i], b);
        }
      }
      if (nxt.phase == 1) {
        // The chunk's h is complete: r into shared memory, split, as the
        // next product's A fragments. This thread's accumulator holds rows
        // g, g+8 and hidden units 2t, 2t+1 of one 8-wide step: the A
        // fragment of the same lane with the hidden units renumbered.
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NH; ++j) {
            const int step = wn * NH + j, c = cur.c0 + 8 * step + 2 * t;
            const bool in0 = c < f, in1 = c + 1 < f;
            const float bias0 = in0 ? b1[c] : 0.f, bias1 = in1 ? b1[c + 1] : 0.f;
            float rv[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float hv = hacc[i][j][e] + (e & 1 ? bias1 : bias0);
              rv[e] = (e & 1 ? in1 : in0) ? fmaxf(hv, 0.f) : 0.f;
              const int row = r0 + 16 * i + 8 * (e >> 1) + g;
              if (relu_mask != nullptr && row < n && (e & 1 ? in1 : in0))
                relu_mask[(long long)row * f + c + (e & 1)] = hv > 0.f;
            }
            store_a(rs + (i * RS + step) * 256 + 4 * lane, rv[0], rv[2], rv[1], rv[3]);
          }
      }
    } else {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        Frag<4> a[MT];
#pragma unroll
        for (int i = 0; i < MT; ++i) a[i] = a_split<RS>(rs, i, cur.k0 / 8 + s, lane);
#pragma unroll
        for (int j = 0; j < NY; ++j) {
          const Frag<2> b = b_tile(w, wn * (DP / 8) + 8 * j + g, s, t);
#pragma unroll
          for (int i = 0; i < MT; ++i) mma3(yacc[i][j], a[i], b);
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
            y[o] = x[o] + (yacc[i][j][2 * hh + e] + b2[col]);
          }
        }
    }
}

// --- backward ----------------------------------------------------------------

// LN(x) into ln (n, ldd), zero past d, and each row's (mean, rstd) into
// stats (n, 2); one warp a row.
__global__ void __launch_bounds__(THREADS)
ffn_ln_rows(const float* __restrict__ x, const float* __restrict__ gamma,
            const float* __restrict__ beta, float* __restrict__ ln,
            float* __restrict__ stats, int n, int d, int ldd) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (row >= n) return;
  const float* xr = x + row * d;
  float mean, rstd;
  ln_stats(xr, d, lane, mean, rstd);
  for (int k = lane; k < ldd; k += 32)
    ln[row * ldd + k] = k < d ? ln_value(xr[k], mean, rstd, gamma[k], beta[k]) : 0.f;
  if (lane == 0) {
    stats[2 * row] = mean;
    stats[2 * row + 1] = rstd;
  }
}

// Unit u of splitting B(k, n) = src[n][k] (a row-major (rows, ld) matrix,
// k < cols) into bpairs tiles of KS along k by np columns: tile kt at
// (kt np + n) 2KS; zero outside (rows, cols). A unit is a group's two words
// along k, k fastest (reads along src's rows).
__device__ __forceinline__ void split_row_unit(const float* __restrict__ src,
                                               uint32_t* __restrict__ dst, int rows,
                                               int cols, int ld, int np, long long u) {
  const int t = u & 3, s = (u >> 2) % KSTEP;
  const long long row = u / (4 * KSTEP);  // kt np + n
  const int n = row % np, k = (int)(row / np) * KS + 8 * s + 2 * t;
  const float* sr = src + (long long)n * ld;
  store_b(dst + row * 2 * KS + 16 * (s ^ (n & 1)) + 4 * t,
          n < rows && k < cols ? sr[k] : 0.f, n < rows && k + 1 < cols ? sr[k + 1] : 0.f);
}

// W1 and W2 split once for the hidden kernel, as bpairs tiles of BN_H
// hidden units by KS of D: ws[(kt fp + n) 2KS + ...] holds B(k, n) for k in
// tile kt of D and hidden unit n < fp (f rounded up to BN_H), W1's B(k, n)
// = W1[n][k] and W2's B(k, n) = W2[k][n]; zero outside (d, f). Every row
// block of the hidden kernel stages these words as they are.
__global__ void __launch_bounds__(THREADS)
ffn_split_weights(const float* __restrict__ w1, const float* __restrict__ w2,
                  uint32_t* __restrict__ w1s, uint32_t* __restrict__ w2s,
                  uint32_t* __restrict__ w1d, int d, int f, int ldd, int ldf, int fp,
                  int dp) {
  const long long units = (long long)((d + KS - 1) / KS) * fp * KSTEP * 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long u = blockIdx.x * (long long)blockDim.x + threadIdx.x; u < units;
       u += stride)
    split_row_unit(w1, w1s, f, d, ldd, fp, u);
  // W2: n fastest (reads along W2's rows)
  for (long long u = blockIdx.x * (long long)blockDim.x + threadIdx.x; u < units;
       u += stride) {
    const int n = u % fp, rest = (int)(u / fp), t = rest & 3, s = (rest >> 2) % KSTEP;
    const int kt = rest / (4 * KSTEP), k = kt * KS + 8 * s + 2 * t;
    const long long row = (long long)kt * fp + n;
    store_b(w2s + row * 2 * KS + 16 * (s ^ (n & 1)) + 4 * t,
            n < f && k < d ? w2[(long long)k * ldf + n] : 0.f,
            n < f && k + 1 < d ? w2[(long long)(k + 1) * ldf + n] : 0.f);
  }
  // W1 for the dx kernel: B(k, n) = W1[k][n] for k in tile kt of F and
  // n < dp (d rounded up to 128), n fastest
  const long long units_dx = (long long)((f + KS - 1) / KS) * dp * KSTEP * 4;
  for (long long u = blockIdx.x * (long long)blockDim.x + threadIdx.x; u < units_dx;
       u += stride) {
    const int n = u % dp, rest = (int)(u / dp), t = rest & 3, s = (rest >> 2) % KSTEP;
    const int kt = rest / (4 * KSTEP), k = kt * KS + 8 * s + 2 * t;
    const long long row = (long long)kt * dp + n;
    store_b(w1d + row * 2 * KS + 16 * (s ^ (n & 1)) + 4 * t,
            n < d && k < f ? w1[(long long)k * ldd + n] : 0.f,
            n < d && k + 1 < f ? w1[(long long)(k + 1) * ldd + n] : 0.f);
  }
}

// Shared memory of the hidden kernel (words): LN and g raw (swizzled) and
// split (afrags), and two stages of the split W1 and W2 tiles.
constexpr int H_RAW = 2 * BM_H * KS;
constexpr int H_SPLIT = 2 * 2 * BM_H * KS;
constexpr int H_W = 2 * 2 * BN_H * KS;
constexpr size_t H_SMEM = sizeof(float) * (H_RAW + H_SPLIT + 2 * H_W);

// h = LN W1^T + b1 and dr = g W2 over a (BM_H rows, BN_H hidden units) tile,
// both contracting over D; writes r = relu(h) and dh = dr [h > 0] (n, ldf),
// zero at hidden units past f. h repeats the forward's bits: the same split
// words in the same mma order.
__global__ void __launch_bounds__(THREADS, 2)
ffn_bwd_hidden_tc(const float* __restrict__ ln, const float* __restrict__ g,
                  const uint32_t* __restrict__ w1s, const uint32_t* __restrict__ w2s,
                  const float* __restrict__ b1, float* __restrict__ r,
                  float* __restrict__ dh, int n, int d, int f, int ldd, int ldf,
                  int fp) {
  extern __shared__ __align__(16) float sm[];
  float* raw = sm;  // LN, g (BM_H, KS), swizzled
  uint32_t* ln_s = reinterpret_cast<uint32_t*>(sm + H_RAW);  // afrags
  uint32_t* g_s = ln_s + 2 * BM_H * KS;                       // afrags
  uint32_t* w_s = g_s + 2 * BM_H * KS;  // 2 stages of W1, W2 bpairs
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3, wm = warp >> 2, wn = warp & 3;
  const int r0 = blockIdx.x * BM_H, n0 = blockIdx.y * BN_H;

  auto stage = [&](int kt) {
    const int k0 = kt * KS;
    stage_rows<BM_H>(raw, ln, ldd, n, r0, k0);
    stage_rows<BM_H>(raw + BM_H * KS, g, ldd, n, r0, k0);
    uint32_t* dst = w_s + (kt & 1) * H_W;
    const long long at = ((long long)kt * fp + n0) * 2 * KS;
    constexpr int CH = 2 * BN_H * KS / 4;  // 16-byte chunks of a W tile
#pragma unroll
    for (int i = 0; i < CH / THREADS; ++i) {
      const int e = 4 * (threadIdx.x + i * THREADS);
      cp_async16(reinterpret_cast<float*>(dst + e),
                 reinterpret_cast<const float*>(w1s + at + e), true);
      cp_async16(reinterpret_cast<float*>(dst + 2 * BN_H * KS + e),
                 reinterpret_cast<const float*>(w2s + at + e), true);
    }
  };

  float hacc[2][4][4], dracc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) hacc[i][j][e] = dracc[i][j][e] = 0.f;

  const int kt_n = (d + KS - 1) / KS;
  stage(0);
  cp_async_commit();
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<0>();
    __syncthreads();  // tile kt landed; LN and g's split words are free
    split_a_rows<BM_H>(ln_s, raw);
    split_a_rows<BM_H>(g_s, raw + BM_H * KS);
    __syncthreads();  // split words ready; the raw tile is free
    if (kt + 1 < kt_n) stage(kt + 1);
    cp_async_commit();
    const uint32_t* w1_t = w_s + (kt & 1) * H_W;
    const uint32_t* w2_t = w1_t + 2 * BN_H * KS;
#pragma unroll
    for (int s8 = 0; s8 < KSTEP; ++s8) {
      Frag<4> a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) a[i] = a_split(ln_s, 2 * wm + i, s8, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const Frag<2> b = b_split(w1_t, 32 * wn + 8 * j + gq, s8, t);
        mma3(hacc[0][j], a[0], b);
        mma3(hacc[1][j], a[1], b);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) a[i] = a_split(g_s, 2 * wm + i, s8, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const Frag<2> b = b_split(w2_t, 32 * wn + 8 * j + gq, s8, t);
        mma3(dracc[0][j], a[0], b);
        mma3(dracc[1][j], a[1], b);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + 32 * wn + 8 * j + 2 * t;  // even; ldf % 4 == 0
    if (col >= ldf) continue;
    const float bias0 = col < f ? b1[col] : 0.f, bias1 = col + 1 < f ? b1[col + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = r0 + 32 * wm + 16 * i + 8 * hh + gq;
        if (row >= n) continue;
        const float h0 = hacc[i][j][2 * hh] + bias0, h1 = hacc[i][j][2 * hh + 1] + bias1;
        const long long o = (long long)row * ldf + col;
        *reinterpret_cast<float2*>(r + o) = make_float2(fmaxf(h0, 0.f), fmaxf(h1, 0.f));
        *reinterpret_cast<float2*>(dh + o) =
            make_float2(h0 > 0.f ? dracc[i][j][2 * hh] : 0.f,
                        h1 > 0.f ? dracc[i][j][2 * hh + 1] : 0.f);
      }
  }
}

template <int JJ>
struct Dx {
  static constexpr int DP = 128 * JJ;
  static constexpr int STAGE = BM * KS + 2 * DP * KS;  // dh swizzled, W1 split
  static constexpr int NY = DP / 64;                   // n8 tiles of dln a warp
  static constexpr size_t SMEM = sizeof(float) * 2 * STAGE;
};

// dln = dh W1 for BM rows and all of D, contracting over F; then dx and the
// block's dgamma, dbeta partials dgb_part[block] (2, d). g at pitch ldd;
// w1d: W1 split once, bpairs tiles of KS hidden units by DP
// (ffn_split_weights). Warp w holds all BM rows and columns w DP/8 ..
// (w+1) DP/8 - 1.
template <int JJ>
__global__ void __launch_bounds__(THREADS, 1)
ffn_bwd_dx_tc(const float* __restrict__ dh, const uint32_t* __restrict__ w1d,
              const float* __restrict__ x, const float* __restrict__ g,
              const float* __restrict__ gamma, const float* __restrict__ stats,
              float* __restrict__ dx, float* __restrict__ dgb_part, int n, int d,
              int f, int ldd, int ldf) {
  using S = Dx<JJ>;
  constexpr int DP = S::DP, STAGE = S::STAGE, NY = S::NY;
  extern __shared__ __align__(16) float sm[];
  const int wn = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * BM;

  auto stage = [&](int kt, int buf) {
    float* s = sm + buf * STAGE;
    stage_rows<BM>(s, dh, ldf, n, r0, kt * KS);
    const uint32_t* src = w1d + (long long)kt * DP * 2 * KS;
    constexpr int CH = 2 * DP * KS / 4;  // 16-byte chunks of the W1 tile
#pragma unroll
    for (int i = 0; i < CH / THREADS; ++i) {
      const int e = 4 * (threadIdx.x + i * THREADS);
      cp_async16(s + BM * KS + e, reinterpret_cast<const float*>(src + e), true);
    }
  };

  float acc[MT][NY][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NY; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int kt_n = (f + KS - 1) / KS;
  stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<0>();
    __syncthreads();
    if (kt + 1 < kt_n) stage(kt + 1, (kt + 1) & 1);
    cp_async_commit();
    const float* at = sm + (kt & 1) * STAGE;
    const uint32_t* bt = reinterpret_cast<const uint32_t*>(at + BM * KS);
#pragma unroll
    for (int s8 = 0; s8 < KSTEP; ++s8) {
      Frag<4> a[MT];
#pragma unroll
      for (int i = 0; i < MT; ++i) a[i] = a_tile(at, 16 * i + gq, s8, t);
#pragma unroll
      for (int j = 0; j < NY; ++j) {
        const Frag<2> b = b_split(bt, wn * (DP / 8) + 8 * j + gq, s8, t);
#pragma unroll
        for (int i = 0; i < MT; ++i) mma3(acc[i][j], a[i], b);
      }
    }
  }
  __syncthreads();  // the stages are free

  // The rows' sums of gs = dln gamma and gs xhat: this thread's columns,
  // its quad, then the eight warps in order.
  float* red = sm;  // (8, BM, 2)
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
            const float xh = (x[(long long)row * d + col] - mean[i][hh]) * rstd[i][hh];
            const float gs = acc[i][j][2 * hh + e] * gamma[col];
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
            const float xh = (x[o] - mean[i][hh]) * rstd[i][hh];
            const float gs = dln * gamma[col];
            dx[o] = g[(long long)row * ldd + col] +
                    rstd[i][hh] * (gs - m1[i][hh] - xh * m2[i][hh]);
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

constexpr int W_RAW = 2 * KS * (BW + KP);  // A and B, k-major
constexpr int W_SPLIT = 2 * 2 * BW * KS;   // afrags, bpairs
constexpr size_t W_SMEM = sizeof(float) * (W_RAW + W_SPLIT);

// out (m, p) [of split blockIdx.z] = sum over that split's rows of
// a[row][m] b[row][p]; a (n, lda), b (n, ldb) row-major. Blocks with
// blockIdx.x == 0 also write the split's column sums of a, colsum (m).
// Warp tile 64 (m) x 32 (p) of the BW x BW block tile.
__global__ void __launch_bounds__(THREADS, 2)
ffn_dw_tc(const float* __restrict__ a, const float* __restrict__ b,
          float* __restrict__ out, float* __restrict__ colsum, int n, int m,
          int p, int lda, int ldb, int rows_per_split) {
  extern __shared__ __align__(16) float sm[];
  float* raw = sm;  // A (KS, BW + KP), then B
  uint32_t* a_s = reinterpret_cast<uint32_t*>(sm + W_RAW);
  uint32_t* b_s = a_s + 2 * BW * KS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3, wm = warp >> 2, wn = warp & 3;
  const int p0 = blockIdx.x * BW, m0 = blockIdx.y * BW, split = blockIdx.z;
  const int lo = split * rows_per_split, hi = min(n, lo + rows_per_split);
  const bool sums = blockIdx.x == 0 && threadIdx.x < BW;

  auto stage = [&](int k0) {
    stage_kmajor<BW>(raw, a, lda, hi, k0, m0);
    stage_kmajor<BW>(raw + KS * (BW + KP), b, ldb, hi, k0, p0);
  };

  float acc[4][4][4], cs = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  if (lo < hi) stage(lo);
  cp_async_commit();
  for (int k0 = lo; k0 < hi; k0 += KS) {
    cp_async_wait<0>();
    __syncthreads();
    split_a_kmajor<BW>(a_s, raw);
    split_b_kmajor<BW>(b_s, raw + KS * (BW + KP));
    if (sums) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) cs += raw[kk * (BW + KP) + threadIdx.x];
    }
    __syncthreads();
    if (k0 + KS < hi) stage(k0 + KS);
    cp_async_commit();
#pragma unroll
    for (int s8 = 0; s8 < KSTEP; ++s8) {
      Frag<4> af[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) af[i] = a_split(a_s, 4 * wm + i, s8, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const Frag<2> bf = b_split(b_s, 32 * wn + 8 * j + gq, s8, t);
#pragma unroll
        for (int i = 0; i < 4; ++i) mma3(acc[i][j], af[i], bf);
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

// B(k, n) = src[n][k] split once (split_row_unit): W1 for h as
// ffn_split_weights splits it, W2 for y.
__global__ void __launch_bounds__(THREADS)
ffn_split_rows(const float* __restrict__ src, uint32_t* __restrict__ dst, int rows,
               int cols, int ld, int np) {
  const long long units = (long long)((cols + KS - 1) / KS) * np * KSTEP * 4;
  for (long long u = blockIdx.x * (long long)blockDim.x + threadIdx.x; u < units;
       u += (long long)gridDim.x * blockDim.x)
    split_row_unit(src, dst, rows, cols, ld, np, u);
}

enum { EPI_RELU, EPI_RESID, EPI_RAW };

constexpr int BM_G = 128;                   // rows a block of ffn_gemm_tc
constexpr int BN_G = 128;                   // columns a block
constexpr int G_SPLIT = 2 * BM_G * KS;      // A split (afrags)
constexpr int G_B = 2 * BN_G * KS;          // a stage of B (bpairs)
constexpr size_t G_SMEM = sizeof(float) * (BM_G * KS + G_SPLIT + 2 * G_B);

// c = a b over k for rows < n, a (n, lda) row-major (16-byte aligned rows,
// zero past k), b split once (bpairs tiles of KS by np columns). Epilogue:
//   EPI_RELU:  c (n, ldc) = relu(acc + bias), zero at columns p .. ldc - 1,
//              and relu_mask (n, p) = acc + bias > 0 where not null;
//   EPI_RESID: c (n, ldc) = resid + (acc + bias) at columns < p;
//   EPI_RAW:   c (n, ldc) = acc at columns < ldc.
template <int EPI>
__global__ void __launch_bounds__(THREADS, 2)
ffn_gemm_tc(const float* __restrict__ a, const uint32_t* __restrict__ bs,
            const float* __restrict__ bias, const float* __restrict__ resid,
            float* __restrict__ c, unsigned char* __restrict__ relu_mask, int n, int k,
            int p, int lda, int ldc, int np) {
  extern __shared__ __align__(16) float sm[];
  float* raw = sm;  // A (BM_G, KS), swizzled
  uint32_t* a_s = reinterpret_cast<uint32_t*>(sm + BM_G * KS);
  uint32_t* b_s = a_s + G_SPLIT;  // 2 stages
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3, wm = warp >> 2, wn = warp & 3;
  const int r0 = blockIdx.y * BM_G, n0 = blockIdx.x * BN_G;

  auto stage = [&](int kt) {
    stage_rows<BM_G>(raw, a, lda, n, r0, kt * KS);
    uint32_t* dst = b_s + (kt & 1) * G_B;
    const long long at = ((long long)kt * np + n0) * 2 * KS;
#pragma unroll
    for (int i = 0; i < G_B / 4 / THREADS; ++i) {
      const int e = 4 * (threadIdx.x + i * THREADS);
      cp_async16(reinterpret_cast<float*>(dst + e),
                 reinterpret_cast<const float*>(bs + at + e), true);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int kt_n = (k + KS - 1) / KS;
  stage(0);
  cp_async_commit();
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<0>();
    __syncthreads();  // tile kt landed; the split A words are free
    split_a_rows<BM_G>(a_s, raw);
    __syncthreads();  // split words ready; the raw tile is free
    if (kt + 1 < kt_n) stage(kt + 1);
    cp_async_commit();
    const uint32_t* bt = b_s + (kt & 1) * G_B;
#pragma unroll
    for (int s8 = 0; s8 < KSTEP; ++s8) {
      Frag<4> af[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) af[i] = a_split(a_s, 4 * wm + i, s8, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const Frag<2> bf = b_split(bt, 32 * wn + 8 * j + gq, s8, t);
#pragma unroll
        for (int i = 0; i < 4; ++i) mma3(acc[i][j], af[i], bf);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + 32 * wn + 8 * j + 2 * t;  // even
    if (col >= (EPI == EPI_RESID ? p : ldc)) continue;
    float bias0 = 0.f, bias1 = 0.f;
    if constexpr (EPI != EPI_RAW) {
      bias0 = col < p ? bias[col] : 0.f;
      bias1 = col + 1 < p ? bias[col + 1] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = r0 + 64 * wm + 16 * i + 8 * hh + gq;
        if (row >= n) continue;
        const float v0 = acc[i][j][2 * hh], v1 = acc[i][j][2 * hh + 1];
        const long long o = (long long)row * ldc + col;
        if constexpr (EPI == EPI_RELU) {  // ldc % 4 == 0: col + 1 < ldc
          const float h0 = v0 + bias0, h1 = v1 + bias1;
          *reinterpret_cast<float2*>(c + o) = make_float2(fmaxf(h0, 0.f), fmaxf(h1, 0.f));
          if (relu_mask != nullptr) {
            const long long m = (long long)row * p + col;
            if (col < p) relu_mask[m] = h0 > 0.f;
            if (col + 1 < p) relu_mask[m + 1] = h1 > 0.f;
          }
        } else if constexpr (EPI == EPI_RESID) {
          c[o] = resid[o] + (v0 + bias0);
          if (col + 1 < p) c[o + 1] = resid[o + 1] + (v1 + bias1);
        } else {  // ldc % 4 == 0
          *reinterpret_cast<float2*>(c + o) = make_float2(v0, v1);
        }
      }
  }
}

// dx and the block's dgamma, dbeta partials dgb_part[block] (2, d) from
// dln (n, ldd), past D 512: one block per BM rows, as ffn_bwd_dx_tc's. The
// rows' means of gs = dln gamma and gs xhat, one warp a row, then a thread
// a column over the block's rows.
__global__ void __launch_bounds__(THREADS)
ffn_dx_rows(const float* __restrict__ dln, const float* __restrict__ x,
            const float* __restrict__ g, const float* __restrict__ gamma,
            const float* __restrict__ stats, float* __restrict__ dx,
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
        const float gs = dln[row * ldd + col] * gamma[col];
        s1 += gs;
        s2 = fmaf(gs, (x[row * d + col] - mean) * rstd, s2);
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
    const float gm = gamma[col];
    float pg = 0.f, pb = 0.f;
    for (int rr = 0; rr < BM && r0 + rr < n; ++rr) {
      const long long row = r0 + rr;
      const float mean = stats[2 * row], rstd = stats[2 * row + 1];
      const float dl = dln[row * ldd + col];
      const float xh = (x[row * d + col] - mean) * rstd;
      dx[row * d + col] =
          g[row * ldd + col] + rstd * (dl * gm - m1[rr] - xh * m2[rr]);
      pg = fmaf(dl, xh, pg);
      pb += dl;
    }
    part[col] = pg;
    part[d + col] = pb;
  }
}

// out[e] = sum over s < parts of part[s * total + e], in order of s.
__global__ void ffn_sum_parts_kernel(const float* __restrict__ part,
                                     float* __restrict__ out, long long total,
                                     int parts) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int q = 0; q < parts; ++q) s += part[q * total + e];
    out[e] = s;
  }
}

int sum_parts(const float* part, float* out, long long total, int parts,
              cudaStream_t st) {
  const long long blocks = (total + 255) / 256;
  ffn_sum_parts_kernel<<<(unsigned)min(blocks, 4096LL), 256, 0, st>>>(
      part, out, total, parts);
  return (int)cudaGetLastError();
}

template <class K>
int prepare(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int JJ>
int launch_fwd(const float* x, const float* gamma, const float* beta,
               const float* w1, const float* b1, const float* w2,
               const float* b2, float* y, unsigned char* relu_mask, int n,
               int d, int f, int ldd, int ldf, cudaStream_t st) {
  const size_t smem = Fwd<JJ>::SMEM;
  int err = prepare(ffn_fwd_tc<JJ>, smem);
  if (err != 0) return err;
  ffn_fwd_tc<JJ><<<(n + BM - 1) / BM, THREADS, smem, st>>>(
      x, gamma, beta, w1, b1, w2, b2, y, relu_mask, n, d, f, ldd, ldf);
  return (int)cudaGetLastError();
}

template <int JJ>
int launch_dx(const float* dh, const uint32_t* w1d, const float* x, const float* g,
              const float* gamma, const float* stats, float* dx,
              float* dgb_part, int n, int d, int f, int ldd, int ldf,
              cudaStream_t st) {
  const size_t smem = Dx<JJ>::SMEM;
  int err = prepare(ffn_bwd_dx_tc<JJ>, smem);
  if (err != 0) return err;
  ffn_bwd_dx_tc<JJ><<<(n + BM - 1) / BM, THREADS, smem, st>>>(
      dh, w1d, x, g, gamma, stats, dx, dgb_part, n, d, f, ldd, ldf);
  return (int)cudaGetLastError();
}

// dW (m, p) and the column sums (m) of a, over `splits` row splits, then
// summed in split order (with one split, written in place).
int weight_grad(const float* a, const float* b, float* dw, float* dcol,
                float* dw_part, float* col_part, int n, int m, int p, int lda,
                int ldb, int splits, cudaStream_t st) {
  const int per = (n + splits - 1) / splits;
  const dim3 grid((p + BW - 1) / BW, (m + BW - 1) / BW, splits);
  float* out = splits > 1 ? dw_part : dw;
  float* cs = splits > 1 ? col_part : dcol;
  int err = prepare(ffn_dw_tc, W_SMEM);
  if (err != 0) return err;
  ffn_dw_tc<<<grid, THREADS, W_SMEM, st>>>(a, b, out, cs, n, m, p, lda, ldb, per);
  err = (int)cudaGetLastError();
  if (err != 0 || splits == 1) return err;
  err = sum_parts(dw_part, dw, (long long)m * p, splits, st);
  if (err != 0) return err;
  return sum_parts(col_part, dcol, m, splits, st);
}

bool bad_layout(const float* w1, const float* w2, int d, int f, int ldd, int ldf) {
  return ldd < d || ldf < f || ldd % 4 != 0 || ldf % 4 != 0 ||
         ((uintptr_t)w1 | (uintptr_t)w2) % 16 != 0;
}

int split_rows(const float* src, uint32_t* dst, int rows, int cols, int ld, int np,
               cudaStream_t st) {
  ffn_split_rows<<<4 * 132, THREADS, 0, st>>>(src, dst, rows, cols, ld, np);
  return (int)cudaGetLastError();
}

// ffn_gemm_tc over n rows and np / BN_G column tiles.
template <int EPI>
int gemm(const float* a, const uint32_t* bs, const float* bias, const float* resid,
         float* c, unsigned char* relu_mask, int n, int k, int p, int lda, int ldc,
         int np, cudaStream_t st) {
  const int row_tiles = (n + BM_G - 1) / BM_G;
  if (row_tiles > 65535) return (int)cudaErrorInvalidValue;
  int err = prepare(ffn_gemm_tc<EPI>, G_SMEM);
  if (err != 0) return err;
  ffn_gemm_tc<EPI><<<dim3(np / BN_G, row_tiles), THREADS, G_SMEM, st>>>(
      a, bs, bias, resid, c, relu_mask, n, k, p, lda, ldc, np);
  return (int)cudaGetLastError();
}

constexpr int FUSED_MAX_D = 512;  // D the fused forward and dx kernels take

int round_up(int v, int m) { return (v + m - 1) / m * m; }

}  // namespace

// The D tiers: D <= 128 * jj for the instantiated jj.
#define KANVIT_FFN_JJ(X) X(1) X(2) X(3) X(4)

// Forward. x (n, d), y (n, d); gamma, beta, b2 (d); w1 (f, ldd) and w2
// (d, ldf) row-major, 16-byte aligned, zero in the pad columns (ldd, ldf:
// d and f rounded up to 4); b1 (f); all f32, 1 <= d <= 512; relu_mask
// (n, f) uint8, h > 0, or null. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int kanvit_ffn_fwd(const float* x, const float* gamma,
                              const float* beta, const float* w1,
                              const float* b1, const float* w2,
                              const float* b2, float* y,
                              unsigned char* relu_mask, int n, int d, int f,
                              int ldd, int ldf, void* stream) {
  if (n <= 0 || d <= 0 || f <= 0 || bad_layout(w1, w2, d, f, ldd, ldf))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define KANVIT_CASE(J)                                                      \
  if (d <= 128 * J)                                                         \
    return launch_fwd<J>(x, gamma, beta, w1, b1, w2, b2, y, relu_mask, n, d, \
                         f, ldd, ldf, st);
  KANVIT_FFN_JJ(KANVIT_CASE)
#undef KANVIT_CASE
  return (int)cudaErrorInvalidValue;
}

// Forward past D 512 (any d >= 1): as kanvit_ffn_fwd, through scratch ln
// (n, ldd), stats (n, 2), r (n, ldf), w1s (ceil(d / 16) * fp * 32 words, fp
// = f rounded up to 128) and w2s (ceil(f / 16) * dp * 32 words, dp = d
// rounded up to 128), all 16-byte aligned.
extern "C" int kanvit_ffn_fwd_wide(const float* x, const float* gamma,
                                   const float* beta, const float* w1,
                                   const float* b1, const float* w2,
                                   const float* b2, float* y,
                                   unsigned char* relu_mask, float* ln,
                                   float* stats, float* r, unsigned int* w1s,
                                   unsigned int* w2s, int n, int d, int f,
                                   int ldd, int ldf, void* stream) {
  if (n <= 0 || d <= 0 || f <= 0 || bad_layout(w1, w2, d, f, ldd, ldf) ||
      ((uintptr_t)ln | (uintptr_t)r | (uintptr_t)w1s | (uintptr_t)w2s) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int fp = round_up(f, BN_G), dp = round_up(d, BN_G);
  ffn_ln_rows<<<(n + THREADS / 32 - 1) / (THREADS / 32), THREADS, 0, st>>>(
      x, gamma, beta, ln, stats, n, d, ldd);
  int err = (int)cudaGetLastError();
  if (err == 0) err = split_rows(w1, w1s, f, d, ldd, fp, st);
  if (err == 0) err = split_rows(w2, w2s, d, f, ldf, dp, st);
  if (err == 0)
    err = gemm<EPI_RELU>(ln, w1s, b1, nullptr, r, relu_mask, n, d, f, ldd, ldf, fp, st);
  if (err == 0)
    err = gemm<EPI_RESID>(r, w2s, b2, x, y, nullptr, n, f, d, ldf, d, dp, st);
  return err;
}

// Backward of kanvit_ffn_fwd and kanvit_ffn_fwd_wide. x (n, d); g (n, ldd),
// the gradient of y, and w1 (f, ldd), w2 (d, ldf) as the forward takes them;
// b1 (f), gamma, beta (d). Writes dx (n, d), dgb (2, d) = (dgamma, dbeta),
// dw1 (f, d), db1 (f), dw2 (d, f), db2 (d). Scratch: ln (n, ldd), stats (n,
// 2), r and dh (n, ldf), w1s and w2s (ceil(d / 16) * fp * 32 words each, fp
// = f rounded up to 128), w1d (ceil(f / 16) * dp * 32 words, dp = d rounded
// up to 128), dgb_part (ceil(n / 48), 2, d); past D 512 also dln (n, ldd)
// (null at d <= 512); with splits > 1, dw1_part (splits, f, d), db1_part
// (splits, f), dw2_part (splits, d, f), db2_part (splits, d). All f32, the
// scratch 16-byte aligned, d >= 1, splits >= 1. Launches the LN pass, the
// hidden, dx and weight-gradient kernels and the fixed-order sums on
// `stream`; returns cudaGetLastError() (0 on success).
extern "C" int kanvit_ffn_bwd(const float* x, const float* g,
                              const float* gamma, const float* beta,
                              const float* w1, const float* w2,
                              const float* b1, float* dx, float* dgb,
                              float* dw1, float* db1, float* dw2, float* db2,
                              float* ln, float* stats, float* r, float* dh,
                              unsigned int* w1s, unsigned int* w2s,
                              unsigned int* w1d,
                              float* dgb_part, float* dln, float* dw1_part,
                              float* db1_part, float* dw2_part,
                              float* db2_part, int n, int d, int f, int ldd,
                              int ldf, int splits, void* stream) {
  const int h_tiles = (f + BN_H - 1) / BN_H;
  if (n <= 0 || d <= 0 || f <= 0 || splits < 1 || splits > 65535 ||
      h_tiles > 65535 || bad_layout(w1, w2, d, f, ldd, ldf) ||
      ((uintptr_t)g | (uintptr_t)ln | (uintptr_t)r | (uintptr_t)dh |
       (uintptr_t)w1s | (uintptr_t)w2s | (uintptr_t)w1d | (uintptr_t)dln) % 16 != 0 ||
      (d > FUSED_MAX_D && dln == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int row_blocks = (n + BM - 1) / BM;
  ffn_ln_rows<<<(n + THREADS / 32 - 1) / (THREADS / 32), THREADS, 0, st>>>(
      x, gamma, beta, ln, stats, n, d, ldd);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int fp = h_tiles * BN_H;
  ffn_split_weights<<<4 * 132, THREADS, 0, st>>>(w1, w2, w1s, w2s, w1d, d, f, ldd,
                                                 ldf, fp, (d + 127) / 128 * 128);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  err = prepare(ffn_bwd_hidden_tc, H_SMEM);
  if (err != 0) return err;
  ffn_bwd_hidden_tc<<<dim3((n + BM_H - 1) / BM_H, h_tiles), THREADS, H_SMEM, st>>>(
      ln, g, w1s, w2s, b1, r, dh, n, d, f, ldd, ldf, fp);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  if (d > FUSED_MAX_D) {
    err = gemm<EPI_RAW>(dh, w1d, nullptr, nullptr, dln, nullptr, n, f, d, ldf, ldd,
                        round_up(d, BN_G), st);
    if (err != 0) return err;
    ffn_dx_rows<<<row_blocks, THREADS, 0, st>>>(dln, x, g, gamma, stats, dx, dgb_part,
                                                n, d, ldd);
    err = (int)cudaGetLastError();
  } else {
    err = (int)cudaErrorInvalidValue;
#define KANVIT_CASE(J)                                                     \
  if (err == (int)cudaErrorInvalidValue && d <= 128 * J)                   \
    err = launch_dx<J>(dh, w1d, x, g, gamma, stats, dx, dgb_part, n, d, f, \
                       ldd, ldf, st);
    KANVIT_FFN_JJ(KANVIT_CASE)
#undef KANVIT_CASE
  }
  if (err != 0) return err;
  err = sum_parts(dgb_part, dgb, 2LL * d, row_blocks, st);
  if (err != 0) return err;
  err = weight_grad(g, r, dw2, db2, dw2_part, db2_part, n, d, f, ldd, ldf,
                    splits, st);
  if (err != 0) return err;
  return weight_grad(dh, ln, dw1, db1, dw1_part, db1_part, n, f, d, ldf, ldd,
                     splits, st);
}
