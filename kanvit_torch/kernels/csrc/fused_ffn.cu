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
// F 1,536) the forward is 4 N D F = 29.7 GFLOP, 0.44 ms at 67 TFLOP/s f32,
// against 39 MB of x and y: arithmetic. The backward is 10 N D F = 74.4
// GFLOP, 1.11 ms.
//
// Design. The Pallas kernel keeps a (rows, F) f32 block on chip; at 64 rows
// and F = 1,536 that is 384 KB, more than an SM's shared memory, so the
// forward tiles F instead: a block owns BM = 32 rows, writes their LN into
// shared memory (k-major, so a thread reads its 4 rows as one float4), and
// for each chunk of BF = 128 hidden units computes h = LN W1^T + b1 and its
// ReLU into shared memory, then adds r W2^T of the chunk into a (BM, D)
// accumulator that stays in registers (4 rows by 4 * JJ columns a thread,
// D <= 128 JJ); the epilogue adds b2 + x. W1^T and W2^T (transposed outside
// the kernel) stream through shared memory in KS = 16-deep tiles. SIMT f32
// on the CUDA cores, a 4 x 4 (4 x 4 JJ) register tile per thread.
//
// The backward's row kernel does the same walk with g beside LN: for each
// chunk h and g W2 (one staged pass over D), dh into shared memory, and dln
// += dh W1 into registers; the epilogue turns dln into dx (a warp holds whole
// rows, so the two row means are shuffle sums) and writes the block's dgamma
// and dbeta partials. r, dh and LN(x) go to device-memory scratch, (N, F),
// (N, F) and (N, D): dW2 = g^T r and dW1 = dh^T LN(x) are reductions over
// all N rows, which one row block cannot own. A second kernel computes each
// as a tiled A^T B over a split of the rows (with db2 and db1, the column
// sums of A, on the side), and a last pass sums the splits in a fixed order:
// no atomics, the same bits every run. The scratch (173 MB at ViT-S) is the
// cost a later redesign removes.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 32;         // rows per block of the row kernels
constexpr int THREADS = 256;   // 8 warps: warp ty owns rows 4 ty .. 4 ty + 3
constexpr int BF = 128;        // hidden units per chunk
constexpr int KS = 16;         // depth of a staged weight tile
constexpr int LP = BM + 4;     // pitch of a k-major (k, BM) tile
constexpr int WB = 64;         // (M, P) tile of the dW kernel
constexpr float LN_EPS = 1e-5f;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// acc[i][j] += a[i] * b[j] over a 4 x 4 tile.
__device__ __forceinline__ void outer4(float (&acc)[4][4], float4 a, float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

// LN of the block's rows into lnt (k-major, rows k < dp, zero past d), each
// row's mean and rstd into mean_s and rstd_s, and, if ln_out is given, LN(x)
// into ln_out (n, d). Warp ty normalises rows 4 ty .. 4 ty + 3.
__device__ void layer_norm_rows(const float* __restrict__ x,
                                const float* __restrict__ gamma,
                                const float* __restrict__ beta, float* lnt,
                                float* mean_s, float* rstd_s,
                                float* __restrict__ ln_out, int r0, int n,
                                int d, int dp) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i, row = r0 + r;
    if (row >= n) {
      for (int k = tx; k < dp; k += 32) lnt[k * LP + r] = 0.f;
      if (tx == 0) mean_s[r] = rstd_s[r] = 0.f;
      continue;
    }
    const float* xr = x + (long long)row * d;
    float s = 0.f;
    for (int k = tx; k < d; k += 32) s += xr[k];
    const float mean = warp_sum(s) / d;
    float v = 0.f;
    for (int k = tx; k < d; k += 32) {
      const float c = xr[k] - mean;
      v = fmaf(c, c, v);
    }
    const float rstd = 1.f / sqrtf(warp_sum(v) / d + LN_EPS);
    for (int k = tx; k < dp; k += 32) {
      const float ln = k < d ? (xr[k] - mean) * rstd * gamma[k] + beta[k] : 0.f;
      lnt[k * LP + r] = ln;
      if (ln_out != nullptr && k < d) ln_out[(long long)row * d + k] = ln;
    }
    if (tx == 0) {
      mean_s[r] = mean;
      rstd_s[r] = rstd;
    }
  }
}

// Stage rows [k0, k0 + KS) x columns [c0, c0 + width) of the row-major
// (rows, ld) matrix src into dst (KS, width), zero outside (rows, cols).
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      int ld, int k0, int rows, int c0,
                                      int cols, int width) {
  for (int e = threadIdx.x; e < KS * width; e += THREADS) {
    const int kk = e / width, j = e % width, k = k0 + kk, c = c0 + j;
    dst[e] = (k < rows && c < cols) ? src[(long long)k * ld + c] : 0.f;
  }
}

// acc (4 rows x 4 JJ columns) += at[k][rows] * W[c0 + k][columns] over the
// chunk's hidden units k < min(BF, f - c0); at is the chunk's k-major
// (BF, LP) tile, W (f, d) row-major, staged through bs (KS, 128 JJ).
template <int JJ>
__device__ __forceinline__ void chunk_times_rows(float (&acc)[4][4 * JJ],
                                                 const float* at,
                                                 const float* __restrict__ w,
                                                 float* bs, int c0, int f,
                                                 int d) {
  constexpr int DP = 128 * JJ;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int k0 = 0; k0 < BF && c0 + k0 < f; k0 += KS) {
    __syncthreads();  // bs is no longer read
    stage(bs, w, d, c0 + k0, f, 0, d, DP);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KS; ++kk) {
      const float4 a = ld4(at + (k0 + kk) * LP + 4 * ty);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int jj = 0; jj < JJ; ++jj) {
        const float4 b = ld4(bs + kk * DP + 128 * jj + 4 * tx);
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][4 * jj + e] = fmaf(av[i], bv[e], acc[i][4 * jj + e]);
      }
    }
  }
}

// Forward. One block per BM rows; dynamic shared memory (floats):
// lnt (DP, LP), rt (BF, LP), bs (KS, DP). relu_mask, when not null, gets
// h > 0 (n, f): the ReLU pattern, for a gradient check that holds a
// reference to the kernel's own linear piece. Checks only: the model path
// passes null.
template <int JJ>
__global__ void __launch_bounds__(THREADS)
ffn_fwd_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, const float* __restrict__ w1t,
               const float* __restrict__ b1, const float* __restrict__ w2t,
               const float* __restrict__ b2, float* __restrict__ y,
               unsigned char* __restrict__ relu_mask, int n, int d, int f) {
  constexpr int DP = 128 * JJ;
  extern __shared__ __align__(16) float sm[];
  float* lnt = sm;
  float* rt = lnt + DP * LP;
  float* bs = rt + BF * LP;
  __shared__ float mean_s[BM], rstd_s[BM];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int r0 = blockIdx.x * BM;

  layer_norm_rows(x, gamma, beta, lnt, mean_s, rstd_s, nullptr, r0, n, d, DP);

  float acc[4][4 * JJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * JJ; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < f; c0 += BF) {
    float h[4][4] = {};
    for (int k0 = 0; k0 < d; k0 += KS) {
      __syncthreads();  // bs (and, at k0 = 0, rt) is no longer read
      stage(bs, w1t, f, k0, d, c0, f, BF);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KS; ++kk)
        outer4(h, ld4(lnt + (k0 + kk) * LP + 4 * ty), ld4(bs + kk * BF + 4 * tx));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + 4 * tx + j;
      const float bias = c < f ? b1[c] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float hv = h[i][j] + bias;
        rt[(4 * tx + j) * LP + 4 * ty + i] = fmaxf(hv, 0.f);
        const int row = r0 + 4 * ty + i;
        if (relu_mask != nullptr && row < n && c < f)
          relu_mask[(long long)row * f + c] = hv > 0.f;
      }
    }
    chunk_times_rows<JJ>(acc, rt, w2t, bs, c0, f, d);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + 4 * ty + i;
    if (row >= n) continue;
#pragma unroll
    for (int jj = 0; jj < JJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 128 * jj + 4 * tx + e;
        if (col < d) {
          const long long o = (long long)row * d + col;
          y[o] = x[o] + (acc[i][4 * jj + e] + b2[col]);
        }
      }
  }
}

// Backward, the row kernel. One block per BM rows; dynamic shared memory
// (floats): lnt (DP, LP), gt (DP, LP), dht (BF, LP), bs (KS, max(2 BF, DP)).
// Writes dx, the (n, f) scratch r and dh, LN(x) (n, d), and the block's
// dgamma and dbeta partials dgb_part[block] (2, d).
template <int JJ>
__global__ void __launch_bounds__(THREADS)
ffn_bwd_rows_kernel(const float* __restrict__ x, const float* __restrict__ g,
                    const float* __restrict__ gamma,
                    const float* __restrict__ beta,
                    const float* __restrict__ w1t, const float* __restrict__ w1,
                    const float* __restrict__ w2, const float* __restrict__ b1,
                    float* __restrict__ dx, float* __restrict__ r_out,
                    float* __restrict__ dh_out, float* __restrict__ ln_out,
                    float* __restrict__ dgb_part, int n, int d, int f) {
  constexpr int DP = 128 * JJ;
  extern __shared__ __align__(16) float sm[];
  float* lnt = sm;
  float* gt = lnt + DP * LP;
  float* dht = gt + DP * LP;
  float* bs = dht + BF * LP;
  __shared__ float mean_s[BM], rstd_s[BM];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int r0 = blockIdx.x * BM;

  layer_norm_rows(x, gamma, beta, lnt, mean_s, rstd_s, ln_out, r0, n, d, DP);
  for (int e = threadIdx.x; e < BM * DP; e += THREADS) {
    const int r = e / DP, k = e % DP, row = r0 + r;
    gt[k * LP + r] = (row < n && k < d) ? g[(long long)row * d + k] : 0.f;
  }

  float acc[4][4 * JJ];  // dln
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * JJ; ++j) acc[i][j] = 0.f;

  float* bs1 = bs;            // W1^T tile (KS, BF)
  float* bs2 = bs + KS * BF;  // W2 tile (KS, BF)
  for (int c0 = 0; c0 < f; c0 += BF) {
    float h[4][4] = {}, dr[4][4] = {};
    for (int k0 = 0; k0 < d; k0 += KS) {
      __syncthreads();  // bs (and, at k0 = 0, dht) is no longer read
      stage(bs1, w1t, f, k0, d, c0, f, BF);
      stage(bs2, w2, f, k0, d, c0, f, BF);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KS; ++kk) {
        const int o = (k0 + kk) * LP + 4 * ty;
        outer4(h, ld4(lnt + o), ld4(bs1 + kk * BF + 4 * tx));
        outer4(dr, ld4(gt + o), ld4(bs2 + kk * BF + 4 * tx));
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + 4 * tx + j;
      const float bias = c < f ? b1[c] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float hv = h[i][j] + bias;
        const float dh = hv > 0.f ? dr[i][j] : 0.f;
        dht[(4 * tx + j) * LP + 4 * ty + i] = dh;
        const int row = r0 + 4 * ty + i;
        if (row < n && c < f) {
          const long long o = (long long)row * f + c;
          r_out[o] = fmaxf(hv, 0.f);
          dh_out[o] = dh;
        }
      }
    }
    chunk_times_rows<JJ>(acc, dht, w1, bs, c0, f, d);
  }

  // dx from dln; each row's columns are all in warp ty.
  float pg[4 * JJ], pb[4 * JJ];  // this thread's dgamma, dbeta over its rows
#pragma unroll
  for (int j = 0; j < 4 * JJ; ++j) pg[j] = pb[j] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i, row = r0 + r;
    const bool live = row < n;
    const float mean = mean_s[r], rstd = rstd_s[r];
    float xh[4 * JJ], s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int jj = 0; jj < JJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * jj + e, col = 128 * jj + 4 * tx + e;
        const bool in = live && col < d;
        xh[j] = in ? (x[(long long)row * d + col] - mean) * rstd : 0.f;
        const float gs = in ? acc[i][j] * gamma[col] : 0.f;
        s1 += gs;
        s2 = fmaf(gs, xh[j], s2);
        pg[j] = fmaf(acc[i][j], xh[j], pg[j]);
        pb[j] += acc[i][j];
      }
    const float m1 = warp_sum(s1) / d, m2 = warp_sum(s2) / d;
    if (!live) continue;
#pragma unroll
    for (int jj = 0; jj < JJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * jj + e, col = 128 * jj + 4 * tx + e;
        if (col < d) {
          const long long o = (long long)row * d + col;
          const float gs = acc[i][j] * gamma[col];
          dx[o] = g[o] + rstd * (gs - m1 - xh[j] * m2);
        }
      }
  }

  // The block's dgamma, dbeta: the 8 warps' partials summed in warp order.
  __syncthreads();  // lnt is free
  float* red = lnt;  // (8, 2, DP)
#pragma unroll
  for (int jj = 0; jj < JJ; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 4 * jj + e, col = 128 * jj + 4 * tx + e;
      red[(ty * 2) * DP + col] = pg[j];
      red[(ty * 2 + 1) * DP + col] = pb[j];
    }
  __syncthreads();
  for (int e = threadIdx.x; e < 2 * d; e += THREADS) {
    const int which = e / d, col = e % d;
    float s = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) s += red[(w * 2 + which) * DP + col];
    dgb_part[(long long)blockIdx.x * 2 * d + e] = s;
  }
}

// out (m, p) [of split blockIdx.z] = sum over that split's rows of
// a[row][m] * b[row][p]; a (n, m) and b (n, p) row-major. Blocks with
// blockIdx.x == 0 also write the split's column sums of a, colsum (m).
// 256 threads as 16 x 16, a 4 x 4 tile each of the WB x WB block tile.
__global__ void __launch_bounds__(THREADS)
ffn_dw_kernel(const float* __restrict__ a, const float* __restrict__ b,
              float* __restrict__ out, float* __restrict__ colsum, int n,
              int m, int p, int rows_per_split) {
  __shared__ __align__(16) float as[KS][WB];
  __shared__ __align__(16) float bsh[KS][WB];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int p0 = blockIdx.x * WB, m0 = blockIdx.y * WB, split = blockIdx.z;
  const int lo = split * rows_per_split, hi = min(n, lo + rows_per_split);
  const bool sums = blockIdx.x == 0 && tx == 0;
  float acc[4][4] = {}, cs[4] = {};
  for (int k0 = lo; k0 < hi; k0 += KS) {
    __syncthreads();  // as, bsh are no longer read
    for (int e = tid; e < KS * WB; e += THREADS) {
      const int kk = e / WB, j = e % WB, row = k0 + kk;
      const bool in = row < hi;
      as[kk][j] = (in && m0 + j < m) ? a[(long long)row * m + m0 + j] : 0.f;
      bsh[kk][j] = (in && p0 + j < p) ? b[(long long)row * p + p0 + j] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const float4 av = ld4(&as[kk][4 * ty]);
      outer4(acc, av, ld4(&bsh[kk][4 * tx]));
      if (sums) {
        cs[0] += av.x;
        cs[1] += av.y;
        cs[2] += av.z;
        cs[3] += av.w;
      }
    }
  }
  float* dst = out + (long long)split * m * p;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + 4 * ty + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = p0 + 4 * tx + j;
      if (col < p) dst[(long long)row * p + col] = acc[i][j];
    }
    if (sums) colsum[(long long)split * m + row] = cs[i];
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

size_t fwd_smem(int jj) {
  return sizeof(float) * (128 * jj * LP + BF * LP + KS * 128 * jj);
}

size_t bwd_smem(int jj) {
  return sizeof(float) * (2 * 128 * jj * LP + BF * LP + KS * max(2 * BF, 128 * jj));
}

template <class K>
int prepare(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int JJ>
int launch_fwd(const float* x, const float* gamma, const float* beta,
               const float* w1t, const float* b1, const float* w2t,
               const float* b2, float* y, unsigned char* relu_mask, int n,
               int d, int f, cudaStream_t st) {
  const size_t smem = fwd_smem(JJ);
  int err = prepare(ffn_fwd_kernel<JJ>, smem);
  if (err != 0) return err;
  ffn_fwd_kernel<JJ><<<(n + BM - 1) / BM, THREADS, smem, st>>>(
      x, gamma, beta, w1t, b1, w2t, b2, y, relu_mask, n, d, f);
  return (int)cudaGetLastError();
}

template <int JJ>
int launch_bwd_rows(const float* x, const float* g, const float* gamma,
                    const float* beta, const float* w1t, const float* w1,
                    const float* w2, const float* b1, float* dx, float* r,
                    float* dh, float* ln, float* dgb_part, int n, int d, int f,
                    cudaStream_t st) {
  const size_t smem = bwd_smem(JJ);
  int err = prepare(ffn_bwd_rows_kernel<JJ>, smem);
  if (err != 0) return err;
  ffn_bwd_rows_kernel<JJ><<<(n + BM - 1) / BM, THREADS, smem, st>>>(
      x, g, gamma, beta, w1t, w1, w2, b1, dx, r, dh, ln, dgb_part, n, d, f);
  return (int)cudaGetLastError();
}

// dW (m, p) and the column sums (m) of a, over `splits` row splits, then
// summed in split order (with one split, written in place).
int weight_grad(const float* a, const float* b, float* dw, float* dcol,
                float* dw_part, float* col_part, int n, int m, int p,
                int splits, cudaStream_t st) {
  const int per = (n + splits - 1) / splits;
  const dim3 grid((p + WB - 1) / WB, (m + WB - 1) / WB, splits);
  float* out = splits > 1 ? dw_part : dw;
  float* cs = splits > 1 ? col_part : dcol;
  ffn_dw_kernel<<<grid, THREADS, 0, st>>>(a, b, out, cs, n, m, p, per);
  int err = (int)cudaGetLastError();
  if (err != 0 || splits == 1) return err;
  err = sum_parts(dw_part, dw, (long long)m * p, splits, st);
  if (err != 0) return err;
  return sum_parts(col_part, dcol, m, splits, st);
}

}  // namespace

// The widest row a thread's registers hold: D <= 128 * jj for the
// instantiated jj.
#define KANVIT_FFN_JJ(X) X(1) X(2) X(3) X(4)

// Forward. x (n, d), y (n, d); gamma, beta, b2 (d); w1t = W1^T (d, f);
// b1 (f); w2t = W2^T (f, d); all f32 contiguous, 1 <= d <= 512; relu_mask
// (n, f) uint8, h > 0, or null. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int kanvit_ffn_fwd(const float* x, const float* gamma,
                              const float* beta, const float* w1t,
                              const float* b1, const float* w2t,
                              const float* b2, float* y,
                              unsigned char* relu_mask, int n, int d, int f,
                              void* stream) {
  if (n <= 0 || d <= 0 || f <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define KANVIT_CASE(J)                                                     \
  if (d <= 128 * J)                                                        \
    return launch_fwd<J>(x, gamma, beta, w1t, b1, w2t, b2, y, relu_mask, n, \
                         d, f, st);
  KANVIT_FFN_JJ(KANVIT_CASE)
#undef KANVIT_CASE
  return (int)cudaErrorInvalidValue;
}

// Backward of kanvit_ffn_fwd. x, g (n, d): the input and the gradient of y;
// w1t (d, f) = W1^T, w1 (f, d), w2 (d, f), b1 (f), gamma, beta (d).
// Writes dx (n, d), dgb (2, d) = (dgamma, dbeta), dw1 (f, d), db1 (f),
// dw2 (d, f), db2 (d). Scratch: r, dh (n, f); ln (n, d); dgb_part
// (ceil(n / 32), 2, d); with splits > 1, dw1_part (splits, f, d), db1_part
// (splits, f), dw2_part (splits, d, f), db2_part (splits, d). All f32
// contiguous, 1 <= d <= 512, splits >= 1. Launches the row kernel, the two
// weight-gradient kernels and the fixed-order sums on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int kanvit_ffn_bwd(const float* x, const float* g,
                              const float* gamma, const float* beta,
                              const float* w1t, const float* w1,
                              const float* w2, const float* b1, float* dx,
                              float* dgb, float* dw1, float* db1, float* dw2,
                              float* db2, float* r, float* dh, float* ln,
                              float* dgb_part, float* dw1_part,
                              float* db1_part, float* dw2_part,
                              float* db2_part, int n, int d, int f, int splits,
                              void* stream) {
  if (n <= 0 || d <= 0 || f <= 0 || splits < 1 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int err = (int)cudaErrorInvalidValue;
#define KANVIT_CASE(J)                                                     \
  if (err == (int)cudaErrorInvalidValue && d <= 128 * J)                   \
    err = launch_bwd_rows<J>(x, g, gamma, beta, w1t, w1, w2, b1, dx, r, dh, \
                             ln, dgb_part, n, d, f, st);
  KANVIT_FFN_JJ(KANVIT_CASE)
#undef KANVIT_CASE
  if (err != 0) return err;
  err = sum_parts(dgb_part, dgb, 2LL * d, (n + BM - 1) / BM, st);
  if (err != 0) return err;
  err = weight_grad(g, r, dw2, db2, dw2_part, db2_part, n, d, f, splits, st);
  if (err != 0) return err;
  return weight_grad(dh, ln, dw1, db1, dw1_part, db1_part, n, f, d, splits, st);
}
