// Fused B-spline KAN layer, forward and backward: expand x into its
// B-spline + silu basis and contract it against the packed weight (forward),
// or reduce the output gradient back through the same basis (backward),
// without writing the basis to memory.
//
// Replaces the TPU kernels of kanvit/kernels/fused_basis.py:
//   forward:  _fused_fwd (pallas_call at :1067) and its out-blocked tier
//             _fused_fwd_ob (:777), reached from bspline_kan (:3556), the patch
//             embedder; _fused_fwd_sg (:1240), reached from
//             bspline_qkv_grouped (:1361), the q/k/v projection of every head
//             in one launch;
//   backward: _fused_bwd (:1159), the out-blocked _fused_bwd_ob (:810) and the
//             split pair _fused_fwd_basis (:969) + _fused_bwd_split (:1006),
//             all reached from _bspline_op's VJP (:2624); _fused_bwd_sg
//             (:1278), reached from _bspline_op_sg's VJP (:1330).
// One set of kernels serves both: `groups` = 1 for the embedder, = H for
// q/k/v.
//
//   y[n, g*nout + o]  = sum_i sum_s B_s(x[n, g*nin + i]) * W[g, s, i, o]
//   dx[n, g*nin + i]  = sum_s B'_s(x[n, g*nin + i]) * sum_o gy[n, g*nout + o] W[g, s, i, o]
//   dW[g, s, i, o]    = sum_n B_s(x[n, g*nin + i]) * gy[n, g*nout + o]
//
// s runs over the 8 cubic B-spline bases of the per-feature knot grid
// (12 knots: grid 5, order 3) and a ninth slice silu(x), so the base branch
// silu(x) @ base_weight.T rides the same contraction. The knot table is read
// per feature, (12, nin) row-major: no uniform grid is assumed. B' is the
// closed form of kanvit's bspline_family._levels (fused_basis.py:451-483):
// B'_{3,j} = 3 (B_{2,j} / (g_{j+3} - g_j) - B_{2,j+1} / (g_{j+4} - g_{j+1})),
// and silu'(x) = sig + silu (1 - sig).
//
// What bounds them on the H100: the contractions. At the ViT-S embedder
// (N = 64*196, 768 -> 384) each of y, dx and dW is 2*N*9*768*384 = 67 GFLOP
// against ~70 MB of x, y (or gy) and W, far above the ridge point, so all
// three are bound by arithmetic. This first version does them in f32 FMAs on
// the CUDA cores (no tensor cores), whose f32 peak is ~67 TFLOP/s.
//
// Forward: a block owns a BM x BN tile of (rows x outputs) of one group and
// walks the group's input features in chunks of BK. Per chunk it (1) stages
// the chunk's knots and the reciprocals of the knot differences in shared
// memory, (2) evaluates the 9 basis values of its BM x BK inputs into shared
// memory (the Cox-de Boor recursion, mul/add only), (3) stages the matching
// 9 x BK x BN weight tile, and (4) accumulates a 4 x 4 register tile per
// thread with f32 FMAs. The basis is recomputed once per output tile
// (nout / BN times) instead of being stored.
//
// dx: a block owns DX_BM rows x DX_BK features of one group (their knots are
// staged once) and walks the outputs in chunks of DX_BO: gW = gy W^T for the
// tile's 9 slices accumulates in registers (4 rows x 2 features x 9 slices a
// thread) and is reduced against B'(x) and silu'(x) at the end; gW never
// leaves registers.
//
// dW: a block owns DW_BF features x 9 slices x DW_BN outputs of one group and
// streams rows in chunks of DW_BR, recomputing its features' basis for each
// chunk. A TPU grid carries the row sum in scratch from step to step; blocks
// on Hopper run in no order, so where the (feature x output) tiles are too
// few to fill the card the rows are cut into a fixed number of splits, each
// split writes its partial dW, and a second pass sums the splits in a fixed
// order. No atomics: two runs give the same bits.
//
// Edge semantics follow kanvit_torch/ops/kan_bases.py::bspline_bases: the
// order-0 bases are the half-open indicators g_j <= x < g_{j+1}, so x on a
// knot starts the next interval and x outside every span gets all-zero
// spline bases and derivatives. Ragged rows, outputs and features are masked
// in-kernel. Tensor cores, TMA and a pipelined ring of tiles are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KNOTS = 12;          // grid_size + 2 * order + 1
constexpr int ORDER = 3;
constexpr int NSPLINE = KNOTS - ORDER - 1;  // 8 spline bases
constexpr int S = NSPLINE + 1;     // + the silu slice
constexpr int NINV = ORDER * KNOTS;

// forward tiles
constexpr int BM = 64;             // rows per block
constexpr int BN = 64;             // outputs per block
constexpr int BK = 8;              // input features per chunk
constexpr int TM = 4;              // rows per thread
constexpr int TN = 4;              // outputs per thread
constexpr int TX = BN / TN;        // 16
constexpr int TY = BM / TM;        // 16
constexpr int THREADS = TX * TY;   // 256
constexpr int KS = S * BK;         // reduction entries per chunk

// dx tiles
constexpr int DX_BM = 64;          // rows per block
constexpr int DX_BK = 16;          // input features per block
constexpr int DX_BO = 32;          // outputs per chunk
constexpr int DX_TM = 4;           // rows per thread (contiguous)
constexpr int DX_TF = 2;           // features per thread (contiguous)
constexpr int DX_TX = DX_BK / DX_TF;  // 8
constexpr int DX_TY = DX_BM / DX_TM;  // 16
constexpr int DX_THREADS = DX_TX * DX_TY;  // 128

// dW tiles
constexpr int DW_BF = 8;           // input features per block
constexpr int DW_BN = 64;          // outputs per block
constexpr int DW_BR = 32;          // rows per chunk
constexpr int DW_TF = 2;           // features per thread (contiguous)
constexpr int DW_TN = 4;           // outputs per thread (contiguous)
constexpr int DW_TX = DW_BN / DW_TN;  // 16
constexpr int DW_TY = DW_BF / DW_TF;  // 4
constexpr int DW_THREADS = DW_TX * DW_TY;  // 64

// Knots of features [k0, k0 + nf) and the reciprocals of their knot
// differences into shared memory:
//   knots[kf][j], inv[kf][(k-1)*KNOTS + j] = 1 / (g[j+k] - g[j]).
// Every thread of the block must call it (it synchronises).
__device__ void stage_knots(const float* __restrict__ gridt, int nin, int k0,
                            int nf, float (*knots)[KNOTS], float (*inv)[NINV]) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int e = tid; e < nf * KNOTS; e += nt) {
    const int kf = e / KNOTS, j = e % KNOTS, i = k0 + kf;
    knots[kf][j] = i < nin ? gridt[(long long)j * nin + i] : 0.f;
  }
  __syncthreads();
  for (int e = tid; e < nf * NINV; e += nt) {
    const int kf = e / NINV, r = e % NINV;
    const int k = r / KNOTS + 1, j = r % KNOTS;
    inv[kf][r] = (j + k < KNOTS && k0 + kf < nin)
                     ? 1.f / (knots[kf][j + k] - knots[kf][j]) : 0.f;
  }
  __syncthreads();
}

// Cox-de Boor from the order-0 indicators up to order UPTO, in place:
// b[0 .. KNOTS-2-UPTO] hold the bases of that order.
template <int UPTO>
__device__ __forceinline__ void levels(float xv, const float* gk,
                                       const float* iv, float (&b)[KNOTS - 1]) {
#pragma unroll
  for (int j = 0; j < KNOTS - 1; ++j)
    b[j] = (xv >= gk[j] && !(xv >= gk[j + 1])) ? 1.f : 0.f;
#pragma unroll
  for (int k = 1; k <= UPTO; ++k) {
    const float* ivk = iv + (k - 1) * KNOTS;
#pragma unroll
    for (int j = 0; j < KNOTS - 1 - k; ++j) {
      const float left = (xv - gk[j]) * ivk[j];
      const float right = (gk[j + k + 1] - xv) * ivk[j + 1];
      b[j] = left * b[j] + right * b[j + 1];
    }
  }
}

__device__ __forceinline__ float silu(float xv) {
  return xv / (1.f + expf(-xv));
}

__global__ void __launch_bounds__(THREADS)
bspline_kan_fwd_kernel(const float* __restrict__ x, long long ldx,
                       const float* __restrict__ gridt,
                       const float* __restrict__ w, float* __restrict__ y,
                       int n, int groups, int nin, int nout) {
  __shared__ float as[KS][BM];        // basis values, [s*BK + kf][row]
  __shared__ float bs[KS][BN];        // weight tile,  [s*BK + kf][out]
  __shared__ float knots[BK][KNOTS];
  __shared__ float inv[BK][NINV];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int o0 = blockIdx.x * BN;
  const int r0 = blockIdx.y * BM;
  const int g = blockIdx.z;
  const float* wg = w + (long long)g * S * nin * nout;
  const long long ldy = (long long)groups * nout;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < nin; k0 += BK) {
    // (1) knots and knot-difference reciprocals of this chunk's features.
    stage_knots(gridt, nin, k0, BK, knots, inv);

    // (2) the 9 basis values of each (row, feature) of the chunk.
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int m = e % BM, kf = e / BM;
      const int row = r0 + m, i = k0 + kf;
      float b[KNOTS - 1] = {};
      float xv = 0.f;
      const bool live = row < n && i < nin;
      if (live) {
        xv = x[(long long)row * ldx + (long long)g * nin + i];
        levels<ORDER>(xv, knots[kf], inv[kf], b);
      }
#pragma unroll
      for (int s = 0; s < NSPLINE; ++s) as[s * BK + kf][m] = live ? b[s] : 0.f;
      as[NSPLINE * BK + kf][m] = live ? silu(xv) : 0.f;
    }

    // (3) the weight tile W[g, s, k0:k0+BK, o0:o0+BN].
    for (int e = tid; e < KS * BN; e += THREADS) {
      const int c = e % BN, r = e / BN;
      const int s = r / BK, kf = r % BK;
      const int i = k0 + kf, o = o0 + c;
      bs[r][c] = (i < nin && o < nout)
                     ? wg[((long long)s * nin + i) * nout + o] : 0.f;
    }
    __syncthreads();

    // (4) register-tiled f32 FMAs over the chunk's 9 * BK reduction entries.
#pragma unroll 8
    for (int kk = 0; kk < KS; ++kk) {
      float a[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = as[kk][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = bs[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = r0 + ty + i * TY;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int o = o0 + tx + j * TX;
      if (o < nout) y[(long long)row * ldy + (long long)g * nout + o] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(DX_THREADS)
bspline_kan_dx_kernel(const float* __restrict__ x, long long ldx,
                      const float* __restrict__ gridt,
                      const float* __restrict__ w,
                      const float* __restrict__ gy, float* __restrict__ dx,
                      int n, int groups, int nin, int nout) {
  // +4 pads keep the float4 / float2 reads aligned and spread the
  // transposing stores over more banks.
  __shared__ __align__(16) float gs[DX_BO][DX_BM + 4];      // gy^T tile
  __shared__ __align__(16) float ws[DX_BO][S * DX_BK + 4];  // [out][s*BK + kf]
  __shared__ float knots[DX_BK][KNOTS];
  __shared__ float inv[DX_BK][NINV];

  const int tid = threadIdx.x;
  const int tx = tid % DX_TX;
  const int ty = tid / DX_TX;
  const int k0 = blockIdx.x * DX_BK;
  const int r0 = blockIdx.y * DX_BM;
  const int g = blockIdx.z;
  const float* wg = w + (long long)g * S * nin * nout;
  const long long ldg = (long long)groups * nout;
  const float* gyg = gy + (long long)g * nout;

  stage_knots(gridt, nin, k0, DX_BK, knots, inv);

  float acc[DX_TM][DX_TF][S];
#pragma unroll
  for (int r = 0; r < DX_TM; ++r)
#pragma unroll
    for (int f = 0; f < DX_TF; ++f)
#pragma unroll
      for (int s = 0; s < S; ++s) acc[r][f][s] = 0.f;

  for (int o0 = 0; o0 < nout; o0 += DX_BO) {
    for (int e = tid; e < DX_BO * DX_BM; e += DX_THREADS) {
      const int c = e % DX_BO, m = e / DX_BO;
      const int row = r0 + m, o = o0 + c;
      gs[c][m] = (row < n && o < nout) ? gyg[(long long)row * ldg + o] : 0.f;
    }
    for (int e = tid; e < DX_BO * S * DX_BK; e += DX_THREADS) {
      const int c = e % DX_BO, r = e / DX_BO;
      const int s = r / DX_BK, kf = r % DX_BK;
      const int i = k0 + kf, o = o0 + c;
      ws[c][r] = (i < nin && o < nout)
                     ? wg[((long long)s * nin + i) * nout + o] : 0.f;
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < DX_BO; ++c) {
      const float4 gv = *reinterpret_cast<const float4*>(&gs[c][ty * DX_TM]);
      const float a[DX_TM] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float2 wv =
            *reinterpret_cast<const float2*>(&ws[c][s * DX_BK + tx * DX_TF]);
#pragma unroll
        for (int r = 0; r < DX_TM; ++r) {
          acc[r][0][s] = fmaf(a[r], wv.x, acc[r][0][s]);
          acc[r][1][s] = fmaf(a[r], wv.y, acc[r][1][s]);
        }
      }
    }
    __syncthreads();
  }

  // Reduce gW against B'(x) and silu'(x).
  const long long ldd = (long long)groups * nin;
#pragma unroll
  for (int f = 0; f < DX_TF; ++f) {
    const int kf = tx * DX_TF + f, i = k0 + kf;
    if (i >= nin) continue;
    const float* gk = knots[kf];
    const float* iv3 = inv[kf] + (ORDER - 1) * KNOTS;
#pragma unroll
    for (int r = 0; r < DX_TM; ++r) {
      const int row = r0 + ty * DX_TM + r;
      if (row >= n) continue;
      const float xv = x[(long long)row * ldx + (long long)g * nin + i];
      float b[KNOTS - 1];
      levels<ORDER - 1>(xv, gk, inv[kf], b);  // b[0..8]: order-2 bases
      float d = 0.f;
#pragma unroll
      for (int j = 0; j < NSPLINE; ++j)
        d = fmaf(acc[r][f][j], ORDER * (b[j] * iv3[j] - b[j + 1] * iv3[j + 1]), d);
      const float sig = 1.f / (1.f + expf(-xv));
      const float sl = xv * sig;
      d = fmaf(acc[r][f][NSPLINE], sig + sl * (1.f - sig), d);
      dx[(long long)row * ldd + (long long)g * nin + i] = d;
    }
  }
}

__global__ void __launch_bounds__(DW_THREADS)
bspline_kan_dw_kernel(const float* __restrict__ x, long long ldx,
                      const float* __restrict__ gridt,
                      const float* __restrict__ gy, float* __restrict__ dw,
                      int n, int groups, int nin, int nout,
                      int rows_per_split) {
  __shared__ __align__(16) float bsm[DW_BR][S * DW_BF];  // [row][s*BF + kf]
  __shared__ __align__(16) float gsm[DW_BR][DW_BN];
  __shared__ float knots[DW_BF][KNOTS];
  __shared__ float inv[DW_BF][NINV];

  const int tid = threadIdx.x;
  const int tx = tid % DW_TX;
  const int ty = tid / DW_TX;
  const int o0 = blockIdx.x * DW_BN;
  const int k0 = blockIdx.y * DW_BF;
  const int g = blockIdx.z % groups;
  const int split = blockIdx.z / groups;
  const long long rbeg = (long long)split * rows_per_split;
  const long long rend = min((long long)n, rbeg + rows_per_split);
  const long long ldg = (long long)groups * nout;
  const float* gyg = gy + (long long)g * nout;

  stage_knots(gridt, nin, k0, DW_BF, knots, inv);

  float acc[S][DW_TF][DW_TN];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int f = 0; f < DW_TF; ++f)
#pragma unroll
      for (int j = 0; j < DW_TN; ++j) acc[s][f][j] = 0.f;

  for (long long r0 = rbeg; r0 < rend; r0 += DW_BR) {
    // the 9 basis values of the chunk's (row, feature) pairs
    for (int e = tid; e < DW_BR * DW_BF; e += DW_THREADS) {
      const int m = e % DW_BR, kf = e / DW_BR;
      const long long row = r0 + m;
      const int i = k0 + kf;
      const bool live = row < rend && i < nin;
      float b[KNOTS - 1] = {};
      float xv = 0.f;
      if (live) {
        xv = x[row * ldx + (long long)g * nin + i];
        levels<ORDER>(xv, knots[kf], inv[kf], b);
      }
#pragma unroll
      for (int s = 0; s < NSPLINE; ++s) bsm[m][s * DW_BF + kf] = live ? b[s] : 0.f;
      bsm[m][NSPLINE * DW_BF + kf] = live ? silu(xv) : 0.f;
    }
    for (int e = tid; e < DW_BR * DW_BN; e += DW_THREADS) {
      const int c = e % DW_BN, m = e / DW_BN;
      const long long row = r0 + m;
      const int o = o0 + c;
      gsm[m][c] = (row < rend && o < nout) ? gyg[row * ldg + o] : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int m = 0; m < DW_BR; ++m) {
      const float4 gv = *reinterpret_cast<const float4*>(&gsm[m][tx * DW_TN]);
      const float c4[DW_TN] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float2 bv =
            *reinterpret_cast<const float2*>(&bsm[m][s * DW_BF + ty * DW_TF]);
#pragma unroll
        for (int j = 0; j < DW_TN; ++j) {
          acc[s][0][j] = fmaf(bv.x, c4[j], acc[s][0][j]);
          acc[s][1][j] = fmaf(bv.y, c4[j], acc[s][1][j]);
        }
      }
    }
    __syncthreads();
  }

  // dw (this split's slab): [split][g][s][i][o]
  float* dst = dw + ((long long)split * groups + g) * S * nin * nout;
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int f = 0; f < DW_TF; ++f) {
      const int i = k0 + ty * DW_TF + f;
      if (i >= nin) continue;
#pragma unroll
      for (int j = 0; j < DW_TN; ++j) {
        const int o = o0 + tx * DW_TN + j;
        if (o < nout) dst[((long long)s * nin + i) * nout + o] = acc[s][f][j];
      }
    }
}

// out[e] = sum over splits of part[split][e], in split order.
__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, long long total,
                                  int splits) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int sp = 0; sp < splits; ++sp) acc += part[(long long)sp * total + e];
    out[e] = acc;
  }
}

}  // namespace

// x: (n, groups*nin) f32 with row stride ldx and unit column stride;
// gridt: (12, nin) f32 row-major; w: (groups, 9, nin, nout) f32 contiguous;
// y: (n, groups*nout) f32 contiguous. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int kanvit_bspline_kan_fwd(const float* x, long long ldx,
                                      const float* gridt, const float* w,
                                      float* y, int n, int groups, int nin,
                                      int nout, void* stream) {
  if (n <= 0 || groups <= 0 || nin <= 0 || nout <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((nout + BN - 1) / BN, (n + BM - 1) / BM, groups);
  if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidValue;
  bspline_kan_fwd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      x, ldx, gridt, w, y, n, groups, nin, nout);
  return (int)cudaGetLastError();
}

// Backward of kanvit_bspline_kan_fwd. x, gridt, w as there; gy: (n,
// groups*nout) f32 contiguous, the gradient of y. dx: (n, groups*nin) f32
// contiguous, or null to skip it. dw: (groups, 9, nin, nout) f32 contiguous,
// or null to skip it. splits >= 1 cuts the rows of the dW reduction into that
// many parts; with splits > 1, dw_part is scratch of splits * groups * 9 *
// nin * nout floats, summed into dw by a second pass. Launches on `stream`
// and returns cudaGetLastError() (0 on success).
extern "C" int kanvit_bspline_kan_bwd(const float* x, long long ldx,
                                      const float* gridt, const float* w,
                                      const float* gy, float* dx, float* dw,
                                      float* dw_part, int n, int groups,
                                      int nin, int nout, int splits,
                                      void* stream) {
  if (n <= 0 || groups <= 0 || nin <= 0 || nout <= 0 || splits <= 0 ||
      (splits > 1 && dw != nullptr && dw_part == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dx != nullptr) {
    const dim3 grid((nin + DX_BK - 1) / DX_BK, (n + DX_BM - 1) / DX_BM, groups);
    if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidValue;
    bspline_kan_dx_kernel<<<grid, DX_THREADS, 0, st>>>(
        x, ldx, gridt, w, gy, dx, n, groups, nin, nout);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  if (dw != nullptr) {
    long long per = ((long long)n + splits - 1) / splits;
    per = (per + DW_BR - 1) / DW_BR * DW_BR;
    const dim3 grid((nout + DW_BN - 1) / DW_BN, (nin + DW_BF - 1) / DW_BF,
                    groups * splits);
    if (grid.y > 65535u || (long long)groups * splits > 65535 || per > 0x7fffffff)
      return (int)cudaErrorInvalidValue;
    bspline_kan_dw_kernel<<<grid, DW_THREADS, 0, st>>>(
        x, ldx, gridt, gy, splits > 1 ? dw_part : dw, n, groups, nin, nout,
        (int)per);
    int err = (int)cudaGetLastError();
    if (err != 0) return err;
    if (splits > 1) {
      const long long total = (long long)groups * S * nin * nout;
      const long long want = (total + 255) / 256;
      const long long blocks = want < 4096 ? want : 4096;
      sum_splits_kernel<<<(unsigned)blocks, 256, 0, st>>>(dw_part, dw, total,
                                                          splits);
      err = (int)cudaGetLastError();
      if (err != 0) return err;
    }
  }
  return 0;
}
