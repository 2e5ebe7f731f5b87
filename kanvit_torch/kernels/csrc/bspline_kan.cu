// Fused B-spline KAN forward: expand x into its B-spline + silu basis and
// contract it against the packed weight, without writing the basis to memory.
//
// Replaces the TPU kernels of kanvit/kernels/fused_basis.py:
//   _fused_fwd (pallas_call at :1067) and its out-blocked tier _fused_fwd_ob
//   (:777), reached from bspline_kan (:3556), the patch embedder; and
//   _fused_fwd_sg (:1240), reached from bspline_qkv_grouped (:1361), the
//   q/k/v projection of every head in one launch.
// One kernel serves both: `groups` = 1 for the embedder, = H for q/k/v.
//
//   y[n, g*nout + o] = sum_i sum_s B_s(x[n, g*nin + i]) * W[g, s, i, o]
//
// s runs over the 8 cubic B-spline bases of the per-feature knot grid
// (12 knots: grid 5, order 3) and a ninth slice silu(x), so the base branch
// silu(x) @ base_weight.T rides the same contraction. The knot table is read
// per feature, (12, nin) row-major: no uniform grid is assumed.
//
// What bounds it on the H100: the contraction. At the ViT-S embedder
// (N = 64*196, 768 -> 384) it is 2*N*9*768*384 = 67 GFLOP against ~70 MB of
// x, y and W, far above the ridge point, so it is bound by arithmetic. This
// first version does it in f32 FMAs on the CUDA cores (no tensor cores),
// whose f32 peak is ~67 TFLOP/s.
//
// The simple design: a block owns a BM x BN tile of (rows x outputs) of one
// group and walks the group's input features in chunks of BK. Per chunk it
// (1) stages the chunk's knots and the reciprocals of the knot differences
// in shared memory, (2) evaluates the 9 basis values of its BM x BK inputs
// into shared memory (the Cox-de Boor recursion, mul/add only), (3) stages
// the matching 9 x BK x BN weight tile, and (4) accumulates a 4 x 4 register
// tile per thread with f32 FMAs. The basis is recomputed once per output
// tile (nout / BN times) instead of being stored; tensor cores, TMA and a
// pipelined ring of tiles are later work.
//
// Edge semantics follow kanvit_torch/ops/kan_bases.py::bspline_bases: the
// order-0 bases are the half-open indicators g_j <= x < g_{j+1}, so x on a
// knot starts the next interval and x outside every span gets all-zero
// spline bases. Ragged rows, outputs and features are masked in-kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KNOTS = 12;          // grid_size + 2 * order + 1
constexpr int ORDER = 3;
constexpr int NSPLINE = KNOTS - ORDER - 1;  // 8 spline bases
constexpr int S = NSPLINE + 1;     // + the silu slice
constexpr int BM = 64;             // rows per block
constexpr int BN = 64;             // outputs per block
constexpr int BK = 8;              // input features per chunk
constexpr int TM = 4;              // rows per thread
constexpr int TN = 4;              // outputs per thread
constexpr int TX = BN / TN;        // 16
constexpr int TY = BM / TM;        // 16
constexpr int THREADS = TX * TY;   // 256
constexpr int KS = S * BK;         // reduction entries per chunk
constexpr int NINV = ORDER * KNOTS;

__global__ void __launch_bounds__(THREADS)
bspline_kan_fwd_kernel(const float* __restrict__ x, long long ldx,
                       const float* __restrict__ gridt,
                       const float* __restrict__ w, float* __restrict__ y,
                       int n, int groups, int nin, int nout) {
  __shared__ float as[KS][BM];        // basis values, [s*BK + kf][row]
  __shared__ float bs[KS][BN];        // weight tile,  [s*BK + kf][out]
  __shared__ float knots[BK][KNOTS];
  __shared__ float inv[BK][NINV];     // inv[kf][(k-1)*KNOTS + j] = 1/(g[j+k]-g[j])

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
    if (tid < BK * KNOTS) {
      const int kf = tid / KNOTS, j = tid % KNOTS, i = k0 + kf;
      knots[kf][j] = i < nin ? gridt[(long long)j * nin + i] : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < BK * NINV; e += THREADS) {
      const int kf = e / NINV, r = e % NINV;
      const int k = r / KNOTS + 1, j = r % KNOTS;
      inv[kf][r] = (j + k < KNOTS && k0 + kf < nin)
                       ? 1.f / (knots[kf][j + k] - knots[kf][j]) : 0.f;
    }
    __syncthreads();

    // (2) the 9 basis values of each (row, feature) of the chunk.
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int m = e % BM, kf = e / BM;
      const int row = r0 + m, i = k0 + kf;
      float b[KNOTS - 1];
#pragma unroll
      for (int j = 0; j < KNOTS - 1; ++j) b[j] = 0.f;
      float xv = 0.f;
      const bool live = row < n && i < nin;
      if (live) {
        xv = x[(long long)row * ldx + (long long)g * nin + i];
        const float* gk = knots[kf];
#pragma unroll
        for (int j = 0; j < KNOTS - 1; ++j)
          b[j] = (xv >= gk[j] && !(xv >= gk[j + 1])) ? 1.f : 0.f;
#pragma unroll
        for (int k = 1; k <= ORDER; ++k) {
          const float* iv = inv[kf] + (k - 1) * KNOTS;
#pragma unroll
          for (int j = 0; j < KNOTS - 1 - k; ++j) {
            const float left = (xv - gk[j]) * iv[j];
            const float right = (gk[j + k + 1] - xv) * iv[j + 1];
            b[j] = left * b[j] + right * b[j + 1];
          }
        }
      }
#pragma unroll
      for (int s = 0; s < NSPLINE; ++s) as[s * BK + kf][m] = live ? b[s] : 0.f;
      as[NSPLINE * BK + kf][m] = live ? xv / (1.f + expf(-xv)) : 0.f;
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
