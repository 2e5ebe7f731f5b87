// Fused KAN layers, forward and backward, for three basis families: expand
// x into its parameter-free basis and contract it against the packed weight
// (forward), or reduce the output gradient back through the same basis
// (backward), without writing the basis to memory.
//
// One set of templated kernels, instantiated per family:
//   B-spline  S = 9: the 8 cubic B-spline bases of a per-feature 12-knot grid
//             (grid 5, order 3) and silu(x), so efficient-kan's base branch
//             rides the same contraction;
//   Chebyshev S = 5: T_0..T_4 of t = tanh(x) (degree 4);
//   Fourier   S = 2G: cos(kx) for k = 1..G, then sin(kx) for k = 1..G, with
//             G at run time (28 in the ViT's patch embedder).
//
// Replaces the TPU kernels of kanvit/kernels/fused_basis.py:
//   forward:  _fused_fwd (pallas_call at :1067) and its out-blocked tier
//             _fused_fwd_ob (:777), reached from bspline_kan (:3556),
//             chebykan (:3779) and fourierkan (:3748) below its K-blocked
//             tier; fourierkan's K-blocked _fused_fwd_kb (:2317,
//             _fwd_kernel_kbf); _fused_fwd_sg (:1240), reached
//             from bspline_qkv_grouped (:1361) and cheby_qkv_grouped (:1395),
//             the q/k/v projection of every head in one launch;
//   backward: _fused_bwd (:1159), _fused_bwd_ob (:810) and the split pair
//             _fused_fwd_basis (:969) + _fused_bwd_split (:1006), reached
//             from the VJPs of _bspline_op (:2624), _cheby_op (:3499) and
//             _fourier_op (:3472); fourierkan's K-blocked _fused_bwd_kb dx
//             (:2492, _dx_kernel_kbf) and dW (:2564, _dw_kernel_kbf);
//             _fused_bwd_sg (:1278), reached from the VJPs of _bspline_op_sg
//             (:1330) and _cheby_op_sg (:1351).
// `groups` = 1 for a layer, = H for the grouped q/k/v.
//
//   y[n, g*nout + o]  = sum_i sum_s B_s(x[n, g*nin + i]) * W[g, s, i, o]
//   dx[n, g*nin + i]  = sum_s B'_s(x[n, g*nin + i]) * sum_o gy[n, g*nout + o] W[g, s, i, o]
//   dW[g, s, i, o]    = sum_n B_s(x[n, g*nin + i]) * gy[n, g*nout + o]
//
// A family (the structs below) gives the slices of one input value in
// chunks of SC: the values and x-derivatives of chunk c, and which stored
// slice each chunk entry is. B-spline and Chebyshev are one chunk. Fourier
// runs in chunks of 4 harmonics (8 slices: their cos and sin), so no tile or
// register array grows with G: at G = 28 a 56-slice chunk would need 2 x 448
// x 64 floats of forward tiles (229 KB, over a block's shared memory) and
// 448 accumulators a thread in dx and dW. Each harmonic is sincosf(k * x)
// with k * x rounded to f32, the reference's arithmetic (nfkan.py, kanvit's
// plain fourier_bases): one sincosf per value, harmonic and output tile.
// kanvit's TPU kernel (_fwd_kernel_kbf) builds them from one sincos(x) pair
// by angle addition instead, which a chunked walk would have to carry from
// chunk to chunk; its drift over 28 harmonics put dx ~40x further from the
// plain version, for a few percent of the kernels' time. B-spline stages its knots and the reciprocals of the knot differences in
// shared memory; the other families stage nothing. IEEE tanhf, sincosf and
// expf throughout: the arguments of sincosf reach 28 |x|, far outside where
// __sinf is accurate, and tanh.approx's 2^-11 error would show in T_4.
//
// What bounds them on the H100: the contractions, in f32 FMAs on the CUDA
// cores (no tensor cores; f32 peak ~67 TFLOP/s). At the ViT-S embedder
// (N = 64*196, 768 -> 384) each of y, dx and dW is 2*N*S*768*384 FLOPs,
// 67 GFLOP for B-spline, 37 for Chebyshev and 414 for Fourier G = 28,
// against ~70-110 MB of x, y (or gy) and W: far above the ridge point.
//
// Forward: a block owns a BM x BN tile of (rows x outputs) of one group and
// walks the group's input features in chunks of BK and, inside, the
// family's slice chunks. Per step it evaluates the SC slices of its BM x BK
// inputs into shared memory, stages the matching SC x BK x BN weight tile,
// and accumulates a 4 x 4 register tile per thread with f32 FMAs (Fourier:
// each step into its own sums, then added). The basis is recomputed once per
// output tile (nout / BN times) instead of stored.
//
// dx: a block owns DX_BM rows x DX_BK features of one group and, for each
// slice chunk, walks the outputs in chunks of DX_BO: gW = gy W^T for the
// chunk's slices accumulates in registers (4 rows x 2 features x SC slices
// a thread) and is reduced against the chunk's derivatives; gW never leaves
// registers. gy is read once per slice chunk.
//
// dW: a block owns DW_BF features x one slice chunk x DW_BN outputs of one
// group and streams rows in chunks of DW_BR, recomputing its features'
// basis for each chunk. Blocks on Hopper run in no order, so where the
// (feature x chunk x output) tiles are too few to fill the card the rows are
// cut into a fixed number of splits, each split writes its partial dW, and a
// second pass sums the splits in a fixed order. No atomics: two runs give
// the same bits.
//
// Edge semantics follow kanvit_torch/ops/kan_bases.py: B-spline order-0
// bases are the half-open indicators g_j <= x < g_{j+1}, so x on a knot
// starts the next interval and x outside every span gets all-zero spline
// bases and derivatives; where tanh(x) rounds to +-1 the Chebyshev
// derivative is T'_n(+-1) * (1 - t^2) = 0. Ragged rows, outputs, features
// and Fourier's last chunk are masked in-kernel. Tensor cores, TMA and a
// pipelined ring of tiles are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// forward tiles (BK, the features per chunk, is the family's)
constexpr int BM = 64;             // rows per block
constexpr int BN = 64;             // outputs per block
constexpr int TM = 4;              // rows per thread
constexpr int TN = 4;              // outputs per thread
constexpr int TX = BN / TN;        // 16
constexpr int TY = BM / TM;        // 16
constexpr int THREADS = TX * TY;   // 256

// dx tiles (DX_BK, the features per block, is the family's)
constexpr int DX_BM = 64;          // rows per block
constexpr int DX_BO = 32;          // outputs per chunk
constexpr int DX_TM = 4;           // rows per thread (contiguous)
constexpr int DX_TF = 2;           // features per thread (contiguous)
constexpr int DX_TY = DX_BM / DX_TM;  // 16

// dW tiles
constexpr int DW_BF = 8;           // input features per block
constexpr int DW_BN = 64;          // outputs per block
constexpr int DW_BR = 32;          // rows per chunk
constexpr int DW_TF = 2;           // features per thread (contiguous)
constexpr int DW_TN = 4;           // outputs per thread (contiguous)
constexpr int DW_TX = DW_BN / DW_TN;  // 16
constexpr int DW_TY = DW_BF / DW_TF;  // 4
constexpr int DW_THREADS = DW_TX * DW_TY;  // 64

__device__ __forceinline__ float silu(float xv) {
  return xv / (1.f + expf(-xv));
}

// ---------------------------------------------------------------------------
// Families
// ---------------------------------------------------------------------------

struct Empty {};

// B-spline: 12 knots a feature (grid 5, order 3), 8 spline bases + silu.
struct Bspline {
  static constexpr int KNOTS = 12;
  static constexpr int ORDER = 3;
  static constexpr int NSPLINE = KNOTS - ORDER - 1;
  static constexpr int NINV = ORDER * KNOTS;
  static constexpr int SC = NSPLINE + 1;  // one chunk: all 9 slices
  static constexpr int BK = 8;
  static constexpr int DX_BK = 16;
  static constexpr bool STEP_SUMS = false;
  struct Params { const float* gridt; };  // (12, nin) row-major
  // knots[kf][j], inv[kf][(k-1)*KNOTS + j] = 1 / (g[j+k] - g[j])
  template <int NF> struct Stage { float knots[NF][KNOTS]; float inv[NF][NINV]; };

  __host__ __device__ static int slices(Params) { return SC; }
  __host__ __device__ static int chunks(Params) { return 1; }
  __device__ static int slice(Params, int, int j) { return j; }

  // Knots of features [k0, k0 + NF) and their reciprocals into shared
  // memory. Every thread of the block must call it (it synchronises).
  template <int NF>
  __device__ static void stage(Params p, int nin, int k0, Stage<NF>& st) {
    const int tid = threadIdx.x, nt = blockDim.x;
    for (int e = tid; e < NF * KNOTS; e += nt) {
      const int kf = e / KNOTS, j = e % KNOTS, i = k0 + kf;
      st.knots[kf][j] = i < nin ? p.gridt[(long long)j * nin + i] : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < NF * NINV; e += nt) {
      const int kf = e / NINV, r = e % NINV;
      const int k = r / KNOTS + 1, j = r % KNOTS;
      st.inv[kf][r] = (j + k < KNOTS && k0 + kf < nin)
                          ? 1.f / (st.knots[kf][j + k] - st.knots[kf][j]) : 0.f;
    }
    __syncthreads();
  }

  // Cox-de Boor from the order-0 indicators up to order UPTO, in place:
  // b[0 .. KNOTS-2-UPTO] hold the bases of that order.
  template <int UPTO>
  __device__ __forceinline__ static void levels(float xv, const float* gk,
                                                const float* iv,
                                                float (&b)[KNOTS - 1]) {
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

  template <int NF>
  __device__ __forceinline__ static void values(Params, const Stage<NF>& st,
                                                int kf, float xv, int,
                                                float (&v)[SC]) {
    float b[KNOTS - 1];
    levels<ORDER>(xv, st.knots[kf], st.inv[kf], b);
#pragma unroll
    for (int s = 0; s < NSPLINE; ++s) v[s] = b[s];
    v[NSPLINE] = silu(xv);
  }

  // B'_{3,j} = 3 (B_{2,j} / (g_{j+3} - g_j) - B_{2,j+1} / (g_{j+4} - g_{j+1}))
  // (the closed form of kanvit's bspline_family._levels, fused_basis.py:
  // 451-483) and silu'(x) = sig + silu (1 - sig).
  template <int NF>
  __device__ __forceinline__ static void derivs(Params, const Stage<NF>& st,
                                                int kf, float xv, int,
                                                float (&d)[SC]) {
    float b[KNOTS - 1];
    levels<ORDER - 1>(xv, st.knots[kf], st.inv[kf], b);  // order-2 bases
    const float* iv3 = st.inv[kf] + (ORDER - 1) * KNOTS;
#pragma unroll
    for (int j = 0; j < NSPLINE; ++j)
      d[j] = ORDER * (b[j] * iv3[j] - b[j + 1] * iv3[j + 1]);
    const float sig = 1.f / (1.f + expf(-xv));
    const float sl = xv * sig;
    d[NSPLINE] = sig + sl * (1.f - sig);
  }
};

// Chebyshev, degree 4: T_n = 2 t T_{n-1} - T_{n-2} on t = tanh(x) (kanvit's
// cheby_family, fused_basis.py:251-285), T'_n = 2 T_{n-1} + 2 t T'_{n-1} -
// T'_{n-2}, times dt/dx = 1 - t^2.
struct Cheby {
  static constexpr int SC = 5;
  static constexpr int BK = 16;
  static constexpr int DX_BK = 16;
  static constexpr bool STEP_SUMS = false;
  using Params = Empty;
  template <int NF> using Stage = Empty;

  __host__ __device__ static int slices(Params) { return SC; }
  __host__ __device__ static int chunks(Params) { return 1; }
  __device__ static int slice(Params, int, int j) { return j; }
  template <int NF>
  __device__ static void stage(Params, int, int, Stage<NF>&) {}

  template <int NF>
  __device__ __forceinline__ static void values(Params, const Stage<NF>&, int,
                                                float xv, int, float (&v)[SC]) {
    const float t = tanhf(xv);
    v[0] = 1.f;
    v[1] = t;
#pragma unroll
    for (int n = 2; n < SC; ++n) v[n] = 2.f * t * v[n - 1] - v[n - 2];
  }

  template <int NF>
  __device__ __forceinline__ static void derivs(Params, const Stage<NF>&, int,
                                                float xv, int, float (&d)[SC]) {
    const float t = tanhf(xv);
    float tp = 1.f, tc = t;  // T_{n-2}, T_{n-1}
    d[0] = 0.f;
    d[1] = 1.f;
#pragma unroll
    for (int n = 2; n < SC; ++n) {
      d[n] = 2.f * tc + 2.f * t * d[n - 1] - d[n - 2];
      const float tn = 2.f * t * tc - tp;
      tp = tc;
      tc = tn;
    }
    const float dtdx = 1.f - t * t;
#pragma unroll
    for (int n = 0; n < SC; ++n) d[n] *= dtdx;
  }
};

// Fourier, G harmonics at run time, in chunks of HC = 4: chunk c holds
// harmonics k = 4c+1 .. 4c+4, entry j < 4 is cos(kx) (stored slice k-1) and
// entry 4 + j is sin(kx) (stored slice G + k-1).
struct Fourier {
  static constexpr int HC = 4;
  static constexpr int SC = 2 * HC;
  static constexpr int BK = 8;
  static constexpr int DX_BK = 16;
  // The forward reduces over 2G * nin entries (43008 in the ViT's patch
  // embedder): one FMA chain that long strays ~1e-5 relative from the
  // exact sum; step sums of 64 entries cut that ~5x, to cuBLAS's level,
  // at no measurable cost.
  static constexpr bool STEP_SUMS = true;
  struct Params { int grid_size; };
  template <int NF> using Stage = Empty;

  __host__ __device__ static int slices(Params p) { return 2 * p.grid_size; }
  __host__ __device__ static int chunks(Params p) { return (p.grid_size + HC - 1) / HC; }
  __device__ static int slice(Params p, int c, int j) {
    const int h = c * HC + (j % HC);  // harmonic k - 1
    if (h >= p.grid_size) return -1;
    return j < HC ? h : p.grid_size + h;
  }
  template <int NF>
  __device__ static void stage(Params, int, int, Stage<NF>&) {}

  // cos and sin of harmonics 4c+1 .. 4c+4 into ch[], sh[].
  __device__ __forceinline__ static void harmonics(float xv, int c,
                                                   float (&ch)[HC],
                                                   float (&sh)[HC]) {
#pragma unroll
    for (int q = 0; q < HC; ++q) {
      const float kx = (float)(c * HC + q + 1) * xv;  // rounded, as the reference
      sincosf(kx, &sh[q], &ch[q]);
    }
  }

  template <int NF>
  __device__ __forceinline__ static void values(Params, const Stage<NF>&, int,
                                                float xv, int c, float (&v)[SC]) {
    float ch[HC], sh[HC];
    harmonics(xv, c, ch, sh);
#pragma unroll
    for (int q = 0; q < HC; ++q) {
      v[q] = ch[q];
      v[HC + q] = sh[q];
    }
  }

  // d cos(kx)/dx = -k sin(kx), d sin(kx)/dx = k cos(kx)
  template <int NF>
  __device__ __forceinline__ static void derivs(Params, const Stage<NF>&, int,
                                                float xv, int c, float (&d)[SC]) {
    float ch[HC], sh[HC];
    harmonics(xv, c, ch, sh);
#pragma unroll
    for (int q = 0; q < HC; ++q) {
      const float k = (float)(c * HC + q + 1);
      d[q] = -k * sh[q];
      d[HC + q] = k * ch[q];
    }
  }
};

// ---------------------------------------------------------------------------
// Kernels
// ---------------------------------------------------------------------------

// s[i][j] += sum over the KS staged entries of as[kk][row i] * bs[kk][out j],
// a TM x TN register tile of f32 FMAs.
template <int KS>
__device__ __forceinline__ void fma_tile(const float (*as)[BM],
                                         const float (*bs)[BN], int tx, int ty,
                                         float (&s)[TM][TN]) {
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
      for (int j = 0; j < TN; ++j) s[i][j] = fmaf(a[i], bv[j], s[i][j]);
  }
}

template <class F>
__global__ void __launch_bounds__(THREADS)
kan_fwd_kernel(const float* __restrict__ x, long long ldx,
               typename F::Params p, const float* __restrict__ w,
               float* __restrict__ y, int n, int groups, int nin, int nout) {
  constexpr int BK = F::BK;
  constexpr int SC = F::SC;
  constexpr int KS = SC * BK;         // reduction entries per step
  __shared__ float as[KS][BM];        // basis values, [j*BK + kf][row]
  __shared__ float bs[KS][BN];        // weight tile,  [j*BK + kf][out]
  __shared__ typename F::template Stage<BK> st;

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int o0 = blockIdx.x * BN;
  const int r0 = blockIdx.y * BM;
  const int g = blockIdx.z;
  const int slices = F::slices(p), nchunks = F::chunks(p);
  const float* wg = w + (long long)g * slices * nin * nout;
  const long long ldy = (long long)groups * nout;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < nin; k0 += BK) {
    F::template stage<BK>(p, nin, k0, st);
    for (int c = 0; c < nchunks; ++c) {
      // (1) the chunk's basis values of each (row, feature).
      for (int e = tid; e < BM * BK; e += THREADS) {
        const int m = e % BM, kf = e / BM;
        const int row = r0 + m, i = k0 + kf;
        float v[SC] = {};
        const bool live = row < n && i < nin;
        if (live) {
          F::template values<BK>(p, st, kf, x[(long long)row * ldx + (long long)g * nin + i],
                                 c, v);
        }
#pragma unroll
        for (int j = 0; j < SC; ++j) as[j * BK + kf][m] = live ? v[j] : 0.f;
      }

      // (2) the weight tile W[g, slice(c, j), k0:k0+BK, o0:o0+BN].
      for (int e = tid; e < KS * BN; e += THREADS) {
        const int col = e % BN, r = e / BN;
        const int s = F::slice(p, c, r / BK), i = k0 + r % BK, o = o0 + col;
        bs[r][col] = (s >= 0 && i < nin && o < nout)
                         ? wg[((long long)s * nin + i) * nout + o] : 0.f;
      }
      __syncthreads();

      // (3) register-tiled f32 FMAs over the step's SC * BK entries: into
      // acc, or, for a family with STEP_SUMS, into the step's own sums,
      // added to acc after it (a two-level sum of the deep reduction).
      if constexpr (F::STEP_SUMS) {
        float part[TM][TN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) part[i][j] = 0.f;
        fma_tile<KS>(as, bs, tx, ty, part);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] += part[i][j];
      } else {
        fma_tile<KS>(as, bs, tx, ty, acc);
      }
      __syncthreads();
    }
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

template <class F>
__global__ void __launch_bounds__(F::DX_BK / DX_TF * DX_TY)
kan_dx_kernel(const float* __restrict__ x, long long ldx,
              typename F::Params p, const float* __restrict__ w,
              const float* __restrict__ gy, float* __restrict__ dx,
              int n, int groups, int nin, int nout) {
  constexpr int BK = F::DX_BK;
  constexpr int SC = F::SC;
  constexpr int TXN = BK / DX_TF;
  constexpr int NT = TXN * DX_TY;
  // +4 pads keep the float4 / float2 reads aligned and spread the
  // transposing stores over more banks.
  __shared__ __align__(16) float gs[DX_BO][DX_BM + 4];      // gy^T tile
  __shared__ __align__(16) float ws[DX_BO][SC * BK + 4];    // [out][j*BK + kf]
  __shared__ typename F::template Stage<BK> st;

  const int tid = threadIdx.x;
  const int tx = tid % TXN;
  const int ty = tid / TXN;
  const int k0 = blockIdx.x * BK;
  const int r0 = blockIdx.y * DX_BM;
  const int g = blockIdx.z;
  const int slices = F::slices(p), nchunks = F::chunks(p);
  const float* wg = w + (long long)g * slices * nin * nout;
  const long long ldg = (long long)groups * nout;
  const float* gyg = gy + (long long)g * nout;

  F::template stage<BK>(p, nin, k0, st);

  float out[DX_TM][DX_TF];
#pragma unroll
  for (int r = 0; r < DX_TM; ++r)
#pragma unroll
    for (int f = 0; f < DX_TF; ++f) out[r][f] = 0.f;

  for (int c = 0; c < nchunks; ++c) {
    float acc[DX_TM][DX_TF][SC];
#pragma unroll
    for (int r = 0; r < DX_TM; ++r)
#pragma unroll
      for (int f = 0; f < DX_TF; ++f)
#pragma unroll
        for (int j = 0; j < SC; ++j) acc[r][f][j] = 0.f;

    for (int o0 = 0; o0 < nout; o0 += DX_BO) {
      for (int e = tid; e < DX_BO * DX_BM; e += NT) {
        const int col = e % DX_BO, m = e / DX_BO;
        const int row = r0 + m, o = o0 + col;
        gs[col][m] = (row < n && o < nout) ? gyg[(long long)row * ldg + o] : 0.f;
      }
      for (int e = tid; e < DX_BO * SC * BK; e += NT) {
        const int col = e % DX_BO, r = e / DX_BO;
        const int s = F::slice(p, c, r / BK), i = k0 + r % BK, o = o0 + col;
        ws[col][r] = (s >= 0 && i < nin && o < nout)
                         ? wg[((long long)s * nin + i) * nout + o] : 0.f;
      }
      __syncthreads();

#pragma unroll 2
      for (int col = 0; col < DX_BO; ++col) {
        const float4 gv = *reinterpret_cast<const float4*>(&gs[col][ty * DX_TM]);
        const float a[DX_TM] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          const float2 wv =
              *reinterpret_cast<const float2*>(&ws[col][j * BK + tx * DX_TF]);
#pragma unroll
          for (int r = 0; r < DX_TM; ++r) {
            acc[r][0][j] = fmaf(a[r], wv.x, acc[r][0][j]);
            acc[r][1][j] = fmaf(a[r], wv.y, acc[r][1][j]);
          }
        }
      }
      __syncthreads();
    }

    // Reduce the chunk's gW against its derivatives.
#pragma unroll
    for (int f = 0; f < DX_TF; ++f) {
      const int kf = tx * DX_TF + f, i = k0 + kf;
      if (i >= nin) continue;
#pragma unroll
      for (int r = 0; r < DX_TM; ++r) {
        const int row = r0 + ty * DX_TM + r;
        if (row >= n) continue;
        float d[SC];
        F::template derivs<BK>(p, st, kf, x[(long long)row * ldx + (long long)g * nin + i],
                               c, d);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < SC; ++j) sum = fmaf(acc[r][f][j], d[j], sum);
        out[r][f] += sum;
      }
    }
  }

  const long long ldd = (long long)groups * nin;
#pragma unroll
  for (int f = 0; f < DX_TF; ++f) {
    const int i = k0 + tx * DX_TF + f;
    if (i >= nin) continue;
#pragma unroll
    for (int r = 0; r < DX_TM; ++r) {
      const int row = r0 + ty * DX_TM + r;
      if (row < n) dx[(long long)row * ldd + (long long)g * nin + i] = out[r][f];
    }
  }
}

template <class F>
__global__ void __launch_bounds__(DW_THREADS)
kan_dw_kernel(const float* __restrict__ x, long long ldx,
              typename F::Params p, const float* __restrict__ gy,
              float* __restrict__ dw, int n, int groups, int nin, int nout,
              int rows_per_split) {
  constexpr int SC = F::SC;
  __shared__ __align__(16) float bsm[DW_BR][SC * DW_BF];  // [row][j*BF + kf]
  __shared__ __align__(16) float gsm[DW_BR][DW_BN];
  __shared__ typename F::template Stage<DW_BF> st;

  const int tid = threadIdx.x;
  const int tx = tid % DW_TX;
  const int ty = tid / DW_TX;
  const int ftiles = (nin + DW_BF - 1) / DW_BF;
  const int o0 = blockIdx.x * DW_BN;
  const int k0 = (blockIdx.y % ftiles) * DW_BF;
  const int c = blockIdx.y / ftiles;  // slice chunk
  const int g = blockIdx.z % groups;
  const int split = blockIdx.z / groups;
  const long long rbeg = (long long)split * rows_per_split;
  const long long rend = min((long long)n, rbeg + rows_per_split);
  const long long ldg = (long long)groups * nout;
  const float* gyg = gy + (long long)g * nout;

  F::template stage<DW_BF>(p, nin, k0, st);

  float acc[SC][DW_TF][DW_TN];
#pragma unroll
  for (int j = 0; j < SC; ++j)
#pragma unroll
    for (int f = 0; f < DW_TF; ++f)
#pragma unroll
      for (int q = 0; q < DW_TN; ++q) acc[j][f][q] = 0.f;

  for (long long r0 = rbeg; r0 < rend; r0 += DW_BR) {
    // the chunk's basis values of the (row, feature) pairs
    for (int e = tid; e < DW_BR * DW_BF; e += DW_THREADS) {
      const int m = e % DW_BR, kf = e / DW_BR;
      const long long row = r0 + m;
      const int i = k0 + kf;
      const bool live = row < rend && i < nin;
      float v[SC] = {};
      if (live) F::template values<DW_BF>(p, st, kf, x[row * ldx + (long long)g * nin + i], c, v);
#pragma unroll
      for (int j = 0; j < SC; ++j) bsm[m][j * DW_BF + kf] = live ? v[j] : 0.f;
    }
    for (int e = tid; e < DW_BR * DW_BN; e += DW_THREADS) {
      const int col = e % DW_BN, m = e / DW_BN;
      const long long row = r0 + m;
      const int o = o0 + col;
      gsm[m][col] = (row < rend && o < nout) ? gyg[row * ldg + o] : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int m = 0; m < DW_BR; ++m) {
      const float4 gv = *reinterpret_cast<const float4*>(&gsm[m][tx * DW_TN]);
      const float c4[DW_TN] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const float2 bv =
            *reinterpret_cast<const float2*>(&bsm[m][j * DW_BF + ty * DW_TF]);
#pragma unroll
        for (int q = 0; q < DW_TN; ++q) {
          acc[j][0][q] = fmaf(bv.x, c4[q], acc[j][0][q]);
          acc[j][1][q] = fmaf(bv.y, c4[q], acc[j][1][q]);
        }
      }
    }
    __syncthreads();
  }

  // dw (this split's slab): [split][g][s][i][o]
  const int slices = F::slices(p);
  float* dst = dw + ((long long)split * groups + g) * slices * nin * nout;
#pragma unroll
  for (int j = 0; j < SC; ++j) {
    const int s = F::slice(p, c, j);
    if (s < 0) continue;
#pragma unroll
    for (int f = 0; f < DW_TF; ++f) {
      const int i = k0 + ty * DW_TF + f;
      if (i >= nin) continue;
#pragma unroll
      for (int q = 0; q < DW_TN; ++q) {
        const int o = o0 + tx * DW_TN + q;
        if (o < nout) dst[((long long)s * nin + i) * nout + o] = acc[j][f][q];
      }
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

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <class F>
int launch_fwd(const float* x, long long ldx, typename F::Params p,
               const float* w, float* y, int n, int groups, int nin, int nout,
               void* stream) {
  if (n <= 0 || groups <= 0 || nin <= 0 || nout <= 0 || F::slices(p) <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((nout + BN - 1) / BN, (n + BM - 1) / BM, groups);
  if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidValue;
  kan_fwd_kernel<F><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      x, ldx, p, w, y, n, groups, nin, nout);
  return (int)cudaGetLastError();
}

template <class F>
int launch_bwd(const float* x, long long ldx, typename F::Params p,
               const float* w, const float* gy, float* dx, float* dw,
               float* dw_part, int n, int groups, int nin, int nout, int splits,
               void* stream) {
  if (n <= 0 || groups <= 0 || nin <= 0 || nout <= 0 || splits <= 0 ||
      F::slices(p) <= 0 || (splits > 1 && dw != nullptr && dw_part == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dx != nullptr) {
    const dim3 grid((nin + F::DX_BK - 1) / F::DX_BK, (n + DX_BM - 1) / DX_BM,
                    groups);
    if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidValue;
    kan_dx_kernel<F><<<grid, F::DX_BK / DX_TF * DX_TY, 0, st>>>(
        x, ldx, p, w, gy, dx, n, groups, nin, nout);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  if (dw != nullptr) {
    long long per = ((long long)n + splits - 1) / splits;
    per = (per + DW_BR - 1) / DW_BR * DW_BR;
    const long long gy_blocks =
        (long long)((nin + DW_BF - 1) / DW_BF) * F::chunks(p);
    const dim3 grid((nout + DW_BN - 1) / DW_BN, (unsigned)gy_blocks,
                    groups * splits);
    if (gy_blocks > 65535 || (long long)groups * splits > 65535 || per > 0x7fffffff)
      return (int)cudaErrorInvalidValue;
    kan_dw_kernel<F><<<grid, DW_THREADS, 0, st>>>(
        x, ldx, p, gy, splits > 1 ? dw_part : dw, n, groups, nin, nout,
        (int)per);
    int err = (int)cudaGetLastError();
    if (err != 0) return err;
    if (splits > 1) {
      const long long total = (long long)groups * F::slices(p) * nin * nout;
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

}  // namespace

// Forward: x (n, groups*nin) f32 with row stride ldx and unit column stride;
// w (groups, S, nin, nout) f32 contiguous; y (n, groups*nout) f32
// contiguous. Launches on `stream` and returns cudaGetLastError() (0 on
// success).
//
// Backward: x and w as there; gy (n, groups*nout) f32 contiguous, the
// gradient of y; dx (n, groups*nin) f32 contiguous, or null to skip it; dw
// (groups, S, nin, nout) f32 contiguous, or null to skip it. splits >= 1
// cuts the rows of the dW reduction into that many parts; with splits > 1,
// dw_part is scratch of splits * groups * S * nin * nout floats, summed
// into dw by a second pass.

// B-spline: gridt (12, nin) f32 row-major, S = 9.
extern "C" int kanvit_bspline_kan_fwd(const float* x, long long ldx,
                                      const float* gridt, const float* w,
                                      float* y, int n, int groups, int nin,
                                      int nout, void* stream) {
  return launch_fwd<Bspline>(x, ldx, {gridt}, w, y, n, groups, nin, nout, stream);
}

extern "C" int kanvit_bspline_kan_bwd(const float* x, long long ldx,
                                      const float* gridt, const float* w,
                                      const float* gy, float* dx, float* dw,
                                      float* dw_part, int n, int groups,
                                      int nin, int nout, int splits,
                                      void* stream) {
  return launch_bwd<Bspline>(x, ldx, {gridt}, w, gy, dx, dw, dw_part, n,
                             groups, nin, nout, splits, stream);
}

// Chebyshev, degree 4: S = 5.
extern "C" int kanvit_chebykan_fwd(const float* x, long long ldx,
                                   const float* w, float* y, int n, int groups,
                                   int nin, int nout, void* stream) {
  return launch_fwd<Cheby>(x, ldx, {}, w, y, n, groups, nin, nout, stream);
}

extern "C" int kanvit_chebykan_bwd(const float* x, long long ldx,
                                   const float* w, const float* gy, float* dx,
                                   float* dw, float* dw_part, int n, int groups,
                                   int nin, int nout, int splits, void* stream) {
  return launch_bwd<Cheby>(x, ldx, {}, w, gy, dx, dw, dw_part, n, groups, nin,
                           nout, splits, stream);
}

// Fourier, grid_size G >= 1 harmonics: S = 2G.
extern "C" int kanvit_fourierkan_fwd(const float* x, long long ldx,
                                     const float* w, float* y, int n,
                                     int groups, int nin, int nout,
                                     int grid_size, void* stream) {
  return launch_fwd<Fourier>(x, ldx, {grid_size}, w, y, n, groups, nin, nout,
                             stream);
}

extern "C" int kanvit_fourierkan_bwd(const float* x, long long ldx,
                                     const float* w, const float* gy,
                                     float* dx, float* dw, float* dw_part,
                                     int n, int groups, int nin, int nout,
                                     int grid_size, int splits, void* stream) {
  return launch_bwd<Fourier>(x, ldx, {grid_size}, w, gy, dx, dw, dw_part, n,
                             groups, nin, nout, splits, stream);
}
