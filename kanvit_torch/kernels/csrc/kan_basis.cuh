// Fused KAN layers, forward and backward: expand x into a parameter-free
// basis and contract it against the packed weight (forward), or reduce the
// output gradient back through the same basis (backward), without writing
// the basis to memory. One set of templated kernels, instantiated per basis
// family: kan_basis.cu holds B-spline, Chebyshev and Fourier (its dx),
// kan_rbf_sine.cu the RBF (FastKAN, with its LayerNorm) and sine families.
// `groups` = 1 for a layer, = H for a grouped q/k/v projection. The Fourier
// and sine embedders' forward and dW, every grouped q/k/v backward and the
// B-spline grouped forward run on the tensor cores instead
// (kan_basis_tc.cuh).
//
//   y[n, g*nout + o]  = sum_i sum_s B_s(x[n, g*nin + i]) * W[g, s, i, o]
//   dx[n, g*nin + i]  = sum_s B'_s(x[n, g*nin + i]) * sum_o gy[n, g*nout + o] W[g, s, i, o]
//   dW[g, s, i, o]    = sum_n B_s(x[n, g*nin + i]) * gy[n, g*nout + o]
//
// A family gives the slices of one input value in chunks of SC: the values
// of chunk c and which stored slice each chunk entry is, and for dx either
// the x-derivatives (`derivs`) or, with DX_FOLD, its own fold of the
// chunk's gW = gy W^T into up to two per-element outputs and, with DX_RED,
// into per-slice sums reduced over the block (sine's dfreq). The family
// sees each input as an Elem: the value, its feature, group and row.
//
// What bounds the kernels on the H100: the contractions, in f32 FMAs on the
// CUDA cores (no tensor cores; f32 peak ~67 TFLOP/s), far above the ridge
// point at the ViT's shapes.
//
// Forward: a block owns a BM x BN tile of (rows x outputs) of one group and
// walks the group's input features in chunks of BK and, inside, the
// family's slice chunks. Per step it evaluates the SC slices of its BM x BK
// inputs into shared memory, stages the matching SC x BK x BN weight tile,
// and accumulates a 4 x 4 register tile per thread with f32 FMAs (with
// STEP_SUMS: each step into its own sums, then added). The basis is
// recomputed once per output tile (nout / BN times) instead of stored.
//
// dx: a block owns DX_BM rows x DX_BK features of one group and, for each
// slice chunk, walks the outputs in chunks of DX_BO: gW = gy W^T for the
// chunk's slices accumulates in registers (4 rows x 2 features x SC slices
// a thread) and is folded into the outputs; gW never leaves registers.
//
// dW: a block owns DW_BF features x one slice chunk x DW_BN outputs of one
// group and streams rows in chunks of DW_BR, recomputing its features'
// basis for each chunk. Blocks on Hopper run in no order, so where the
// (feature x chunk x output) tiles are too few to fill the card the rows are
// cut into a fixed number of splits, each split writes its partial dW, and a
// second pass sums the splits in a fixed order. Every cross-block sum here
// (dW splits, dfreq, the LayerNorm's dgamma and dbeta) is a fixed-order
// second pass, never an atomic: two runs give the same bits.
//
// Ragged rows, outputs, features and a family's last chunk are masked
// in-kernel. What still runs here: the B-spline, Chebyshev and RBF
// embedders (forward, and their dx and dW), every family's dx of the
// Fourier and sine embedders, the Chebyshev, RBF and sine grouped q/k/v
// forwards, and the sine grouped backward past 4 slices; kan_basis_tc.cuh
// takes the same families' values and derivatives onto the tensor cores.

#pragma once

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

// silu'(x) = sig + silu (1 - sig)
__device__ __forceinline__ float silu_grad(float xv) {
  const float sig = 1.f / (1.f + expf(-xv));
  const float sl = xv * sig;
  return sig + sl * (1.f - sig);
}

// One input value as a family sees it.
struct Elem {
  float x;         // x[row, g*nin + i]
  int kf;          // feature within the block's staged range
  int i;           // feature within the group
  int g;           // group
  long long row;
};

struct Empty {};

// What a family does not override: one FMA chain per output, dx from the
// family's `derivs`, no per-slice sums, no state carried from one chunk's
// fold to the next (DX_CARRY: kan_basis_tc.cuh part 4's dx hands the fold a
// Carry a (row, feature), chunk after chunk), and a chunk's slices stored in
// the packed weight in chunk order (wslice: where slice l of the chunk walk,
// chunk l / SC, is stored in a weight of `slices` slices; kan_basis_tc.cuh
// parts 3 and 4).
struct FamilyDefaults {
  static constexpr bool STEP_SUMS = false;
  static constexpr bool DX_FOLD = false;
  static constexpr bool DX_RED = false;
  static constexpr bool DX_CARRY = false;
  using Carry = Empty;
  __host__ __device__ static int wslice(int, int l) { return l; }
};

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
    F::template stage<BK>(p, nin, k0, g, st);
    for (int c = 0; c < nchunks; ++c) {
      // (1) the chunk's basis values of each (row, feature).
      for (int e = tid; e < BM * BK; e += THREADS) {
        const int m = e % BM, kf = e / BM;
        const int row = r0 + m, i = k0 + kf;
        float v[SC] = {};
        const bool live = row < n && i < nin;
        if (live) {
          const Elem el{x[(long long)row * ldx + (long long)g * nin + i], kf, i, g, row};
          F::template values<BK>(p, st, el, c, v);
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

// dx, or what the family folds gW into. Per element the kernel keeps two
// outputs: with `split`, o0 goes to out0 and o1 to out1 (either may be
// null); without, o0 + o1 goes to out0 (null: nothing is written). A DX_RED
// family's per-slice sums of each chunk are reduced over the block in a
// fixed order into red_part[g][block][slice] (null: skipped).
template <class F>
__global__ void __launch_bounds__(F::DX_BK / DX_TF * DX_TY)
kan_dx_kernel(const float* __restrict__ x, long long ldx,
              typename F::Params p, const float* __restrict__ w,
              const float* __restrict__ gy, float* __restrict__ out0,
              float* __restrict__ out1, int split,
              float* __restrict__ red_part, int n, int groups, int nin,
              int nout) {
  constexpr int BK = F::DX_BK;
  constexpr int SC = F::SC;
  constexpr int TXN = BK / DX_TF;
  constexpr int NT = TXN * DX_TY;
  // +4 pads keep the float4 / float2 reads aligned and spread the
  // transposing stores over more banks.
  __shared__ __align__(16) float gs[DX_BO][DX_BM + 4];      // gy^T tile
  __shared__ __align__(16) float ws[DX_BO][SC * BK + 4];    // [out][j*BK + kf]
  __shared__ float redsm[F::DX_RED ? SC : 1][NT];
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

  F::template stage<BK>(p, nin, k0, g, st);

  float o0[DX_TM][DX_TF], o1[DX_TM][DX_TF];
#pragma unroll
  for (int r = 0; r < DX_TM; ++r)
#pragma unroll
    for (int f = 0; f < DX_TF; ++f) o0[r][f] = o1[r][f] = 0.f;

  for (int c = 0; c < nchunks; ++c) {
    float acc[DX_TM][DX_TF][SC];
#pragma unroll
    for (int r = 0; r < DX_TM; ++r)
#pragma unroll
      for (int f = 0; f < DX_TF; ++f)
#pragma unroll
        for (int j = 0; j < SC; ++j) acc[r][f][j] = 0.f;

    for (int oc = 0; oc < nout; oc += DX_BO) {
      for (int e = tid; e < DX_BO * DX_BM; e += NT) {
        const int col = e % DX_BO, m = e / DX_BO;
        const int row = r0 + m, o = oc + col;
        gs[col][m] = (row < n && o < nout) ? gyg[(long long)row * ldg + o] : 0.f;
      }
      for (int e = tid; e < DX_BO * SC * BK; e += NT) {
        const int col = e % DX_BO, r = e / DX_BO;
        const int s = F::slice(p, c, r / BK), i = k0 + r % BK, o = oc + col;
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

    // Fold the chunk's gW into the outputs.
    float red[SC];
#pragma unroll
    for (int j = 0; j < SC; ++j) red[j] = 0.f;
#pragma unroll
    for (int f = 0; f < DX_TF; ++f) {
      const int kf = tx * DX_TF + f, i = k0 + kf;
      if (i >= nin) continue;
#pragma unroll
      for (int r = 0; r < DX_TM; ++r) {
        const int row = r0 + ty * DX_TM + r;
        if (row >= n) continue;
        const Elem el{x[(long long)row * ldx + (long long)g * nin + i], kf, i, g, row};
        if constexpr (F::DX_FOLD) {
          F::template fold<BK>(p, st, el, c, acc[r][f], o0[r][f], o1[r][f], red);
        } else {
          float d[SC];
          F::template derivs<BK>(p, st, el, c, d);
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < SC; ++j) sum = fmaf(acc[r][f][j], d[j], sum);
          o0[r][f] += sum;
        }
      }
    }
    if constexpr (F::DX_RED) {
      if (red_part != nullptr) {
#pragma unroll
        for (int j = 0; j < SC; ++j) redsm[j][tid] = red[j];
        __syncthreads();
        if (tid < SC) {
          const int s = F::slice(p, c, tid);
          if (s >= 0) {
            float sum = 0.f;
            for (int t = 0; t < NT; ++t) sum += redsm[tid][t];
            const long long blk =
                ((long long)g * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
            red_part[blk * slices + s] = sum;
          }
        }
        __syncthreads();
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
      if (row >= n) continue;
      const long long at = (long long)row * ldd + (long long)g * nin + i;
      if (split) {
        if (out0 != nullptr) out0[at] = o0[r][f];
        if (out1 != nullptr) out1[at] = o1[r][f];
      } else if (out0 != nullptr) {
        out0[at] = F::DX_FOLD ? o0[r][f] + o1[r][f] : o0[r][f];
      }
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

  F::template stage<DW_BF>(p, nin, k0, g, st);

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
      if (live) {
        const Elem el{x[row * ldx + (long long)g * nin + i], kf, i, g, row};
        F::template values<DW_BF>(p, st, el, c, v);
      }
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

// out[e] = sum over splits of part[split][e], in split order: one running
// sum, or with group > 0 two levels (the splits in groups of `group`, each
// group's running sum added into the total in order), whose rounding grows
// with splits / group + group rather than with splits.
__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, long long total,
                                  int splits, int group) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    float acc = 0.f;
    if (group <= 0) {
      for (int sp = 0; sp < splits; ++sp) acc += part[(long long)sp * total + e];
    } else {
      for (int g0 = 0; g0 < splits; g0 += group) {
        float sum = 0.f;
        for (int sp = g0; sp < min(splits, g0 + group); ++sp)
          sum += part[(long long)sp * total + e];
        acc += sum;
      }
    }
    out[e] = acc;
  }
}

int sum_splits(const float* part, float* out, long long total, int splits,
               cudaStream_t st, int group = 0) {
  const long long want = (total + 255) / 256;
  const long long blocks = want < 4096 ? want : 4096;
  sum_splits_kernel<<<(unsigned)blocks, 256, 0, st>>>(part, out, total, splits, group);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

bool bad_shape(int n, int groups, int nin, int nout) {
  return n <= 0 || groups <= 0 || nin <= 0 || nout <= 0;
}

template <class F>
int launch_fwd(const float* x, long long ldx, typename F::Params p,
               const float* w, float* y, int n, int groups, int nin, int nout,
               void* stream) {
  if (bad_shape(n, groups, nin, nout) || F::slices(p) <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((nout + BN - 1) / BN, (n + BM - 1) / BM, groups);
  if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidValue;
  kan_fwd_kernel<F><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      x, ldx, p, w, y, n, groups, nin, nout);
  return (int)cudaGetLastError();
}

// The dx kernel's launch grid: (feature tiles, row tiles, groups).
template <class F>
dim3 dx_grid(int n, int groups, int nin) {
  return dim3((nin + F::DX_BK - 1) / F::DX_BK, (n + DX_BM - 1) / DX_BM, groups);
}

template <class F>
int launch_dx(const float* x, long long ldx, typename F::Params p,
              const float* w, const float* gy, float* out0, float* out1,
              int split, float* red_part, int n, int groups, int nin, int nout,
              cudaStream_t st) {
  const dim3 grid = dx_grid<F>(n, groups, nin);
  if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidValue;
  kan_dx_kernel<F><<<grid, F::DX_BK / DX_TF * DX_TY, 0, st>>>(
      x, ldx, p, w, gy, out0, out1, split, red_part, n, groups, nin, nout);
  return (int)cudaGetLastError();
}

template <class F>
int launch_dw(const float* x, long long ldx, typename F::Params p,
              const float* gy, float* dw, float* dw_part, int n, int groups,
              int nin, int nout, int splits, cudaStream_t st) {
  if (splits <= 0 || (splits > 1 && dw_part == nullptr))
    return (int)cudaErrorInvalidValue;
  long long per = ((long long)n + splits - 1) / splits;
  per = (per + DW_BR - 1) / DW_BR * DW_BR;
  const long long gy_blocks = (long long)((nin + DW_BF - 1) / DW_BF) * F::chunks(p);
  const dim3 grid((nout + DW_BN - 1) / DW_BN, (unsigned)gy_blocks,
                  groups * splits);
  if (gy_blocks > 65535 || (long long)groups * splits > 65535 || per > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  kan_dw_kernel<F><<<grid, DW_THREADS, 0, st>>>(
      x, ldx, p, gy, splits > 1 ? dw_part : dw, n, groups, nin, nout, (int)per);
  const int err = (int)cudaGetLastError();
  if (err != 0 || splits == 1) return err;
  return sum_splits(dw_part, dw, (long long)groups * F::slices(p) * nin * nout,
                    splits, st);
}

// dx (from the family's derivatives) and dW, either of them null to skip it.
template <class F>
int launch_bwd(const float* x, long long ldx, typename F::Params p,
               const float* w, const float* gy, float* dx, float* dw,
               float* dw_part, int n, int groups, int nin, int nout, int splits,
               void* stream) {
  if (bad_shape(n, groups, nin, nout) || F::slices(p) <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dx != nullptr) {
    const int err = launch_dx<F>(x, ldx, p, w, gy, dx, nullptr, 0, nullptr, n,
                                 groups, nin, nout, st);
    if (err != 0) return err;
  }
  if (dw != nullptr)
    return launch_dw<F>(x, ldx, p, gy, dw, dw_part, n, groups, nin, nout,
                        splits, st);
  return 0;
}

}  // namespace
