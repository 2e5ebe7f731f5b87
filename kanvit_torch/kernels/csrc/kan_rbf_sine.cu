// The RBF (FastKAN) and sine (SineKAN) families of the fused KAN kernels
// (the kernels themselves: kan_basis.cuh), and the LayerNorm passes of the
// RBF layer.
//
//   RBF   S = 8 (+1): exp(-u_k^2), u_k = (LN(x) - c_k) / h, for the 8 grid
//         centres c_k, then silu(x) of the RAW x as slice 8 when the layer
//         has its base branch. LN is the layer's own LayerNorm over each
//         row's segment of nin features (the whole row in the patch
//         embedder, one head's d_head in the grouped projection), eps 1e-5,
//         biased variance, a per-group gamma and beta; without it (the
//         reference's time_benchmark flag) u_k = (x - c_k) / h.
//   Sine  S = G: sin(x * freq[g, s] + phase[i, s]), freq per group and
//         slice (trainable), phase per feature and slice (a constant
//         table), walked in chunks of 4 slices like Fourier's harmonics.
//
// Replaces the TPU kernels of kanvit/kernels/fused_basis.py:
//   RBF:  _rbf_ln_base_op fwd (pallas_call at :2947) and bwd (:2995), reached
//         from fastkan (:3600), the patch embedder; _rbf_ln_sg_op fwd
//         (:3191) and bwd (:3246), reached from fastkan_qkv_grouped (:3300),
//         one launch per q/k/v projection over every head; and the tiers
//         the same family covers with its flags: _rbf_base_op (:2726,
//         :2769; the LayerNorm skipped) and _rbf_op (_fused_fwd / _fused_bwd
//         under rbf_family; no silu slice).
//   Sine: the K-blocked _fused_fwd_kb (:2317), _fused_bwd_kb dx (:2492) and
//         dW + dfreq (:2523, _dw_kernel_kb_sine), reached from sinekan
//         (:3667), the grid-28 patch embedder, and below that tier
//         _fused_fwd (:1067) and _fused_bwd_sine_plain (:1728);
//         _sine_op_sg fwd (:1518) and bwd (:1557), reached from
//         sinekan_qkv_grouped (:1597); the opt-in _fused_fwd_kb_basis
//         (:2354) and _fused_bwd_kb_sine_res (:2401, :2433), and sinekan_qkv
//         (:3691), compute the same functions.
//
// What bounds them on the H100: the contractions, in f32 FMAs, and the
// transcendentals beside them. At the ViT-S embedder (N = 12,544, 768 ->
// 384) a pass is 2*N*S*768*384 FLOPs: 66.6 GFLOP for the RBF (S = 9), 207
// for the sine (S = 28); at the grouped q/k/v (N = 12,608, 6 heads of 64)
// 5.6 and 2.5. The basis is recomputed per 64-output tile: 6 x (8 expf +
// 1 silu) RBF and 6 x 28 sinf sine per (row, feature) in the forward and
// dW, once in dx. IEEE expf, sinf, cosf: the sine argument x*freq + phase
// stays within a few pi here, on sinf's fast path.
//
// The RBF's LayerNorm is part of the kernels, forward and backward:
//   stats: one warp per (row, group) segment: mean, then the biased
//          variance about it, rstd = 1 / sqrt(var + 1e-5), saved (n, G, 2)
//          for the backward;
//   fwd:   the family normalises each input from its row's stats and its
//          feature's gamma, beta (staged per block);
//   dx:    the fold keeps two gradients apart: dln = sum_k gW_k (-2u_k/h)
//          b_k, which goes through the LayerNorm's VJP, and gW_8 silu'(x),
//          which is the raw x's and is added after it. The VJP couples all
//          features of a segment, and a dx block owns only 16 of them, so a
//          second, row-wise pass (one warp per segment) adds
//          rstd (dxh - mean(dxh) - xh mean(dxh xh)), dxh = dln gamma.
//   dgamma, dbeta: column sums of dln xh and dln over the rows, per-block
//          partials over fixed row ranges, then a fixed-order second pass.
// The patch embedder's backward needs no dx (its input is the image) but
// dgamma and dbeta still need dln: the dln pass runs, the dx pass does not.
//
// Sine's dfreq_s = sum_{n,i} gW_s[n, i] x cos(arg) rides the dx kernel,
// where gW is in registers: per-block sums in a fixed order, then one block
// per (group, slice) sums the blocks in a fixed order. The embedder's
// backward needs dfreq but no dx: the dx kernel runs and writes no dx.

#include "kan_basis.cuh"

namespace {

constexpr float LN_EPS = 1e-5f;

struct Rbf : FamilyDefaults {
  static constexpr int NG = 8;           // RBF centres
  static constexpr int SC = NG + 1;      // one chunk: the RBF slices + silu
  static constexpr int BK = 8;
  static constexpr int DX_BK = 16;
  static constexpr bool DX_FOLD = true;
  struct Params {
    const float* stats;    // (n, groups, 2) mean, rstd; null: no LayerNorm
    const float* gamma;    // (groups, nin)
    const float* beta;     // (groups, nin)
    const float* centres;  // (NG,)
    float inv_h;           // 1 / the grid spacing h
    int groups;
    int base;              // 1: silu(x) is slice NG
  };
  template <int NF> struct Stage { float gamma[NF]; float beta[NF]; float c[NG]; };

  __host__ __device__ static int slices(Params p) { return NG + p.base; }
  __host__ __device__ static int chunks(Params) { return 1; }
  __device__ static int slice(Params p, int, int j) {
    return j < NG + p.base ? j : -1;
  }

  template <int NF>
  __device__ static void stage(Params p, int nin, int k0, int g, Stage<NF>& st) {
    const int tid = threadIdx.x;
    if (tid < NF) {
      const int i = k0 + tid;
      const bool live = p.stats != nullptr && i < nin;
      st.gamma[tid] = live ? p.gamma[(long long)g * nin + i] : 1.f;
      st.beta[tid] = live ? p.beta[(long long)g * nin + i] : 0.f;
    }
    if (tid < NG) st.c[tid] = p.centres[tid];
    __syncthreads();
  }

  // The RBF's input: LN(x) from the row's stats, or x itself.
  template <int NF>
  __device__ __forceinline__ static float normed(Params p, const Stage<NF>& st,
                                                 const Elem& e) {
    if (p.stats == nullptr) return e.x;
    const float* s = p.stats + (e.row * p.groups + e.g) * 2;
    return (e.x - s[0]) * s[1] * st.gamma[e.kf] + st.beta[e.kf];
  }

  template <int NF>
  __device__ __forceinline__ static void values(Params p, const Stage<NF>& st,
                                                const Elem& e, int,
                                                float (&v)[SC]) {
    const float ln = normed(p, st, e);
#pragma unroll
    for (int k = 0; k < NG; ++k) {
      const float u = (ln - st.c[k]) * p.inv_h;
      v[k] = expf(-u * u);
    }
    v[NG] = p.base ? silu(e.x) : 0.f;
  }

  // o0 += dln (the gradient of the RBF's input), o1 += gW_8 silu'(x).
  template <int NF>
  __device__ __forceinline__ static void fold(Params p, const Stage<NF>& st,
                                              const Elem& e, int,
                                              const float (&gw)[SC], float& o0,
                                              float& o1, float (&)[SC]) {
    const float ln = normed(p, st, e);
    const float coef = -2.f * p.inv_h;
    float dln = 0.f;
#pragma unroll
    for (int k = 0; k < NG; ++k) {
      const float u = (ln - st.c[k]) * p.inv_h;
      dln = fmaf(gw[k], coef * u * expf(-u * u), dln);
    }
    o0 += dln;
    if (p.base) o1 += gw[NG] * silu_grad(e.x);
  }
};

struct Sine : FamilyDefaults {
  static constexpr int SC = 4;
  static constexpr int BK = 16;
  static constexpr int DX_BK = 16;
  // 28 * 768 = 21,504-deep forward sums in the embedder: step sums, as
  // Fourier's.
  static constexpr bool STEP_SUMS = true;
  static constexpr bool DX_FOLD = true;
  static constexpr bool DX_RED = true;
  struct Params {
    const float* freq;   // (groups, S)
    const float* phase;  // (nin, S)
    int grid_size;       // S
  };
  template <int NF> using Stage = Empty;

  __host__ __device__ static int slices(Params p) { return p.grid_size; }
  __host__ __device__ static int chunks(Params p) { return (p.grid_size + SC - 1) / SC; }
  __device__ static int slice(Params p, int c, int j) {
    const int s = c * SC + j;
    return s < p.grid_size ? s : -1;
  }
  template <int NF>
  __device__ static void stage(Params, int, int, int, Stage<NF>&) {}

  __device__ __forceinline__ static float freq(Params p, const Elem& e, int s) {
    return __ldg(p.freq + (long long)e.g * p.grid_size + s);
  }
  __device__ __forceinline__ static float arg(Params p, const Elem& e, int s) {
    return e.x * freq(p, e, s) + __ldg(p.phase + (long long)e.i * p.grid_size + s);
  }

  template <int NF>
  __device__ __forceinline__ static void values(Params p, const Stage<NF>&,
                                                const Elem& e, int c,
                                                float (&v)[SC]) {
#pragma unroll
    for (int j = 0; j < SC; ++j) {
      const int s = c * SC + j;
      v[j] = s < p.grid_size ? sinf(arg(p, e, s)) : 0.f;
    }
  }

  // o0 += sum_s gW_s freq_s cos(arg_s); red_s += gW_s x cos(arg_s).
  template <int NF>
  __device__ __forceinline__ static void fold(Params p, const Stage<NF>&,
                                              const Elem& e, int c,
                                              const float (&gw)[SC], float& o0,
                                              float&, float (&red)[SC]) {
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < SC; ++j) {
      const int s = c * SC + j;
      if (s >= p.grid_size) continue;
      const float cs = cosf(arg(p, e, s));
      sum = fmaf(gw[j], freq(p, e, s) * cs, sum);
      red[j] = fmaf(gw[j] * e.x, cs, red[j]);
    }
    o0 += sum;
  }
};

// ---------------------------------------------------------------------------
// The RBF layer's LayerNorm
// ---------------------------------------------------------------------------

constexpr int LN_WARPS = 8;  // segments per block of the row-wise passes

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// stats[seg] = (mean, rstd) of x's segment seg = row * groups + g.
__global__ void __launch_bounds__(LN_WARPS * 32)
ln_stats_kernel(const float* __restrict__ x, long long ldx,
                float* __restrict__ stats, int n, int groups, int nin) {
  const long long seg = (long long)blockIdx.x * LN_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (seg >= (long long)n * groups) return;
  const float* xs = x + (seg / groups) * ldx + (seg % groups) * (long long)nin;
  float s = 0.f;
  for (int i = lane; i < nin; i += 32) s += xs[i];
  const float mean = warp_sum(s) / nin;
  float v = 0.f;
  for (int i = lane; i < nin; i += 32) {
    const float d = xs[i] - mean;
    v = fmaf(d, d, v);
  }
  const float var = warp_sum(v) / nin;
  if (lane == 0) {
    stats[seg * 2] = mean;
    stats[seg * 2 + 1] = 1.f / sqrtf(var + LN_EPS);
  }
}

// dx[seg] += rstd (dxh - mean(dxh) - xh mean(dxh xh)), dxh = dln gamma.
__global__ void __launch_bounds__(LN_WARPS * 32)
ln_dx_kernel(const float* __restrict__ x, long long ldx,
             const float* __restrict__ stats, const float* __restrict__ gamma,
             const float* __restrict__ dln, float* __restrict__ dx, int n,
             int groups, int nin) {
  const long long seg = (long long)blockIdx.x * LN_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (seg >= (long long)n * groups) return;
  const long long row = seg / groups;
  const int g = (int)(seg % groups);
  const float* xs = x + row * ldx + (long long)g * nin;
  const long long at = seg * nin;  // dln and dx: (n, groups * nin) contiguous
  const float* gam = gamma + (long long)g * nin;
  const float mean = stats[seg * 2], rstd = stats[seg * 2 + 1];
  float m1 = 0.f, m2 = 0.f;
  for (int i = lane; i < nin; i += 32) {
    const float gs = dln[at + i] * gam[i];
    m1 += gs;
    m2 = fmaf(gs, (xs[i] - mean) * rstd, m2);
  }
  m1 = warp_sum(m1) / nin;
  m2 = warp_sum(m2) / nin;
  for (int i = lane; i < nin; i += 32) {
    const float gs = dln[at + i] * gam[i];
    const float xh = (xs[i] - mean) * rstd;
    dx[at + i] += rstd * (gs - m1 - xh * m2);
  }
}

// part[split] = (sum of dln xh, sum of dln) over the split's rows, per
// column (g*nin + i): dgamma and dbeta before the second pass.
__global__ void ln_dgb_kernel(const float* __restrict__ x, long long ldx,
                              const float* __restrict__ stats,
                              const float* __restrict__ dln,
                              float* __restrict__ part, int n, int groups,
                              int nin, int rows_per_split) {
  const int cols = groups * nin;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= cols) return;
  const int g = col / nin;
  const long long rbeg = (long long)blockIdx.y * rows_per_split;
  const long long rend = min((long long)n, rbeg + rows_per_split);
  float sg = 0.f, sb = 0.f;
  for (long long row = rbeg; row < rend; ++row) {
    const float* s = stats + (row * groups + g) * 2;
    const float d = dln[row * cols + col];
    sg = fmaf(d, (x[row * ldx + col] - s[0]) * s[1], sg);
    sb += d;
  }
  float* out = part + (long long)blockIdx.y * 2 * cols;
  out[col] = sg;
  out[cols + col] = sb;
}

// ---------------------------------------------------------------------------
// Sine's dfreq: the dx blocks' per-slice sums, summed in a fixed order
// ---------------------------------------------------------------------------

constexpr int RED_THREADS = 256;

// out[g * S + s] = sum over blocks b of part[g][b][s]: one block per
// (slice, group), strided partial sums, then a fixed tree.
__global__ void __launch_bounds__(RED_THREADS)
sum_blocks_kernel(const float* __restrict__ part, float* __restrict__ out,
                  int blocks, int slices) {
  __shared__ float sm[RED_THREADS];
  const int s = blockIdx.x, g = blockIdx.y, tid = threadIdx.x;
  const float* pg = part + (long long)g * blocks * slices;
  float acc = 0.f;
  for (int b = tid; b < blocks; b += RED_THREADS) acc += pg[(long long)b * slices + s];
  sm[tid] = acc;
  __syncthreads();
  for (int w = RED_THREADS / 2; w > 0; w >>= 1) {
    if (tid < w) sm[tid] += sm[tid + w];
    __syncthreads();
  }
  if (tid == 0) out[(long long)g * slices + s] = sm[0];
}

unsigned ln_blocks(int n, int groups) {
  return (unsigned)(((long long)n * groups + LN_WARPS - 1) / LN_WARPS);
}

}  // namespace

// FastKAN forward: x (n, groups*nin) f32, row stride ldx, unit column
// stride; gamma, beta (groups, nin), or gamma null for no LayerNorm;
// centres (8,); inv_h = 1 / h; w (groups, 8 + base, nin, nout) contiguous;
// y (n, groups*nout); stats (n, groups, 2) written for the backward (unused
// without LayerNorm). Returns cudaGetLastError() (0 on success).
extern "C" int kanvit_fastkan_fwd(const float* x, long long ldx,
                                  const float* gamma, const float* beta,
                                  const float* centres, float inv_h,
                                  const float* w, float* y, float* stats,
                                  int n, int groups, int nin, int nout,
                                  int base, void* stream) {
  if (bad_shape(n, groups, nin, nout)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool ln = gamma != nullptr;
  if (ln) {
    ln_stats_kernel<<<ln_blocks(n, groups), LN_WARPS * 32, 0, st>>>(
        x, ldx, stats, n, groups, nin);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  const Rbf::Params p{ln ? stats : nullptr, gamma, beta, centres, inv_h, groups,
                      base ? 1 : 0};
  return launch_fwd<Rbf>(x, ldx, p, w, y, n, groups, nin, nout, stream);
}

// FastKAN backward: x, gamma, beta, centres, inv_h, w, base as the forward,
// stats its output; gy (n, groups*nout). dx (n, groups*nin) or null; dw
// (groups, S, nin, nout) or null, with dw_part as kan_basis.cu's backward;
// dgb (2, groups, nin): dgamma then dbeta, or null (needs the LayerNorm).
// dln (n, groups*nin) and dgb_part (ln_splits, 2, groups, nin) are scratch,
// needed when the LayerNorm is on and dx or dgb is asked for.
extern "C" int kanvit_fastkan_bwd(const float* x, long long ldx,
                                  const float* gamma, const float* beta,
                                  const float* centres, float inv_h,
                                  const float* stats, const float* w,
                                  const float* gy, float* dx, float* dw,
                                  float* dw_part, float* dln, float* dgb,
                                  float* dgb_part, int n, int groups, int nin,
                                  int nout, int base, int splits,
                                  int ln_splits, void* stream) {
  const bool ln = gamma != nullptr;
  if (bad_shape(n, groups, nin, nout) || (dgb != nullptr && !ln))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const Rbf::Params p{ln ? stats : nullptr, gamma, beta, centres, inv_h, groups,
                      base ? 1 : 0};
  int err = 0;
  if (ln && (dx != nullptr || dgb != nullptr)) {
    if (dln == nullptr || ln_splits <= 0 || (dgb != nullptr && dgb_part == nullptr))
      return (int)cudaErrorInvalidValue;
    // dln, and the silu term straight into dx
    err = launch_dx<Rbf>(x, ldx, p, w, gy, dln, dx, 1, nullptr, n, groups, nin,
                         nout, st);
    if (err != 0) return err;
    if (dx != nullptr) {
      ln_dx_kernel<<<ln_blocks(n, groups), LN_WARPS * 32, 0, st>>>(
          x, ldx, stats, gamma, dln, dx, n, groups, nin);
      err = (int)cudaGetLastError();
      if (err != 0) return err;
    }
    if (dgb != nullptr) {
      const int rows = (n + ln_splits - 1) / ln_splits;
      const dim3 grid((groups * nin + 127) / 128, ln_splits);
      ln_dgb_kernel<<<grid, 128, 0, st>>>(x, ldx, stats, dln, dgb_part, n,
                                          groups, nin, rows);
      err = (int)cudaGetLastError();
      if (err != 0) return err;
      err = sum_splits(dgb_part, dgb, 2LL * groups * nin, ln_splits, st);
      if (err != 0) return err;
    }
  } else if (dx != nullptr) {
    err = launch_dx<Rbf>(x, ldx, p, w, gy, dx, nullptr, 0, nullptr, n, groups,
                         nin, nout, st);
    if (err != 0) return err;
  }
  if (dw != nullptr)
    return launch_dw<Rbf>(x, ldx, p, gy, dw, dw_part, n, groups, nin, nout,
                          splits, st);
  return 0;
}

// SineKAN forward: x as FastKAN's; freq (groups, S), phase (nin, S), w
// (groups, S, nin, nout), all f32 contiguous; y (n, groups*nout).
extern "C" int kanvit_sinekan_fwd(const float* x, long long ldx,
                                  const float* freq, const float* phase,
                                  const float* w, float* y, int n, int groups,
                                  int nin, int nout, int grid_size,
                                  void* stream) {
  return launch_fwd<Sine>(x, ldx, {freq, phase, grid_size}, w, y, n, groups,
                          nin, nout, stream);
}

// SineKAN backward: dx and dw as kan_basis.cu's backward, either null to
// skip it; dfreq (groups, S) or null, with dfreq_part scratch of groups *
// (the dx kernel's blocks per group) * S floats.
extern "C" int kanvit_sinekan_bwd(const float* x, long long ldx,
                                  const float* freq, const float* phase,
                                  const float* w, const float* gy, float* dx,
                                  float* dw, float* dw_part, float* dfreq,
                                  float* dfreq_part, int n, int groups,
                                  int nin, int nout, int grid_size, int splits,
                                  void* stream) {
  if (bad_shape(n, groups, nin, nout) || grid_size <= 0 ||
      (dfreq != nullptr && dfreq_part == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const Sine::Params p{freq, phase, grid_size};
  int err = 0;
  if (dx != nullptr || dfreq != nullptr) {
    err = launch_dx<Sine>(x, ldx, p, w, gy, dx, nullptr, 0,
                          dfreq != nullptr ? dfreq_part : nullptr, n, groups,
                          nin, nout, st);
    if (err != 0) return err;
    if (dfreq != nullptr) {
      const dim3 g = dx_grid<Sine>(n, groups, nin);
      sum_blocks_kernel<<<dim3(grid_size, groups), RED_THREADS, 0, st>>>(
          dfreq_part, dfreq, (int)(g.x * g.y), grid_size);
      err = (int)cudaGetLastError();
      if (err != 0) return err;
    }
  }
  if (dw != nullptr)
    return launch_dw<Sine>(x, ldx, p, gy, dw, dw_part, n, groups, nin, nout,
                           splits, st);
  return 0;
}
