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
//         from fastkan (:3600), the patch embedder, its forward on the
//         tensor cores after the statistics pass (part 3 at one group, its
//         sum in two levels, entry kanvit_fastkan_kan_tc_fwd), its
//         backward's dx (dln) and dW too (part 2 at one group, entry
//         kanvit_fastkan_qkv_tc_bwd); _rbf_ln_sg_op fwd
//         (:3191) and bwd (:3246), reached from fastkan_qkv_grouped (:3300),
//         one launch per q/k/v projection over every head, its forward on
//         the tensor cores after the statistics pass (kan_basis_tc.cuh part
//         3, entry kanvit_fastkan_qkv_tc_fwd), its backward's dx and dW too
//         (part 2, entry kanvit_fastkan_qkv_tc_bwd); and the tiers
//         the same family covers with its flags: _rbf_base_op (:2726,
//         :2769; the LayerNorm skipped) and _rbf_op (_fused_fwd / _fused_bwd
//         under rbf_family; no silu slice). On bf16 operands (kanvit's bf16
//         policy) all four of fastkan's and fastkan_qkv_grouped's: entries
//         kanvit_fastkan_tc_fwd_bf16 (part 3's Bf16 type, one running sum)
//         and kanvit_fastkan_tc_bwd_bf16 (part 4 with the RBF fold), the
//         LayerNorm passes reading bf16 x, gamma and beta.
//   Sine: the K-blocked _fused_fwd_kb (:2317), _fused_bwd_kb dx (:2492) and
//         dW + dfreq (:2523, _dw_kernel_kb_sine), reached from sinekan
//         (:3667), the grid-28 patch embedder, and below that tier
//         _fused_fwd (:1067) and _fused_bwd_sine_plain (:1728): the forward
//         and dW + dfreq on the tensor cores (kan_basis_tc.cuh, SineTc,
//         the kanvit_sinekan_tc_* entries), dx on the CUDA-core dx kernel;
//         _sine_op_sg fwd (:1518) and bwd (:1557), reached from
//         sinekan_qkv_grouped (:1597): for G <= 4 the forward on the tensor
//         cores (kan_basis_tc.cuh part 3, entry kanvit_sinekan_qkv_tc_fwd)
//         and the backward's dx, dfreq and dW too (part 2, entry
//         kanvit_sinekan_qkv_tc_bwd), on the CUDA-core kernels past it
//         (kanvit_sinekan_fwd, kanvit_sinekan_bwd); the opt-in
//         _fused_fwd_kb_basis (:2354)
//         and _fused_bwd_kb_sine_res (:2401, :2433), and sinekan_qkv
//         (:3691), compute the same functions. On bf16 operands (kanvit's
//         bf16 policy) all four of sinekan's and sinekan_qkv_grouped's:
//         entries kanvit_sinekan_tc_fwd_bf16 (part 3's Bf16 type, one
//         running sum, the embedder's 28 slices in chunks of 4) and
//         kanvit_sinekan_tc_bwd_bf16 (part 4 with the sine fold; dfreq
//         summed over the rows, then the features, rounded once).
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
//          partials over fixed row ranges, then a fixed-order second pass
//          in two levels (groups of LN_PART_GROUP partials): one running
//          sum over the vit-s q/k/v's 197 partials put dbeta 2.3x further
//          from f64 than the plain f32 version on the H100.
// The patch embedder's backward needs no dx (its input is the image) but
// dgamma and dbeta still need dln: the dln pass runs, the dx pass does not.
//
// Sine's dfreq_s = sum_{n,i} gW_s[n, i] x cos(arg). For the grouped q/k/v
// it rides the dx kernel (the tensor-core one for G <= 4), where gW is in
// registers: per-block sums in a fixed order, then one block per (group,
// slice) sums the blocks in a fixed order; that backward needs no dx, so
// the dx kernel runs and writes none. The RBF grouped backward on the
// tensor cores runs the same LayerNorm passes after its dx kernel.
// For the embedder (sinekan) it rides the tensor-core dW kernel as
// sum_{i,o} W[s, i, o] D[s, i, o] (kan_basis_tc.cuh), whether dx is asked
// or not; the dx kernel then computes dx alone.

#include "kan_basis.cuh"
#include "kan_basis_tc.cuh"

namespace {

constexpr float LN_EPS = 1e-5f;
// kan_tc_fwd_grouped's shape up to 64 outputs (one q/k/v projection) a
// family: warps a block, blocks an SM (why these: kan_basis_tc.cuh part 3).
// RBF keeps it at every width (the launch's NARROW), the embedder's too: a
// 192-output tile's two stages of its 10 steps would take 245,760 bytes of
// shared memory, past a block's 232,448.
constexpr int RBF_FWD_WARPS = 12, RBF_FWD_MINB = 1;
// The bf16 forward's shape (part 3's Bf16 operand type, 5 steps of two
// slices a stage): past 64 outputs (the embedder) 192 a block at 12 warps,
// one block an SM, where two stages take 61,440 bytes; up to 64 (one q/k/v
// projection) RBF_BF16_WARPS warps, RBF_BF16_MINB blocks an SM.
// kanvit_torch/probe_bf16.py --fast-shapes timed eight shapes on the H100
// 80GB HBM3 at 700 W (PERF.md), every one with the route's bits: at the
// vit-s q/k/v 4 warps at four blocks an SM took 0.0963 ms against 0.1072
// for the f32 RBF forward's 12 warps at one block (0.1019-0.1026 at 8 or 12
// warps and two or three blocks); at the vit-s embedder 192 outputs at 12
// warps took 0.4232 against 0.6062 at 8 warps and 0.71-0.95 for every
// 64-output shape. Below one wave the 192-output blocks lose (one vit-s
// image: 0.4234 ms against 0.2139 at 64 outputs, 4 warps), as the other
// bf16 embedders' do.
constexpr int RBF_BF16_WARPS = 4, RBF_BF16_MINB = 4;
constexpr int SINE_FWD_WARPS = 8, SINE_FWD_MINB = 3;
// The bf16 sine forward's shape up to 64 outputs (one q/k/v projection;
// part 3's Bf16 type, two 16-deep steps of two slices a stage): warps a
// block, blocks an SM. Past 64 outputs (the embedder) 192 a block at 12
// warps, one block an SM, 132 blocks at vit-s: one wave.
// kanvit_torch/probe_bf16.py --sine-shapes timed eight shapes on the H100
// 80GB HBM3 at 700 W (PERF.md), every one with the route's bits: at the
// vit-s q/k/v 4 warps at six blocks an SM took 0.0809 ms against 0.0943 at
// four blocks and 0.0859 at 8 warps and three (the f32 sine forward's
// shape); at the vit-s embedder 192 outputs at 12 warps took 3.05 against
// 5.19 at 8 warps and 5.9-8.4 for every 64-output shape, which makes each
// basis value six times. Below one wave the 192-output blocks lose (one
// vit-s image: 3.04 ms against 2.30 at 64 outputs, 4 warps, four blocks).
constexpr int SINE_BF16_WARPS = 4, SINE_BF16_MINB = 6;
// The FastKAN embedder's forward sums its 768 features (96 stages at
// vit-s) in two levels of FASTKAN_EMB_FLUSH stages, as B-spline's does, so
// that a small batch can run each level in blocks of its own
// (kan_basis_tc.cuh part 3).
constexpr int FASTKAN_EMB_FLUSH = 12;

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
    // the bf16 kernels' gamma and beta (groups, nin), upcast as staged; null
    // in the f32 kernels
    const __nv_bfloat16* gamma16;
    const __nv_bfloat16* beta16;
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
      const long long at = (long long)g * nin + i;
      st.gamma[tid] = !live ? 1.f : p.gamma16 ? __bfloat162float(p.gamma16[at]) : p.gamma[at];
      st.beta[tid] = !live ? 0.f : p.beta16 ? __bfloat162float(p.beta16[at]) : p.beta[at];
    }
    if (tid < NG) st.c[tid] = p.centres[tid];
    __syncthreads();
  }

  // LN(x) from the row's (mean, rstd) and the feature's gamma, beta.
  template <int NF>
  __device__ __forceinline__ static float normed(const Stage<NF>& st, const Elem& e,
                                                 float mean, float rstd) {
    return (e.x - mean) * rstd * st.gamma[e.kf] + st.beta[e.kf];
  }

  // The RBF's input: LN(x) from the row's stats, or x itself.
  template <int NF>
  __device__ __forceinline__ static float normed(Params p, const Stage<NF>& st,
                                                 const Elem& e) {
    if (p.stats == nullptr) return e.x;
    const float* s = p.stats + (e.row * p.groups + e.g) * 2;
    return normed(st, e, s[0], s[1]);
  }

  // The RBF slices of the RBF's input ln and the silu slice of the raw x.
  template <int NF>
  __device__ __forceinline__ static void from_input(Params p, const Stage<NF>& st, float ln,
                                                    float x, float (&v)[SC]) {
#pragma unroll
    for (int k = 0; k < NG; ++k) {
      const float u = (ln - st.c[k]) * p.inv_h;
      v[k] = expf(-u * u);
    }
    v[NG] = p.base ? silu(x) : 0.f;
  }

  template <int NF>
  __device__ __forceinline__ static void values(Params p, const Stage<NF>& st,
                                                const Elem& e, int,
                                                float (&v)[SC]) {
    from_input(p, st, normed(p, st, e), e.x, v);
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
    // the bf16 kernels' freq (groups, S), upcast as read, in place of freq;
    // with it the argument and the fold round each product and sum as
    // kanvit's x * freq + phase, dx += gW (freq cos a), gW x cos a do
    const __nv_bfloat16* freq16;
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

  __device__ __forceinline__ static float freq(Params p, int g, int s) {
    const long long at = (long long)g * p.grid_size + s;
    return p.freq16 != nullptr ? __bfloat162float(p.freq16[at]) : __ldg(p.freq + at);
  }
  __device__ __forceinline__ static float freq(Params p, const Elem& e, int s) {
    return freq(p, e.g, s);
  }
  // x freq_s + phase[i, s]: the sine's argument, from a frequency at hand.
  __device__ __forceinline__ static float arg(Params p, const Elem& e, int s, float fr) {
    const float ph = __ldg(p.phase + (long long)e.i * p.grid_size + s);
    return p.freq16 != nullptr ? __fadd_rn(__fmul_rn(e.x, fr), ph) : e.x * fr + ph;
  }
  __device__ __forceinline__ static float arg(Params p, const Elem& e, int s) {
    return arg(p, e, s, freq(p, e, s));
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

  // o0 += sum_s gW_s freq_s cos(arg_s); red_s += gW_s x cos(arg_s). The
  // bf16 kernels (freq16) add each term into o0 in slice order, o0 carried
  // across the chunks, every product and sum rounded as kanvit's.
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
      const float fr = freq(p, e, s), cs = cosf(arg(p, e, s, fr));
      if (p.freq16 != nullptr) {
        o0 = __fadd_rn(o0, __fmul_rn(gw[j], __fmul_rn(fr, cs)));
        red[j] = __fadd_rn(red[j], __fmul_rn(__fmul_rn(gw[j], e.x), cs));
      } else {
        sum = fmaf(gw[j], fr * cs, sum);
        red[j] = fmaf(gw[j] * e.x, cs, red[j]);
      }
    }
    if (p.freq16 == nullptr) o0 += sum;
  }
};

// The grouped forward on the tensor cores (kan_basis_tc.cuh, part 3) holds
// each of a lane's rows' LayerNorm statistics in registers for the whole
// stage loop (Rbf::normed would load them once a value), and keeps the silu
// slice apart: silu(x) of the raw x reaches |x| (60 in the tests' inputs)
// beside RBF bases <= 1, so it goes into a running sum of its own with
// exact products (TcFwdRow's SPLIT and EXACT). With one running sum and
// 3xTF32 products the forward over 2 heads of 32 features (1,849 rows,
// tests/test_torch_port_cuda.py) landed 3.02e-7 x max|y| from f64 against
// the plain f32 version's 1.20e-7 on the H100 80GB HBM3 at 700 W; mostly
// the rounding of the running sum, carried through every later step once a
// large silu product is in it, partly the products' two-word split (the
// CPU emulation of each change alone). With both the same test passes.
template <>
struct TcFwdRow<Rbf> {
  static constexpr int SPLIT = Rbf::NG, EXACT = Rbf::NG;
  struct Row { float mean, rstd; };
  __device__ __forceinline__ static Row load(const Rbf::Params& p, int g, long long row) {
    if (p.stats == nullptr) return {0.f, 1.f};
    const float* s = p.stats + (row * p.groups + g) * 2;
    return {s[0], s[1]};
  }
  template <int NF>
  __device__ __forceinline__ static void values(const Rbf::Params& p,
                                                const Rbf::Stage<NF>& st, const Elem& e,
                                                const Row& r, int, float (&v)[Rbf::SC]) {
    Rbf::from_input(p, st, p.stats == nullptr ? e.x : Rbf::normed(st, e, r.mean, r.rstd),
                    e.x, v);
  }
};

// ... and each group's frequencies of its first chunk (a lane's rows are all
// of one group): Sine::values would load them once a value. A later chunk
// (the bf16 embedder's, one group) reads its own as it goes.
template <>
struct TcFwdRow<Sine> {
  static constexpr int SPLIT = Sine::SC, EXACT = -1;
  struct Row { float freq[Sine::SC]; };
  __device__ __forceinline__ static Row load(const Sine::Params& p, int g, long long) {
    Row r;
#pragma unroll
    for (int s = 0; s < Sine::SC; ++s) r.freq[s] = s < p.grid_size ? Sine::freq(p, g, s) : 0.f;
    return r;
  }
  template <int NF>
  __device__ __forceinline__ static void values(const Sine::Params& p, const Sine::Stage<NF>&,
                                                const Elem& e, const Row& r, int c,
                                                float (&v)[Sine::SC]) {
#pragma unroll
    for (int j = 0; j < Sine::SC; ++j) {
      const int s = c * Sine::SC + j;
      const float fr = c == 0 ? r.freq[j] : s < p.grid_size ? Sine::freq(p, e.g, s) : 0.f;
      v[j] = s < p.grid_size ? sinf(Sine::arg(p, e, s, fr)) : 0.f;
    }
  }
};

// ---------------------------------------------------------------------------
// The RBF layer's LayerNorm
// ---------------------------------------------------------------------------

constexpr int LN_WARPS = 8;       // segments per block of the row-wise passes
constexpr int LN_PART_GROUP = 16;  // dgamma / dbeta partials a group of the second pass

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// x, gamma, beta as f32: the f32 kernels' values, the bf16 kernels' upcast
__device__ __forceinline__ float f32_of(float v) { return v; }
__device__ __forceinline__ float f32_of(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_as(float* at, float v) { *at = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* at, float v) {
  *at = __float2bfloat16_rn(v);
}

// stats[seg] = (mean, rstd) of x's segment seg = row * groups + g, in f32
// (x f32, or bf16 upcast).
template <class T>
__global__ void __launch_bounds__(LN_WARPS * 32)
ln_stats_kernel(const T* __restrict__ x, long long ldx,
                float* __restrict__ stats, int n, int groups, int nin) {
  const long long seg = (long long)blockIdx.x * LN_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (seg >= (long long)n * groups) return;
  const T* xs = x + (seg / groups) * ldx + (seg % groups) * (long long)nin;
  float s = 0.f;
  for (int i = lane; i < nin; i += 32) s += f32_of(xs[i]);
  const float mean = warp_sum(s) / nin;
  float v = 0.f;
  for (int i = lane; i < nin; i += 32) {
    const float d = f32_of(xs[i]) - mean;
    v = fmaf(d, d, v);
  }
  const float var = warp_sum(v) / nin;
  if (lane == 0) {
    stats[seg * 2] = mean;
    stats[seg * 2 + 1] = 1.f / sqrtf(var + LN_EPS);
  }
}

// dx[seg] = add[seg] + rstd (dxh - mean(dxh) - xh mean(dxh xh)), dxh =
// dln gamma, in f32 and stored as T once: f32 in place (add = dx, the silu
// term the dx kernel wrote), or bf16 from the f32 silu term.
template <class T>
__global__ void __launch_bounds__(LN_WARPS * 32)
ln_dx_kernel(const T* __restrict__ x, long long ldx,
             const float* __restrict__ stats, const T* __restrict__ gamma,
             const float* __restrict__ dln, const float* add, T* dx, int n,
             int groups, int nin) {
  const long long seg = (long long)blockIdx.x * LN_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (seg >= (long long)n * groups) return;
  const long long row = seg / groups;
  const int g = (int)(seg % groups);
  const T* xs = x + row * ldx + (long long)g * nin;
  const long long at = seg * nin;  // dln and dx: (n, groups * nin) contiguous
  const T* gam = gamma + (long long)g * nin;
  const float mean = stats[seg * 2], rstd = stats[seg * 2 + 1];
  float m1 = 0.f, m2 = 0.f;
  for (int i = lane; i < nin; i += 32) {
    const float gs = dln[at + i] * f32_of(gam[i]);
    m1 += gs;
    m2 = fmaf(gs, (f32_of(xs[i]) - mean) * rstd, m2);
  }
  m1 = warp_sum(m1) / nin;
  m2 = warp_sum(m2) / nin;
  for (int i = lane; i < nin; i += 32) {
    const float gs = dln[at + i] * f32_of(gam[i]);
    const float xh = (f32_of(xs[i]) - mean) * rstd;
    store_as(dx + at + i, add[at + i] + rstd * (gs - m1 - xh * m2));
  }
}

// part[split] = (sum of dln xh, sum of dln) over the split's rows, per
// column (g*nin + i): dgamma and dbeta before the second pass.
template <class T>
__global__ void ln_dgb_kernel(const T* __restrict__ x, long long ldx,
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
    sg = fmaf(d, (f32_of(x[row * ldx + col]) - s[0]) * s[1], sg);
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

// The bf16 sine backward's dfreq: out[g S + s] = bf16(sum over features f
// of (sum over row tiles t of part[g][s][t][f])), the rows of each feature
// before the features, as kanvit sums a lane over the rows and then a
// head's lanes: one block a (slice, group), each thread a feature's row
// tiles in order, then its features in order, then a fixed tree; rounded
// once.
__global__ void __launch_bounds__(RED_THREADS)
sum_rows_features_kernel(const float* __restrict__ part, __nv_bfloat16* __restrict__ out,
                         int nin, int tiles, int slices) {
  __shared__ float sm[RED_THREADS];
  const int s = blockIdx.x, g = blockIdx.y, tid = threadIdx.x;
  const float* pg = part + ((long long)g * slices + s) * tiles * nin;
  float acc = 0.f;
  for (int f = tid; f < nin; f += RED_THREADS) {
    float rows = 0.f;
    for (int t = 0; t < tiles; ++t) rows += pg[(long long)t * nin + f];
    acc += rows;
  }
  sm[tid] = acc;
  __syncthreads();
  for (int w = RED_THREADS / 2; w > 0; w >>= 1) {
    if (tid < w) sm[tid] += sm[tid + w];
    __syncthreads();
  }
  if (tid == 0) out[(long long)g * slices + s] = __float2bfloat16_rn(sm[0]);
}

unsigned ln_blocks(int n, int groups) {
  return (unsigned)(((long long)n * groups + LN_WARPS - 1) / LN_WARPS);
}

// The forward's first pass: the LayerNorm's statistics into stats where the
// layer has one (gamma given); then the family's parameters over them.
template <class T>
int ln_stats_pass(const T* x, long long ldx, const void* gamma, float* stats, int n,
                  int groups, int nin, cudaStream_t st) {
  if (gamma == nullptr) return 0;
  ln_stats_kernel<T><<<ln_blocks(n, groups), LN_WARPS * 32, 0, st>>>(x, ldx, stats, n, groups,
                                                                     nin);
  return (int)cudaGetLastError();
}

Rbf::Params rbf_params(const float* gamma, const float* beta, const float* centres,
                       float inv_h, const float* stats, int groups, int base) {
  return {gamma != nullptr ? stats : nullptr, gamma, beta, centres, inv_h, groups,
          base ? 1 : 0, nullptr, nullptr};
}

// The bf16 kernels' parameters: gamma and beta bf16, upcast as staged.
Rbf::Params rbf_params_bf16(const __nv_bfloat16* gamma, const __nv_bfloat16* beta,
                            const float* centres, float inv_h, const float* stats, int groups,
                            int base) {
  return {gamma != nullptr ? stats : nullptr, nullptr, nullptr, centres, inv_h, groups,
          base ? 1 : 0, gamma, beta};
}

// The LayerNorm's backward from dln: dx = add + its VJP (dx null: skipped;
// f32 in place: add = dx), and dgb = (dgamma, dbeta) (null: skipped) from
// ln_splits row partials summed in two levels in f32, stored as T once.
template <class T>
int ln_bwd(const T* x, long long ldx, const float* stats, const T* gamma,
           const float* dln, const float* add, T* dx, T* dgb, float* dgb_part, int n,
           int groups, int nin, int ln_splits, cudaStream_t st) {
  if (dx != nullptr) {
    ln_dx_kernel<T><<<ln_blocks(n, groups), LN_WARPS * 32, 0, st>>>(x, ldx, stats, gamma, dln,
                                                                    add, dx, n, groups, nin);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  if (dgb == nullptr) return 0;
  const int rows = (n + ln_splits - 1) / ln_splits;
  const dim3 grid((groups * nin + 127) / 128, ln_splits);
  ln_dgb_kernel<T><<<grid, 128, 0, st>>>(x, ldx, stats, dln, dgb_part, n, groups, nin, rows);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return sum_splits(dgb_part, dgb, 2LL * groups * nin, ln_splits, st, LN_PART_GROUP);
}

// The RBF backward's steps over its two launches: dx_launch(out0, out1,
// split) writes dln and the silu term (split, the LayerNorm on) or dx
// itself, dw_launch() dW; the LayerNorm's passes after dln.
template <class DxLaunch, class DwLaunch>
int rbf_bwd(const float* x, long long ldx, const float* gamma, const float* stats,
            float* dx, float* dw, float* dln, float* dgb, float* dgb_part, int n,
            int groups, int nin, int ln_splits, cudaStream_t st, DxLaunch dx_launch,
            DwLaunch dw_launch) {
  int err = 0;
  if (gamma != nullptr && (dx != nullptr || dgb != nullptr)) {
    if (dln == nullptr || ln_splits <= 0 || (dgb != nullptr && dgb_part == nullptr))
      return (int)cudaErrorInvalidValue;
    err = dx_launch(dln, dx, 1);
    if (err != 0) return err;
    err = ln_bwd(x, ldx, stats, gamma, dln, dx, dx, dgb, dgb_part, n, groups, nin, ln_splits,
                 st);
    if (err != 0) return err;
  } else if (dx != nullptr) {
    err = dx_launch(dx, nullptr, 0);
    if (err != 0) return err;
  }
  return dw != nullptr ? dw_launch() : 0;
}

// The bf16 sine kernels' parameters: freq bf16 (groups, S), upcast as read;
// the phase table f32.
Sine::Params sine_params_bf16(const void* freq, const float* phase, int grid_size) {
  return {nullptr, phase, grid_size, static_cast<const __nv_bfloat16*>(freq)};
}

// The grouped sine backward's steps over its two launches: dx_launch(part)
// writes dx (if asked) and dfreq's per-block sums into part (null: none),
// summed over `blocks` blocks a group in a fixed order; dw_launch() dW.
template <class DxLaunch, class DwLaunch>
int sine_bwd(float* dx, float* dw, float* dfreq, float* dfreq_part, int blocks, int groups,
             int grid_size, cudaStream_t st, DxLaunch dx_launch, DwLaunch dw_launch) {
  if (dx != nullptr || dfreq != nullptr) {
    int err = dx_launch(dfreq != nullptr ? dfreq_part : nullptr);
    if (err != 0) return err;
    if (dfreq != nullptr) {
      sum_blocks_kernel<<<dim3(grid_size, groups), RED_THREADS, 0, st>>>(
          dfreq_part, dfreq, blocks, grid_size);
      err = (int)cudaGetLastError();
      if (err != 0) return err;
    }
  }
  return dw != nullptr ? dw_launch() : 0;
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
  const int err = ln_stats_pass(x, ldx, gamma, stats, n, groups, nin, (cudaStream_t)stream);
  if (err != 0) return err;
  return launch_fwd<Rbf>(x, ldx, rbf_params(gamma, beta, centres, inv_h, stats, groups, base),
                         w, y, n, groups, nin, nout, stream);
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
  const Rbf::Params p = rbf_params(gamma, beta, centres, inv_h, stats, groups, base);
  return rbf_bwd(
      x, ldx, gamma, stats, dx, dw, dln, dgb, dgb_part, n, groups, nin, ln_splits, st,
      [&](float* out0, float* out1, int split) {
        return launch_dx<Rbf>(x, ldx, p, w, gy, out0, out1, split, nullptr, n, groups, nin,
                              nout, st);
      },
      [&] {
        return launch_dw<Rbf>(x, ldx, p, gy, dw, dw_part, n, groups, nin, nout, splits, st);
      });
}

// The bf16 FastKAN forward (fastkan's and fastkan_qkv_grouped's, kanvit's
// bf16 serving policy on kan_basis_tc.cuh part 3's Bf16 operand type): x,
// gamma, beta, w and y bf16, the centres f32; the LayerNorm's statistics of
// the upcast x in f32 into stats, then the RBF bases of the f32 LayerNorm
// (gamma and beta upcast) and silu of the raw x made in f32 in registers and
// rounded to bf16 at the dot, two slices a 16-deep step (five steps, silu
// alone in the last), f32 accumulation in one running sum, y rounded to bf16
// once; the bias is added outside. The shape above RBF_BF16_*; wsplit of
// wwords words (launch_tc_grouped_fwd).
extern "C" int kanvit_fastkan_tc_fwd_bf16(const void* x, long long ldx, const void* gamma,
                                          const void* beta, const float* centres, float inv_h,
                                          const void* w, void* y, float* stats,
                                          unsigned int* wsplit, long long wwords, int n,
                                          int groups, int nin, int nout, int base,
                                          void* stream) {
  using bf = __nv_bfloat16;
  if (bad_shape(n, groups, nin, nout)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const bf* xb = static_cast<const bf*>(x);
  const int err = ln_stats_pass(xb, ldx, gamma, stats, n, groups, nin, st);
  if (err != 0) return err;
  return launch_tc_grouped_fwd<Rbf, RBF_BF16_WARPS, RBF_BF16_MINB, false, 0, Bf16>(
      xb, ldx,
      rbf_params_bf16(static_cast<const bf*>(gamma), static_cast<const bf*>(beta), centres,
                      inv_h, stats, groups, base),
      static_cast<const bf*>(w), static_cast<bf*>(y), wsplit, wwords, n, groups, nin, nout, st);
}

// The bf16 FastKAN backward (kanvit's bf16 training policy, part 4): x,
// gamma, beta, w, gy, dx, dw and dgb bf16, the centres and stats (the
// forward's) f32. With the LayerNorm: kan_bf16_dx<Rbf> writes dln, and
// where dx is asked the silu term gW_silu silu'(x), into the f32 scratch
// dln and dxs (n, groups nin), gW = gy W^T in f32 never rounded; then
// ln_dx_kernel writes dx = bf16(dxs + the LayerNorm's VJP) and
// ln_dgb_kernel dgamma and dbeta's row partials into dgb_part (ln_splits, 2,
// groups, nin) f32, summed in two levels and rounded once into dgb (2,
// groups, nin); the dln pass runs whenever dgb is asked (the embedder's
// step asks no dx). Without it, dx = bf16(dln + the silu term). dW summed
// in f32 over all the rows (row splits into dw_part, splits groups S nin
// nout floats) and rounded once. dx, dw or dgb null to skip it.
extern "C" int kanvit_fastkan_tc_bwd_bf16(const void* x, long long ldx, const void* gamma,
                                          const void* beta, const float* centres, float inv_h,
                                          const float* stats, const void* w, const void* gy,
                                          void* dx, void* dw, float* dw_part, float* dln,
                                          float* dxs, void* dgb, float* dgb_part, int n,
                                          int groups, int nin, int nout, int base, int splits,
                                          int ln_splits, void* stream) {
  using bf = __nv_bfloat16;
  const bool ln = gamma != nullptr;
  if (bad_shape(n, groups, nin, nout) || splits < 1 || (dgb != nullptr && !ln) ||
      (dw != nullptr && dw_part == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const bf *xb = static_cast<const bf*>(x), *wb = static_cast<const bf*>(w);
  const bf* gyb = static_cast<const bf*>(gy);
  bf* dxb = static_cast<bf*>(dx);
  const Rbf::Params p = rbf_params_bf16(static_cast<const bf*>(gamma),
                                        static_cast<const bf*>(beta), centres, inv_h, stats,
                                        groups, base);
  int err = 0;
  if (ln && (dx != nullptr || dgb != nullptr)) {
    if (dln == nullptr || ln_splits <= 0 || (dgb != nullptr && dgb_part == nullptr) ||
        (dx != nullptr && dxs == nullptr))
      return (int)cudaErrorInvalidValue;
    err = launch_bf16_dx<Rbf>(xb, ldx, p, wb, gyb, nullptr, dln, dx != nullptr ? dxs : nullptr,
                              1, n, groups, nin, nout, st);
    if (err != 0) return err;
    err = ln_bwd<bf>(xb, ldx, stats, static_cast<const bf*>(gamma), dln, dxs, dxb,
                     static_cast<bf*>(dgb), dgb_part, n, groups, nin, ln_splits, st);
  } else if (dx != nullptr) {
    err = launch_bf16_dx<Rbf>(xb, ldx, p, wb, gyb, dxb, nullptr, nullptr, 0, n, groups, nin,
                              nout, st);
  }
  if (err != 0 || dw == nullptr) return err;
  return launch_bf16_grouped_dw<Rbf>(xb, ldx, p, wb, gyb, static_cast<bf*>(dw), dw_part, n,
                                     groups, nin, nout, splits, st);
}

// The bf16 SineKAN forward (sinekan's and sinekan_qkv_grouped's, kanvit's
// bf16 serving policy on kan_basis_tc.cuh part 3's Bf16 operand type): x,
// freq, w and y bf16, phase f32; the argument x freq + phase formed in f32
// (freq upcast, the product and the sum each rounded), sin of it made in f32
// in registers and rounded to bf16 at the dot, two slices a 16-deep step,
// f32 accumulation in one running sum, y rounded to bf16 once; the bias is
// added outside. A grid past 4 slices (the embedder's 28) walks them in
// chunks of 4 inside each 8 features (7 stages of 8 features at grid 28).
// The shape above SINE_BF16_*; wsplit of wwords words (launch_tc_grouped_fwd,
// chunks included).
extern "C" int kanvit_sinekan_tc_fwd_bf16(const void* x, long long ldx, const void* freq,
                                          const float* phase, const void* w, void* y,
                                          unsigned int* wsplit, long long wwords, int n,
                                          int groups, int nin, int nout, int grid_size,
                                          void* stream) {
  using bf = __nv_bfloat16;
  if (grid_size <= 0) return (int)cudaErrorInvalidValue;
  return launch_tc_grouped_fwd<Sine, SINE_BF16_WARPS, SINE_BF16_MINB, false, 0, Bf16>(
      static_cast<const bf*>(x), ldx, sine_params_bf16(freq, phase, grid_size),
      static_cast<const bf*>(w), static_cast<bf*>(y), wsplit, wwords, n, groups, nin, nout,
      (cudaStream_t)stream);
}

// The bf16 SineKAN backward (kanvit's bf16 training policy, part 4): x,
// freq, w, gy, dx, dw and dfreq bf16, phase f32. kan_bf16_dx<Sine> (gW = gy
// W^T in f32, never rounded; the sine fold in its epilogue: dx = sum_s gW_s
// (freq_s cos a_s) in f32, rounded once, written where dx is not null, and
// gW_s x cos a_s summed over each block's 128 rows a feature into
// dfreq_part (groups, S, ceil(n / 128), nin) f32) runs on every call: dfreq
// needs gW, and the embedder's training step asks no dx. Then
// sum_rows_features_kernel sums dfreq_part over the row tiles and then the
// features in a fixed order and rounds once into dfreq (groups, S). dW on
// kan_bf16_dw<Sine> over the basis made in f32 and rounded to bf16 at the
// dot, the rows in at most `splits` splits into dw_part (splits groups S
// nin nout floats), summed in f32 and rounded once; dw null to skip it.
extern "C" int kanvit_sinekan_tc_bwd_bf16(const void* x, long long ldx, const void* freq,
                                          const float* phase, const void* w, const void* gy,
                                          void* dx, void* dw, float* dw_part, void* dfreq,
                                          float* dfreq_part, int n, int groups, int nin,
                                          int nout, int grid_size, int splits, void* stream) {
  using bf = __nv_bfloat16;
  if (bad_shape(n, groups, nin, nout) || grid_size <= 0 || splits < 1 || dfreq == nullptr ||
      dfreq_part == nullptr || (dw != nullptr && dw_part == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const bf *xb = static_cast<const bf*>(x), *wb = static_cast<const bf*>(w);
  const bf* gyb = static_cast<const bf*>(gy);
  const Sine::Params p = sine_params_bf16(freq, phase, grid_size);
  int err = launch_bf16_dx<Sine>(xb, ldx, p, wb, gyb, static_cast<bf*>(dx), nullptr, nullptr,
                                 0, n, groups, nin, nout, st, dfreq_part);
  if (err != 0) return err;
  sum_rows_features_kernel<<<dim3(grid_size, groups), RED_THREADS, 0, st>>>(
      dfreq_part, static_cast<bf*>(dfreq), nin, cdiv(n, tcb::DX_BM), grid_size);
  err = (int)cudaGetLastError();
  if (err != 0 || dw == nullptr) return err;
  return launch_bf16_grouped_dw<Sine>(xb, ldx, p, wb, gyb, static_cast<bf*>(dw), dw_part, n,
                                      groups, nin, nout, splits, st);
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
  const dim3 g = dx_grid<Sine>(n, groups, nin);
  return sine_bwd(
      dx, dw, dfreq, dfreq_part, (int)(g.x * g.y), groups, grid_size, st,
      [&](float* part) {
        return launch_dx<Sine>(x, ldx, p, w, gy, dx, nullptr, 0, part, n, groups, nin, nout,
                               st);
      },
      [&] {
        return launch_dw<Sine>(x, ldx, p, gy, dw, dw_part, n, groups, nin, nout, splits, st);
      });
}

// The grouped FastKAN q/k/v backward (fastkan_qkv_grouped's) and, at one
// group, the embedder's (fastkan's) on the tensor cores (kan_basis_tc.cuh,
// part 2): kanvit_fastkan_bwd's arguments and steps, its dx kernel (dln,
// and the silu term into dx) and dW kernel the tensor-core ones, with their
// scratch wtsplit (launch_tc_grouped_dx) and splits the dW kernel's row
// splits (at most). The embedder's training step asks for no dx: dln, the
// LayerNorm's dgamma and dbeta and dW, the same bits as with dx.
extern "C" int kanvit_fastkan_qkv_tc_bwd(const float* x, long long ldx,
                                         const float* gamma, const float* beta,
                                         const float* centres, float inv_h,
                                         const float* stats, const float* w,
                                         const float* gy, float* dx, float* dw,
                                         float* dw_part, float* dln, float* dgb,
                                         float* dgb_part, unsigned int* wtsplit, int n,
                                         int groups, int nin, int nout, int base,
                                         int splits, int ln_splits, void* stream) {
  const bool ln = gamma != nullptr;
  if (bad_shape(n, groups, nin, nout) || (dgb != nullptr && !ln))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const Rbf::Params p = rbf_params(gamma, beta, centres, inv_h, stats, groups, base);
  return rbf_bwd(
      x, ldx, gamma, stats, dx, dw, dln, dgb, dgb_part, n, groups, nin, ln_splits, st,
      [&](float* out0, float* out1, int split) {
        return launch_tc_grouped_dx<Rbf>(x, ldx, p, w, gy, out0, out1, split, nullptr,
                                         wtsplit, n, groups, nin, nout, st);
      },
      [&] {
        return launch_tc_grouped_dw<Rbf>(x, ldx, p, gy, dw, dw_part, n, groups, nin, nout,
                                         splits, st);
      });
}

// The grouped SineKAN q/k/v backward (sinekan_qkv_grouped's, grid_size <=
// 4) on the tensor cores: kanvit_sinekan_bwd's arguments and steps, with
// dfreq_part of groups * (tc_dx_grid's blocks per group) * S floats and the
// scratch wtsplit (launch_tc_grouped_dx), needed when dx or dfreq is.
extern "C" int kanvit_sinekan_qkv_tc_bwd(const float* x, long long ldx,
                                         const float* freq, const float* phase,
                                         const float* w, const float* gy, float* dx,
                                         float* dw, float* dw_part, float* dfreq,
                                         float* dfreq_part, unsigned int* wtsplit, int n,
                                         int groups, int nin, int nout, int grid_size,
                                         int splits, void* stream) {
  if (bad_shape(n, groups, nin, nout) || grid_size <= 0 || grid_size > Sine::SC ||
      (dfreq != nullptr && dfreq_part == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const Sine::Params p{freq, phase, grid_size};
  const dim3 g = tc_dx_grid(n, groups, nin);
  return sine_bwd(
      dx, dw, dfreq, dfreq_part, (int)(g.x * g.y), groups, grid_size, st,
      [&](float* part) {
        return launch_tc_grouped_dx<Sine>(x, ldx, p, w, gy, dx, nullptr, 0, part, wtsplit, n,
                                          groups, nin, nout, st);
      },
      [&] {
        return launch_tc_grouped_dw<Sine>(x, ldx, p, gy, dw, dw_part, n, groups, nin, nout,
                                          splits, st);
      });
}

// The grouped FastKAN q/k/v forward (fastkan_qkv_grouped's) on the tensor
// cores (kan_basis_tc.cuh, part 3): kanvit_fastkan_fwd's arguments and
// steps (the LayerNorm's stats, then the contraction), with scratch wsplit
// of wwords >= groups ceil(nout / BN) ceil(nin / 8) 10 BN 16 words
// (launch_tc_grouped_fwd: 9 slices with or without the base branch, and
// the silu slice's remainders).
extern "C" int kanvit_fastkan_qkv_tc_fwd(const float* x, long long ldx, const float* gamma,
                                         const float* beta, const float* centres,
                                         float inv_h, const float* w, float* y, float* stats,
                                         unsigned int* wsplit, long long wwords, int n,
                                         int groups, int nin, int nout, int base,
                                         void* stream) {
  if (bad_shape(n, groups, nin, nout)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int err = ln_stats_pass(x, ldx, gamma, stats, n, groups, nin, st);
  if (err != 0) return err;
  return launch_tc_grouped_fwd<Rbf, RBF_FWD_WARPS, RBF_FWD_MINB, true>(
      x, ldx, rbf_params(gamma, beta, centres, inv_h, stats, groups, base), w, y, wsplit,
      wwords, n, groups, nin, nout, st);
}

// The FastKAN patch embedder's forward (fastkan's) on the tensor cores:
// kanvit_fastkan_qkv_tc_fwd's arguments, steps and shape at one group, its
// sum in two levels; splits 1, or one a level with part scratch of splits n
// groups nout floats (launch_tc_grouped_fwd).
extern "C" int kanvit_fastkan_kan_tc_fwd(const float* x, long long ldx, const float* gamma,
                                         const float* beta, const float* centres,
                                         float inv_h, const float* w, float* y, float* stats,
                                         unsigned int* wsplit, long long wwords, float* part,
                                         int splits, int n, int groups, int nin, int nout,
                                         int base, void* stream) {
  if (bad_shape(n, groups, nin, nout)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int err = ln_stats_pass(x, ldx, gamma, stats, n, groups, nin, st);
  if (err != 0) return err;
  return launch_tc_grouped_fwd<Rbf, RBF_FWD_WARPS, RBF_FWD_MINB, true, FASTKAN_EMB_FLUSH>(
      x, ldx, rbf_params(gamma, beta, centres, inv_h, stats, groups, base), w, y, wsplit,
      wwords, n, groups, nin, nout, st, part, splits);
}

// The grouped SineKAN q/k/v forward (sinekan_qkv_grouped's, grid_size <= 4)
// on the tensor cores: kanvit_sinekan_fwd's arguments, with scratch wsplit
// of wwords >= groups ceil(nout / BN) ceil(nin / 8) 4 BN 16 words.
extern "C" int kanvit_sinekan_qkv_tc_fwd(const float* x, long long ldx, const float* freq,
                                         const float* phase, const float* w, float* y,
                                         unsigned int* wsplit, long long wwords, int n,
                                         int groups, int nin, int nout, int grid_size,
                                         void* stream) {
  return launch_tc_grouped_fwd<Sine, SINE_FWD_WARPS, SINE_FWD_MINB>(
      x, ldx, {freq, phase, grid_size}, w, y, wsplit, wwords, n, groups, nin, nout,
      (cudaStream_t)stream);
}

// SineKAN embedder (sinekan, one group) on the tensor cores. Forward: x, freq
// (S,), phase (nin, S), w (S, nin, nout) as kanvit_sinekan_fwd's; y (n,
// nout); wsplit scratch of ceil(nin / 32) * S * npad * 64 words (npad: nout
// rounded up to 384), 16-byte aligned.
extern "C" int kanvit_sinekan_tc_fwd(const float* x, long long ldx,
                                     const float* freq, const float* phase,
                                     const float* w, float* y,
                                     unsigned int* wsplit, int n, int nin,
                                     int nout, int grid_size, void* stream) {
  return launch_tc_fwd<SineTc>(x, ldx, {freq, phase, grid_size}, w, y, wsplit, n,
                               nin, nout, (cudaStream_t)stream);
}

// Backward: dx (n, nin) or null from the CUDA-core dx kernel (no dfreq
// there); dw (S, nin, nout) and dfreq (S,) from the tensor-core dW kernel
// and its D route, with gysplit scratch of ceil(n / 32) * npad * 64 words
// (16-byte aligned) and dfreq_part of ceil(nin / 48) * (npad / 192) * S
// floats, summed per slice in a fixed order.
extern "C" int kanvit_sinekan_tc_bwd(const float* x, long long ldx,
                                     const float* freq, const float* phase,
                                     const float* w, const float* gy, float* dx,
                                     float* dw, float* dfreq,
                                     unsigned int* gysplit, float* dfreq_part,
                                     int n, int nin, int nout, int grid_size,
                                     void* stream) {
  if (bad_shape(n, 1, nin, nout) || grid_size <= 0 || dw == nullptr ||
      dfreq == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const SineTc::Params p{freq, phase, grid_size};
  if (dx != nullptr) {
    const int err = launch_dx<Sine>(x, ldx, {freq, phase, grid_size}, w, gy, dx,
                                    nullptr, 0, nullptr, n, 1, nin, nout, st);
    if (err != 0) return err;
  }
  int err = launch_tc_dw<SineTc>(x, ldx, p, w, gy, dw, gysplit, dfreq_part, n, nin,
                                 nout, st);
  if (err != 0) return err;
  const int blocks = cdiv(nin, tc::DW_F) * (tc_npad<SineTc, true>(nout) / Tile<SineTc, true>::BN);
  sum_blocks_kernel<<<dim3(grid_size, 1), RED_THREADS, 0, st>>>(dfreq_part, dfreq,
                                                                 blocks, grid_size);
  return (int)cudaGetLastError();
}
