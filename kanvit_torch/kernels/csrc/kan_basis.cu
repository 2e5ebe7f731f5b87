// The B-spline, Chebyshev and Fourier families of the fused KAN kernels
// (the kernels themselves: kan_basis.cuh):
//   B-spline  S = 9: the 8 cubic B-spline bases of a per-feature 12-knot grid
//             (grid 5, order 3) and silu(x), so efficient-kan's base branch
//             rides the same contraction;
//   Chebyshev S = 5: T_0..T_4 of t = tanh(x) (degree 4);
//   Fourier   S = 2G: cos(kx) for k = 1..G, then sin(kx) for k = 1..G, with
//             G at run time (28 in the ViT's patch embedder).
//
// Replaces the TPU kernels of kanvit/kernels/fused_basis.py:
//   forward:  _fused_fwd (pallas_call at :1067) and its out-blocked tier
//             _fused_fwd_ob (:777), reached from bspline_kan (:3556) and
//             chebykan (:3779); _fused_fwd_sg (:1240), reached from
//             bspline_qkv_grouped (:1361) and cheby_qkv_grouped (:1395),
//             the q/k/v projection of every head in one launch;
//   backward: _fused_bwd (:1159), _fused_bwd_ob (:810) and the split pair
//             _fused_fwd_basis (:969) + _fused_bwd_split (:1006), reached
//             from the VJPs of _bspline_op (:2624) and _cheby_op (:3499);
//             fourierkan's K-blocked _fused_bwd_kb dx (:2492,
//             _dx_kernel_kbf), from the VJP of _fourier_op (:3472);
//             _fused_bwd_sg (:1278), reached from the VJPs of _bspline_op_sg
//             (:1330) and _cheby_op_sg (:1351): both run on the tensor cores
//             (kan_basis_tc.cuh, part 2, instantiated here for Bspline and
//             Cheby). bspline_qkv_grouped's and cheby_qkv_grouped's
//             forwards (_fused_fwd_sg) run on the tensor cores too
//             (kan_basis_tc.cuh, part 3, for Bspline and Cheby), and so do
//             bspline_kan's forward and backward (_fused_fwd, _fused_bwd)
//             and chebykan's forward and backward (_fused_fwd, entry
//             kanvit_chebykan_tc_fwd; _fused_bwd, entry
//             kanvit_cheby_qkv_tc_bwd) as their one-group case. The
//             CUDA-core forward of chebykan (kan_basis.cuh, entry
//             kanvit_chebykan_fwd) stays, timed beside it.
//   bf16 (kanvit's bf16 serving and training): bspline_kan's and
//   bspline_qkv_grouped's forwards (_fused_fwd :1067, _fused_fwd_sg :1240
//   on bf16 operands) on kan_basis_tc.cuh part 3 with its Bf16 operand
//   type, entry kanvit_bspline_tc_fwd_bf16; their backwards (_fused_bwd
//   :1159, _fused_bwd_sg :1278 on bf16 operands) on part 4, entry
//   kanvit_bspline_tc_bwd_bf16; chebykan's and cheby_qkv_grouped's the
//   same way (_cheby_op :3491, _cheby_op_sg :1343 and their VJPs), entries
//   kanvit_cheby_tc_fwd_bf16 and kanvit_cheby_tc_bwd_bf16; fourierkan's
//   (_fused_fwd_kb :2317 with _fwd_kernel_kbf, _fused_bwd_kb :2492 and
//   :2564 with _dx_kernel_kbf and _dw_kernel_kbf, and _fused_fwd :1067 /
//   _fused_bwd :1159 below that tier) as FourierBf16, entries
//   kanvit_fourierkan_tc_fwd_bf16 and kanvit_fourierkan_tc_bwd_bf16.
//   Fourier's forward (fourierkan (:3748): the K-blocked _fused_fwd_kb
//   (:2317, _fwd_kernel_kbf) and, below that tier, _fused_fwd (:1067)) and
//   its weight gradient (_fused_bwd_kb dW, :2564, _dw_kernel_kbf) run on
//   the tensor cores: kan_basis_tc.cuh, instantiated here as FourierTc.
//
// At the ViT-S embedder (N = 64*196, 768 -> 384) each of y, dx and dW is
// 2*N*S*768*384 FLOPs, 67 GFLOP for B-spline, 37 for Chebyshev and 414 for
// Fourier G = 28, against ~70-110 MB of x, y (or gy) and W.
//
// Fourier's dx runs in chunks of 4 harmonics (8 slices: their cos and sin),
// so no register array grows with G: 448 accumulators a thread at G = 28 in
// one chunk. Each harmonic is sincosf(k * x) with k * x rounded to f32, the
// reference's arithmetic (nfkan.py, kanvit's plain fourier_bases), in dx and
// in the tensor-core kernels alike. kanvit's TPU kernel (_fwd_kernel_kbf)
// builds them from one sincos(x) pair by angle addition instead, which a
// chunked walk would have to carry from chunk to chunk; its drift over 28
// harmonics put dx ~40x further from the plain version, for a few percent
// of the kernels' time. B-spline stages its knots and the reciprocals of the
// knot differences in shared memory; the other families stage nothing. IEEE
// tanhf, sincosf and expf throughout: the arguments of sincosf reach 28 |x|,
// far outside where __sinf is accurate, and tanh.approx's 2^-11 error would
// show in T_4.
//
// Edge semantics follow kanvit_torch/ops/kan_bases.py: B-spline order-0
// bases are the half-open indicators g_j <= x < g_{j+1}, so x on a knot
// starts the next interval and x outside every span gets all-zero spline
// bases and derivatives; where tanh(x) rounds to +-1 the Chebyshev
// derivative is T'_n(+-1) * (1 - t^2) = 0.

#include "kan_basis.cuh"
#include "kan_basis_tc.cuh"

namespace {

// kan_tc_fwd_grouped's shape for Chebyshev: 64 outputs a block at every
// width, 8 warps, three blocks an SM (why: kan_basis_tc.cuh part 3).
constexpr int CHEBY_FWD_WARPS = 8, CHEBY_FWD_MINB = 3;
// The B-spline embedder's forward sums its 768 features (96 stages at
// vit-s) in two levels, the running sum of every 12 stages (864 entries)
// added into y: one running sum lands past twice the plain f32 version's
// distance from f64 in the CPU emulation (1.6-2.4x), and at 0.86x on the
// card, where two levels sit at 0.21x (kan_basis_tc.cuh part 3).
constexpr int BSPLINE_EMB_FLUSH = 12;
// The Chebyshev embedder's forward: the q/k/v's 64-output tiles at one
// group, CHEBY_EMB_WARPS warps a block (16 rows each) at CHEBY_EMB_MINB
// blocks an SM, its 768 features (96 stages of 5 steps at vit-s, 3,840
// entries deep) summed in two levels of CHEBY_EMB_FLUSH stages: one running
// sum lands 1.6-2.3x the plain f32 version's distance from f64 in the CPU
// emulation (past twice it at two of five draws), levels of 6, 12 and 24
// stages 0.39-0.77x (tests/test_torch_port_tc_embedder_cheby_fwd.py); on
// the card one sum 1.2x, levels of 24 0.44x. At vit-s
// (kanvit_torch/probe_embedder_rbf.py --cheby, the H100 80GB HBM3 at 700
// W; PERF.md): 12 warps, one block an SM, levels of 24, 0.8083 ms; the
// q/k/v's 8 warps at three blocks an SM 0.8386 (levels of 12: 0.8909), at
// two 0.9248; 192-output tiles 0.8022, within the run's noise; one running
// sum 0.7643, levels of 6 0.9732. Below one wave (one image: 12 blocks)
// the 4 levels run in blocks of their own.
constexpr int CHEBY_EMB_WARPS = 12, CHEBY_EMB_MINB = 1, CHEBY_EMB_FLUSH = 24;
// The bf16 forward's shape at both call sites, B-spline's bf16 rule: past
// 64 outputs 192 a block at 12 warps, one block an SM
// (kan_tc_fwd_grouped<Cheby, 24, 12, 1, Bf16, 0>); up to 64 outputs 64 a
// block at CHEBY_BF16_WARPS warps, CHEBY_BF16_MINB blocks an SM. A 16-deep
// bf16 stage is half a 3xTF32 one's bytes, so the f32 Chebyshev shapes'
// reasons do not carry over; kanvit_torch/probe_bf16.py --cheby-shapes timed
// nine on the H100 80GB HBM3 at 700 W (PERF.md), every one with the route's
// bits: at the vit-s embedder 192 outputs at 12 warps took 0.2008 ms against
// 0.2855 for the f32 q/k/v's 64 outputs at 8 warps and three blocks an SM
// (0.2388 at 8 warps and two, 0.2732 at 64 outputs, 12 warps and two); at
// the vit-s q/k/v 0.1140 against 0.1113, within the run's noise. Below one
// wave the 192-output blocks lose (one vit-s image: 0.1960 ms against
// 0.0880 at 64 outputs), as the B-spline bf16 embedder's do.
constexpr int CHEBY_BF16_WARPS = 8, CHEBY_BF16_MINB = 3;
// The bf16 Fourier forward's shape up to 64 outputs (the MNIST embedder:
// 16 -> 64; part 3's Bf16 type, two 16-deep steps of two slices a stage):
// warps a block, blocks an SM. Past 64 outputs (the vit-s embedder) 192 a
// block at 12 warps, one block an SM, as every bf16 embedder takes.
// kanvit_torch/probe_bf16.py --fourier-shapes timed eight shapes on the
// H100 80GB HBM3 at 700 W (PERF.md), every one with the route's bits: at
// the vit-s embedder 192 outputs at 12 warps took 1.97 ms against 2.82 for
// 96 outputs at 8 warps, two blocks an SM, and 3.09-3.99 for 64-output
// shapes; at the MNIST embedder 4 warps at four blocks an SM 0.0235 against
// 0.0239-0.0307 for the other 64-output shapes. Below one wave the
// 192-output blocks lose (one vit-s image: 1.97 ms against 0.93 at 64
// outputs, 4 warps, four blocks an SM), as the other bf16 embedders' do.
constexpr int FOURIER_BF16_WARPS = 4, FOURIER_BF16_MINB = 4;

// B-spline: 12 knots a feature (grid 5, order 3), 8 spline bases + silu.
struct Bspline : FamilyDefaults {
  static constexpr int KNOTS = 12;
  static constexpr int ORDER = 3;
  static constexpr int NSPLINE = KNOTS - ORDER - 1;
  static constexpr int NINV = ORDER * KNOTS;
  static constexpr int SC = NSPLINE + 1;  // one chunk: all 9 slices
  static constexpr int BK = 8;
  static constexpr int DX_BK = 16;
  // The knots, (12, nin) row-major, of group g at gridt + g * gstride:
  // gstride 0 shares one grid among the groups, 12 * nin gives each group
  // its own (the refit grids of a stateful-grid MSA, one per head).
  struct Params { const float* gridt; long long gstride; };
  // knots[kf][j], inv[kf][(k-1)*KNOTS + j] = 1 / (g[j+k] - g[j])
  template <int NF> struct Stage { float knots[NF][KNOTS]; float inv[NF][NINV]; };

  __host__ __device__ static int slices(Params) { return SC; }
  __host__ __device__ static int chunks(Params) { return 1; }
  __device__ static int slice(Params, int, int j) { return j; }

  // Knots of group g's features [k0, k0 + NF) and their reciprocals into
  // shared memory. Every thread of the block must call it (it synchronises).
  template <int NF>
  __device__ static void stage(Params p, int nin, int k0, int g, Stage<NF>& st) {
    const int tid = threadIdx.x, nt = blockDim.x;
    const float* gt = p.gridt + g * p.gstride;
    for (int e = tid; e < NF * KNOTS; e += nt) {
      const int kf = e / KNOTS, j = e % KNOTS, i = k0 + kf;
      st.knots[kf][j] = i < nin ? gt[(long long)j * nin + i] : 0.f;
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
                                                const Elem& e, int,
                                                float (&v)[SC]) {
    float b[KNOTS - 1];
    levels<ORDER>(e.x, st.knots[e.kf], st.inv[e.kf], b);
#pragma unroll
    for (int s = 0; s < NSPLINE; ++s) v[s] = b[s];
    v[NSPLINE] = silu(e.x);
  }

  // B'_{3,j} = 3 (B_{2,j} / (g_{j+3} - g_j) - B_{2,j+1} / (g_{j+4} - g_{j+1}))
  // (the closed form of kanvit's bspline_family._levels, fused_basis.py:
  // 451-483) and silu'(x).
  template <int NF>
  __device__ __forceinline__ static void derivs(Params, const Stage<NF>& st,
                                                const Elem& e, int,
                                                float (&d)[SC]) {
    float b[KNOTS - 1];
    levels<ORDER - 1>(e.x, st.knots[e.kf], st.inv[e.kf], b);  // order-2 bases
    const float* iv3 = st.inv[e.kf] + (ORDER - 1) * KNOTS;
#pragma unroll
    for (int j = 0; j < NSPLINE; ++j)
      d[j] = ORDER * (b[j] * iv3[j] - b[j + 1] * iv3[j + 1]);
    d[NSPLINE] = silu_grad(e.x);
  }
};

// Chebyshev, degree 4: T_n = 2 t T_{n-1} - T_{n-2} on t = tanh(x) (kanvit's
// cheby_family, fused_basis.py:251-285), T'_n = 2 T_{n-1} + 2 t T'_{n-1} -
// T'_{n-2}, times dt/dx = 1 - t^2.
struct Cheby : FamilyDefaults {
  static constexpr int SC = 5;
  static constexpr int BK = 16;
  static constexpr int DX_BK = 16;
  using Params = Empty;
  template <int NF> using Stage = Empty;

  __host__ __device__ static int slices(Params) { return SC; }
  __host__ __device__ static int chunks(Params) { return 1; }
  __device__ static int slice(Params, int, int j) { return j; }
  template <int NF>
  __device__ static void stage(Params, int, int, int, Stage<NF>&) {}

  template <int NF>
  __device__ __forceinline__ static void values(Params, const Stage<NF>&,
                                                const Elem& e, int,
                                                float (&v)[SC]) {
    const float t = tanhf(e.x);
    v[0] = 1.f;
    v[1] = t;
#pragma unroll
    for (int n = 2; n < SC; ++n) v[n] = 2.f * t * v[n - 1] - v[n - 2];
  }

  template <int NF>
  __device__ __forceinline__ static void derivs(Params, const Stage<NF>&,
                                                const Elem& e, int,
                                                float (&d)[SC]) {
    const float t = tanhf(e.x);
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

// Fourier's dx, G harmonics at run time, in chunks of HC = 4: chunk c holds
// harmonics k = 4c+1 .. 4c+4, entry j < 4 is cos(kx) (stored slice k-1) and
// entry 4 + j is sin(kx) (stored slice G + k-1).
struct Fourier : FamilyDefaults {
  static constexpr int HC = 4;
  static constexpr int SC = 2 * HC;
  static constexpr int DX_BK = 16;
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
  __device__ static void stage(Params, int, int, int, Stage<NF>&) {}

  // d cos(kx)/dx = -k sin(kx), d sin(kx)/dx = k cos(kx)
  template <int NF>
  __device__ __forceinline__ static void derivs(Params, const Stage<NF>&,
                                                const Elem& e, int c,
                                                float (&d)[SC]) {
#pragma unroll
    for (int q = 0; q < HC; ++q) {
      const float k = (float)(c * HC + q + 1);
      float sh, ch;
      sincosf(k * e.x, &sh, &ch);  // k * x rounded, as the reference
      d[q] = -k * sh;
      d[HC + q] = k * ch;
    }
  }
};

// Fourier on bf16 operands (kan_basis_tc.cuh parts 3 and 4; kanvit's
// K-blocked recurrence kernels _fwd_kernel_kbf, _dx_kernel_kbf and
// _dw_kernel_kbf, fused_basis.py:1858-1960): G harmonics at run time in
// chunks of HC = 2, chunk c = (cos k, sin k, cos k+1, sin k+1) for k = 2c +
// 1, read from and written to the packed weight (cos harmonics first, then
// sin) through wslice, so that a chunk's values follow from one state.
// cos/sin(kx) by angle addition from c1 = cos(x), s1 = sin(x), each product
// and sum rounded as kanvit's ch*c1 - sh*s1, sh*c1 + ch*s1 reads (no FMA
// contraction): the forward (TcFwdRow<FourierBf16>, below) and dx (fold)
// seed once, at harmonic 1, and carry (c1, s1, ch, sh) from chunk to chunk,
// as kanvit's forward and dx carry it through every harmonic; dW (values)
// seeds each chunk afresh at its first harmonic by cos and sin of the f32
// product k x, as kanvit's dW seeds each slab's first harmonic. The seeds
// are IEEE sincosf, the same bits as cosf and sinf (the plain twin's
// torch.cos and torch.sin on the card): none of 2^31 floats differed on the
// H100 (kanvit_torch/probe_bf16.py --sincos; PERF.md), so the kernels'
// basis is the twin's bit for bit.
struct FourierBf16 : FamilyDefaults {
  static constexpr int HC = 2;
  static constexpr int SC = 2 * HC;
  static constexpr bool DX_FOLD = true, DX_CARRY = true;
  struct Params { int grid_size; };
  template <int NF> using Stage = Empty;
  struct Carry { float c1, s1, ch, sh; };  // cos/sin(x), cos/sin(kx) of the next k

  __host__ __device__ static int slices(Params p) { return 2 * p.grid_size; }
  __host__ __device__ static int chunks(Params p) { return (p.grid_size + HC - 1) / HC; }
  // slice l of the chunk walk: harmonic l / 2 + 1, its cos (l even) or sin
  __host__ __device__ static int wslice(int slices, int l) {
    return (l & 1) * (slices / 2) + (l >> 1);
  }
  template <int NF>
  __device__ static void stage(Params, int, int, int, Stage<NF>&) {}

  __device__ __forceinline__ static void rotate(Carry& r) {
    const float ch = __fsub_rn(__fmul_rn(r.ch, r.c1), __fmul_rn(r.sh, r.s1));
    r.sh = __fadd_rn(__fmul_rn(r.sh, r.c1), __fmul_rn(r.ch, r.s1));
    r.ch = ch;
  }
  __device__ __forceinline__ static Carry seed(float x) {
    float c1, s1;
    sincosf(x, &s1, &c1);
    return {c1, s1, c1, s1};
  }
  // A chunk's values from the state at its first harmonic; the state moved
  // past the chunk.
  __device__ __forceinline__ static void walk(Carry& r, float (&v)[SC]) {
#pragma unroll
    for (int h = 0; h < HC; ++h) {
      v[2 * h] = r.ch;
      v[2 * h + 1] = r.sh;
      rotate(r);
    }
  }

  // dW's values of chunk c, seeded at its first harmonic.
  template <int NF>
  __device__ __forceinline__ static void values(Params, const Stage<NF>&, const Elem& e,
                                                int c, float (&v)[SC]) {
    Carry r;
    sincosf(e.x, &r.s1, &r.c1);
    sincosf(__fmul_rn((float)(HC * c + 1), e.x), &r.sh, &r.ch);
    walk(r, v);
  }

  // dx's fold of chunk c (gw: the chunk's gW in walk order): o0 += k (gW_sin,k
  // c_k - gW_cos,k s_k) for its harmonics in turn, as kanvit's acc += m *
  // (gw_sin * ch - gw_cos * sh) reads.
  __device__ __forceinline__ static void fold(Params p, const Elem& e, int c,
                                              const float (&gw)[SC], float& o0, Carry& r) {
    if (c == 0) r = seed(e.x);
#pragma unroll
    for (int h = 0; h < HC; ++h) {
      const int k = HC * c + h + 1;
      if (k <= p.grid_size)
        o0 = __fadd_rn(o0, __fmul_rn((float)k, __fsub_rn(__fmul_rn(gw[2 * h + 1], r.ch),
                                                         __fmul_rn(gw[2 * h], r.sh))));
      rotate(r);
    }
  }
};

// The bf16 Fourier forward's lanes carry the recurrence's state of their
// row's two values a stage (features 2t, 2t + 1 of its 8: value kf & 1)
// through the stage's chunks, seeded at chunk 0.
template <>
struct TcFwdRow<FourierBf16> {
  static constexpr int SPLIT = FourierBf16::SC, EXACT = -1;
  struct Row { FourierBf16::Carry f[2]; };
  __device__ __forceinline__ static Row load(const FourierBf16::Params&, int, long long) {
    return {};
  }
  template <int NF>
  __device__ __forceinline__ static void values(const FourierBf16::Params&,
                                                const FourierBf16::Stage<NF>&, const Elem& e,
                                                Row& r, int c, float (&v)[FourierBf16::SC]) {
    FourierBf16::Carry& s = r.f[e.kf & 1];
    if (c == 0) s = FourierBf16::seed(e.x);
    FourierBf16::walk(s, v);
  }
};

// dx (from the family's derivatives) and dW of a grouped layer on the
// tensor cores (kan_basis_tc.cuh, part 2), either null to skip it.
template <class F>
int launch_tc_grouped_bwd(const float* x, long long ldx, typename F::Params p, const float* w,
                          const float* gy, float* dx, float* dw, float* dw_part,
                          uint32_t* wtsplit, int n, int groups, int nin, int nout,
                          int splits, cudaStream_t st) {
  if (bad_shape(n, groups, nin, nout)) return (int)cudaErrorInvalidValue;
  if (dx != nullptr) {
    const int err = launch_tc_grouped_dx<F>(x, ldx, p, w, gy, dx, nullptr, 0, nullptr,
                                            wtsplit, n, groups, nin, nout, st);
    if (err != 0) return err;
  }
  if (dw == nullptr) return 0;
  return launch_tc_grouped_dw<F>(x, ldx, p, gy, dw, dw_part, n, groups, nin, nout, splits,
                                 st);
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

// B-spline: gridt (12, nin) f32 row-major, S = 9; group g's knots at
// gridt + g * gstride (0: one grid for every group; 12 * nin: a grid each).
extern "C" int kanvit_bspline_kan_fwd(const float* x, long long ldx,
                                      const float* gridt, long long gstride,
                                      const float* w, float* y, int n,
                                      int groups, int nin, int nout,
                                      void* stream) {
  return launch_fwd<Bspline>(x, ldx, {gridt, gstride}, w, y, n, groups, nin,
                             nout, stream);
}

extern "C" int kanvit_bspline_kan_bwd(const float* x, long long ldx,
                                      const float* gridt, long long gstride,
                                      const float* w, const float* gy,
                                      float* dx, float* dw, float* dw_part,
                                      int n, int groups, int nin, int nout,
                                      int splits, void* stream) {
  return launch_bwd<Bspline>(x, ldx, {gridt, gstride}, w, gy, dx, dw, dw_part,
                             n, groups, nin, nout, splits, stream);
}

// The grouped q/k/v backward (bspline_qkv_grouped's) on the tensor cores
// (kan_basis_tc.cuh, part 2): dx and dW as kanvit_bspline_kan_bwd, splits
// the dW kernel's row splits (at most), with scratch wtsplit
// (launch_tc_grouped_dx says its size) and, with splits > 1, dw_part.
extern "C" int kanvit_bspline_qkv_tc_bwd(const float* x, long long ldx,
                                         const float* gridt, long long gstride,
                                         const float* w, const float* gy, float* dx,
                                         float* dw, float* dw_part, unsigned int* wtsplit,
                                         int n, int groups, int nin, int nout,
                                         int splits, void* stream) {
  return launch_tc_grouped_bwd<Bspline>(x, ldx, {gridt, gstride}, w, gy, dx, dw, dw_part,
                                        wtsplit, n, groups, nin, nout, splits,
                                        (cudaStream_t)stream);
}

// The grouped q/k/v forward (bspline_qkv_grouped's) on the tensor cores
// (kan_basis_tc.cuh, part 3): y as kanvit_bspline_kan_fwd, with scratch
// wsplit of wwords words (launch_tc_grouped_fwd says the size it needs).
extern "C" int kanvit_bspline_qkv_tc_fwd(const float* x, long long ldx,
                                         const float* gridt, long long gstride,
                                         const float* w, float* y, unsigned int* wsplit,
                                         long long wwords, int n, int groups, int nin,
                                         int nout, void* stream) {
  return launch_tc_grouped_fwd<Bspline>(x, ldx, {gridt, gstride}, w, y, wsplit, wwords, n,
                                        groups, nin, nout, (cudaStream_t)stream);
}

// The B-spline patch embedder's forward (bspline_kan's) on the tensor cores:
// kanvit_bspline_qkv_tc_fwd's template at one group, its sum in two levels;
// splits 1, or one a level with part scratch of splits n groups nout floats
// (launch_tc_grouped_fwd).
extern "C" int kanvit_bspline_kan_tc_fwd(const float* x, long long ldx, const float* gridt,
                                         long long gstride, const float* w, float* y,
                                         unsigned int* wsplit, long long wwords, float* part,
                                         int splits, int n, int groups, int nin, int nout,
                                         void* stream) {
  return launch_tc_grouped_fwd<Bspline, tcf::WARPS, 1, false, BSPLINE_EMB_FLUSH>(
      x, ldx, {gridt, gstride}, w, y, wsplit, wwords, n, groups, nin, nout,
      (cudaStream_t)stream, part, splits);
}

// The bf16 forward (kanvit's bf16 serving policy, kan_basis_tc.cuh part 3's
// Bf16 operand type): x, w and y bf16, the knots f32, the basis made in f32
// and rounded to bf16 at the dot, f32 accumulation in one running sum, y
// rounded to bf16 once. The grouped q/k/v's (bspline_qkv_grouped's), and the
// B-spline patch embedder's (bspline_kan's) as its one-group case: the same
// template, shape and entry; wsplit of wwords words (launch_tc_grouped_fwd).
extern "C" int kanvit_bspline_tc_fwd_bf16(const void* x, long long ldx, const float* gridt,
                                          long long gstride, const void* w, void* y,
                                          unsigned int* wsplit, long long wwords, int n,
                                          int groups, int nin, int nout, void* stream) {
  using bf = __nv_bfloat16;
  return launch_tc_grouped_fwd<Bspline, tcf::WARPS, 1, false, 0, Bf16>(
      static_cast<const bf*>(x), ldx, {gridt, gstride}, static_cast<const bf*>(w),
      static_cast<bf*>(y), wsplit, wwords, n, groups, nin, nout, (cudaStream_t)stream);
}

// The bf16 backward (kanvit's bf16 training policy, kan_basis_tc.cuh part
// 4): x, w, gy, dx and dw bf16, the knots f32; the basis and B' made in f32,
// gW = gy W^T accumulated in f32 and never rounded, dx summed in f32 and
// rounded once, dW summed in f32 over all the rows (row splits into the f32
// scratch dw_part of splits groups 9 nin nout floats, added in split order)
// and rounded once. The grouped q/k/v's (bspline_qkv_grouped's), and the
// B-spline patch embedder's (bspline_kan's) as its one-group case; dx or dw
// null to skip it.
extern "C" int kanvit_bspline_tc_bwd_bf16(const void* x, long long ldx, const float* gridt,
                                          long long gstride, const void* w, const void* gy,
                                          void* dx, void* dw, float* dw_part, int n,
                                          int groups, int nin, int nout, int splits,
                                          void* stream) {
  using bf = __nv_bfloat16;
  return launch_bf16_grouped_bwd<Bspline>(
      static_cast<const bf*>(x), ldx, {gridt, gstride}, static_cast<const bf*>(w),
      static_cast<const bf*>(gy), static_cast<bf*>(dx), static_cast<bf*>(dw), dw_part, n,
      groups, nin, nout, splits, (cudaStream_t)stream);
}

// Chebyshev, degree 4: S = 5. The CUDA-core forward (kan_basis.cuh); the
// route's is kanvit_chebykan_tc_fwd.
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

// The grouped q/k/v forward (cheby_qkv_grouped's) on the tensor cores
// (kan_basis_tc.cuh, part 3): as kanvit_bspline_qkv_tc_fwd, for Chebyshev
// (the family's values: the recurrence on tanh(x), T_n(+-1) where tanh
// rounds to +-1, as kan_fwd_kernel).
extern "C" int kanvit_cheby_qkv_tc_fwd(const float* x, long long ldx, const float* w, float* y,
                                       unsigned int* wsplit, long long wwords, int n,
                                       int groups, int nin, int nout, void* stream) {
  return launch_tc_grouped_fwd<Cheby, CHEBY_FWD_WARPS, CHEBY_FWD_MINB, true>(
      x, ldx, {}, w, y, wsplit, wwords, n, groups, nin, nout, (cudaStream_t)stream);
}

// The Chebyshev patch embedder's forward (chebykan's) on the tensor cores:
// kanvit_cheby_qkv_tc_fwd's template at one group, its sum in two levels;
// splits 1, or one a level with part scratch of splits n groups nout floats
// (launch_tc_grouped_fwd), as kanvit_bspline_kan_tc_fwd.
extern "C" int kanvit_chebykan_tc_fwd(const float* x, long long ldx, const float* w, float* y,
                                      unsigned int* wsplit, long long wwords, float* part,
                                      int splits, int n, int groups, int nin, int nout,
                                      void* stream) {
  return launch_tc_grouped_fwd<Cheby, CHEBY_EMB_WARPS, CHEBY_EMB_MINB, true, CHEBY_EMB_FLUSH>(
      x, ldx, {}, w, y, wsplit, wwords, n, groups, nin, nout, (cudaStream_t)stream, part,
      splits);
}

// The grouped q/k/v backward (cheby_qkv_grouped's) on the tensor cores
// (kan_basis_tc.cuh, part 2): as kanvit_bspline_qkv_tc_bwd, for Chebyshev.
extern "C" int kanvit_cheby_qkv_tc_bwd(const float* x, long long ldx, const float* w,
                                       const float* gy, float* dx, float* dw,
                                       float* dw_part, unsigned int* wtsplit, int n,
                                       int groups, int nin, int nout, int splits,
                                       void* stream) {
  return launch_tc_grouped_bwd<Cheby>(x, ldx, {}, w, gy, dx, dw, dw_part, wtsplit, n, groups,
                                      nin, nout, splits, (cudaStream_t)stream);
}


// The bf16 forward of the Chebyshev embedder (chebykan's) and of the grouped
// q/k/v (cheby_qkv_grouped's), kanvit's bf16 serving policy on part 3's Bf16
// operand type: x, w and y bf16, T_0..T_4 of tanh of the upcast x made in
// f32 in registers and rounded to bf16 at the dot, two slices a 16-deep
// step (three steps, the last half zero), f32 accumulation in one running
// sum (levels would round between them in bf16), y rounded to bf16 once.
// Both call sites take the shape above CHEBY_BF16_*; wsplit of wwords words
// (launch_tc_grouped_fwd).
extern "C" int kanvit_cheby_tc_fwd_bf16(const void* x, long long ldx, const void* w, void* y,
                                        unsigned int* wsplit, long long wwords, int n,
                                        int groups, int nin, int nout, void* stream) {
  using bf = __nv_bfloat16;
  return launch_tc_grouped_fwd<Cheby, CHEBY_BF16_WARPS, CHEBY_BF16_MINB, false, 0, Bf16>(
      static_cast<const bf*>(x), ldx, {}, static_cast<const bf*>(w), static_cast<bf*>(y),
      wsplit, wwords, n, groups, nin, nout, (cudaStream_t)stream);
}

// The bf16 backward of the Chebyshev embedder and q/k/v (kanvit's bf16
// training policy, kan_basis_tc.cuh part 4): x, w, gy, dx and dw bf16; T_n
// and T'_n (1 - t^2) made in f32, gW = gy W^T accumulated in f32 and never
// rounded, dx summed in f32 and rounded once, dW summed in f32 over all the
// rows (row splits into the f32 scratch dw_part of splits groups 5 nin nout
// floats, added in split order) and rounded once; dx or dw null to skip it.
extern "C" int kanvit_cheby_tc_bwd_bf16(const void* x, long long ldx, const void* w,
                                        const void* gy, void* dx, void* dw, float* dw_part,
                                        int n, int groups, int nin, int nout, int splits,
                                        void* stream) {
  using bf = __nv_bfloat16;
  return launch_bf16_grouped_bwd<Cheby>(
      static_cast<const bf*>(x), ldx, {}, static_cast<const bf*>(w),
      static_cast<const bf*>(gy), static_cast<bf*>(dx), static_cast<bf*>(dw), dw_part, n,
      groups, nin, nout, splits, (cudaStream_t)stream);
}

// Fourier, grid_size G >= 1 harmonics: S = 2G, one group. Forward: y (n,
// nout) from the tensor-core kernel; wsplit is scratch of
// ceil(nin / 16) * G * npad * 64 words (npad: nout rounded up to 192),
// 16-byte aligned. Backward: dx (n, nin) or null from the CUDA-core dx
// kernel, dW (2G, nin, nout) or null from the tensor-core kernel, with
// gysplit scratch of ceil(n / 32) * npad * 64 words, 16-byte aligned.
extern "C" int kanvit_fourierkan_fwd(const float* x, long long ldx,
                                     const float* w, float* y,
                                     unsigned int* wsplit, int n, int nin,
                                     int nout, int grid_size, void* stream) {
  return launch_tc_fwd<FourierTc>(x, ldx, {grid_size}, w, y, wsplit, n, nin, nout,
                                  (cudaStream_t)stream);
}

extern "C" int kanvit_fourierkan_bwd(const float* x, long long ldx,
                                     const float* w, const float* gy,
                                     float* dx, float* dw,
                                     unsigned int* gysplit, int n, int nin,
                                     int nout, int grid_size, void* stream) {
  if (bad_shape(n, 1, nin, nout) || grid_size <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dx != nullptr) {
    const int err = launch_dx<Fourier>(x, ldx, {grid_size}, w, gy, dx, nullptr, 0,
                                       nullptr, n, 1, nin, nout, st);
    if (err != 0) return err;
  }
  if (dw == nullptr) return 0;
  return launch_tc_dw<FourierTc>(x, ldx, {grid_size}, nullptr, gy, dw, gysplit,
                                 nullptr, n, nin, nout, st);
}

// The bf16 Fourier embedder's forward (fourierkan's, kanvit's bf16 serving
// policy, _fwd_kernel_kbf on bf16 operands, on part 3's Bf16 operand type):
// x, w and y bf16, w (groups, 2G, nin, nout) packed cos harmonics first;
// cos/sin(kx) of the upcast x by the recurrence in f32 in registers, seeded
// once and carried through the stage's chunks of 2 harmonics (walked inside
// each 8 features: ceil(nin / 8) ceil(G / 2) stages), rounded to bf16 at the
// dot, f32 accumulation in one running sum, y rounded to bf16 once; the bias
// is added outside. The shape above FOURIER_BF16_*; wsplit of wwords words
// (launch_tc_grouped_fwd, chunks included).
extern "C" int kanvit_fourierkan_tc_fwd_bf16(const void* x, long long ldx, int grid_size,
                                             const void* w, void* y, unsigned int* wsplit,
                                             long long wwords, int n, int groups, int nin,
                                             int nout, void* stream) {
  using bf = __nv_bfloat16;
  if (grid_size <= 0) return (int)cudaErrorInvalidValue;
  return launch_tc_grouped_fwd<FourierBf16, FOURIER_BF16_WARPS, FOURIER_BF16_MINB, false, 0,
                               Bf16>(
      static_cast<const bf*>(x), ldx, {grid_size}, static_cast<const bf*>(w),
      static_cast<bf*>(y), wsplit, wwords, n, groups, nin, nout, (cudaStream_t)stream);
}

// The bf16 Fourier embedder's backward (kanvit's bf16 training policy,
// _dx_kernel_kbf and _dw_kernel_kbf on bf16 operands, part 4): x, w, gy, dx
// and dw bf16. dx on kan_bf16_dx<FourierBf16>: gW = gy W^T in f32, never
// rounded, the Fourier fold in its epilogue (k (gW_sin c_k - gW_cos s_k)
// added harmonic by harmonic in f32, the recurrence seeded once and carried
// through the chunks), rounded once. dW on kan_bf16_dw<FourierBf16, NJ>, a
// block a chunk of 2 harmonics seeded at its first, the basis rounded to
// bf16 at the dot, the rows in at most `splits` splits into dw_part (splits
// groups 2G nin nout floats), summed in f32 and rounded once. dx or dw null
// to skip it.
extern "C" int kanvit_fourierkan_tc_bwd_bf16(const void* x, long long ldx, int grid_size,
                                             const void* w, const void* gy, void* dx, void* dw,
                                             float* dw_part, int n, int groups, int nin,
                                             int nout, int splits, void* stream) {
  using bf = __nv_bfloat16;
  if (grid_size <= 0) return (int)cudaErrorInvalidValue;
  return launch_bf16_grouped_bwd<FourierBf16>(
      static_cast<const bf*>(x), ldx, {grid_size}, static_cast<const bf*>(w),
      static_cast<const bf*>(gy), static_cast<bf*>(dx), static_cast<bf*>(dw), dw_part, n,
      groups, nin, nout, splits, (cudaStream_t)stream);
}
