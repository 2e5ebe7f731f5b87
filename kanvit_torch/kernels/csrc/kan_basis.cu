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
//
// At the ViT-S embedder (N = 64*196, 768 -> 384) each of y, dx and dW is
// 2*N*S*768*384 FLOPs, 67 GFLOP for B-spline, 37 for Chebyshev and 414 for
// Fourier G = 28, against ~70-110 MB of x, y (or gy) and W.
//
// Fourier runs in chunks of 4 harmonics (8 slices: their cos and sin), so no
// tile or register array grows with G: at G = 28 a 56-slice chunk would need
// 2 x 448 x 64 floats of forward tiles (229 KB, over a block's shared
// memory) and 448 accumulators a thread in dx and dW. Each harmonic is
// sincosf(k * x) with k * x rounded to f32, the reference's arithmetic
// (nfkan.py, kanvit's plain fourier_bases): one sincosf per value, harmonic
// and output tile. kanvit's TPU kernel (_fwd_kernel_kbf) builds them from
// one sincos(x) pair by angle addition instead, which a chunked walk would
// have to carry from chunk to chunk; its drift over 28 harmonics put dx ~40x
// further from the plain version, for a few percent of the kernels' time.
// B-spline stages its knots and the reciprocals of the knot differences in
// shared memory; the other families stage nothing. IEEE tanhf, sincosf and
// expf throughout: the arguments of sincosf reach 28 |x|, far outside where
// __sinf is accurate, and tanh.approx's 2^-11 error would show in T_4.
//
// Edge semantics follow kanvit_torch/ops/kan_bases.py: B-spline order-0
// bases are the half-open indicators g_j <= x < g_{j+1}, so x on a knot
// starts the next interval and x outside every span gets all-zero spline
// bases and derivatives; where tanh(x) rounds to +-1 the Chebyshev
// derivative is T'_n(+-1) * (1 - t^2) = 0.

#include "kan_basis.cuh"

namespace {

// B-spline: 12 knots a feature (grid 5, order 3), 8 spline bases + silu.
struct Bspline : FamilyDefaults {
  static constexpr int KNOTS = 12;
  static constexpr int ORDER = 3;
  static constexpr int NSPLINE = KNOTS - ORDER - 1;
  static constexpr int NINV = ORDER * KNOTS;
  static constexpr int SC = NSPLINE + 1;  // one chunk: all 9 slices
  static constexpr int BK = 8;
  static constexpr int DX_BK = 16;
  struct Params { const float* gridt; };  // (12, nin) row-major
  // knots[kf][j], inv[kf][(k-1)*KNOTS + j] = 1 / (g[j+k] - g[j])
  template <int NF> struct Stage { float knots[NF][KNOTS]; float inv[NF][NINV]; };

  __host__ __device__ static int slices(Params) { return SC; }
  __host__ __device__ static int chunks(Params) { return 1; }
  __device__ static int slice(Params, int, int j) { return j; }

  // Knots of features [k0, k0 + NF) and their reciprocals into shared
  // memory. Every thread of the block must call it (it synchronises).
  template <int NF>
  __device__ static void stage(Params p, int nin, int k0, int, Stage<NF>& st) {
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

// Fourier, G harmonics at run time, in chunks of HC = 4: chunk c holds
// harmonics k = 4c+1 .. 4c+4, entry j < 4 is cos(kx) (stored slice k-1) and
// entry 4 + j is sin(kx) (stored slice G + k-1).
struct Fourier : FamilyDefaults {
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
  __device__ static void stage(Params, int, int, int, Stage<NF>&) {}

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
  __device__ __forceinline__ static void values(Params, const Stage<NF>&,
                                                const Elem& e, int c,
                                                float (&v)[SC]) {
    float ch[HC], sh[HC];
    harmonics(e.x, c, ch, sh);
#pragma unroll
    for (int q = 0; q < HC; ++q) {
      v[q] = ch[q];
      v[HC + q] = sh[q];
    }
  }

  // d cos(kx)/dx = -k sin(kx), d sin(kx)/dx = k cos(kx)
  template <int NF>
  __device__ __forceinline__ static void derivs(Params, const Stage<NF>&,
                                                const Elem& e, int c,
                                                float (&d)[SC]) {
    float ch[HC], sh[HC];
    harmonics(e.x, c, ch, sh);
#pragma unroll
    for (int q = 0; q < HC; ++q) {
      const float k = (float)(c * HC + q + 1);
      d[q] = -k * sh[q];
      d[HC + q] = k * ch[q];
    }
  }
};

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
