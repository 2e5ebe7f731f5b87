// KAN contractions on Hopper's tensor cores, in four parts.
//
// Part 1: the Fourier and sine KAN layers' forward and weight gradient: one
// templated contraction over a basis generated on chip (kan_tc_kernel),
// instantiated for Fourier in kan_basis.cu and for sine in kan_rbf_sine.cu.
// Their dx stays on kan_basis.cuh's CUDA-core kan_dx_kernel.
//
// Part 2 (below, "The grouped q/k/v backward"): dW and dx of a grouped KAN
// projection, one group a head, templated over kan_basis.cuh's basis
// families (kan_tc_dw_grouped, kan_tc_dx_kernel); instantiated for B-spline
// and Chebyshev in kan_basis.cu and for RBF and sine in kan_rbf_sine.cu;
// the B-spline, FastKAN and Chebyshev embedders' backward is its one-group
// case.
//
// Part 3 (below, "The grouped q/k/v forward"): y of a grouped KAN projection
// (kan_tc_fwd_grouped), templated over the same families; instantiated for
// B-spline and Chebyshev in kan_basis.cu and for RBF and sine (up to 4
// slices) in kan_rbf_sine.cu; the B-spline, FastKAN and Chebyshev
// embedders' forward is its one-group case, its 768-deep sum in two
// levels. Its Bf16 operand type is kanvit's bf16 serving policy,
// instantiated for B-spline and Chebyshev (the embedder and the q/k/v) and
// the Fourier embedder in kan_basis.cu and for RBF and sine in
// kan_rbf_sine.cu; a family's slices past its tile walk it in chunks inside
// each 8 features (the bf16 sine embedder's 28 in 7 chunks of 4, the bf16
// Fourier embedder's 56 in 14). The f32 sine grouped forward past 4 slices
// stays on kan_basis.cuh's CUDA-core kan_fwd_kernel.
//
// Part 4 (below, "The bf16 backward"): dW and dx of a grouped KAN layer on
// bf16 operands (kan_bf16_dw, kan_bf16_dx), kanvit's bf16 training policy,
// templated over kan_basis.cuh's families; instantiated for B-spline,
// Chebyshev and Fourier in kan_basis.cu and for RBF and sine in
// kan_rbf_sine.cu, the embedder's backward its one-group case, the sine
// embedder's 28 slices and the Fourier embedder's 56 in chunks of 4 (dW a
// block a chunk, dx the chunks in turn in each block).
//
// Part 1:
//
//   forward  y[n, o]      = sum_(s,i) B_s(x[n, i]) W[s, i, o]
//   dW       dW[s, i, o]  = sum_n B_s(x[n, i]) gy[n, o]
//   sine     D[s, i, o]   = sum_n x[n, i] cos(arg_nis) gy[n, o],
//            dfreq_s      = sum_(i,o) W[s, i, o] D[s, i, o]
// (arg_nis = x[n, i] freq_s + phase_is). Both are C = A B with A generated:
// the forward's A is (rows x (slice, feature)), the basis; dW's is
// ((slice, feature) x rows), the basis transposed; B is W or gy.
//
// What bounds them on the H100: the products. At the vit-s embedder
// (12,544 rows, 768 -> 384, G 28) the Fourier forward and dW are each
// 414 GFLOP (f32 bound 6.18 ms at 67 TFLOP/s, 2.51 ms in 3xTF32 at the
// dense 495 TFLOP/s, 4.01 at mma.sync's measured 309.7), the sine forward
// 207, the sine dW with D 414; the bytes (x, W, gy or y, dW) take 0.04 ms.
// Beside the products: one sincosf per (row, feature, harmonic) and output
// tile (sinf for the sine forward), and the TF32 split of each value.
//
// Arithmetic (attention_tc.cuh): mma.sync.m16n8k8 in 3xTF32, each f32
// operand split into big + small TF32 words, each 8-deep step's three
// products into a zeroed accumulator that an f32 add takes into the running
// sum. The running sum is two-level: every FLUSH stages (896 contracted
// entries) it is added into a total (each element its one thread's) and
// restarted; one running sum over all 43,008 entries of the Fourier forward
// (12,544 of dW) would stray past twice the plain f32's distance from f64
// (tests/test_torch_port_kan_tc.py).
//
// Basis values keep the CUDA-core kernels' arithmetic: Fourier
// sincosf((float)k * x), the f32-rounded product; sine sin / cos of
// x freq + phase, IEEE sincosf / sinf (|arg| reaches hundreds).
//
// Warps. A block of 12: 8 MMA warps, 48 rows x 48 outputs of C each (3 x 6
// m16n8 tiles, 72 accumulators a thread), and 4 producer warps that fill
// the next stage while the MMA warps work on this one: they start its B
// tile's 16-byte cp.async copies, generate its A tile into shared memory,
// split into TF32 words laid out per fragment (afrags, fused_ffn.cu's
// layout), from the x (and sine's phase) they loaded into registers a stage
// before, and load the next stage's. Two buffers, one barrier a stage (bar.sync
// 1, from both loops). The B operand is split once a call by a pre-pass
// (kan_tc_split) into the per-column layout the fragments read (bpairs), in
// the stage order of the contraction: 132 MB for the vit-s Fourier W, 66
// MB for the sine W, 38.5 MB for gy. Generating the basis in the MMA warps
// between their stages took ~45% of the Fourier forward's time and ~55% of
// dW's on the H100: the sincosf chains and the loads of x stalled the
// tensor cores.
//
// Tiles (Tile<F, DW>). The contracted index runs in stages of KT = 32
// (four mma steps):
//   Fourier forward: 96 rows x 192 outputs (MMA warps 2 x 4); a stage is 16
//     features x one harmonic, entries 0-15 cos(kx) of the 16 features,
//     16-31 sin(kx), so one sincosf gives two entries; stages walk the
//     harmonics inside each chunk of 16 features. 131 x 2 blocks at vit-s:
//     two full waves, one block an SM.
//   sine forward: 48 rows x 384 outputs (MMA warps 1 x 8); a stage is 32
//     features x one slice, sin(arg). At 96 x 192 its one sinf a value (not
//     one sincosf for two) bound it; the wider tile feeds each sinf to twice
//     the outputs. 262 blocks: two full waves.
//   dW: 96 x 192; a stage is 32 rows. The block's 96 rows of C are 48
//     features x one harmonic (slice): rows 0-47 Fourier's cos (sine's
//     sin), rows 48-95 Fourier's sin (sine's x cos, the D route), again one
//     sincosf for two values. 448 x 2 blocks: 6.8 waves.
// Shared memory, 216 KB (one block an SM) in each: at 96 x 192 two stages
// of A 24 KB + B 48 KB and the 72 KB total; at 48 x 384 two stages of A
// 12 KB + B 96 KB, and the total goes to y instead (a flush's loads of y
// issued together).
//
// dW's rows need no splits: 448 x 2 blocks fill the card, so there is no
// scratch beyond the split gy and no second pass for dW. Sine's dfreq: each
// block's epilogue sums W D over its D rows and outputs in a fixed order
// into one partial, and sum_blocks_kernel (kan_rbf_sine.cu) sums the
// partials of each slice in a fixed order; D is never written. No atomics:
// a second backward gives the same bits.
//
// Ragged rows, features, outputs and a family's last chunk are zero in the
// generated A and the split B and never stored.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tc.cuh"
#include "kan_basis.cuh"

namespace {

namespace tc {
constexpr int THREADS = 256;                      // the 8 MMA warps
constexpr int PRODUCERS = 128;                    // the 4 warps that fill the stages
constexpr int MI = 3;                             // m16 tiles a warp (48 rows)
constexpr int NJ = 6;                             // n8 tiles a warp (48 outputs)
constexpr int KT = 32;                            // contracted entries a stage
constexpr int KSTEPS = KT / 8;                    // mma steps a stage
constexpr int ACC = MI * NJ * 4;                  // accumulators a thread
constexpr int FLUSH = 28;                         // stages a level of the sum
constexpr int FWD_PAIR_F = 16;                    // features a Fourier forward stage
constexpr int FWD_ONE_F = 32;                     // features a sine forward stage
constexpr int DW_F = 48;                          // features a dW block
}  // namespace tc

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// Fourier, G harmonics: packed slice h is cos((h+1) x), G + h sin((h+1) x).
struct FourierTc {
  struct Params { int grid_size; };
  static constexpr bool FWD_PAIR = true;  // a forward stage: 16 features, cos and sin
  static constexpr bool DW_D = false;     // dW's second half is dW (sin), not D
  __host__ __device__ static int harmonics(Params p) { return p.grid_size; }
  // The packed slice and feature of forward stage kt's entry k.
  __device__ static void fwd_entry(Params p, int kt, int k, int& slice, int& feature) {
    const int h = kt % p.grid_size;
    slice = k < tc::FWD_PAIR_F ? h : p.grid_size + h;
    feature = kt / p.grid_size * tc::FWD_PAIR_F + (k & (tc::FWD_PAIR_F - 1));
  }
  __device__ static int second_slice(Params p, int h) { return p.grid_size + h; }
  // What a stage's values share (harmonic k = h + 1), and what a value
  // needs beside x (nothing).
  __device__ __forceinline__ static float coef(Params, int h) { return (float)(h + 1); }
  __device__ __forceinline__ static float aux(Params, int, int) { return 0.f; }
  // cos and sin of k x: the f32-rounded product, as the reference.
  __device__ __forceinline__ static void pair(float xv, float, float k, float& first,
                                              float& second) {
    sincosf(k * xv, &second, &first);
  }
};

// Sine, S slices: sin(x freq_s + phase_is); its dW tile's second half is the
// D route's x cos(arg).
struct SineTc {
  struct Params {
    const float* freq;   // (S,)
    const float* phase;  // (nin, S)
    int grid_size;       // S
  };
  static constexpr bool FWD_PAIR = false;  // a forward stage: 32 features, sin
  static constexpr bool DW_D = true;
  __host__ __device__ static int harmonics(Params p) { return p.grid_size; }
  __device__ static void fwd_entry(Params p, int kt, int k, int& slice, int& feature) {
    slice = kt % p.grid_size;
    feature = kt / p.grid_size * tc::FWD_ONE_F + k;
  }
  __device__ static int second_slice(Params, int) { return -1; }
  // What a stage's values share (slice s's freq), and what a value needs
  // beside x (its feature's phase of slice s).
  __device__ __forceinline__ static float coef(Params p, int s) { return p.freq[s]; }
  __device__ __forceinline__ static float aux(Params p, int s, int feature) {
    return p.phase[(long long)feature * p.grid_size + s];
  }
  __device__ __forceinline__ static float one(float xv, float phase, float freq) {
    return sinf(xv * freq + phase);
  }
  __device__ __forceinline__ static void pair(float xv, float phase, float freq,
                                              float& first, float& second) {
    float sn, cs;
    sincosf(xv * freq + phase, &sn, &cs);
    first = sn;
    second = xv * cs;
  }
};

// A block's tile of C and its shared memory. The 8 MMA warps stand WM
// along the rows and 8 / WM along the outputs, 48 x 48 each: 96 x 192 for
// the Fourier forward and dW, 48 x 384 for the sine forward, whose one sinf
// a value (not one sincosf for two) bound it at 96 x 192. The two-level
// sum's total stays in shared memory where it fits (72 KB beside the two
// stages); the sine forward, whose stages take 216 KB, adds it into y.
template <class F, bool DW>
struct Tile {
  static constexpr int WM = DW || F::FWD_PAIR ? 2 : 1;
  static constexpr int WN = 8 / WM;
  static constexpr int BM = 48 * WM, BN = 48 * WN;
  static constexpr int A_WORDS = BM / 16 * tc::KSTEPS * 256;  // afrags of a stage
  static constexpr int B_WORDS = BN * 2 * tc::KT;             // bpairs of a stage
  static constexpr int STAGE_WORDS = A_WORDS + B_WORDS;
  static constexpr bool SMEM_TOTAL = WM == 2;
  static constexpr size_t SMEM =
      sizeof(float) * (2 * STAGE_WORDS + (SMEM_TOTAL ? tc::ACC * tc::THREADS : 0));
};

// B operand sources of the split pre-pass: B(k, col) of stage kt.
template <class F>
struct WSource {  // the forward's W, in F's stage order
  const float* w;
  typename F::Params p;
  int nin, nout;
  __device__ float operator()(long long kt, int k, int col) const {
    int slice, feature;
    F::fwd_entry(p, (int)kt, k, slice, feature);
    return feature < nin && col < nout
               ? w[((long long)slice * nin + feature) * nout + col] : 0.f;
  }
};

struct GySource {  // dW's gy, (n, nout) row-major: stage kt is rows 32 kt ..
  const float* gy;
  int n, nout;
  __device__ float operator()(long long kt, int k, int col) const {
    const long long row = kt * tc::KT + k;
    return row < n && col < nout ? gy[row * nout + col] : 0.f;
  }
};

// bpairs word of column col, step s, fragment thread t in a stage's tile:
// big(2t), big(2t+1), small(2t), small(2t+1); the XOR on the column's low
// bit puts a quarter-warp's 16-byte loads (columns g, g+1) on 32 banks.
__device__ __forceinline__ int tc_bword(int col, int s, int t) {
  return col * 2 * tc::KT + 16 * (s ^ (col & 1)) + 4 * t;
}

// out[(kt npad + col) 2KT + ...]: every stage's B tile, split, for all npad
// columns, stages of KTS entries (tc::KT, or the grouped dx's 16). A warp
// covers 8 columns of one step (reads: 8 rows of 32 bytes; writes: 64
// contiguous bytes a column), KTS / 8 warps a stage's steps.
template <class Src, int KTS = tc::KT>
__global__ void __launch_bounds__(256)
kan_tc_split(Src src, uint32_t* __restrict__ out, int npad, long long units) {
  constexpr int STEPS = KTS / 8;
  const int nb = npad / 8;
  for (long long u = blockIdx.x * 256LL + threadIdx.x; u < units;
       u += (long long)gridDim.x * 256) {
    const int t = (int)(u & 3), s = (int)((u >> 5) % STEPS);
    const long long rest = (u >> 5) / STEPS, kt = rest / nb;
    const int col = (int)(rest % nb) * 8 + (int)((u >> 2) & 7), k = 8 * s + 2 * t;
    store_b(out + (kt * npad + col) * 2 * KTS + 16 * (s ^ (col & 1)) + 4 * t,
            src(kt, k, col), src(kt, k + 1, col));
  }
}

// A producer thread's share of a stage's A tile: UNITS quads of a fragment
// (one lane's values at two rows and two contracted entries), U of them a
// thread. Per quad value q: the forward's (row g + 8 (q & 1), entry 2t +
// (q >> 1)), dW's (feature g + 8 (q & 1), row 2t + (q >> 1)).
template <class F, bool DW>
struct Gen {
  static constexpr int UNITS =
      DW ? tc::MI * tc::KSTEPS * 32
         : Tile<F, DW>::BM / 16 * (F::FWD_PAIR ? 2 : tc::KSTEPS) * 32;
  static constexpr int U = UNITS / tc::PRODUCERS;
  int ptid, n, nin, r0, f0, h;  // forward: rows r0 ..; dW: features f0 .., harmonic h

  // Row, feature and slice (harmonic) of unit u's value q in stage kt.
  __device__ __forceinline__ void at(typename F::Params p, int kt, int u, int q, long long& row,
                                     int& f, int& s) const {
    const int lane = u & 31, g = lane >> 2, t = lane & 3;
    if constexpr (DW) {
      const int st = (u >> 5) & 3, i = u >> 7;
      f = f0 + 16 * i + g + 8 * (q & 1);
      row = (long long)kt * tc::KT + 8 * st + 2 * t + (q >> 1);
      s = h;
    } else {
      const int hs = F::harmonics(p), i = F::FWD_PAIR ? u >> 6 : u >> 7;
      const int st = F::FWD_PAIR ? (u >> 5) & 1 : (u >> 5) & 3;  // Fourier: the half
      row = r0 + 16 * i + g + 8 * (q & 1);
      f = kt / hs * (F::FWD_PAIR ? tc::FWD_PAIR_F : tc::FWD_ONE_F) + 8 * st + 2 * t +
          (q >> 1);
      s = kt % hs;
    }
  }

  // x and the family's aux values of stage kt into xr, ar (0 outside).
  __device__ __forceinline__ void load(typename F::Params p, const float* __restrict__ x,
                                       long long ldx, int kt, float (&xr)[U][4],
                                       float (&ar)[U][4]) const {
#pragma unroll
    for (int q0 = 0; q0 < U; ++q0)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        long long row;
        int f, sl;
        at(p, kt, ptid + q0 * tc::PRODUCERS, q, row, f, sl);
        const bool in = row < n && f < nin;
        xr[q0][q] = in ? x[row * ldx + f] : 0.f;
        ar[q0][q] = in ? F::aux(p, sl, f) : 0.f;
      }
  }

  // Stage kt's values from xr, ar, split, into afrags at As.
  __device__ __forceinline__ void store(typename F::Params p, int kt, const float (&xr)[U][4],
                                        const float (&ar)[U][4], uint32_t* As) const {
    const float c = F::coef(p, DW ? h : kt % F::harmonics(p));  // the stage's slice
#pragma unroll
    for (int q0 = 0; q0 < U; ++q0) {
      const int u = ptid + q0 * tc::PRODUCERS, lane = u & 31;
      float a[4], b[4];
      int i = 0, sa = 0, sb = 0, ib = 0;  // afrags (m16 tile, step) of each quad
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        long long row;
        int f, sl;
        at(p, kt, u, q, row, f, sl);
        a[q] = b[q] = 0.f;
        if (row < n && f < nin) {
          if constexpr (DW || F::FWD_PAIR)
            F::pair(xr[q0][q], ar[q0][q], c, a[q], b[q]);
          else
            a[q] = F::one(xr[q0][q], ar[q0][q], c);
        }
      }
      if constexpr (DW) {  // first values: m16 tiles 0-2; second: 3-5
        i = u >> 7;
        sa = sb = (u >> 5) & 3;
        ib = i + tc::MI;
      } else if constexpr (F::FWD_PAIR) {  // cos: steps 0, 1; sin: steps 2, 3
        i = ib = u >> 6;
        sa = (u >> 5) & 1;
        sb = 2 + sa;
      } else {
        i = u >> 7;
        sa = (u >> 5) & 3;
      }
      store_a(As + (i * tc::KSTEPS + sa) * 256 + 4 * lane, a[0], a[1], a[2], a[3]);
      if constexpr (DW || F::FWD_PAIR)
        store_a(As + (ib * tc::KSTEPS + sb) * 256 + 4 * lane, b[0], b[1], b[2], b[3]);
    }
  }
};

// The stage barrier of the MMA and the producer warps, which reach it from
// their own loops: bar.sync 1 over the block's threads.
__device__ __forceinline__ void stage_barrier() {
  asm volatile("bar.sync 1, %0;" ::"n"(tc::THREADS + tc::PRODUCERS) : "memory");
}

// C = A B over nk stages. Forward (DW false): grid (npad / BN, row tiles),
// out = y (n, nout). dW: grid (npad / BN, feature tiles x harmonics), out =
// dW (S, nin, nout); a DW_D family's second half goes to part[b S + h], b =
// feature tile x gridDim.x + blockIdx.x, through w (S, nin, nout).
template <class F, bool DW>
__global__ void __launch_bounds__(tc::THREADS + tc::PRODUCERS, 1)
kan_tc_kernel(const float* __restrict__ x, long long ldx, typename F::Params p,
              const uint32_t* __restrict__ bsplit, const float* __restrict__ w,
              float* __restrict__ out, float* __restrict__ part, int n, int nin,
              int nout, int npad, int nk) {
  using T = Tile<F, DW>;
  // local names: kan_basis.cuh's THREADS shares the namespace
  constexpr int THREADS = tc::THREADS, MI = tc::MI, NJ = tc::NJ, KT = tc::KT;
  constexpr int KSTEPS = tc::KSTEPS, PRODUCERS = tc::PRODUCERS, FLUSH = tc::FLUSH;
  extern __shared__ __align__(16) float sm[];
  __shared__ float red[THREADS / 32];
  uint32_t* stages = reinterpret_cast<uint32_t*>(sm);
  float* total = sm + 2 * T::STAGE_WORDS;  // [accumulator][MMA thread]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool producer = tid >= THREADS;
  const int ptid = tid - THREADS;  // a producer's thread
  const int g = lane >> 2, t = lane & 3, wm = warp / T::WN, wn = warp % T::WN;
  const int n0 = blockIdx.x * T::BN;
  const int nfc = cdiv(nin, tc::DW_F);
  const int h = DW ? blockIdx.y / nfc : 0;
  const int f0 = DW ? blockIdx.y % nfc * tc::DW_F : 0;
  const int r0 = DW ? 0 : blockIdx.y * T::BM;

  if (producer) {
    // Stage kt + 1 while the MMA warps work on stage kt: its B tile by
    // cp.async, the x (and aux) of stage kt + 2 into registers, its A tile
    // generated from the ones loaded a stage before.
    using G = Gen<F, DW>;
    const G gen{ptid, n, nin, r0, f0, h};
    float xn[G::U][4], an[G::U][4];  // the next stage's
    auto fill = [&](int kt, int buf) {
      uint32_t* as = stages + buf * T::STAGE_WORDS;
      const uint32_t* src = bsplit + ((long long)kt * npad + n0) * 2 * KT;
#pragma unroll
      for (int i = 0; i < T::B_WORDS / 4 / PRODUCERS; ++i) {
        const int e = 4 * (ptid + i * PRODUCERS);
        cp_async16(reinterpret_cast<float*>(as + T::A_WORDS + e),
                   reinterpret_cast<const float*>(src + e), true);
      }
      cp_async_commit();
      float xc[G::U][4], ac[G::U][4];
#pragma unroll
      for (int u = 0; u < G::U; ++u)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          xc[u][q] = xn[u][q];
          ac[u][q] = an[u][q];
        }
      if (kt + 1 < nk) gen.load(p, x, ldx, kt + 1, xn, an);
      gen.store(p, kt, xc, ac, as);
    };
    gen.load(p, x, ldx, 0, xn, an);
    fill(0, 0);
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<0>();
      stage_barrier();  // stage kt's A and B visible; buffer (kt + 1) & 1 is free
      if (kt + 1 < nk) fill(kt + 1, (kt + 1) & 1);
    }
  } else {
    float acc[MI][NJ][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    if constexpr (T::SMEM_TOTAL) {
#pragma unroll
      for (int e = 0; e < tc::ACC; ++e) total[e * THREADS + tid] = 0.f;
    }
    for (int k0 = 0; k0 < nk; k0 += FLUSH) {
      for (int kt = k0; kt < min(k0 + FLUSH, nk); ++kt) {
        stage_barrier();
        const uint32_t* as = stages + (kt & 1) * T::STAGE_WORDS;
        const uint32_t* bs = as + T::A_WORDS;
#pragma unroll
        for (int s = 0; s < KSTEPS; ++s) {
          Frag<4> a[MI];
#pragma unroll
          for (int i = 0; i < MI; ++i)
            a[i] = load_a(as + ((MI * wm + i) * KSTEPS + s) * 256 + 4 * lane);
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const Frag<2> b = load_b(bs + tc_bword(48 * wn + 8 * j + g, s, t));
#pragma unroll
            for (int i = 0; i < MI; ++i) mma3(acc[i][j], a[i], b);
          }
        }
      }
      // the running sum of these FLUSH stages into the total (each element
      // its one thread's), and restarted: in shared memory, or in y
      if constexpr (T::SMEM_TOTAL) {
#pragma unroll
        for (int e = 0; e < tc::ACC; ++e) {
          total[e * THREADS + tid] += (&acc[0][0][0])[e];
          (&acc[0][0][0])[e] = 0.f;
        }
      } else {
#pragma unroll
        for (int i = 0; i < MI; ++i) {  // an m16 tile's 24 values at a time
          float old[NJ][4];
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = r0 + 48 * wm + 16 * i + g + 8 * (e >> 1);
              const int col = n0 + 48 * wn + 8 * j + 2 * t + (e & 1);
              old[j][e] = k0 > 0 && row < n && col < nout
                              ? out[(long long)row * nout + col] : 0.f;
            }
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = r0 + 48 * wm + 16 * i + g + 8 * (e >> 1);
              const int col = n0 + 48 * wn + 8 * j + 2 * t + (e & 1);
              if (row < n && col < nout)
                out[(long long)row * nout + col] = k0 > 0 ? old[j][e] + acc[i][j][e]
                                                          : acc[i][j][e];
              acc[i][j][e] = 0.f;
            }
        }
      }
    }
  }
  if constexpr (!DW) {
    if constexpr (T::SMEM_TOTAL) {  // y from the total
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = r0 + 48 * wm + 16 * i + g + 8 * (e >> 1);
            const int col = n0 + 48 * wn + 8 * j + 2 * t + (e & 1);
            if (!producer && row < n && col < nout)
              out[(long long)row * nout + col] = total[((i * NJ + j) * 4 + e) * THREADS + tid];
          }
    }
    return;
  }

  float dsum = 0.f;  // a DW_D family's W D over this thread's D values
  if (!producer) {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = total[((i * NJ + j) * 4 + e) * THREADS + tid];
          const int m = 16 * i + g + 8 * (e >> 1);  // within the warp's 48 rows
          const int col = n0 + 48 * wn + 8 * j + 2 * t + (e & 1);
          const int f = f0 + m;
          if (col >= nout || f >= nin) continue;
          if (wm == 0 || !F::DW_D) {
            const int slice = wm == 0 ? h : F::second_slice(p, h);
            out[((long long)slice * nin + f) * nout + col] = v;
          } else {
            dsum = fmaf(w[((long long)h * nin + f) * nout + col], v, dsum);
          }
        }
  }
  if constexpr (F::DW_D) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) dsum += __shfl_xor_sync(0xffffffffu, dsum, off);
    if (lane == 0 && !producer) red[warp] = dsum;
    __syncthreads();
    if (tid == 0) {
      float sum = 0.f;
      for (int wv = THREADS / 64; wv < THREADS / 32; ++wv) sum += red[wv];  // the D warps
      const long long b = (long long)(blockIdx.y % nfc) * gridDim.x + blockIdx.x;
      part[b * F::harmonics(p) + h] = sum;
    }
  }
}

// A kernel's dynamic shared memory past 48 KB.
template <class K>
int tc_attr(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

// nout rounded up to the tile's outputs.
template <class F, bool DW>
int tc_npad(int nout) {
  return cdiv(nout, Tile<F, DW>::BN) * Tile<F, DW>::BN;
}

// Stages of the forward's contraction.
template <class F>
int tc_fwd_stages(typename F::Params p, int nin) {
  return cdiv(nin, F::FWD_PAIR ? tc::FWD_PAIR_F : tc::FWD_ONE_F) * F::harmonics(p);
}

template <class Src, int KTS = tc::KT>
int tc_split(Src src, uint32_t* out, int npad, long long stages, cudaStream_t st) {
  const long long units = stages * npad * (KTS / 8) * 4;
  const long long want = (units + 255) / 256;
  kan_tc_split<Src, KTS><<<(unsigned)(want < 132 * 16 ? want : 132 * 16), 256, 0, st>>>(
      src, out, npad, units);
  return (int)cudaGetLastError();
}

// y (n, nout) = B(x) W for a groups-1 layer; wsplit: scratch of
// tc_fwd_stages * npad * 2 KT words (npad: tc_npad<F, false>), 16-byte
// aligned.
template <class F>
int launch_tc_fwd(const float* x, long long ldx, typename F::Params p, const float* w,
                  float* y, uint32_t* wsplit, int n, int nin, int nout,
                  cudaStream_t st) {
  if (n <= 0 || nin <= 0 || nout <= 0 || F::harmonics(p) <= 0 ||
      (uintptr_t)wsplit % 16 != 0)
    return (int)cudaErrorInvalidValue;
  using T = Tile<F, false>;
  const int npad = tc_npad<F, false>(nout), nk = tc_fwd_stages<F>(p, nin);
  const dim3 grid(npad / T::BN, cdiv(n, T::BM));
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  int err = tc_split(WSource<F>{w, p, nin, nout}, wsplit, npad, nk, st);
  if (err != 0) return err;
  err = tc_attr(kan_tc_kernel<F, false>, T::SMEM);
  if (err != 0) return err;
  kan_tc_kernel<F, false><<<grid, tc::THREADS + tc::PRODUCERS, T::SMEM, st>>>(
      x, ldx, p, wsplit, nullptr, y, nullptr, n, nin, nout, npad, nk);
  return (int)cudaGetLastError();
}

// dW (S, nin, nout) = B(x)^T gy, and for a DW_D family the per-block
// partials of dfreq into part (feature tiles x npad / BN x S floats);
// gysplit: scratch of cdiv(n, KT) * npad * 2 KT words (npad:
// tc_npad<F, true>), 16-byte aligned.
template <class F>
int launch_tc_dw(const float* x, long long ldx, typename F::Params p, const float* w,
                 const float* gy, float* dw, uint32_t* gysplit, float* part, int n,
                 int nin, int nout, cudaStream_t st) {
  if (n <= 0 || nin <= 0 || nout <= 0 || F::harmonics(p) <= 0 ||
      (uintptr_t)gysplit % 16 != 0 || (F::DW_D && part == nullptr))
    return (int)cudaErrorInvalidValue;
  using T = Tile<F, true>;
  const int npad = tc_npad<F, true>(nout), nk = cdiv(n, tc::KT);
  const long long tiles = (long long)cdiv(nin, tc::DW_F) * F::harmonics(p);
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  int err = tc_split(GySource{gy, n, nout}, gysplit, npad, nk, st);
  if (err != 0) return err;
  err = tc_attr(kan_tc_kernel<F, true>, T::SMEM);
  if (err != 0) return err;
  kan_tc_kernel<F, true><<<dim3(npad / T::BN, (unsigned)tiles),
                           tc::THREADS + tc::PRODUCERS, T::SMEM, st>>>(
      x, ldx, p, gysplit, w, dw, part, n, nin, nout, npad, nk);
  return (int)cudaGetLastError();
}

// ===========================================================================
// Part 2: the grouped q/k/v backward on the tensor cores.
//
// Replaces the CUDA-core kan_dx_kernel + kan_dw_kernel pair for the grouped
// q/k/v projection's backward (kanvit/kernels/fused_basis.py::_fused_bwd_sg,
// pallas_call at :1278, reached from _bspline_op_sg_bwd :1330 and
// bspline_qkv_grouped :1361). For every group (head) g, x_g (n, nin) and
// gy_g (n, nout) the columns of x and gy that belong to it, W_g (S, nin,
// nout) packed:
//   dW_g[s, f, o] = sum_n B_s(x_g[n, f]) gy_g[n, o]     (over the rows)
//   dx_g[n, f]    = sum_s B'_s(x_g[n, f]) gW[n, (s, f)],
//   gW            = gy_g W_g^T                          (over the outputs)
// with the family's basis B and derivative B' (kan_basis.cu's B-spline: the
// 8 cubic bases of a 12-knot grid and silu, S = 9, the knots of group g at
// gridt + g gstride, so a refit grid a head is one more stride), or the
// family's own fold of gW (kan_rbf_sine.cu). Instantiated for B-spline and
// Chebyshev (T_0..T_4 of tanh x, S = 5; _cheby_op_sg_bwd, :1351) in
// kan_basis.cu, and for RBF (FastKAN: 8 Gaussians of the head's LayerNorm
// and silu, S = 9, or 8 without the base slice; _rbf_ln_sg_op_bwd, :3246)
// and sine (S = G <= 4 slices; _sine_op_sg_bwd, :1557) in kan_rbf_sine.cu.
// A family's tile holds SC slices; a weight of S < SC slices leaves the
// rest zero in both operands and never stores them. The FastKAN patch
// embedder's backward (_rbf_ln_base_op_bwd, :2995, and the tier without
// its LayerNorm, :2769) is RBF's one-group case: at vit-s (12,544 rows,
// 768 -> 384) dW takes 48 feature tiles x 2 tiles of 192 outputs (NJ 3),
// its rows in 11 splits, 1,056 blocks, 8 waves of one block an SM
// (tc_grouped_dw_splits rounds the splits up to whole waves), and the dx
// kernel writes dln, 4,704 blocks, 384 outputs deep in one running sum. So
// is the B-spline patch embedder's (_fused_bwd, :1159, from bspline_kan's
// VJP), the same shape with B' in the dx kernel's epilogue; the training
// step asks it for dW alone. And the Chebyshev patch embedder's (_fused_bwd,
// :1159, from _cheby_op's VJP, :3499): 5 slices, one dW block an SM at NJ 3
// too (below), 11 splits; at vit-s its dW alone ran 0.9440 ms against the
// CUDA-core kernels' 2.4350, with dx 1.7011 against 4.3577, on the H100
// 80GB HBM3 at 700 W (kanvit_torch/probe_embedder_rbf.py --cheby, which
// timed 8, 16 and 22 splits within 0.04 ms of 11).
//
// What bounds it on the H100: the products. At the vit-s q/k/v (n 12,608,
// 6 heads of nin 64, nout 192) dW and dx are 16.73 GFLOP each: 0.4995 ms in
// f32 at 67 TFLOP/s, 0.2028 ms in 3xTF32 at the dense 495 TFLOP/s, 0.324 at
// mma.sync's measured 309.7; the bytes (x, gy, W, dx, dW) take 0.04 ms.
// FastKAN's and sine's q/k/v (one projection: nout 64, S 9 and 4) are 5.58
// and 2.48 GFLOP each; beside the products, their basis (8 expf and silu,
// or 4 sinf, per x value in dW; the fold's expf, cosf in dx) and the
// LayerNorm's row passes (FastKAN: 0.058 of its 0.407 ms on the H100 80GB
// HBM3 at 700 W, probe_qkv.py) bound them.
// Arithmetic: 3xTF32 mma.sync.m16n8k8 (attention_tc.cuh), through the
// operand type Op (Tf32x3; a bf16 type would take one product a step).
//
// dW (kan_tc_dw_grouped<F, NJ>): C = A B with A the basis transposed,
// ((slice, feature) x rows), generated on chip, and B gy, landing raw by
// cp.async two stages ahead into one of three buffers and split as each
// warp loads its fragments (each warp owns its outputs, so each value is
// split once a block; a pre-pass writing gy split, 116 MB at vit-s, took
// 0.151 ms of the first form's 0.902 on the H100 80GB HBM3 at 700 W,
// probe_qkv.py; bpairs split a stage ahead held 32 KB more shared memory
// and one block an SM: FastKAN's dW 0.2405 ms, raw 0.1842). A block holds
// 16 features of one group, all F::SC slices of each: SC m16 tiles of C
// (144 rows for B-spline), by 64 NJ outputs (NJ 3: 192, the vit-s q|k|v;
// NJ 1: 64 where nout <= 64), 8 warps side by side along the outputs, SC x
// NJ m16n8 tiles a warp (108 accumulators at NJ 3). A stage is 32 rows:
// while the warps run stage kt's products, every thread generates two x
// values' SC basis values of stage kt + 1 (one Cox-de Boor pass for all 9,
// never one a slice), split into afrags; two A buffers, one barrier a
// stage. One block an SM at NJ 3, two at NJ 1 (three for 4 slices):
// tc_dw_blocks. At NJ 3 a block takes 2 SC 4 KB of A and 73.5 KB of raw
// gy: 116.2 KB for Chebyshev's 5 slices, so two blocks (with the 1 KB the
// card reserves for each) would need 234,496 bytes of the SM's 233,472, and
// Chebyshev runs one block an SM there too. The grouped dW is only 6 heads
// x 4 feature tiles x 1 output tile at vit-s, 24 blocks, so the rows are
// cut into splits (22 there: 528 blocks), each writing its partial, summed
// in split order by sum_splits_kernel: no atomics, a second backward
// repeats the bits. Inside a split the running sum is added into the
// split's partial every tc::FLUSH stages (part 1's two-level sum; the
// partial is the block's own slab).
//
// dx (kan_tc_dx_kernel<F>): C = gy_g W_g^T, gy landing raw by cp.async and
// split by each warp as it loads its fragments, W^T split once a call by the
// pre-pass (WtSource, stages of 16 outputs). A block holds 128 rows x 16
// features of one group, every slice of each: C's columns are (half,
// slice, feature), so warp (row group, half) holds 32 rows x the 8 features
// of its half x all SC slices, and each thread all SC values of its (row,
// feature) pairs. The epilogue generates B'_s(x) (the family's closed form)
// and reduces over s in registers, or hands the SC values to the family's
// fold (kan_dx_kernel's contract: RBF keeps dln and the silu term apart
// for the LayerNorm's VJP, sine adds x cos(arg) gW_s into per-slice sums
// for dfreq, reduced over the block in a fixed order): gW never leaves the
// registers. 8 warps, 2 blocks an SM; 2,376 blocks at the vit-s q|k|v. The
// contraction is nout deep (192), one running sum.
//
// Ragged rows, features and outputs are zero in the generated A and the
// split operands and never stored. gy rows need no alignment: 16-byte
// copies where every row of gy starts on 16 bytes, 4-byte copies otherwise.
// ===========================================================================

// The operand type of the grouped kernels: 3xTF32 (each f32 operand split
// into big + small TF32 words, three mma a step into a zeroed accumulator
// added in f32).
struct Tf32x3 {
  using A = Frag<4>;
  using B = Frag<2>;
  // Part 3's forward: f32 x, W and y; one slice a step (8 deep); a (step,
  // column, fragment thread) word group of the split W is 4 words.
  using In = float;
  using Out = float;
  static constexpr int SPS = 1, UNIT = 4;
  __device__ __forceinline__ static float in(float x) { return x; }
  __device__ __forceinline__ static float out(float x) { return x; }
  __device__ __forceinline__ static A load_a(const uint32_t* at) { return ::load_a(at); }
  __device__ __forceinline__ static B load_b(const uint32_t* at) { return ::load_b(at); }
  // Two of a lane's four afrag words (2h, 2h + 1), split: big at at, small at
  // at + 128.
  __device__ __forceinline__ static void store_a2(uint32_t* at, float a0, float a1) {
    uint2 b, sm;
    split_round(a0, b.x, sm.x);
    split_round(a1, b.y, sm.y);
    *reinterpret_cast<uint2*>(at) = b;
    *reinterpret_cast<uint2*>(at + 128) = sm;
  }
  // A B fragment (k = 2t, 2t + 1 of the step; column g) of a raw row-major
  // (k x column) tile: `at` points at (the step's first row + 2t, g). The
  // words of store_b.
  template <int PITCH>
  __device__ __forceinline__ static B cols(const float* at) {
    const float v[2] = {at[0], at[PITCH]};
    return split_frag(v);
  }
  // A fragment (rows m, m + 8; k = 2t, 2t + 1 of the step) of a raw row-major
  // tile: `at` points at (m, the step's first column + 2t).
  template <int PITCH>
  __device__ __forceinline__ static A rows(const float* at) {
    const float2 lo = *reinterpret_cast<const float2*>(at);
    const float2 hi = *reinterpret_cast<const float2*>(at + 8 * PITCH);
    const float v[4] = {lo.x, hi.x, lo.y, hi.y};
    return split_frag(v);
  }
  // An A fragment from its four values in register order, split.
  __device__ __forceinline__ static A frag(const float (&v)[4]) { return split_frag(v); }
  __device__ __forceinline__ static void mma(float (&d)[4], const A& a, const B& b) {
    mma3(d, a, b);
  }
  // d += a b with each operand in three TF32 words (its split and its
  // remainder, ar and br): six products, down to small*small and the
  // remainders against the big words, smallest first, into a zeroed
  // accumulator added in f32; what is dropped is ~2^-33 of a product.
  __device__ __forceinline__ static void mma_exact(float (&d)[4], const A& a,
                                                   const uint32_t (&ar)[4], const B& b,
                                                   const uint32_t (&br)[2]) {
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    mma_tf32(c, ar, b.big);
    mma_tf32(c, a.big, br);
    mma_tf32(c, a.small, b.small);
    mma_tf32(c, a.small, b.big);
    mma_tf32(c, a.big, b.small);
    mma_tf32(c, a.big, b.big);
#pragma unroll
    for (int i = 0; i < 4; ++i) d[i] += c[i];
  }
};

// The bf16 operand type of part 3's forward (kanvit's bf16 policy,
// fused_basis.py:521-531, :1253): bf16 x, W and y, the basis made in f32
// from the upcast x and rounded to bf16 once, at the dot, one
// mma.sync.m16n8k16 a step, f32 accumulation through the whole sum, y
// rounded to bf16 once. A 16-deep step holds two slices of a stage's 8
// features (k 0..7 slice s, k 8..15 slice s + 1; past SC zero), so a lane's
// A fragment holds the same four x values as Tf32x3's, (rows g, g + 8;
// features 2t, 2t + 1), in both halves: a0 (row g, slice s), a1 (row g + 8,
// slice s), a2 and a3 the same of slice s + 1, each word the two features.
// A (step, column, fragment thread) word group of the split W is 2 words:
// the B fragment's (slice s, features 2t, 2t + 1) and (slice s + 1, the
// same).
struct Bf16 {
  struct A { uint32_t w[4]; };
  struct B { uint32_t w[2]; };
  using In = __nv_bfloat16;
  using Out = __nv_bfloat16;
  static constexpr int SPS = 2, UNIT = 2;
  __device__ __forceinline__ static float in(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ __forceinline__ static __nv_bfloat16 out(float x) {
    return __float2bfloat16_rn(x);
  }
  // The step of slices s, s + 1 from a lane's basis values v[q][slice]
  // (value q: row g + 8 (q & 1), feature 2t + (q >> 1)).
  template <int SC>
  __device__ __forceinline__ static A pair(const float (&v)[4][SC], int s) {
    A a;
    a.w[0] = pack_bf16(v[0][s], v[2][s]);
    a.w[1] = pack_bf16(v[1][s], v[3][s]);
    a.w[2] = s + 1 < SC ? pack_bf16(v[0][s + 1], v[2][s + 1]) : 0u;
    a.w[3] = s + 1 < SC ? pack_bf16(v[1][s + 1], v[3][s + 1]) : 0u;
    return a;
  }
  __device__ __forceinline__ static B load_b(const uint32_t* at) {
    const uint2 w = *reinterpret_cast<const uint2*>(at);
    return {{w.x, w.y}};
  }
  __device__ __forceinline__ static void mma(float (&d)[4], const A& a, const B& b) {
    mma_bf16(d, a.w, b.w);
  }
};

namespace tcg {
constexpr int THREADS = 256;       // 8 warps
constexpr int FT = 16;             // features a block: an m16 tile a slice (dW)
constexpr int DX_BM = 128;         // rows a dx block
constexpr int DX_KS = 16;          // outputs a dx stage
constexpr int DX_PITCH = DX_KS + 8;  // the raw gy tile's pitch, 8 mod 32
constexpr int DW_WIDE = 3;         // NJ of nout > 64
}  // namespace tcg

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(s), "l"(src), "r"(in ? 4 : 0) : "memory");
}

// dx's W^T of every group and feature tile: stage kt' = (g ftn + ft) nk + kt
// holds outputs 16 kt .. 16 kt + 15 by the tile's columns (half, slice,
// feature): column c is feature 16 ft + 8 (c / 8 SC) + c % 8 of slice
// c / 8 % SC; slices past the weight's S are zero.
template <int SC>
struct WtSource {
  const float* w;  // (groups, S, nin, nout)
  int slices, nin, nout, ftn, nk;
  __device__ float operator()(long long kt, int k, int col) const {
    const long long gft = kt / nk;
    const int g = (int)(gft / ftn), ft = (int)(gft % ftn);
    const int o = (int)(kt % nk) * tcg::DX_KS + k;
    const int s = col / 8 % SC, f = ft * tcg::FT + col / (8 * SC) * 8 + col % 8;
    return s < slices && o < nout && f < nin
               ? w[(((long long)g * slices + s) * nin + f) * nout + o] : 0.f;
  }
};

// Blocks an SM the grouped dW kernel is built for: one at NJ 3 (108
// accumulators a thread), two at NJ 1, three at NJ 1 for a tile of at most
// 4 slices (registers 128 and 85 a thread).
template <int SC, int NJ>
constexpr int tc_dw_blocks() {
  return NJ > 1 ? 1 : SC <= 4 ? 3 : 2;
}

// dW of one group's 16 features x 64 NJ outputs over the rows of one split:
// grid (npad / 64 NJ, feature tiles x groups, splits). out: dW (groups, S,
// nin, nout) with one split, else split z's partial at z groups S nin nout
// (S = F::slices(p) <= SC: a family's tile slices past S are zero, never
// stored).
// gy (n, ldg), group g's columns at g nout; vec: 16-byte copies of it.
template <class F, int NJ, class Op = Tf32x3>
__global__ void __launch_bounds__(tcg::THREADS, (tc_dw_blocks<F::SC, NJ>()))
kan_tc_dw_grouped(const float* __restrict__ x, long long ldx, typename F::Params p,
                  const float* __restrict__ gy, long long ldg, float* __restrict__ out,
                  int n, int groups, int nin, int nout, int nk, int stages_per_split,
                  int vec) {
  constexpr int THREADS = tcg::THREADS, SC = F::SC, KT = tc::KT, KSTEPS = tc::KSTEPS;
  constexpr int BN = 64 * NJ;
  constexpr int A_WORDS = SC * KSTEPS * 256;  // afrags of a stage: SC m16 tiles
  constexpr int RAW_P = BN + 4;               // raw gy's pitch, 4 mod 32
  constexpr int RAW = KT * RAW_P;             // a stage's raw gy
  extern __shared__ __align__(16) float sm[];
  __shared__ typename F::template Stage<tcg::FT> st;
  uint32_t* stages = reinterpret_cast<uint32_t*>(sm);
  float* raw = sm + 2 * A_WORDS;  // 3 x RAW: gy of this stage, the next and the one after
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t = lane & 3;
  const int ftn = cdiv(nin, tcg::FT);
  const int o0 = blockIdx.x * BN, grp = blockIdx.y / ftn;
  const int f0 = blockIdx.y % ftn * tcg::FT;
  const int kt0 = blockIdx.z * stages_per_split;
  const int kt1 = min(nk, kt0 + stages_per_split);
  const int S = F::slices(p);
  const float* gyg = gy + (long long)grp * nout + o0;
  F::template stage<tcg::FT>(p, nin, f0, grp, st);

  // gy of stage kt (32 rows x BN outputs) into raw buffer buf, by cp.async
  auto load_gy = [&](int kt, int buf) {
    float* r = raw + buf * RAW;
    if (vec) {
#pragma unroll
      for (int i = 0; i < KT * BN / 4 / THREADS; ++i) {
        const int e = tid + i * THREADS, k = e / (BN / 4), c = e % (BN / 4) * 4;
        const long long row = (long long)kt * KT + k;
        const bool in = row < n && o0 + c < nout;
        cp_async16(r + k * RAW_P + c, in ? gyg + row * ldg + c : gyg, in);
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < KT * BN / THREADS; ++i) {
        const int e = tid + i * THREADS, k = e / BN, c = e % BN;
        const long long row = (long long)kt * KT + k;
        const bool in = row < n && o0 + c < nout;
        cp_async4(r + k * RAW_P + c, in ? gyg + row * ldg + c : gyg, in);
      }
    }
  };

  // This thread's two x values a stage: row 8 gs + 2 gt + hr of the stage,
  // features f0 + gg and f0 + gg + 8 (half hr of lane gl's quad, step gs).
  const int hr = tid & 1, gl = (tid >> 1) & 31, gs = tid >> 6;
  const int gg = gl >> 2, gt = gl & 3;
  const int fa = f0 + gg, fb = fa + 8;
  const float* xg = x + (long long)grp * nin;
  auto row_of = [&](int kt) { return (long long)kt * KT + 8 * gs + 2 * gt + hr; };
  float xa, xb;  // x of the next stage to make
  auto load_x = [&](int kt) {
    const long long row = row_of(kt);
    const bool live = kt < kt1 && row < n;
    xa = live && fa < nin ? xg[row * ldx + fa] : 0.f;
    xb = live && fb < nin ? xg[row * ldx + fb] : 0.f;
  };
  // Stage kt's A into buffer buf: the basis of xa, xb split into afrags.
  auto make = [&](int kt, int buf) {
    uint32_t* as = stages + buf * A_WORDS;
    const long long row = row_of(kt);
    float va[SC], vb[SC];
#pragma unroll
    for (int s = 0; s < SC; ++s) va[s] = vb[s] = 0.f;
    if (row < n && fa < nin) F::template values<tcg::FT>(p, st, Elem{xa, gg, fa, grp, row}, 0, va);
    if (row < n && fb < nin)
      F::template values<tcg::FT>(p, st, Elem{xb, gg + 8, fb, grp, row}, 0, vb);
#pragma unroll
    for (int s = 0; s < SC; ++s)
      Op::store_a2(as + (s * KSTEPS + gs) * 256 + 4 * gl + 2 * hr, va[s], vb[s]);
  };

  float acc[SC][NJ][4];
#pragma unroll
  for (int i = 0; i < SC; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  // the running sum added into this split's partial (the first time
  // written), then restarted
  float* dst = out + ((long long)blockIdx.z * groups + grp) * S * nin * nout;
  auto flush = [&](bool first) {
#pragma unroll
    for (int i = 0; i < SC; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int f = f0 + g8 + 8 * (e >> 1);
          const int o = o0 + 8 * (warp * NJ + j) + 2 * t + (e & 1);
          if (i < S && f < nin && o < nout) {
            float* d = dst + ((long long)i * nin + f) * nout + o;
            *d = first ? acc[i][j][e] : *d + acc[i][j][e];
          }
          acc[i][j][e] = 0.f;
        }
  };

  // Stage kt + 1's A is made, and kt + 2's gy lands, while stage kt's
  // products run: A buffers by (stage - kt0) & 1, gy buffers by (stage -
  // kt0) % 3; one cp.async group a stage.
  load_gy(kt0, 0);
  cp_async_commit();
  if (kt0 + 1 < kt1) load_gy(kt0 + 1, 1);
  cp_async_commit();
  load_x(kt0);
  make(kt0, 0);
  load_x(kt0 + 1);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int b = (kt - kt0) & 1, r = (kt - kt0) % 3;
    cp_async_wait<1>();
    __syncthreads();  // stage kt made, its gy landed; A buffer b ^ 1 and gy buffer r + 2 free
    if (kt + 2 < kt1) load_gy(kt + 2, (r + 2) % 3);
    cp_async_commit();
    if (kt + 1 < kt1) {
      make(kt + 1, b ^ 1);
      load_x(kt + 2);
    }
    const uint32_t* as = stages + b * A_WORDS;
    const float* rs = raw + r * RAW;
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) {
      typename Op::B bf[NJ];  // gy's rows 8 s + 2 t, + 1 of column 8 (warp NJ + j) + g8
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        bf[j] = Op::template cols<RAW_P>(rs + (8 * s + 2 * t) * RAW_P + 8 * (warp * NJ + j) + g8);
#pragma unroll
      for (int i = 0; i < SC; ++i) {
        const typename Op::A a = Op::load_a(as + (i * KSTEPS + s) * 256 + 4 * lane);
#pragma unroll
        for (int j = 0; j < NJ; ++j) Op::mma(acc[i][j], a, bf[j]);
      }
    }
    const int done = kt + 1 - kt0;
    if (done % tc::FLUSH == 0 || kt + 1 == kt1) flush(done <= tc::FLUSH);
  }
}

// dx of one group's 128 rows x 16 features: grid (feature tiles, row tiles,
// groups); wsplit from WtSource, 16-output stages of 2 SC 8 columns. The
// epilogue keeps kan_dx_kernel's contract (kan_basis.cuh): per (row,
// feature) two outputs, o0 from the family's derivatives (sum_s B'_s gW_s)
// or, with DX_FOLD, o0 and o1 from its fold; with `split` o0 goes to out0
// and o1 to out1 (either may be null), without it o0 + o1 to out0 (null:
// nothing is written). A DX_RED family's per-slice sums are reduced over
// the block in a fixed order into red_part[g][block][slice] (null:
// skipped), block = row tile x feature tiles + feature tile.
template <class F, class Op = Tf32x3>
__global__ void __launch_bounds__(tcg::THREADS, 2)
kan_tc_dx_kernel(const float* __restrict__ x, long long ldx, typename F::Params p,
                 const float* __restrict__ gy, long long ldg,
                 const uint32_t* __restrict__ wsplit, float* __restrict__ out0,
                 float* __restrict__ out1, int split, float* __restrict__ red_part, int n,
                 int groups, int nin, int nout, int nk, int vec) {
  constexpr int THREADS = tcg::THREADS, SC = F::SC, BM = tcg::DX_BM;
  constexpr int KS = tcg::DX_KS, PITCH = tcg::DX_PITCH;
  constexpr int NC = 2 * SC * 8;           // columns of C: (half, slice, feature)
  constexpr int A_FLOATS = BM * PITCH;     // gy, raw
  constexpr int B_WORDS = NC * 2 * KS;     // W^T, split
  constexpr int STAGE = A_FLOATS + B_WORDS;
  extern __shared__ __align__(16) float sm[];
  __shared__ typename F::template Stage<tcg::FT> st;
  __shared__ float redw[F::DX_RED ? THREADS / 32 : 1][SC];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t = lane & 3, wr = warp >> 1, wh = warp & 1;
  const int ftn = cdiv(nin, tcg::FT);
  const int f0 = blockIdx.x * tcg::FT, r0 = blockIdx.y * BM, grp = blockIdx.z;
  const float* gyg = gy + (long long)grp * nout;
  const uint32_t* wsrc = wsplit + ((long long)grp * ftn + blockIdx.x) * nk * B_WORDS;
  F::template stage<tcg::FT>(p, nin, f0, grp, st);

  auto stage = [&](int kt, int buf) {
    float* a = sm + buf * STAGE;
    const int k0 = kt * KS;
    if (vec) {  // rows of gy on 16 bytes, nout % 4 == 0
#pragma unroll
      for (int i = 0; i < BM * KS / 4 / THREADS; ++i) {
        const int e = tid + i * THREADS, r = e / (KS / 4), c = e % (KS / 4) * 4;
        const int row = r0 + r, col = k0 + c;
        const bool in = row < n && col < nout;
        cp_async16(a + r * PITCH + c, in ? gyg + row * ldg + col : gyg, in);
      }
    } else {
#pragma unroll
      for (int i = 0; i < BM * KS / THREADS; ++i) {
        const int e = tid + i * THREADS, r = e / KS, c = e % KS;
        const int row = r0 + r, col = k0 + c;
        const bool in = row < n && col < nout;
        cp_async4(a + r * PITCH + c, in ? gyg + row * ldg + col : gyg, in);
      }
    }
    uint32_t* b = reinterpret_cast<uint32_t*>(a + A_FLOATS);
    const uint32_t* src = wsrc + (long long)kt * B_WORDS;
    for (int e = 4 * tid; e < B_WORDS; e += 4 * THREADS)
      cp_async16(reinterpret_cast<float*>(b + e), reinterpret_cast<const float*>(src + e),
                 true);
    cp_async_commit();
  };

  float acc[2][SC][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < SC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  stage(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<0>();
    __syncthreads();  // stage kt landed; the other buffer is free
    if (kt + 1 < nk) stage(kt + 1, (kt + 1) & 1);
    const float* a = sm + (kt & 1) * STAGE;
    const uint32_t* b = reinterpret_cast<const uint32_t*>(a + A_FLOATS);
#pragma unroll
    for (int s = 0; s < KS / 8; ++s) {
      typename Op::A af[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        af[i] = Op::template rows<PITCH>(a + (32 * wr + 16 * i + g8) * PITCH + 8 * s + 2 * t);
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const int col = (wh * SC + j) * 8 + g8;
        const typename Op::B bf = Op::load_b(b + col * 2 * KS + 16 * (s ^ (col & 1)) + 4 * t);
#pragma unroll
        for (int i = 0; i < 2; ++i) Op::mma(acc[i][j], af[i], bf);
      }
    }
  }

  // The epilogue of this thread's rows (g8, g8 + 8 of its two m16 tiles)
  // and features (2t, 2t + 1 of its half), each with all SC slices of gW:
  // sum_s B'_s(x) gW_s in slice order, or the family's fold.
  const long long ldd = (long long)groups * nin;
  float red[SC];
#pragma unroll
  for (int j = 0; j < SC; ++j) red[j] = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long row = r0 + 32 * wr + 16 * i + g8 + 8 * (e >> 1);
      const int kf = 8 * wh + 2 * t + (e & 1), f = f0 + kf;
      if (row >= n || f >= nin) continue;
      const Elem el{x[row * ldx + (long long)grp * nin + f], kf, f, grp, row};
      float o0 = 0.f, o1 = 0.f;
      if constexpr (F::DX_FOLD) {
        float gw[SC];
#pragma unroll
        for (int j = 0; j < SC; ++j) gw[j] = acc[i][j][e];
        F::template fold<tcg::FT>(p, st, el, 0, gw, o0, o1, red);
      } else {
        float d[SC];
        F::template derivs<tcg::FT>(p, st, el, 0, d);
#pragma unroll
        for (int j = 0; j < SC; ++j) o0 = fmaf(acc[i][j][e], d[j], o0);
      }
      const long long at = row * ldd + (long long)grp * nin + f;
      if (split) {
        if (out0 != nullptr) out0[at] = o0;
        if (out1 != nullptr) out1[at] = o1;
      } else if (out0 != nullptr) {
        out0[at] = F::DX_FOLD ? o0 + o1 : o0;
      }
    }
  if constexpr (F::DX_RED) {
    if (red_part != nullptr) {  // lanes by a fixed butterfly, then warps in order
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        float v = red[j];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0) redw[warp][j] = v;
      }
      __syncthreads();
      const int S = F::slices(p);
      if (tid < S) {
        float sum = 0.f;
        for (int wv = 0; wv < THREADS / 32; ++wv) sum += redw[wv][tid];
        const long long blk = ((long long)grp * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
        red_part[blk * S + tid] = sum;
      }
    }
  }
}

template <class F, int NJ>
int launch_tc_dw_grouped(const float* x, long long ldx, typename F::Params p,
                         const float* gy, long long ldg, int vec, float* dw,
                         float* dw_part, int n, int groups, int nin, int nout, int splits,
                         cudaStream_t st) {
  constexpr int BN = 64 * NJ;
  const int nk = cdiv(n, tc::KT);
  const int per = cdiv(nk, min(splits, nk));
  splits = cdiv(nk, per);  // no split left empty
  if (splits > 1 && dw_part == nullptr) return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)cdiv(nin, tcg::FT) * groups;
  if (tiles > 65535 || splits > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (2 * F::SC * tc::KSTEPS * 256 + 3 * tc::KT * (BN + 4));
  int err = tc_attr(kan_tc_dw_grouped<F, NJ>, smem);
  if (err != 0) return err;
  kan_tc_dw_grouped<F, NJ><<<dim3(cdiv(nout, BN), (unsigned)tiles, splits), tcg::THREADS,
                             smem, st>>>(x, ldx, p, gy, ldg, splits > 1 ? dw_part : dw, n,
                                         groups, nin, nout, nk, per, vec);
  err = (int)cudaGetLastError();
  if (err != 0 || splits == 1) return err;
  return sum_splits(dw_part, dw, (long long)groups * F::slices(p) * nin * nout, splits, st);
}

// 16-byte copies of gy (n, groups nout) contiguous: its rows start on 16 bytes.
inline int tc_gy_vec(const float* gy, int groups, int nout) {
  return (long long)groups * nout % 4 == 0 && nout % 4 == 0 && (uintptr_t)gy % 16 == 0;
}

// The grouped dx kernel's grid: (feature tiles, row tiles, groups).
inline dim3 tc_dx_grid(int n, int groups, int nin) {
  return dim3(cdiv(nin, tcg::FT), cdiv(n, tcg::DX_BM), groups);
}

// kan_tc_dx_kernel over x (n, groups nin) with row stride ldx, gy (n, groups
// nout) contiguous and w (groups, S, nin, nout) contiguous, into out0 /
// out1 / red_part as the kernel says. wtsplit: scratch of groups ceil(nin /
// 16) ceil(nout / 16) 2 SC 8 32 words, 16-byte aligned.
template <class F>
int launch_tc_grouped_dx(const float* x, long long ldx, typename F::Params p,
                         const float* w, const float* gy, float* out0, float* out1,
                         int split, float* red_part, uint32_t* wtsplit, int n, int groups,
                         int nin, int nout, cudaStream_t st) {
  const int nk = cdiv(nout, tcg::DX_KS);
  const dim3 grid = tc_dx_grid(n, groups, nin);
  if (bad_shape(n, groups, nin, nout) || F::slices(p) <= 0 || F::slices(p) > F::SC ||
      wtsplit == nullptr || (uintptr_t)wtsplit % 16 != 0 || grid.y > 65535u ||
      grid.z > 65535u)
    return (int)cudaErrorInvalidValue;
  int err = tc_split<WtSource<F::SC>, tcg::DX_KS>(
      WtSource<F::SC>{w, F::slices(p), nin, nout, (int)grid.x, nk}, wtsplit,
      2 * F::SC * 8, (long long)groups * grid.x * nk, st);
  if (err != 0) return err;
  const size_t smem = sizeof(float) * 2 *
                      (tcg::DX_BM * tcg::DX_PITCH + 2 * F::SC * 8 * 2 * tcg::DX_KS);
  err = tc_attr(kan_tc_dx_kernel<F>, smem);
  if (err != 0) return err;
  kan_tc_dx_kernel<F><<<grid, tcg::THREADS, smem, st>>>(
      x, ldx, p, gy, (long long)groups * nout, wtsplit, out0, out1, split, red_part, n,
      groups, nin, nout, nk, tc_gy_vec(gy, groups, nout));
  return (int)cudaGetLastError();
}

// dW (groups, S, nin, nout) of a grouped layer, as launch_tc_grouped_dx's
// operands; scratch dw_part of splits groups S nin nout floats (splits > 1).
template <class F>
int launch_tc_grouped_dw(const float* x, long long ldx, typename F::Params p,
                         const float* gy, float* dw, float* dw_part, int n, int groups,
                         int nin, int nout, int splits, cudaStream_t st) {
  if (bad_shape(n, groups, nin, nout) || splits < 1 || F::slices(p) <= 0 ||
      F::slices(p) > F::SC)
    return (int)cudaErrorInvalidValue;
  const long long ldg = (long long)groups * nout;
  const int vec = tc_gy_vec(gy, groups, nout);
  if (nout <= 64)
    return launch_tc_dw_grouped<F, 1>(x, ldx, p, gy, ldg, vec, dw, dw_part, n, groups,
                                      nin, nout, splits, st);
  return launch_tc_dw_grouped<F, tcg::DW_WIDE>(x, ldx, p, gy, ldg, vec, dw, dw_part, n,
                                               groups, nin, nout, splits, st);
}

// ===========================================================================
// Part 3: the grouped q/k/v forward on the tensor cores.
//
// Replaces the CUDA-core kan_fwd_kernel for the grouped q/k/v projection's
// forward (kanvit/kernels/fused_basis.py::_fused_fwd_sg, pallas_call at
// :1240, reached from bspline_qkv_grouped :1361; _rbf_ln_sg_op, :3191, from
// fastkan_qkv_grouped; _sine_op_sg, :1518, from sinekan_qkv_grouped), and
// for the B-spline patch embedder's (_fused_fwd, :1067, from bspline_kan
// :3556) as its one-group case. For
// every group (head) g, x_g (n, nin) the columns of x that belong to it and
// W_g (S, nin, nout) packed:
//   y[n, g nout + o] = sum_(s,f) B_s(x_g[n, f]) W_g[s, f, o]
// C = A B per group: A the basis, rows x (slice, feature), generated on chip
// from x; B W_g in (slice, feature) order. Instantiated for B-spline in
// kan_basis.cu (the knots of group g at gridt + g gstride, so a refit grid a
// head is one more stride) and for Chebyshev there (T_0..T_4 of tanh x by
// the recurrence, S = 5; _cheby_op_sg, :1343, from cheby_qkv_grouped
// :1395), for Rbf (after the LayerNorm's statistics pass) and Sine in
// kan_rbf_sine.cu (one projection of 64 outputs a launch).
//
// What bounds it on the H100: the products. At the vit-s q/k/v (n 12,608,
// 6 heads of nin 64, nout 192, S 9) it is 16.73 GFLOP: 0.2497 ms in f32 at
// 67 TFLOP/s, 0.1014 in 3xTF32 at the dense 495 TFLOP/s; the bytes (x 19.4
// MB, y 58.1, W 2.65) take 0.024 ms. Beside the products: the basis, one
// Cox-de Boor pass for all 9 slices of each x value (the same basis set the
// pace of part 2's grouped dW), and the TF32 split of each value. One vit-s
// projection (64 outputs a head) is 5.58 GFLOP for RBF (S 9; 0.0338 ms in
// 3xTF32, 0.0832 in f32) and 2.48 for sine (S 4; 0.0150, 0.0370), 8 expf a
// value beside the products for RBF, 4 sinf for sine; the Chebyshev q|k|v
// 9.30 (S 5; 0.0563, 0.1387), one tanhf and three FMAs a value.
//
// kan_tc_fwd_grouped<F, NT>: a block holds 192 rows x 8 NT outputs of one
// group (NT 24: 192, a head's q|k|v; NT 8: 64 where nout <= 64, one
// projection; past 192 outputs the grid walks output tiles, the basis made
// again for each). 12 warps, each 16 rows x all the block's outputs (NT
// m16n8 tiles, 96 accumulators a thread at NT 24). A stage is 8 features x
// all SC slices, SC mma steps: step s is slice s of the 8 features. So a
// lane's A fragment in every step of a stage holds its own four x values
// (rows g, g + 8 of the warp's 16; features 2t, 2t + 1 of the stage's 8):
// the lane generates those values' SC basis values in registers (one
// Cox-de Boor pass for all 9, the family's values) and splits each once. No
// A tile in shared memory, and each x value's basis is made once a call (at
// nout <= 192). The knots of a stage's 8 features are staged after its
// barrier.
//
// B: W is split once a call by a pre-pass (kan_tc_fwd_split, 5.3 MB at
// vit-s) into each stage's layout, (step, column, fragment thread, 4
// words: big(2t), big(2t+1), small(2t), small(2t+1)), so a quarter-warp's
// 16-byte loads cover 32 banks. Every warp reads every column of a stage (a
// split at load would split each value once a warp); a stage lands by
// 16-byte cp.async one stage ahead into one of two buffers, 2 SC 8 NT 64
// bytes: 216 KB at NT 24, 72 KB at NT 8.
//
// Why 12 warps of 16 rows (kanvit_torch/probe_qkv_fwd.py, the H100 80GB
// HBM3 at 700 W): the 96 accumulators and 36 basis values a thread leave
// too few registers for the products' chains to overlap, and 8 warps an SM
// could not hide them: 0.60 ms at vit-s. 12 warps at 168 registers (the
// most 384 threads may hold, some spilled) take 0.47, and 12,608 rows in
// blocks of 192 are 396 blocks, three full waves. 64-output tiles made the
// basis three times and ran 0.51; the 4 nonzero cubic bases of each x
// alone (local support, the same Cox-de Boor expressions) ran no faster,
// so the family's values stay.
//
// At 64 outputs a block the shape is the family's, template parameters of
// the launch (warps a block, blocks an SM): probe_qkv_fwd.py timed them at
// one vit-s projection. RBF keeps 12 warps, one block an SM (0.1997 ms with
// its statistics; 8 warps at two blocks 0.2125; two m16 row tiles a warp,
// whose B fragments feed two products, 0.2365 at 255 registers and
// spilling). Sine, 4 slices a stage and 80 registers, takes 8 warps at
// three blocks an SM (0.1084 against 0.1242 at 12 warps, one block; 24
// warps an SM against 12): 594 blocks of 128 rows, 1.5 waves of 396.
// Chebyshev takes that 64-output shape at every width (NARROW; 8 warps,
// three blocks an SM, 80 registers, no spills): 0.2070 ms at the vit-s
// q|k|v on the H100 80GB HBM3 at 700 W (probe_qkv_fwd.py --cheby) against
// 0.2452 for 192-output blocks of 12 warps (168 registers;
// 8 warps 0.3036 at 255, spilling), though it makes each value's basis
// three times, once an output tile: its basis is cheap, and 24 warps an SM
// hide the products' chains that 12 could not.
//
// Arithmetic: 3xTF32 mma.sync.m16n8k8 (Op), each 8-deep step into a zeroed
// accumulator added in f32, one running sum over the nin / 8 x SC steps
// (72 at vit-s, 576 entries deep): within twice the plain f32 version's
// distance from f64 (tests/test_torch_port_qkv_tc_fwd_cheby.py,
// tests/test_torch_port_qkv_tc_fwd_rbf_sine.py, and on the card
// chip_smoke.py). A family may keep a slice of large values apart
// (TcFwdRow's SPLIT and EXACT: Rbf's silu slice). A launch may sum in two
// levels (FLUSH stages a level, the running sum added into y; the loads of
// 8 n8 tiles' y issued together): the B-spline embedder, 96 stages of 9
// steps at vit-s, 6,912 entries deep, whose one running sum lands past
// twice the plain f32 version's distance from f64 on the CPU
// (tests/test_torch_port_tc_embedder_bspline.py), flushes every 12 stages
// (864 entries, part 1's 896). At vit-s (12,544 rows, 768 -> 384, 66.6
// GFLOP: 0.4036 ms in 3xTF32, 0.9939 in f32) it takes 192-output blocks of
// 12 warps, 66 x 2 = 132 blocks, one wave (kanvit_torch/probe_embedder_rbf.py
// --bspline timed 128- and 64-output blocks, 8 and 12 warps, one to three
// blocks an SM: PERF.md). Below one wave (one vit-s image: 4 blocks of 96
// stages, 1.70 ms against the CUDA-core kernel's 0.75 on the H100 80GB HBM3
// at 700 W) each level runs in blocks of its own into a partial, and
// sum_splits adds them in level order: the same sum, so a row's bits do
// not depend on the batch (the wrapper's tc_fwd_splits). The FastKAN
// embedder (_rbf_ln_base_op, :2947, from fastkan :3600; _rbf_base_op, :2726,
// without its LayerNorm) sums in the same two levels of 12 stages, its
// silu slice in the second running sum, in the RBF q/k/v's 64-output shape
// (12 warps, one block an SM): 396 blocks, three waves, 1.9343 ms at vit-s
// against the CUDA-core kernel's 3.3407 (statistics pass included: 1.9552)
// on the H100 80GB HBM3 at 700 W. probe_embedder_rbf.py --fastkan timed 8
// warps at two blocks an SM 2.1268, three 2.9733, 128-output tiles 2.4277
// (12 warps) and 2.9106 (8); 192-output tiles cannot hold two stages of
// its 10 steps. One running sum ran 1.8436 ms and landed 4.0e-7 from f64
// (levels of 12: 1.8e-7; the plain f32 version 1.3e-6), but an image alone
// would then run 12 blocks through all 96 stages; below one wave the levels
// split as B-spline's (one vit-s image: 0.1025 ms device against the
// CUDA-core kernel's 0.5541). The Chebyshev embedder (_cheby_op, :3491,
// from chebykan :3779) takes the Chebyshev q/k/v's 64-output tiles at 12
// warps, one block an SM, its sum in two levels of 24 stages (kan_basis.cu's
// CHEBY_EMB_*): 0.8083 ms at vit-s against the CUDA-core kernel's 1.9360,
// 2.6e-7 from f64 against the plain f32 version's 8.3e-7 (probe_embedder_rbf.py
// --cheby, the H100 80GB HBM3 at 700 W); an image's 4 levels split below
// one wave.
//
// bf16 (kanvit's bf16 serving; the B-spline embedder and q/k/v, entry
// kanvit_bspline_tc_fwd_bf16, the Chebyshev ones, entry
// kanvit_cheby_tc_fwd_bf16 at kan_basis.cu's CHEBY_BF16_* shape, and the
// FastKAN ones after the LayerNorm's statistics, entry
// kanvit_fastkan_tc_fwd_bf16 at kan_rbf_sine.cu's RBF_BF16_* shape, the
// silu slice in the one running sum): Op = Bf16, x, W and y bf16, one
// mma.sync.m16n8k16 a step of two slices (Bf16 above), the basis made in
// f32 and rounded to bf16 at the dot, one f32 running sum (no levels: a
// bf16 y would round between them), y rounded once. At vit-s: the embedder
// 0.5495 ms, the q|k|v 0.2025, against the f32 kernels' 1.8063 and 0.4762
// on the same operands (PERF.md, the H100 80GB HBM3 at 700 W); their
// bounds are the products at 989 TFLOP/s bf16, 0.0673 and 0.0169 ms. What
// issues beside the HMMA bounds them: 120 HMMA of the 2,800 instructions
// at 192 outputs, led by the basis's FMUL, FFMA and ISETP and the F2FP
// that packs its bf16 pairs (chip_smoke.py's SASS report). The Fourier
// embedder (entry kanvit_fourierkan_tc_fwd_bf16; 1,344 stages of two steps
// at vit-s, its basis a rotation a harmonic) took 2.00 ms against its
// 0.42 bound: each of the 12 warps reads the stage's whole W from shared
// memory, 144 KB a stage at 128 bytes a cycle against 576 cycles of HMMA
// (PERF.md).
//
// Edge semantics as kan_fwd_kernel's: the family's values (B-spline: x on a
// knot starts the next interval, x outside every span has zero spline
// bases). Ragged rows, features (nin not a multiple of 8) and outputs are
// zero in A and the split W and never stored. No atomics, no row splits: a
// second forward gives the same bits.
// ===========================================================================

namespace tcf {
constexpr int WARPS = 12;  // warps a block at the route's shape
constexpr int FS = 8;      // features a stage: one mma step a slice
}  // namespace tcf

// What kan_tc_fwd_grouped holds of each of a lane's rows for the whole
// stage loop, and the family's values from it (of slice chunk c): by
// default nothing, and F::values. A family specialises it where a value
// reads something of its row (Rbf: the row's LayerNorm statistics, loaded
// once a lane instead of once a value). `row` is always a row of x: the
// kernel clamps the ragged edge's rows to the last one, and zeroes their
// values itself.
//
// A family whose values follow from the last chunk's (the bf16 Fourier
// family's recurrence) keeps that state in its Row too and takes it by
// reference: the kernel makes each lane's values stage after stage in order,
// chunk 0 of a stage's 8 features first.
//
// SPLIT and EXACT shape the sum for a family with one slice of values far
// larger than the rest (Rbf's silu(x) of the raw x, up to |x|, beside RBF
// bases <= 1): the slices from SPLIT on go into a second running sum, added
// to the first after the last stage, so the large values' rounding is not
// carried through every later step of the small ones; and slice EXACT's
// products are exact but for ~2^-33 of a product: both operands in three
// TF32 words (big, small and the ~2-bit remainder), six products. By
// default one running sum and no exact slice.
template <class F>
struct TcFwdRow {
  static constexpr int SPLIT = F::SC;
  static constexpr int EXACT = -1;
  struct Row {};
  __device__ __forceinline__ static Row load(const typename F::Params&, int, long long) {
    return {};
  }
  template <int NF>
  __device__ __forceinline__ static void values(const typename F::Params& p,
                                                const typename F::template Stage<NF>& st,
                                                const Elem& e, const Row&, int c,
                                                float (&v)[F::SC]) {
    F::template values<NF>(p, st, e, c, v);
  }
};

// The remainder of x past its split_round words: exact in f32, and ~2 bits
// wide, so exact in TF32 too.
__device__ __forceinline__ float tf32_rest(float x) {
  const float d = x - __uint_as_float(tf32_round(x));
  return d - __uint_as_float(tf32_round(d));
}

// W (groups, S, nin, nout) split into kan_tc_fwd_grouped's stages: stage kt
// of output tile ot of group g holds steps s = 0 .. SC - 1 (slice s, zero
// past S) of features 8 kt .. 8 kt + 7 by the tile's bn columns, the word
// group of (s, column c, fragment thread t) at ((s bn + c) 4 + t) 4, and
// with an exact slice (EXACT >= 0) one more step s = SC holding the
// remainders of slice EXACT's words (tf32_rest, as big words; zero small
// ones); stages in order (g, ot, kt). One unit a word group. Op Bf16: W
// bf16, ceil(SC / 2) steps of two slices, a word group of 2 words at
// ((s bn + c) 4 + t) 2: the bf16 pairs (slice 2s, features 2t, 2t + 1) and
// (slice 2s + 1, the same), zero past S. A weight of `chunks` chunks of SC
// slices (S > SC: the bf16 sine and Fourier embedders') walks them inside
// each 8 features: stage kt is features 8 (kt / chunks) .., slices SC (kt %
// chunks) .. of the chunk walk, each read where F::wslice stores it.
template <class F, int EXACT, class Op = Tf32x3>
__global__ void __launch_bounds__(256)
kan_tc_fwd_split(const typename Op::In* __restrict__ w, uint32_t* __restrict__ out,
                 int slices, int chunks, int nin, int nout, int bn, int otiles, int nk,
                 long long units) {
  constexpr int SC = F::SC;
  constexpr int STEPS = (SC + Op::SPS - 1) / Op::SPS + (EXACT >= 0);
  for (long long u = blockIdx.x * 256LL + threadIdx.x; u < units;
       u += (long long)gridDim.x * 256) {
    const int t = (int)(u & 3);
    long long r = u >> 2;
    const int col = (int)(r % bn);
    r /= bn;
    const int step = (int)(r % STEPS), s = step < SC ? step : EXACT;
    r /= STEPS;
    const int kt = (int)(r % nk), s0 = kt % chunks * SC;
    r /= nk;
    const int o = (int)(r % otiles) * bn + col, f = tcf::FS * (kt / chunks) + 2 * t;
    const long long g = r / otiles;
    if constexpr (Op::SPS == 2) {
      static_assert(EXACT < 0, "the bf16 forward has no exact slice");
      uint32_t word[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int sl = s0 + 2 * step + h;
        uint32_t lo = 0u, hi = 0u;
        if (2 * step + h < SC && sl < slices && o < nout) {
          const unsigned short* wr =
              reinterpret_cast<const unsigned short*>(w) +
              ((g * slices + F::wslice(slices, sl)) * nin + f) * (long long)nout + o;
          if (f < nin) lo = wr[0];
          if (f + 1 < nin) hi = wr[nout];
        }
        word[h] = lo | (hi << 16);
      }
      *reinterpret_cast<uint2*>(out + 2 * u) = make_uint2(word[0], word[1]);
    } else {
      float b[2] = {0.f, 0.f};
      if (s0 + s < slices && o < nout) {
        const float* wr =
            w + ((g * slices + F::wslice(slices, s0 + s)) * nin + f) * (long long)nout + o;
        if (f < nin) b[0] = wr[0];
        if (f + 1 < nin) b[1] = wr[nout];
      }
      if (step >= SC) {
        b[0] = tf32_rest(b[0]);
        b[1] = tf32_rest(b[1]);
      }
      store_b(out + 4 * u, b[0], b[1]);
    }
  }
}

// y of one group's 16 WARPS rows x 8 NT outputs: grid (row tiles, groups,
// output tiles x splits); wsplit from kan_tc_fwd_split, nk = ceil(nin / 8)
// F::chunks(p) stages (a family's slices past its tile's SC in chunks of
// SC, walked inside each 8 features). MINB blocks an SM bound the
// registers. FLUSH > 0: the sum in two levels, the running sum of every
// FLUSH stages added into y (stored the first time) and restarted; 0: one
// running sum, y stored once. With splits > 1 (FLUSH > 0 only) block z /
// output tiles runs that one level and stores it into its slab of part,
// which sum_splits adds into y in level order: the same sum, so the same
// bits. Op: the operand type, x and
// y of its In and Out types (Bf16: one running sum, FLUSH 0, and no slice
// apart or exact, whatever the family's TcFwdRow asks of 3xTF32: Rbf's silu
// slice sums with the rest, as in kanvit's one bf16 dot).
template <class F, int NT, int WARPS = tcf::WARPS, int MINB = 1, class Op = Tf32x3,
          int FLUSH = 0>
__global__ void __launch_bounds__(32 * WARPS, MINB)
kan_tc_fwd_grouped(const typename Op::In* __restrict__ x, long long ldx,
                   typename F::Params p, const uint32_t* __restrict__ wsplit,
                   typename Op::Out* __restrict__ y, float* __restrict__ part, int splits,
                   int n, int groups, int nin, int nout, int nk) {
  using R = TcFwdRow<F>;
  using Out = typename Op::Out;
  constexpr int SC = F::SC, BN = 8 * NT, FS = tcf::FS, THREADS = 32 * WARPS;
  constexpr int SPS = Op::SPS;
  // bf16: one running sum, as kanvit's one dot, whatever the family's SPLIT
  // and EXACT (a bf16 x bf16 product is exact in f32)
  constexpr int SPLIT = SPS == 1 ? R::SPLIT : SC, EXACT = SPS == 1 ? R::EXACT : -1;
  constexpr int SUMS = SPLIT < SC ? 2 : 1;
  constexpr int STEPS = (SC + SPS - 1) / SPS + (EXACT >= 0);
  static_assert(SPS == 1 || FLUSH == 0, "bf16: one running sum, no levels");
  constexpr int STAGE = STEPS * BN * 4 * Op::UNIT;  // words of a stage's split W
  extern __shared__ __align__(16) float sm[];
  __shared__ typename F::template Stage<FS> st;
  uint32_t* wbuf = reinterpret_cast<uint32_t*>(sm);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t = lane & 3;
  const bool split = FLUSH > 0 && splits > 1;
  const int otiles = gridDim.z / splits, ot = blockIdx.z % otiles, sp = blockIdx.z / otiles;
  const int grp = blockIdx.y, o0 = ot * BN;
  const int kt0 = split ? sp * FLUSH : 0, kt1 = split ? min(nk, kt0 + FLUSH) : nk;
  const long long r0 = ((long long)blockIdx.x * WARPS + warp) * 16;  // the warp's rows
  const uint32_t* wg = wsplit + ((long long)grp * otiles + ot) * nk * STAGE;
  const typename Op::In* xg = x + (long long)grp * nin;
  const int CH = F::chunks(p);  // stage kt: features FS (kt / CH) .., slice chunk kt % CH

  // stage kt's split W into buffer kt & 1, by cp.async
  auto load_w = [&](int kt) {
    const uint32_t* src = wg + (long long)kt * STAGE;
    uint32_t* dst = wbuf + (kt & 1) * STAGE;
#pragma unroll 4
    for (int e = 4 * tid; e < STAGE; e += 4 * THREADS)
      cp_async16(reinterpret_cast<float*>(dst + e), reinterpret_cast<const float*>(src + e),
                 true);
    cp_async_commit();
  };
  // This lane's row h: r0 + g8 + 8 h (value q reads row h = q & 1, the A
  // fragment's register order).
  auto row_of = [&](int h) { return r0 + g8 + 8 * h; };
  typename R::Row rows[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) rows[h] = R::load(p, grp, min(row_of(h), (long long)n - 1));
  // Value q of a stage: row row_of(q & 1), feature 8 (kt / CH) + 2t + (q >> 1).
  float xv[4];
  auto load_x = [&](int kt) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long row = row_of(q & 1);
      const int f = FS * (kt / CH) + 2 * t + (q >> 1);
      xv[q] = row < n && f < nin ? Op::in(xg[row * ldx + f]) : 0.f;
    }
  };
  // The basis of this lane's values of stage kt (from xv, its rows and the
  // staged stage), 0 outside.
  auto make = [&](int kt, float (&v)[4][SC]) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long row = row_of(q & 1);
      const int kf = 2 * t + (q >> 1), f = FS * (kt / CH) + kf;
      const bool live = row < n && f < nin;
      float b[SC];
      R::template values<FS>(
          p, st, Elem{xv[q], kf, min(f, nin - 1), grp, min(row, (long long)n - 1)},
          rows[q & 1], kt % CH, b);
#pragma unroll
      for (int s = 0; s < SC; ++s) v[q][s] = live ? b[s] : 0.f;
    }
  };
  float acc[SUMS][NT][4];  // running sums: slices below SPLIT, and from it
#pragma unroll
  for (int a = 0; a < SUMS; ++a)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][j][e] = 0.f;
  const long long ldy = (long long)groups * nout;
  Out* yg = (split ? reinterpret_cast<Out*>(part + (long long)sp * n * ldy) : y) +
            (long long)grp * nout;
  // The running sums (the second added into the first) into y, stored or
  // added to y's value (the loads of CH n8 tiles' values issued together);
  // then restarted.
  auto flush = [&](bool first) {
    if (SUMS == 2)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[0][j][e] += acc[SUMS - 1][j][e];
    constexpr int CH = NT % 8 == 0 ? 8 : NT;
#pragma unroll
    for (int j0 = 0; j0 < NT; j0 += CH) {
      float old[CH][4];
#pragma unroll
      for (int j = 0; j < CH; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const long long row = row_of(e >> 1);
          const int col = o0 + 8 * (j0 + j) + 2 * t + (e & 1);
          old[j][e] = !first && row < n && col < nout ? Op::in(yg[row * ldy + col]) : 0.f;
        }
#pragma unroll
      for (int j = 0; j < CH; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const long long row = row_of(e >> 1);
          const int col = o0 + 8 * (j0 + j) + 2 * t + (e & 1);
          if (row < n && col < nout)
            yg[row * ldy + col] =
                Op::out(first ? acc[0][j0 + j][e] : old[j][e] + acc[0][j0 + j][e]);
#pragma unroll
          for (int a = 0; a < SUMS; ++a) acc[a][j0 + j][e] = 0.f;
        }
    }
  };

  load_w(kt0);
  load_x(kt0);
  for (int kt = kt0; kt < kt1; ++kt) {
    cp_async_wait<0>();
    __syncthreads();  // stage kt's W landed; every warp is past stage kt - 1
    F::template stage<FS>(p, nin, FS * (kt / CH), grp, st);
    if (kt + 1 < kt1) load_w(kt + 1);
    float v[4][SC];
    make(kt, v);
    if (kt + 1 < kt1) load_x(kt + 1);
    const uint32_t* ws = wbuf + (kt & 1) * STAGE + Op::UNIT * (4 * g8 + t);
    if constexpr (SPS == 2) {
#pragma unroll
      for (int s = 0; s < SC; s += 2) {
        const typename Op::A a = Op::pair(v, s);
#pragma unroll
        for (int j = 0; j < NT; ++j)
          Op::mma(acc[0][j], a, Op::load_b(ws + ((s / 2) * BN + 8 * j) * 4 * Op::UNIT));
      }
    } else {
#pragma unroll
      for (int s = 0; s < SC; ++s) {
        const float a4[4] = {v[0][s], v[1][s], v[2][s], v[3][s]};
        const typename Op::A a = Op::frag(a4);
        uint32_t rest[4];  // slice EXACT: the values' remainders
        if (s == EXACT)
#pragma unroll
          for (int q = 0; q < 4; ++q) rest[q] = __float_as_uint(tf32_rest(a4[q]));
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const typename Op::B b = Op::load_b(ws + (s * BN + 8 * j) * 16);
          if (s == EXACT) {
            const typename Op::B rb = Op::load_b(ws + (SC * BN + 8 * j) * 16);
            Op::mma_exact(acc[s >= SPLIT][j], a, rest, b, rb.big);
          } else {
            Op::mma(acc[s >= SPLIT][j], a, b);
          }
        }
      }
    }
    if constexpr (FLUSH > 0) {
      if ((kt + 1) % FLUSH == 0 && kt + 1 < kt1) flush(kt + 1 == FLUSH);
    }
  }
  flush(FLUSH == 0 || kt1 - kt0 <= FLUSH);
}

// The pre-pass and kan_tc_fwd_grouped<F, NT, WARPS, MINB, Op, FLUSH> over
// the operands of launch_tc_grouped_fwd, and with splits > 1 the sum of the
// levels; cudaErrorInvalidValue when wsplit's wwords words cannot hold the
// split W, or splits is neither 1 nor the levels (FLUSH > 0) with part.
template <class F, int NT, int WARPS = tcf::WARPS, int MINB = 1, int FLUSH = 0,
          class Op = Tf32x3>
int launch_tc_fwd_grouped(const typename Op::In* x, long long ldx, typename F::Params p,
                          const typename Op::In* w, typename Op::Out* y, uint32_t* wsplit,
                          long long wwords, int n, int groups, int nin, int nout,
                          cudaStream_t st, float* part = nullptr, int splits = 1) {
  constexpr int BN = 8 * NT, EXACT = Op::SPS == 1 ? TcFwdRow<F>::EXACT : -1;
  constexpr int STEPS = (F::SC + Op::SPS - 1) / Op::SPS + (EXACT >= 0);
  const int nk = cdiv(nin, tcf::FS) * F::chunks(p), otiles = cdiv(nout, BN);
  const long long units = (long long)groups * otiles * nk * STEPS * BN * 4;
  if (groups > 65535 || (long long)otiles * splits > 65535 || Op::UNIT * units > wwords ||
      (splits != 1 && (FLUSH == 0 || part == nullptr || splits != cdiv(nk, FLUSH))))
    return (int)cudaErrorInvalidValue;
  const long long want = (units + 255) / 256;
  kan_tc_fwd_split<F, EXACT, Op>
      <<<(unsigned)(want < 132 * 16 ? want : 132 * 16), 256, 0, st>>>(
          w, wsplit, F::slices(p), F::chunks(p), nin, nout, BN, otiles, nk, units);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const size_t smem = sizeof(uint32_t) * 2 * STEPS * BN * 4 * Op::UNIT;
  err = tc_attr(kan_tc_fwd_grouped<F, NT, WARPS, MINB, Op, FLUSH>, smem);
  if (err != 0) return err;
  kan_tc_fwd_grouped<F, NT, WARPS, MINB, Op, FLUSH>
      <<<dim3((unsigned)cdiv(n, 16 * WARPS), groups, otiles * splits), 32 * WARPS, smem,
          st>>>(x, ldx, p, wsplit, y, part, splits, n, groups, nin, nout, nk);
  err = (int)cudaGetLastError();
  if constexpr (FLUSH > 0) {
    if (err == 0 && splits > 1)
      return sum_splits(part, y, (long long)n * groups * nout, splits, st);
  }
  return err;
}

// y (n, groups nout) of a grouped layer: x (n, groups nin) with row stride
// ldx and unit column stride, w (groups, S, nin, nout) contiguous with S =
// F::slices(p) <= F::SC F::chunks(p), y contiguous; wsplit: scratch of
// wwords >= groups ceil(nout / BN) ceil(nin / 8) chunks STEPS BN 16 words
// (STEPS = SC, one more with an exact slice; not S: the pre-pass writes
// zeros past S; BN 64 where nout <= 64 or with NARROW, else 192), 16-byte
// aligned, else cudaErrorInvalidValue. Up to 64 outputs (one projection), and with
// NARROW at every width, the family's shape: 64 outputs a block, WARPS8
// warps, MINB8 blocks an SM; past them 12 warps, 192 outputs a block.
// FLUSH: the kernel's stages a level of a two-level sum (0: one level);
// with it, splits > 1 runs each level in blocks of its own (as many splits
// as levels) into part, splits n groups nout floats, summed in level order.
// Op: the operand type (Tf32x3, or Bf16: x, w and y bf16, FLUSH 0; the
// scratch then ceil(SC / 2) BN 8 words a stage, no exact slice).
template <class F, int WARPS8 = tcf::WARPS, int MINB8 = 1, bool NARROW = false,
          int FLUSH = 0, class Op = Tf32x3>
int launch_tc_grouped_fwd(const typename Op::In* x, long long ldx, typename F::Params p,
                          const typename Op::In* w, typename Op::Out* y, uint32_t* wsplit,
                          long long wwords, int n, int groups, int nin, int nout,
                          cudaStream_t st, float* part = nullptr, int splits = 1) {
  if (bad_shape(n, groups, nin, nout) || F::slices(p) <= 0 ||
      F::slices(p) > F::SC * F::chunks(p) || wsplit == nullptr ||
      (uintptr_t)wsplit % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if constexpr (!NARROW) {
    if (nout > 64)
      return launch_tc_fwd_grouped<F, 24, tcf::WARPS, 1, FLUSH, Op>(
          x, ldx, p, w, y, wsplit, wwords, n, groups, nin, nout, st, part, splits);
  }
  return launch_tc_fwd_grouped<F, 8, WARPS8, MINB8, FLUSH, Op>(
      x, ldx, p, w, y, wsplit, wwords, n, groups, nin, nout, st, part, splits);
}


// ===========================================================================
// Part 4: the bf16 backward of a grouped KAN layer (kanvit's bf16 training
// policy).
//
// Replaces, on bf16 operands, the TPU kernels that part 2 replaces in f32:
// kanvit/kernels/fused_basis.py::_fused_bwd_sg (pallas_call at :1278, the
// grouped q/k/v's backward, from _bspline_op_sg_bwd :1330 and
// _cheby_op_sg_bwd :1351) and _fused_bwd (:1159, the patch embedder's, from
// _bspline_op's VJP :2624 and _cheby_op_bwd :3499) as its one-group case;
// and the FastKAN backwards, _rbf_ln_sg_op's (:3246) and _rbf_ln_base_op's
// (:2995), with the LayerNorm passes of kan_rbf_sine.cu; and the sine
// backwards, _sine_op_sg's (:1557, _bwd_kernel_sine_sg :1447) and the
// embedder's (_fused_bwd_sine_plain :1728, _fused_bwd_kb :2523 with
// _dw_kernel_kb_sine :2104), dfreq from the dx kernel's fold; and the
// Fourier embedder's (_fused_bwd_kb :2492 dx with _dx_kernel_kbf, :2564 dW
// with _dw_kernel_kbf; _fused_bwd :1159 below that tier). Their body,
// _bwd_kernel (:566-625; _rbf_ln_bwd_kernel :2861 and its _sg form :3079
// for FastKAN), keeps this policy on bf16 inputs, which the kernels below
// follow:
//   x upcast to f32, the basis B and its derivative B' made in f32;
//   gW = gy W^T with bf16 operands and f32 accumulation, never rounded;
//   dx = sum_s gW_s B'_s summed in f32, rounded to bf16 once;
//   dW = bf16(B)^T gy summed in f32 over ALL the rows, rounded to bf16 once.
// Every product is bf16 mma.sync.m16n8k16 with f32 accumulation
// (attention_tc.cuh). The product of two bf16 values is exact in f32, so
// the only roundings are the policy's and those of the f32 sums.
//
// dW (kan_bf16_dw<F, NJ>): part 2's dW tiling and pipeline -- 16 features
// of one group x all F::SC slices x 64 NJ outputs a block, 8 warps side by
// side along the outputs, SC x NJ m16n8 tiles a warp, 32-row stages (here
// two 16-deep steps), the basis of stage kt + 1 made while stage kt's
// products run, gy landing raw by cp.async two stages ahead, the rows cut
// into splits (tc_grouped_dw_splits). Each thread makes two rows' values of
// one feature (rows 2t, 2t + 1 of a step, feature g or g + 8), so it writes
// whole words of the A fragments, and a warp reads its fragment of a slice
// as one 16-byte load. gy's B fragments (rows 2t, 2t + 1 of the step,
// output column g) come by ldmatrix.trans from the raw tile, whose pitch of
// BN + 8 bf16 puts ldmatrix's eight 16-byte rows on distinct banks. Every
// split, one split too, writes an f32 partial (inside a split the running
// sum is added into it every tc::FLUSH stages); sum_splits_bf16_kernel adds
// the partials in split order and rounds once: the f32 sum over all the
// rows rounded once is kanvit's dW, where rounding each split's partial to
// bf16 before the sum would be another function.
//
// dx (kan_bf16_dx<F>): part 2's dx tiling -- 128 rows x 16 features of one
// group, all SC slices, warp (row group, half) holding 32 rows x the 8
// features of its half x SC slices -- over 16-output stages of raw gy and
// raw W, double buffered by cp.async. A (slice, feature) row of W holds a
// stage's 16 outputs side by side, which is a B fragment's pair order, so W
// needs no pre-pass. The epilogue makes B'_s(x) in f32 and sums gW_s B'_s
// in slice order, each product rounded and added as kanvit's dx += gW_s
// B'_s, then rounds dx to bf16 once; gW never leaves the registers. A
// DX_FOLD family takes part 2's fold instead (Rbf: dln = sum_k gW_k (-2u_k /
// h) b_k and the silu term gW_8 silu'(x), each left in f32 for the
// LayerNorm's VJP, which couples a segment's features, and for dgamma and
// dbeta; kanvit keeps both in f32 too, rounding only dx; Sine: dx =
// sum_s gW_s (freq_s cos a_s) in slice order, and dfreq's terms gW_s x cos
// a_s summed over the block's rows a feature, for a second pass that sums
// the row tiles and then the features; the dx kernel runs without dx for
// them, as dfreq needs gW).
//
// What bounds it at vit-s: the products. The q/k/v (n 12,608, 6 heads of
// nin 64, nout 192): dW and dx 16.73 GFLOP each, 0.034 ms together at the
// dense 989 TFLOP/s of bf16; the embedder's no-dx dW (12,544 x 6,912 x
// 384) 66.6 GFLOP, 0.067 ms. Beside the products, each stage makes its
// basis in f32 (one Cox-de Boor pass for all 9 values of an x value), the
// work that bounds part 2's f32 dW; this first version keeps part 2's shape.
// The sine embedder (28 slices, 207 GFLOP a product, 0.42 ms for both at
// the bf16 rate) makes 270 M sinf for dW per output tile and 270 M cosf in
// dx's fold: its dW took 3.93 ms and its dx (for dfreq) 2.66 at vit-s on
// the H100 80GB HBM3 at 700 W (PERF.md), each chunk of dx restaging gy.
// ===========================================================================

namespace tcb {
constexpr int THREADS = 256;     // 8 warps
constexpr int FT = 16;           // features a block
constexpr int KT = 32;           // rows a dW stage: two 16-deep steps
constexpr int DX_BM = 128;       // rows a dx block
constexpr int DX_KS = 16;        // outputs a dx stage: one 16-deep step
constexpr int DX_P = DX_KS + 8;  // pitch of dx's staged gy and W rows, bf16
}  // namespace tcb

// dW of one group's 16 features x one chunk of SC slices x 64 NJ outputs
// over the rows of one split, into split z's f32 partial at part + z groups
// S nin nout (S = F::slices(p) <= SC chunks; slices past S never stored):
// grid (npad / 64 NJ, feature tiles x chunks x groups, splits). x (n,
// groups nin) bf16 with row stride ldx; gy (n, ldg) bf16, group g's columns
// at g nout; vec: 16-byte copies of gy (ldg and nout multiples of 8, gy on
// 16 bytes).
// Blocks an SM the bf16 dW kernel is built for: part 2's, and two at NJ 3
// for a tile of at most 4 slices (the sine embedder's, 48 accumulators a
// thread): at vit-s its dW took 3.93 ms at 128 registers (a few spilled)
// against 6.47 at one block an SM (probe_bf16.py --model-type sine, the H100
// 80GB HBM3 at 700 W), the sinf of its basis stalling 8 warps an SM.
template <int SC, int NJ>
constexpr int bf16_dw_blocks() {
  return NJ > 1 && SC <= 4 ? 2 : tc_dw_blocks<SC, NJ>();
}

template <class F, int NJ>
__global__ void __launch_bounds__(tcb::THREADS, (bf16_dw_blocks<F::SC, NJ>()))
kan_bf16_dw(const __nv_bfloat16* __restrict__ x, long long ldx, typename F::Params p,
            const __nv_bfloat16* __restrict__ gy, long long ldg, float* __restrict__ part,
            int n, int groups, int nin, int nout, int nk, int stages_per_split, int vec) {
  using bf = __nv_bfloat16;
  constexpr int THREADS = tcb::THREADS, SC = F::SC, KT = tcb::KT;
  constexpr int BN = 64 * NJ;
  constexpr int A_WORDS = SC * 2 * 128;  // a stage's A fragments: SC slices x 2 steps
  constexpr int RAW_P = BN + 8;          // raw gy's pitch, bf16
  constexpr int RAW = KT * RAW_P;        // a stage's raw gy, bf16
  extern __shared__ __align__(16) uint32_t smb[];
  __shared__ typename F::template Stage<tcb::FT> st;
  uint32_t* stages = smb;                                   // 2 x A_WORDS
  bf* raw = reinterpret_cast<bf*>(smb + 2 * A_WORDS);       // 3 x RAW
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t = lane & 3;
  const int ftn = cdiv(nin, tcb::FT), CH = F::chunks(p);
  const int o0 = blockIdx.x * BN, grp = blockIdx.y / (ftn * CH);
  const int c = blockIdx.y / ftn % CH, s0 = c * SC;  // the block's slices s0 ..
  const int f0 = blockIdx.y % ftn * tcb::FT;
  const int kt0 = blockIdx.z * stages_per_split;
  const int kt1 = min(nk, kt0 + stages_per_split);
  const int S = F::slices(p);
  const bf* gyg = gy + (long long)grp * nout + o0;
  F::template stage<tcb::FT>(p, nin, f0, grp, st);

  // gy of stage kt (32 rows x BN outputs) into raw buffer buf
  auto load_gy = [&](int kt, int buf) {
    bf* r = raw + buf * RAW;
    if (vec) {
#pragma unroll
      for (int i = 0; i < KT * BN / 8 / THREADS; ++i) {
        const int e = tid + i * THREADS, k = e / (BN / 8), c = e % (BN / 8) * 8;
        const long long row = (long long)kt * KT + k;
        const bool in = row < n && o0 + c < nout;
        cp_async16(reinterpret_cast<float*>(r + k * RAW_P + c),
                   reinterpret_cast<const float*>(in ? gyg + row * ldg + c : gyg), in);
      }
    } else {
      for (int e = tid; e < KT * BN; e += THREADS) {
        const int k = e / BN, c = e % BN;
        const long long row = (long long)kt * KT + k;
        r[k * RAW_P + c] =
            row < n && o0 + c < nout ? gyg[row * ldg + c] : __float2bfloat16_rn(0.f);
      }
    }
  };

  // This thread's x values a stage: rows rr and rr + 1 of feature f0 + kf,
  // word wq of lane l's A fragment of step ks (m = kf, k = rr - 16 ks).
  const int ks = tid >> 7, l = (tid >> 2) & 31, wq = tid & 3;
  const int kf = (l >> 2) + 8 * (wq & 1), fx = f0 + kf;
  const int rr = 16 * ks + 2 * (l & 3) + 8 * (wq >> 1);
  const bf* xg = x + (long long)grp * nin + fx;
  float xa, xb;  // x of the next stage to make
  auto load_x = [&](int kt) {
    const long long row = (long long)kt * KT + rr;
    const bool live = kt < kt1 && fx < nin;
    xa = live && row < n ? __bfloat162float(xg[row * ldx]) : 0.f;
    xb = live && row + 1 < n ? __bfloat162float(xg[(row + 1) * ldx]) : 0.f;
  };
  // Stage kt's A into buffer buf: each slice's values of the two rows, as
  // one bf16 pair.
  auto make = [&](int kt, int buf) {
    uint32_t* as = stages + buf * A_WORDS;
    const long long row = (long long)kt * KT + rr;
    float va[SC], vb[SC];
#pragma unroll
    for (int s = 0; s < SC; ++s) va[s] = vb[s] = 0.f;
    if (fx < nin && row < n) F::template values<tcb::FT>(p, st, Elem{xa, kf, fx, grp, row}, c, va);
    if (fx < nin && row + 1 < n)
      F::template values<tcb::FT>(p, st, Elem{xb, kf, fx, grp, row + 1}, c, vb);
#pragma unroll
    for (int s = 0; s < SC; ++s) as[(s * 2 + ks) * 128 + (tid & 127)] = pack_bf16(va[s], vb[s]);
  };

  float acc[SC][NJ][4];
#pragma unroll
  for (int i = 0; i < SC; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  // the running sum added into this split's partial (the first time
  // written), then restarted
  float* dst = part + ((long long)blockIdx.z * groups + grp) * S * nin * nout;
  auto flush = [&](bool first) {
#pragma unroll
    for (int i = 0; i < SC; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int f = f0 + g8 + 8 * (e >> 1);
          const int o = o0 + 8 * (warp * NJ + j) + 2 * t + (e & 1);
          if (s0 + i < S && f < nin && o < nout) {
            float* d = dst + ((long long)F::wslice(S, s0 + i) * nin + f) * nout + o;
            *d = first ? acc[i][j][e] : *d + acc[i][j][e];
          }
          acc[i][j][e] = 0.f;
        }
  };

  // Stage kt + 1's A is made, and kt + 2's gy lands, while stage kt's
  // products run: A buffers by (stage - kt0) & 1, gy buffers by (stage -
  // kt0) % 3; one cp.async group a stage.
  load_gy(kt0, 0);
  cp_async_commit();
  if (kt0 + 1 < kt1) load_gy(kt0 + 1, 1);
  cp_async_commit();
  load_x(kt0);
  make(kt0, 0);
  load_x(kt0 + 1);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int b = (kt - kt0) & 1, r = (kt - kt0) % 3;
    cp_async_wait<1>();
    __syncthreads();  // stage kt made, its gy landed; A buffer b ^ 1 and gy buffer r + 2 free
    if (kt + 2 < kt1) load_gy(kt + 2, (r + 2) % 3);
    cp_async_commit();
    if (kt + 1 < kt1) {
      make(kt + 1, b ^ 1);
      load_x(kt + 2);
    }
    const uint32_t* as = stages + b * A_WORDS;
    const bf* rs = raw + r * RAW;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      uint32_t bfr[NJ][2];  // gy's rows 16 s + 2 t, + 1 (+ 8) of column 8 (warp NJ + j) + g
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        ldsm_x2_trans(bfr[j], rs + (16 * s + (lane & 15)) * RAW_P + 8 * (warp * NJ + j));
#pragma unroll
      for (int i = 0; i < SC; ++i) {
        const uint4 a4 = *reinterpret_cast<const uint4*>(as + (i * 2 + s) * 128 + 4 * lane);
        const uint32_t a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma_bf16(acc[i][j], a, bfr[j]);
      }
    }
    const int done = kt + 1 - kt0;
    if (done % tc::FLUSH == 0 || kt + 1 == kt1) flush(done <= tc::FLUSH);
  }
}

// out[e] = bf16(sum over splits of part[split][e]), the splits in order
// and one rounding: sum_splits_kernel's sums (group > 0: its two levels)
// rounded to bf16 once.
__global__ void sum_splits_bf16_kernel(const float* __restrict__ part,
                                       __nv_bfloat16* __restrict__ out, long long total,
                                       int splits, int group) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
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
    out[e] = __float2bfloat16_rn(acc);
  }
}

// sum_splits into a bf16 out, rounded once.
int sum_splits(const float* part, __nv_bfloat16* out, long long total, int splits,
               cudaStream_t st, int group = 0) {
  const long long want = (total + 255) / 256;
  sum_splits_bf16_kernel<<<(unsigned)(want < 4096 ? want : 4096), 256, 0, st>>>(
      part, out, total, splits, group);
  return (int)cudaGetLastError();
}

// dx of one group's 128 rows x 16 features: grid (feature tiles, row
// tiles, groups). w (groups, S, nin, nout) bf16 contiguous; dx (n, groups
// nin) bf16 contiguous (null: not written); vec: 16-byte copies of gy and
// w. A family of more than one chunk of SC slices (the bf16 sine
// embedder's 28, the bf16 Fourier embedder's 56) runs the chunks in turn,
// each over every output stage into SC fresh sums, its fold adding into the
// same per-(row, feature) outputs in slice order; a DX_CARRY family's fold
// (Fourier: dx and its recurrence's state) takes a Carry of each (row,
// feature) from chunk to chunk. A DX_FOLD family (Rbf) keeps part 2's two
// outputs of its fold: with `split`, o0 (dln) to out0 and o1 (the silu
// term) to out1, each f32 (n, groups nin) and either null to skip it, for
// the LayerNorm's passes; without, dx = bf16(o0 + o1). A DX_RED family
// (Sine) sums its fold's per-slice values over the block's 128 rows for
// each of its 16 features (lanes by a fixed butterfly, then the row
// warps in order) into red_part (groups, S, row tiles, nin) f32 (null:
// skipped), the rows of each feature before the features, which a second
// pass sums.
template <class F>
__global__ void __launch_bounds__(tcb::THREADS, 2)
kan_bf16_dx(const __nv_bfloat16* __restrict__ x, long long ldx, typename F::Params p,
            const __nv_bfloat16* __restrict__ gy, long long ldg,
            const __nv_bfloat16* __restrict__ w, __nv_bfloat16* __restrict__ dx,
            float* __restrict__ out0, float* __restrict__ out1, int split,
            float* __restrict__ red_part, int n, int groups, int nin, int nout, int nk,
            int vec) {
  using bf = __nv_bfloat16;
  constexpr int THREADS = tcb::THREADS, SC = F::SC, FT = tcb::FT, BM = tcb::DX_BM;
  constexpr int KS = tcb::DX_KS, P = tcb::DX_P;
  constexpr int NW = SC * FT;  // W rows a stage: (slice, feature)
  __shared__ __align__(16) bf gs[2][BM * P];
  __shared__ __align__(16) bf ws[2][NW * P];
  __shared__ typename F::template Stage<FT> st;
  __shared__ float redw[F::DX_RED ? THREADS / 64 : 1][F::DX_RED ? FT : 1][SC];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t = lane & 3, wr = warp >> 1, wh = warp & 1;
  const int f0 = blockIdx.x * FT, r0 = blockIdx.y * BM, grp = blockIdx.z;
  const int S = F::slices(p), CH = F::chunks(p);
  const bf* gyg = gy + (long long)grp * nout;
  const bf* wg = w + (long long)grp * S * nin * nout;
  F::template stage<FT>(p, nin, f0, grp, st);

  // gy's 128 rows and W's (slice, feature) rows of chunk c, outputs 16 kt ..
  // 16 kt + 15
  auto stage = [&](int c, int kt, int buf) {
    bf* a = gs[buf];
    bf* b = ws[buf];
    const int k0 = kt * KS;
    if (vec) {
      for (int e = tid; e < (BM + NW) * 2; e += THREADS) {
        const int r = e >> 1, cc = (e & 1) * 8, col = k0 + cc;
        if (r < BM) {
          const int row = r0 + r;
          const bool in = row < n && col < nout;
          cp_async16(reinterpret_cast<float*>(a + r * P + cc),
                     reinterpret_cast<const float*>(in ? gyg + row * ldg + col : gyg), in);
        } else {
          const int s = c * SC + (r - BM) / FT, f = f0 + (r - BM) % FT;
          const bool in = s < S && f < nin && col < nout;
          cp_async16(reinterpret_cast<float*>(b + (r - BM) * P + cc),
                     reinterpret_cast<const float*>(
                         in ? wg + ((long long)F::wslice(S, s) * nin + f) * nout + col : wg),
                     in);
        }
      }
    } else {
      for (int e = tid; e < (BM + NW) * KS; e += THREADS) {
        const int r = e / KS, cc = e % KS, col = k0 + cc;
        if (r < BM) {
          const int row = r0 + r;
          a[r * P + cc] = row < n && col < nout ? gyg[row * ldg + col] : __float2bfloat16_rn(0.f);
        } else {
          const int s = c * SC + (r - BM) / FT, f = f0 + (r - BM) % FT;
          b[(r - BM) * P + cc] = s < S && f < nin && col < nout
                                     ? wg[((long long)F::wslice(S, s) * nin + f) * nout + col]
                                     : __float2bfloat16_rn(0.f);
        }
      }
    }
    cp_async_commit();
  };

  // this thread's outputs of its rows (g, g + 8 of its two m16 tiles) and
  // features (2t, 2t + 1 of its half), summed over the chunks, and a
  // DX_CARRY family's state of each from chunk to chunk
  float o0s[2][4], o1s[2][4];
  typename F::Carry carry[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o0s[i][e] = o1s[i][e] = 0.f;

  for (int c = 0; c < CH; ++c) {
    float acc[2][SC][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    if (c > 0) __syncthreads();  // the last chunk's stages and sums are read
    stage(c, 0, 0);
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<0>();
      __syncthreads();  // stage kt landed; the other buffer is free
      if (kt + 1 < nk) stage(c, kt + 1, (kt + 1) & 1);
      const bf* a = gs[kt & 1];
      const bf* b = ws[kt & 1];
      uint32_t af[2][4];  // gy rows 32 wr + 16 i + g (+ 8), outputs 2t, 2t + 1 (+ 8)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const bf* ar = a + (32 * wr + 16 * i + g8) * P + 2 * t;
        af[i][0] = *reinterpret_cast<const uint32_t*>(ar);
        af[i][1] = *reinterpret_cast<const uint32_t*>(ar + 8 * P);
        af[i][2] = *reinterpret_cast<const uint32_t*>(ar + 8);
        af[i][3] = *reinterpret_cast<const uint32_t*>(ar + 8 * P + 8);
      }
#pragma unroll
      for (int j = 0; j < SC; ++j) {  // column g: slice j, feature 8 wh + g
        const bf* br = b + (j * FT + 8 * wh + g8) * P + 2 * t;
        const uint32_t bfr[2] = {*reinterpret_cast<const uint32_t*>(br),
                                 *reinterpret_cast<const uint32_t*>(br + 8)};
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_bf16(acc[i][j], af[i], bfr);
      }
    }

    // The epilogue of chunk c, each (row, feature) with the chunk's SC
    // slices of gW.
    float red[2][SC];  // DX_RED: this thread's rows' sums, feature 2t + h
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < SC; ++j) red[h][j] = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long row = r0 + 32 * wr + 16 * i + g8 + 8 * (e >> 1);
        const int kf = 8 * wh + 2 * t + (e & 1), f = f0 + kf;
        if (row >= n || f >= nin) continue;
        const Elem el{__bfloat162float(x[row * ldx + (long long)grp * nin + f]), kf, f, grp,
                      row};
        if constexpr (F::DX_FOLD) {
          float gw[SC];
#pragma unroll
          for (int j = 0; j < SC; ++j) gw[j] = acc[i][j][e];
          if constexpr (F::DX_CARRY)
            F::fold(p, el, c, gw, o0s[i][e], carry[i][e]);
          else
            F::template fold<FT>(p, st, el, c, gw, o0s[i][e], o1s[i][e], red[e & 1]);
        } else {
          float d[SC];
          F::template derivs<FT>(p, st, el, c, d);
#pragma unroll
          for (int j = 0; j < SC; ++j)
            o0s[i][e] = __fadd_rn(o0s[i][e], __fmul_rn(acc[i][j][e], d[j]));
        }
      }
    if constexpr (F::DX_RED) {
      if (red_part != nullptr) {
        // over the warp's 32 rows (the lanes of one t), then its row group's
        // warps in order; features kf = 8 wh + 2t + h
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < SC; ++j) {
            float v = red[h][j];
#pragma unroll
            for (int off = 4; off < 32; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
            if (g8 == 0) redw[wr][8 * wh + 2 * t + h][j] = v;
          }
        __syncthreads();
        if (tid < FT * SC) {
          const int kf = tid / SC, j = tid % SC, s = c * SC + j, f = f0 + kf;
          float sum = 0.f;
          for (int q = 0; q < THREADS / 64; ++q) sum += redw[q][kf][j];
          if (f < nin && s < S)
            red_part[(((long long)grp * S + s) * gridDim.y + blockIdx.y) * nin + f] = sum;
        }
      }
    }
  }

  const long long ldd = (long long)groups * nin;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long row = r0 + 32 * wr + 16 * i + g8 + 8 * (e >> 1);
      const int f = f0 + 8 * wh + 2 * t + (e & 1);
      if (row >= n || f >= nin) continue;
      const long long at = row * ldd + (long long)grp * nin + f;
      if (F::DX_FOLD && split) {
        if (out0 != nullptr) out0[at] = o0s[i][e];
        if (out1 != nullptr) out1[at] = o1s[i][e];
      } else if (dx != nullptr) {
        dx[at] = __float2bfloat16_rn(F::DX_FOLD ? o0s[i][e] + o1s[i][e] : o0s[i][e]);
      }
    }
}

template <class F, int NJ>
int launch_bf16_dw(const __nv_bfloat16* x, long long ldx, typename F::Params p,
                   const __nv_bfloat16* gy, long long ldg, int vec, __nv_bfloat16* dw,
                   float* part, int n, int groups, int nin, int nout, int splits,
                   cudaStream_t st) {
  constexpr int BN = 64 * NJ;
  const int nk = cdiv(n, tcb::KT);
  const int per = cdiv(nk, min(splits, nk));
  splits = cdiv(nk, per);  // no split left empty
  const long long tiles = (long long)cdiv(nin, tcb::FT) * F::chunks(p) * groups;
  if (tiles > 65535 || splits > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(uint32_t) * 2 * F::SC * 2 * 128 +
                      sizeof(__nv_bfloat16) * 3 * tcb::KT * (BN + 8);
  int err = tc_attr(kan_bf16_dw<F, NJ>, smem);
  if (err != 0) return err;
  kan_bf16_dw<F, NJ><<<dim3(cdiv(nout, BN), (unsigned)tiles, splits), tcb::THREADS, smem,
                       st>>>(x, ldx, p, gy, ldg, part, n, groups, nin, nout, nk, per, vec);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  return sum_splits(part, dw, (long long)groups * F::slices(p) * nin * nout, splits, st);
}

// 16-byte copies of gy (n, groups nout) and w in the bf16 kernels.
inline int bf16_vec(const __nv_bfloat16* gy, const __nv_bfloat16* w, int nout) {
  return nout % 8 == 0 && (uintptr_t)gy % 16 == 0 && (uintptr_t)w % 16 == 0;
}

// kan_bf16_dx<F> over launch_bf16_grouped_bwd's operands, into dx or (a
// DX_FOLD family with split) out0 and out1, and a DX_RED family's
// per-feature row-tile sums into red_part (either may be null, not both).
template <class F>
int launch_bf16_dx(const __nv_bfloat16* x, long long ldx, typename F::Params p,
                   const __nv_bfloat16* w, const __nv_bfloat16* gy, __nv_bfloat16* dx,
                   float* out0, float* out1, int split, int n, int groups, int nin, int nout,
                   cudaStream_t st, float* red_part = nullptr) {
  const dim3 grid(cdiv(nin, tcb::FT), cdiv(n, tcb::DX_BM), groups);
  if (grid.y > 65535u || grid.z > 65535u || (!split && dx == nullptr && red_part == nullptr))
    return (int)cudaErrorInvalidValue;
  kan_bf16_dx<F><<<grid, tcb::THREADS, 0, st>>>(x, ldx, p, gy, (long long)groups * nout, w, dx,
                                                out0, out1, split, red_part, n, groups, nin,
                                                nout, cdiv(nout, tcb::DX_KS),
                                                bf16_vec(gy, w, nout));
  return (int)cudaGetLastError();
}

// dW of launch_bf16_grouped_bwd's operands: 64 outputs a block up to nout
// 64, else 192.
template <class F>
int launch_bf16_grouped_dw(const __nv_bfloat16* x, long long ldx, typename F::Params p,
                           const __nv_bfloat16* w, const __nv_bfloat16* gy, __nv_bfloat16* dw,
                           float* part, int n, int groups, int nin, int nout, int splits,
                           cudaStream_t st) {
  const long long ldg = (long long)groups * nout;
  const int vec = bf16_vec(gy, w, nout);
  if (nout <= 64)
    return launch_bf16_dw<F, 1>(x, ldx, p, gy, ldg, vec, dw, part, n, groups, nin, nout,
                                splits, st);
  return launch_bf16_dw<F, tcg::DW_WIDE>(x, ldx, p, gy, ldg, vec, dw, part, n, groups, nin,
                                         nout, splits, st);
}

// dx and dW of a grouped layer in bf16, either null to skip it: x (n,
// groups nin) bf16 with row stride ldx and unit column stride, w (groups,
// S, nin, nout), gy (n, groups nout), dx (n, groups nin) and dw (groups,
// S, nin, nout) bf16 contiguous; part: f32 scratch of splits groups S nin
// nout floats (the dW kernel's row splits, at most `splits`) when dw is
// asked for. cudaErrorInvalidValue on a bad shape or a missing scratch.
template <class F>
int launch_bf16_grouped_bwd(const __nv_bfloat16* x, long long ldx, typename F::Params p,
                            const __nv_bfloat16* w, const __nv_bfloat16* gy,
                            __nv_bfloat16* dx, __nv_bfloat16* dw, float* part, int n,
                            int groups, int nin, int nout, int splits, cudaStream_t st) {
  if (bad_shape(n, groups, nin, nout) || F::slices(p) <= 0 ||
      F::slices(p) > F::SC * F::chunks(p) || splits < 1 || (dw != nullptr && part == nullptr))
    return (int)cudaErrorInvalidValue;
  if (dx != nullptr) {
    const int err = launch_bf16_dx<F>(x, ldx, p, w, gy, dx, nullptr, nullptr, 0, n, groups,
                                      nin, nout, st);
    if (err != 0) return err;
  }
  if (dw == nullptr) return 0;
  return launch_bf16_grouped_dw<F>(x, ldx, p, w, gy, dw, part, n, groups, nin, nout, splits,
                                   st);
}

}  // namespace
