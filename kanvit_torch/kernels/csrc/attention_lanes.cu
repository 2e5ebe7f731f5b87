// Attention over head-concatenated (B, T, H*dh) tensors, forward and
// backward.
//
// Replaces the TPU kernels of kanvit/kernels/flash_attention.py:
//   forward:  _lanes_fwd_impl (pallas_call at :571), reached from
//             _flash_lanes (:547) and flash_attention_lanes (:647);
//   backward: _lanes_bwd (pallas_call at :604, body _lanes_bwd_kernel
//             :498-534), _flash_lanes' VJP.
// The single-tile tier (_small_fwd_impl :410, _small_bwd_impl :442) runs on
// these kernels too, through (B, T, H, dh) views. The bf16 path (kanvit's
// bf16 serving and training) is attention_lanes_fwd_bf16 and the backward
// pair attention_lanes_dq_bf16 and attention_lanes_dkv_bf16, below the f32
// tensor-core kernels: bf16 mma.sync.m16n8k16, every head dim the f32
// kernels take (dh 8, 16, 32 and 64 on instantiations of their own, every
// other multiple of 8 through 128 on one padded to 128).
//
// Per batch item b and head h:
//   o_h = softmax(q_h k_h^T * dh^-1/2 + key bias + causal bias) v_h
// with the TPU kernel's edge semantics (flash_attention.py:312-341): masked
// keys contribute exactly 0, the row max is clamped at -1e30 and the row sum
// at 1e-10, so a fully masked row outputs 0 and gets gradients of exactly 0.
// The backward, with p the normalised probabilities:
//   dv = p^T do,  delta = rowsum(do * o),  ds = p * (do v^T - delta),
//   dq = ds k * dh^-1/2,  dk = ds^T q * dh^-1/2.
//
// q, k and v are read in place through (batch, token, head) strides with a
// unit stride inside a head, so the three q/k/v slices of the grouped
// projection's (N, H*3dh) output are consumed without a copy. o, do and the
// gradients are contiguous (B, T, H*dh), the layout the next layer reads.
//
// What bounds them on the H100: at ViT-S (T = 197, dh = 64, 6 heads, batch
// 64) the forward's two products are 4*B*H*T^2*dh = 3.8 GFLOP per layer
// against ~78 MB of q, k, v and o; the backward's seven (the scores and
// do v^T in each of its two kernels, then dq, dk and dv) are 13.4 GFLOP
// against ~0.2 GB of q, k, v, o, do and gradients. On the CUDA cores (67
// TFLOP/s f32) that is 0.057 and 0.20 ms of arithmetic; on the tensor cores
// in 3xTF32 (three TF32 products for each f32 one, 495 TFLOP/s dense) 0.023
// and 0.081 ms, level with the bytes (0.023 and 0.06 ms at 3.35 TB/s).
// Besides the products, every score takes one expf (14.9M a forward layer,
// twice that in the backward): full-precision expf, never __expf, as the
// TPU kernel's exp. What bounds these kernels in practice is neither: it is
// the instructions issued beside each mma (chip_smoke.py prints the SASS
// mix: 192 HMMA of 3,272 instructions in the dh-64 forward) -- the operand
// splits, the f32 adds of the per-step accumulators, the masks and the
// online softmax -- and the latency of a product's three dependent mma, at
// 3 blocks of 4 warps an SM. They run at about 12% of the 3xTF32 bound
// (PERF.md section 6). Splitting each staged tile once for the block's
// warps instead of in every warp, a 128-register cap and 2-warp blocks
// were each no faster.
//
// Head dims 8, 16, 32 and 64 (vit-s/b/l 64, the reference preset 32,
// load_predictor's defaults 8) run the f32 tensor-core kernels below; every
// other multiple of 8 through 128 runs the generic CUDA-core kernels at the
// end of the file (attention_common.cuh): no main path runs them, and a
// templated instantiation per dh made the build run past its time limit.
// In bf16 every such dh runs on the tensor cores: the generic ones on one
// instantiation padded to 128 (below, "--- bf16").
//
// -- Arithmetic: 3xTF32 on mma.sync.m16n8k8 (helpers: attention_tc.cuh) ----
// Every product runs as mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32.
// Each f32 operand x is split in registers into big = tf32(x) and small =
// tf32(x - big) (cvt.rna.tf32.f32 both), and a product is three mma into
// one f32 accumulator, in the order small*big, big*small, big*big (CUTLASS's
// OpMultiplyAddFastF32, the arithmetic of PyTorch's f32 memory-efficient
// attention). The dropped small*small term is ~2^-22 of each product. Each
// 8-wide step's three mma go into a zeroed accumulator that an f32 add
// (round to nearest) takes into the running sum (mma3): the tensor cores'
// own accumulation truncates, and chained through the running sum it put
// the vit-s forward further from f64 than the 1e-6 that the card test
// allows. With the fresh accumulator the forward is 4.5e-7 of max(1,
// max|o|) from f64 on the card (chip_smoke.py), where plain 1xTF32 would be
// ~6e-4 off and break the 1e-5 gate (tests/test_torch_port_attention_tc.py
// emulates both).
//
// -- Fragment route ---------------------------------------------------------
// m16n8k8 fragments (g = lane / 4, t = lane % 4): A holds (g, t), (g+8, t),
// (g, t+4), (g+8, t+4); B holds (k t, n g), (k t+4, n g); the accumulator C
// holds (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1). A score tile comes out
// as C, with each thread on columns 2t and 2t+1, while the next product
// needs it as A on columns t and t+4. A contraction does not care about the
// order of its index, so within each 8-wide step the kernels number the
// contracted index (keys in the forward and dq, queries in dk/dv) as
// k t <-> 2t and k t+4 <-> 2t+1: C's four registers become A's as they are
// (c0, c2, c1, c3), and the B operand of that product reads rows 2t and
// 2t+1 of its staged tile at column g. No probability touches shared memory.
//   forward  S = (q scale) K^T    A q rows (registers)   B K tile, row g
//            O += P V             A P from S's C         B V tile, rows 2t, 2t+1
//   dq       S, dP = do V^T       A q, do rows           B K, V tiles, row g
//            dQ += dS K           A dS from C            B K tile, rows 2t, 2t+1
//   dk/dv    S^T = K (q scale)^T  A K, V rows of the     B q, do tiles, row g
//            dP^T = V do^T          warp's keys
//            dV += P^T do         A P^T from S^T's C     B do tile, rows 2t, 2t+1
//            dK += dS^T (q scale) A dS^T from C          B q tile, rows 2t, 2t+1
// The dk/dv kernel computes the transposed scores itself (keys as the M
// rows), so P^T and dS^T are C fragments like P and dS, and take the same
// register route. Staged tiles have a row pitch of dh + 4 floats, which
// puts both read patterns (row g, column t; rows 2t and 2t+1, column g) on
// 32 distinct banks.
//
// -- Layout -----------------------------------------------------------------
// A block is 4 warps; each warp owns 16 rows (queries in the forward and dq,
// keys in dk/dv), so T = 197 runs 13 warps of rows (208), and a warp whose
// rows all lie past T only helps stage tiles. Tiles of 32 keys (queries in
// dk/dv) are staged with 16-byte cp.async, double buffered, shared by the
// block's warps; keys and queries past T are zero-filled, and a warp skips
// each 8-wide step that lies wholly past T or, causal, wholly outside its
// rows' reach. The forward keeps the online softmax (running max from the
// -1e30 clamp, running sum) on the S accumulator in registers and writes
// each row's (m, l) when asked; the backward reads them instead of
// recomputing. The backward is two kernels, no atomics, so its bits repeat:
// dq (which writes delta) per query tile streaming the keys, then dk/dv per
// key tile streaming the queries. 16-byte copies need every staged row
// 16-byte aligned: the wrapper checks q, k and v and raises otherwise.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "attention_tc.cuh"

namespace {

constexpr float EPSILON = 1e-10f;
constexpr float MAX_CLAMP = -1e30f;

// --- tensor-core kernels: dh 8, 16, 32, 64 ---------------------------------

constexpr int TC_ROWS = 16 * TC_WARPS;  // rows a block: queries (fwd, dq), keys (dk/dv)
constexpr int TC_TILE = 32;             // keys (queries in dk/dv) a staged tile
constexpr int TC_STEPS = TC_TILE / 8;   // 8-wide steps a tile

// Forward. One block per (64 query rows, head, batch); warp w owns rows
// q0 + 16w .. +15.
template <int DH>
__global__ void __launch_bounds__(32 * TC_WARPS)
attention_lanes_fwd_tc(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       long long q_sb, long long q_st, long long q_sh,
                       long long k_sb, long long k_st, long long k_sh,
                       long long v_sb, long long v_st, long long v_sh,
                       const uint8_t* __restrict__ mask,
                       float* __restrict__ o, float* __restrict__ stats,
                       int t_len, int heads, int causal, float scale) {
  constexpr int P = DH + TC_PAD;
  constexpr int KD = DH / 8;  // 8-wide steps over dh
  __shared__ __align__(16) float ks[2][TC_TILE][P];
  __shared__ __align__(16) float vs[2][TC_TILE][P];
  __shared__ int kvalid[2][TC_TILE];

  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * TC_ROWS;
  const int r0 = q0 + (tid >> 5) * 16;  // the warp's first row
  const bool active = r0 < t_len;
  const int last = min(r0 + 15, t_len - 1);  // the warp's last live row
  const int ra = r0 + g, rb = r0 + g + 8;

  // The warp's q rows, scaled, as split A fragments.
  Frag<4> qf[KD];
  {
    const float* qpa = q + b * q_sb + (long long)min(ra, t_len - 1) * q_st + h * q_sh;
    const float* qpb = q + b * q_sb + (long long)min(rb, t_len - 1) * q_st + h * q_sh;
    const float fa = ra < t_len ? scale : 0.f, fb = rb < t_len ? scale : 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      const int c = kd * 8 + t;
      const float x[4] = {qpa[c] * fa, qpb[c] * fb, qpa[c + 4] * fa, qpb[c + 4] * fb};
      qf[kd] = Frag<4>(x);
    }
  }

  float acc[KD][4];
#pragma unroll
  for (int d = 0; d < KD; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float ma = MAX_CLAMP, mb = MAX_CLAMP, la = 0.f, lb = 0.f;

  const float* kh = k + b * k_sb + h * k_sh;
  const float* vh = v + b * v_sb + h * v_sh;
  const int kend = causal ? min(t_len, q0 + TC_ROWS) : t_len;
  const int tiles = (kend + TC_TILE - 1) / TC_TILE;
  auto stage = [&](int tile, int buf) {
    stage_tile<DH, TC_TILE>(&ks[buf][0][0], kh, k_st, tile * TC_TILE, t_len, tid);
    stage_tile<DH, TC_TILE>(&vs[buf][0][0], vh, v_st, tile * TC_TILE, t_len, tid);
    cp_async_commit();
    if (tid < TC_TILE) {
      const int key = tile * TC_TILE + tid;
      kvalid[buf][tid] = key < t_len &&
                         (mask == nullptr || mask[(long long)b * t_len + key] != 0);
    }
  };
  stage(0, 0);
  for (int it = 0; it < tiles; ++it) {
    const int buf = it & 1, k0 = it * TC_TILE;
    if (it + 1 < tiles) {
      stage(it + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // 8-key steps with a key this warp may see: below t_len and, causal,
    // at or before its last row.
    const int steps = min(TC_STEPS, ((causal ? last + 1 : t_len) - k0 + 7) / 8);
    if (active && steps > 0) {
      float s[TC_STEPS][4];
#pragma unroll
      for (int n = 0; n < TC_STEPS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
#pragma unroll
        for (int n = 0; n < TC_STEPS; ++n)
          if (n < steps) mma3(s[n], qf[kd], b_row(&ks[buf][n * 8 + g][kd * 8 + t]));
      float mxa = ma, mxb = mb;
#pragma unroll
      for (int n = 0; n < TC_STEPS; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = n * 8 + 2 * t + (c & 1);
          const bool ok = kvalid[buf][j] && (!causal || k0 + j <= (c < 2 ? ra : rb));
          s[n][c] = ok ? s[n][c] : -INFINITY;
          if (c < 2) mxa = fmaxf(mxa, s[n][c]);
          else mxb = fmaxf(mxb, s[n][c]);
        }
      mxa = quad_max(mxa);
      mxb = quad_max(mxb);
      const float ca = expf(ma - mxa), cb = expf(mb - mxb);
      la *= ca;
      lb *= cb;
#pragma unroll
      for (int d = 0; d < KD; ++d) {
        acc[d][0] *= ca;
        acc[d][1] *= ca;
        acc[d][2] *= cb;
        acc[d][3] *= cb;
      }
#pragma unroll
      for (int n = 0; n < TC_STEPS; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[n][c] = expf(s[n][c] - (c < 2 ? mxa : mxb));  // exactly 0 for a masked key
          if (c < 2) la += s[n][c];
          else lb += s[n][c];
        }
      ma = mxa;
      mb = mxb;
#pragma unroll
      for (int n = 0; n < TC_STEPS; ++n) {
        if (n >= steps) continue;
        const Frag<4> pa = c_as_a(s[n]);
#pragma unroll
        for (int d = 0; d < KD; ++d)
          mma3(acc[d], pa, b_pair<P>(&vs[buf][n * 8 + 2 * t][d * 8 + g]));
      }
    }
    __syncthreads();  // this buffer is restaged two tiles on
  }

  la = quad_sum(la);
  lb = quad_sum(lb);
  const float rla = 1.f / fmaxf(la, EPSILON), rlb = 1.f / fmaxf(lb, EPSILON);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? rb : ra;
    if (!active || row >= t_len) continue;
    const float rl = half ? rlb : rla;
    float* op = o + (((long long)b * t_len + row) * heads + h) * DH + 2 * t;
#pragma unroll
    for (int d = 0; d < KD; ++d)
      *reinterpret_cast<float2*>(op + d * 8) =
          make_float2(acc[d][2 * half] * rl, acc[d][2 * half + 1] * rl);
    if (stats != nullptr && t == 0) {
      float* sp = stats + (((long long)b * heads + h) * t_len + row) * 2;
      sp[0] = half ? mb : ma;
      sp[1] = half ? lb : la;
    }
  }
}

// dq and delta. One block per (64 query rows, head, batch); warp w owns
// rows q0 + 16w .. +15 and streams the keys. Dynamic shared memory: the
// block's q and do rows (A operands, read at each 8-wide step of dh), then
// the double-buffered K and V tiles.
template <int DH>
__global__ void __launch_bounds__(32 * TC_WARPS)
attention_lanes_dq_tc(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      long long q_sb, long long q_st, long long q_sh,
                      long long k_sb, long long k_st, long long k_sh,
                      long long v_sb, long long v_st, long long v_sh,
                      const uint8_t* __restrict__ mask,
                      const float* __restrict__ o,
                      const float* __restrict__ dout,
                      const float* __restrict__ stats,
                      float* __restrict__ delta_out,
                      float* __restrict__ dq, int t_len, int heads,
                      int causal, float scale) {
  constexpr int P = DH + TC_PAD;
  constexpr int KD = DH / 8;
  extern __shared__ __align__(16) float smem[];
  float* qrow = smem;                    // [TC_ROWS][P]
  float* drow = qrow + TC_ROWS * P;      // [TC_ROWS][P]
  float* ks = drow + TC_ROWS * P;        // [2][TC_TILE][P]
  float* vs = ks + 2 * TC_TILE * P;      // [2][TC_TILE][P]
  __shared__ int kvalid[2][TC_TILE];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * TC_ROWS;
  const int r0 = q0 + warp * 16;
  const bool active = r0 < t_len;
  const int last = min(r0 + 15, t_len - 1);
  const int ra = r0 + g, rb = r0 + g + 8;
  const bool la_ok = ra < t_len, lb_ok = rb < t_len;
  const long long srow = ((long long)b * heads + h) * t_len;  // of stats, delta

  const float* kh = k + b * k_sb + h * k_sh;
  const float* vh = v + b * v_sb + h * v_sh;
  const int kend = causal ? min(t_len, q0 + TC_ROWS) : t_len;
  const int tiles = (kend + TC_TILE - 1) / TC_TILE;
  auto stage = [&](int tile, int buf) {
    stage_tile<DH, TC_TILE>(ks + buf * TC_TILE * P, kh, k_st, tile * TC_TILE, t_len, tid);
    stage_tile<DH, TC_TILE>(vs + buf * TC_TILE * P, vh, v_st, tile * TC_TILE, t_len, tid);
    cp_async_commit();
    if (tid < TC_TILE) {
      const int key = tile * TC_TILE + tid;
      kvalid[buf][tid] = key < t_len &&
                         (mask == nullptr || mask[(long long)b * t_len + key] != 0);
    }
  };
  stage_tile<DH, TC_ROWS>(qrow, q + b * q_sb + h * q_sh, q_st, q0, t_len, tid);
  stage_tile<DH, TC_ROWS>(drow, dout + (long long)b * t_len * heads * DH + h * DH,
                          (long long)heads * DH, q0, t_len, tid);
  stage(0, 0);  // one group with the rows

  // delta = rowsum(do * o) of rows ra and rb, and the forward's (m, 1/l).
  float dla = 0.f, dlb = 0.f;
  {
    const long long oa = (((long long)b * t_len + min(ra, t_len - 1)) * heads + h) * DH;
    const long long ob = (((long long)b * t_len + min(rb, t_len - 1)) * heads + h) * DH;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
#pragma unroll
      for (int e = 0; e < 8; e += 4) {
        const int c = kd * 8 + t + e;
        dla = fmaf(dout[oa + c], o[oa + c], dla);
        dlb = fmaf(dout[ob + c], o[ob + c], dlb);
      }
  }
  dla = quad_sum(dla);  // every lane shuffles; rows past t_len read row t_len-1
  dlb = quad_sum(dlb);
  const float ma = la_ok ? stats[(srow + ra) * 2] : 0.f;
  const float mb = lb_ok ? stats[(srow + rb) * 2] : 0.f;
  const float rla = la_ok ? 1.f / fmaxf(stats[(srow + ra) * 2 + 1], EPSILON) : 0.f;
  const float rlb = lb_ok ? 1.f / fmaxf(stats[(srow + rb) * 2 + 1], EPSILON) : 0.f;

  float acc[KD][4];
#pragma unroll
  for (int d = 0; d < KD; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  const float* qw = qrow + (warp * 16 + g) * P + t;  // A at (g, t) of step 0
  const float* dw = drow + (warp * 16 + g) * P + t;
  for (int it = 0; it < tiles; ++it) {
    const int buf = it & 1, k0 = it * TC_TILE;
    if (it + 1 < tiles) {
      stage(it + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* kt = ks + buf * TC_TILE * P;
    const float* vt = vs + buf * TC_TILE * P;
    const int steps = min(TC_STEPS, ((causal ? last + 1 : t_len) - k0 + 7) / 8);
    if (active && steps > 0) {
      float s[TC_STEPS][4], dp[TC_STEPS][4];
#pragma unroll
      for (int n = 0; n < TC_STEPS; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[n][c] = dp[n][c] = 0.f;
#pragma unroll 1
      for (int kd = 0; kd < KD; ++kd) {
        const Frag<4> qf = a_rows<P>(qw + kd * 8, scale), df = a_rows<P>(dw + kd * 8);
#pragma unroll
        for (int n = 0; n < TC_STEPS; ++n) {
          if (n >= steps) continue;
          mma3(s[n], qf, b_row(kt + (n * 8 + g) * P + kd * 8 + t));
          mma3(dp[n], df, b_row(vt + (n * 8 + g) * P + kd * 8 + t));
        }
      }
#pragma unroll
      for (int n = 0; n < TC_STEPS; ++n)  // s becomes ds
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = n * 8 + 2 * t + (c & 1);
          const bool hi = c >= 2;
          const bool ok = (hi ? lb_ok : la_ok) && kvalid[buf][j] &&
                          (!causal || k0 + j <= (hi ? rb : ra));
          const float p = ok ? expf(s[n][c] - (hi ? mb : ma)) * (hi ? rlb : rla) : 0.f;
          s[n][c] = p * (dp[n][c] - (hi ? dlb : dla));
        }
#pragma unroll
      for (int n = 0; n < TC_STEPS; ++n) {
        if (n >= steps) continue;
        const Frag<4> sa = c_as_a(s[n]);
#pragma unroll
        for (int d = 0; d < KD; ++d)
          mma3(acc[d], sa, b_pair<P>(kt + (n * 8 + 2 * t) * P + d * 8 + g));
      }
    }
    __syncthreads();  // this buffer is restaged two tiles on
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? rb : ra;
    if (!active || row >= t_len) continue;
    float* dqp = dq + (((long long)b * t_len + row) * heads + h) * DH + 2 * t;
#pragma unroll
    for (int d = 0; d < KD; ++d)
      *reinterpret_cast<float2*>(dqp + d * 8) =
          make_float2(acc[d][2 * half] * scale, acc[d][2 * half + 1] * scale);
    if (t == 0) delta_out[srow + row] = half ? dlb : dla;
  }
}

// dk and dv. One block per (64 keys, head, batch); warp w owns keys
// k0 + 16w .. +15 and streams the queries, reading the forward's (m, l) and
// the dq kernel's delta. Dynamic shared memory: the block's k and v rows (A
// operands), then the double-buffered q (unscaled) and do tiles.
template <int DH>
__global__ void __launch_bounds__(32 * TC_WARPS)
attention_lanes_dkv_tc(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       long long q_sb, long long q_st, long long q_sh,
                       long long k_sb, long long k_st, long long k_sh,
                       long long v_sb, long long v_st, long long v_sh,
                       const uint8_t* __restrict__ mask,
                       const float* __restrict__ dout,
                       const float* __restrict__ stats,
                       const float* __restrict__ delta,
                       float* __restrict__ dk, float* __restrict__ dv,
                       int t_len, int heads, int causal, float scale) {
  constexpr int P = DH + TC_PAD;
  constexpr int KD = DH / 8;
  extern __shared__ __align__(16) float smem[];
  float* krow = smem;                    // [TC_ROWS][P]
  float* vrow = krow + TC_ROWS * P;      // [TC_ROWS][P]
  float* qs = vrow + TC_ROWS * P;        // [2][TC_TILE][P]
  float* dos = qs + 2 * TC_TILE * P;     // [2][TC_TILE][P]
  __shared__ float mrow[2][TC_TILE], rlrow[2][TC_TILE], drow[2][TC_TILE];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * TC_ROWS;
  const int j0 = k0 + warp * 16;  // the warp's first key
  const bool active = j0 < t_len;
  const int ja = j0 + g, jb = j0 + g + 8;
  const bool va = ja < t_len && (mask == nullptr || mask[(long long)b * t_len + ja] != 0);
  const bool vb = jb < t_len && (mask == nullptr || mask[(long long)b * t_len + jb] != 0);
  const long long srow = ((long long)b * heads + h) * t_len;

  float dka[KD][4], dva[KD][4];
#pragma unroll
  for (int d = 0; d < KD; ++d)
#pragma unroll
    for (int c = 0; c < 4; ++c) dka[d][c] = dva[d][c] = 0.f;

  const float* qh = q + b * q_sb + h * q_sh;
  const float* doh = dout + (long long)b * t_len * heads * DH + h * DH;
  // Causal: query i sees key j only for i >= j, so the tiles start at k0.
  const int i_start = causal ? k0 : 0;
  const int tiles = (t_len - i_start + TC_TILE - 1) / TC_TILE;
  auto stage = [&](int tile, int buf) {
    const int i0 = i_start + tile * TC_TILE;
    stage_tile<DH, TC_TILE>(qs + buf * TC_TILE * P, qh, q_st, i0, t_len, tid);
    stage_tile<DH, TC_TILE>(dos + buf * TC_TILE * P, doh, (long long)heads * DH, i0,
                            t_len, tid);
    cp_async_commit();
    if (tid < TC_TILE) {
      const int qi = i0 + tid;
      const bool in = qi < t_len;
      mrow[buf][tid] = in ? stats[(srow + qi) * 2] : 0.f;
      rlrow[buf][tid] = in ? 1.f / fmaxf(stats[(srow + qi) * 2 + 1], EPSILON) : 0.f;
      drow[buf][tid] = in ? delta[srow + qi] : 0.f;
    }
  };
  stage_tile<DH, TC_ROWS>(krow, k + b * k_sb + h * k_sh, k_st, k0, t_len, tid);
  stage_tile<DH, TC_ROWS>(vrow, v + b * v_sb + h * v_sh, v_st, k0, t_len, tid);
  stage(0, 0);  // one group with the rows

  const float* kw = krow + (warp * 16 + g) * P + t;  // A at (g, t) of step 0
  const float* vw = vrow + (warp * 16 + g) * P + t;
  for (int it = 0; it < tiles; ++it) {
    const int buf = it & 1, i0 = i_start + it * TC_TILE;
    if (it + 1 < tiles) {
      stage(it + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* qt = qs + buf * TC_TILE * P;
    const float* dt = dos + buf * TC_TILE * P;
    // 8-query steps this warp's keys may be seen from: below t_len and,
    // causal, ending at or after its first key.
    const int hi_step = min(TC_STEPS, (t_len - i0 + 7) / 8);
    const int lo_step = causal ? max(0, (j0 - i0) / 8) : 0;
    if (active && lo_step < hi_step) {
      float st[TC_STEPS][4], dpt[TC_STEPS][4];
#pragma unroll
      for (int n = 0; n < TC_STEPS; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) st[n][c] = dpt[n][c] = 0.f;
#pragma unroll 1
      for (int kd = 0; kd < KD; ++kd) {
        const Frag<4> kf = a_rows<P>(kw + kd * 8), vf = a_rows<P>(vw + kd * 8);
#pragma unroll
        for (int n = 0; n < TC_STEPS; ++n) {
          if (n < lo_step || n >= hi_step) continue;
          mma3(st[n], kf, b_row(qt + (n * 8 + g) * P + kd * 8 + t, scale));
          mma3(dpt[n], vf, b_row(dt + (n * 8 + g) * P + kd * 8 + t));
        }
      }
#pragma unroll
      for (int n = 0; n < TC_STEPS; ++n)  // st becomes p^T, dpt ds^T
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = n * 8 + 2 * t + (c & 1), qi = i0 + r;
          const bool hi = c >= 2;
          const bool ok = (hi ? vb : va) && qi < t_len &&
                          (!causal || (hi ? jb : ja) <= qi);
          const float p = ok ? expf(st[n][c] - mrow[buf][r]) * rlrow[buf][r] : 0.f;
          dpt[n][c] = p * (dpt[n][c] - drow[buf][r]);
          st[n][c] = p;
        }
#pragma unroll
      for (int n = 0; n < TC_STEPS; ++n) {
        if (n < lo_step || n >= hi_step) continue;
        const Frag<4> pa = c_as_a(st[n]), sa = c_as_a(dpt[n]);
#pragma unroll
        for (int d = 0; d < KD; ++d) {
          mma3(dva[d], pa, b_pair<P>(dt + (n * 8 + 2 * t) * P + d * 8 + g));
          mma3(dka[d], sa, b_pair<P>(qt + (n * 8 + 2 * t) * P + d * 8 + g, scale));
        }
      }
    }
    __syncthreads();  // this buffer is restaged two tiles on
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = half ? jb : ja;
    if (!active || key >= t_len) continue;
    const long long off = (((long long)b * t_len + key) * heads + h) * DH + 2 * t;
#pragma unroll
    for (int d = 0; d < KD; ++d) {
      *reinterpret_cast<float2*>(dk + off + d * 8) =
          make_float2(dka[d][2 * half], dka[d][2 * half + 1]);
      *reinterpret_cast<float2*>(dv + off + d * 8) =
          make_float2(dva[d][2 * half], dva[d][2 * half + 1]);
    }
  }
}

// --- bf16: every multiple of 8 through 128 --------------------------------
// The bf16 forward and backward kernels (bf16 mma.sync.m16n8k16), on the
// fragment helpers of attention_tc.cuh (bf16_a_rows, bf16_rows_by_tile,
// bf16_c_by_tile, store_bf16_pair) over TC_STEPS 8-row steps a tile. dh 8,
// 16, 32 and 64 are instantiated as they are; every other dh runs the
// instantiation padded to 128 (PAD, BF16_PAD_DH) with the true dh at run
// time, as the tiled kernels do (flash_attention.cu, "Head dims"): staged
// rows zero-filled past dh (the dk/dv kernel's scaled q tile by its plain
// stores), the products over all of DH, stores stopping at dh, and a padded
// dk/dv block holding 64 of dh's columns (ceil(dh / 64) blocks a key tile,
// each recomputing the scores), so that its accumulators fit beside the
// warp's k and v rows. At vit-s's width in 3 heads of 128 the bytes bound
// them as at 6 heads of 64 (the same H*dh; PERF.md).

// --- bf16 forward ------------------------------------------------------------
// kanvit's bf16 policy (flash_attention.py:482-495, _small_probs :328-341):
// q scaled in bf16 by the scale rounded to bf16 (1/8 at dh 64 is exact,
// 1/sqrt(32) and 1/sqrt(8) are not: the wrapper rounds it), the scores and
// the softmax in f32 over the whole row (m = max(row max, -1e30), p =
// exp(s - m), l = max(sum of the f32 p, 1e-10)), the PV product on p rounded
// to bf16, and o = bf16(pv * (1 / l)). Each product is bf16 mma.sync.m16n8k16
// with f32 accumulation (attention_tc.cuh). The f32 kernel's online softmax
// would round each tile's p against a running max, other bits than the
// policy's; so the block streams the keys twice: the first pass takes each
// row's max over the scores, the second recomputes the same scores (the
// same products in the same order: the same bits) and takes p against that
// max. The first pass stages K alone. With stats, each row's (m, l) is
// written for the backward: the bits its own recomputation would give.
//
// The grid, the warps' rows and the 32-key tiles are the f32 kernel's. A
// warp keeps its 16 scaled q rows as A fragments (KD 16-deep steps over dh;
// at dh 8 one step, its upper half zero). K tiles feed the score product's
// B by ldmatrix (a K row is a B column), V tiles the PV product's by
// ldmatrix.trans; the score C fragments of keys 16m .. 16m+15 are, packed
// to bf16, the PV product's A fragment (attention_tc.cuh). Staged rows have
// a pitch of dh + 8 bf16, which puts ldmatrix's eight 16-byte rows on
// distinct banks at dh 16, 32 and 64.
//
// What bounds it at vit-s: the bytes, 38.7 MB of q, k, v and o (0.0116 ms
// at 3.35 TB/s; the two products' 3.8 GFLOP take 0.0039 at 989 TFLOP/s
// bf16). It runs at 0.0569 ms of device time against SDPA bf16's 0.0250
// (PERF.md, the H100 80GB HBM3 at 700 W): the second pass over the keys,
// and a block of 4 warps for 64 query rows of one head re-stages K and V
// for every 64 rows.
template <int DH, bool PAD = false>
__global__ void __launch_bounds__(32 * TC_WARPS)
attention_lanes_fwd_bf16(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         long long q_sb, long long q_st, long long q_sh,
                         long long k_sb, long long k_st, long long k_sh,
                         long long v_sb, long long v_st, long long v_sh,
                         const uint8_t* __restrict__ mask,
                         __nv_bfloat16* __restrict__ o, float* __restrict__ stats,
                         int t_len, int heads, int causal, float scale, int dh_run) {
  constexpr int P = DH + 8;          // staged row pitch, bf16
  constexpr int KD = (DH + 15) / 16;  // 16-deep steps over dh
  constexpr int ND = DH / 8;          // n8 tiles of o over dh
  const int dh = PAD ? dh_run : DH;
  __shared__ __align__(16) __nv_bfloat16 ks[2][TC_TILE][P];
  __shared__ __align__(16) __nv_bfloat16 vs[2][TC_TILE][P];
  __shared__ int kvalid[2][TC_TILE];

  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * TC_ROWS;
  const int r0 = q0 + (tid >> 5) * 16;  // the warp's first row
  const bool active = r0 < t_len;
  const int last = min(r0 + 15, t_len - 1);  // the warp's last live row
  const int ra = r0 + g, rb = r0 + g + 8;

  // The warp's q rows, scaled in bf16 (0 past t_len), as A fragments.
  uint32_t qa[KD][4];
  bf16_a_rows<DH>(q + b * q_sb + (long long)min(ra, t_len - 1) * q_st + h * q_sh,
                  q + b * q_sb + (long long)min(rb, t_len - 1) * q_st + h * q_sh,
                  ra < t_len ? scale : 0.f, rb < t_len ? scale : 0.f, t, qa, dh);

  const __nv_bfloat16* kh = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vh = v + b * v_sb + h * v_sh;
  const int kend = causal ? min(t_len, q0 + TC_ROWS) : t_len;
  const int tiles = (kend + TC_TILE - 1) / TC_TILE;
  auto stage = [&](int tile, int buf, bool with_v) {
    stage_tile_bf16<DH, TC_TILE, PAD>(&ks[buf][0][0], kh, k_st, tile * TC_TILE, t_len, tid,
                                      dh);
    if (with_v)
      stage_tile_bf16<DH, TC_TILE, PAD>(&vs[buf][0][0], vh, v_st, tile * TC_TILE, t_len,
                                        tid, dh);
    cp_async_commit();
    if (tid < TC_TILE) {
      const int key = tile * TC_TILE + tid;
      kvalid[buf][tid] = key < t_len &&
                         (mask == nullptr || mask[(long long)b * t_len + key] != 0);
    }
  };
  // This tile's scores of the warp's rows, keys past the warp's reach -inf.
  auto scores = [&](int buf, int k0, int steps, float (&s)[TC_STEPS][4]) {
    bf16_rows_by_tile<DH>(qa, &ks[buf][0][0], steps, lane, s);
#pragma unroll
    for (int n = 0; n < TC_STEPS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = n * 8 + 2 * t + (c & 1);
        const bool ok = kvalid[buf][j] && (!causal || k0 + j <= (c < 2 ? ra : rb));
        s[n][c] = ok ? s[n][c] : -INFINITY;
      }
  };
  auto steps_of = [&](int k0) {
    return min(TC_STEPS, ((causal ? last + 1 : t_len) - k0 + 7) / 8);
  };

  // Pass 1: each row's max.
  float ma = MAX_CLAMP, mb = MAX_CLAMP;
  stage(0, 0, false);
  for (int it = 0; it < tiles; ++it) {
    const int buf = it & 1, k0 = it * TC_TILE;
    if (it + 1 < tiles) {
      stage(it + 1, buf ^ 1, false);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int steps = steps_of(k0);
    if (active && steps > 0) {
      float s[TC_STEPS][4];
      scores(buf, k0, steps, s);
#pragma unroll
      for (int n = 0; n < TC_STEPS; ++n) {
        ma = fmaxf(ma, fmaxf(s[n][0], s[n][1]));
        mb = fmaxf(mb, fmaxf(s[n][2], s[n][3]));
      }
    }
    __syncthreads();  // this buffer is restaged two tiles on
  }
  ma = quad_max(ma);
  mb = quad_max(mb);

  // Pass 2: p against the row max, its f32 sum, and P V.
  float acc[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float la = 0.f, lb = 0.f;
  stage(0, 0, true);
  for (int it = 0; it < tiles; ++it) {
    const int buf = it & 1, k0 = it * TC_TILE;
    if (it + 1 < tiles) {
      stage(it + 1, buf ^ 1, true);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int steps = steps_of(k0);
    if (active && steps > 0) {
      float s[TC_STEPS][4];
      scores(buf, k0, steps, s);
#pragma unroll
      for (int n = 0; n < TC_STEPS; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[n][c] = expf(s[n][c] - (c < 2 ? ma : mb));  // exactly 0 for a masked key
          if (c < 2) la += s[n][c];
          else lb += s[n][c];
        }
      bf16_c_by_tile<DH>(s, &vs[buf][0][0], steps, lane, acc);
    }
    __syncthreads();  // this buffer is restaged two tiles on
  }

  la = quad_sum(la);
  lb = quad_sum(lb);
  const float rla = 1.f / fmaxf(la, EPSILON), rlb = 1.f / fmaxf(lb, EPSILON);
  const long long srow = ((long long)b * heads + h) * t_len;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? rb : ra;
    if (!active || row >= t_len) continue;
    const float rl = half ? rlb : rla;
    __nv_bfloat16* op = o + (((long long)b * t_len + row) * heads + h) * dh + 2 * t;
#pragma unroll
    for (int d = 0; d < ND; ++d)
      if (d * 8 < dh)
        store_bf16_pair(op + d * 8, acc[d][2 * half] * rl, acc[d][2 * half + 1] * rl);
    if (stats != nullptr && t == 0) {
      stats[(srow + row) * 2] = half ? mb : ma;
      stats[(srow + row) * 2 + 1] = half ? lb : la;
    }
  }
}

// --- bf16 backward ------------------------------------------------------------
// kanvit's bf16 lanes backward (_lanes_bwd, pallas_call at
// flash_attention.py:604, body _lanes_bwd_kernel :498-535) on bf16 q, k, v,
// o and do, per head:
//   qs = bf16(q * bf16(dh^-1/2)); s = qs k^T in f32, masked; p = exp(s - m)
//   against the forward's row max m, pn = p * (1 / max(l, 1e-10)) in f32;
//   dv = bf16(pn)^T do (f32 accumulation, rounded once);
//   delta = sum(f32(do) * f32(o)) over dh; dp = do v^T in f32;
//   dsc = bf16(pn * (dp - delta));
//   dq = bf16((dsc k) * dh^-1/2), this scale the f32 one, not bf16(dh^-1/2);
//   dk = bf16(dsc^T qs).
// The forward's (m, l) (written with stats) are the bits the backward's own
// recomputation of the scores gives (the same products in the same order),
// so both kernels read them. Two kernels, no atomics, so the bits repeat:
// the dq kernel (it writes delta) per 64 query rows streaming the keys,
// then the dk/dv kernel per 64 keys streaming the queries; their grids,
// warps and 32-row tiles are the forward's. Each product is bf16
// mma.sync.m16n8k16 with f32 accumulation:
//   dq    S = qs K^T, dP = do V^T   A qs, do rows (registers)    B K, V tiles (ldmatrix)
//         dQ += dsc K               A dsc from S's C fragments    B K tile (ldmatrix.trans)
//   dk/dv S^T = K qs^T, dP^T = V do^T  A K, V rows (registers)   B qs, do tiles (ldmatrix)
//         dV += pn^T do, dK += dsc^T qs  A from the C fragments  B do, qs tiles (.trans)
// The dk/dv kernel stages each q tile scaled and rounded to bf16 (qs) with
// plain loads, and the do tiles by cp.async.
//
// What bounds it at vit-s (batch 64, T 197, 6 heads of 64): the bytes, q,
// k, v, o and do read and dq, dk, dv written, 8 x 9.7 MB, 0.023 ms at 3.35
// TB/s; its seven products (the scores and dP in each kernel, dq, dk, dv)
// are 13.4 GFLOP, 0.0135 ms at 989 TFLOP/s bf16. Beside them, every score
// takes one expf, twice.
template <int DH, bool PAD = false>
__global__ void __launch_bounds__(32 * TC_WARPS)
attention_lanes_dq_bf16(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        long long q_sb, long long q_st, long long q_sh,
                        long long k_sb, long long k_st, long long k_sh,
                        long long v_sb, long long v_st, long long v_sh,
                        const uint8_t* __restrict__ mask,
                        const __nv_bfloat16* __restrict__ o,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ stats, float* __restrict__ delta_out,
                        __nv_bfloat16* __restrict__ dq, int t_len, int heads, int causal,
                        float qscale, float scale, int dh_run) {
  constexpr int P = DH + 8, KD = (DH + 15) / 16, ND = DH / 8;
  const int dh = PAD ? dh_run : DH;
  __shared__ __align__(16) __nv_bfloat16 ks[2][TC_TILE][P];
  __shared__ __align__(16) __nv_bfloat16 vs[2][TC_TILE][P];
  __shared__ int kvalid[2][TC_TILE];

  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * TC_ROWS;
  const int r0 = q0 + (tid >> 5) * 16;
  const bool active = r0 < t_len;
  const int last = min(r0 + 15, t_len - 1);
  const int ra = r0 + g, rb = r0 + g + 8;
  const bool la_ok = ra < t_len, lb_ok = rb < t_len;
  const long long srow = ((long long)b * heads + h) * t_len;  // of stats, delta
  const long long oa = (((long long)b * t_len + min(ra, t_len - 1)) * heads + h) * dh;
  const long long ob = (((long long)b * t_len + min(rb, t_len - 1)) * heads + h) * dh;

  // The warp's qs and do rows as A fragments; delta of rows ra and rb.
  uint32_t qa[KD][4], da[KD][4];
  bf16_a_rows<DH>(q + b * q_sb + (long long)min(ra, t_len - 1) * q_st + h * q_sh,
                  q + b * q_sb + (long long)min(rb, t_len - 1) * q_st + h * q_sh,
                  la_ok ? qscale : 0.f, lb_ok ? qscale : 0.f, t, qa, dh);
  bf16_a_rows<DH>(dout + oa, dout + ob, la_ok ? 1.f : 0.f, lb_ok ? 1.f : 0.f, t, da, dh);
  float dla = 0.f, dlb = 0.f;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    if (d * 8 >= dh) continue;
    const int c = d * 8 + 2 * t;
    const float2 da2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dout + oa + c));
    const float2 oa2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + oa + c));
    const float2 db2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dout + ob + c));
    const float2 ob2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + ob + c));
    dla = fmaf(da2.y, oa2.y, fmaf(da2.x, oa2.x, dla));
    dlb = fmaf(db2.y, ob2.y, fmaf(db2.x, ob2.x, dlb));
  }
  dla = quad_sum(dla);  // every lane shuffles; rows past t_len read row t_len-1
  dlb = quad_sum(dlb);
  const float ma = la_ok ? stats[(srow + ra) * 2] : 0.f;
  const float mb = lb_ok ? stats[(srow + rb) * 2] : 0.f;
  const float rla = la_ok ? 1.f / fmaxf(stats[(srow + ra) * 2 + 1], EPSILON) : 0.f;
  const float rlb = lb_ok ? 1.f / fmaxf(stats[(srow + rb) * 2 + 1], EPSILON) : 0.f;

  const __nv_bfloat16* kh = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vh = v + b * v_sb + h * v_sh;
  const int kend = causal ? min(t_len, q0 + TC_ROWS) : t_len;
  const int tiles = (kend + TC_TILE - 1) / TC_TILE;
  auto stage = [&](int tile, int buf) {
    stage_tile_bf16<DH, TC_TILE, PAD>(&ks[buf][0][0], kh, k_st, tile * TC_TILE, t_len, tid,
                                      dh);
    stage_tile_bf16<DH, TC_TILE, PAD>(&vs[buf][0][0], vh, v_st, tile * TC_TILE, t_len, tid,
                                      dh);
    cp_async_commit();
    if (tid < TC_TILE) {
      const int key = tile * TC_TILE + tid;
      kvalid[buf][tid] = key < t_len &&
                         (mask == nullptr || mask[(long long)b * t_len + key] != 0);
    }
  };

  float acc[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  stage(0, 0);
  for (int it = 0; it < tiles; ++it) {
    const int buf = it & 1, k0 = it * TC_TILE;
    if (it + 1 < tiles) {
      stage(it + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int steps = min(TC_STEPS, ((causal ? last + 1 : t_len) - k0 + 7) / 8);
    if (active && steps > 0) {
      float s[TC_STEPS][4], dp[TC_STEPS][4];
      bf16_rows_by_tile<DH>(qa, &ks[buf][0][0], steps, lane, s);
      bf16_rows_by_tile<DH>(da, &vs[buf][0][0], steps, lane, dp);
#pragma unroll
      for (int n = 0; n < TC_STEPS; ++n)  // s becomes dsc, in f32
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = n * 8 + 2 * t + (c & 1);
          const bool hi = c >= 2;
          const bool ok = (hi ? lb_ok : la_ok) && kvalid[buf][j] &&
                          (!causal || k0 + j <= (hi ? rb : ra));
          const float pn = ok ? expf(s[n][c] - (hi ? mb : ma)) * (hi ? rlb : rla) : 0.f;
          s[n][c] = pn * (dp[n][c] - (hi ? dlb : dla));
        }
      bf16_c_by_tile<DH>(s, &ks[buf][0][0], steps, lane, acc);
    }
    __syncthreads();  // this buffer is restaged two tiles on
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? rb : ra;
    if (!active || row >= t_len) continue;
    __nv_bfloat16* dqp = dq + (((long long)b * t_len + row) * heads + h) * dh + 2 * t;
#pragma unroll
    for (int d = 0; d < ND; ++d)
      if (d * 8 < dh)
        store_bf16_pair(dqp + d * 8, acc[d][2 * half] * scale, acc[d][2 * half + 1] * scale);
    if (t == 0) delta_out[srow + row] = half ? dlb : dla;
  }
}

// dk and dv. One block per (64 keys, head, batch); warp w owns keys
// k0 + 16w .. +15 and streams the queries, reading the forward's (m, l) and
// the dq kernel's delta. Padded, a block holds the dk and dv columns of one
// half of dh (BF16_DKV_SPLIT wide, the halves of a key tile neighbours in x).
template <int DH, bool PAD = false>
__global__ void __launch_bounds__(32 * TC_WARPS)
attention_lanes_dkv_bf16(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         long long q_sb, long long q_st, long long q_sh,
                         long long k_sb, long long k_st, long long k_sh,
                         long long v_sb, long long v_st, long long v_sh,
                         const uint8_t* __restrict__ mask,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ stats, const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                         int t_len, int heads, int causal, float qscale, int dh_run) {
  constexpr int P = DH + 8, KD = (DH + 15) / 16;
  constexpr int NA = PAD ? BF16_DKV_SPLIT / 8 : DH / 8;  // n8 tiles of dk, dv a block
  constexpr int NT = 32 * TC_WARPS;
  const int dh = PAD ? dh_run : DH;
  const int halves = PAD ? bf16_dkv_halves(dh) : 1;
  __shared__ __align__(16) __nv_bfloat16 qs[2][TC_TILE][P];  // q scaled, rounded to bf16
  __shared__ __align__(16) __nv_bfloat16 dos[2][TC_TILE][P];
  __shared__ float mrow[2][TC_TILE], rlrow[2][TC_TILE], drow[2][TC_TILE];

  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = (PAD ? blockIdx.x / halves : blockIdx.x) * TC_ROWS;
  const int d0 = PAD ? blockIdx.x % halves * NA : 0;  // the block's first n8 tile
  const int j0 = k0 + (tid >> 5) * 16;  // the warp's first key
  const bool active = j0 < t_len;
  const int ja = j0 + g, jb = j0 + g + 8;
  const bool va = ja < t_len && (mask == nullptr || mask[(long long)b * t_len + ja] != 0);
  const bool vb = jb < t_len && (mask == nullptr || mask[(long long)b * t_len + jb] != 0);
  const long long srow = ((long long)b * heads + h) * t_len;

  uint32_t ka[KD][4], vfa[KD][4];  // the warp's k and v rows
  bf16_a_rows<DH>(k + b * k_sb + (long long)min(ja, t_len - 1) * k_st + h * k_sh,
                  k + b * k_sb + (long long)min(jb, t_len - 1) * k_st + h * k_sh,
                  ja < t_len ? 1.f : 0.f, jb < t_len ? 1.f : 0.f, t, ka, dh);
  bf16_a_rows<DH>(v + b * v_sb + (long long)min(ja, t_len - 1) * v_st + h * v_sh,
                  v + b * v_sb + (long long)min(jb, t_len - 1) * v_st + h * v_sh,
                  ja < t_len ? 1.f : 0.f, jb < t_len ? 1.f : 0.f, t, vfa, dh);
  float dka[NA][4], dva[NA][4];
#pragma unroll
  for (int d = 0; d < NA; ++d)
#pragma unroll
    for (int c = 0; c < 4; ++c) dka[d][c] = dva[d][c] = 0.f;

  const __nv_bfloat16* qh = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* doh = dout + (long long)b * t_len * heads * dh + h * dh;
  // Causal: query i sees key j only for i >= j, so the tiles start at k0.
  const int i_start = causal ? k0 : 0;
  const int tiles = (t_len - i_start + TC_TILE - 1) / TC_TILE;
  auto stage = [&](int tile, int buf) {
    const int i0 = i_start + tile * TC_TILE;
    stage_tile_bf16<DH, TC_TILE, PAD>(&dos[buf][0][0], doh, (long long)heads * dh, i0, t_len,
                                      tid, dh);
    cp_async_commit();
    for (int e = tid; e < TC_TILE * DH / 2; e += NT) {  // zeros past dh
      const int r = e / (DH / 2), c = e % (DH / 2) * 2, qi = i0 + r;
      float2 x = make_float2(0.f, 0.f);
      if (qi < t_len && (!PAD || c < dh))
        x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qh + qi * q_st + c));
      store_bf16_pair(&qs[buf][r][c], x.x * qscale, x.y * qscale);
    }
    if (tid < TC_TILE) {
      const int qi = i0 + tid;
      const bool in = qi < t_len;
      mrow[buf][tid] = in ? stats[(srow + qi) * 2] : 0.f;
      rlrow[buf][tid] = in ? 1.f / fmaxf(stats[(srow + qi) * 2 + 1], EPSILON) : 0.f;
      drow[buf][tid] = in ? delta[srow + qi] : 0.f;
    }
  };
  stage(0, 0);
  for (int it = 0; it < tiles; ++it) {
    const int buf = it & 1, i0 = i_start + it * TC_TILE;
    if (it + 1 < tiles) {
      stage(it + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // 8-query steps this warp's keys may be seen from: below t_len and,
    // causal, ending at or after its first key.
    const int hi_step = min(TC_STEPS, (t_len - i0 + 7) / 8);
    const int lo_step = causal ? max(0, (j0 - i0) / 8) : 0;
    if (active && lo_step < hi_step) {
      float st[TC_STEPS][4], dpt[TC_STEPS][4];
      bf16_rows_by_tile<DH>(ka, &qs[buf][0][0], hi_step, lane, st);
      bf16_rows_by_tile<DH>(vfa, &dos[buf][0][0], hi_step, lane, dpt);
#pragma unroll
      for (int n = 0; n < TC_STEPS; ++n)  // st becomes pn^T, dpt dsc^T, in f32
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = n * 8 + 2 * t + (c & 1), qi = i0 + r;
          const bool hi = c >= 2;
          const bool ok = (hi ? vb : va) && qi < t_len && (!causal || (hi ? jb : ja) <= qi);
          const float pn = ok ? expf(st[n][c] - mrow[buf][r]) * rlrow[buf][r] : 0.f;
          dpt[n][c] = pn * (dpt[n][c] - drow[buf][r]);
          st[n][c] = pn;
        }
      bf16_c_by_tile<DH, TC_STEPS, NA>(st, &dos[buf][0][0], hi_step, lane, dva, d0);
      bf16_c_by_tile<DH, TC_STEPS, NA>(dpt, &qs[buf][0][0], hi_step, lane, dka, d0);
    }
    __syncthreads();  // this buffer is restaged two tiles on
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = half ? jb : ja;
    if (!active || key >= t_len) continue;
    const long long off = (((long long)b * t_len + key) * heads + h) * dh + 2 * t;
#pragma unroll
    for (int d = 0; d < NA; ++d) {
      const int c = (d0 + d) * 8;
      if (c >= dh) continue;
      store_bf16_pair(dk + off + c, dka[d][2 * half], dka[d][2 * half + 1]);
      store_bf16_pair(dv + off + c, dva[d][2 * half], dva[d][2 * half + 1]);
    }
  }
}

template <int DH, bool PAD>
int launch_fwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                    const __nv_bfloat16* v, long long q_sb, long long q_st,
                    long long q_sh, long long k_sb, long long k_st, long long k_sh,
                    long long v_sb, long long v_st, long long v_sh,
                    const uint8_t* mask, __nv_bfloat16* o, float* stats, int batch,
                    int t_len, int heads, int dh, int causal, float scale,
                    cudaStream_t stream) {
  const dim3 grid((t_len + TC_ROWS - 1) / TC_ROWS, heads, batch);
  attention_lanes_fwd_bf16<DH, PAD><<<grid, 32 * TC_WARPS, 0, stream>>>(
      q, k, v, q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, mask, o,
      stats, t_len, heads, causal, scale, dh);
  return (int)cudaGetLastError();
}

template <int DH, bool PAD>
int launch_bwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                    const __nv_bfloat16* v, long long q_sb, long long q_st,
                    long long q_sh, long long k_sb, long long k_st, long long k_sh,
                    long long v_sb, long long v_st, long long v_sh,
                    const uint8_t* mask, const __nv_bfloat16* o,
                    const __nv_bfloat16* dout, const float* stats, float* delta,
                    __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv, int batch,
                    int t_len, int heads, int dh, int causal, float qscale, float scale,
                    cudaStream_t stream) {
  const int tiles = (t_len + TC_ROWS - 1) / TC_ROWS;
  attention_lanes_dq_bf16<DH, PAD><<<dim3(tiles, heads, batch), 32 * TC_WARPS, 0, stream>>>(
      q, k, v, q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, mask, o, dout,
      stats, delta, dq, t_len, heads, causal, qscale, scale, dh);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  // a padded dh: bf16_dkv_halves(dh) blocks a key tile
  attention_lanes_dkv_bf16<DH, PAD><<<dim3(tiles * bf16_dkv_halves(dh), heads, batch),
                                      32 * TC_WARPS, 0, stream>>>(
      q, k, v, q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, mask, dout, stats,
      delta, dk, dv, t_len, heads, causal, qscale, dh);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_fwd(const float* q, const float* k, const float* v, long long q_sb,
               long long q_st, long long q_sh, long long k_sb, long long k_st,
               long long k_sh, long long v_sb, long long v_st, long long v_sh,
               const uint8_t* mask, float* o, float* stats, int batch,
               int t_len, int heads, int causal, float scale,
               cudaStream_t stream) {
  const dim3 grid((t_len + TC_ROWS - 1) / TC_ROWS, heads, batch);
  attention_lanes_fwd_tc<DH><<<grid, 32 * TC_WARPS, 0, stream>>>(
      q, k, v, q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, mask, o,
      stats, t_len, heads, causal, scale);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_bwd(const float* q, const float* k, const float* v, long long q_sb,
               long long q_st, long long q_sh, long long k_sb, long long k_st,
               long long k_sh, long long v_sb, long long v_st, long long v_sh,
               const uint8_t* mask, const float* o, const float* dout,
               const float* stats, float* delta, float* dq, float* dk,
               float* dv, int batch, int t_len, int heads, int causal,
               float scale, cudaStream_t stream) {
  const dim3 grid((t_len + TC_ROWS - 1) / TC_ROWS, heads, batch);
  // the block's rows and the double-buffered tiles
  const size_t smem = sizeof(float) * (2 * TC_ROWS + 4 * TC_TILE) * (DH + TC_PAD);
  int err = allow_shared(attention_lanes_dq_tc<DH>, smem);
  if (err == 0) err = allow_shared(attention_lanes_dkv_tc<DH>, smem);
  if (err != 0) return err;
  attention_lanes_dq_tc<DH><<<grid, 32 * TC_WARPS, smem, stream>>>(
      q, k, v, q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, mask, o,
      dout, stats, delta, dq, t_len, heads, causal, scale);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  attention_lanes_dkv_tc<DH><<<grid, 32 * TC_WARPS, smem, stream>>>(
      q, k, v, q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, mask,
      dout, stats, delta, dk, dv, t_len, heads, causal, scale);
  return (int)cudaGetLastError();
}

// --- generic head dims (attention_common.cuh): one thread a row on the CUDA
// cores, the head dim walked at run time in chunks of C; the q (and do) row
// re-read per staged tile, the accumulators in shared memory. The forward's
// arithmetic is that of the CUDA-core kernels that dh 8, 16, 32 and 64 ran
// before the tensor-core kernels above, in the same order.

constexpr int BQ = 64;   // query rows per block, one thread each
constexpr int BKV = 32;  // keys per staged tile
constexpr int BR = 64;   // rows per backward block
constexpr int BT = 32;   // rows per staged backward tile

constexpr int C = GENERIC_CHUNK;

// Forward. Dynamic shared memory (floats): ks, vs (BKV, dh), acc (dh, BQ).
__global__ void __launch_bounds__(BQ)
attention_lanes_fwd_generic(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            long long q_sb, long long q_st, long long q_sh,
                            long long k_sb, long long k_st, long long k_sh,
                            long long v_sb, long long v_st, long long v_sh,
                            const uint8_t* __restrict__ mask,
                            float* __restrict__ o, float* __restrict__ stats,
                            int t_len, int heads, int dh, int causal,
                            float scale) {
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;
  float* vs = ks + BKV * dh;
  float* acc = vs + BKV * dh;  // acc[d * BQ + tid]
  __shared__ int kvalid[BKV];

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int qi = q0 + tid;
  const bool live = qi < t_len;
  const float* qp = q + b * q_sb + (long long)(live ? qi : 0) * q_st + h * q_sh;
  for (int d = 0; d < dh; ++d) acc[d * BQ + tid] = 0.f;
  float m = MAX_CLAMP;
  float l = 0.f;

  const int kend = causal ? min(t_len, q0 + BQ) : t_len;
  for (int k0 = 0; k0 < kend; k0 += BKV) {
    __syncthreads();  // the previous tile is no longer read
    for (int e = tid; e < BKV * dh; e += BQ) {
      const int j = e / dh, d = e % dh, key = k0 + j;
      const bool in = key < t_len;
      ks[e] = in ? k[b * k_sb + key * k_st + h * k_sh + d] : 0.f;
      vs[e] = in ? v[b * v_sb + key * v_st + h * v_sh + d] : 0.f;
    }
    if (tid < BKV) {
      const int key = k0 + tid;
      kvalid[tid] = key < t_len &&
                    (mask == nullptr || mask[(long long)b * t_len + key] != 0);
    }
    __syncthreads();

    float s[BKV];
#pragma unroll
    for (int j = 0; j < BKV; ++j) s[j] = 0.f;
    for (int c = 0; c < dh; c += C) {
      float qc[C];
#pragma unroll
      for (int u = 0; u < C; ++u) qc[u] = live ? qp[c + u] * scale : 0.f;
#pragma unroll
      for (int j = 0; j < BKV; ++j)
#pragma unroll
        for (int u = 0; u < C; ++u) s[j] = fmaf(qc[u], ks[j * dh + c + u], s[j]);
    }
    float mt = m;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      const bool ok = kvalid[j] && (!causal || k0 + j <= qi);
      s[j] = ok ? s[j] : -INFINITY;
      mt = fmaxf(mt, s[j]);
    }
    const float corr = expf(m - mt);
    l *= corr;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      s[j] = expf(s[j] - mt);  // p: exactly 0 for a masked key
      l += s[j];
    }
    for (int c = 0; c < dh; c += C) {
      float a[C];
#pragma unroll
      for (int u = 0; u < C; ++u) a[u] = acc[(c + u) * BQ + tid] * corr;
#pragma unroll
      for (int j = 0; j < BKV; ++j)
#pragma unroll
        for (int u = 0; u < C; ++u) a[u] = fmaf(s[j], vs[j * dh + c + u], a[u]);
#pragma unroll
      for (int u = 0; u < C; ++u) acc[(c + u) * BQ + tid] = a[u];
    }
    m = mt;
  }

  if (live) {
    const float rl = 1.f / fmaxf(l, EPSILON);
    float* op = o + (((long long)b * t_len + qi) * heads + h) * dh;
    for (int d = 0; d < dh; ++d) op[d] = acc[d * BQ + tid] * rl;
    if (stats != nullptr) {
      float* sp = stats + (((long long)b * heads + h) * t_len + qi) * 2;
      sp[0] = m;
      sp[1] = l;
    }
  }
}

// dq and delta, one thread a query row. Dynamic shared memory (floats):
// ks, vs (BT, dh), dq (dh, BR).
__global__ void __launch_bounds__(BR)
attention_lanes_dq_generic(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           long long q_sb, long long q_st, long long q_sh,
                           long long k_sb, long long k_st, long long k_sh,
                           long long v_sb, long long v_st, long long v_sh,
                           const uint8_t* __restrict__ mask,
                           const float* __restrict__ o,
                           const float* __restrict__ dout,
                           const float* __restrict__ stats,
                           float* __restrict__ delta_out,
                           float* __restrict__ dq, int t_len, int heads, int dh,
                           int causal, float scale) {
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;
  float* vs = ks + BT * dh;
  float* acc = vs + BT * dh;  // acc[d * BR + tid]
  __shared__ int kvalid[BT];

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int qi = q0 + tid;
  const bool live = qi < t_len;
  const long long row = ((long long)b * t_len + (live ? qi : 0)) * heads + h;
  const float* qp = q + b * q_sb + (long long)(live ? qi : 0) * q_st + h * q_sh;
  const float* dp = dout + row * dh;
  float dlt = 0.f, m = 0.f, rl = 0.f;
  if (live) {
    const float* op = o + row * dh;
    for (int d = 0; d < dh; ++d) dlt = fmaf(dp[d], op[d], dlt);
    const float* sp = stats + (((long long)b * heads + h) * t_len + qi) * 2;
    m = sp[0];
    rl = 1.f / fmaxf(sp[1], EPSILON);
  }
  for (int d = 0; d < dh; ++d) acc[d * BR + tid] = 0.f;

  const int kend = causal ? min(t_len, q0 + BR) : t_len;
  for (int k0 = 0; k0 < kend; k0 += BT) {
    __syncthreads();  // the previous tile is no longer read
    for (int e = tid; e < BT * dh; e += BR) {
      const int j = e / dh, d = e % dh, key = k0 + j;
      const bool in = key < t_len;
      ks[e] = in ? k[b * k_sb + key * k_st + h * k_sh + d] : 0.f;
      vs[e] = in ? v[b * v_sb + key * v_st + h * v_sh + d] : 0.f;
    }
    if (tid < BT) {
      const int key = k0 + tid;
      kvalid[tid] = key < t_len &&
                    (mask == nullptr || mask[(long long)b * t_len + key] != 0);
    }
    __syncthreads();

    float s[BT], dpv[BT];
#pragma unroll
    for (int j = 0; j < BT; ++j) s[j] = dpv[j] = 0.f;
    for (int c = 0; c < dh; c += C) {
      float qc[C], dc[C];
#pragma unroll
      for (int u = 0; u < C; ++u) {
        qc[u] = live ? qp[c + u] * scale : 0.f;
        dc[u] = live ? dp[c + u] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < BT; ++j)
#pragma unroll
        for (int u = 0; u < C; ++u) {
          s[j] = fmaf(qc[u], ks[j * dh + c + u], s[j]);
          dpv[j] = fmaf(dc[u], vs[j * dh + c + u], dpv[j]);
        }
    }
#pragma unroll
    for (int j = 0; j < BT; ++j) {  // s[j] becomes ds
      const bool ok = live && kvalid[j] && (!causal || k0 + j <= qi);
      const float p = ok ? expf(s[j] - m) * rl : 0.f;
      s[j] = p * (dpv[j] - dlt);
    }
    for (int c = 0; c < dh; c += C) {
      float a[C];
#pragma unroll
      for (int u = 0; u < C; ++u) a[u] = acc[(c + u) * BR + tid];
#pragma unroll
      for (int j = 0; j < BT; ++j)
#pragma unroll
        for (int u = 0; u < C; ++u) a[u] = fmaf(s[j], ks[j * dh + c + u], a[u]);
#pragma unroll
      for (int u = 0; u < C; ++u) acc[(c + u) * BR + tid] = a[u];
    }
  }

  if (live) {
    float* dqp = dq + row * dh;
    for (int d = 0; d < dh; ++d) dqp[d] = acc[d * BR + tid] * scale;
    delta_out[((long long)b * heads + h) * t_len + qi] = dlt;
  }
}

// dk and dv, one thread a key. Dynamic shared memory (floats): qs (q *
// scale), dos (BT, dh), dk, dv (dh, BR).
__global__ void __launch_bounds__(BR)
attention_lanes_dkv_generic(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            long long q_sb, long long q_st, long long q_sh,
                            long long k_sb, long long k_st, long long k_sh,
                            long long v_sb, long long v_st, long long v_sh,
                            const uint8_t* __restrict__ mask,
                            const float* __restrict__ dout,
                            const float* __restrict__ stats,
                            const float* __restrict__ delta,
                            float* __restrict__ dk, float* __restrict__ dv,
                            int t_len, int heads, int dh, int causal,
                            float scale) {
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;
  float* dos = qs + BT * dh;
  float* dka = dos + BT * dh;   // dka[d * BR + tid]
  float* dva = dka + dh * BR;
  __shared__ float mrow[BT], rlrow[BT], drow[BT];

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kj = k0 + tid;
  const bool live = kj < t_len;
  const bool valid =
      live && (mask == nullptr || mask[(long long)b * t_len + kj] != 0);
  const long long srow = ((long long)b * heads + h) * t_len;  // of stats, delta
  const float* kp = k + b * k_sb + (long long)(live ? kj : 0) * k_st + h * k_sh;
  const float* vp = v + b * v_sb + (long long)(live ? kj : 0) * v_st + h * v_sh;
  for (int d = 0; d < dh; ++d) dka[d * BR + tid] = dva[d * BR + tid] = 0.f;

  // Causal: query i sees key j only for i >= j, so the tile starts at k0.
  for (int i0 = causal ? k0 : 0; i0 < t_len; i0 += BT) {
    __syncthreads();  // the previous tile is no longer read
    for (int e = tid; e < BT * dh; e += BR) {
      const int r = e / dh, d = e % dh, qi = i0 + r;
      const bool in = qi < t_len;
      qs[e] = in ? q[b * q_sb + qi * q_st + h * q_sh + d] * scale : 0.f;
      dos[e] = in ? dout[(((long long)b * t_len + qi) * heads + h) * dh + d] : 0.f;
    }
    if (tid < BT) {
      const int qi = i0 + tid;
      const bool in = qi < t_len;
      mrow[tid] = in ? stats[(srow + qi) * 2] : 0.f;
      rlrow[tid] = in ? 1.f / fmaxf(stats[(srow + qi) * 2 + 1], EPSILON) : 0.f;
      drow[tid] = in ? delta[srow + qi] : 0.f;
    }
    __syncthreads();

    float s[BT], dpv[BT];
#pragma unroll
    for (int r = 0; r < BT; ++r) s[r] = dpv[r] = 0.f;
    for (int c = 0; c < dh; c += C) {
      float kc[C], vc[C];
#pragma unroll
      for (int u = 0; u < C; ++u) {
        kc[u] = live ? kp[c + u] : 0.f;
        vc[u] = live ? vp[c + u] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < BT; ++r)
#pragma unroll
        for (int u = 0; u < C; ++u) {
          s[r] = fmaf(qs[r * dh + c + u], kc[u], s[r]);
          dpv[r] = fmaf(dos[r * dh + c + u], vc[u], dpv[r]);
        }
    }
#pragma unroll
    for (int r = 0; r < BT; ++r) {  // s[r] becomes p, dpv[r] ds
      const int qi = i0 + r;
      const bool ok = valid && qi < t_len && (!causal || kj <= qi);
      const float p = ok ? expf(s[r] - mrow[r]) * rlrow[r] : 0.f;
      dpv[r] = p * (dpv[r] - drow[r]);
      s[r] = p;
    }
    for (int c = 0; c < dh; c += C) {
      float av[C], ak[C];
#pragma unroll
      for (int u = 0; u < C; ++u) {
        av[u] = dva[(c + u) * BR + tid];
        ak[u] = dka[(c + u) * BR + tid];
      }
#pragma unroll
      for (int r = 0; r < BT; ++r)
#pragma unroll
        for (int u = 0; u < C; ++u) {
          av[u] = fmaf(s[r], dos[r * dh + c + u], av[u]);
          ak[u] = fmaf(dpv[r], qs[r * dh + c + u], ak[u]);  // qs carries the scale
        }
#pragma unroll
      for (int u = 0; u < C; ++u) {
        dva[(c + u) * BR + tid] = av[u];
        dka[(c + u) * BR + tid] = ak[u];
      }
    }
  }

  if (live) {
    const long long off = (((long long)b * t_len + kj) * heads + h) * dh;
    for (int d = 0; d < dh; ++d) {
      dk[off + d] = dka[d * BR + tid];
      dv[off + d] = dva[d * BR + tid];
    }
  }
}

int launch_fwd_generic(const float* q, const float* k, const float* v,
                       long long q_sb, long long q_st, long long q_sh,
                       long long k_sb, long long k_st, long long k_sh,
                       long long v_sb, long long v_st, long long v_sh,
                       const uint8_t* mask, float* o, float* stats, int batch,
                       int t_len, int heads, int dh, int causal, float scale,
                       cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * BKV + BQ) * dh;
  const int err = allow_shared(attention_lanes_fwd_generic, smem);
  if (err != 0) return err;
  const dim3 grid((t_len + BQ - 1) / BQ, heads, batch);
  attention_lanes_fwd_generic<<<grid, BQ, smem, stream>>>(
      q, k, v, q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, mask, o,
      stats, t_len, heads, dh, causal, scale);
  return (int)cudaGetLastError();
}

int launch_bwd_generic(const float* q, const float* k, const float* v,
                       long long q_sb, long long q_st, long long q_sh,
                       long long k_sb, long long k_st, long long k_sh,
                       long long v_sb, long long v_st, long long v_sh,
                       const uint8_t* mask, const float* o, const float* dout,
                       const float* stats, float* delta, float* dq, float* dk,
                       float* dv, int batch, int t_len, int heads, int dh,
                       int causal, float scale, cudaStream_t stream) {
  const size_t dq_smem = sizeof(float) * (2 * BT + BR) * dh;
  const size_t dkv_smem = sizeof(float) * (2 * BT + 2 * BR) * dh;
  int err = allow_shared(attention_lanes_dq_generic, dq_smem);
  if (err == 0) err = allow_shared(attention_lanes_dkv_generic, dkv_smem);
  if (err != 0) return err;
  const dim3 grid((t_len + BR - 1) / BR, heads, batch);
  attention_lanes_dq_generic<<<grid, BR, dq_smem, stream>>>(
      q, k, v, q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, mask, o,
      dout, stats, delta, dq, t_len, heads, dh, causal, scale);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  attention_lanes_dkv_generic<<<grid, BR, dkv_smem, stream>>>(
      q, k, v, q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, mask,
      dout, stats, delta, dk, dv, t_len, heads, dh, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: f32, element (b, t, h, d) at b*sb + t*st + h*sh + d (strides in
// elements); mask: (batch, t_len) uint8 (nonzero = attend) or null;
// o: (batch, t_len, heads*dh) f32 contiguous; stats: (batch, heads, t_len, 2)
// f32, each row's (max, sum) for the backward, or null. dh is a multiple of 8
// from 8 through 128 (attention_common.cuh); at dh 8, 16, 32 and 64 (the
// tensor-core kernels) q, k and v must be 16-byte aligned with strides that
// are multiples of 4, else cudaErrorMisalignedAddress. Launches on `stream`
// and returns cudaGetLastError() (0 on success).
extern "C" int kanvit_attention_lanes_fwd(
    const float* q, const float* k, const float* v, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh,
    const uint8_t* mask, float* o, float* stats, int batch, int t_len,
    int heads, int dh, int causal, float scale, void* stream) {
  if (batch <= 0 || t_len <= 0 || heads <= 0 || batch > 65535 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (tc_head_dim(dh) && !rows_aligned(q, k, v, q_sb, q_st, q_sh, k_sb, k_st,
                                       k_sh, v_sb, v_st, v_sh))
    return (int)cudaErrorMisalignedAddress;
#define KANVIT_FWD(D)                                                       \
  launch_fwd<D>(q, k, v, q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st,   \
                v_sh, mask, o, stats, batch, t_len, heads, causal, scale, st)
  switch (dh) {
    case 8: return KANVIT_FWD(8);
    case 16: return KANVIT_FWD(16);
    case 32: return KANVIT_FWD(32);
    case 64: return KANVIT_FWD(64);
    default: break;
  }
#undef KANVIT_FWD
  if (!generic_head_dim(dh)) return (int)cudaErrorInvalidValue;
  return launch_fwd_generic(q, k, v, q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb,
                            v_st, v_sh, mask, o, stats, batch, t_len, heads, dh,
                            causal, scale, st);
}

// Backward of kanvit_attention_lanes_fwd. q, k, v, mask as there; o: the
// forward's output and dout its gradient, (batch, t_len, heads*dh) f32
// contiguous; stats: the forward's (batch, heads, t_len, 2); delta: scratch
// of batch*heads*t_len floats; dq, dk, dv: (batch, t_len, heads*dh) f32
// contiguous (dout 16-byte aligned at the tensor-core head dims). Launches
// the dq kernel, then the dk/dv kernel, on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int kanvit_attention_lanes_bwd(
    const float* q, const float* k, const float* v, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh,
    const uint8_t* mask, const float* o, const float* dout,
    const float* stats, float* delta, float* dq, float* dk, float* dv,
    int batch, int t_len, int heads, int dh, int causal, float scale,
    void* stream) {
  if (batch <= 0 || t_len <= 0 || heads <= 0 || batch > 65535 ||
      heads > 65535 || stats == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (tc_head_dim(dh) && (!rows_aligned(q, k, v, q_sb, q_st, q_sh, k_sb, k_st,
                                        k_sh, v_sb, v_st, v_sh) ||
                          (uintptr_t)dout % 16 != 0))
    return (int)cudaErrorMisalignedAddress;
#define KANVIT_BWD(D)                                                       \
  launch_bwd<D>(q, k, v, q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st,   \
                v_sh, mask, o, dout, stats, delta, dq, dk, dv, batch, t_len, \
                heads, causal, scale, st)
  switch (dh) {
    case 8: return KANVIT_BWD(8);
    case 16: return KANVIT_BWD(16);
    case 32: return KANVIT_BWD(32);
    case 64: return KANVIT_BWD(64);
    default: break;
  }
#undef KANVIT_BWD
  if (!generic_head_dim(dh)) return (int)cudaErrorInvalidValue;
  return launch_bwd_generic(q, k, v, q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb,
                            v_st, v_sh, mask, o, dout, stats, delta, dq, dk, dv,
                            batch, t_len, heads, dh, causal, scale, st);
}

// The bf16 forward (kanvit's bf16 lanes kernel). q, k, v: bf16, strided as
// kanvit_attention_lanes_fwd's; o: (batch, t_len, heads*dh) bf16
// contiguous; stats: (batch, heads, t_len, 2) f32, each row's (max, sum)
// for the backward, or null; scale: dh^-1/2 rounded to bf16. dh a multiple
// of 8 from 8 through 128 (8, 16, 32 and 64 each on an instantiation of its
// own, the rest padded to BF16_PAD_DH), else cudaErrorInvalidValue; q, k
// and v 16-byte aligned with strides that are multiples of 8, else
// cudaErrorMisalignedAddress.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int kanvit_attention_lanes_fwd_bf16(
    const void* q, const void* k, const void* v, long long q_sb, long long q_st,
    long long q_sh, long long k_sb, long long k_st, long long k_sh, long long v_sb,
    long long v_st, long long v_sh, const uint8_t* mask, void* o, float* stats, int batch,
    int t_len, int heads, int dh, int causal, float scale, void* stream) {
  if (batch <= 0 || t_len <= 0 || heads <= 0 || batch > 65535 || heads > 65535 ||
      !generic_head_dim(dh))
    return (int)cudaErrorInvalidValue;
  const uintptr_t ptrs = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v;
  const long long strides =
      q_sb | q_st | q_sh | k_sb | k_st | k_sh | v_sb | v_st | v_sh;
  if (ptrs % 16 != 0 || strides % 8 != 0) return (int)cudaErrorMisalignedAddress;
  using bf = __nv_bfloat16;
  const bf *qb = static_cast<const bf*>(q), *kb = static_cast<const bf*>(k),
           *vb = static_cast<const bf*>(v);
  bf* ob = static_cast<bf*>(o);
  const cudaStream_t st = (cudaStream_t)stream;
#define KANVIT_FWD_BF16(D, PAD)                                               \
  launch_fwd_bf16<D, PAD>(qb, kb, vb, q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, \
                          v_st, v_sh, mask, ob, stats, batch, t_len, heads, dh, \
                          causal, scale, st)
  switch (dh) {
    case 8: return KANVIT_FWD_BF16(8, false);
    case 16: return KANVIT_FWD_BF16(16, false);
    case 32: return KANVIT_FWD_BF16(32, false);
    case 64: return KANVIT_FWD_BF16(64, false);
    default: return KANVIT_FWD_BF16(BF16_PAD_DH, true);
  }
#undef KANVIT_FWD_BF16
}

// The bf16 backward of kanvit_attention_lanes_fwd_bf16 (kanvit's bf16 lanes
// backward). q, k, v, mask as there; o: the forward's output and dout its
// gradient, (batch, t_len, heads*dh) bf16 contiguous, 16-byte aligned;
// stats: the forward's (batch, heads, t_len, 2); delta: f32 scratch of
// batch*heads*t_len floats; dq, dk, dv: (batch, t_len, heads*dh) bf16
// contiguous; qscale: dh^-1/2 rounded to bf16 (q's scale), scale: dh^-1/2
// in f32 (dq's). Launches the dq kernel, then the dk/dv kernel, on `stream`
// and returns cudaGetLastError() (0 on success).
extern "C" int kanvit_attention_lanes_bwd_bf16(
    const void* q, const void* k, const void* v, long long q_sb, long long q_st,
    long long q_sh, long long k_sb, long long k_st, long long k_sh, long long v_sb,
    long long v_st, long long v_sh, const uint8_t* mask, const void* o, const void* dout,
    const float* stats, float* delta, void* dq, void* dk, void* dv, int batch, int t_len,
    int heads, int dh, int causal, float qscale, float scale, void* stream) {
  if (batch <= 0 || t_len <= 0 || heads <= 0 || batch > 65535 || heads > 65535 ||
      !generic_head_dim(dh) || stats == nullptr || delta == nullptr)
    return (int)cudaErrorInvalidValue;
  const uintptr_t ptrs = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o |
                         (uintptr_t)dout;
  const long long strides =
      q_sb | q_st | q_sh | k_sb | k_st | k_sh | v_sb | v_st | v_sh;
  if (ptrs % 16 != 0 || strides % 8 != 0) return (int)cudaErrorMisalignedAddress;
  using bf = __nv_bfloat16;
  const bf *qb = static_cast<const bf*>(q), *kb = static_cast<const bf*>(k),
           *vb = static_cast<const bf*>(v), *obf = static_cast<const bf*>(o),
           *db = static_cast<const bf*>(dout);
  bf *dqb = static_cast<bf*>(dq), *dkb = static_cast<bf*>(dk), *dvb = static_cast<bf*>(dv);
  const cudaStream_t st = (cudaStream_t)stream;
#define KANVIT_BWD_BF16(D, PAD)                                                      \
  launch_bwd_bf16<D, PAD>(qb, kb, vb, q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st,  \
                          v_sh, mask, obf, db, stats, delta, dqb, dkb, dvb, batch,     \
                          t_len, heads, dh, causal, qscale, scale, st)
  switch (dh) {
    case 8: return KANVIT_BWD_BF16(8, false);
    case 16: return KANVIT_BWD_BF16(16, false);
    case 32: return KANVIT_BWD_BF16(32, false);
    case 64: return KANVIT_BWD_BF16(64, false);
    default: return KANVIT_BWD_BF16(BF16_PAD_DH, true);
  }
#undef KANVIT_BWD_BF16
}
