// Attention over head-concatenated (B, T, H*dh) tensors, forward and
// backward.
//
// Replaces the TPU kernels of kanvit/kernels/flash_attention.py:
//   forward:  _lanes_fwd_impl (pallas_call at :571), reached from
//             _flash_lanes (:547) and flash_attention_lanes (:647);
//   backward: _lanes_bwd (pallas_call at :604, body _lanes_bwd_kernel
//             :498-534), _flash_lanes' VJP.
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
// against ~0.2 GB of q, k, v, o, do and gradients. Both are bound by
// arithmetic and by the exp of every score; the TPU kernel was bound by its
// exp throughput too.
//
// Forward: one block per (query tile of BQ rows, head, batch), one thread per
// query row. The thread keeps its scaled q row and its output accumulator in
// registers and streams the keys in tiles of BKV that the block stages in
// shared memory (K and V tiles: 2*BKV*dh*4 bytes, 16 KB at dh = 64, far
// under the 48 KB static limit at any T). An online softmax keeps the
// running max m (starting at the -1e30 clamp) and the running sum l; a masked
// key gets a score of -inf and so a probability of exactly 0. Causal blocks
// stop at their last query's key. When asked, the forward writes each row's
// (m, l), which the backward reads instead of recomputing them: kept as two
// numbers, as kanvit keeps them, so a fully masked row (m = -1e30, l = 0)
// gives p = 0 and gradients of exactly 0.
//
// Backward: dk and dv sum over every query row, dq over every key. K, V, dK
// and dV of one (b, h) would take 4*197*64*4 B = 202 KB, near the 227 KB of
// shared memory, so the backward is two kernels, as the TPU's tiled
// _flash_bwd (:806, :831) is: a dq kernel per query tile that streams the
// keys (and writes delta), then a dk/dv kernel per key tile that streams the
// queries. Each keeps its rows in registers, two threads per row with half
// the head dims each (a row's dot products meet with one warp shuffle), so a
// thread holds 3 (dq) or 4 (dk/dv) half rows. Both are deterministic: no
// atomics. All math is f32 on the CUDA cores; tensor-core products (mma /
// wgmma) are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

constexpr int BQ = 64;   // query rows per block, one thread each
constexpr int BKV = 32;  // keys per staged tile
constexpr int BR = 64;   // rows per backward block, two threads each
constexpr int BT = 32;   // rows per staged backward tile
constexpr float EPSILON = 1e-10f;
constexpr float MAX_CLAMP = -1e30f;

template <int DH>
__global__ void __launch_bounds__(BQ)
attention_lanes_fwd_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           long long q_sb, long long q_st, long long q_sh,
                           long long k_sb, long long k_st, long long k_sh,
                           long long v_sb, long long v_st, long long v_sh,
                           const uint8_t* __restrict__ mask,
                           float* __restrict__ o, float* __restrict__ stats,
                           int t_len, int heads, int causal, float scale) {
  __shared__ float ks[BKV][DH];
  __shared__ float vs[BKV][DH];
  __shared__ int kvalid[BKV];

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int qi = q0 + tid;
  const bool live = qi < t_len;

  float qr[DH], acc[DH];
  if (live) {
    const float* qp = q + b * q_sb + qi * q_st + h * q_sh;
#pragma unroll
    for (int d = 0; d < DH; ++d) qr[d] = qp[d] * scale;
  } else {
#pragma unroll
    for (int d = 0; d < DH; ++d) qr[d] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  float m = MAX_CLAMP;
  float l = 0.f;

  const int kend = causal ? min(t_len, q0 + BQ) : t_len;
  for (int k0 = 0; k0 < kend; k0 += BKV) {
    __syncthreads();  // the previous tile is no longer read
    for (int e = tid; e < BKV * DH; e += BQ) {
      const int j = e / DH, d = e % DH, key = k0 + j;
      const bool in = key < t_len;
      ks[j][d] = in ? k[b * k_sb + key * k_st + h * k_sh + d] : 0.f;
      vs[j][d] = in ? v[b * v_sb + key * v_st + h * v_sh + d] : 0.f;
    }
    if (tid < BKV) {
      const int key = k0 + tid;
      kvalid[tid] = key < t_len &&
                    (mask == nullptr || mask[(long long)b * t_len + key] != 0);
    }
    __syncthreads();

    float s[BKV];
    float mt = m;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) dot = fmaf(qr[d], ks[j][d], dot);
      const bool ok = kvalid[j] && (!causal || k0 + j <= qi);
      s[j] = ok ? dot : -INFINITY;
      mt = fmaxf(mt, s[j]);
    }
    const float corr = expf(m - mt);
    l *= corr;
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      const float p = expf(s[j] - mt);  // exactly 0 for a masked key
      l += p;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = fmaf(p, vs[j][d], acc[d]);
    }
    m = mt;
  }

  if (live) {
    const float rl = 1.f / fmaxf(l, EPSILON);
    float* op = o + (((long long)b * t_len + qi) * heads + h) * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) op[d] = acc[d] * rl;
    if (stats != nullptr) {
      float* sp = stats + (((long long)b * heads + h) * t_len + qi) * 2;
      sp[0] = m;
      sp[1] = l;
    }
  }
}

// dq and delta. One block per (query tile of BR rows, head, batch), two
// threads per query row.
template <int DH>
__global__ void __launch_bounds__(2 * BR)
attention_lanes_dq_kernel(const float* __restrict__ q,
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
  using TL = Tile<DH>;
  constexpr int HD = TL::HD;
  __shared__ __align__(16) float ks[BT][TL::PITCH];
  __shared__ __align__(16) float vs[BT][TL::PITCH];
  __shared__ int kvalid[BT];

  const int tid = threadIdx.x;
  const int half = tid & 1;
  const int q0 = blockIdx.x * BR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int qi = q0 + (tid >> 1);
  const bool live = qi < t_len;
  const long long row = ((long long)b * t_len + qi) * heads + h;  // of o, do, dq

  float qr[HD], dor[HD], acc[HD];
  float dlt = 0.f, m = 0.f, rl = 0.f;
  if (live) {
    const float* qp = q + b * q_sb + qi * q_st + h * q_sh + half * HD;
    const float* op = o + row * DH + half * HD;
    const float* dp = dout + row * DH + half * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      qr[d] = qp[d] * scale;
      dor[d] = dp[d];
      dlt = fmaf(dor[d], op[d], dlt);
    }
    const float* sp = stats + (((long long)b * heads + h) * t_len + qi) * 2;
    m = sp[0];
    rl = 1.f / fmaxf(sp[1], EPSILON);
  } else {
#pragma unroll
    for (int d = 0; d < HD; ++d) qr[d] = dor[d] = 0.f;
  }
  dlt = pair_sum(dlt);
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;

  const int kend = causal ? min(t_len, q0 + BR) : t_len;
  for (int k0 = 0; k0 < kend; k0 += BT) {
    __syncthreads();  // the previous tile is no longer read
    for (int e = tid; e < BT * DH; e += 2 * BR) {
      const int j = e / DH, d = e % DH, key = k0 + j;
      const bool in = key < t_len;
      const int c = TL::at(d / HD, d % HD);
      ks[j][c] = in ? k[b * k_sb + key * k_st + h * k_sh + d] : 0.f;
      vs[j][c] = in ? v[b * v_sb + key * v_st + h * v_sh + d] : 0.f;
    }
    if (tid < BT) {
      const int key = k0 + tid;
      kvalid[tid] = key < t_len &&
                    (mask == nullptr || mask[(long long)b * t_len + key] != 0);
    }
    __syncthreads();

    for (int j = 0; j < BT; ++j) {
      const float* kr = &ks[j][TL::at(half, 0)];
      const float* vr = &vs[j][TL::at(half, 0)];
      float s = 0.f, dpv = 0.f;
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        const float4 k4 = ld4(kr + d), v4 = ld4(vr + d);
        s = fmaf(qr[d], k4.x, fmaf(qr[d + 1], k4.y,
                 fmaf(qr[d + 2], k4.z, fmaf(qr[d + 3], k4.w, s))));
        dpv = fmaf(dor[d], v4.x, fmaf(dor[d + 1], v4.y,
                   fmaf(dor[d + 2], v4.z, fmaf(dor[d + 3], v4.w, dpv))));
      }
      s = pair_sum(s);
      dpv = pair_sum(dpv);
      const bool ok = live && kvalid[j] && (!causal || k0 + j <= qi);
      const float p = ok ? expf(s - m) * rl : 0.f;
      const float ds = p * (dpv - dlt);
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        const float4 k4 = ld4(kr + d);
        acc[d] = fmaf(ds, k4.x, acc[d]);
        acc[d + 1] = fmaf(ds, k4.y, acc[d + 1]);
        acc[d + 2] = fmaf(ds, k4.z, acc[d + 2]);
        acc[d + 3] = fmaf(ds, k4.w, acc[d + 3]);
      }
    }
  }

  if (live) {
    float* dqp = dq + row * DH + half * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) dqp[d] = acc[d] * scale;
    if (half == 0) delta_out[((long long)b * heads + h) * t_len + qi] = dlt;
  }
}

// dk and dv. One block per (key tile of BR keys, head, batch), two threads
// per key; reads the (m, l) of the forward and the delta of the dq kernel.
template <int DH>
__global__ void __launch_bounds__(2 * BR)
attention_lanes_dkv_kernel(const float* __restrict__ q,
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
  using TL = Tile<DH>;
  constexpr int HD = TL::HD;
  __shared__ __align__(16) float qs[BT][TL::PITCH];   // q * scale
  __shared__ __align__(16) float dos[BT][TL::PITCH];
  __shared__ float mrow[BT], rlrow[BT], drow[BT];

  const int tid = threadIdx.x;
  const int half = tid & 1;
  const int k0 = blockIdx.x * BR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kj = k0 + (tid >> 1);
  const bool live = kj < t_len;
  const bool valid =
      live && (mask == nullptr || mask[(long long)b * t_len + kj] != 0);
  const long long srow = ((long long)b * heads + h) * t_len;  // of stats, delta

  float kr[HD], vr[HD], dka[HD], dva[HD];
  if (live) {
    const float* kp = k + b * k_sb + kj * k_st + h * k_sh + half * HD;
    const float* vp = v + b * v_sb + kj * v_st + h * v_sh + half * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      kr[d] = kp[d];
      vr[d] = vp[d];
    }
  } else {
#pragma unroll
    for (int d = 0; d < HD; ++d) kr[d] = vr[d] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < HD; ++d) dka[d] = dva[d] = 0.f;

  // Causal: query i sees key j only for i >= j, so the tile starts at k0.
  for (int i0 = causal ? k0 : 0; i0 < t_len; i0 += BT) {
    __syncthreads();  // the previous tile is no longer read
    for (int e = tid; e < BT * DH; e += 2 * BR) {
      const int r = e / DH, d = e % DH, qi = i0 + r;
      const bool in = qi < t_len;
      const int c = TL::at(d / HD, d % HD);
      qs[r][c] = in ? q[b * q_sb + qi * q_st + h * q_sh + d] * scale : 0.f;
      dos[r][c] = in ? dout[(((long long)b * t_len + qi) * heads + h) * DH + d] : 0.f;
    }
    if (tid < BT) {
      const int qi = i0 + tid;
      const bool in = qi < t_len;
      mrow[tid] = in ? stats[(srow + qi) * 2] : 0.f;
      rlrow[tid] = in ? 1.f / fmaxf(stats[(srow + qi) * 2 + 1], EPSILON) : 0.f;
      drow[tid] = in ? delta[srow + qi] : 0.f;
    }
    __syncthreads();

    for (int r = 0; r < BT; ++r) {
      const float* qrow = &qs[r][TL::at(half, 0)];
      const float* drw = &dos[r][TL::at(half, 0)];
      float s = 0.f, dpv = 0.f;
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        const float4 q4 = ld4(qrow + d), o4 = ld4(drw + d);
        s = fmaf(q4.x, kr[d], fmaf(q4.y, kr[d + 1],
                 fmaf(q4.z, kr[d + 2], fmaf(q4.w, kr[d + 3], s))));
        dpv = fmaf(o4.x, vr[d], fmaf(o4.y, vr[d + 1],
                   fmaf(o4.z, vr[d + 2], fmaf(o4.w, vr[d + 3], dpv))));
      }
      s = pair_sum(s);
      dpv = pair_sum(dpv);
      const int qi = i0 + r;
      const bool ok = valid && qi < t_len && (!causal || kj <= qi);
      const float p = ok ? expf(s - mrow[r]) * rlrow[r] : 0.f;
      const float ds = p * (dpv - drow[r]);
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        const float4 q4 = ld4(qrow + d), o4 = ld4(drw + d);
        dva[d] = fmaf(p, o4.x, dva[d]);
        dva[d + 1] = fmaf(p, o4.y, dva[d + 1]);
        dva[d + 2] = fmaf(p, o4.z, dva[d + 2]);
        dva[d + 3] = fmaf(p, o4.w, dva[d + 3]);
        dka[d] = fmaf(ds, q4.x, dka[d]);  // qs carries the scale
        dka[d + 1] = fmaf(ds, q4.y, dka[d + 1]);
        dka[d + 2] = fmaf(ds, q4.z, dka[d + 2]);
        dka[d + 3] = fmaf(ds, q4.w, dka[d + 3]);
      }
    }
  }

  if (live) {
    const long long off = (((long long)b * t_len + kj) * heads + h) * DH + half * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      dk[off + d] = dka[d];
      dv[off + d] = dva[d];
    }
  }
}

template <int DH>
int launch_fwd(const float* q, const float* k, const float* v, long long q_sb,
               long long q_st, long long q_sh, long long k_sb, long long k_st,
               long long k_sh, long long v_sb, long long v_st, long long v_sh,
               const uint8_t* mask, float* o, float* stats, int batch,
               int t_len, int heads, int causal, float scale,
               cudaStream_t stream) {
  const dim3 grid((t_len + BQ - 1) / BQ, heads, batch);
  attention_lanes_fwd_kernel<DH><<<grid, BQ, 0, stream>>>(
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
  const dim3 grid((t_len + BR - 1) / BR, heads, batch);
  attention_lanes_dq_kernel<DH><<<grid, 2 * BR, 0, stream>>>(
      q, k, v, q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, mask, o,
      dout, stats, delta, dq, t_len, heads, causal, scale);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  attention_lanes_dkv_kernel<DH><<<grid, 2 * BR, 0, stream>>>(
      q, k, v, q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, mask,
      dout, stats, delta, dk, dv, t_len, heads, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: f32, element (b, t, h, d) at b*sb + t*st + h*sh + d (strides in
// elements); mask: (batch, t_len) uint8 (nonzero = attend) or null;
// o: (batch, t_len, heads*dh) f32 contiguous; stats: (batch, heads, t_len, 2)
// f32, each row's (max, sum) for the backward, or null. dh must be 16, 32 or
// 64. Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int kanvit_attention_lanes_fwd(
    const float* q, const float* k, const float* v, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh,
    const uint8_t* mask, float* o, float* stats, int batch, int t_len,
    int heads, int dh, int causal, float scale, void* stream) {
  if (batch <= 0 || t_len <= 0 || heads <= 0 || batch > 65535 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define KANVIT_FWD(D)                                                       \
  launch_fwd<D>(q, k, v, q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st,   \
                v_sh, mask, o, stats, batch, t_len, heads, causal, scale, st)
  switch (dh) {
    case 16: return KANVIT_FWD(16);
    case 32: return KANVIT_FWD(32);
    case 64: return KANVIT_FWD(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef KANVIT_FWD
}

// Backward of kanvit_attention_lanes_fwd. q, k, v, mask as there; o: the
// forward's output and dout its gradient, (batch, t_len, heads*dh) f32
// contiguous; stats: the forward's (batch, heads, t_len, 2); delta: scratch
// of batch*heads*t_len floats; dq, dk, dv: (batch, t_len, heads*dh) f32
// contiguous. Launches the dq kernel, then the dk/dv kernel, on `stream` and
// returns cudaGetLastError() (0 on success).
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
#define KANVIT_BWD(D)                                                       \
  launch_bwd<D>(q, k, v, q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st,   \
                v_sh, mask, o, dout, stats, delta, dq, dk, dv, batch, t_len, \
                heads, causal, scale, st)
  switch (dh) {
    case 16: return KANVIT_BWD(16);
    case 32: return KANVIT_BWD(32);
    case 64: return KANVIT_BWD(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef KANVIT_BWD
}
