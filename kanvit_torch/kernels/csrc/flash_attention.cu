// Tiled attention over (B, H, T, dh) tensors, forward and backward.
//
// Replaces the TPU kernels of kanvit/kernels/flash_attention.py that
// flash_attention (:873) reaches past one tile:
//   forward:  _fwd_pallas (pallas_call at :132, body _fwd_kernel :66-123);
//   backward: _flash_bwd's dq kernel (pallas_call at :806, body
//             _bwd_dq_kernel :176-223) and its dk/dv kernel (:831, body
//             _bwd_dkv_kernel :226-272).
//
// Per batch item b and head h, with qpos = row - max(tk - tq, 0):
//   s = q k^T * dh^-1/2, set to NEG_INF (the finite float32 min) on masked
//       keys and, causal, where qpos < kpos;
//   online softmax over key tiles: m = running max, p = exp(s - m) zeroed on
//       masked keys only, each tile's row sum clamped at 1e-10, l = running
//       sum, o = acc / max(l, 1e-10).
// These are the TPU tiled kernel's edge semantics, not the lanes kernel's:
// with a finite NEG_INF, a row that sees no valid key causally keeps
// m = NEG_INF, and exp(NEG_INF - NEG_INF) = 1 gives it the uniform mean of v
// over every valid key, later keys included. The backward, with the
// forward's per-row (m, l) (never an lse):
//   p = exp(s - m) / l on valid keys, delta = rowsum(do * o),
//   ds = p * (do v^T - delta), zeroed where the causal mask applies,
//   dq = ds k * dh^-1/2,  dk = ds^T q * dh^-1/2,  dv = p^T do,
// so a fully masked row still adds its uniform p to dv.
//
// q, k and v are read in place through (batch, token, head) strides with a
// unit stride inside a head, so (B, T, H, dh) projections viewed as
// (B, H, T, dh) need no copy. o, do and the gradients are contiguous
// (B, T, H*dh), the layout the output projection reads.
//
// What bounds them on the H100: at the causal decoder's shapes (B*H = 64,
// T = 2048, or B*H = 16, T = 8192, dh = 64) the forward's two products are
// 2*B*H*T^2*dh FLOP with causal skipping (34 GFLOP at T = 2048) against
// 4*B*H*T*dh*4 B = 134 MB of q, k, v and o: arithmetic, and the exp of every
// score, bound them, as the lanes kernels. The backward recomputes the
// scores in both of its kernels (7 products in all).
//
// Design, as attention_lanes.cu: the forward takes one thread per query row
// (BQ rows a block), keeps its scaled q row and accumulator in registers and
// streams K/V tiles of BKV keys staged in shared memory. The backward is a
// dq kernel per query tile (which also writes delta) and a dk/dv kernel per
// key tile, two threads per row with half the head dims each, deterministic
// (no atomics). Causal blocks stop at their last row's key, unless one of
// their rows has seen no valid key yet: that row needs every later tile
// (p = 1 on every valid key), so the block goes on. The dk/dv kernel skips
// query tiles that see none of its keys causally unless a row in them has
// m = NEG_INF. All math is f32 on the CUDA cores, with IEEE expf (no fast
// math, which would change the fully masked rows); tensor-core products are
// later work.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

constexpr int BQ = 64;   // query rows per forward block, one thread each
constexpr int BKV = 32;  // keys per staged forward tile
constexpr int BR = 64;   // rows per backward block, two threads each
constexpr int BT = 32;   // rows per staged backward tile
constexpr float EPSILON = 1e-10f;
constexpr float NEG_INF = -FLT_MAX;

// An f32 (B, T, H, dh) tensor read through its strides (in elements).
struct View {
  const float* p;
  long long sb, st, sh;
  __device__ __forceinline__ const float* at(int b, int t, int h) const {
    return p + b * sb + t * st + h * sh;
  }
};

__device__ __forceinline__ bool key_ok(const uint8_t* mask, int b, int tk,
                                       int key) {
  return key < tk && (mask == nullptr || mask[(long long)b * tk + key] != 0);
}

// Forward. One block per (query tile of BQ rows, head, batch), one thread
// per query row.
template <int DH>
__global__ void __launch_bounds__(BQ)
flash_fwd_kernel(View q, View k, View v, const uint8_t* __restrict__ mask,
                 float* __restrict__ o, float* __restrict__ stats, int tq,
                 int tk, int heads, int causal, float scale) {
  __shared__ float ks[BKV][DH];
  __shared__ float vs[BKV][DH];
  __shared__ int kvalid[BKV];

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int qi = q0 + tid;
  const bool live = qi < tq;
  const int diff = max(tk - tq, 0);
  const int qpos = qi - diff;

  float qr[DH], acc[DH];
  if (live) {
    const float* qp = q.at(b, qi, h);
#pragma unroll
    for (int d = 0; d < DH; ++d) qr[d] = qp[d] * scale;
  } else {
#pragma unroll
    for (int d = 0; d < DH; ++d) qr[d] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  float m = NEG_INF;
  float l = 0.f;

  // Keys past the block's last row are causally masked for all its rows.
  const int frontier = causal ? min(tk, max(0, q0 + BQ - diff)) : tk;
  for (int k0 = 0; k0 < tk; k0 += BKV) {
    // Past the frontier only a row with no valid key so far still changes.
    if (k0 >= frontier && !__syncthreads_or(live && m == NEG_INF)) break;
    __syncthreads();  // the previous tile is no longer read
    for (int e = tid; e < BKV * DH; e += BQ) {
      const int j = e / DH, d = e % DH, key = k0 + j;
      const bool in = key < tk;
      ks[j][d] = in ? k.at(b, key, h)[d] : 0.f;
      vs[j][d] = in ? v.at(b, key, h)[d] : 0.f;
    }
    if (tid < BKV) kvalid[tid] = key_ok(mask, b, tk, k0 + tid);
    __syncthreads();

    float s[BKV];
    float mt = m;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) dot = fmaf(qr[d], ks[j][d], dot);
      const bool ok = kvalid[j] && (!causal || k0 + j <= qpos);
      s[j] = ok ? dot : NEG_INF;
      mt = fmaxf(mt, s[j]);
    }
    const float corr = expf(m - mt);
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= corr;
    float bsum = 0.f;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      // 1 on a valid, causally masked key of a row whose max is NEG_INF
      const float p = kvalid[j] ? expf(s[j] - mt) : 0.f;
      bsum += p;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = fmaf(p, vs[j][d], acc[d]);
    }
    l = corr * l + fmaxf(bsum, EPSILON);
    m = mt;
  }

  if (live) {
    const float lc = fmaxf(l, EPSILON);
    float* op = o + (((long long)b * tq + qi) * heads + h) * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) op[d] = acc[d] / lc;
    if (stats != nullptr) {
      float* sp = stats + (((long long)b * heads + h) * tq + qi) * 2;
      sp[0] = m;
      sp[1] = lc;
    }
  }
}

// dq and delta. One block per (query tile of BR rows, head, batch), two
// threads per query row.
template <int DH>
__global__ void __launch_bounds__(2 * BR)
flash_dq_kernel(View q, View k, View v, const uint8_t* __restrict__ mask,
                const float* __restrict__ o, const float* __restrict__ dout,
                const float* __restrict__ stats, float* __restrict__ delta_out,
                float* __restrict__ dq, int tq, int tk, int heads, int causal,
                float scale) {
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
  const bool live = qi < tq;
  const int diff = max(tk - tq, 0);
  const int qpos = qi - diff;
  const long long row = ((long long)b * tq + qi) * heads + h;  // of o, do, dq

  float qr[HD], dor[HD], acc[HD];
  float dlt = 0.f, m = 0.f, linv = 0.f;
  if (live) {
    const float* qp = q.at(b, qi, h) + half * HD;
    const float* op = o + row * DH + half * HD;
    const float* dp = dout + row * DH + half * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      qr[d] = qp[d] * scale;
      dor[d] = dp[d];
      dlt = fmaf(dor[d], op[d], dlt);
    }
    const float* sp = stats + (((long long)b * heads + h) * tq + qi) * 2;
    m = sp[0];
    linv = 1.f / sp[1];
  } else {
#pragma unroll
    for (int d = 0; d < HD; ++d) qr[d] = dor[d] = 0.f;
  }
  dlt = pair_sum(dlt);
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;

  // ds is 0 wherever the causal mask applies, so keys past the block's last
  // row add nothing to dq.
  const int kend = causal ? min(tk, max(0, q0 + BR - diff)) : tk;
  for (int k0 = 0; k0 < kend; k0 += BT) {
    __syncthreads();  // the previous tile is no longer read
    for (int e = tid; e < BT * DH; e += 2 * BR) {
      const int j = e / DH, d = e % DH, key = k0 + j;
      const bool in = key < tk;
      const int c = TL::at(d / HD, d % HD);
      ks[j][c] = in ? k.at(b, key, h)[d] : 0.f;
      vs[j][c] = in ? v.at(b, key, h)[d] : 0.f;
    }
    if (tid < BT) kvalid[tid] = key_ok(mask, b, tk, k0 + tid);
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
      const bool vis = !causal || k0 + j <= qpos;
      const float p = (live && kvalid[j]) ? expf((vis ? s : NEG_INF) - m) * linv
                                          : 0.f;
      const float ds = vis ? p * (dpv - dlt) : 0.f;
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
    if (half == 0) delta_out[((long long)b * heads + h) * tq + qi] = dlt;
  }
}

// dk and dv. One block per (key tile of BR keys, head, batch), two threads
// per key; reads the (m, l) of the forward and the delta of the dq kernel.
template <int DH>
__global__ void __launch_bounds__(2 * BR)
flash_dkv_kernel(View q, View k, View v, const uint8_t* __restrict__ mask,
                 const float* __restrict__ dout, const float* __restrict__ stats,
                 const float* __restrict__ delta, float* __restrict__ dk,
                 float* __restrict__ dv, int tq, int tk, int heads, int causal,
                 float scale) {
  using TL = Tile<DH>;
  constexpr int HD = TL::HD;
  __shared__ __align__(16) float qs[BT][TL::PITCH];   // q * scale
  __shared__ __align__(16) float dos[BT][TL::PITCH];
  __shared__ float mrow[BT], lirow[BT], drow[BT];

  const int tid = threadIdx.x;
  const int half = tid & 1;
  const int k0 = blockIdx.x * BR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kj = k0 + (tid >> 1);
  const bool live = kj < tk;
  const bool valid = live && key_ok(mask, b, tk, kj);
  const int diff = max(tk - tq, 0);
  const long long srow = ((long long)b * heads + h) * tq;  // of stats, delta

  float kr[HD], vr[HD], dka[HD], dva[HD];
  if (live) {
    const float* kp = k.at(b, kj, h) + half * HD;
    const float* vp = v.at(b, kj, h) + half * HD;
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

  // The first row that sees key k0 causally (qpos >= k0).
  const int first = causal ? k0 + diff : 0;
  for (int i0 = 0; i0 < tq; i0 += BT) {
    __syncthreads();  // the previous tile is no longer read
    bool dead = false;
    if (tid < BT) {
      const int qi = i0 + tid;
      const bool in = qi < tq;
      const float mi = in ? stats[(srow + qi) * 2] : 0.f;
      mrow[tid] = mi;
      lirow[tid] = in ? 1.f / stats[(srow + qi) * 2 + 1] : 0.f;
      drow[tid] = in ? delta[srow + qi] : 0.f;
      dead = in && mi == NEG_INF;
    }
    // A tile whose rows see none of this block's keys causally adds only
    // the uniform p of rows that saw no valid key (m = NEG_INF) to dv.
    if (!__syncthreads_or(dead) && i0 + BT <= first) continue;
    for (int e = tid; e < BT * DH; e += 2 * BR) {
      const int r = e / DH, d = e % DH, qi = i0 + r;
      const bool in = qi < tq;
      const int c = TL::at(d / HD, d % HD);
      qs[r][c] = in ? q.at(b, qi, h)[d] * scale : 0.f;
      dos[r][c] = in ? dout[(((long long)b * tq + qi) * heads + h) * DH + d] : 0.f;
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
      const bool vis = !causal || kj <= qi - diff;
      const float p = (valid && qi < tq)
                          ? expf((vis ? s : NEG_INF) - mrow[r]) * lirow[r]
                          : 0.f;
      const float ds = vis ? p * (dpv - drow[r]) : 0.f;
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
    const long long off = (((long long)b * tk + kj) * heads + h) * DH + half * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      dk[off + d] = dka[d];
      dv[off + d] = dva[d];
    }
  }
}

bool bad_dims(int batch, int tq, int tk, int heads) {
  return batch <= 0 || tq <= 0 || tk <= 0 || heads <= 0 || batch > 65535 ||
         heads > 65535;
}

}  // namespace

// q: f32, element (b, t, h, d) of a (batch, tq, heads, dh) tensor at
// b*q_sb + t*q_st + h*q_sh + d (strides in elements); k, v alike over tk
// keys. mask: (batch, tk) uint8 (nonzero = attend) or null. o: (batch, tq,
// heads*dh) f32 contiguous; stats: (batch, heads, tq, 2) f32, each row's
// (max, clamped sum) for the backward, or null. dh must be 16, 32 or 64.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int kanvit_flash_attention_fwd(
    const float* q, const float* k, const float* v, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh,
    const uint8_t* mask, float* o, float* stats, int batch, int tq, int tk,
    int heads, int dh, int causal, float scale, void* stream) {
  if (bad_dims(batch, tq, tk, heads)) return (int)cudaErrorInvalidValue;
  const View qv{q, q_sb, q_st, q_sh}, kv{k, k_sb, k_st, k_sh},
      vv{v, v_sb, v_st, v_sh};
  const dim3 grid((tq + BQ - 1) / BQ, heads, batch);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (dh) {
    case 16: flash_fwd_kernel<16><<<grid, BQ, 0, st>>>(
        qv, kv, vv, mask, o, stats, tq, tk, heads, causal, scale); break;
    case 32: flash_fwd_kernel<32><<<grid, BQ, 0, st>>>(
        qv, kv, vv, mask, o, stats, tq, tk, heads, causal, scale); break;
    case 64: flash_fwd_kernel<64><<<grid, BQ, 0, st>>>(
        qv, kv, vv, mask, o, stats, tq, tk, heads, causal, scale); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// dq of kanvit_flash_attention_fwd, and delta = rowsum(dout * o). q, k, v,
// mask as there; o: the forward's output and dout its gradient, (batch, tq,
// heads*dh) f32 contiguous; stats: the forward's (batch, heads, tq, 2);
// delta: (batch, heads, tq) f32, written; dq: (batch, tq, heads*dh) f32
// contiguous. Launches on `stream` and returns cudaGetLastError().
extern "C" int kanvit_flash_attention_dq(
    const float* q, const float* k, const float* v, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh,
    const uint8_t* mask, const float* o, const float* dout,
    const float* stats, float* delta, float* dq, int batch, int tq, int tk,
    int heads, int dh, int causal, float scale, void* stream) {
  if (bad_dims(batch, tq, tk, heads)) return (int)cudaErrorInvalidValue;
  const View qv{q, q_sb, q_st, q_sh}, kv{k, k_sb, k_st, k_sh},
      vv{v, v_sb, v_st, v_sh};
  const dim3 grid((tq + BR - 1) / BR, heads, batch);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (dh) {
    case 16: flash_dq_kernel<16><<<grid, 2 * BR, 0, st>>>(
        qv, kv, vv, mask, o, dout, stats, delta, dq, tq, tk, heads, causal,
        scale); break;
    case 32: flash_dq_kernel<32><<<grid, 2 * BR, 0, st>>>(
        qv, kv, vv, mask, o, dout, stats, delta, dq, tq, tk, heads, causal,
        scale); break;
    case 64: flash_dq_kernel<64><<<grid, 2 * BR, 0, st>>>(
        qv, kv, vv, mask, o, dout, stats, delta, dq, tq, tk, heads, causal,
        scale); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// dk and dv of kanvit_flash_attention_fwd. q, k, v, mask, dout and stats as
// for the dq kernel; delta: what the dq kernel wrote; dk, dv: (batch, tk,
// heads*dh) f32 contiguous. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int kanvit_flash_attention_dkv(
    const float* q, const float* k, const float* v, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh,
    const uint8_t* mask, const float* dout, const float* stats,
    const float* delta, float* dk, float* dv, int batch, int tq, int tk,
    int heads, int dh, int causal, float scale, void* stream) {
  if (bad_dims(batch, tq, tk, heads)) return (int)cudaErrorInvalidValue;
  const View qv{q, q_sb, q_st, q_sh}, kv{k, k_sb, k_st, k_sh},
      vv{v, v_sb, v_st, v_sh};
  const dim3 grid((tk + BR - 1) / BR, heads, batch);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (dh) {
    case 16: flash_dkv_kernel<16><<<grid, 2 * BR, 0, st>>>(
        qv, kv, vv, mask, dout, stats, delta, dk, dv, tq, tk, heads, causal,
        scale); break;
    case 32: flash_dkv_kernel<32><<<grid, 2 * BR, 0, st>>>(
        qv, kv, vv, mask, dout, stats, delta, dk, dv, tq, tk, heads, causal,
        scale); break;
    case 64: flash_dkv_kernel<64><<<grid, 2 * BR, 0, st>>>(
        qv, kv, vv, mask, dout, stats, delta, dk, dv, tq, tk, heads, causal,
        scale); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
