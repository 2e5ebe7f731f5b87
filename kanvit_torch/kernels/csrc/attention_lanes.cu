// Attention over head-concatenated (B, T, H*dh) tensors, forward.
//
// Replaces the TPU kernel of kanvit/kernels/flash_attention.py:
//   _lanes_fwd_impl (pallas_call at :571), reached from _flash_lanes (:547)
//   and flash_attention_lanes (:647).
//
// Per batch item b and head h:
//   o_h = softmax(q_h k_h^T * dh^-1/2 + key bias + causal bias) v_h
// with the TPU kernel's edge semantics (flash_attention.py:312-341): masked
// keys contribute exactly 0, the row max is clamped at -1e30 and the row sum
// at 1e-10, so a fully masked row outputs 0.
//
// q, k and v are read in place through (batch, token, head) strides with a
// unit stride inside a head, so the three q/k/v slices of the grouped
// projection's (N, H*3dh) output are consumed without a copy. The output is
// written contiguous (B, T, H*dh), the layout the next layer reads.
//
// What bounds it on the H100: at ViT-S (T = 197, dh = 64, 6 heads, batch
// 64) the two products are 4*B*H*T^2*dh = 3.8 GFLOP per layer against
// ~39 MB of q, k, v and o, so it is bound by arithmetic and by the exp of
// every score; the TPU kernel was bound by its exp throughput too.
//
// The simple design: one block per (query tile of BQ rows, head, batch),
// one thread per query row. The thread keeps its scaled q row and its
// output accumulator in registers and streams the keys in tiles of BKV that
// the block stages in shared memory (K and V tiles: 2*BKV*dh*4 bytes, 16 KB
// at dh = 64, far under the 48 KB static limit at any T). An online softmax
// keeps the running max m (starting at the -1e30 clamp) and the running sum
// l; a masked key gets a score of -inf and so a probability of exactly 0.
// Causal blocks stop at their last query's key. All math is f32 on the CUDA
// cores; tensor-core products (mma / wgmma) are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // query rows per block, one thread each
constexpr int BKV = 32;  // keys per staged tile

template <int DH>
__global__ void __launch_bounds__(BQ)
attention_lanes_fwd_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           long long q_sb, long long q_st, long long q_sh,
                           long long k_sb, long long k_st, long long k_sh,
                           long long v_sb, long long v_st, long long v_sh,
                           const uint8_t* __restrict__ mask,
                           float* __restrict__ o, int t_len, int heads,
                           int causal, float scale) {
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
  float m = -1e30f;
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
    const float rl = 1.f / fmaxf(l, 1e-10f);
    float* op = o + (((long long)b * t_len + qi) * heads + h) * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) op[d] = acc[d] * rl;
  }
}

template <int DH>
int launch(const float* q, const float* k, const float* v, long long q_sb,
           long long q_st, long long q_sh, long long k_sb, long long k_st,
           long long k_sh, long long v_sb, long long v_st, long long v_sh,
           const uint8_t* mask, float* o, int batch, int t_len, int heads,
           int causal, float scale, cudaStream_t stream) {
  const dim3 grid((t_len + BQ - 1) / BQ, heads, batch);
  attention_lanes_fwd_kernel<DH><<<grid, BQ, 0, stream>>>(
      q, k, v, q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, mask, o,
      t_len, heads, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: f32, element (b, t, h, d) at b*sb + t*st + h*sh + d (strides in
// elements); mask: (batch, t_len) uint8 (nonzero = attend) or null;
// o: (batch, t_len, heads*dh) f32 contiguous. dh must be 16, 32 or 64.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int kanvit_attention_lanes_fwd(
    const float* q, const float* k, const float* v, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh,
    const uint8_t* mask, float* o, int batch, int t_len, int heads, int dh,
    int causal, float scale, void* stream) {
  if (batch <= 0 || t_len <= 0 || heads <= 0 || batch > 65535 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (dh) {
    case 16:
      return launch<16>(q, k, v, q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb,
                        v_st, v_sh, mask, o, batch, t_len, heads, causal,
                        scale, st);
    case 32:
      return launch<32>(q, k, v, q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb,
                        v_st, v_sh, mask, o, batch, t_len, heads, causal,
                        scale, st);
    case 64:
      return launch<64>(q, k, v, q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb,
                        v_st, v_sh, mask, o, batch, t_len, heads, causal,
                        scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
