// W8A8 int8 linear layer with the activations quantized per row inside the
// kernel: y = int32(q(x) q(W)^T) * s_x[row] * s_w[col] + b.
//
// Replaces the TPU kernel of kanvit/kernels/int8_matmul.py: _int8_op
// (pallas_call at :134, body _int8_kernel :88), reached from int8_linear
// (:198) under int8 serving.
//
//   q(x)[r, k] = clip(rint(x[r, k] / s_x[r]), -127, 127),
//   s_x[r]     = max(max_k |x[r, k]|, 1e-12) / 127;
// W arrives quantized per output channel (q(W), s_w), as kanvit quantizes it
// outside its kernel (int8_matmul.py:126-133). The rounding is rintf (half
// to even, as jnp.round and torch.round), the divisions IEEE (the build has
// no fast math), and the epilogue rounds each of acc * s_x, * s_w and + b
// on its own (__fmul_rn, __fadd_rn: no fused multiply-add), so the kernel
// and its plain version (kanvit_torch.ops.quant.qdot_rowwise) give the same
// bits from the same q(W).
//
// What bounds it on the H100: at the ViT-S FF (N = 12,608 tokens, K 384,
// out 1,536, or the reverse) the product is 2 N K out = 14.9 GOP, under
// 0.01 ms at the card's dense int8 rate, against 97 MB of x and y in f32 and
// W in int8: bytes, 0.029 ms. The design keeps x to one read: a block owns
// BM rows, quantizes them into shared memory once (a warp reduces a row's
// max), then walks every output tile over them with int8 tensor-core
// products (mma.sync m16n8k32, s8 in, s32 out) whose B fragments are read
// straight from q(W) (out x K bytes, L2-resident). A simple first version:
// no cp.async pipeline, no wgmma, no reuse of B across warps.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;        // rows per block
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BN = 64;        // outputs per tile: 2 warp columns of 32
constexpr int KSTEP = 32;     // the mma's depth in int8 values
constexpr int PAD = 16;       // bytes after each quantized row
constexpr float EPS = 1e-12f;

__device__ __forceinline__ int ld32(const int8_t* p) {
  return *reinterpret_cast<const int*>(p);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], int a0, int a1, int a2,
                                       int a3, int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int8_t quant(float v, float s) {
  const float q = rintf(__fdiv_rn(v, s));
  return (int8_t)(int)fminf(fmaxf(q, -127.f), 127.f);
}

// x (n, k) f32, row stride ldx, k % 32 == 0; wq (nout, k) int8 contiguous;
// sw (nout) f32; bias (nout) f32 or null; y (n, nout) f32 contiguous,
// nout % 64 == 0. Dynamic shared memory: BM * (k + PAD) bytes + BM floats.
__global__ void __launch_bounds__(THREADS)
int8_linear_kernel(const float* __restrict__ x, long long ldx,
                   const int8_t* __restrict__ wq, const float* __restrict__ sw,
                   const float* __restrict__ bias, float* __restrict__ y, int n,
                   int k, int nout) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int pitch = k + PAD;
  int8_t* xq = reinterpret_cast<int8_t*>(smem);
  float* sx = reinterpret_cast<float*>(smem + (size_t)BM * pitch);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * BM;

  // Quantize: warp w owns rows w, w + WARPS, ...; a row's max by a shuffle
  // reduction (max is exact, so its order does not matter).
  for (int r = warp; r < BM; r += WARPS) {
    const int row = r0 + r;
    int8_t* dst = xq + (size_t)r * pitch;
    if (row >= n) {
      for (int c = lane; c < k; c += 32) dst[c] = 0;
      if (lane == 0) sx[r] = 0.f;
      continue;
    }
    const float* src = x + (long long)row * ldx;
    float amax = 0.f;
    for (int c = lane; c < k; c += 32) amax = fmaxf(amax, fabsf(src[c]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float s = __fdiv_rn(fmaxf(amax, EPS), 127.f);
    for (int c = lane; c < k; c += 32) dst[c] = quant(src[c], s);
    if (lane == 0) sx[r] = s;
  }
  __syncthreads();

  // Products: warp w owns rows (w & 1) * 16 .. + 16 and, of each BN-wide
  // tile, the outputs (w >> 1) * 32 .. + 32 as four n8 fragments.
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp & 1) * 16, wc = (warp >> 1) * 32;
  const int8_t* arow0 = xq + (size_t)(wr + g) * pitch + t * 4;
  const int8_t* arow1 = arow0 + 8 * (size_t)pitch;
  const int ra = r0 + wr + g, rb = ra + 8;
  const float sxa = sx[wr + g], sxb = sx[wr + g + 8];
  for (int n0 = 0; n0 < nout; n0 += BN) {
    int acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0;
    const int8_t* brow = wq + (long long)(n0 + wc + g) * k + t * 4;
    for (int k0 = 0; k0 < k; k0 += KSTEP) {
      const int a0 = ld32(arow0 + k0), a1 = ld32(arow1 + k0);
      const int a2 = ld32(arow0 + k0 + 16), a3 = ld32(arow1 + k0 + 16);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* bp = brow + (long long)j * 8 * k + k0;
        mma_s8(acc[j], a0, a1, a2, a3, __ldg(reinterpret_cast<const int*>(bp)),
               __ldg(reinterpret_cast<const int*>(bp + 16)));
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wc + j * 8 + t * 2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? ra : rb;
        const int c = col + (e & 1);
        if (row < n) {
          float v = __fmul_rn(__fmul_rn((float)acc[j][e], e < 2 ? sxa : sxb),
                              sw[c]);
          if (bias != nullptr) v = __fadd_rn(v, bias[c]);
          y[(long long)row * nout + c] = v;
        }
      }
    }
  }
}

}  // namespace

// x: (n, k) f32 with row stride ldx (elements) and unit column stride, k a
// positive multiple of 32 with BM * (k + 16) bytes within the block's shared
// memory; wq: (nout, k) int8 contiguous, each row quantized with its scale
// in sw (nout) f32; bias: (nout) f32 or null; y: (n, nout) f32 contiguous,
// nout a positive multiple of 64. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int kanvit_int8_linear_fwd(const float* x, long long ldx,
                                      const int8_t* wq, const float* sw,
                                      const float* bias, float* y, int n,
                                      int k, int nout, void* stream) {
  if (n <= 0 || k <= 0 || nout <= 0 || k % KSTEP || nout % BN)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)BM * (k + PAD) + BM * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_linear_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((n + BM - 1) / BM);
  int8_linear_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, ldx, wq, sw, bias, y, n, k, nout);
  return (int)cudaGetLastError();
}
