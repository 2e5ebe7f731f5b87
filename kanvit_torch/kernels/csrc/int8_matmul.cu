// W8A8 int8 linear layer with the activations quantized per row inside the
// kernel: y = int32(q(x) q(W)^T) * s_x[row] * s_w[col] + b.
//
// Replaces the TPU kernel of kanvit/kernels/int8_matmul.py: _int8_op
// (pallas_call at :134, body _int8_kernel :88), reached from int8_linear
// (:168) under int8 serving.
//
//   q(x)[r, k] = clip(rint(x[r, k] / s_x[r]), -127, 127),
//   s_x[r]     = max(max_k |x[r, k]|, 1e-12) / 127;
// W arrives quantized per output channel (q(W), s_w), as kanvit quantizes it
// outside its kernel (int8_matmul.py:126-133). The rounding is rintf (half
// to even, as jnp.round and torch.round), the divisions IEEE (__fdiv_rn; the
// build has no fast math), and the epilogue rounds each of acc * s_x, * s_w
// and + b on its own (__fmul_rn, __fadd_rn: no fused multiply-add), so the
// kernel and its plain version (kanvit_torch.ops.quant.qdot_rowwise) give
// the same bits from the same q(W): int32 sums are exact in any order.
//
// What bounds it on the H100: at the ViT-S FF (N = 12,608 tokens, K 384,
// out 1,536, or the reverse) the product is 2 N K out = 14.9 GOP, under
// 0.01 ms at the card's dense int8 rate, against 97 MB of x and y in f32 and
// W in int8: bytes, 0.029 ms; y is 80% of them at FF1, x at FF2. The design
// reads x once from device memory, keeps W's reads from L2 to one a block
// of BM rows, and stores whole 32-byte sectors of y:
//
// - a block owns BM rows (the wrapper's rule on K, int8_matmul.py's
//   rows_per_block, passed in as `bm`: 48, 32 or 16, smaller as K grows, so
//   BM rows of K bytes fit beside W's stages) and quantizes them once into
//   shared memory (quantize_rows: many 16-byte loads in flight a lane, each
//   row's values held in registers between its max and its quantization up
//   to K 2,048), at a pitch of K + 16 bytes, which ldmatrix reads without
//   bank conflicts;
// - W (out x K int8, L2-resident: 0.6 MB at vit-s) streams through shared
//   memory in stages of BN outputs x KC bytes, shared by all 8 warps: a ring
//   of STAGES stages filled by 16-byte cp.async, STAGES - 1 ahead, over the
//   flattened (output tile, K chunk) sequence, so the next tile's first
//   stage lands while a tile's epilogue runs; the first is issued before
//   the quantization, which it overlaps;
// - the products are int8 tensor-core mma.sync m16n8k32 (s8 in, s32 out),
//   A and B fragments by ldmatrix.x4 (a row pitch of KC + 16 bytes for W);
//   each warp holds MT m16 x NT n8 accumulators of the block's BM x BN tile;
// - the epilogue writes each fragment's two adjacent columns as one 8-byte
//   store: a warp's store fills whole 32-byte sectors of 8 rows.
//
// Why 48 rows, 128-byte stages, two of them (kanvit_torch/probe_int8.py, the
// H100 80GB HBM3 at 700 W; PERF.md): 48 rows x K 1,536 and the ring take
// 111,744 bytes, so two blocks share an SM and one's quantization overlaps
// the other's products, and vit-s's 12,608 rows are 263 blocks, one wave of
// 264; W's reads from L2 are N / 48 K out bytes. At FF1 / FF2 / the
// embedder it ran 0.0828 / 0.0874 / 0.0481 ms; 64 rows with three stages
// 0.0824 / 0.1328 / 0.0565 (one block an SM at FF2), 32 rows 0.1158 /
// 0.1206 / 0.0682 (W read 394 times), 64-byte stages 0.0940 / 0.0997 /
// 0.0552. A first version that branched on each row's loads (one load in
// flight a lane) ran FF2 at 0.26 ms.
//
// One block a row tile; no atomics, so a second call gives the same bits.
//
// The bf16 form (entry kanvit_int8_linear_fwd_bf16; the same TPU kernel on
// bf16 activations, int8_matmul.py:111,149, reached when a bf16 model serves
// int8 with the kernel on): the kernel templated on the activation type T.
// x is read as bf16, 8 bytes for 4 values, and widened exactly to f32, so
// the row max and rintf(__fdiv_rn(v, s)) see kanvit's f32 values; the
// epilogue is the f32 one above, then rounds each value once to bf16
// (__float2bfloat16_rn) and stores bf16 pairs. The bias stays f32 (the
// wrapper widens a bf16 bias, as kanvit's brow = bias.astype(f32)). The
// quantized rows in shared memory are int8 either way, so shared_bytes and
// the rows a block do not change. Its bits: qdot_rowwise's f32 result
// rounded once to bf16. At vit-b (N = 12,608 tokens, K 768 and out 3,072,
// or the reverse) the product is 59.5 G int8 operations, 0.030 ms at the
// card's dense int8 rate, against 99 MB of x and y in bf16 and W in int8,
// 0.030 ms: bytes and operations bound it alike.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int BN = 128;      // outputs a tile (kanvit's eligibility: out % 128 == 0)
constexpr int KC = 128;      // int8 values of K a stage of W
constexpr int STAGES = 2;    // W stages in the ring
constexpr int XPAD = 16;     // bytes after each quantized row
constexpr int QCHUNKS = 16;  // loads of 4 x values a lane has in flight (16 or 8 bytes)
constexpr float EPS = 1e-12f;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int quant(float v, float s) {
  const float q = rintf(__fdiv_rn(v, s));
  return (int)fminf(fmaxf(q, -127.f), 127.f);
}

// Four values quantized, packed little-endian: k, k+1, k+2, k+3.
__device__ __forceinline__ int quant4(float4 v, float s) {
  return (quant(v.x, s) & 0xff) | ((quant(v.y, s) & 0xff) << 8) |
         ((quant(v.z, s) & 0xff) << 16) | (int)((unsigned)quant(v.w, s) << 24);
}

template <bool VEC>
__device__ __forceinline__ float4 load4(const float* p) {
  if constexpr (VEC) return __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

// bf16 widened exactly: its 16 bits are the top half of an f32.
__device__ __forceinline__ float widen(unsigned short h) {
  return __uint_as_float((unsigned)h << 16);
}

// Four bf16 values as f32, k .. k + 3: one 8-byte load with VEC.
template <bool VEC>
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
  if constexpr (VEC) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
  }
  return make_float4(widen(__ldg(h)), widen(__ldg(h + 1)), widen(__ldg(h + 2)),
                     widen(__ldg(h + 3)));
}

// Two adjacent outputs: f32 as they are, bf16 each rounded once.
__device__ __forceinline__ void store2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float2 v) {
  __nv_bfloat162 h;
  h.x = __float2bfloat16_rn(v.x);
  h.y = __float2bfloat16_rn(v.y);
  *reinterpret_cast<__nv_bfloat162*>(p) = h;
}

__device__ __forceinline__ float amax4(float m, float4 v) {
  return fmaxf(fmaxf(m, fmaxf(fabsf(v.x), fabsf(v.y))), fmaxf(fabsf(v.z), fabsf(v.w)));
}

// Rows r0 .. r0 + BM of x (n, k), k % 128 == 0, quantized into xq (BM rows
// at a pitch of k + XPAD bytes) with their scales in sx (0 past row n):
// warp w takes rows w R .. + R, then WARPS R on. A pass loads U 128-wide
// chunks of each of its R rows, all issued before any is used (addresses
// clamped into the row, not branched on: a value read twice leaves the max
// as it is), R U 16-byte loads in flight a lane (8-byte ones for bf16 x;
// single values without VEC, x's rows not aligned to 4 values). The first
// pass takes each row's max, a shuffle reduction gives it to the warp
// (exact, so its order does not matter); the second quantizes the values
// and stores 4 packed int8 a lane.
// Where k <= 128 U the values are still in registers, and x is read once;
// past it (quantize's deepest rows) the second pass loads them again.
template <int BM, bool VEC, int R, int U, typename T>
__device__ __forceinline__ void quantize_rows(const T* __restrict__ x, long long ldx,
                                              long long r0, int n, int k, int8_t* xq,
                                              float* sx) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, xpitch = k + XPAD;
  const bool cached = k <= 128 * U;
  for (int rb = warp * R; rb < BM; rb += WARPS * R) {
    const T* src[R];
    bool live[R];
    float m[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const long long row = r0 + rb + q;
      live[q] = row < n;
      src[q] = x + (live[q] ? row : 0) * ldx;
      m[q] = 0.f;
    }
    float4 v[R][U];
    auto load = [&](int c0) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = min(c0 + 128 * u, k - 4);
#pragma unroll
        for (int q = 0; q < R; ++q) v[q][u] = load4<VEC>(src[q] + c);
      }
    };
    for (int c0 = 4 * lane; c0 < k; c0 += 128 * U) {
      load(c0);
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int q = 0; q < R; ++q) m[q] = amax4(m[q], v[q][u]);
    }
    float s[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m[q] = fmaxf(m[q], __shfl_xor_sync(0xffffffffu, m[q], off));
      s[q] = live[q] ? __fdiv_rn(fmaxf(m[q], EPS), 127.f) : 0.f;
      if (lane == 0) sx[rb + q] = s[q];
    }
    for (int c0 = 4 * lane; c0 < k; c0 += 128 * U) {
      if (!cached) load(c0);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = c0 + 128 * u;
        if (c < k)
#pragma unroll
          for (int q = 0; q < R; ++q)
            *reinterpret_cast<int*>(xq + (size_t)(rb + q) * xpitch + c) =
                live[q] ? quant4(v[q][u], s[q]) : 0;
      }
    }
  }
}

// quantize_rows with QCHUNKS 16-byte loads a lane in flight: rows of up to
// QCHUNKS 128-wide chunks one pass each (4, 2 or 1 rows at a time), deeper
// ones 4 rows at a time in two passes.
template <int BM, bool VEC, typename T>
__device__ __forceinline__ void quantize(const T* __restrict__ x, long long ldx,
                                         long long r0, int n, int k, int8_t* xq, float* sx) {
  if (k <= 128 * QCHUNKS / 4)
    quantize_rows<BM, VEC, 4, QCHUNKS / 4>(x, ldx, r0, n, k, xq, sx);
  else if (k <= 128 * QCHUNKS / 2)
    quantize_rows<BM, VEC, 2, QCHUNKS / 2>(x, ldx, r0, n, k, xq, sx);
  else if (k <= 128 * QCHUNKS)
    quantize_rows<BM, VEC, 1, QCHUNKS>(x, ldx, r0, n, k, xq, sx);
  else
    quantize_rows<BM, VEC, 4, QCHUNKS / 4>(x, ldx, r0, n, k, xq, sx);
}

// Shared memory of a BM-row block at depth k: the row scales, the
// quantized rows and the W ring.
template <int BM, int KCH = KC, int NST = STAGES>
constexpr size_t shared_bytes(int k) {
  return (size_t)BM * sizeof(float) + (size_t)BM * (k + XPAD) +
         (size_t)NST * BN * (KCH + 16);
}

// x (n, k) T (f32 or bf16), row stride ldx, k % KCH == 0 (and % 32); wq
// (nout, k) int8 contiguous, nout % BN == 0; sw (nout) f32; bias (nout) f32
// or null; y (n, nout) T contiguous. Grid: ceil(n / BM) blocks of THREADS;
// dynamic shared memory shared_bytes<BM, KCH, NST>(k).
template <int BM, int KCH, int NST, typename T>
__global__ void __launch_bounds__(THREADS, 2)
int8_linear_kernel(const T* __restrict__ x, long long ldx,
                   const int8_t* __restrict__ wq, const float* __restrict__ sw,
                   const float* __restrict__ bias, T* __restrict__ y, int n, int k,
                   int nout) {
  // warps: WM along the rows (MT m16 tiles each) x WN along the tile's outputs
  constexpr int WM = BM >= 64 ? BM / 32 : 1, MT = BM / (16 * WM);
  constexpr int WN = WARPS / WM, NT = BN / (8 * WN);
  constexpr int WPITCH = KCH + 16, WSTAGE = BN * WPITCH;
  static_assert(WM * WN == WARPS && WM * MT * 16 == BM && NT % 2 == 0, "warp layout");
  extern __shared__ __align__(16) unsigned char smem[];
  float* sx = reinterpret_cast<float*>(smem);
  int8_t* xq = reinterpret_cast<int8_t*>(smem + BM * sizeof(float));
  const int xpitch = k + XPAD;
  int8_t* wbuf = xq + (size_t)BM * xpitch;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long r0 = (long long)blockIdx.x * BM;
  const int kchunks = k / KCH, total = (nout / BN) * kchunks;

  // stage i of the (output tile, K chunk) sequence into ring slot i % NST
  auto load_w = [&](int i) {
    const int t = i / kchunks, kc = i - t * kchunks;
    const int8_t* src = wq + (long long)t * BN * k + kc * KCH;
    int8_t* dst = wbuf + (i % NST) * WSTAGE;
    for (int e = tid; e < BN * (KCH / 16); e += THREADS) {
      const int r = e / (KCH / 16), c = 16 * (e % (KCH / 16));
      cp_async16(dst + r * WPITCH + c, src + (long long)r * k + c);
    }
  };
#pragma unroll
  for (int i = 0; i < NST - 1; ++i) {
    if (i < total) load_w(i);
    cp_async_commit();
  }

  if ((ldx & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & (4 * sizeof(T) - 1)) == 0)
    quantize<BM, true>(x, ldx, r0, n, k, xq, sx);
  else
    quantize<BM, false>(x, ldx, r0, n, k, xq, sx);
  __syncthreads();

  // Products: warp (wm, wn) owns rows wm MT 16 .. + MT 16 and outputs
  // wn NT 8 .. + NT 8 of each tile.
  const int wm = warp % WM, wn = warp / WM;
  const int g = lane >> 2, tq = lane & 3;
  // ldmatrix.x4 row addresses: A's four 8x16-byte matrices are (rows 0-7,
  // k 0-15), (8-15, 0-15), (0-7, 16-31), (8-15, 16-31): a0..a3; B's, of two
  // n8 tiles, (n 0-7, k 0-15), (0-7, 16-31), (8-15, 0-15), (8-15, 16-31):
  // b0, b1 of the first, then of the second.
  const int8_t* arow = xq + (size_t)(wm * MT * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * xpitch +
                       (lane >> 4) * 16;
  const int brow = wn * NT * 8 + (lane & 7) + ((lane >> 4) << 3);
  const int bcol = ((lane >> 3) & 1) * 16;
  float sxr[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) sxr[mt][h] = sx[wm * MT * 16 + mt * 16 + g + 8 * h];

  int acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;

  for (int i = 0; i < total; ++i) {
    cp_async_wait<NST - 2>();
    __syncthreads();  // stage i landed; every warp is past stage i - 1's slot
    if (i + NST - 1 < total) load_w(i + NST - 1);
    cp_async_commit();
    const int t = i / kchunks, kc = i - t * kchunks;
    const int8_t* ws = wbuf + (i % NST) * WSTAGE + brow * WPITCH + bcol;
#pragma unroll
    for (int ks = 0; ks < KCH / 32; ++ks) {
      unsigned a[MT][4], b[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(a[mt], arow + (size_t)mt * 16 * xpitch + kc * KCH + ks * 32);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned r[4];
        ldmatrix_x4(r, ws + np * 16 * WPITCH + ks * 32);
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_s8(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
    }
    if (kc + 1 < kchunks) continue;
    // Epilogue of output tile t: acc * s_x * s_w (+ b), each rounded in f32
    // (then once to bf16 for a bf16 y).
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = t * BN + wn * NT * 8 + nt * 8 + 2 * tq;
      const float2 swv = __ldg(reinterpret_cast<const float2*>(sw + col));
      const float2 bv = bias != nullptr ? __ldg(reinterpret_cast<const float2*>(bias + col))
                                        : make_float2(0.f, 0.f);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long row = r0 + wm * MT * 16 + mt * 16 + g + 8 * h;
          float2 v;
          v.x = __fmul_rn(__fmul_rn((float)acc[mt][nt][2 * h], sxr[mt][h]), swv.x);
          v.y = __fmul_rn(__fmul_rn((float)acc[mt][nt][2 * h + 1], sxr[mt][h]), swv.y);
          if (bias != nullptr) {
            v.x = __fadd_rn(v.x, bv.x);
            v.y = __fadd_rn(v.y, bv.y);
          }
          if (row < n) store2(y + row * nout + col, v);
          acc[mt][nt][2 * h] = acc[mt][nt][2 * h + 1] = 0;
        }
    }
  }
}

// The kernel over the operands of kanvit_int8_linear_fwd at BM rows a
// block: cudaErrorInvalidValue where k or nout do not divide into its tiles
// or its shared memory passes a block's 232,448 bytes.
template <int BM, int KCH = KC, int NST = STAGES, typename T = float>
int launch_int8_linear(const T* x, long long ldx, const int8_t* wq, const float* sw,
                       const float* bias, T* y, int n, int k, int nout,
                       cudaStream_t st) {
  const size_t smem = shared_bytes<BM, KCH, NST>(k);
  if (n <= 0 || k <= 0 || nout <= 0 || k % KCH || k % 32 || nout % BN || smem > 232448)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      int8_linear_kernel<BM, KCH, NST, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int8_linear_kernel<BM, KCH, NST, T><<<(unsigned)((n + BM - 1) / BM), THREADS, smem, st>>>(
      x, ldx, wq, sw, bias, y, n, k, nout);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (n, k) f32 with row stride ldx (elements) and unit column stride, k a
// positive multiple of 128; wq: (nout, k) int8 contiguous, each row
// quantized with its scale in sw (nout) f32; bias: (nout) f32 or null, sw
// and bias 8-byte aligned; y: (n, nout) f32 contiguous, nout a positive
// multiple of 128; bm: the rows a block, 48, 32 or 16 (int8_matmul.py's
// rows_per_block(k)), with shared_bytes<bm>(k) within a block's shared
// memory. Launches on `stream` and returns cudaGetLastError() (0 on
// success), cudaErrorInvalidValue on anything else.
extern "C" int kanvit_int8_linear_fwd(const float* x, long long ldx, const int8_t* wq,
                                      const float* sw, const float* bias, float* y, int n,
                                      int k, int nout, int bm, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (bm) {
    case 48: return launch_int8_linear<48>(x, ldx, wq, sw, bias, y, n, k, nout, st);
    case 32: return launch_int8_linear<32>(x, ldx, wq, sw, bias, y, n, k, nout, st);
    case 16: return launch_int8_linear<16>(x, ldx, wq, sw, bias, y, n, k, nout, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The bf16 form: x (n, k) and y (n, nout) bf16 (x 8-byte aligned rows take
// the vector loads), every other operand and rule as kanvit_int8_linear_fwd;
// y is the f32 epilogue rounded once to bf16.
extern "C" int kanvit_int8_linear_fwd_bf16(const __nv_bfloat16* x, long long ldx,
                                           const int8_t* wq, const float* sw,
                                           const float* bias, __nv_bfloat16* y, int n,
                                           int k, int nout, int bm, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (bm) {
    case 48: return launch_int8_linear<48>(x, ldx, wq, sw, bias, y, n, k, nout, st);
    case 32: return launch_int8_linear<32>(x, ldx, wq, sw, bias, y, n, k, nout, st);
    case 16: return launch_int8_linear<16>(x, ldx, wq, sw, bias, y, n, k, nout, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
