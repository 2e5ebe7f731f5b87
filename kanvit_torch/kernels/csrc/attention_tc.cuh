// The tensor-core helpers of the attention kernels (attention_lanes.cu,
// flash_attention.cu), the fused FF (fused_ffn.cu) and the KAN kernels
// (kan_basis_tc.cuh): the TF32 split of an f32 operand, mma.sync.m16n8k8
// fragments and the three-product step, split operands stored per fragment,
// 16-byte cp.async staging, the reductions across a fragment row's four
// threads, which head dims take these kernels; and the bf16
// mma.sync.m16n8k16 step with its ldmatrix loads.
//
// Arithmetic in f32: every product runs as
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32. Each f32 operand x is
// split into big = tf32(x) and small = tf32(x - big), both rounded to
// nearest with ties away from zero, and a product is three mma into one
// zeroed f32 accumulator, in the order small*big, big*small, big*big
// (CUTLASS's OpMultiplyAddFastF32), which an f32 add then takes into the
// running sum (mma3): the tensor cores' own accumulation truncates, and
// chained through the running sum it put the vit-s lanes forward further
// from f64 than 1e-6. The dropped small*small term is ~2^-22 of a product.
//
// bf16 (the bf16 lanes kernels, attention_lanes.cu, and the bf16 tiled
// forward, flash_attention.cu, at every head dim through 128: the generic
// ones padded to BF16_PAD_DH; the KAN kernels, kan_basis_tc.cuh parts 3-4;
// the tiled backward is wgmma, hopper.cuh):
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, one product a 16-deep
// step into the f32 running sum (the products of two bf16 are exact in f32);
// the attention's B operands are loaded from shared memory by ldmatrix, the
// KAN forward's from its pre-pass layout.
//
// Fragments of m16n8k8 (g = lane / 4, t = lane % 4): A holds (g, t),
// (g+8, t), (g, t+4), (g+8, t+4); B holds (k t, n g), (k t+4, n g); the
// accumulator C holds (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1). A C
// fragment becomes the next product's A when the contracted index of each
// 8-wide step is numbered k t <-> 2t, k t+4 <-> 2t+1 (c_as_a); that
// product's B then reads rows 2t and 2t+1 of its tile at column g.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TC_WARPS = 4;  // warps a block
constexpr int TC_PAD = 4;    // a staged f32 tile's row pitch is dh + 4 floats

__host__ __device__ inline bool tc_head_dim(int dh) {
  return dh == 8 || dh == 16 || dh == 32 || dh == 64;
}

// The bf16 lanes kernels and the bf16 tiled forward take every head dim
// that is a multiple of 8 from 8 through 128 (attention_common.cuh's
// generic_head_dim): dh 8, 16, 32 and 64 each on an instantiation of its
// own, every other dh on one instantiation padded to BF16_PAD_DH with the
// true dh passed at run time. Padded, staged rows and A fragments hold dh
// values and zeros past them, the products walk all of DH as at DH itself
// (no branch on dh in the loops: a step past dh adds exact zeros), and the
// stores stop at dh. Padded, a lanes dk/dv block holds the gradients of
// BF16_DKV_SPLIT columns of dh, so that its accumulators fit the registers
// beside the warp's k and v rows: bf16_dkv_halves(dh) blocks a key tile,
// each recomputing the scores.
constexpr int BF16_PAD_DH = 128;
constexpr int BF16_DKV_SPLIT = 64;

__host__ __device__ inline int bf16_dkv_halves(int dh) {
  return tc_head_dim(dh) ? 1 : (dh + BF16_DKV_SPLIT - 1) / BF16_DKV_SPLIT;
}

// Every row of q, k and v (elements of T, strides in elements) starts
// 16-byte aligned (cp.async of 16 bytes; TMA's strides and bases).
template <typename T>
inline bool rows_aligned(const T* q, const T* k, const T* v,
                         long long q_sb, long long q_st, long long q_sh,
                         long long k_sb, long long k_st, long long k_sh,
                         long long v_sb, long long v_st, long long v_sh) {
  const uintptr_t ptrs = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v;
  const long long strides =
      q_sb | q_st | q_sh | k_sb | k_st | k_sh | v_sb | v_st | v_sh;
  return ptrs % 16 == 0 && strides % (16 / (long long)sizeof(T)) == 0;
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both TF32.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// tf32_rna in two integer instructions: add half of the dropped 13 bits'
// range to the magnitude's bits, then clear them. The same bits as
// cvt.rna.tf32.f32 for every finite x; cvt adds a check for inf and NaN
// (the FSETP and SEL of the lanes kernels' SASS). The tiled kernels split
// with it; the lanes kernels keep tf32_rna, and their bits.
__device__ __forceinline__ uint32_t tf32_round(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_round(float x, uint32_t& big,
                                            uint32_t& small) {
  big = tf32_round(x);
  small = tf32_round(x - __uint_as_float(big));
}

// An A fragment (4 floats) or a B fragment (2 floats), split.
template <int N>
struct Frag {
  uint32_t big[N], small[N];
  Frag() = default;
  __device__ __forceinline__ explicit Frag(const float (&x)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) split(x[i], big[i], small[i]);
  }
};

// Frag with the integer split (split_round): the tiled attention's and the
// fused FF's operands.
template <int N>
__device__ __forceinline__ Frag<N> split_frag(const float (&x)[N]) {
  Frag<N> f;
#pragma unroll
  for (int i = 0; i < N; ++i) split_round(x[i], f.big[i], f.small[i]);
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32: small*big, big*small, big*big into a zeroed
// accumulator, which an f32 add (round to nearest) then takes into d.
__device__ __forceinline__ void mma3(float (&d)[4], const Frag<4>& a,
                                     const Frag<2>& b) {
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(c, a.small, b.big);
  mma_tf32(c, a.big, b.small);
  mma_tf32(c, a.big, b.big);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += c[i];
}

// A from a C fragment, the contracted index permuted (c0, c2, c1, c3).
__device__ __forceinline__ Frag<4> c_as_a(const float (&c)[4]) {
  const float a[4] = {c[0], c[2], c[1], c[3]};
  return Frag<4>(a);
}

// B at (k t, n g), (k t+4, n g) of a tile stored (n, k): row g, columns
// t and t+4 of `row_g` (row g's first column of this step).
__device__ __forceinline__ Frag<2> b_row(const float* row_g, float scale = 1.f) {
  const float b[2] = {row_g[0] * scale, row_g[4] * scale};
  return Frag<2>(b);
}

// B at (k t, n g), (k t+4, n g) of a tile stored (k, n) with k permuted:
// rows 2t and 2t+1, column g. `at` points at row 2t, column g.
template <int PITCH>
__device__ __forceinline__ Frag<2> b_pair(const float* at, float scale = 1.f) {
  const float b[2] = {at[0] * scale, at[PITCH] * scale};
  return Frag<2>(b);
}

// Rows of a block's operand kept in shared memory: A at rows r, r+8 and
// columns c, c+4 of a (rows, DH + TC_PAD) tile, `at` pointing at (r, c),
// scaled and split.
template <int PITCH>
__device__ __forceinline__ Frag<4> a_rows(const float* at, float scale = 1.f) {
  const float a[4] = {at[0] * scale, at[8 * PITCH] * scale, at[4] * scale,
                      at[8 * PITCH + 4] * scale};
  return Frag<4>(a);
}

// Split operands laid out per fragment (fused_ffn.cu, kan_basis_tc.cu): an A
// fragment's four big words at `at` in the register order (g, 2t), (g+8, 2t),
// (g, 2t+1), (g+8, 2t+1) and its small words at at + 128; a B fragment's
// big(2t), big(2t+1), small(2t), small(2t+1) in one 16-byte group.
__device__ __forceinline__ void store_a(uint32_t* at, float a0, float a1, float a2,
                                        float a3) {
  uint4 b, s;
  split_round(a0, b.x, s.x);
  split_round(a1, b.y, s.y);
  split_round(a2, b.z, s.z);
  split_round(a3, b.w, s.w);
  *reinterpret_cast<uint4*>(at) = b;
  *reinterpret_cast<uint4*>(at + 128) = s;
}

__device__ __forceinline__ void store_b(uint32_t* at, float b0, float b1) {
  uint4 w;
  split_round(b0, w.x, w.z);
  split_round(b1, w.y, w.w);
  *reinterpret_cast<uint4*>(at) = w;
}

__device__ __forceinline__ Frag<4> load_a(const uint32_t* at) {
  const uint4 b = *reinterpret_cast<const uint4*>(at);
  const uint4 sm = *reinterpret_cast<const uint4*>(at + 128);
  Frag<4> f;
  f.big[0] = b.x;
  f.big[1] = b.y;
  f.big[2] = b.z;
  f.big[3] = b.w;
  f.small[0] = sm.x;
  f.small[1] = sm.y;
  f.small[2] = sm.z;
  f.small[3] = sm.w;
  return f;
}

__device__ __forceinline__ Frag<2> load_b(const uint32_t* at) {
  const uint4 w = *reinterpret_cast<const uint4*>(at);
  Frag<2> f;
  f.big[0] = w.x;
  f.big[1] = w.y;
  f.small[0] = w.z;
  f.small[1] = w.w;
  return f;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(s), "l"(src), "r"(in ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// Stage rows row0 .. row0+ROWS-1 (row r at src + r*stride, dh floats) into
// a (ROWS, DH + TC_PAD) tile with 16-byte cp.async; rows past t_len are
// zero-filled.
template <int DH, int ROWS>
__device__ __forceinline__ void stage_tile(float* dst, const float* src,
                                           long long stride, int row0,
                                           int t_len, int tid) {
  constexpr int CH = DH / 4;  // 16-byte chunks a row
  constexpr int NT = 32 * TC_WARPS;
#pragma unroll
  for (int i = 0; i < (ROWS * CH + NT - 1) / NT; ++i) {
    const int e = tid + i * NT;
    if (ROWS * CH % NT != 0 && e >= ROWS * CH) break;
    const int r = e / CH, c = (e % CH) * 4, row = row0 + r;
    const bool in = row < t_len;
    cp_async16(dst + r * (DH + TC_PAD) + c, in ? src + row * stride + c : src, in);
  }
}

// Max and sum across the four threads of a fragment row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// --- bf16 on mma.sync.m16n8k16 ---------------------------------------------
// Fragments of m16n8k16 (g = lane / 4, t = lane % 4), two bf16 a 32-bit
// word, the lower index in the low half: A holds (g, 2t..2t+1), (g+8,
// 2t..2t+1), (g, 2t+8..2t+9), (g+8, 2t+8..2t+9); B holds (k 2t..2t+1, n g),
// (k 2t+8..2t+9, n g); C as m16n8k8's: (g, 2t), (g, 2t+1), (g+8, 2t),
// (g+8, 2t+1). So the C fragments of two n8 tiles side by side (columns
// 16m .. 16m+7 and 16m+8 .. 16m+15) are, packed, the A fragment of the
// 16-deep step over those columns, with no permutation.

// Two floats rounded to bf16 (to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ldmatrix of 8 x 8 bf16 matrices from shared memory, each row 16 bytes at
// a 16-byte aligned address (`row`: this lane's row of its matrix; lanes
// 0-7 address matrix 0, 8-15 matrix 1). Without .trans lane (g, t) gets
// (row g, columns 2t, 2t+1) of each matrix: a B fragment of a tile stored
// (n, k). With .trans it gets (rows 2t, 2t+1, column g): a B fragment of a
// tile stored (k, n).
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* row) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const void* row) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}

__device__ __forceinline__ uint32_t ldsm_x1(const void* row) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(row);
  uint32_t r;
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.shared.b16 {%0}, [%1];" : "=r"(r) : "r"(a));
  return r;
}

// Stage rows row0 .. row0+ROWS-1 of bf16 (row r at src + r*stride, dh
// values) into a (ROWS, DH + 8) tile with 16-byte cp.async; rows past t_len
// are zero-filled. PAD (a padded DH, dh given at run time): the columns
// past dh are zero-filled too (a cp.async that reads no source), so that
// the products over all of DH add exact zeros there.
template <int DH, int ROWS, bool PAD = false>
__device__ __forceinline__ void stage_tile_bf16(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                long long stride, int row0,
                                                int t_len, int tid, int dh = DH) {
  constexpr int CH = DH / 8;  // 16-byte chunks a row
  constexpr int NT = 32 * TC_WARPS;
#pragma unroll
  for (int i = 0; i < (ROWS * CH + NT - 1) / NT; ++i) {
    const int e = tid + i * NT;
    if (ROWS * CH % NT != 0 && e >= ROWS * CH) break;
    const int r = e / CH, c = (e % CH) * 8, row = row0 + r;
    const bool in = row < t_len && (!PAD || c < dh);
    cp_async16(reinterpret_cast<float*>(dst + r * (DH + 8) + c),
               reinterpret_cast<const float*>(in ? src + row * stride + c : src), in);
  }
}

// The bf16 attention kernels' fragments (attention_lanes.cu,
// flash_attention.cu). KD 16-deep steps span DH (at dh 8 one step, its
// upper half zero); a staged tile has rows of DH + 8 bf16 and STEPS 8-row
// steps. A padded DH walks all of DH: its rows are zero past dh.

// The A fragments of 16 rows of a head (rows g and g + 8 at pa and pb, dh
// bf16 values each, zeros past them), every value times f rounded to bf16
// (fa, fb: 1 takes the rows as they are, 0 a row past t_len).
template <int DH>
__device__ __forceinline__ void bf16_a_rows(const __nv_bfloat16* pa, const __nv_bfloat16* pb,
                                            float fa, float fb, int t,
                                            uint32_t (&a)[(DH + 15) / 16][4], int dh = DH) {
  auto scaled = [&](const __nv_bfloat16* row, int c, float f) -> uint32_t {
    if (c >= dh) return 0u;
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + c));
    return pack_bf16(x.x * f, x.y * f);
  };
#pragma unroll
  for (int kd = 0; kd < (DH + 15) / 16; ++kd) {
    const int c = kd * 16 + 2 * t;
    a[kd][0] = scaled(pa, c, fa);
    a[kd][1] = scaled(pb, c, fb);
    a[kd][2] = scaled(pa, c + 8, fa);
    a[kd][3] = scaled(pb, c + 8, fb);
  }
}

// s[n] = A T^T for the 8-row steps n < steps of a staged tile T (its rows
// n*8 .. n*8+7 are the columns of B, read by ldmatrix), A a warp's 16 rows
// as bf16_a_rows gives them; f32 accumulation, s zeroed first.
template <int DH, int STEPS>
__device__ __forceinline__ void bf16_rows_by_tile(const uint32_t (&a)[(DH + 15) / 16][4],
                                                  const __nv_bfloat16* tile, int steps,
                                                  int lane, float (&s)[STEPS][4]) {
#pragma unroll
  for (int n = 0; n < STEPS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < STEPS; ++n) {
    if (n >= steps) continue;
    const __nv_bfloat16* row = tile + (n * 8 + (lane & 7)) * (DH + 8);
#pragma unroll
    for (int kd = 0; kd < (DH + 15) / 16; ++kd) {
      uint32_t b[2];
      if constexpr (DH >= 16) {
        ldsm_x2(b, row + kd * 16 + ((lane >> 3) & 1) * 8);
      } else {
        b[0] = ldsm_x1(row);
        b[1] = 0u;
      }
      mma_bf16(s[n], a[kd], b);
    }
  }
}

// acc[d] += C T for the 16-row steps m with 2m < steps: C the f32 tiles
// c[2m], c[2m + 1] (8 columns each, a C fragment's layout) rounded to bf16
// as the A fragment over those 16 columns, T the staged tile's rows
// 16m .. 16m + 15 (read by ldmatrix.trans: a row of T is a row of B). acc
// holds the NA n8 tiles of columns 8 d0 .. 8 (d0 + NA) - 1.
template <int DH, int STEPS, int NA = DH / 8>
__device__ __forceinline__ void bf16_c_by_tile(const float (&c)[STEPS][4],
                                               const __nv_bfloat16* tile, int steps, int lane,
                                               float (&acc)[NA][4], int d0 = 0) {
#pragma unroll
  for (int m = 0; m < STEPS / 2; ++m) {
    if (2 * m >= steps) continue;
    const uint32_t pa[4] = {pack_bf16(c[2 * m][0], c[2 * m][1]),
                            pack_bf16(c[2 * m][2], c[2 * m][3]),
                            pack_bf16(c[2 * m + 1][0], c[2 * m + 1][1]),
                            pack_bf16(c[2 * m + 1][2], c[2 * m + 1][3])};
    const __nv_bfloat16* row = tile + (m * 16 + (lane & 15)) * (DH + 8);
#pragma unroll
    for (int d = 0; d < NA; ++d) {
      uint32_t b[2];
      ldsm_x2_trans(b, row + (d0 + d) * 8);
      mma_bf16(acc[d], pa, b);
    }
  }
}

// Two f32 accumulators of a C fragment, rounded to bf16, at dst (a pair).
__device__ __forceinline__ void store_bf16_pair(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<uint32_t*>(dst) = pack_bf16(a, b);
}

}  // namespace
