// Tiled attention over (B, H, T, dh) tensors, forward and backward.
//
// Replaces the TPU kernels of kanvit/kernels/flash_attention.py that
// flash_attention (:873) reaches past one tile:
//   forward:  _fwd_pallas (pallas_call at :132, body _fwd_kernel :66-123);
//   backward: _flash_bwd's dq kernel (pallas_call at :806, body
//             _bwd_dq_kernel :176-223) and its dk/dv kernel (:831, body
//             _bwd_dkv_kernel :226-272).
// On bf16 operands (kanvit's bf16 policy, the causal decoder's --bf16) the
// same three run as flash_fwd_bf16 (mma.sync), flash_dq_bf16 and
// flash_dkv_bf16 (wgmma on TMA-fed tiles, warp-specialised: hopper.cuh),
// below the f32 tensor-core kernels, at every head dim the f32 kernels
// take (the decoder's --heads 2: dh 128).
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
// 4*B*H*T*dh*4 B = 134 MB of q, k, v and o: arithmetic bounds them, 0.21 ms
// at the dense TF32 rate for three TF32 products an f32 one, and the expf of
// every score. The backward recomputes the scores in both of its kernels
// (7 products in all).
//
// Head dims 8, 16, 32 and 64 run the tensor-core kernels below; every other
// multiple of 8 through 128 runs the generic CUDA-core kernels at the end
// of the file (attention_common.cuh).
//
// -- Arithmetic: 3xTF32 on mma.sync.m16n8k8 (attention_tc.cuh), as the
// lanes kernels: each f32 operand split into two TF32 parts, three products
// a step into a zeroed accumulator, an f32 add into the running sum. IEEE
// expf (never __expf or ex2.approx, which would change the rows that see no
// valid key). Masks are applied to S after the products, as the finite
// NEG_INF; keys and queries past T are zero-filled and invalid.
//
// -- Layout. A block is 4 warps and owns 64 resident rows, 16 a warp
// (queries in the forward and dq, keys in dk/dv), and streams tiles of the
// other side: 32 keys (forward), 16 keys (dq) or 16 queries (dk/dv). What
// bounded the lanes kernels was the instructions beside each mma, above all
// the operand splits each warp repeated on its own fragments. Here each
// streamed tile lands in shared memory by 16-byte cp.async and is split
// once, by the whole block, into big/small TF32 words laid out so that
// every fragment is 16-byte loads (the rows, pairs and afrags layouts
// below; split_rows_pairs writes a tile's two layouts from one read). No
// split remains in the product loops but that of P and dS, which go from
// the accumulator registers into the next product (c_as_a_round: the
// contracted index renumbered, as in the lanes kernels; dk/dv computes
// S^T = K (q scale)^T and dP^T = V do^T itself, so P^T and dS^T take the
// same route). The resident rows are split once too: the forward's and
// dq's q in registers (A fragments), dq's do and dk/dv's k and v in shared
// memory. Per tile: wait for the copy, barrier, split, barrier, start the
// next tile's copy, compute; the copy overlaps the products. Each exp is
// computed for every score and then selected, never under a branch. Block
// shapes and tiles are set by registers and shared memory: the forward
// caps registers at 168 for 3 blocks an SM, dq (255 registers, 66 KB) and
// dk/dv (201, 107 KB) run 2; what bounds them then is latency (PERF.md).
//
// -- Semantics on the tiles. A block stops at its causal frontier only when
// no live row still has m == NEG_INF (such a row takes every later valid
// key); a warp skips a key tile past its last row unless one of its rows
// has m == NEG_INF, and masks the rest per score. dq skips keys past its
// rows (ds is 0 there). dk/dv skips the query tiles that see none of its
// keys causally only when no row before the block's last key has
// m == NEG_INF (read from stats); else it streams every query tile. Causal
// blocks of the forward and dq are launched longest first (the query tile
// is the slowest grid dimension, reversed); dk/dv's longest key tile is the
// first. Two backward kernels, one per query tile (dq, which writes delta)
// and one per key tile (dk, dv), each summing in a fixed order: no
// atomics, the bits repeat.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_common.cuh"
#include "attention_tc.cuh"
#include "hopper.cuh"

namespace {

constexpr int BQ = 64;   // query rows per generic forward block, one thread each
constexpr int BKV = 32;  // keys per staged generic forward tile
constexpr int BR = 64;   // rows per generic backward block
constexpr int BT = 32;   // rows per staged generic backward tile
constexpr float EPSILON = 1e-10f;
constexpr float NEG_INF = -FLT_MAX;

// A (B, T, H, dh) tensor of T read through its strides (in elements).
template <typename T>
struct StridedView {
  const T* p;
  long long sb, st, sh;
  __device__ __forceinline__ const T* at(int b, int t, int h) const {
    return p + b * sb + t * st + h * sh;
  }
};
using View = StridedView<float>;
using View16 = StridedView<__nv_bfloat16>;

__device__ __forceinline__ bool key_ok(const uint8_t* mask, int b, int tk,
                                       int key) {
  return key < tk && (mask == nullptr || mask[(long long)b * tk + key] != 0);
}

// The tensor-core kernels' grids hold the 64-row tiles in z (at most 65535).
bool bad_dims(int batch, int tq, int tk, int heads) {
  return batch <= 0 || tq <= 0 || tk <= 0 || heads <= 0 || batch > 65535 ||
         heads > 65535 || tq > 65535 * 64 || tk > 65535 * 64;
}

// --- tensor-core kernels: dh 8, 16, 32, 64 ---------------------------------

constexpr int NT = 32 * TC_WARPS;       // threads a block
constexpr int TC_ROWS = 16 * TC_WARPS;  // resident rows a block
constexpr int FWD_KEYS = 32;            // keys a streamed forward tile
constexpr int DQ_KEYS = 16;             // keys a streamed dq tile
constexpr int DKV_QUERIES = 16;         // queries a streamed dk/dv tile

// Split operands in shared memory, 32-bit TF32 words laid out so that
// each thread's fragment is 16-byte loads, with no padding:
//   rows:   an (R, DH) tile, row r's 8-column step s at words
//           r*2DH + 16*(s ^ (r & 1)) + 4t + [big(c t), big(c t+4),
//           small(c t), small(c t+4)] of its columns 8s + t, 8s + t + 4:
//           the B fragment (k t, n g) of a tile stored (n, k), at row g;
//   pairs:  an (R, DH) tile stored by column, column c's 8-row step s at
//           c*2R + 16*(s ^ (c & 1)) + 4t + [big(2t), big(2t+1), small(2t),
//           small(2t+1)] of its rows 8s + 2t, 8s + 2t + 1: the B fragment of
//           a tile stored (k, n) with k renumbered, at column g;
//   afrags: R resident rows, block w of 16 rows and 8-column step kd at
//           (w*KD + kd)*256: the 32 lanes' big parts, 4 words each in the A
//           register order (g, t), (g+8, t), (g, t+4), (g+8, t+4), then
//           their small parts.
// The swizzle (s ^ parity) puts the 16-byte loads of each quarter-warp
// (rows or columns g, g+1; t = 0..3) on 32 distinct banks; at dh 8 a row
// is one 16-word step and needs none.
template <int DH>
__device__ __forceinline__ int rows_word(int r, int s) {
  return r * 2 * DH + 16 * (DH > 8 ? s ^ (r & 1) : s);
}

template <int R>
__device__ __forceinline__ int pairs_word(int c, int s) {
  return c * 2 * R + 16 * (s ^ (c & 1));
}

// c_as_a with the integer split.
__device__ __forceinline__ Frag<4> c_as_a_round(const float (&c)[4]) {
  const float a[4] = {c[0], c[2], c[1], c[3]};
  return split_frag(a);
}

// One thread's B fragments of a rows or pairs tile (PITCH = 2DH or 2R
// words): at(i, j) is the fragment of rows (columns) 8i .. 8i+7, step j.
template <int PITCH, bool SWIZZLED>
struct TileB {
  const uint32_t* even;
  const uint32_t* odd;
  __device__ __forceinline__ TileB(const uint32_t* tile, int g, int t) {
    const int sw = SWIZZLED ? 16 * (g & 1) : 0;
    even = tile + g * PITCH + 4 * t + sw;
    odd = tile + g * PITCH + 4 * t - sw;
  }
  __device__ __forceinline__ Frag<2> at(int i, int j) const {
    const uint4 w = *reinterpret_cast<const uint4*>((j & 1 ? odd : even) +
                                                   i * 8 * PITCH + 16 * j);
    Frag<2> f;
    f.big[0] = w.x;
    f.big[1] = w.y;
    f.small[0] = w.z;
    f.small[1] = w.w;
    return f;
  }
};

template <int DH>
using RowsB = TileB<2 * DH, (DH > 8)>;
template <int R>
using PairsB = TileB<2 * R, true>;

// The A fragment of an afrags tile; `at`: the block's step, plus 4 lane.
__device__ __forceinline__ Frag<4> a_frag(const uint32_t* at) {
  const uint4 b = *reinterpret_cast<const uint4*>(at);
  const uint4 s = *reinterpret_cast<const uint4*>(at + 128);
  Frag<4> f;
  f.big[0] = b.x;
  f.big[1] = b.y;
  f.big[2] = b.z;
  f.big[3] = b.w;
  f.small[0] = s.x;
  f.small[1] = s.y;
  f.small[2] = s.z;
  f.small[3] = s.w;
  return f;
}

// A staged (R, DH + TC_PAD) tile into a rows tile.
template <int DH, int R>
__device__ __forceinline__ void split_rows(uint32_t* dst, const float* raw, int tid) {
  constexpr int KD = DH / 8, UNITS = R * KD * 4;
#pragma unroll
  for (int i = 0; i < (UNITS + NT - 1) / NT; ++i) {
    const int u = tid + i * NT;
    if (UNITS % NT != 0 && u >= UNITS) break;
    const int t = u & 3, kd = (u >> 2) % KD, r = (u >> 2) / KD;
    const float* at = raw + r * (DH + TC_PAD) + kd * 8 + t;
    uint4 w;
    split_round(at[0], w.x, w.z);
    split_round(at[4], w.y, w.w);
    *reinterpret_cast<uint4*>(dst + rows_word<DH>(r, kd) + 4 * t) = w;
  }
}

// A staged (R, DH + TC_PAD) tile into a pairs tile.
template <int DH, int R>
__device__ __forceinline__ void split_pairs(uint32_t* dst, const float* raw, int tid) {
  constexpr int UNITS = DH * (R / 8) * 4;
#pragma unroll
  for (int i = 0; i < (UNITS + NT - 1) / NT; ++i) {
    const int u = tid + i * NT;
    if (UNITS % NT != 0 && u >= UNITS) break;
    const int t = u & 3, c = (u >> 2) % DH, s = (u >> 2) / DH;
    const float* at = raw + (s * 8 + 2 * t) * (DH + TC_PAD) + c;
    uint4 w;
    split_round(at[0], w.x, w.z);
    split_round(at[DH + TC_PAD], w.y, w.w);
    *reinterpret_cast<uint4*>(dst + pairs_word<R>(c, s) + 4 * t) = w;
  }
}

// A staged (R, DH + TC_PAD) tile, times scale, into a rows and a pairs
// tile at once: each thread splits a 2x2 block (rows 2p, 2p+1; columns
// c, c+4) and writes its two rows' and two columns' words.
template <int DH, int R>
__device__ __forceinline__ void split_rows_pairs(uint32_t* rows, uint32_t* pairs,
                                                 const float* raw, float scale,
                                                 int tid) {
  constexpr int KD = DH / 8, UNITS = (R / 2) * KD * 4;
#pragma unroll
  for (int i = 0; i < (UNITS + NT - 1) / NT; ++i) {
    const int u = tid + i * NT;
    if (UNITS % NT != 0 && u >= UNITS) break;
    const int t = u & 3, tp = (u >> 2) & 3, kd = (u >> 4) % KD, s = (u >> 4) / KD;
    const int r0 = s * 8 + 2 * tp, c0 = kd * 8 + t;
    const float* at = raw + r0 * (DH + TC_PAD) + c0;
    uint32_t b00, s00, b01, s01, b10, s10, b11, s11;
    split_round(at[0] * scale, b00, s00);
    split_round(at[4] * scale, b01, s01);
    split_round(at[DH + TC_PAD] * scale, b10, s10);
    split_round(at[DH + TC_PAD + 4] * scale, b11, s11);
    *reinterpret_cast<uint4*>(rows + rows_word<DH>(r0, kd) + 4 * t) =
        make_uint4(b00, b01, s00, s01);
    *reinterpret_cast<uint4*>(rows + rows_word<DH>(r0 + 1, kd) + 4 * t) =
        make_uint4(b10, b11, s10, s11);
    *reinterpret_cast<uint4*>(pairs + pairs_word<R>(c0, s) + 4 * tp) =
        make_uint4(b00, b10, s00, s10);
    *reinterpret_cast<uint4*>(pairs + pairs_word<R>(c0 + 4, s) + 4 * tp) =
        make_uint4(b01, b11, s01, s11);
  }
}

// Rows row0 .. row0+TC_ROWS-1 of src (row r at src + r*stride; rows past
// t_len read as 0) into an afrags tile.
template <int DH>
__device__ __forceinline__ void split_afrags(uint32_t* dst, const float* src,
                                             long long stride, int row0,
                                             int t_len, int tid) {
  constexpr int KD = DH / 8, UNITS = TC_WARPS * KD * 32;
#pragma unroll
  for (int i = 0; i < UNITS / NT; ++i) {
    const int u = tid + i * NT;
    const int lane = u & 31, kd = (u >> 5) % KD, w = (u >> 5) / KD;
    const int ra = row0 + w * 16 + (lane >> 2), rb = ra + 8;
    const int c = kd * 8 + (lane & 3);
    const float* pa = src + ra * stride + c;
    const float* pb = src + rb * stride + c;
    const bool ia = ra < t_len, ib = rb < t_len;
    uint4 big, small;
    split_round(ia ? pa[0] : 0.f, big.x, small.x);
    split_round(ib ? pb[0] : 0.f, big.y, small.y);
    split_round(ia ? pa[4] : 0.f, big.z, small.z);
    split_round(ib ? pb[4] : 0.f, big.w, small.w);
    uint32_t* at = dst + (w * KD + kd) * 256 + lane * 4;
    *reinterpret_cast<uint4*>(at) = big;
    *reinterpret_cast<uint4*>(at + 128) = small;
  }
}

// A 4- or 8-byte cp.async (cached); zero-filled when !in.
template <int BYTES>
__device__ __forceinline__ void cp_async_small(void* dst, const void* src, bool in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;"
               :: "r"(s), "l"(src), "n"(BYTES), "r"(in ? BYTES : 0) : "memory");
}

// Bit j of the result: key k0 + j is valid (below tk and not masked). One
// warp's ballot; every lane gets the word.
__device__ __forceinline__ unsigned key_bits(const uint8_t* mask, int b, int tk,
                                             int k0, int lane) {
  return __ballot_sync(0xffffffffu, key_ok(mask, b, tk, k0 + lane));
}

// Dynamic shared memory of each kernel, in bytes.
template <int DH>
constexpr size_t fwd_smem() {
  return sizeof(float) * (2 * FWD_KEYS * (DH + TC_PAD) + 2 * FWD_KEYS * 2 * DH);
}
template <int DH>
constexpr size_t dq_smem() {
  return sizeof(float) * (2 * DQ_KEYS * (DH + TC_PAD) +
                          (3 * DQ_KEYS + TC_ROWS) * 2 * DH);
}
template <int DH>
constexpr size_t dkv_smem() {
  return sizeof(float) * (2 * DKV_QUERIES * (DH + TC_PAD) +
                          (4 * DKV_QUERIES + 2 * TC_ROWS) * 2 * DH);
}

// Forward. One block per (head, batch, 64 query rows), the query tiles
// longest first; warp w owns rows q0 + 16w .. +15, its q rows (scaled) as
// split A fragments in registers.
template <int DH>
__global__ void __launch_bounds__(NT, 3)
flash_fwd_tc(View q, View k, View v, const uint8_t* __restrict__ mask,
             float* __restrict__ o, float* __restrict__ stats, int tq, int tk,
             int heads, int causal, float scale) {
  constexpr int KD = DH / 8, RAW = DH + TC_PAD, STEPS = FWD_KEYS / 8;
  extern __shared__ __align__(16) float smem[];
  float* kraw = smem;                                   // [FWD_KEYS][RAW]
  float* vraw = kraw + FWD_KEYS * RAW;                  // [FWD_KEYS][RAW]
  uint32_t* ks = reinterpret_cast<uint32_t*>(vraw + FWD_KEYS * RAW);  // rows
  uint32_t* vs = ks + FWD_KEYS * 2 * DH;                // pairs
  __shared__ unsigned kbits;                            // key_bits of the tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * TC_ROWS;
  const int r0 = q0 + warp * 16;
  const bool active = r0 < tq;
  const int ra = r0 + g, rb = ra + 8;
  const bool la = ra < tq, lb = rb < tq;
  const int diff = max(tk - tq, 0);
  // Keys the warp's rows may see: below tk and, causal, at or before its
  // last live row's position.
  const int wkeys = causal ? min(tk, min(r0 + 15, tq - 1) - diff + 1) : tk;
  const RowsB<DH> kB(ks, g, t);         // B of S = (q scale) K^T: at(n, kd)
  const PairsB<FWD_KEYS> vB(vs, g, t);  // B of O += P V: at(d, n)

  Frag<4> qf[KD];
  {
    const float* qa = q.at(b, min(ra, tq - 1), h);
    const float* qb = q.at(b, min(rb, tq - 1), h);
    const float fa = la ? scale : 0.f, fb = lb ? scale : 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      const int c = kd * 8 + t;
      const float x[4] = {qa[c] * fa, qb[c] * fb, qa[c + 4] * fa, qb[c + 4] * fb};
      qf[kd] = split_frag(x);
    }
  }
  float acc[KD][4];
#pragma unroll
  for (int d = 0; d < KD; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float ma = NEG_INF, mb = NEG_INF, sa = 0.f, sb = 0.f;  // running max and sum

  // Keys past the block's last row are causally masked for all its rows.
  const int frontier = causal ? min(tk, max(0, q0 + TC_ROWS - diff)) : tk;
  const int tiles = (tk + FWD_KEYS - 1) / FWD_KEYS;
  const float* kh = k.at(b, 0, h);
  const float* vh = v.at(b, 0, h);
  auto stage = [&](int tile) {
    stage_tile<DH, FWD_KEYS>(kraw, kh, k.st, tile * FWD_KEYS, tk, tid);
    stage_tile<DH, FWD_KEYS>(vraw, vh, v.st, tile * FWD_KEYS, tk, tid);
    cp_async_commit();
  };
  stage(0);
  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * FWD_KEYS;
    cp_async_wait<0>();
    const bool dead = (la && ma == NEG_INF) || (lb && mb == NEG_INF);
    // Past the frontier only a row with no valid key so far still changes.
    if (!__syncthreads_or(k0 < frontier || dead)) break;
    split_rows<DH, FWD_KEYS>(ks, kraw, tid);
    split_pairs<DH, FWD_KEYS>(vs, vraw, tid);
    if (warp == 0) {
      const unsigned bits = key_bits(mask, b, tk, k0, lane);
      if (lane == 0) kbits = bits;
    }
    __syncthreads();  // the split tile is ready, the staged one free
    if (it + 1 < tiles) stage(it + 1);

    // Skip the tile when no row of the warp sees one of its keys, unless a
    // row has m == NEG_INF: it takes every valid key, seen or not. Every
    // 8-key step is computed otherwise; the masks below zero what lies
    // past a row.
    if (!active || (k0 >= wkeys && !__any_sync(0xffffffffu, dead))) continue;
    const unsigned kv = kbits >> (2 * t);  // bit 8n + c: key k0 + 8n + 2t + c
    // key k0 + j (j = 8n + 2t + (c & 1)) is causally seen by row ra iff
    // 8n + (c & 1) <= ra - diff - k0 - 2t
    const int lim_a = causal ? ra - diff - k0 - 2 * t : FWD_KEYS;
    const int lim_b = causal ? rb - diff - k0 - 2 * t : FWD_KEYS;
    float s[STEPS][4];
#pragma unroll
    for (int n = 0; n < STEPS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
#pragma unroll
      for (int n = 0; n < STEPS; ++n) mma3(s[n], qf[kd], kB.at(n, kd));
    float mxa = ma, mxb = mb;
#pragma unroll
    for (int n = 0; n < STEPS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = n * 8 + (c & 1);
        const bool ok = ((kv >> j) & 1u) && j <= (c < 2 ? lim_a : lim_b);
        s[n][c] = ok ? s[n][c] : NEG_INF;
        if (c < 2) mxa = fmaxf(mxa, s[n][c]);
        else mxb = fmaxf(mxb, s[n][c]);
      }
    mxa = quad_max(mxa);
    mxb = quad_max(mxb);
    const float ca = expf(ma - mxa), cb = expf(mb - mxb);
    float ta = 0.f, tb = 0.f;
#pragma unroll
    for (int n = 0; n < STEPS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        // 1 on a valid, causally masked key of a row whose max is NEG_INF
        const int j = n * 8 + (c & 1);
        const float e = expf(s[n][c] - (c < 2 ? mxa : mxb));  // in [0, 1]
        s[n][c] = ((kv >> j) & 1u) ? e : 0.f;
        if (c < 2) ta += s[n][c];
        else tb += s[n][c];
      }
    sa = ca * sa + fmaxf(quad_sum(ta), EPSILON);
    sb = cb * sb + fmaxf(quad_sum(tb), EPSILON);
    ma = mxa;
    mb = mxb;
    if (__any_sync(0xffffffffu, ca != 1.f || cb != 1.f)) {  // a max moved
#pragma unroll
      for (int d = 0; d < KD; ++d) {
        acc[d][0] *= ca;
        acc[d][1] *= ca;
        acc[d][2] *= cb;
        acc[d][3] *= cb;
      }
    }
#pragma unroll
    for (int n = 0; n < STEPS; ++n) {
      const Frag<4> pa = c_as_a_round(s[n]);
#pragma unroll
      for (int d = 0; d < KD; ++d) mma3(acc[d], pa, vB.at(d, n));
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? rb : ra;
    if (row >= tq) continue;
    const float lc = fmaxf(half ? sb : sa, EPSILON);
    float* op = o + (((long long)b * tq + row) * heads + h) * DH + 2 * t;
#pragma unroll
    for (int d = 0; d < KD; ++d)
      *reinterpret_cast<float2*>(op + d * 8) =
          make_float2(acc[d][2 * half] / lc, acc[d][2 * half + 1] / lc);
    if (stats != nullptr && t == 0) {
      float* sp = stats + (((long long)b * heads + h) * tq + row) * 2;
      sp[0] = half ? mb : ma;
      sp[1] = lc;
    }
  }
}

// dq and delta. One block per (head, batch, 64 query rows), the query tiles
// longest first; warp w owns rows q0 + 16w .. +15: its q rows (scaled) as
// split A fragments in registers, the block's do rows split in shared
// memory. Streams K and V tiles up to the block's causal frontier.
template <int DH>
__global__ void __launch_bounds__(NT)
flash_dq_tc(View q, View k, View v, const uint8_t* __restrict__ mask,
            const float* __restrict__ o, const float* __restrict__ dout,
            const float* __restrict__ stats, float* __restrict__ delta_out,
            float* __restrict__ dq, int tq, int tk, int heads, int causal,
            float scale) {
  constexpr int KD = DH / 8, RAW = DH + TC_PAD, STEPS = DQ_KEYS / 8;
  extern __shared__ __align__(16) float smem[];
  float* kraw = smem;                                   // [DQ_KEYS][RAW]
  float* vraw = kraw + DQ_KEYS * RAW;                   // [DQ_KEYS][RAW]
  uint32_t* ks = reinterpret_cast<uint32_t*>(vraw + DQ_KEYS * RAW);  // rows
  uint32_t* vs = ks + DQ_KEYS * 2 * DH;                 // rows
  uint32_t* kp = vs + DQ_KEYS * 2 * DH;                 // pairs
  uint32_t* dos = kp + DQ_KEYS * 2 * DH;                // afrags, TC_ROWS rows
  __shared__ unsigned kbits;                            // key_bits of the tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * TC_ROWS;
  const int r0 = q0 + warp * 16;
  const bool active = r0 < tq;
  const int ra = r0 + g, rb = ra + 8;
  const bool la = ra < tq, lb = rb < tq;
  const int diff = max(tk - tq, 0);
  const int wkeys = causal ? min(tk, min(r0 + 15, tq - 1) - diff + 1) : tk;
  const RowsB<DH> kB(ks, g, t);        // B of S = (q scale) K^T: at(n, kd)
  const RowsB<DH> vB(vs, g, t);        // B of dP = do V^T: at(n, kd)
  const PairsB<DQ_KEYS> kpB(kp, g, t);  // B of dQ += dS K: at(d, n)
  const uint32_t* dw = dos + warp * KD * 256 + lane * 4;  // A of step kd: + 256 kd
  const long long hs = (long long)heads * DH;  // row stride of o, do and dq
  const float* doh = dout + (long long)b * tq * hs + h * DH;
  const float* oh = o + (long long)b * tq * hs + h * DH;
  const long long srow = ((long long)b * heads + h) * tq;  // of stats, delta

  // The block's do rows; the first barrier of the loop publishes them.
  split_afrags<DH>(dos, doh, hs, q0, tq, tid);
  Frag<4> qf[KD];
  float dla = 0.f, dlb = 0.f;  // delta = rowsum(do * o)
  {
    const int ca = min(ra, tq - 1), cb = min(rb, tq - 1);
    const float* qa = q.at(b, ca, h);
    const float* qb = q.at(b, cb, h);
    const float fa = la ? scale : 0.f, fb = lb ? scale : 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      const int c = kd * 8 + t;
      const float x[4] = {qa[c] * fa, qb[c] * fb, qa[c + 4] * fa, qb[c + 4] * fb};
      qf[kd] = split_frag(x);
#pragma unroll
      for (int e = 0; e < 8; e += 4) {
        dla = fmaf(doh[ca * hs + c + e], oh[ca * hs + c + e], dla);
        dlb = fmaf(doh[cb * hs + c + e], oh[cb * hs + c + e], dlb);
      }
    }
  }
  dla = quad_sum(dla);
  dlb = quad_sum(dlb);
  const float ma = la ? stats[(srow + ra) * 2] : 0.f;
  const float mb = lb ? stats[(srow + rb) * 2] : 0.f;
  const float rla = la ? 1.f / stats[(srow + ra) * 2 + 1] : 0.f;
  const float rlb = lb ? 1.f / stats[(srow + rb) * 2 + 1] : 0.f;

  float acc[KD][4];
#pragma unroll
  for (int d = 0; d < KD; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  // ds is 0 wherever the causal mask applies, so keys past the block's last
  // row add nothing to dq.
  const int kend = causal ? min(tk, max(0, q0 + TC_ROWS - diff)) : tk;
  const int tiles = (kend + DQ_KEYS - 1) / DQ_KEYS;
  const float* kh = k.at(b, 0, h);
  const float* vh = v.at(b, 0, h);
  auto stage = [&](int tile) {
    stage_tile<DH, DQ_KEYS>(kraw, kh, k.st, tile * DQ_KEYS, tk, tid);
    stage_tile<DH, DQ_KEYS>(vraw, vh, v.st, tile * DQ_KEYS, tk, tid);
    cp_async_commit();
  };
  if (tiles > 0) stage(0);
  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * DQ_KEYS;
    cp_async_wait<0>();
    __syncthreads();  // the staged tile has landed; the split one is free
    split_rows_pairs<DH, DQ_KEYS>(ks, kp, kraw, 1.f, tid);
    split_rows<DH, DQ_KEYS>(vs, vraw, tid);
    if (warp == 0) {
      const unsigned bits = key_bits(mask, b, tk, k0, lane);
      if (lane == 0) kbits = bits;
    }
    __syncthreads();  // the split tiles are ready, the staged ones free
    if (it + 1 < tiles) stage(it + 1);

    // Every 8-key step of a tile with a key the warp's rows see; the masks
    // zero ds past a row.
    if (!active || k0 >= wkeys) continue;
    const unsigned kv = kbits >> (2 * t);  // bit 8n + c: key k0 + 8n + 2t + c
    // key k0 + 8n + 2t + (c & 1) is seen by row r iff 8n + (c & 1) <= lim
    const int lim_a = !la ? -1 : causal ? ra - diff - k0 - 2 * t : DQ_KEYS;
    const int lim_b = !lb ? -1 : causal ? rb - diff - k0 - 2 * t : DQ_KEYS;
    float s[STEPS][4], dp[STEPS][4];
#pragma unroll
    for (int n = 0; n < STEPS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = dp[n][c] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      const Frag<4> df = a_frag(dw + kd * 256);
#pragma unroll
      for (int n = 0; n < STEPS; ++n) {
        mma3(s[n], qf[kd], kB.at(n, kd));
        mma3(dp[n], df, vB.at(n, kd));
      }
    }
#pragma unroll
    for (int n = 0; n < STEPS; ++n)  // s becomes ds
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = n * 8 + (c & 1);
        const bool hi = c >= 2;
        const bool ok = ((kv >> j) & 1u) && j <= (hi ? lim_b : lim_a);
        // computed for every entry, then selected: no branch a score
        const float p = expf(s[n][c] - (hi ? mb : ma)) * (hi ? rlb : rla);
        s[n][c] = ok ? p * (dp[n][c] - (hi ? dlb : dla)) : 0.f;
      }
#pragma unroll
    for (int n = 0; n < STEPS; ++n) {
      const Frag<4> da = c_as_a_round(s[n]);
#pragma unroll
      for (int d = 0; d < KD; ++d) mma3(acc[d], da, kpB.at(d, n));
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? rb : ra;
    if (row >= tq) continue;
    float* dqp = dq + ((long long)b * tq + row) * hs + h * DH + 2 * t;
#pragma unroll
    for (int d = 0; d < KD; ++d)
      *reinterpret_cast<float2*>(dqp + d * 8) =
          make_float2(acc[d][2 * half] * scale, acc[d][2 * half + 1] * scale);
    if (t == 0) delta_out[srow + row] = half ? dlb : dla;
  }
}

// dk and dv. One block per (head, batch, 64 keys); warp w owns keys
// k0 + 16w .. +15, the block's k and v rows split in shared memory (A
// fragments). Streams q (scaled) and do tiles, reading the forward's (m, l)
// and the dq kernel's delta.
template <int DH>
__global__ void __launch_bounds__(NT)
flash_dkv_tc(View q, View k, View v, const uint8_t* __restrict__ mask,
             const float* __restrict__ dout, const float* __restrict__ stats,
             const float* __restrict__ delta, float* __restrict__ dk,
             float* __restrict__ dv, int tq, int tk, int heads, int causal,
             float scale) {
  constexpr int KD = DH / 8, RAW = DH + TC_PAD, STEPS = DKV_QUERIES / 8;
  constexpr int TILE = DKV_QUERIES * 2 * DH;  // words of a split tile
  extern __shared__ __align__(16) float smem[];
  float* qraw = smem;                                     // [DKV_QUERIES][RAW]
  float* draw = qraw + DKV_QUERIES * RAW;                 // [DKV_QUERIES][RAW]
  uint32_t* qr = reinterpret_cast<uint32_t*>(draw + DKV_QUERIES * RAW);  // rows
  uint32_t* dr = qr + TILE;                               // rows
  uint32_t* qp = dr + TILE;                               // pairs
  uint32_t* dp = qp + TILE;                               // pairs
  uint32_t* kres = dp + TILE;                             // afrags, TC_ROWS rows
  uint32_t* vres = kres + TC_ROWS * 2 * DH;               // afrags
  __shared__ float mrow[DKV_QUERIES], lrow[DKV_QUERIES], drow[DKV_QUERIES];
  __shared__ __align__(8) float2 ml_raw[DKV_QUERIES];  // staged (m, l) and delta
  __shared__ float delta_raw[DKV_QUERIES];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * TC_ROWS;  // key tile 0 sees the most queries
  const int j0 = k0 + warp * 16;        // the warp's first key
  const bool active = j0 < tk;
  const int ja = j0 + g, jb = ja + 8;
  const bool va = key_ok(mask, b, tk, ja), vb = key_ok(mask, b, tk, jb);
  const int diff = max(tk - tq, 0);
  const long long hs = (long long)heads * DH;  // row stride of do, dk and dv
  const long long srow = ((long long)b * heads + h) * tq;  // of stats, delta
  const RowsB<DH> qB(qr, g, t);             // B of S^T = K (q scale)^T: at(n, kd)
  const RowsB<DH> doB(dr, g, t);            // B of dP^T = V do^T: at(n, kd)
  const PairsB<DKV_QUERIES> qpB(qp, g, t);  // B of dK += dS^T (q scale): at(d, n)
  const PairsB<DKV_QUERIES> dopB(dp, g, t); // B of dV += P^T do: at(d, n)
  const uint32_t* kw = kres + warp * KD * 256 + lane * 4;  // A of step kd: + 256 kd
  const uint32_t* vw = vres + warp * KD * 256 + lane * 4;

  // The block's k and v rows; the first barrier of the loop publishes them.
  split_afrags<DH>(kres, k.at(b, 0, h), k.st, k0, tk, tid);
  split_afrags<DH>(vres, v.at(b, 0, h), v.st, k0, tk, tid);
  float dka[KD][4], dva[KD][4];
#pragma unroll
  for (int d = 0; d < KD; ++d)
#pragma unroll
    for (int c = 0; c < 4; ++c) dka[d][c] = dva[d][c] = 0.f;

  // Causal: query i sees key j only for i - diff >= j. A query that sees
  // none of the block's keys adds only where it saw no valid key at all
  // (m = NEG_INF: p = 1/l on every valid key, into dv). Unless a row before
  // the one that sees the block's last key is such a row, the block starts
  // at the first query that sees its first key and each warp skips the
  // tiles that see none of its keys; else it streams every query.
  bool skip = false;
  int i_start = 0;
  if (causal) {
    const int scan = min(tq, k0 + TC_ROWS - 1 + diff);
    bool dead = false;
    for (int r = tid; r < scan; r += NT) dead |= stats[(srow + r) * 2] == NEG_INF;
    skip = !__syncthreads_or(dead);
    if (skip) i_start = min(tq, k0 + diff) / DKV_QUERIES * DKV_QUERIES;
  }
  const int tiles = (tq - i_start + DKV_QUERIES - 1) / DKV_QUERIES;
  const float* qh = q.at(b, 0, h);
  const float* doh = dout + (long long)b * tq * hs + h * DH;
  // A tile's q and do rows, and its queries' (m, l) and delta, in one
  // group: no load of the tile waits on device memory in the loop.
  auto stage = [&](int tile) {
    const int i0 = i_start + tile * DKV_QUERIES;
    stage_tile<DH, DKV_QUERIES>(qraw, qh, q.st, i0, tq, tid);
    stage_tile<DH, DKV_QUERIES>(draw, doh, hs, i0, tq, tid);
    if (tid < DKV_QUERIES) {
      const int qi = i0 + tid;
      const bool in = qi < tq;
      cp_async_small<8>(&ml_raw[tid], stats + (srow + (in ? qi : 0)) * 2, in);
      cp_async_small<4>(&delta_raw[tid], delta + srow + (in ? qi : 0), in);
    }
    cp_async_commit();
  };
  if (tiles > 0) stage(0);
  for (int it = 0; it < tiles; ++it) {
    const int i0 = i_start + it * DKV_QUERIES;
    cp_async_wait<0>();
    __syncthreads();  // the staged tile has landed; the split one is free
    split_rows_pairs<DH, DKV_QUERIES>(qr, qp, qraw, scale, tid);
    split_rows_pairs<DH, DKV_QUERIES>(dr, dp, draw, 1.f, tid);
    if (tid < DKV_QUERIES) {
      const bool in = i0 + tid < tq;
      mrow[tid] = in ? ml_raw[tid].x : 0.f;
      lrow[tid] = in ? 1.f / ml_raw[tid].y : 0.f;
      drow[tid] = in ? delta_raw[tid] : 0.f;
    }
    __syncthreads();  // the split tiles are ready, the staged ones free
    if (it + 1 < tiles) stage(it + 1);

    // Skipping, a tile whose last query sees none of the warp's keys adds
    // nothing; every 8-query step is computed otherwise, the masks zeroing
    // p and ds where a query does not see a key.
    if (!active || (skip && i0 + DKV_QUERIES - 1 - diff < j0)) continue;
    float st[STEPS][4], dpt[STEPS][4];
#pragma unroll
    for (int n = 0; n < STEPS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) st[n][c] = dpt[n][c] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      const Frag<4> kf = a_frag(kw + kd * 256), vf = a_frag(vw + kd * 256);
#pragma unroll
      for (int n = 0; n < STEPS; ++n) {
        mma3(st[n], kf, qB.at(n, kd));
        mma3(dpt[n], vf, doB.at(n, kd));
      }
    }
#pragma unroll
    for (int n = 0; n < STEPS; ++n)  // st becomes p^T, dpt ds^T
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = n * 8 + 2 * t + (c & 1), qi = i0 + r;
        const bool hi = c >= 2;
        const bool vis = !causal || (hi ? jb : ja) <= qi - diff;
        const float e = expf((vis ? st[n][c] : NEG_INF) - mrow[r]) * lrow[r];
        const float p = ((hi ? vb : va) && qi < tq) ? e : 0.f;
        dpt[n][c] = vis ? p * (dpt[n][c] - drow[r]) : 0.f;
        st[n][c] = p;
      }
#pragma unroll
    for (int n = 0; n < STEPS; ++n) {
      const Frag<4> pa = c_as_a_round(st[n]), sa = c_as_a_round(dpt[n]);
#pragma unroll
      for (int d = 0; d < KD; ++d) {
        mma3(dva[d], pa, dopB.at(d, n));
        mma3(dka[d], sa, qpB.at(d, n));  // qp carries the scale
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = half ? jb : ja;
    if (key >= tk) continue;
    const long long off = ((long long)b * tk + key) * hs + h * DH + 2 * t;
#pragma unroll
    for (int d = 0; d < KD; ++d) {
      *reinterpret_cast<float2*>(dk + off + d * 8) =
          make_float2(dka[d][2 * half], dka[d][2 * half + 1]);
      *reinterpret_cast<float2*>(dv + off + d * 8) =
          make_float2(dva[d][2 * half], dva[d][2 * half + 1]);
    }
  }
}

// --- bf16 tensor-core kernels: every multiple of 8 through 128 ---------------
// kanvit's bf16 policy for the tiled kernels (_fwd_kernel :66-123,
// _bwd_dq_kernel :176-223, _bwd_dkv_kernel :226-272) on bf16 q, k, v, o and
// do, with the f32 kernels' edge semantics above:
//   s = (q k^T) * dh^-1/2, f32 sums of bf16 products, the f32 scale after
//       the product; the finite NEG_INF where masked;
//   forward: online softmax in f32 (running max m, p = exp(s - m) zeroed on
//       invalid keys, each tile's sum of the unrounded p clamped at 1e-10),
//       acc = acc * corr + bf16(p) v in f32, o = bf16(acc / max(l, 1e-10)),
//       a true division; (m, l) in f32 for the backward;
//   backward: p = exp(s - m) * (1 / l), delta = rowsum(f32(do) f32(o)) from
//       the bf16 o, ds = (p * dh^-1/2) * (do v^T - delta) in f32, 0 where
//       causally unseen; dq = bf16(bf16(ds) k) with no scale after it,
//       dk = bf16(bf16(ds)^T q) with q unscaled, dv = bf16(bf16(p)^T do).
// The causal frontier and its exceptions for rows with m == NEG_INF, the
// longest blocks first, the two backward kernels (dq writes delta) and the
// layout of o, do and the gradients are the f32 kernels'. Every row of q,
// k, v and do must start 16-byte aligned (cp.async and TMA).
//
// The forward, flash_fwd_bf16: bf16 mma.sync.m16n8k16 with f32
// accumulation fed by ldmatrix (attention_tc.cuh's bf16 helpers, as the
// lanes bf16 kernels), S = q K^T with the warp's q rows as A fragments in
// registers, O += P V with P from S's C fragments; 64 resident rows a
// block (16 a warp), streamed 32-key tiles staged raw by 16-byte cp.async,
// double buffered (rows of dh + 8 bf16). One pass: it rounds p against its
// running max over its own 32-key tiles, where kanvit rounds it against the
// running max over its 128-multiple key blocks (_plan's bk). Each bf16(p)
// is within 2^-8 of its f32 value on either side, so o may differ from the
// twin's by 2^-7 of sum(p |v|) / l besides one output ulp (chip_smoke.py's
// gate; the CPU tests emulate these tiles). dh 8, 16, 32 and 64 are
// instantiated as they are; every other multiple of 8 through 128 runs the
// instantiation padded to DH 128 (BF16_PAD_DH, attention_tc.cuh) with the
// true dh at run time: staged rows and A fragments zero past dh (cp.async
// reading no source), the products over all of DH (a step past dh adds
// exact zeros; a branch on dh beside each mma ran 1.9-2.8x slower:
// PERF.md), the stores stopping at dh.
//
// The backward, flash_dq_bf16 and flash_dkv_bf16, is written for Hopper:
// see its section below.

constexpr int BF_TILE = 32;            // rows a streamed bf16 tile
constexpr int BF_STEPS = BF_TILE / 8;  // its 8-row steps

// Forward. One block per (head, batch, 64 query rows), the query tiles
// longest first; warp w owns rows q0 + 16w .. +15, its q rows as A
// fragments in registers.
template <int DH, bool PAD = false>
__global__ void __launch_bounds__(NT)
flash_fwd_bf16(View16 q, View16 k, View16 v, const uint8_t* __restrict__ mask,
               __nv_bfloat16* __restrict__ o, float* __restrict__ stats, int tq, int tk,
               int heads, int causal, float scale, int dh_run) {
  constexpr int P = DH + 8, KD = (DH + 15) / 16, ND = DH / 8;
  const int dh = PAD ? dh_run : DH;
  __shared__ __align__(16) __nv_bfloat16 ks[2][BF_TILE][P];
  __shared__ __align__(16) __nv_bfloat16 vs[2][BF_TILE][P];
  __shared__ unsigned kbits[2];  // key_bits of each buffer's tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * TC_ROWS;
  const int r0 = q0 + warp * 16;
  const bool active = r0 < tq;
  const int ra = r0 + g, rb = ra + 8;
  const bool la = ra < tq, lb = rb < tq;
  const int diff = max(tk - tq, 0);
  // Keys the warp's rows may see: below tk and, causal, at or before its
  // last live row's position.
  const int wkeys = causal ? min(tk, min(r0 + 15, tq - 1) - diff + 1) : tk;

  uint32_t qa[KD][4];
  bf16_a_rows<DH>(q.at(b, min(ra, tq - 1), h), q.at(b, min(rb, tq - 1), h),
                  la ? 1.f : 0.f, lb ? 1.f : 0.f, t, qa, dh);
  float acc[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float ma = NEG_INF, mb = NEG_INF, sa = 0.f, sb = 0.f;  // running max and sum

  // Keys past the block's last row are causally masked for all its rows.
  const int frontier = causal ? min(tk, max(0, q0 + TC_ROWS - diff)) : tk;
  const int tiles = (tk + BF_TILE - 1) / BF_TILE;
  const __nv_bfloat16* kh = k.at(b, 0, h);
  const __nv_bfloat16* vh = v.at(b, 0, h);
  auto stage = [&](int tile, int buf) {
    stage_tile_bf16<DH, BF_TILE, PAD>(&ks[buf][0][0], kh, k.st, tile * BF_TILE, tk, tid, dh);
    stage_tile_bf16<DH, BF_TILE, PAD>(&vs[buf][0][0], vh, v.st, tile * BF_TILE, tk, tid, dh);
    cp_async_commit();
    if (warp == 0) {
      const unsigned bits = key_bits(mask, b, tk, tile * BF_TILE, lane);
      if (lane == 0) kbits[buf] = bits;
    }
  };
  stage(0, 0);
  for (int it = 0; it < tiles; ++it) {
    const int buf = it & 1, k0 = it * BF_TILE;
    const bool dead = (la && ma == NEG_INF) || (lb && mb == NEG_INF);
    // Past the frontier only a row with no valid key so far still changes.
    // The barrier also frees the buffer the next stage fills.
    if (!__syncthreads_or(k0 < frontier || dead)) break;
    if (it + 1 < tiles) {
      stage(it + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the tile and its key bits have landed

    // Skip the tile when no row of the warp sees one of its keys, unless a
    // row has m == NEG_INF: it takes every valid key, seen or not.
    if (!active || (k0 >= wkeys && !__any_sync(0xffffffffu, dead))) continue;
    const unsigned kv = kbits[buf] >> (2 * t);  // bit 8n + c: key k0 + 8n + 2t + c
    const int steps = min(BF_STEPS, (tk - k0 + 7) / 8);
    // key k0 + 8n + 2t + (c & 1) is causally seen by row r iff
    // 8n + (c & 1) <= r - diff - k0 - 2t
    const int lim_a = causal ? ra - diff - k0 - 2 * t : BF_TILE;
    const int lim_b = causal ? rb - diff - k0 - 2 * t : BF_TILE;
    float s[BF_STEPS][4];
    bf16_rows_by_tile<DH>(qa, &ks[buf][0][0], steps, lane, s);
    float mxa = ma, mxb = mb;
#pragma unroll
    for (int n = 0; n < BF_STEPS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = n * 8 + (c & 1);
        const bool ok = ((kv >> j) & 1u) && j <= (c < 2 ? lim_a : lim_b);
        s[n][c] = ok ? s[n][c] * scale : NEG_INF;
        if (c < 2) mxa = fmaxf(mxa, s[n][c]);
        else mxb = fmaxf(mxb, s[n][c]);
      }
    mxa = quad_max(mxa);
    mxb = quad_max(mxb);
    const float ca = expf(ma - mxa), cb = expf(mb - mxb);
    float ta = 0.f, tb = 0.f;
#pragma unroll
    for (int n = 0; n < BF_STEPS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        // 1 on a valid, causally masked key of a row whose max is NEG_INF
        const int j = n * 8 + (c & 1);
        const float e = expf(s[n][c] - (c < 2 ? mxa : mxb));  // in [0, 1]
        s[n][c] = ((kv >> j) & 1u) ? e : 0.f;
        if (c < 2) ta += s[n][c];
        else tb += s[n][c];
      }
    sa = ca * sa + fmaxf(quad_sum(ta), EPSILON);
    sb = cb * sb + fmaxf(quad_sum(tb), EPSILON);
    ma = mxa;
    mb = mxb;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      acc[d][0] *= ca;
      acc[d][1] *= ca;
      acc[d][2] *= cb;
      acc[d][3] *= cb;
    }
    bf16_c_by_tile<DH>(s, &vs[buf][0][0], steps, lane, acc);  // + bf16(p) V
  }
  cp_async_wait<0>();

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? rb : ra;
    if (row >= tq) continue;
    const float lc = fmaxf(half ? sb : sa, EPSILON);
    __nv_bfloat16* op = o + (((long long)b * tq + row) * heads + h) * dh + 2 * t;
#pragma unroll
    for (int d = 0; d < ND; ++d)
      if (d * 8 < dh)
        store_bf16_pair(op + d * 8, acc[d][2 * half] / lc, acc[d][2 * half + 1] / lc);
    if (stats != nullptr && t == 0) {
      float* sp = stats + (((long long)b * heads + h) * tq + row) * 2;
      sp[0] = half ? mb : ma;
      sp[1] = lc;
    }
  }
}

// --- the bf16 backward on Hopper: warp-specialised, TMA-fed wgmma ------------
// flash_dq_bf16 and flash_dkv_bf16 replace kanvit's _bwd_dq_kernel
// (kanvit/kernels/flash_attention.py:176-223, pallas_call :806) and
// _bwd_dkv_kernel (:226-272, pallas_call :831) on bf16 operands, with the
// policy above; the renormalisation by the forward's final (m, l) lets no
// tiling enter. What bounds them on the H100 at the causal decoder's shapes
// (B H T^2 dh bf16 FLOPs a product, 3 in dq and 4 in dk/dv, against a few
// bytes a row): the tensor cores, 989 TFLOP/s dense bf16, which only
// wgmma reaches (mma.sync, the forward's, does not), and beside them the
// score pass, ~14 instructions a score of an exp, masks and ds for every
// query-key pair: at dh 64 it is as long as the products.
//
// The design. A block is 384 threads: a producer warpgroup, of which one
// warp issues TMA copies and stages per-tile data (setmaxnreg down), and
// two consumer warpgroups (setmaxnreg up), each owning 64 resident rows,
// the M of a wgmma (queries in dq, keys in dk/dv; 128 a block, launched
// longest first). Every 64-row tile the producer streams (keys of k and v
// in dq, queries of q and do in dk/dv) serves both consumers, through a
// ring of HB_STAGES stages, each with a full and an empty mbarrier; no
// __syncthreads in the loop. TMA reads q, k, v in place through 4-D tensor
// maps (dh, H, T, B) of their strides and do (and o for delta) contiguous,
// 64-column boxes with 128-byte swizzle (hopper.cuh's panels), and fills
// zeros past T and past dh: DH 64 takes dh 8-64 and DH 128 dh 72-128, the
// true dh at run time, the padded columns exact zeros. Products, all
// wgmma m64nNk16 with f32 accumulators:
//   dq      S = q K^T, dP = do V^T   A q, do rows (registers, once)  B K, V tile
//           dQ += bf16(dS) K         A dS from the accumulators    B K tile, MN-major
//   dk/dv   S^T = K q^T, dP^T = V do^T  A k, v rows (registers at     B q, do tile
//                                    DH 64; shared memory at 128)
//           dV += bf16(P^T) do,      A from the accumulators        B do, q tile,
//           dK += bf16(dS^T) q                                       MN-major
// At DH 128 a dk/dv consumer holds all of dh's dK and dV (128 registers a
// thread), so no block recomputes the scores for a part of dh. The two
// independent chains of each phase are issued interleaved. Each tile's
// scores take one pass, computed for every entry and selected, with exp
// on the SFU (exp_sfu); a tile every row of which sees every key, all
// valid, takes the pass without the masks. dq reads each row's (m, 1/l)
// and computes delta (two threads a row, 16-byte loads of o and do) once;
// dk/dv's producer stages each tile's rows' m, 1/l and delta in shared
// memory on the tile's barrier (loaded a tile ahead; plain loads, as a
// (b, h) row of stats starts only 8-byte aligned at odd tq). Rows with no
// valid key: without a key mask they are exactly the rows at qpos < 0, so
// dk/dv knows them from tq and tk; with one it scans the rows' m. Each sum
// is in a fixed order and no atomics: the bits repeat. Measured (PERF.md):
// the consumers run their phases in step, the products of both together;
// taking turns, or deferring a tile's second products into the next turn,
// ran slower (one warpgroup's chains alone do not fill the tensor cores).

constexpr int HB_WG = 128;                              // threads a warpgroup
constexpr int HB_CONSUMERS = 2;                         // consumer warpgroups a block
constexpr int HB_THREADS = HB_WG * (1 + HB_CONSUMERS);  // and one producer warpgroup
constexpr int HB_ROWS = PANEL_ROWS;                     // resident rows a consumer (wgmma M)
constexpr int HB_BLOCK = HB_ROWS * HB_CONSUMERS;        // resident rows a block
constexpr int HB_TILE = PANEL_ROWS;                     // rows a streamed tile
constexpr int HB_STAGES = 3;                            // streamed tiles in flight
// setmaxnreg: dq 128 x 24 + 256 x 240 = 384 x 168, the registers the block
// launches with (__launch_bounds__(384, 1)); dk/dv's producer takes 32
// (its row loads), its consumers 232.
constexpr int HB_PRODUCER_REGS = 24, HB_CONSUMER_REGS = 240;
constexpr int HB_DKV_PRODUCER_REGS = 32, HB_DKV_CONSUMER_REGS = 232;

// Shared memory of both kernels at DH (64 or 128), from a 1024-byte aligned
// base: the resident rows (tensor x: 0 q, 1 do in dq; 0 k, 1 v in dk/dv; a
// 64-row tile of DH / 64 panels for each consumer), the stages (tensor x: 0
// k, 1 v in dq; 0 q, 1 do in dk/dv), each stage's streamed rows' m, 1 / l
// and delta (dk/dv, floats [stage][3][64]) or its keys' valid bits (dq,
// words [stage][2]), the barriers (full and empty a stage, one for the
// resident rows) and dq's delta of each resident row.
template <int DH>
struct HbSmem {
  static constexpr int TILE = DH / 64 * PANEL_BYTES;
  static constexpr int STAGE = 2 * HB_CONSUMERS * TILE;
  static constexpr int ROWS = STAGE + HB_STAGES * 2 * TILE;
  static constexpr int BITS = ROWS + HB_STAGES * 3 * HB_TILE * 4;
  static constexpr int BARS = BITS + HB_STAGES * 8;
  static constexpr int DELTA = BARS + (2 * HB_STAGES + 1) * 8;
  static constexpr int BYTES = DELTA + HB_CONSUMERS * HB_ROWS * 4;
  static constexpr int ALLOC = BYTES + 1024;  // and room to align the base
  static __device__ __forceinline__ int res(int x, int w) { return (x * HB_CONSUMERS + w) * TILE; }
  static __device__ __forceinline__ int stage(int s, int x) { return STAGE + (s * 2 + x) * TILE; }
};

__device__ __forceinline__ uint8_t* hb_base(uint8_t* raw) {
  return raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
}

// full[s]: the producer warp's 32 arrivals (its lane 0's with the stage's
// TMA bytes); empty[s]: one arrival from each consumer warp; resident: the
// resident rows' bytes.
__device__ __forceinline__ void hb_init_barriers(uint64_t* bars) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < HB_STAGES; ++s) {
      mbar_init(&bars[s], 32);
      mbar_init(&bars[HB_STAGES + s], HB_CONSUMERS * HB_WG / 32);
    }
    mbar_init(&bars[2 * HB_STAGES], 1);
    mbar_init_fence();
  }
}

// The producer's lane 0: both resident tensors' rows r0 + 64 w of every
// consumer w whose rows start below t_len, on the resident barrier.
template <int DH>
__device__ __forceinline__ void hb_load_resident(uint8_t* sm, const CUtensorMap* m0,
                                                 const CUtensorMap* m1, uint64_t* bar, int r0,
                                                 int t_len, int h, int b) {
  using L = HbSmem<DH>;
  uint32_t bytes = 0;
  for (int w = 0; w < HB_CONSUMERS; ++w)
    if (r0 + w * HB_ROWS < t_len) bytes += 2 * L::TILE;
  mbar_arrive_expect_tx(bar, bytes);
  for (int w = 0; w < HB_CONSUMERS; ++w) {
    if (r0 + w * HB_ROWS >= t_len) continue;
    for (int p = 0; p < DH / 64; ++p) {
      tma_load_4d(sm + L::res(0, w) + p * PANEL_BYTES, m0, bar, p * 64, h, r0 + w * HB_ROWS, b);
      tma_load_4d(sm + L::res(1, w) + p * PANEL_BYTES, m1, bar, p * 64, h, r0 + w * HB_ROWS, b);
    }
  }
}

// The producer's lane 0: stage s's tiles of both streamed tensors, rows
// row0 .. row0 + 63, completing on full (its arrival with their bytes).
template <int DH>
__device__ __forceinline__ void hb_load_stage(uint8_t* sm, const CUtensorMap* m0,
                                              const CUtensorMap* m1, uint64_t* full, int s,
                                              int row0, int h, int b) {
  using L = HbSmem<DH>;
  mbar_arrive_expect_tx(full, 2 * L::TILE);
  for (int p = 0; p < DH / 64; ++p) {
    tma_load_4d(sm + L::stage(s, 0) + p * PANEL_BYTES, m0, full, p * 64, h, row0, b);
    tma_load_4d(sm + L::stage(s, 1) + p * PANEL_BYTES, m1, full, p * 64, h, row0, b);
  }
}

// A consumer warp is done with stage s.
__device__ __forceinline__ void hb_release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty);
}

// x + the dot product of 8 bf16 pairs, f32, in column order.
__device__ __forceinline__ float dot8_bf16(uint4 a, uint4 b, float x) {
  const uint32_t wa[4] = {a.x, a.y, a.z, a.w}, wb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fa = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wa[i]));
    const float2 fb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wb[i]));
    x = fmaf(fa.y, fb.y, fmaf(fa.x, fb.x, x));
  }
  return x;
}

// exp(y) as 2^(y log2 e) on the SFU (ex2.approx.ftz): two instructions
// where IEEE expf takes eight, six of them on the FMA pipe, in a score pass
// that is issue-bound (PERF.md). ~2 ulp beside the rounding of y log2 e
// (|y| 2^-24 relative), far below p's and ds's bf16 rounding; exp(0) = 1
// and exp(-huge) = 0 exactly, so a row with m == NEG_INF still takes p =
// 1 / l on every valid key.
__device__ __forceinline__ float exp_sfu(float y) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(y * 1.44269504f));
  return r;
}

// dq and delta. One block per (head, batch, 128 query rows), the query
// tiles longest first: a producer warp streams 64-key tiles of K and V up
// to the block's causal frontier (ds is 0 past it) with their keys' valid
// bits; consumer w owns rows q0 + 64 w .. + 63, its q and do rows loaded
// once by TMA and held as A fragments, and skips the tiles its rows see
// no key of.
template <int DH>
__global__ void __launch_bounds__(HB_THREADS, 1)
flash_dq_bf16(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
              const __grid_constant__ CUtensorMap v_map,
              const __grid_constant__ CUtensorMap do_map, const uint8_t* __restrict__ mask,
              const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ stats, float* __restrict__ delta_out,
              __nv_bfloat16* __restrict__ dq, int tq, int tk, int heads, int causal,
              float scale, int dh) {
  using L = HbSmem<DH>;
  extern __shared__ uint8_t hb_raw[];
  uint8_t* sm = hb_base(hb_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* empty = full + HB_STAGES;
  uint64_t* resident = empty + HB_STAGES;
  uint32_t* bits = reinterpret_cast<uint32_t*>(sm + L::BITS);
  const int tid = threadIdx.x, h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * HB_BLOCK;
  const int diff = max(tk - tq, 0);
  const int kend = causal ? min(tk, max(0, q0 + HB_BLOCK - diff)) : tk;
  const int tiles = (kend + HB_TILE - 1) / HB_TILE;
  hb_init_barriers(full);
  __syncthreads();

  if (tid < HB_WG) {  // the producer
    regs_dec<HB_PRODUCER_REGS>();
    if (tid >= 32) return;
    if (tid == 0) hb_load_resident<DH>(sm, &q_map, &do_map, resident, q0, tq, h, b);
    for (int it = 0; it < tiles; ++it) {
      const int s = it % HB_STAGES, k0 = it * HB_TILE;
      const unsigned lo = key_bits(mask, b, tk, k0, tid);
      const unsigned hi = key_bits(mask, b, tk, k0 + 32, tid);
      mbar_wait(&empty[s], (it / HB_STAGES & 1) ^ 1);
      if (tid == 0) {
        bits[2 * s] = lo;
        bits[2 * s + 1] = hi;
        hb_load_stage<DH>(sm, &k_map, &v_map, &full[s], s, k0, h, b);
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  regs_inc<HB_CONSUMER_REGS>();
  const int w = tid / HB_WG - 1, ct = tid % HB_WG;
  const int warp = ct >> 5, lane = ct & 31, g = lane >> 2, t = lane & 3;
  const int r0 = q0 + w * HB_ROWS;
  const int ra = r0 + warp * 16 + g, rb = ra + 8;
  const bool la = ra < tq, lb = rb < tq;
  // Keys the warpgroup's rows may see: below tk and, causal, at or before
  // its last live row's position.
  const int wkeys = r0 >= tq ? 0
                    : causal ? min(tk, min(r0 + HB_ROWS - 1, tq - 1) - diff + 1)
                             : tk;
  const long long hs = (long long)heads * dh;  // row stride of o, do and dq
  const long long srow = ((long long)b * heads + h) * tq;  // of stats, delta
  float* dsm = reinterpret_cast<float*>(sm + L::DELTA) + w * HB_ROWS;
  {  // delta = rowsum(f32(do) f32(o)): two threads a row, 8 columns a load
    const int row = r0 + ct / 2;
    float d = 0.f;
    if (row < tq) {
      const long long at = ((long long)b * tq + row) * hs + (long long)h * dh;
      for (int c = (ct & 1) * 8; c < dh; c += 16)
        d = dot8_bf16(*reinterpret_cast<const uint4*>(dout + at + c),
                      *reinterpret_cast<const uint4*>(o + at + c), d);
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if ((ct & 1) == 0) {
      dsm[ct / 2] = d;
      if (row < tq) delta_out[srow + row] = d;
    }
  }
  named_sync(1 + w, HB_WG);
  const float dla = dsm[warp * 16 + g], dlb = dsm[warp * 16 + g + 8];
  const float ma = la ? stats[(srow + ra) * 2] : 0.f;
  const float mb = lb ? stats[(srow + rb) * 2] : 0.f;
  const float rla = la ? 1.f / stats[(srow + ra) * 2 + 1] : 0.f;
  const float rlb = lb ? 1.f / stats[(srow + rb) * 2 + 1] : 0.f;

  float acc[DH / 2];  // dQ, f32
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  mbar_wait(resident, 0);
  uint32_t qa[DH / 16][4], doa[DH / 16][4];  // the rows of q and do as A fragments
  panel_a_frags<DH>(sm + L::res(0, w), warp, lane, qa);
  panel_a_frags<DH>(sm + L::res(1, w), warp, lane, doa);
  for (int it = 0; it < tiles; ++it) {
    const int s = it % HB_STAGES, k0 = it * HB_TILE;
    mbar_wait(&full[s], it / HB_STAGES & 1);
    if (k0 < wkeys) {  // the warpgroup's rows see a key of the tile
      const uint32_t kt = smem_addr(sm + L::stage(s, 0)), vt = smem_addr(sm + L::stage(s, 1));
      float sc[32], dp[32];  // S and dP, written by their first step (accumulate 0)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {  // two chains, interleaved
        wgmma_rs_n64_k(sc, qa[kk], desc_k(kt, kk), kk);
        wgmma_rs_n64_k(dp, doa[kk], desc_k(vt, kk), kk);
      }
      wgmma_commit();
      // bit 8n + c of kv: key k0 + 8n + 2t + c is valid
      const unsigned long long kv =
          ((unsigned long long)bits[2 * s + 1] << 32 | bits[2 * s]) >> (2 * t);
      // key k0 + 8n + 2t + (c & 1) is seen by row r iff 8n + (c & 1) <= lim
      const int lim_a = !la ? -1 : causal ? ra - diff - k0 - 2 * t : HB_TILE;
      const int lim_b = !lb ? -1 : causal ? rb - diff - k0 - 2 * t : HB_TILE;
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      uint32_t da[HB_TILE / 16][4];  // bf16(ds), the A fragments of dQ += dS K
      // ds of every score, computed and then selected (no branch a score);
      // an interior tile (every row below tq sees every key of it, all
      // valid) takes the pass without the masks.
      auto scores = [&](auto interior) {
        constexpr bool IN = decltype(interior)::value;
#pragma unroll
        for (int n = 0; n < HB_TILE / 8; ++n) {
          float ds[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = n * 8 + (c & 1);
            const bool hi = c >= 2;
            const bool vis = IN || j <= (hi ? lim_b : lim_a);
            const float x = vis ? __fmul_rn(sc[4 * n + c], scale) : NEG_INF;
            const float e = exp_sfu(x - (hi ? mb : ma)) * (hi ? rlb : rla);
            const float p = IN || ((kv >> j) & 1ull) ? e : 0.f;
            ds[c] = vis ? (p * scale) * (dp[4 * n + c] - (hi ? dlb : dla)) : 0.f;
          }
          da[n / 2][(n & 1) * 2] = pack_bf16(ds[0], ds[1]);
          da[n / 2][(n & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
        }
      };
      if ((!causal || k0 + HB_TILE - 1 <= r0 - diff) && r0 + HB_ROWS <= tq &&
          k0 + HB_TILE <= tk && mask == nullptr)
        scores(std::true_type());
      else
        scores(std::false_type());
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HB_TILE / 16; ++kk) wgmma_rs<DH>(acc, da[kk], desc_mn(kt, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(da);
    }
    hb_release(&empty[s], lane);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? rb : ra;
    if (row >= tq) continue;
    __nv_bfloat16* dqp = dq + ((long long)b * tq + row) * hs + (long long)h * dh + 2 * t;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      if (n * 8 < dh) store_bf16_pair(dqp + n * 8, acc[4 * n + 2 * half], acc[4 * n + 2 * half + 1]);
  }
}

// dk and dv. One block per (head, batch, 128 keys), key tile 0 (the one the
// most queries see) first: a producer warp streams 64-query tiles of q and
// do with their rows' m, 1 / l and delta; consumer w owns keys k0 + 64 w ..
// + 63, its k and v rows resident in shared memory.
template <int DH>
__global__ void __launch_bounds__(HB_THREADS, 1)
flash_dkv_bf16(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map,
               const __grid_constant__ CUtensorMap do_map, const uint8_t* __restrict__ mask,
               const float* __restrict__ stats, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int tq, int tk,
               int heads, int causal, float scale, int dh) {
  using L = HbSmem<DH>;
  extern __shared__ uint8_t hb_raw[];
  uint8_t* sm = hb_base(hb_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* empty = full + HB_STAGES;
  uint64_t* resident = empty + HB_STAGES;
  float* rows = reinterpret_cast<float*>(sm + L::ROWS);
  const int tid = threadIdx.x, h = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * HB_BLOCK;
  const int diff = max(tk - tq, 0);
  const long long srow = ((long long)b * heads + h) * tq;  // of stats, delta
  hb_init_barriers(full);

  // Causal: query i sees key j only for i - diff >= j. A query that sees
  // none of the block's keys adds only where it saw no valid key at all
  // (m = NEG_INF: p = 1/l on every valid key, into dv). Unless a row before
  // the one that sees the block's last key is such a row, the block starts
  // at the tile of the first query that sees its first key and each
  // consumer skips the tiles that see none of its keys; else it streams
  // every query.
  // Without a key mask such rows are exactly those at qpos < 0 (rows below
  // diff; scores are finite), so no stats are read; with one, the block
  // scans the m of the rows before its last key's first query.
  bool skip = false;
  int i_start = 0;
  if (causal && mask != nullptr) {
    const int scan = min(tq, k0 + HB_BLOCK - 1 + diff);
    bool dead = false;
    for (int r = tid; r < scan; r += HB_THREADS) dead |= stats[(srow + r) * 2] == NEG_INF;
    skip = !__syncthreads_or(dead);
  } else {
    skip = causal && diff == 0;
    __syncthreads();
  }
  if (skip) i_start = min(tq, k0 + diff) / HB_TILE * HB_TILE;
  const int tiles = (tq - i_start + HB_TILE - 1) / HB_TILE;

  if (tid < HB_WG) {  // the producer
    regs_dec<HB_DKV_PRODUCER_REGS>();
    if (tid >= 32) return;
    if (tid == 0) hb_load_resident<DH>(sm, &k_map, &v_map, resident, k0, tk, h, b);
    // Rows i0 + tid and i0 + 32 + tid of the next tile: m, l and delta (0
    // past tq), loaded a tile ahead so that they land during the wait.
    float m[2], l[2], dl[2];
    auto fetch = [&](int it) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = i_start + it * HB_TILE + 32 * e + tid;
        const bool in = it < tiles && qi < tq;
        m[e] = in ? stats[(srow + qi) * 2] : 0.f;
        l[e] = in ? stats[(srow + qi) * 2 + 1] : 0.f;
        dl[e] = in ? delta[srow + qi] : 0.f;
      }
    };
    fetch(0);
    for (int it = 0; it < tiles; ++it) {
      const int s = it % HB_STAGES, i0 = i_start + it * HB_TILE;
      mbar_wait(&empty[s], (it / HB_STAGES & 1) ^ 1);
      float* r = rows + s * 3 * HB_TILE;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        r[32 * e + tid] = m[e];
        r[HB_TILE + 32 * e + tid] = i0 + 32 * e + tid < tq ? 1.f / l[e] : 0.f;
        r[2 * HB_TILE + 32 * e + tid] = dl[e];
      }
      if (tid == 0) {
        hb_load_stage<DH>(sm, &q_map, &do_map, &full[s], s, i0, h, b);
      } else {
        mbar_arrive(&full[s]);
      }
      fetch(it + 1);
    }
    return;
  }

  regs_inc<HB_DKV_CONSUMER_REGS>();
  const int w = tid / HB_WG - 1, ct = tid % HB_WG;
  const int warp = ct >> 5, lane = ct & 31, g = lane >> 2, t = lane & 3;
  const int j0 = k0 + w * HB_ROWS;  // the warpgroup's first key
  const bool active = j0 < tk;
  const int ja = j0 + warp * 16 + g, jb = ja + 8;
  const bool va = key_ok(mask, b, tk, ja), vb = key_ok(mask, b, tk, jb);
  const long long hs = (long long)heads * dh;  // row stride of dk and dv

  float dka[DH / 2], dva[DH / 2];  // dK, dV, f32
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dka[i] = dva[i] = 0.f;
  const uint32_t kr = smem_addr(sm + L::res(0, w)), vr = smem_addr(sm + L::res(1, w));
  mbar_wait(resident, 0);
  // At DH 64 the rows of k and v as A fragments (S^T and dP^T from
  // registers); at DH 128 they would not fit beside dK and dV, and the
  // products read them from shared memory.
  constexpr bool A_REGS = DH == 64;
  uint32_t ka[DH / 16][4], vfa[DH / 16][4];
  if constexpr (A_REGS) {
    panel_a_frags<DH>(sm + L::res(0, w), warp, lane, ka);
    panel_a_frags<DH>(sm + L::res(1, w), warp, lane, vfa);
  }
  for (int it = 0; it < tiles; ++it) {
    const int s = it % HB_STAGES, i0 = i_start + it * HB_TILE;
    mbar_wait(&full[s], it / HB_STAGES & 1);
    // Skipping, a tile whose last query sees none of the warpgroup's keys
    // adds nothing; the masks zero p and ds where a query does not see a key.
    if (active && !(skip && i0 + HB_TILE - 1 - diff < j0)) {
      const uint32_t qt = smem_addr(sm + L::stage(s, 0)), dt = smem_addr(sm + L::stage(s, 1));
      float st[32], dpt[32];  // S^T and dP^T, keys by queries; written by their first step
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {  // two chains, interleaved
        if constexpr (A_REGS) {
          wgmma_rs_n64_k(st, ka[kk], desc_k(qt, kk), kk);
          wgmma_rs_n64_k(dpt, vfa[kk], desc_k(dt, kk), kk);
        } else {
          wgmma_ss_n64(st, desc_k(kr, kk), desc_k(qt, kk), kk);
          wgmma_ss_n64(dpt, desc_k(vr, kk), desc_k(dt, kk), kk);
        }
      }
      wgmma_commit();
      // query i0 + 8n + 2t + (c & 1) sees key ja (jb) causally iff
      // 8n + (c & 1) >= from_a (from_b), and lies below tq iff < qlim
      const int from_a = causal ? ja + diff - i0 - 2 * t : 0;
      const int from_b = causal ? jb + diff - i0 - 2 * t : 0;
      const int qlim = tq - i0 - 2 * t;
      const float* r = rows + s * 3 * HB_TILE + 2 * t;
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      uint32_t pa[HB_TILE / 16][4], sa[HB_TILE / 16][4];  // bf16(p^T), bf16(ds^T)
      // As in dq; an interior tile (every query of it below tq sees every
      // key of the warpgroup, all valid) takes the pass without the masks.
      auto scores = [&](auto interior) {
        constexpr bool IN = decltype(interior)::value;
#pragma unroll
        for (int n = 0; n < HB_TILE / 8; ++n) {
          const float2 m2 = *reinterpret_cast<const float2*>(r + 8 * n);
          const float2 rl2 = *reinterpret_cast<const float2*>(r + HB_TILE + 8 * n);
          const float2 dl2 = *reinterpret_cast<const float2*>(r + 2 * HB_TILE + 8 * n);
          float p[4], ds[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = n * 8 + (c & 1);
            const bool hi = c >= 2;
            const bool vis = IN || j >= (hi ? from_b : from_a);
            const float x = vis ? __fmul_rn(st[4 * n + c], scale) : NEG_INF;
            const float e = exp_sfu(x - (c & 1 ? m2.y : m2.x)) * (c & 1 ? rl2.y : rl2.x);
            p[c] = IN || ((hi ? vb : va) && j < qlim) ? e : 0.f;
            ds[c] = vis ? (p[c] * scale) * (dpt[4 * n + c] - (c & 1 ? dl2.y : dl2.x)) : 0.f;
          }
          pa[n / 2][(n & 1) * 2] = pack_bf16(p[0], p[1]);
          pa[n / 2][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
          sa[n / 2][(n & 1) * 2] = pack_bf16(ds[0], ds[1]);
          sa[n / 2][(n & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
        }
      };
      if ((!causal || i0 - diff >= j0 + HB_ROWS - 1) && i0 + HB_TILE <= tq &&
          j0 + HB_ROWS <= tk && mask == nullptr)
        scores(std::true_type());
      else
        scores(std::false_type());
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HB_TILE / 16; ++kk) {  // two chains, interleaved
        wgmma_rs<DH>(dva, pa[kk], desc_mn(dt, kk));
        wgmma_rs<DH>(dka, sa[kk], desc_mn(qt, kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
      fence_regs(pa);
      fence_regs(sa);
    }
    hb_release(&empty[s], lane);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = half ? jb : ja;
    if (key >= tk) continue;
    const long long off = ((long long)b * tk + key) * hs + (long long)h * dh + 2 * t;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      if (n * 8 >= dh) continue;
      store_bf16_pair(dk + off + n * 8, dka[4 * n + 2 * half], dka[4 * n + 2 * half + 1]);
      store_bf16_pair(dv + off + n * 8, dva[4 * n + 2 * half], dva[4 * n + 2 * half + 1]);
    }
  }
}

// --- generic head dims (attention_common.cuh): the same functions, one
// thread a row, the head dim walked at run time in chunks of C; the q (and
// do) row re-read per staged tile, the accumulators in shared memory.

constexpr int C = GENERIC_CHUNK;

// Forward. Dynamic shared memory (floats): ks, vs (BKV, dh), acc (dh, BQ).
__global__ void __launch_bounds__(BQ)
flash_fwd_generic(View q, View k, View v, const uint8_t* __restrict__ mask,
                  float* __restrict__ o, float* __restrict__ stats, int tq,
                  int tk, int heads, int dh, int causal, float scale) {
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
  const bool live = qi < tq;
  const int diff = max(tk - tq, 0);
  const int qpos = qi - diff;
  const float* qp = q.at(b, live ? qi : 0, h);
  for (int d = 0; d < dh; ++d) acc[d * BQ + tid] = 0.f;
  float m = NEG_INF;
  float l = 0.f;

  // Keys past the block's last row are causally masked for all its rows.
  const int frontier = causal ? min(tk, max(0, q0 + BQ - diff)) : tk;
  for (int k0 = 0; k0 < tk; k0 += BKV) {
    // Past the frontier only a row with no valid key so far still changes.
    if (k0 >= frontier && !__syncthreads_or(live && m == NEG_INF)) break;
    __syncthreads();  // the previous tile is no longer read
    for (int e = tid; e < BKV * dh; e += BQ) {
      const int j = e / dh, d = e % dh, key = k0 + j;
      const bool in = key < tk;
      ks[e] = in ? k.at(b, key, h)[d] : 0.f;
      vs[e] = in ? v.at(b, key, h)[d] : 0.f;
    }
    if (tid < BKV) kvalid[tid] = key_ok(mask, b, tk, k0 + tid);
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
      const bool ok = kvalid[j] && (!causal || k0 + j <= qpos);
      s[j] = ok ? s[j] : NEG_INF;
      mt = fmaxf(mt, s[j]);
    }
    const float corr = expf(m - mt);
    float bsum = 0.f;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      // 1 on a valid, causally masked key of a row whose max is NEG_INF
      s[j] = kvalid[j] ? expf(s[j] - mt) : 0.f;
      bsum += s[j];
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
    l = corr * l + fmaxf(bsum, EPSILON);
    m = mt;
  }

  if (live) {
    const float lc = fmaxf(l, EPSILON);
    float* op = o + (((long long)b * tq + qi) * heads + h) * dh;
    for (int d = 0; d < dh; ++d) op[d] = acc[d * BQ + tid] / lc;
    if (stats != nullptr) {
      float* sp = stats + (((long long)b * heads + h) * tq + qi) * 2;
      sp[0] = m;
      sp[1] = lc;
    }
  }
}

// dq and delta, one thread a query row. Dynamic shared memory (floats):
// ks, vs (BT, dh), dq (dh, BR).
__global__ void __launch_bounds__(BR)
flash_dq_generic(View q, View k, View v, const uint8_t* __restrict__ mask,
                 const float* __restrict__ o, const float* __restrict__ dout,
                 const float* __restrict__ stats, float* __restrict__ delta_out,
                 float* __restrict__ dq, int tq, int tk, int heads, int dh,
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
  const bool live = qi < tq;
  const int diff = max(tk - tq, 0);
  const int qpos = qi - diff;
  const long long row = ((long long)b * tq + (live ? qi : 0)) * heads + h;
  const float* qp = q.at(b, live ? qi : 0, h);
  const float* dp = dout + row * dh;
  float dlt = 0.f, m = 0.f, linv = 0.f;
  if (live) {
    const float* op = o + row * dh;
    for (int d = 0; d < dh; ++d) dlt = fmaf(dp[d], op[d], dlt);
    const float* sp = stats + (((long long)b * heads + h) * tq + qi) * 2;
    m = sp[0];
    linv = 1.f / sp[1];
  }
  for (int d = 0; d < dh; ++d) acc[d * BR + tid] = 0.f;

  // ds is 0 wherever the causal mask applies, so keys past the block's last
  // row add nothing to dq.
  const int kend = causal ? min(tk, max(0, q0 + BR - diff)) : tk;
  for (int k0 = 0; k0 < kend; k0 += BT) {
    __syncthreads();  // the previous tile is no longer read
    for (int e = tid; e < BT * dh; e += BR) {
      const int j = e / dh, d = e % dh, key = k0 + j;
      const bool in = key < tk;
      ks[e] = in ? k.at(b, key, h)[d] : 0.f;
      vs[e] = in ? v.at(b, key, h)[d] : 0.f;
    }
    if (tid < BT) kvalid[tid] = key_ok(mask, b, tk, k0 + tid);
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
      const bool vis = !causal || k0 + j <= qpos;
      const float p = (live && kvalid[j]) ? expf((vis ? s[j] : NEG_INF) - m) * linv
                                          : 0.f;
      s[j] = vis ? p * (dpv[j] - dlt) : 0.f;
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
    delta_out[((long long)b * heads + h) * tq + qi] = dlt;
  }
}

// dk and dv, one thread a key. Dynamic shared memory (floats): qs (q *
// scale), dos (BT, dh), dk, dv (dh, BR).
__global__ void __launch_bounds__(BR)
flash_dkv_generic(View q, View k, View v, const uint8_t* __restrict__ mask,
                  const float* __restrict__ dout, const float* __restrict__ stats,
                  const float* __restrict__ delta, float* __restrict__ dk,
                  float* __restrict__ dv, int tq, int tk, int heads, int dh,
                  int causal, float scale) {
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;
  float* dos = qs + BT * dh;
  float* dka = dos + BT * dh;  // dka[d * BR + tid]
  float* dva = dka + dh * BR;
  __shared__ float mrow[BT], lirow[BT], drow[BT];

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kj = k0 + tid;
  const bool live = kj < tk;
  const bool valid = live && key_ok(mask, b, tk, kj);
  const int diff = max(tk - tq, 0);
  const long long srow = ((long long)b * heads + h) * tq;  // of stats, delta
  const float* kp = k.at(b, live ? kj : 0, h);
  const float* vp = v.at(b, live ? kj : 0, h);
  for (int d = 0; d < dh; ++d) dka[d * BR + tid] = dva[d * BR + tid] = 0.f;

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
    for (int e = tid; e < BT * dh; e += BR) {
      const int r = e / dh, d = e % dh, qi = i0 + r;
      const bool in = qi < tq;
      qs[e] = in ? q.at(b, qi, h)[d] * scale : 0.f;
      dos[e] = in ? dout[(((long long)b * tq + qi) * heads + h) * dh + d] : 0.f;
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
      const bool vis = !causal || kj <= qi - diff;
      const float p = (valid && qi < tq)
                          ? expf((vis ? s[r] : NEG_INF) - mrow[r]) * lirow[r]
                          : 0.f;
      dpv[r] = vis ? p * (dpv[r] - drow[r]) : 0.f;
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
    const long long off = (((long long)b * tk + kj) * heads + h) * dh;
    for (int d = 0; d < dh; ++d) {
      dk[off + d] = dka[d * BR + tid];
      dv[off + d] = dva[d * BR + tid];
    }
  }
}

}  // namespace

#define KANVIT_TC_SWITCH(LAUNCH) \
  switch (dh) {                  \
    case 8: LAUNCH(8); break;    \
    case 16: LAUNCH(16); break;  \
    case 32: LAUNCH(32); break;  \
    case 64: LAUNCH(64); break;  \
  }

// q: f32, element (b, t, h, d) of a (batch, tq, heads, dh) tensor at
// b*q_sb + t*q_st + h*q_sh + d (strides in elements); k, v alike over tk
// keys. mask: (batch, tk) uint8 (nonzero = attend) or null. o: (batch, tq,
// heads*dh) f32 contiguous; stats: (batch, heads, tq, 2) f32, each row's
// (max, clamped sum) for the backward, or null. dh is a multiple of 8 from 8
// through 128 (attention_common.cuh); at dh 8, 16, 32 and 64 (the
// tensor-core kernels) q, k and v must be 16-byte aligned with strides that
// are multiples of 4, else cudaErrorMisalignedAddress. Launches on `stream`
// and returns cudaGetLastError() (0 on success).
extern "C" int kanvit_flash_attention_fwd(
    const float* q, const float* k, const float* v, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh,
    const uint8_t* mask, float* o, float* stats, int batch, int tq, int tk,
    int heads, int dh, int causal, float scale, void* stream) {
  if (bad_dims(batch, tq, tk, heads)) return (int)cudaErrorInvalidValue;
  const View qv{q, q_sb, q_st, q_sh}, kv{k, k_sb, k_st, k_sh},
      vv{v, v_sb, v_st, v_sh};
  const cudaStream_t st = (cudaStream_t)stream;
  if (tc_head_dim(dh)) {
    if (!rows_aligned(q, k, v, q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh))
      return (int)cudaErrorMisalignedAddress;
    const dim3 grid(heads, batch, (tq + TC_ROWS - 1) / TC_ROWS);
    int err = 0;
#define KANVIT_FWD(D)                                                        \
  err = allow_shared(flash_fwd_tc<D>, fwd_smem<D>());                        \
  if (err == 0)                                                              \
    flash_fwd_tc<D><<<grid, NT, fwd_smem<D>(), st>>>(                        \
        qv, kv, vv, mask, o, stats, tq, tk, heads, causal, scale)
    KANVIT_TC_SWITCH(KANVIT_FWD)
#undef KANVIT_FWD
    return err != 0 ? err : (int)cudaGetLastError();
  }
  if (!generic_head_dim(dh)) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (2 * BKV + BQ) * dh;
  const int err = allow_shared(flash_fwd_generic, smem);
  if (err != 0) return err;
  flash_fwd_generic<<<dim3((tq + BQ - 1) / BQ, heads, batch), BQ, smem, st>>>(
      qv, kv, vv, mask, o, stats, tq, tk, heads, dh, causal, scale);
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
  const cudaStream_t st = (cudaStream_t)stream;
  if (tc_head_dim(dh)) {
    if (!rows_aligned(q, k, v, q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh))
      return (int)cudaErrorMisalignedAddress;
    const dim3 grid(heads, batch, (tq + TC_ROWS - 1) / TC_ROWS);
    int err = 0;
#define KANVIT_DQ(D)                                                         \
  err = allow_shared(flash_dq_tc<D>, dq_smem<D>());                          \
  if (err == 0)                                                              \
    flash_dq_tc<D><<<grid, NT, dq_smem<D>(), st>>>(                          \
        qv, kv, vv, mask, o, dout, stats, delta, dq, tq, tk, heads, causal,  \
        scale)
    KANVIT_TC_SWITCH(KANVIT_DQ)
#undef KANVIT_DQ
    return err != 0 ? err : (int)cudaGetLastError();
  }
  if (!generic_head_dim(dh)) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (2 * BT + BR) * dh;
  const int err = allow_shared(flash_dq_generic, smem);
  if (err != 0) return err;
  flash_dq_generic<<<dim3((tq + BR - 1) / BR, heads, batch), BR, smem, st>>>(
      qv, kv, vv, mask, o, dout, stats, delta, dq, tq, tk, heads, dh, causal,
      scale);
  return (int)cudaGetLastError();
}

// dk and dv of kanvit_flash_attention_fwd. q, k, v, mask, dout and stats as
// for the dq kernel (dout 16-byte aligned at the tensor-core head dims);
// delta: what the dq kernel wrote; dk, dv: (batch, tk, heads*dh) f32
// contiguous. Launches on `stream` and returns cudaGetLastError().
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
  const cudaStream_t st = (cudaStream_t)stream;
  if (tc_head_dim(dh)) {
    if (!rows_aligned(q, k, v, q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh) ||
        (uintptr_t)dout % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
    const dim3 grid(heads, batch, (tk + TC_ROWS - 1) / TC_ROWS);
    int err = 0;
#define KANVIT_DKV(D)                                                        \
  err = allow_shared(flash_dkv_tc<D>, dkv_smem<D>());                        \
  if (err == 0)                                                              \
    flash_dkv_tc<D><<<grid, NT, dkv_smem<D>(), st>>>(                        \
        qv, kv, vv, mask, dout, stats, delta, dk, dv, tq, tk, heads, causal, \
        scale)
    KANVIT_TC_SWITCH(KANVIT_DKV)
#undef KANVIT_DKV
    return err != 0 ? err : (int)cudaGetLastError();
  }
  if (!generic_head_dim(dh)) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (2 * BT + 2 * BR) * dh;
  const int err = allow_shared(flash_dkv_generic, smem);
  if (err != 0) return err;
  flash_dkv_generic<<<dim3((tk + BR - 1) / BR, heads, batch), BR, smem, st>>>(
      qv, kv, vv, mask, dout, stats, delta, dk, dv, tq, tk, heads, dh, causal,
      scale);
  return (int)cudaGetLastError();
}

// --- bf16 entries: every multiple of 8 from 8 through 128 --------------------
// As the f32 entries above, on bf16 q, k, v (and o, dout, dq, dk, dv), with
// (m, l) stats and delta in f32. Every row of q, k and v must start 16-byte
// aligned (strides multiples of 8 elements), and dout too, else
// cudaErrorMisalignedAddress; another head dim is cudaErrorInvalidValue.
// dh 8, 16, 32 and 64 take their own instantiations, every other dh the
// one padded to BF16_PAD_DH (attention_tc.cuh).
#define KANVIT_BF16_SWITCH(LAUNCH)          \
  switch (dh) {                             \
    case 8: LAUNCH(8, false); break;        \
    case 16: LAUNCH(16, false); break;      \
    case 32: LAUNCH(32, false); break;      \
    case 64: LAUNCH(64, false); break;      \
    default: LAUNCH(BF16_PAD_DH, true); break; \
  }

// The bf16 forward: o (batch, tq, heads*dh) bf16 contiguous; stats as the
// f32 forward's, or null. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int kanvit_flash_attention_fwd_bf16(
    const void* q, const void* k, const void* v, long long q_sb, long long q_st,
    long long q_sh, long long k_sb, long long k_st, long long k_sh, long long v_sb,
    long long v_st, long long v_sh, const uint8_t* mask, void* o, float* stats,
    int batch, int tq, int tk, int heads, int dh, int causal, float scale,
    void* stream) {
  if (bad_dims(batch, tq, tk, heads) || !generic_head_dim(dh)) return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  const View16 qv{static_cast<const bf*>(q), q_sb, q_st, q_sh},
      kv{static_cast<const bf*>(k), k_sb, k_st, k_sh},
      vv{static_cast<const bf*>(v), v_sb, v_st, v_sh};
  if (!rows_aligned(qv.p, kv.p, vv.p, q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh))
    return (int)cudaErrorMisalignedAddress;
  const dim3 grid(heads, batch, (tq + TC_ROWS - 1) / TC_ROWS);
#define KANVIT_FWD_BF16(D, PAD)                                              \
  flash_fwd_bf16<D, PAD><<<grid, NT, 0, (cudaStream_t)stream>>>(            \
      qv, kv, vv, mask, static_cast<bf*>(o), stats, tq, tk, heads, causal, \
      scale, dh)
  KANVIT_BF16_SWITCH(KANVIT_FWD_BF16)
#undef KANVIT_FWD_BF16
  return (int)cudaGetLastError();
}

// The bf16 backward's launch: the tensor maps of q, k and v (through their
// strides) and of do ((batch, tq, heads*dh) contiguous), DH 64 for dh
// through 64 and DH 128 past it, the block's shared memory opted into.
// Returns a CUDA error code (0 on success).
template <int DH, class Kernel, class... Args>
int hb_launch(Kernel kernel, int blocks, int heads, int batch, cudaStream_t st, Args... args) {
  // setmaxnreg moves registers between a block's warpgroups, within what
  // the block launched with: less would leave the consumers waiting.
  cudaFuncAttributes attr;
  int err = (int)cudaFuncGetAttributes(&attr, kernel);
  if (err != 0) return err;
  if (attr.numRegs * HB_THREADS < HB_WG * (HB_PRODUCER_REGS + HB_CONSUMERS * HB_CONSUMER_REGS))
    return (int)cudaErrorInvalidConfiguration;
  err = allow_shared(kernel, HbSmem<DH>::ALLOC);
  if (err != 0) return err;
  kernel<<<dim3(heads, batch, blocks), HB_THREADS, HbSmem<DH>::ALLOC, st>>>(args...);
  return (int)cudaGetLastError();
}

struct HbMaps {
  CUtensorMap q, k, v, dout;
};

static bool hb_maps(HbMaps* m, const void* q, const void* k, const void* v, const void* dout,
             long long q_sb, long long q_st, long long q_sh, long long k_sb, long long k_st,
             long long k_sh, long long v_sb, long long v_st, long long v_sh, int batch, int tq,
             int tk, int heads, int dh) {
  const long long hs = (long long)heads * dh;
  return bf16_rows_map(&m->q, q, dh, heads, tq, batch, q_sh, q_st, q_sb) &&
         bf16_rows_map(&m->k, k, dh, heads, tk, batch, k_sh, k_st, k_sb) &&
         bf16_rows_map(&m->v, v, dh, heads, tk, batch, v_sh, v_st, v_sb) &&
         bf16_rows_map(&m->dout, dout, dh, heads, tq, batch, dh, hs, tq * hs);
}

// dq of the bf16 forward and delta = rowsum(dout * o) in f32. o, dout:
// (batch, tq, heads*dh) bf16 contiguous, 16-byte aligned; stats: the
// forward's; delta: (batch, heads, tq) f32, written; dq: (batch, tq,
// heads*dh) bf16 contiguous. Launches flash_dq_bf16<64> for dh through 64,
// <128> past it.
extern "C" int kanvit_flash_attention_dq_bf16(
    const void* q, const void* k, const void* v, long long q_sb, long long q_st,
    long long q_sh, long long k_sb, long long k_st, long long k_sh, long long v_sb,
    long long v_st, long long v_sh, const uint8_t* mask, const void* o,
    const void* dout, const float* stats, float* delta, void* dq, int batch, int tq,
    int tk, int heads, int dh, int causal, float scale, void* stream) {
  if (bad_dims(batch, tq, tk, heads) || !generic_head_dim(dh)) return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  if (!rows_aligned(static_cast<const bf*>(q), static_cast<const bf*>(k),
                    static_cast<const bf*>(v), q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st,
                    v_sh) ||
      (uintptr_t)o % 16 != 0 || (uintptr_t)dout % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  HbMaps m;
  if (!hb_maps(&m, q, k, v, dout, q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, batch,
               tq, tk, heads, dh))
    return (int)cudaErrorInvalidValue;
  const int blocks = (tq + HB_BLOCK - 1) / HB_BLOCK;
  const cudaStream_t st = (cudaStream_t)stream;
#define KANVIT_DQ_BF16(D)                                                                  \
  hb_launch<D>(flash_dq_bf16<D>, blocks, heads, batch, st, m.q, m.k, m.v, m.dout, mask,    \
               static_cast<const bf*>(o), static_cast<const bf*>(dout), stats, delta,      \
               static_cast<bf*>(dq), tq, tk, heads, causal, scale, dh)
  return dh <= 64 ? KANVIT_DQ_BF16(64) : KANVIT_DQ_BF16(128);
#undef KANVIT_DQ_BF16
}

// dk and dv of the bf16 forward. dout, stats as for the dq entry; delta:
// what the dq entry wrote; dk, dv: (batch, tk, heads*dh) bf16 contiguous.
// Launches flash_dkv_bf16<64> for dh through 64, <128> past it.
extern "C" int kanvit_flash_attention_dkv_bf16(
    const void* q, const void* k, const void* v, long long q_sb, long long q_st,
    long long q_sh, long long k_sb, long long k_st, long long k_sh, long long v_sb,
    long long v_st, long long v_sh, const uint8_t* mask, const void* dout,
    const float* stats, const float* delta, void* dk, void* dv, int batch, int tq,
    int tk, int heads, int dh, int causal, float scale, void* stream) {
  if (bad_dims(batch, tq, tk, heads) || !generic_head_dim(dh)) return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  if (!rows_aligned(static_cast<const bf*>(q), static_cast<const bf*>(k),
                    static_cast<const bf*>(v), q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st,
                    v_sh) ||
      (uintptr_t)dout % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  HbMaps m;
  if (!hb_maps(&m, q, k, v, dout, q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, batch,
               tq, tk, heads, dh))
    return (int)cudaErrorInvalidValue;
  const int blocks = (tk + HB_BLOCK - 1) / HB_BLOCK;
  const cudaStream_t st = (cudaStream_t)stream;
#define KANVIT_DKV_BF16(D)                                                                 \
  hb_launch<D>(flash_dkv_bf16<D>, blocks, heads, batch, st, m.q, m.k, m.v, m.dout, mask,   \
               stats, delta, static_cast<bf*>(dk), static_cast<bf*>(dv), tq, tk, heads,    \
               causal, scale, dh)
  return dh <= 64 ? KANVIT_DKV_BF16(64) : KANVIT_DKV_BF16(128);
#undef KANVIT_DKV_BF16
}

