// Hopper's building blocks (sm_90a) for the bf16 tiled attention backward
// (flash_attention.cu): TMA tile loads over tensor maps, mbarriers, named
// barriers, setmaxnreg, and wgmma.mma_async on 128-byte-swizzled shared
// memory with f32 accumulators.
//
// Shared memory holds operands as panels: 64 rows of 64 bf16 (128 bytes), a
// panel 8 KB and 1024-byte aligned, written by one TMA box of 64 columns x
// 64 rows with CU_TENSOR_MAP_SWIZZLE_128B (the 16-byte chunks of row r
// XORed with r % 8). A row wider than 64 columns spans panels side by side.
// wgmma reads a panel two ways:
//   K-major (the contracted index along the row): 8-row groups 1024 bytes
//       apart (SBO), each 16-deep step 32 bytes further along the row;
//   MN-major (the contracted index down the rows, the output columns along
//       them): 8-row groups of the contracted index 1024 bytes apart (SBO),
//       the next 64 output columns one panel on (LBO), each 16-deep step
//       16 rows (2048 bytes) further.

#pragma once

#include <cuda.h>  // CUtensorMap (a type only: no driver call is linked)
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PANEL_ROWS = 64;                        // rows (and columns) a panel
constexpr int PANEL_BYTES = PANEL_ROWS * 64 * 2;      // 8 KB

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// --- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the other threads and to TMA.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(smem_addr(bar)) : "memory");
}

// This thread's arrival, and `bytes` more for the phase to wait for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Spin until the phase of parity `parity` has completed. A wait that lasts
// past MBAR_SPINS polls traps, so that a fault in a pipeline ends the
// launch with an error instead of hanging the card.
constexpr uint32_t MBAR_SPINS = 1u << 25;

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n.reg .u32 n;\nmov.u32 n, 0;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@done bra DONE;\nadd.u32 n, n, 1;\nsetp.lt.u32 done, n, %2;\n"
      "@done bra WAIT;\ntrap;\nDONE:\n}\n"
      :: "r"(smem_addr(bar)), "r"(parity), "n"(MBAR_SPINS) : "memory");
}

// --- TMA -----------------------------------------------------------------------

// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory at dst, completing its bytes on bar.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// --- warp specialisation -----------------------------------------------------

template <int REGS>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(REGS));
}

// Barrier `id` (1-15; 0 is __syncthreads') over `count` threads.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(count) : "memory");
}

// --- wgmma -----------------------------------------------------------------------

__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo & 0x3FFFF) >> 4) << 16 |
         (uint64_t)((sbo & 0x3FFFF) >> 4) << 32 | 1ull << 62;  // 128-byte swizzle
}

// Step kk (16 deep) of a K-major operand of 64 rows whose row is `panels`
// panels wide, starting at the panel at `addr`.
__device__ __forceinline__ uint64_t desc_k(uint32_t addr, int kk) {
  return smem_desc(addr + (kk >> 2) * PANEL_BYTES + (kk & 3) * 32, 16, 1024);
}

// Step kk (16 rows) of an MN-major operand whose output columns lie in
// panels side by side, starting at the panel at `addr`.
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, int kk) {
  return smem_desc(addr + kk * 2048, PANEL_BYTES, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of d across the
// asynchronous products (after a wait, before a fence).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

// The accumulator of m64nNk16 (f32): warp w of the warpgroup holds rows
// 16w .. 16w + 15; d[4n + c] is row 16w + lane / 4 (+ 8 for c >= 2),
// column 8n + 2 (lane % 4) + (c & 1): mma.sync's C fragment a warp, n8
// tile n. Its 16-deep step kk packed to bf16 (d[8kk .. 8kk + 7]) is the A
// fragment of the step over those columns.

// d (+)= A B over one 16-deep step, m64n64k16: A and B K-major in shared
// memory (descriptors a and b); accumulate == 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A B over one 16-deep step, m64n64k16: A from registers (each
// warp its 16 rows as an m16n8k16 A fragment), B K-major in shared memory
// (descriptor b); accumulate == 0 overwrites d.
__device__ __forceinline__ void wgmma_rs_n64_k(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (+)= A B over one 16-deep step, m64n64k16: A from registers (each
// warp its 16 rows as an m16n8k16 A fragment), B MN-major in shared memory
// (descriptor b); accumulate == 0 overwrites d.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (+)= A B over one 16-deep step, m64n128k16: A from registers (each
// warp its 16 rows as an m16n8k16 A fragment), B MN-major in shared memory
// (descriptor b); accumulate == 0 overwrites d.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d += A B with N = 64 or 128 output columns, B MN-major: wgmma_rs_n64 or
// wgmma_rs_n128.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 64) {
    wgmma_rs_n64(d, a, b, 1);
  } else {
    static_assert(N == 128, "wgmma_rs: 64 or 128 columns");
    wgmma_rs_n128(d, a, b, 1);
  }
}

// The A fragments (16-deep steps kk < DH / 16) of rows 16 warp .. + 15 of
// a 64-row K-major tile of DH / 64 panels at `tile`, as TMA's 128-byte
// swizzle laid them out (16-byte chunk c of row r at chunk c ^ (r % 8)).
template <int DH>
__device__ __forceinline__ void panel_a_frags(const uint8_t* tile, int warp, int lane,
                                              uint32_t (&a)[DH / 16][4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = warp * 16 + g + 8 * half, c = 2 * (kk & 3);
      const uint8_t* row = tile + (kk >> 2) * PANEL_BYTES + r * 128 + 4 * t;
      a[kk][half] = *reinterpret_cast<const uint32_t*>(row + ((c ^ (r & 7)) << 4));
      a[kk][2 + half] = *reinterpret_cast<const uint32_t*>(row + (((c + 1) ^ (r & 7)) << 4));
    }
}

// --- tensor maps (host) ----------------------------------------------------------

// cuTensorMapEncodeTiled, fetched from the driver at run time, so the
// library links no -lcuda; null if the driver has none.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A bf16 (batch, t, heads, dh) tensor at p, read through its strides (in
// elements, each a multiple of 8), as the 4-D tensor map (dh, heads, t,
// batch) of boxes of 64 columns x 64 rows of one head, swizzled for wgmma
// (128 bytes), zero past every edge: past dh, and rows past t. A dim of
// extent 1 takes the largest stride (TMA asks a nonzero multiple of 16
// bytes; its stride is never used). False if the driver refuses it.
inline bool bf16_rows_map(CUtensorMap* map, const void* p, int dh, int heads, int t, int batch,
                          long long sh, long long st, long long sb) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const long long big = sh > st ? (sh > sb ? sh : sb) : (st > sb ? st : sb);
  const long long fallback = big > dh ? big : dh;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)heads, (cuuint64_t)t,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)(heads > 1 ? sh : fallback) * 2,
                                 (cuuint64_t)(t > 1 ? st : fallback) * 2,
                                 (cuuint64_t)(batch > 1 ? sb : fallback) * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)PANEL_ROWS, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
