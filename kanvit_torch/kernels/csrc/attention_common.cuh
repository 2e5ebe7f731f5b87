// Helpers shared by the attention kernels (attention_lanes.cu,
// flash_attention.cu): which head dims run templated or generic kernels,
// the two-threads-a-row reductions and the padded shared-memory tile they
// read.

#pragma once

#include <cuda_runtime.h>

namespace {

// Head dims. The kernels templated on dh, which keep a row in registers,
// are instantiated for 8 (the reference geometry: d 64 in 8 heads), 16, 32
// and 64. Every other multiple of 8 through 128
// (kanvit's lanes tier takes any dh % 8 == 0) runs the generic kernels,
// which walk the head dim at run time in chunks of GENERIC_CHUNK with the
// accumulators in shared memory: their code does not grow with dh, so one
// instantiation serves every dh. (ptxas time of a templated instantiation
// grows with dh: one per dh made the build of the whole set run for many
// minutes.)
constexpr int GENERIC_CHUNK = 8;
constexpr int MAX_HEAD_DIM = 128;

inline bool generic_head_dim(int dh) {
  return dh % GENERIC_CHUNK == 0 && dh >= GENERIC_CHUNK && dh <= MAX_HEAD_DIM;
}

// Shared memory past 48 KB a block, the kernel's static and `bytes` of
// dynamic, needs the kernel's opt-in. (The dynamic bytes alone at exactly
// 48 KB, the f32 generic lanes forward at dh 96, failed to launch.)
template <class K>
int allow_shared(K kernel, size_t bytes) {
  if (bytes == 0) return 0;
  cudaFuncAttributes attr;
  const int err = (int)cudaFuncGetAttributes(&attr, kernel);
  if (err != 0) return err;
  if (bytes + attr.sharedSizeBytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Sum of a two-thread row's halves (the pair are neighbouring lanes).
__device__ __forceinline__ float pair_sum(float x) {
  return x + __shfl_xor_sync(0xffffffffu, x, 1);
}

// Four floats from shared memory, 16-byte aligned.
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Row pitch of a staged (rows, DH) tile: half 1 of a row starts 4 floats
// late when DH/2 is a multiple of 32 floats, so the pair's two 16-byte
// reads fall in different banks. Every half row starts 16-byte aligned.
template <int DH>
struct Tile {
  static constexpr int HD = DH / 2;
  static constexpr int PAD = (HD % 32 == 0) ? 4 : 0;
  static constexpr int PITCH = DH + PAD;
  static __device__ __forceinline__ int at(int half, int d) {
    return half * (HD + PAD) + d;
  }
};

}  // namespace
