// Helpers shared by the attention kernels (attention_lanes.cu,
// flash_attention.cu): the two-threads-a-row reductions and the padded
// shared-memory tile they read.

#pragma once

#include <cuda_runtime.h>

namespace {

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
