// The card's issue rate of mma.sync.m16n8k8 TF32, the instruction every
// tensor-core kernel of this port runs (attention_lanes.cu,
// flash_attention.cu, fused_ffn.cu): each warp issues `iters` rounds of
// eight independent mma into eight accumulators, operands in registers, no
// memory traffic. chip_smoke.py times it to set the kernels' times beside
// what this instruction can reach on the card, next to the published dense
// TF32 peak (495 TFLOP/s), which only wgmma reaches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tc.cuh"

namespace {

constexpr int PROBE_THREADS = 256;
constexpr int PROBE_CHAINS = 8;

__global__ void __launch_bounds__(PROBE_THREADS)
tf32_mma_rate(float* __restrict__ out, int iters) {
  const uint32_t lane = threadIdx.x & 31;
  const uint32_t a[4] = {lane, lane + 1, lane + 2, lane + 3};
  const uint32_t b[2] = {lane ^ 5u, lane ^ 9u};
  float acc[PROBE_CHAINS][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < PROBE_CHAINS; ++c) mma_tf32(acc[c], a, b);
  }
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < PROBE_CHAINS; ++c)
    s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  out[blockIdx.x * PROBE_THREADS + threadIdx.x] = s;
}

}  // namespace

// blocks x 256 threads, each warp 8 x iters mma.sync (2,048 FLOP each);
// out (blocks * 256) f32. Returns cudaGetLastError() (0 on success).
extern "C" int kanvit_tf32_mma_rate(float* out, int blocks, int iters, void* stream) {
  if (blocks <= 0 || iters <= 0) return (int)cudaErrorInvalidValue;
  tf32_mma_rate<<<blocks, PROBE_THREADS, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}
