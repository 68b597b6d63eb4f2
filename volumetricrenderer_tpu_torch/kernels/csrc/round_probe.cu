// A probe of the bfloat16 stream mode's weight rounding for Hopper
// (sm_90a): out[i] = sweep::round_weight<__nv_bfloat16>(in[i]), the
// rounding the sweep kernels apply to every bilinear tap weight
// (sweep_common.cuh), alone, so that it can be held against torch's own
// float32 -> bfloat16 rounding. No sweep calls it: it is a library of its
// own, built only by the checks that use it (kernels/round_probe.py).

#include <cuda_runtime.h>

#include "sweep_common.cuh"

namespace {

__global__ void round_weights_kernel(const float* __restrict__ in,
                                     float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = sweep::round_weight<__nv_bfloat16>(in[i]);
}

}  // namespace

// Rounds n float32 values on `stream` and returns cudaGetLastError().
extern "C" int round_weights_launch(const float* in, float* out, int n,
                                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 block(256);
  const dim3 grid((n + block.x - 1) / block.x);
  if (n > 0) round_weights_kernel<<<grid, block, 0, st>>>(in, out, n);
  return static_cast<int>(cudaGetLastError());
}
