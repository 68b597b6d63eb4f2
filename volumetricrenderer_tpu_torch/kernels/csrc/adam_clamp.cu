// Adam's update and the clamp of fit_grid's grid for Hopper (sm_90a), in
// one pass over the grid.
//
// It replaces no Pallas kernel. The JAX package runs optax.adam and then
// jnp.clip inside one jitted step (volumetricrenderer_tpu/fit.py:94-111),
// which XLA fuses into one loop. The port ran torch.optim.Adam's foreach
// path, seven passes over the grid-sized tensors (lerp, mul, addcmul,
// sqrt, div, add, addcdiv), and then the clamp, an eighth: about 80 B a
// voxel moved, and eight launches a step.
//
// The function (the plain version is kernels/adam_clamp.py
// adam_clamp_reference: torch.optim.Adam's step, then clamp_). Per element,
// in torch's non-capturable _multi_tensor_adam order, each operation
// rounded on its own as torch's CUDA kernels round it:
//   m = m + (1 - beta1) * (g - m)          torch's lerp (weight under 0.5)
//   v = v * beta2 + (1 - beta2) * (g * g)  _foreach_mul_, _foreach_addcmul_
//   d = sqrt(v) / bias_correction2_sqrt + eps
//   p = p + step_size * (m / d)            _foreach_addcdiv_
//   p = isnan(p) ? p : min(max(p, lo), hi) torch.clamp, which keeps a NaN
// torch's CUDA kernels (built with nvcc's default --fmad=true) contract
// the lerp's, the addcmul's and the addcdiv's last product and sum into a
// fused multiply-add and divide exactly; here those are __fmaf_rn and every
// other operation is its own correctly rounded intrinsic, so the result
// does not hang on this build's --fmad=false. Stage by stage and whole, the
// kernel equals torch 2.11's foreach Adam and clamp_ bit for bit on an
// NVIDIA H100 (tests/test_torch_gpu.py).
// The host passes the scalars as torch computes them, in double and then
// rounded to float: 1 - beta1, beta2, 1 - beta2, step_size = -lr / (1 -
// beta1^t), bias_correction2_sqrt = sqrt(1 - beta2^t), eps.
//
// What bounds it. Per voxel the update reads the grid, its gradient and
// both moments and writes the grid and both moments: 7 words, 28 B, 3.76
// GB at 512^3, 1.12 ms at 3.35 TB/s. About 15 operations a voxel is half
// an operation a byte, far under the card's 20: bytes bound it, and the
// design is about moving each byte once at the card's rate:
//   - one pass: the four words of a voxel are loaded, updated in registers
//     (the clamp too) and the three results stored, nothing else;
//   - 16-byte accesses (float4), consecutive threads on consecutive
//     addresses, so every warp request is whole 128-byte lines;
//   - streaming hints (__ldcs / __stcs, evict-first): the 2.15 GB of state
//     at 512^3 is 43 times the 50 MB L2, so nothing read is read again;
//   - each thread loads kUnroll float4 of each of the four inputs before
//     it computes: 8 loads of 16 B in flight, enough to cover the memory's
//     latency at the 5 blocks of 256 threads an SM holds (47 registers);
//   - one trip per block, as many blocks as the data needs: on an NVIDIA
//     H100 80GB HBM3 at 512^3 a grid of one resident wave looping over the
//     data took 1.32-1.35 ms, this grid 1.25-1.27 ms (89 % of the bound;
//     torch's copy_ of 1.07 GB reached 90 % on the same card). The grid-
//     stride loop is kept only for data beyond one launch's blocks.
// adam_clamp_vec takes the float4 path when all four pointers are 16-byte
// aligned, with the numel % 4 last elements done by the first threads of
// block 0; adam_clamp_scalar takes any alignment, one float at a time.
// Either is one launch a step.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;        // float4 of each input per thread per trip
constexpr int kUnrollScalar = 8;  // floats of each input, scalar path
constexpr long long kMaxBlocks = 0x7fffffff;  // a launch's gridDim.x

struct Coeffs {
  float one_minus_beta1, beta2, one_minus_beta2, step_size, bc2_sqrt, eps,
      lo, hi;
};

__device__ __forceinline__ void update(float& p, float g, float& m,
                                       float& v, const Coeffs& c) {
  m = __fmaf_rn(c.one_minus_beta1, __fsub_rn(g, m), m);
  v = __fmaf_rn(c.one_minus_beta2, __fmul_rn(g, g), __fmul_rn(v, c.beta2));
  const float d = __fadd_rn(__fdiv_rn(__fsqrt_rn(v), c.bc2_sqrt), c.eps);
  p = __fmaf_rn(c.step_size, __fdiv_rn(m, d), p);
  p = isnan(p) ? p : fminf(fmaxf(p, c.lo), c.hi);
}

__device__ __forceinline__ void update4(float4& p, const float4& g,
                                        float4& m, float4& v,
                                        const Coeffs& c) {
  update(p.x, g.x, m.x, v.x, c);
  update(p.y, g.y, m.y, v.y, c);
  update(p.z, g.z, m.z, v.z, c);
  update(p.w, g.w, m.w, v.w, c);
}

// n4 float4 of each tensor, then `tail` (< 4) floats past them.
__global__ void __launch_bounds__(kThreads)
adam_clamp_vec(float* __restrict__ p, const float* __restrict__ g,
               float* __restrict__ m, float* __restrict__ v, long long n4,
               int tail, Coeffs c) {
  float4* p4 = reinterpret_cast<float4*>(p);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* m4 = reinterpret_cast<float4*>(m);
  float4* v4 = reinterpret_cast<float4*>(v);
  const long long trip = static_cast<long long>(gridDim.x) * kThreads
      * kUnroll;
  for (long long i0 = static_cast<long long>(blockIdx.x) * kThreads * kUnroll
           + threadIdx.x;
       i0 < n4; i0 += trip) {
    float4 rp[kUnroll], rg[kUnroll], rm[kUnroll], rv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + static_cast<long long>(u) * kThreads;
      if (i < n4) {
        rg[u] = __ldcs(g4 + i);
        rm[u] = __ldcs(m4 + i);
        rv[u] = __ldcs(v4 + i);
        rp[u] = __ldcs(p4 + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + static_cast<long long>(u) * kThreads;
      if (i < n4) {
        update4(rp[u], rg[u], rm[u], rv[u], c);
        __stcs(p4 + i, rp[u]);
        __stcs(m4 + i, rm[u]);
        __stcs(v4 + i, rv[u]);
      }
    }
  }
  if (blockIdx.x == 0 && static_cast<int>(threadIdx.x) < tail) {
    const long long i = 4 * n4 + threadIdx.x;
    float rp = p[i], rm = m[i], rv = v[i];
    update(rp, g[i], rm, rv, c);
    p[i] = rp;
    m[i] = rm;
    v[i] = rv;
  }
}

__global__ void __launch_bounds__(kThreads)
adam_clamp_scalar(float* __restrict__ p, const float* __restrict__ g,
                  float* __restrict__ m, float* __restrict__ v, long long n,
                  Coeffs c) {
  const long long trip = static_cast<long long>(gridDim.x) * kThreads
      * kUnrollScalar;
  for (long long i0 = static_cast<long long>(blockIdx.x) * kThreads
           * kUnrollScalar + threadIdx.x;
       i0 < n; i0 += trip) {
    float rp[kUnrollScalar], rg[kUnrollScalar], rm[kUnrollScalar],
        rv[kUnrollScalar];
#pragma unroll
    for (int u = 0; u < kUnrollScalar; ++u) {
      const long long i = i0 + static_cast<long long>(u) * kThreads;
      if (i < n) {
        rg[u] = __ldcs(g + i);
        rm[u] = __ldcs(m + i);
        rv[u] = __ldcs(v + i);
        rp[u] = __ldcs(p + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnrollScalar; ++u) {
      const long long i = i0 + static_cast<long long>(u) * kThreads;
      if (i < n) {
        update(rp[u], rg[u], rm[u], rv[u], c);
        __stcs(p + i, rp[u]);
        __stcs(m + i, rm[u]);
        __stcs(v + i, rv[u]);
      }
    }
  }
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// Blocks enough for one trip each over `items`, at least one, at most what
// a launch takes (the grid-stride loop covers any rest).
unsigned blocks_for(long long items, int per_block) {
  long long blocks = ceil_div(items, per_block);
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<unsigned>(blocks);
}

}  // namespace

// One Adam-and-clamp step over n float32 elements of p (the grid), g (its
// gradient, read only), m and v (the moments), all on the current device,
// updated in place on `stream`. vectorized: the caller has seen all four
// pointers 16-byte aligned (float4 path); else the scalar path. Returns
// the launch's cudaGetLastError().
extern "C" int adam_clamp_launch(float* p, const float* g, float* m, float* v,
                                 long long n, int vectorized,
                                 float one_minus_beta1, float beta2,
                                 float one_minus_beta2, float step_size,
                                 float bc2_sqrt, float eps, float lo,
                                 float hi, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const std::uintptr_t bits = reinterpret_cast<std::uintptr_t>(p)
      | reinterpret_cast<std::uintptr_t>(g)
      | reinterpret_cast<std::uintptr_t>(m)
      | reinterpret_cast<std::uintptr_t>(v);
  if (vectorized && (bits & 15u) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Coeffs c = {one_minus_beta1, beta2, one_minus_beta2, step_size,
                    bc2_sqrt, eps, lo, hi};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vectorized) {
    const long long n4 = n / 4;
    adam_clamp_vec<<<blocks_for(n4, kThreads * kUnroll), kThreads, 0, st>>>(
        p, g, m, v, n4, static_cast<int>(n - 4 * n4), c);
  } else {
    adam_clamp_scalar<<<blocks_for(n, kThreads * kUnrollScalar), kThreads, 0,
                        st>>>(p, g, m, v, n, c);
  }
  return static_cast<int>(cudaGetLastError());
}
