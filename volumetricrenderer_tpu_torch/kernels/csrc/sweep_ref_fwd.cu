// Forward slice sweep of the 4-channel reference medium for Hopper
// (sm_90a): the emission-absorption march over pre-lerped channel slabs,
// front to back.
//
// Replaces the TPU kernel volumetricrenderer_tpu/kernels/sweep_pallas.py
// `_fwd_kernel_ref` / `_run_fwd_ref`, its light-volume branch included. It
// computes that kernel's function, not its schedule: no streamed
// per-(slice, channel) banded row matrices on the MXU, no lane gathers or
// one-hot column matrices, no (RB, Wb) blocks and no chunk checkpoints.
// The taps are computed in the kernel from the plan vectors and params.
//
// Design. The single-channel kernel's (sweep_fwd.cu): one thread per base
// pixel (i, j), blocks of 32 x 8 threads with j on the fast axis, the
// carries (acc, T, wsum, hit) in registers, the four maps written once at
// the end. Per slice s, with delta = slice_z[s] - e_k:
//   * slices with delta * sign <= 0 lie behind the eye and are skipped;
//   * a01 = e_a + delta * v[i], b01 = e_b + delta * u[j]; outside [0, 1]^2
//     (the unscaled coordinates: the box test is the ray's) sigma is 0 and
//     the taps are skipped;
//   * per channel c: taps at a01 * sc_c + offa_c and b01 * sc_c + offb_c,
//     p = x * N - 0.5, i0 = floor(p), f = p - i0, both indices reflected
//     with period 2N (a scrolled coordinate leaves [0, 1], so the mirror is
//     a true reflection, not the clip of the single-channel kernel); four
//     reads of L[s, c] and a bilinear sum;
//   * sigma = (r0 * r1) * (r2 + r3) * sample_scale;
//   * emission: alpha = 1 - exp(-density * sigma * seg), wsum += T * alpha,
//     T *= 1 - alpha, stopping once T <= thresh as the live gate would;
//   * emission with a light volume (the light branch, a template
//     parameter; a null light pointer launches the kernel without it): the
//     light slabs (S, A, B) are pre-lerped onto the slice planes by the
//     wrapper, so slab s belongs to slice s; the light is not a scrolled
//     noise channel, so its taps are the unscaled a01, b01 with clipping
//     (sweep::sample_taps), shade and wsum += (T * alpha) * shade as in the
//     single-channel kernel (sweep::light_shade);
//   * absorption: acc += sigma * seg, hit = 1 (hit does not depend on the
//     channels).
// L is built by the wrapper in slice_z order (the sweep-axis lerp of each
// channel at its own scaled and scrolled depth), so there is no flip here.
//
// Layout: `L` is a contiguous (S, 4, A, B) tensor.
//
// Stream modes: the texel type T of `L` and of the light slabs is a
// template parameter, float or __nv_bfloat16 (the TPU kernel's bfloat16
// streams: the slabs and every channel's tap weights in bfloat16, everything
// else float32; see sweep_common.cuh). The float instantiations are the
// float32 kernels as they were.
//
// Bound: 16 scattered 4-byte tap reads and about 116 float operations per
// in-box sample, against 4 and 30 in the single-channel kernel; the four
// channels' taps fall on four different places of four slabs, so a warp
// touches four times the cache lines. Operations bound it on paper; the
// scattered reads through L1/L2 are what a faster version would stage in
// shared memory, later.
//
// Numerics: expf, --fmad=false, and every tap, sample and sigma from
// sweep_ref_common.cuh, shared with the backward kernel (sweep_ref_bwd.cu),
// whose replay of the transmittance must reproduce this kernel's bit for
// bit.

#include "sweep_ref_common.cuh"

namespace {

template <bool kLight, typename T>
__global__ void __launch_bounds__(256) sweep_ref_fwd_kernel(
    const T* __restrict__ L, const T* __restrict__ light,
    const float* __restrict__ slice_z,
    const float* __restrict__ v_grid, const float* __restrict__ u_grid,
    const float* __restrict__ seglen, const float* __restrict__ params,
    float* __restrict__ out, int S, int A, int B, int Hb, int Wb,
    int emission) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= Hb || j >= Wb) return;

  const sweep::Params P = sweep::load_params(params);
  const sweep::RefParams R = sweep::load_ref_params(params);
  const float v = v_grid[i];
  const float u = u_grid[j];
  const size_t pix = (size_t)i * Wb + j;
  const float seg = seglen[pix];
  const size_t slab = (size_t)sweep::NCH * A * B;

  float acc = 0.f, trans = 1.f, wsum = 0.f, hit = 0.f;
  for (int s = 0; s < S; ++s) {
    if (emission && !(trans > P.thresh)) break;
    const float delta = slice_z[s] - P.e_k;
    if (!sweep::in_front(P, delta)) continue;
    sweep::RefSample smp;
    if (!sweep::ref_sample<T>(P, R, delta, v, u, L + (size_t)s * slab, A, B,
                              smp))
      continue;
    const float sigma = sweep::ref_sigma(smp.r, P.sscale);
    if (emission) {
      const float alpha = 1.f - sweep::extinction(P, sigma, seg);
      if constexpr (kLight) {
        sweep::Taps tl;
        sweep::sample_taps(P, delta, v, u, A, B, 0, tl);
        float lT;
        const float shade = sweep::light_shade<T>(
            light + (size_t)s * A * B, B, tl, P.ambient, lT);
        wsum += (trans * alpha) * shade;
      } else {
        wsum += trans * alpha;
      }
      trans *= 1.f - alpha;
    } else {
      acc += sigma * seg;
      hit = 1.f;
    }
  }
  const size_t plane = (size_t)Hb * Wb;
  out[pix] = acc;
  out[plane + pix] = trans;
  out[2 * plane + pix] = wsum;
  out[3 * plane + pix] = hit;
}

template <typename T>
int launch(const void* L_v, const void* light_v, const float* slice_z,
           const float* v_grid, const float* u_grid, const float* seglen,
           const float* params, float* out, int S, int A, int B, int Hb,
           int Wb, int emission, cudaStream_t st) {
  const T* L = static_cast<const T*>(L_v);
  const T* light = static_cast<const T*>(light_v);
  const dim3 block(32, 8);
  const dim3 grid((Wb + block.x - 1) / block.x, (Hb + block.y - 1) / block.y);
  if (light)
    sweep_ref_fwd_kernel<true, T><<<grid, block, 0, st>>>(
        L, light, slice_z, v_grid, u_grid, seglen, params, out, S, A, B, Hb,
        Wb, emission);
  else
    sweep_ref_fwd_kernel<false, T><<<grid, block, 0, st>>>(
        L, light, slice_z, v_grid, u_grid, seglen, params, out, S, A, B, Hb,
        Wb, emission);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the sweep on `stream` and returns cudaGetLastError() (0 when the
// launch was accepted). `elem` is the texel type of `L` and `light`:
// sweep::kElemF32 or sweep::kElemBF16 (anything else is refused with
// cudaErrorInvalidValue). `L` is (S, 4, A, B), `light` the (S, A, B) light
// slabs in slice order or null for no light volume (emission only), `params`
// (20,), `out` (4, Hb, Wb) float32: acc, trans, wsum, hit.
extern "C" int sweep_ref_fwd_launch(const void* L, const void* light,
                                    const float* slice_z, const float* v_grid,
                                    const float* u_grid, const float* seglen,
                                    const float* params, float* out, int S,
                                    int A, int B, int Hb, int Wb, int emission,
                                    int elem, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem == sweep::kElemF32)
    return launch<float>(L, light, slice_z, v_grid, u_grid, seglen, params,
                         out, S, A, B, Hb, Wb, emission, st);
  if (elem == sweep::kElemBF16)
    return launch<__nv_bfloat16>(L, light, slice_z, v_grid, u_grid, seglen,
                                 params, out, S, A, B, Hb, Wb, emission, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
