// Device code shared by the slice-sweep kernels (sweep_fwd.cu, sweep_bwd.cu).
//
// The backward kernel replays the forward's transmittance slice by slice,
// and the early-stop gate T > thresh decides which slices contribute. A
// replay that rounds one product differently can flip that gate at another
// slice than the forward did, which changes the gradient by more than a
// rounding error. So both kernels take the tap coordinates, the texel
// indices, the bilinear sum, sigma and the extinction factor from these
// functions, with the same evaluation order, and the build passes
// --fmad=false (kernels/build.py) so no product is fused into an add.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace sweep {

// params (8,) float32: e_k, e_a, e_b, sign, density, sample_scale,
// early-stop transmittance, ambient (unused without a light volume).
struct Params {
  float e_k, e_a, e_b, sign, density, sscale, thresh;
};

__device__ __forceinline__ Params load_params(const float* __restrict__ p) {
  return Params{p[0], p[1], p[2], p[3], p[4], p[5], p[6]};
}

__device__ __forceinline__ int wrap_index(int i, int n) {
  const int m = i % n;
  return m < 0 ? m + n : m;
}

__device__ __forceinline__ int clip_index(int i, int n) {
  return min(max(i, 0), n - 1);
}

// The four texels of one bilinear sample on an (A, B) layer and the
// fractions toward a1 and b1.
struct Taps {
  int a0, a1, b0, b1;
  float fa, fb;
};

// Texel-center taps along one axis: p = x01 * n - 0.5, i0 = floor(p),
// f = p - i0. Mirror and clamp clip i0, i0 + 1 to [0, n - 1] (inside the
// box the two agree texel for texel); wrap takes them modulo n.
__device__ __forceinline__ void axis_taps(float x01, int n, int wrap,
                                          int& i0, int& i1, float& f) {
  const float p = x01 * (float)n - 0.5f;
  const float p0 = floorf(p);
  f = p - p0;
  const int i = (int)p0;
  if (wrap) {
    i0 = wrap_index(i, n);
    i1 = wrap_index(i + 1, n);
  } else {
    i0 = clip_index(i, n);
    i1 = clip_index(i + 1, n);
  }
}

// The sample of base pixel (v, u) on the slice at delta = slice_z - e_k:
// a01 = e_a + delta * v, b01 = e_b + delta * u. Returns false when the
// sample lies outside [0, 1]^2, where sigma is 0 and every carry keeps its
// value, so the caller skips the taps.
__device__ __forceinline__ bool sample_taps(const Params& P, float delta,
                                            float v, float u, int A, int B,
                                            int wrap, Taps& t) {
  const float a01 = P.e_a + delta * v;
  const float b01 = P.e_b + delta * u;
  if (!(a01 >= 0.f && a01 <= 1.f && b01 >= 0.f && b01 <= 1.f)) return false;
  axis_taps(a01, A, wrap, t.a0, t.a1, t.fa);
  axis_taps(b01, B, wrap, t.b0, t.b1, t.fb);
  return true;
}

// Slices with delta * sign <= 0 lie behind the eye.
__device__ __forceinline__ bool in_front(const Params& P, float delta) {
  return delta * P.sign > 0.f;
}

// sigma = sample_scale * bilinear(layer) at the taps.
__device__ __forceinline__ float sigma_at(const float* __restrict__ layer,
                                          int B, const Taps& t, float sscale) {
  const float g00 = __ldg(layer + (size_t)t.a0 * B + t.b0);
  const float g01 = __ldg(layer + (size_t)t.a0 * B + t.b1);
  const float g10 = __ldg(layer + (size_t)t.a1 * B + t.b0);
  const float g11 = __ldg(layer + (size_t)t.a1 * B + t.b1);
  const float bil = (1.f - t.fa) * ((1.f - t.fb) * g00 + t.fb * g01)
                  + t.fa * ((1.f - t.fb) * g10 + t.fb * g11);
  return sscale * bil;
}

// E = exp(-density * sigma * seg); the slice's opacity is alpha = 1 - E.
// expf, not __expf: the plain PyTorch version rounds exp to within an ulp.
__device__ __forceinline__ float extinction(const Params& P, float sigma,
                                            float seg) {
  return expf(-P.density * sigma * seg);
}

// The adjoint of sigma_at without its sample_scale: adds w * du to each of
// the four texels, w its bilinear weight. When clipping puts both taps of
// an axis on one edge texel, both weights land there.
__device__ __forceinline__ void bilinear_adjoint(float* __restrict__ layer,
                                                 int B, const Taps& t,
                                                 float du) {
  const float ra = du * (1.f - t.fa);
  const float rb = du * t.fa;
  atomicAdd(layer + (size_t)t.a0 * B + t.b0, ra * (1.f - t.fb));
  atomicAdd(layer + (size_t)t.a0 * B + t.b1, ra * t.fb);
  atomicAdd(layer + (size_t)t.a1 * B + t.b0, rb * (1.f - t.fb));
  atomicAdd(layer + (size_t)t.a1 * B + t.b1, rb * t.fb);
}

}  // namespace sweep
