// Device code shared by the slice-sweep kernels (sweep_fwd.cu, sweep_bwd.cu
// through sweep_tile.cuh, and through sweep_ref_common.cuh the 4-channel
// sweep_ref_fwd.cu and sweep_ref_bwd.cu).
//
// The backward kernel replays the forward's transmittance slice by slice,
// and the early-stop gate T > thresh decides which slices contribute. A
// replay that rounds one product differently can flip that gate at another
// slice than the forward did, which changes the gradient by more than a
// rounding error. So both kernels take the tap coordinates, the texel
// indices, the bilinear sum, sigma and the extinction factor from these
// functions, with the same evaluation order, and the build passes
// --fmad=false (kernels/build.py) so no product is fused into an add.
//
// The texel type T is a template parameter of everything that reads a
// volume: float, or __nv_bfloat16 for the bfloat16 stream mode. In that mode
// the stacks hold bfloat16 texels (2-byte reads, widened exactly) and each
// of the four bilinear weights 1 - fa, fa, 1 - fb, fb is rounded to bfloat16
// on its own (round_weight); products, sums, the carries, expf, the gate and
// every gradient stay float32. The adjoints scatter with the rounded
// weights the forward sampled with. With T = float round_weight is the
// identity and the functions are the float32 kernels' as they were.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace sweep {

// Element type codes of the C launchers' `elem` argument.
constexpr int kElemF32 = 0;
constexpr int kElemBF16 = 1;

// One texel, widened to float. A bfloat16 is the upper 16 bits of the
// float32 of the same value, so the widening is a shift.
__device__ __forceinline__ float load_texel(const float* __restrict__ p) {
  return __ldg(p);
}

__device__ __forceinline__ float load_texel(
    const __nv_bfloat16* __restrict__ p) {
  const unsigned short bits =
      __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned int>(bits) << 16);
}

// A bilinear weight as the stream mode of texel type T holds it: unchanged
// for float, rounded to the nearest bfloat16 (ties to even) for bfloat16.
template <typename T>
__device__ __forceinline__ float round_weight(float w) {
  return w;
}

template <>
__device__ __forceinline__ float round_weight<__nv_bfloat16>(float w) {
  return __bfloat162float(__float2bfloat16_rn(w));
}

// params (8,) float32: e_k, e_a, e_b, sign, density, sample_scale,
// early-stop transmittance, ambient (read only by the light branch).
struct Params {
  float e_k, e_a, e_b, sign, density, sscale, thresh, ambient;
};

__device__ __forceinline__ Params load_params(const float* __restrict__ p) {
  return Params{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7]};
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

// The bilinear sample of an (A, B) layer of texel type T at the taps: the
// four-tap sum in float32, with the weights as round_weight<T> holds them.
template <typename T>
__device__ __forceinline__ float bilinear_at(const T* __restrict__ layer,
                                             int B, const Taps& t) {
  const float g00 = load_texel(layer + (size_t)t.a0 * B + t.b0);
  const float g01 = load_texel(layer + (size_t)t.a0 * B + t.b1);
  const float g10 = load_texel(layer + (size_t)t.a1 * B + t.b0);
  const float g11 = load_texel(layer + (size_t)t.a1 * B + t.b1);
  return round_weight<T>(1.f - t.fa)
             * (round_weight<T>(1.f - t.fb) * g00
                + round_weight<T>(t.fb) * g01)
       + round_weight<T>(t.fa)
             * (round_weight<T>(1.f - t.fb) * g10
                + round_weight<T>(t.fb) * g11);
}

// E = exp(-density * sigma * seg); the slice's opacity is alpha = 1 - E.
// expf, not __expf: the plain PyTorch version rounds exp to within an ulp.
__device__ __forceinline__ float extinction(const Params& P, float sigma,
                                            float seg) {
  return expf(-P.density * sigma * seg);
}

// The adjoint of sigma_at<T> without its sample_scale: adds w * du to each
// of the four texels of the float32 gradient layer, w the bilinear weight
// bilinear_at<T> sampled with (so rounded like it). When clipping puts both
// taps of an axis on one edge texel, both weights land there.
template <typename T>
__device__ __forceinline__ void bilinear_adjoint(float* __restrict__ layer,
                                                 int B, const Taps& t,
                                                 float du) {
  const float ra = du * round_weight<T>(1.f - t.fa);
  const float rb = du * round_weight<T>(t.fa);
  const float wb0 = round_weight<T>(1.f - t.fb);
  const float wb1 = round_weight<T>(t.fb);
  atomicAdd(layer + (size_t)t.a0 * B + t.b0, ra * wb0);
  atomicAdd(layer + (size_t)t.a0 * B + t.b1, ra * wb1);
  atomicAdd(layer + (size_t)t.a1 * B + t.b0, rb * wb0);
  atomicAdd(layer + (size_t)t.a1 * B + t.b1, rb * wb1);
}

// The light branch of all four sweep kernels. `light_layer` is the (A, B)
// layer of the light-transmittance stack that belongs to the sample's slice,
// `t` the sample's taps on it. Returns shade = ambient + (1 - ambient) *
// clip(lT, 0, 1) and keeps lT, the bilinear sample, for the adjoint. The
// forward kernels add (T * alpha) * shade to wsum and the backward kernels
// replay exactly that product, so both take the shade from here.
template <typename T>
__device__ __forceinline__ float light_shade(
    const T* __restrict__ light_layer, int B, const Taps& t, float ambient,
    float& lT) {
  lT = bilinear_at<T>(light_layer, B, t);
  return ambient + (1.f - ambient) * fminf(fmaxf(lT, 0.f), 1.f);
}

// The adjoint of light_shade: dlT = cw * T * alpha * (1 - ambient) * clip',
// added to the four taps of `dlight_layer`. clip' is the subgradient of
// minimum(maximum(x, 0), 1): 1 inside (0, 1), 0.5 at lT == 0 and lT == 1
// (a fully lit voxel has lT == 1 exactly, so ties are common), 0 outside.
// It is decided on the lT that light_shade clipped. With bfloat16 weights
// the four weights of a sample sum to 1 only to within 2^-8, so a fully lit
// neighbourhood samples lT just above or just below 1, sample by sample:
// that is the function in that mode, and forward and backward decide it on
// the same float. T is the light stack's texel type.
template <typename T>
__device__ __forceinline__ void light_shade_adjoint(
    float* __restrict__ dlight_layer, int B, const Taps& t, float ambient,
    float lT, float cw, float trans, float alpha) {
  const float clip_g = (lT > 0.f && lT < 1.f)
                           ? 1.f
                           : ((lT == 0.f || lT == 1.f) ? 0.5f : 0.f);
  const float dlT = cw * trans * alpha * (1.f - ambient) * clip_g;
  bilinear_adjoint<T>(dlight_layer, B, t, dlT);
}

}  // namespace sweep
