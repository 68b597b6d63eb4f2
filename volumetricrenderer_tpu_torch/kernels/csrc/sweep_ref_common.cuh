// Device code shared by the 4-channel reference-combine sweep kernels
// (sweep_ref_fwd.cu, sweep_ref_bwd.cu), on top of sweep_common.cuh.
//
// The reference medium samples four channels, each at its own texture
// coordinate x01 * scale_c + off_c with mirror addressing, and combines
// them as sigma = (r0 * r1) * (r2 + r3) * sample_scale. The backward kernel
// replays the forward's transmittance, so both take the taps, the four
// channel samples and sigma from here, in one evaluation order (see
// sweep_common.cuh on why, and on --fmad=false).
#pragma once

#include "sweep_common.cuh"

namespace sweep {

constexpr int NCH = 4;

// params[8..19]: the channels' coord scales, b offsets and a offsets, after
// the eight of Params.
struct RefParams {
  float sc[NCH], offb[NCH], offa[NCH];
};

__device__ __forceinline__ RefParams load_ref_params(
    const float* __restrict__ p) {
  RefParams r;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    r.sc[c] = p[8 + c];
    r.offb[c] = p[12 + c];
    r.offa[c] = p[16 + c];
  }
  return r;
}

// Mirrored repeat of a texel index: reflection with period 2n. A scrolled
// coordinate can be negative or beyond 2n, and C's % truncates toward zero,
// so a negative remainder is lifted first.
__device__ __forceinline__ int mirror_index(int i, int n) {
  const int period = 2 * n;
  int m = i % period;
  if (m < 0) m += period;
  return m >= n ? period - 1 - m : m;
}

// Texel-center taps along one axis at the channel's texture coordinate
// x01 * sc + off, both indices mirrored. The product and the sum round
// separately, as the plain version's tensor ops do.
__device__ __forceinline__ void mirror_taps(float x01, float sc, float off,
                                            int n, int& i0, int& i1,
                                            float& f) {
  const float q = x01 * sc + off;
  const float p = q * (float)n - 0.5f;
  const float p0 = floorf(p);
  f = p - p0;
  const int i = (int)p0;
  i0 = mirror_index(i, n);
  i1 = mirror_index(i + 1, n);
}

// One in-box sample of the four channels: each channel's taps and its
// bilinear value r[c] (bilinear_at<T>: in the bfloat16 stream mode each
// channel's four weights are rounded on their own, like its texels).
struct RefSample {
  Taps t[NCH];
  float r[NCH];
};

// The sample of base pixel (v, u) on the slice at delta = slice_z - e_k.
// `slab` is L[s], the slice's (NCH, A, B) pre-lerped channel slabs. The box
// test is on the unscaled a01, b01 (it comes from the ray; the mirror
// applies to the texture coordinate only). Returns false outside the box,
// where sigma is 0 and every carry keeps its value.
template <typename T>
__device__ __forceinline__ bool ref_sample(const Params& P, const RefParams& R,
                                           float delta, float v, float u,
                                           const T* __restrict__ slab, int A,
                                           int B, RefSample& out) {
  const float a01 = P.e_a + delta * v;
  const float b01 = P.e_b + delta * u;
  if (!(a01 >= 0.f && a01 <= 1.f && b01 >= 0.f && b01 <= 1.f)) return false;
  const size_t layer = (size_t)A * B;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    Taps& t = out.t[c];
    mirror_taps(a01, R.sc[c], R.offa[c], A, t.a0, t.a1, t.fa);
    mirror_taps(b01, R.sc[c], R.offb[c], B, t.b0, t.b1, t.fb);
    out.r[c] = bilinear_at<T>(slab + c * layer, B, t);
  }
  return true;
}

// sigma = (r0 * r1) * (r2 + r3) * sample_scale.
__device__ __forceinline__ float ref_sigma(const float* r, float sscale) {
  return (r[0] * r[1]) * (r[2] + r[3]) * sscale;
}

}  // namespace sweep
