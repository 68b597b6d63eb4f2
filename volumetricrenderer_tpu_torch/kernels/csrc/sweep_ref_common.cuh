// Device code shared by the 4-channel reference-combine sweep kernels
// (sweep_ref_fwd.cu, sweep_ref_bwd.cu), on top of sweep_common.cuh.
//
// The reference medium samples four channels, each at its own texture
// coordinate x01 * scale_c + off_c with mirror addressing, and combines
// them as sigma = (r0 * r1) * (r2 + r3) * sample_scale. The backward kernel
// replays the forward's transmittance, so both take the taps and sigma
// from here (and the tiled schedule from sweep_ref_tile.cuh), in one
// evaluation order (see sweep_common.cuh on why, and on --fmad=false).
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
// coordinate can be negative or beyond 2n. The first fold on either side
// is taken without a division; beyond it C's % truncates toward zero, so a
// negative remainder is lifted first. Every branch gives the reflection.
__device__ __forceinline__ int mirror_index(int i, int n) {
  if (i >= 0 && i < n) return i;
  if (i < 0 && i >= -n) return -1 - i;
  if (i >= n && i < 2 * n) return 2 * n - 1 - i;
  const int period = 2 * n;
  int m = i % period;
  if (m < 0) m += period;
  return m >= n ? period - 1 - m : m;
}

// The texel-center tap along one axis at the channel's texture coordinate
// x01 * sc + off, before the mirror: t = floor(p), p = q * n - 0.5, and
// the fraction f = p - t. The product and the sum round separately, as the
// plain version's tensor ops do. The one place of this expression: the
// windows' bounds and the lines' taps both take it from here, so a tap
// lies in its window (for sc >= 0 and sc < 0 alike: the map from x01 to t
// keeps or reverses order under float32 rounding) and the samples are the
// per-pixel kernels' bit for bit.
__device__ __forceinline__ int chan_tap(float x01, float sc, float off,
                                        int n, float& f) {
  const float q = x01 * sc + off;
  const float p = q * (float)n - 0.5f;
  const float p0 = floorf(p);
  f = p - p0;
  return (int)p0;
}

// sigma = (r0 * r1) * (r2 + r3) * sample_scale.
__device__ __forceinline__ float ref_sigma(const float* r, float sscale) {
  return (r[0] * r[1]) * (r[2] + r[3]) * sscale;
}

}  // namespace sweep
