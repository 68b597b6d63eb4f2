// Backward slice sweep of the 4-channel reference medium for Hopper
// (sm_90a): the adjoint of sweep_ref_fwd.cu with respect to the pre-lerped
// channel slabs L.
//
// Replaces the TPU kernel volumetricrenderer_tpu/kernels/sweep_pallas.py
// `_bwd_kernel_ref` / `_run_bwd_ref`, its light-volume branch included. It
// computes that kernel's function, not its schedule: no chunk checkpoints
// (one thread replays all S slices of its ray from T = 1), no one-hot
// scatter matrices on the MXU and no per-(slice, channel) scratch.
//
// Design. The forward's thread layout: one thread per base pixel (i, j),
// blocks of 32 x 8 threads with j on the fast axis. Each thread replays its
// ray front to back with the carries in registers and adds its share of dL
// for every contributing slice.
//   * Emission, with cw = ct_wsum and bct = ct_trans * trans_S +
//     cw * wsum_S from the forward's outputs: from T = 1 and Wr = 0, per
//     slice
//       E = exp(-density * sigma * seg), alpha = 1 - E,
//       Wr += T * alpha, A~ = bct - cw * Wr,
//       dsigma = density * seg * (cw * T * E - A~),  T *= 1 - alpha.
//     The four channel samples, sigma and E come from the device functions
//     the forward uses (sweep_ref_common.cuh), and Wr is updated exactly as
//     the forward updates wsum, so T is the forward's bit for bit and the
//     live gate T > thresh stops the replay at the slice where the forward
//     stopped.
//   * Emission with light slabs (the light branch, a template parameter; a
//     null light pointer launches the kernel without it): shade and lT from
//     sweep::light_shade on slab s at the unscaled, clipped taps, as in the
//     forward; Wr += (T * alpha) * shade, dsigma = density * seg *
//     (cw * T * shade * E - A~), and the second output dlight through those
//     taps (sweep::light_shade_adjoint), four more atomics per live sample.
//   * Absorption: dsigma = ct_acc * seg on every in-box, in-front sample.
//   * The product rule of sigma = (r0 * r1) * (r2 + r3) * sample_scale,
//     with d = dsigma * sample_scale:
//       dr0 = d * r1 * (r2 + r3), dr1 = d * r0 * (r2 + r3),
//       dr2 = dr3 = d * r0 * r1.
//   * The scatter: each dr_c goes through the bilinear adjoint to the four
//     mirrored taps of L[s, c]: 16 float atomics per live sample. Where the
//     mirror puts both taps of an axis on one texel, both weights land
//     there.
// dL and dlight must be zeroed by the caller: the taps are added with
// atomicAdd.
//
// Bound: the 16 atomics per live sample, four times the single-channel
// backward's, spread over four slabs; and the forward's 16 tap reads for
// the replay.
//
// Numerics: dL sums in another order on every run (atomics), so it agrees
// with the plain version to a tolerance, not bit for bit.
//
// Stream modes: the texel type T of `L` and of the light slabs is a
// template parameter, float or __nv_bfloat16, as in the forward. The replay
// reads the very bfloat16 slabs the forward read and every channel's
// weights go through the same sweep::round_weight<T>, forward, replay and
// scatter alike. The cotangents, dsigma, dL and dlight are float32 in
// either mode (the TPU kernel's wrapper rounds dL to bfloat16; this port
// does not).

#include "sweep_ref_common.cuh"

namespace {

// Adds the four channels' shares of d = dsigma * sample_scale to dL[s].
template <typename T>
__device__ __forceinline__ void scatter_channels(float* __restrict__ dslab,
                                                 int A, int B,
                                                 const sweep::RefSample& smp,
                                                 float d) {
  const float* r = smp.r;
  const float s34 = r[2] + r[3];
  const float r01 = r[0] * r[1];
  const float dr[sweep::NCH] = {d * r[1] * s34, d * r[0] * s34, d * r01,
                                d * r01};
  const size_t layer = (size_t)A * B;
#pragma unroll
  for (int c = 0; c < sweep::NCH; ++c)
    sweep::bilinear_adjoint<T>(dslab + c * layer, B, smp.t[c], dr[c]);
}

template <bool kLight, typename T>
__global__ void __launch_bounds__(256) sweep_ref_bwd_kernel(
    const T* __restrict__ L, const T* __restrict__ light,
    const float* __restrict__ slice_z,
    const float* __restrict__ v_grid, const float* __restrict__ u_grid,
    const float* __restrict__ seglen, const float* __restrict__ params,
    const float* __restrict__ ct_acc, const float* __restrict__ ct_trans,
    const float* __restrict__ ct_wsum, const float* __restrict__ trans_out,
    const float* __restrict__ wsum_out, float* __restrict__ dL,
    float* __restrict__ dlight, int S, int A, int B, int Hb, int Wb,
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

  if (emission) {
    const float cw = ct_wsum[pix];
    const float bct = ct_trans[pix] * trans_out[pix] + cw * wsum_out[pix];
    float trans = 1.f, wr = 0.f;
    for (int s = 0; s < S; ++s) {
      if (!(trans > P.thresh)) break;
      const float delta = slice_z[s] - P.e_k;
      if (!sweep::in_front(P, delta)) continue;
      sweep::RefSample smp;
      if (!sweep::ref_sample<T>(P, R, delta, v, u, L + (size_t)s * slab, A,
                                B, smp))
        continue;
      const float sigma = sweep::ref_sigma(smp.r, P.sscale);
      const float e = sweep::extinction(P, sigma, seg);
      const float alpha = 1.f - e;
      float dsigma;
      if constexpr (kLight) {
        sweep::Taps tl;
        sweep::sample_taps(P, delta, v, u, A, B, 0, tl);
        const size_t lslab = (size_t)s * A * B;
        float lT;
        const float shade = sweep::light_shade<T>(light + lslab, B, tl,
                                                  P.ambient, lT);
        wr += (trans * alpha) * shade;
        const float a_til = bct - cw * wr;
        dsigma = P.density * seg * (cw * trans * shade * e - a_til);
        sweep::light_shade_adjoint<T>(dlight + lslab, B, tl, P.ambient, lT,
                                      cw, trans, alpha);
      } else {
        wr += trans * alpha;
        const float a_til = bct - cw * wr;
        dsigma = P.density * seg * (cw * trans * e - a_til);
      }
      trans *= 1.f - alpha;
      scatter_channels<T>(dL + (size_t)s * slab, A, B, smp,
                          dsigma * P.sscale);
    }
  } else {
    const float d = ct_acc[pix] * seg * P.sscale;
    for (int s = 0; s < S; ++s) {
      const float delta = slice_z[s] - P.e_k;
      if (!sweep::in_front(P, delta)) continue;
      sweep::RefSample smp;
      if (!sweep::ref_sample<T>(P, R, delta, v, u, L + (size_t)s * slab, A,
                                B, smp))
        continue;
      scatter_channels<T>(dL + (size_t)s * slab, A, B, smp, d);
    }
  }
}

template <typename T>
int launch(const void* L_v, const void* light_v, const float* slice_z,
           const float* v_grid, const float* u_grid, const float* seglen,
           const float* params, const float* ct_acc, const float* ct_trans,
           const float* ct_wsum, const float* trans_out,
           const float* wsum_out, float* dL, float* dlight, int S, int A,
           int B, int Hb, int Wb, int emission, cudaStream_t st) {
  const T* L = static_cast<const T*>(L_v);
  const T* light = static_cast<const T*>(light_v);
  const dim3 block(32, 8);
  const dim3 grid((Wb + block.x - 1) / block.x, (Hb + block.y - 1) / block.y);
  if (light)
    sweep_ref_bwd_kernel<true, T><<<grid, block, 0, st>>>(
        L, light, slice_z, v_grid, u_grid, seglen, params, ct_acc, ct_trans,
        ct_wsum, trans_out, wsum_out, dL, dlight, S, A, B, Hb, Wb, emission);
  else
    sweep_ref_bwd_kernel<false, T><<<grid, block, 0, st>>>(
        L, light, slice_z, v_grid, u_grid, seglen, params, ct_acc, ct_trans,
        ct_wsum, trans_out, wsum_out, dL, dlight, S, A, B, Hb, Wb, emission);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the backward sweep on `stream` and returns cudaGetLastError()
// (0 when the launch was accepted). `elem` is the texel type of `L` and
// `light`: sweep::kElemF32 or sweep::kElemBF16 (anything else is refused
// with cudaErrorInvalidValue). Emission reads ct_trans, ct_wsum and the
// forward's trans and wsum maps; absorption reads ct_acc. The maps are
// (Hb, Wb) float32; the pointers a mode does not read may be null. `dL` is
// the zeroed (S, 4, A, B) float32 gradient. `light` is the (S, A, B) light
// slabs the forward read and `dlight` their zeroed float32 gradient, or
// both null for no light volume (emission only).
extern "C" int sweep_ref_bwd_launch(
    const void* L, const void* light, const float* slice_z,
    const float* v_grid, const float* u_grid, const float* seglen,
    const float* params, const float* ct_acc, const float* ct_trans,
    const float* ct_wsum, const float* trans_out, const float* wsum_out,
    float* dL, float* dlight, int S, int A, int B, int Hb, int Wb,
    int emission, int elem, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem == sweep::kElemF32)
    return launch<float>(L, light, slice_z, v_grid, u_grid, seglen, params,
                         ct_acc, ct_trans, ct_wsum, trans_out, wsum_out, dL,
                         dlight, S, A, B, Hb, Wb, emission, st);
  if (elem == sweep::kElemBF16)
    return launch<__nv_bfloat16>(L, light, slice_z, v_grid, u_grid, seglen,
                                 params, ct_acc, ct_trans, ct_wsum, trans_out,
                                 wsum_out, dL, dlight, S, A, B, Hb, Wb,
                                 emission, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
