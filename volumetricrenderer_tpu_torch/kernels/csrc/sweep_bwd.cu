// Backward slice sweep for Hopper (sm_90a): the adjoint of the
// single-channel sweep of sweep_fwd.cu with respect to the stack.
//
// Replaces the TPU kernel volumetricrenderer_tpu/kernels/sweep_pallas.py
// `_bwd_kernel` / `_run_bwd` (K2), its light-volume branch included. It
// computes K2's function, not its schedule: no chunk checkpoints (tck,
// wck), because one thread replays all S slices of its ray from T = 1; no
// one-hot MXU matrices, no gw/v scratch (nor the light branch's second
// one) and no row windows.
//
// Design. The forward's thread layout: one thread per base pixel (i, j),
// blocks of 32 x 8 threads with j on the fast axis. Each thread replays
// its ray front to back with the carries in registers and adds its share
// of dG for every contributing slice.
//   * Emission, with cw = ct_wsum and bct = ct_trans * trans_S +
//     cw * wsum_S from the forward's outputs: from T = 1 and Wr = 0 (the
//     no-light Wr = 1 - T of K2), per slice
//       E = exp(-density * sigma * seg), alpha = 1 - E,
//       Wr += T * alpha, A~ = bct - cw * Wr,
//       dsigma = density * seg * (cw * T * E - A~),  T *= 1 - alpha.
//     Wr is updated exactly as the forward updates wsum, and sigma and E
//     come from the shared tap math (sweep_common.cuh), so T is the
//     forward's bit for bit and the live gate T > thresh stops the replay
//     at the slice where the forward stopped.
//   * Emission with a light volume (the light branch, a template
//     parameter; a null light pointer launches the kernel without it):
//     shade and lT from sweep::light_shade at the grid's layer and taps,
//       Wr += (T * alpha) * shade, the forward's own product,
//       dsigma = density * seg * (cw * T * shade * E - A~),
//     and the second output dlight: dlT = cw * T * alpha * (1 - ambient) *
//     clip'(lT) through the same four taps (sweep::light_shade_adjoint),
//     four more atomics per live sample.
//   * Absorption: dsigma = ct_acc * seg on every in-box, in-front sample.
//   * The scatter: du = dsigma * sample_scale goes through the bilinear
//     adjoint to the four taps of layer k = S - 1 - s when `flip`, else
//     k = s, so dG leaves the kernel in the stack's own layer order.
//   * Behind-eye and out-of-box samples have no taps and are skipped, as
//     the forward skips them.
// dG and dlight must be zeroed by the caller: the taps are added with
// atomicAdd.
//
// Bound: the atomics. At the flagship (1536^2 base pixels, 256 slices,
// 256^3 grid) a texel of a layer is shared by ~6 x 6 base pixels, so up to
// ~2.4 G float atomics per backward, many on the same address within a
// warp (a warp is one base row: its lanes share a0, a1 and fa). A warp
// pre-reduction of same-texel contributions before the atomics is the
// first step to make it faster, later.
//
// Numerics: dG sums in another order on every run (atomics), so it agrees
// with the plain version to a tolerance, not bit for bit.
//
// Stream modes: the texel type T of `stack` and `light` is a template
// parameter, float or __nv_bfloat16, as in the forward. The replay reads
// the very bfloat16 stacks the forward read and rounds the weights through
// the same sweep::round_weight<T>, so T is still the forward's bit for bit;
// the adjoint scatters with those rounded weights. The cotangents, dsigma
// and both gradients are float32 in either mode.

#include "sweep_common.cuh"

namespace {

template <bool kLight, typename T>
__global__ void __launch_bounds__(256) sweep_bwd_kernel(
    const T* __restrict__ stack, const T* __restrict__ light,
    const float* __restrict__ slice_z,
    const float* __restrict__ v_grid, const float* __restrict__ u_grid,
    const float* __restrict__ seglen, const float* __restrict__ params,
    const float* __restrict__ ct_acc, const float* __restrict__ ct_trans,
    const float* __restrict__ ct_wsum, const float* __restrict__ trans_out,
    const float* __restrict__ wsum_out, float* __restrict__ dstack,
    float* __restrict__ dlight, int S, int A, int B, int Hb, int Wb,
    int emission, int flip, int wrap) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= Hb || j >= Wb) return;

  const sweep::Params P = sweep::load_params(params);
  const float v = v_grid[i];
  const float u = u_grid[j];
  const size_t pix = (size_t)i * Wb + j;
  const float seg = seglen[pix];
  const size_t layer = (size_t)A * B;

  if (emission) {
    const float cw = ct_wsum[pix];
    const float bct = ct_trans[pix] * trans_out[pix] + cw * wsum_out[pix];
    float trans = 1.f, wr = 0.f;
    for (int s = 0; s < S; ++s) {
      if (!(trans > P.thresh)) break;
      const float delta = slice_z[s] - P.e_k;
      if (!sweep::in_front(P, delta)) continue;
      sweep::Taps t;
      if (!sweep::sample_taps(P, delta, v, u, A, B, wrap, t)) continue;
      const int k = flip ? S - 1 - s : s;
      const float sigma = sweep::sigma_at<T>(stack + (size_t)k * layer, B,
                                             t, P.sscale);
      const float e = sweep::extinction(P, sigma, seg);
      const float alpha = 1.f - e;
      float dsigma;
      if constexpr (kLight) {
        float lT;
        const float shade = sweep::light_shade<T>(
            light + (size_t)k * layer, B, t, P.ambient, lT);
        wr += (trans * alpha) * shade;
        const float a_til = bct - cw * wr;
        dsigma = P.density * seg * (cw * trans * shade * e - a_til);
        sweep::light_shade_adjoint<T>(dlight + (size_t)k * layer, B, t,
                                      P.ambient, lT, cw, trans, alpha);
      } else {
        wr += trans * alpha;
        const float a_til = bct - cw * wr;
        dsigma = P.density * seg * (cw * trans * e - a_til);
      }
      trans *= 1.f - alpha;
      sweep::bilinear_adjoint<T>(dstack + (size_t)k * layer, B, t,
                                 dsigma * P.sscale);
    }
  } else {
    const float du = ct_acc[pix] * seg * P.sscale;
    for (int s = 0; s < S; ++s) {
      const float delta = slice_z[s] - P.e_k;
      if (!sweep::in_front(P, delta)) continue;
      sweep::Taps t;
      if (!sweep::sample_taps(P, delta, v, u, A, B, wrap, t)) continue;
      const int k = flip ? S - 1 - s : s;
      sweep::bilinear_adjoint<T>(dstack + (size_t)k * layer, B, t, du);
    }
  }
}

template <typename T>
int launch(const void* stack_v, const void* light_v, const float* slice_z,
           const float* v_grid, const float* u_grid, const float* seglen,
           const float* params, const float* ct_acc, const float* ct_trans,
           const float* ct_wsum, const float* trans_out,
           const float* wsum_out, float* dstack, float* dlight, int S, int A,
           int B, int Hb, int Wb, int emission, int flip, int wrap,
           cudaStream_t st) {
  const T* stack = static_cast<const T*>(stack_v);
  const T* light = static_cast<const T*>(light_v);
  const dim3 block(32, 8);
  const dim3 grid((Wb + block.x - 1) / block.x, (Hb + block.y - 1) / block.y);
  if (light)
    sweep_bwd_kernel<true, T><<<grid, block, 0, st>>>(
        stack, light, slice_z, v_grid, u_grid, seglen, params, ct_acc,
        ct_trans, ct_wsum, trans_out, wsum_out, dstack, dlight, S, A, B, Hb,
        Wb, emission, flip, wrap);
  else
    sweep_bwd_kernel<false, T><<<grid, block, 0, st>>>(
        stack, light, slice_z, v_grid, u_grid, seglen, params, ct_acc,
        ct_trans, ct_wsum, trans_out, wsum_out, dstack, dlight, S, A, B, Hb,
        Wb, emission, flip, wrap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the backward sweep on `stream` and returns cudaGetLastError()
// (0 when the launch was accepted). `elem` is the texel type of `stack` and
// `light`: sweep::kElemF32 or sweep::kElemBF16 (anything else is refused
// with cudaErrorInvalidValue). Emission reads ct_trans, ct_wsum and the
// forward's trans and wsum maps; absorption reads ct_acc. The maps are
// (Hb, Wb) float32; the pointers a mode does not read may be null. `dstack`
// is the zeroed (S, A, B) float32 gradient. `light` is the (S, A, B) light
// stack the forward read and `dlight` its zeroed float32 gradient, or both
// null for no light volume (emission only).
extern "C" int sweep_bwd_launch(const void* stack, const void* light,
                                const float* slice_z, const float* v_grid,
                                const float* u_grid, const float* seglen,
                                const float* params, const float* ct_acc,
                                const float* ct_trans, const float* ct_wsum,
                                const float* trans_out, const float* wsum_out,
                                float* dstack, float* dlight, int S, int A,
                                int B, int Hb, int Wb, int emission, int flip,
                                int wrap, int elem, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem == sweep::kElemF32)
    return launch<float>(stack, light, slice_z, v_grid, u_grid, seglen,
                         params, ct_acc, ct_trans, ct_wsum, trans_out,
                         wsum_out, dstack, dlight, S, A, B, Hb, Wb, emission,
                         flip, wrap, st);
  if (elem == sweep::kElemBF16)
    return launch<__nv_bfloat16>(stack, light, slice_z, v_grid, u_grid,
                                 seglen, params, ct_acc, ct_trans, ct_wsum,
                                 trans_out, wsum_out, dstack, dlight, S, A, B,
                                 Hb, Wb, emission, flip, wrap, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
