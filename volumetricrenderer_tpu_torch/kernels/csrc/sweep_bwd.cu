// Backward slice sweep for Hopper (sm_90a): the adjoint of the
// single-channel sweep of sweep_fwd.cu with respect to the stack.
//
// Replaces the TPU kernel volumetricrenderer_tpu/kernels/sweep_pallas.py
// `_bwd_kernel` / `_run_bwd` (K2) without its light-volume branch. It
// computes K2's function, not its schedule: no chunk checkpoints (tck,
// wck), because one thread replays all S slices of its ray from T = 1; no
// one-hot MXU matrices, no gw/v scratch and no row windows.
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
//   * Absorption: dsigma = ct_acc * seg on every in-box, in-front sample.
//   * The scatter: du = dsigma * sample_scale goes through the bilinear
//     adjoint to the four taps of layer k = S - 1 - s when `flip`, else
//     k = s, so dG leaves the kernel in the stack's own layer order.
//   * Behind-eye and out-of-box samples have no taps and are skipped, as
//     the forward skips them.
// dG must be zeroed by the caller: the taps are added with atomicAdd.
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

#include "sweep_common.cuh"

namespace {

__global__ void __launch_bounds__(256) sweep_bwd_kernel(
    const float* __restrict__ stack, const float* __restrict__ slice_z,
    const float* __restrict__ v_grid, const float* __restrict__ u_grid,
    const float* __restrict__ seglen, const float* __restrict__ params,
    const float* __restrict__ ct_acc, const float* __restrict__ ct_trans,
    const float* __restrict__ ct_wsum, const float* __restrict__ trans_out,
    const float* __restrict__ wsum_out, float* __restrict__ dstack, int S,
    int A, int B, int Hb, int Wb, int emission, int flip, int wrap) {
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
      const float sigma = sweep::sigma_at(stack + (size_t)k * layer, B, t,
                                          P.sscale);
      const float e = sweep::extinction(P, sigma, seg);
      const float alpha = 1.f - e;
      wr += trans * alpha;
      const float a_til = bct - cw * wr;
      const float dsigma = P.density * seg * (cw * trans * e - a_til);
      trans *= 1.f - alpha;
      sweep::bilinear_adjoint(dstack + (size_t)k * layer, B, t,
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
      sweep::bilinear_adjoint(dstack + (size_t)k * layer, B, t, du);
    }
  }
}

}  // namespace

// Launches the backward sweep on `stream` and returns cudaGetLastError()
// (0 when the launch was accepted). Emission reads ct_trans, ct_wsum and
// the forward's trans and wsum maps; absorption reads ct_acc. The maps are
// (Hb, Wb); the pointers a mode does not read may be null. `dstack` is the
// zeroed (S, A, B) gradient.
extern "C" int sweep_bwd_launch(const float* stack, const float* slice_z,
                                const float* v_grid, const float* u_grid,
                                const float* seglen, const float* params,
                                const float* ct_acc, const float* ct_trans,
                                const float* ct_wsum, const float* trans_out,
                                const float* wsum_out, float* dstack, int S,
                                int A, int B, int Hb, int Wb, int emission,
                                int flip, int wrap, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((Wb + block.x - 1) / block.x, (Hb + block.y - 1) / block.y);
  sweep_bwd_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      stack, slice_z, v_grid, u_grid, seglen, params, ct_acc, ct_trans,
      ct_wsum, trans_out, wsum_out, dstack, S, A, B, Hb, Wb, emission, flip,
      wrap);
  return static_cast<int>(cudaGetLastError());
}
