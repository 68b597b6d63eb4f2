// Forward slice sweep for Hopper (sm_90a): the single-channel
// emission-absorption march over volume slices, front to back.
//
// Replaces the TPU kernels volumetricrenderer_tpu/kernels/sweep_pallas.py
// `_fwd_kernel_sc` (sc-major "assoc" form) and `_fwd_kernel` (rb-major
// form). Both compute one function; this kernel computes that function,
// not their schedule: no one-hot MXU matrices, no row-offset granules and
// no precomputed (S, Hb, A) row-tap tensor (403 MB at the flagship). The
// taps are computed in the kernel from the plan vectors.
//
// Design. One thread per base pixel (i, j); blocks of 32 x 8 threads with
// j on the fast axis, so a warp's taps fall on neighbouring grid columns.
// Each thread loops over the S slices in front-to-back order and keeps
// (acc, T, wsum, hit) in registers; the four maps are written once at the
// end. Per slice s, with delta = slice_z[s] - e_k:
//   * slices with delta * sign <= 0 lie behind the eye and are skipped;
//   * a01 = e_a + delta * v[i], b01 = e_b + delta * u[j]; outside [0, 1]^2
//     sigma is 0, which leaves every carry unchanged, so the taps are
//     skipped too;
//   * taps p = x01 * N - 0.5, i0 = floor(p), f = p - i0; mirror and clamp
//     clip i0, i0 + 1 to [0, N - 1] (they agree texel for texel inside the
//     box), wrap takes them modulo N;
//   * sigma = sscale * bilinear(G[k]) with k = S - 1 - s when `flip` (the
//     grid keeps its layer order and is read mirrored) and k = s otherwise;
//   * emission: alpha = 1 - exp(-density * sigma * seg), wsum += T * alpha,
//     T *= 1 - alpha. Once T <= thresh the live gate zeroes alpha for every
//     later slice, so the thread stops there with the same result;
//   * emission with a light volume (the kernels' light branch): the light
//     stack has the grid's layout and is read at the same layer k and the
//     same taps; lT is its bilinear sample, shade = ambient + (1 - ambient)
//     * clip(lT, 0, 1) and wsum += (T * alpha) * shade
//     (sweep::light_shade). The TPU kernels' second row matmul and column
//     stage for the light volume are not carried over. The branch is a
//     template parameter: a null light pointer launches the instantiation
//     without it, which is the kernel as it was;
//   * absorption: acc += sigma * seg, hit = 1.
// `flip` and the lerped sub-voxel stack (n_slices != depth) are decided by
// the wrapper: it passes the stack already in slice order with flip = 0.
//
// Grid layout: `stack` is a contiguous (S, A, B) tensor, the grid permuted
// so the sweep axis is dim 0 (the wrapper makes the copy when the
// permutation is not the identity).
//
// Stream modes: the texel type T of `stack` and `light` is a template
// parameter, float or __nv_bfloat16 (the TPU kernels' `low` mode: G, the
// light stack and the tap weights in bfloat16, everything else float32; see
// sweep_common.cuh). The float instantiations are the float32 kernels as
// they were. In bfloat16 the flagship's 256^3 stack is 34 MB and fits the
// 50 MB L2.
//
// Bound: about 4 * S * Hb * Wb scattered 4-byte tap reads per frame (2.4 G
// at 256 slices on a 1536^2 base grid) from a 67 MB volume, which exceeds
// the 50 MB L2; neighbouring threads share most taps, so the reads hit L1
// and L2 more than device memory. Making it fast (shared-memory tap
// windows per block and slice, TMA) is later work.
//
// Numerics: expf, not __expf, and the build passes --fmad=false, so every
// product and sum is rounded as the plain PyTorch version rounds it. The
// tap math lives in sweep_common.cuh, shared with the backward kernel
// (sweep_bwd.cu), whose replay of the transmittance must reproduce this
// kernel's bit for bit.

#include "sweep_common.cuh"

namespace {

template <bool kLight, typename T>
__global__ void __launch_bounds__(256) sweep_fwd_kernel(
    const T* __restrict__ stack, const T* __restrict__ light,
    const float* __restrict__ slice_z,
    const float* __restrict__ v_grid, const float* __restrict__ u_grid,
    const float* __restrict__ seglen, const float* __restrict__ params,
    float* __restrict__ out, int S, int A, int B, int Hb, int Wb,
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

  float acc = 0.f, trans = 1.f, wsum = 0.f, hit = 0.f;
  for (int s = 0; s < S; ++s) {
    if (emission && !(trans > P.thresh)) break;
    const float delta = slice_z[s] - P.e_k;
    if (!sweep::in_front(P, delta)) continue;
    sweep::Taps t;
    if (!sweep::sample_taps(P, delta, v, u, A, B, wrap, t)) continue;
    const int k = flip ? S - 1 - s : s;
    const float sigma = sweep::sigma_at<T>(stack + (size_t)k * layer, B, t,
                                           P.sscale);
    if (emission) {
      const float alpha = 1.f - sweep::extinction(P, sigma, seg);
      if constexpr (kLight) {
        float lT;
        const float shade = sweep::light_shade<T>(
            light + (size_t)k * layer, B, t, P.ambient, lT);
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
int launch(const void* stack_v, const void* light_v, const float* slice_z,
           const float* v_grid, const float* u_grid, const float* seglen,
           const float* params, float* out, int S, int A, int B, int Hb,
           int Wb, int emission, int flip, int wrap, cudaStream_t st) {
  const T* stack = static_cast<const T*>(stack_v);
  const T* light = static_cast<const T*>(light_v);
  const dim3 block(32, 8);
  const dim3 grid((Wb + block.x - 1) / block.x, (Hb + block.y - 1) / block.y);
  if (light)
    sweep_fwd_kernel<true, T><<<grid, block, 0, st>>>(
        stack, light, slice_z, v_grid, u_grid, seglen, params, out, S, A, B,
        Hb, Wb, emission, flip, wrap);
  else
    sweep_fwd_kernel<false, T><<<grid, block, 0, st>>>(
        stack, light, slice_z, v_grid, u_grid, seglen, params, out, S, A, B,
        Hb, Wb, emission, flip, wrap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the sweep on `stream` and returns cudaGetLastError() (0 when the
// launch was accepted). `elem` is the texel type of `stack` and `light`:
// sweep::kElemF32 or sweep::kElemBF16 (anything else is refused with
// cudaErrorInvalidValue). `light` is the (S, A, B) light-transmittance
// stack in the stack's layer order and type, or null for no light volume
// (emission only). `out` is (4, Hb, Wb) float32: acc, trans, wsum, hit.
extern "C" int sweep_fwd_launch(const void* stack, const void* light,
                                const float* slice_z, const float* v_grid,
                                const float* u_grid, const float* seglen,
                                const float* params, float* out, int S, int A,
                                int B, int Hb, int Wb, int emission, int flip,
                                int wrap, int elem, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem == sweep::kElemF32)
    return launch<float>(stack, light, slice_z, v_grid, u_grid, seglen,
                         params, out, S, A, B, Hb, Wb, emission, flip, wrap,
                         st);
  if (elem == sweep::kElemBF16)
    return launch<__nv_bfloat16>(stack, light, slice_z, v_grid, u_grid,
                                 seglen, params, out, S, A, B, Hb, Wb,
                                 emission, flip, wrap, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
