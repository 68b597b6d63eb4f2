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
// The function, per base pixel (i, j) and slice s in front-to-back order,
// with delta = slice_z[s] - e_k:
//   * slices with delta * sign <= 0 lie behind the eye and are skipped;
//   * a01 = e_a + delta * v[i], b01 = e_b + delta * u[j]; outside [0, 1]^2
//     (the unscaled coordinates: the box test is the ray's) sigma is 0 and
//     the taps are skipped;
//   * per channel c: taps at a01 * sc_c + offa_c and b01 * sc_c + offb_c,
//     p = x * N - 0.5, i0 = floor(p), f = p - i0, both indices reflected
//     with period 2N (a scrolled coordinate leaves [0, 1], so the mirror is
//     a true reflection, not the clip of the single-channel kernel); four
//     texels of L[s, c] and a bilinear sum;
//   * sigma = (r0 * r1) * (r2 + r3) * sample_scale;
//   * emission: alpha = 1 - exp(-density * sigma * seg), wsum += T * alpha,
//     T *= 1 - alpha, stopping once T <= thresh as the live gate would;
//   * emission with a light volume (the light branch, a template
//     parameter; a null light pointer launches the kernel without it): the
//     light slabs (S, A, B) are pre-lerped onto the slice planes by the
//     wrapper, so slab s belongs to slice s; the light is not a scrolled
//     noise channel, so its taps are the unscaled a01, b01 with clipping,
//     shade and wsum += (T * alpha) * shade as in the single-channel
//     kernel;
//   * absorption: acc += sigma * seg, hit = 1 (hit does not depend on the
//     channels).
// L is built by the wrapper in slice_z order (the sweep-axis lerp of each
// channel at its own scaled and scrolled depth), so there is no flip here.
//
// What bounds it on this card. The function needs 48 float operations per
// in-box sample and 30 per in-box row and column of a slice (1.74 GFLOP at
// the reference preset, 1024^2 base, 128 slices: 0.026 ms at 67 TFLOP/s),
// and reads each texel once. The first design, one thread per base pixel
// (PR 3), ran at 0.95 ms on an NVIDIA H100 80GB HBM3 at 700 W: every sample
// recomputed eight channel taps with their mirrors and issued 16 scattered
// loads on four slabs. This design runs the same work in 0.53-0.57 ms on
// that card (1.7x its parent in turns; 0.65 against 1.06 with light, 1.85
// against 4.0 at 256^3 x 4 / 1080p; PERF.md §6).
// What is left: per tile-slice the taps of 256 lines, the window copies
// and two barriers, and per sample four bilinear sums, sixteen reads from
// shared memory.
//
// Design (sweep_ref_tile.cuh, on sweep_tile.cuh's schedule). One CTA of 256
// threads per 32 x 32 base tile, a thread holding the carries of 4 pixels
// of its column; the tile walks its active slices together. Per slice, one
// thread per (channel, row) and per (channel, column) computes the line's
// channel taps and rounded weights into shared memory, and each channel's
// tap window (unmirrored, slot m holding texel mirror(lo + m)) and the
// light's are copied with cp.async one active slice ahead, so a sample is
// sixteen shared-memory reads (twenty with light) and the float32
// arithmetic, no mirror inside the loop. __syncthreads_or ends the walk
// when no pixel of the tile is live. A tile-slice whose windows exceed the
// stage the host sized reads global memory at the same taps, and is
// counted.
//
// Layout: `L` is a contiguous (S, 4, A, B) tensor.
//
// Stream modes: the texel type T of `L` and of the light slabs is a
// template parameter, float or __nv_bfloat16 (the TPU kernel's bfloat16
// streams: the slabs and every channel's tap weights in bfloat16, everything
// else float32; see sweep_common.cuh). bfloat16 slots are widened in place
// in shared memory.
//
// Numerics: expf, --fmad=false, and every tap (chan_tap) and sigma from
// sweep_ref_common.cuh, with the four texels of a sample summed in
// bilinear_at's order: this kernel's maps equal the per-pixel kernel's bit
// for bit, and the backward kernel (sweep_ref_bwd.cu) replays its
// transmittance bit for bit.

#include "sweep_ref_tile.cuh"

namespace {

namespace tl = sweep::tile;
namespace rt = sweep::tile::ref;

// 3 CTAs an SM (85 registers); the light instantiations read their column
// lines from shared memory rather than hold them, which keeps them
// spill-free there.
template <bool kLight, typename T>
__global__ void __launch_bounds__(tl::kThreads, 3) sweep_ref_fwd_kernel(
    const T* __restrict__ L, const T* __restrict__ light,
    const float* __restrict__ slice_z,
    const float* __restrict__ v_grid, const float* __restrict__ u_grid,
    const float* __restrict__ seglen, const float* __restrict__ params,
    float* __restrict__ out, int S, int A, int B, int Hb, int Wb,
    int emission, int cap, unsigned long long* __restrict__ counts) {
  constexpr int NW = rt::kWindows<kLight>;
  constexpr int NCH = sweep::NCH;
  // The window table (NW * S entries), then [buffer][window][cap].
  extern __shared__ int4 smem[];
  __shared__ tl::Line rows_l[NW * tl::kRows], cols_l[NW * tl::kCols];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * tl::kCols + tx;
  const sweep::Params P = sweep::load_params(params);
  const size_t layer = (size_t)A * B;
  int4* const tab = smem;
  float* const stage = reinterpret_cast<float*>(smem + NW * S);
  rt::fill_windows<NW>(tab, P, sweep::load_ref_params(params), slice_z,
                       v_grid, u_grid, S, A, B, Hb, Wb, tid);

  // Per pixel p (row tile_row0 + ty + 8p, column j): emission carries
  // (T, wsum) or absorption's (acc, hit) in (c0, c1).
  const int j = tl::tile_col0() + tx;
  const int rows_left = j < Wb ? Hb - tl::tile_row0() - ty : 0;
  float seg[tl::kPix], c0[tl::kPix], c1[tl::kPix];
#pragma unroll
  for (int p = 0; p < tl::kPix; ++p) {
    const bool ok = tl::kGroups * p < rows_left;
    seg[p] = ok ? seglen[(size_t)(tl::tile_row0() + ty + tl::kGroups * p) *
                             Wb + j]
                : 0.f;
    c0[p] = emission ? 1.f : 0.f;
    c1[p] = 0.f;
  }
  __syncthreads();  // the window table

  const auto win = [&](int bb, int w) {
    return stage + (bb * NW + w) * cap;
  };
  // The bfloat16 halves of the staged slots of slice s and of the next.
  unsigned long long half = 0ull, half_next = 0ull;
  unsigned long long n_done = 0, n_global = 0;
  int s = rt::next_active(tab, NW, 0, S);
  if (s < S && rt::staged_at<NW>(tab, s, cap))
    rt::stage_windows<NW>(win(0, 0), cap, tab, s, L, light, A, B, tid,
                          half);
  tl::copy_commit();
  int b = 0;
  while (s < S) {
    const int sn = rt::next_active(tab, NW, s + 1, S);
    if (sn < S && rt::staged_at<NW>(tab, sn, cap))
      rt::stage_windows<NW>(win(b ^ 1, 0), cap, tab, sn, L, light, A, B,
                            tid, half_next);
    tl::copy_commit();
    const bool staged = rt::staged_at<NW>(tab, s, cap);
    const float delta = __int_as_float(tab[s * NW].w);
    rt::make_lines<kLight, T>(rows_l, cols_l, nullptr, P, params, tab, s,
                              staged, delta, v_grid, u_grid, A, B, Hb, Wb);
    tl::copy_wait_prior();
    if (staged)
      rt::widen_windows<NW, T>(win(b, 0), cap, tab, s, A, B, tid, half);
    __syncthreads();

    tl::Line col[kLight ? 1 : NCH];
    if constexpr (!kLight) {
#pragma unroll
      for (int c = 0; c < NCH; ++c) col[c] = cols_l[c * tl::kCols + tx];
    }
    const auto colw = [&](int c) {
      return kLight ? cols_l[c * tl::kCols + tx] : col[kLight ? 0 : c];
    };
    const T* const g_slab = L + (size_t)s * NCH * layer;
    bool live = false;
#pragma unroll
    for (int p = 0; p < tl::kPix; ++p) {
      if (!(tl::kGroups * p < rows_left)) continue;
      if (emission && !(c0[p] > P.thresh)) continue;
      const int rr = ty + tl::kGroups * p;
      if (colw(0).o0 >= 0 && rows_l[rr].o0 >= 0) {
        float r[NCH];
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          const tl::Line row = rows_l[c * tl::kRows + rr];
          r[c] = staged ? tl::tap_sum<true, T>(win(b, c), row, colw(c))
                        : tl::tap_sum<false, T>(g_slab + c * layer, row,
                                                colw(c));
        }
        const float sigma = sweep::ref_sigma(r, P.sscale);
        if (emission) {
          const float alpha = 1.f - sweep::extinction(P, sigma, seg[p]);
          if constexpr (kLight) {
            const tl::Line row = rows_l[rt::kLightWin * tl::kRows + rr];
            const tl::Line lc = cols_l[rt::kLightWin * tl::kCols + tx];
            const float lT =
                staged ? tl::tap_sum<true, T>(win(b, rt::kLightWin), row, lc)
                       : tl::tap_sum<false, T>(light + (size_t)s * layer,
                                               row, lc);
            c1[p] += (c0[p] * alpha) * tl::shade_of(lT, P.ambient);
          } else {
            c1[p] += c0[p] * alpha;
          }
          c0[p] *= 1.f - alpha;
        } else {
          c0[p] += sigma * seg[p];
          c1[p] = 1.f;
        }
      }
      live = live || !emission || c0[p] > P.thresh;
    }
    ++n_done;
    if (!staged) ++n_global;
    if (!__syncthreads_or(live)) break;
    s = sn;
    b ^= 1;
    half = half_next;
  }
  tl::copy_wait_all();

  const size_t plane = (size_t)Hb * Wb;
#pragma unroll
  for (int p = 0; p < tl::kPix; ++p) {
    if (!(tl::kGroups * p < rows_left)) continue;
    const size_t pix =
        (size_t)(tl::tile_row0() + ty + tl::kGroups * p) * Wb + j;
    out[pix] = emission ? 0.f : c0[p];
    out[plane + pix] = emission ? c0[p] : 1.f;
    out[2 * plane + pix] = emission ? c1[p] : 0.f;
    out[3 * plane + pix] = emission ? 0.f : c1[p];
  }
  if (tid == 0 && counts) {
    atomicAdd(counts + tl::kCountDone, n_done);
    atomicAdd(counts + tl::kCountGlobal, n_global);
  }
}

// The kernel's static shared memory: the Line records.
template <bool kLight>
constexpr size_t kStaticSmem =
    2 * rt::kWindows<kLight> * tl::kCols * sizeof(tl::Line);

template <bool kLight, typename T>
cudaError_t launch_one(const T* L, const T* light, const float* slice_z,
                       const float* v_grid, const float* u_grid,
                       const float* seglen, const float* params, float* out,
                       int S, int A, int B, int Hb, int Wb, int emission,
                       int cap, unsigned long long* counts, cudaStream_t st) {
  constexpr int NW = rt::kWindows<kLight>;
  if ((long long)NW * cap > rt::kMaxSlots) return cudaErrorInvalidValue;
  const dim3 block(tl::kCols, tl::kGroups);
  const dim3 grid((Wb + tl::kCols - 1) / tl::kCols,
                  (Hb + tl::kRows - 1) / tl::kRows);
  const size_t smem = rt::smem_bytes(S, NW, 2 * NW, cap);
  const cudaError_t err = tl::allow_smem(sweep_ref_fwd_kernel<kLight, T>, smem,
                                         kStaticSmem<kLight>);
  if (err != cudaSuccess) return err;
  sweep_ref_fwd_kernel<kLight, T><<<grid, block, smem, st>>>(
      L, light, slice_z, v_grid, u_grid, seglen, params, out, S, A, B, Hb,
      Wb, emission, cap, counts);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* L_v, const void* light_v, const float* slice_z,
           const float* v_grid, const float* u_grid, const float* seglen,
           const float* params, float* out, int S, int A, int B, int Hb,
           int Wb, int emission, int cap, unsigned long long* counts,
           cudaStream_t st) {
  const T* L = static_cast<const T*>(L_v);
  const T* light = static_cast<const T*>(light_v);
  const cudaError_t err =
      light ? launch_one<true, T>(L, light, slice_z, v_grid, u_grid, seglen,
                                  params, out, S, A, B, Hb, Wb, emission, cap,
                                  counts, st)
            : launch_one<false, T>(L, light, slice_z, v_grid, u_grid, seglen,
                                   params, out, S, A, B, Hb, Wb, emission,
                                   cap, counts, st);
  return static_cast<int>(err);
}

}  // namespace

// Launches the sweep on `stream` and returns the CUDA error (0 when the
// launch was accepted). `elem` is the texel type of `L` and `light`:
// sweep::kElemF32 or sweep::kElemBF16 (anything else is refused with
// cudaErrorInvalidValue). `L` is (S, 4, A, B), `light` the (S, A, B) light
// slabs in slice order or null for no light volume (emission only), `params`
// (20,), `out` (4, Hb, Wb) float32: acc, trans, wsum, hit. `cap` is the
// stage: slots per window buffer (0 reads every tile-slice through global
// memory; at most sweep_ref_tile.cuh kMaxSlots over the 4 or 5 windows);
// the launch takes 16 * NW * S + 2 * NW * cap * 4 bytes of dynamic shared
// memory, NW = 4 windows, 5 with light. `counts`, if not null, is the (2,)
// int64 tile-slice tally (sweep_tile.cuh kCountDone, kCountGlobal), added
// to.
extern "C" int sweep_ref_fwd_launch(const void* L, const void* light,
                                    const float* slice_z, const float* v_grid,
                                    const float* u_grid, const float* seglen,
                                    const float* params, float* out, int S,
                                    int A, int B, int Hb, int Wb, int emission,
                                    int elem, int cap, void* counts,
                                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned long long* cnt = static_cast<unsigned long long*>(counts);
  if (elem == sweep::kElemF32)
    return launch<float>(L, light, slice_z, v_grid, u_grid, seglen, params,
                         out, S, A, B, Hb, Wb, emission, cap, cnt, st);
  if (elem == sweep::kElemBF16)
    return launch<__nv_bfloat16>(L, light, slice_z, v_grid, u_grid, seglen,
                                 params, out, S, A, B, Hb, Wb, emission, cap,
                                 cnt, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
