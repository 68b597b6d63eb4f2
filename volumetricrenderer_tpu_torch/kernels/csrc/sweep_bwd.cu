// Backward slice sweep for Hopper (sm_90a): the adjoint of the
// single-channel sweep of sweep_fwd.cu with respect to the stack.
//
// Replaces the TPU kernel volumetricrenderer_tpu/kernels/sweep_pallas.py
// `_bwd_kernel` / `_run_bwd` (K2), its light-volume branch included. It
// computes K2's function, not its schedule: no chunk checkpoints (tck,
// wck), because each tile replays its rays from T = 1; no
// one-hot MXU matrices, no gw/v scratch (nor the light branch's second
// one) and no row windows.
//
// The function, per base pixel and front to back (sweep_fwd.cu's taps):
//   * Emission, with cw = ct_wsum and bct = ct_trans * trans_S +
//     cw * wsum_S from the forward's outputs: from T = 1 and Wr = 0 (the
//     no-light Wr = 1 - T of K2), per slice
//       E = exp(-density * sigma * seg), alpha = 1 - E,
//       Wr += T * alpha, A~ = bct - cw * Wr,
//       dsigma = density * seg * (cw * T * E - A~),  T *= 1 - alpha.
//     Wr is updated exactly as the forward updates wsum, and sigma and E
//     come from the shared tap math (sweep_common.cuh, sweep_tile.cuh), so
//     T is the forward's bit for bit and the live gate T > thresh stops the
//     replay at the slice where the forward stopped.
//   * Emission with a light volume (the light branch, a template
//     parameter; a null light pointer launches the kernel without it):
//     shade and lT at the grid's layer and taps,
//       Wr += (T * alpha) * shade, the forward's own product,
//       dsigma = density * seg * (cw * T * shade * E - A~),
//     and the second output dlight: dlT = cw * T * alpha * (1 - ambient) *
//     clip'(lT) through the same four taps.
//   * Absorption: dsigma = ct_acc * seg on every in-box, in-front sample.
//   * The scatter: du = dsigma * sample_scale goes through the bilinear
//     adjoint to the four taps of layer k = S - 1 - s when `flip`, else
//     k = s, so dG leaves the kernel in the stack's own layer order.
//   * Behind-eye and out-of-box samples have no taps and are skipped, as
//     the forward skips them.
// dG and dlight must be zeroed by the caller: the taps are added with
// atomicAdd.
//
// What bounds it on this card. The function needs 36 float operations per
// in-box sample (5.9 GFLOP at the flagship: 0.087 ms at 67 TFLOP/s). The
// first design, one thread per base pixel with four global float atomics
// per live sample (eight with light), ran at 2.4 ms (5.5 with light) on an
// NVIDIA H100 80GB HBM3 at 700 W: ~650 M atomics per flagship backward,
// and a warp's 32 lanes, one base row, landing on ~6 texel columns of the
// same two rows, so same-address atomics serialised in L2. The tiled
// design below runs it in 1.5 ms (2.4 with light) on that card, and
// config 5's plan (512^3 at 1920x1080) in 3.2 ms (PERF.md §6).
//
// Design (sweep_tile.cuh, K1's schedule). One CTA per 32 x 32 base tile, a
// thread holding (T, Wr, cw, bct, seg) of 4 pixels in registers; the tile
// replays its active slices together from T = 1, with the grid's (and the
// light's) tap window staged in shared memory one active slice ahead and
// the taps computed once per line. The scatter: a warp is one tile row, so
// its lanes share the row taps and fall on a few column taps in runs of
// neighbouring lanes; warp shuffles sum each run, in as many rounds as the
// slice's longest run needs, and its last lane adds the sums to global
// memory with atomicAdd (warp_scatter<true>), at the layer offsets of its
// taps. A staged tile-slice reads its window from shared memory and adds
// the same way: the stage holds only texels read, so K1's layout serves.
// Summing the runs into eight per-warp windows in shared memory first, and
// those into global memory once per texel, took 4.1 ms at config 5's plan,
// where a run is one to three lanes; gathering the tile's du in shared
// memory through the separable bilinear adjoint in two passes, 3.9. A
// tile-slice whose window exceeds the stage reads through global memory,
// and is counted.
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

#include "sweep_tile.cuh"

namespace {

namespace tl = sweep::tile;

// The layer offsets of the taps of one line (make_line's, for a tile-slice
// read through global memory): where K2 adds its sums, staged or not.
template <typename T>
__device__ __forceinline__ int2 layer_offsets(float x01, int n, int wrap,
                                              int stride) {
  const tl::Line l = tl::make_line<T>(x01, n, wrap, false, 0, 0, 1, stride);
  return make_int2(l.o0, l.o1);
}

// The static shared memory K2 takes besides K1's: the layer offsets of its
// rows and columns.
constexpr size_t kStaticSmemBwd =
    tl::kStaticSmem + (tl::kRows + tl::kCols) * sizeof(int2);

// 85 registers (3 CTAs an SM) hold every instantiation but the bfloat16
// light one, which gets up to 128 (2 CTAs) rather than spill. At 64 (4
// CTAs) float32 spills, and ran 2 % slower at config 5's plan.
template <bool kLight, typename T>
__global__ void __launch_bounds__(tl::kThreads,
                                  kLight && sizeof(T) == 2 ? 2 : 3)
    sweep_bwd_kernel(
    const T* __restrict__ stack, const T* __restrict__ light,
    const float* __restrict__ slice_z,
    const float* __restrict__ v_grid, const float* __restrict__ u_grid,
    const float* __restrict__ seglen, const float* __restrict__ params,
    const float* __restrict__ ct_acc, const float* __restrict__ ct_trans,
    const float* __restrict__ ct_wsum, const float* __restrict__ trans_out,
    const float* __restrict__ wsum_out, float* __restrict__ dstack,
    float* __restrict__ dlight, int S, int A, int B, int Hb, int Wb,
    int emission, int flip, int wrap, int cap,
    unsigned long long* __restrict__ counts) {
  // The window table (S entries), then [stack, light][buffer][cap] staged
  // texels. rows_g, cols_g: the layer offsets of the lines' taps.
  extern __shared__ int4 smem[];
  __shared__ tl::Line rows_l[tl::kRows], cols_l[tl::kCols];
  __shared__ int2 rows_g[tl::kRows], cols_g[tl::kCols];
  constexpr int kVols = kLight ? 2 : 1;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * tl::kCols + tx;
  const sweep::Params P = sweep::load_params(params);
  const size_t layer = (size_t)A * B;
  int4* const tab = smem;
  float* const stage = reinterpret_cast<float*>(smem + S);
  tl::fill_windows(tab, P, slice_z, v_grid, u_grid, S, A, B, Hb, Wb, wrap,
                   tid);

  // Per pixel p (row tile_row0 + ty + 8p, column j). Emission: seg, cw,
  // bct and the replay's (T, Wr); absorption: du = ct_acc * seg * sscale
  // in cw.
  const int j = tl::tile_col0() + tx;
  const int rows_left = Hb - tl::tile_row0() - ty;
  float seg[tl::kPix], cw[tl::kPix], bct[tl::kPix], trans[tl::kPix],
      wr[tl::kPix];
#pragma unroll
  for (int p = 0; p < tl::kPix; ++p) {
    const bool ok = tl::kGroups * p < rows_left && j < Wb;
    const size_t pix =
        ok ? (size_t)(tl::tile_row0() + ty + tl::kGroups * p) * Wb + j : 0;
    seg[p] = ok ? seglen[pix] : 0.f;
    trans[p] = 1.f;
    wr[p] = 0.f;
    cw[p] = bct[p] = 0.f;
    if (ok && emission) {
      cw[p] = ct_wsum[pix];
      bct[p] = ct_trans[pix] * trans_out[pix] + cw[p] * wsum_out[pix];
    } else if (ok) {
      cw[p] = ct_acc[pix] * seg[p] * P.sscale;
    }
  }
  __syncthreads();  // the window table

  const auto win = [&](int bb) { return stage + bb * cap; };
  const auto lwin = [&](int bb) { return stage + (2 + bb) * cap; };
  unsigned long long n_done = 0, n_global = 0;
  int s = tl::next_active(tab, 0, S);
  if (emission && s < S) {
    const tl::Window w = tl::window_at(tab, s, S, flip, cap);
    if (w.staged) {
      tl::stage_window(win(0), stack + w.k * layer, w, A, B, wrap, tid);
      if constexpr (kLight)
        tl::stage_window(lwin(0), light + w.k * layer, w, A, B, wrap,
                         tid);
    }
  }
  tl::copy_commit();
  int b = 0;
  while (s < S) {
    const int sn = tl::next_active(tab, s + 1, S);
    if (emission && sn < S) {
      const tl::Window w = tl::window_at(tab, sn, S, flip, cap);
      if (w.staged) {
        tl::stage_window(win(b ^ 1), stack + w.k * layer, w, A, B,
                         wrap, tid);
        if constexpr (kLight)
          tl::stage_window(lwin(b ^ 1), light + w.k * layer, w, A, B,
                           wrap, tid);
      }
    }
    tl::copy_commit();
    const tl::Window w = tl::window_at(tab, s, S, flip, cap);
    tl::make_lines<T>(rows_l, cols_l, P, w, v_grid, u_grid, A, B, Hb, Wb,
                      wrap);
    if (ty == 2) {
      cols_g[tx] = j < Wb ? layer_offsets<T>(P.e_b + w.delta * u_grid[j], B,
                                             wrap, 1)
                          : make_int2(-1, -1);
    } else if (ty == 3) {
      const int i = tl::tile_row0() + tx;
      rows_g[tx] = i < Hb ? layer_offsets<T>(P.e_a + w.delta * v_grid[i], A,
                                             wrap, B)
                          : make_int2(-1, -1);
    }
    tl::copy_wait_prior();
    if (emission && w.staged) {
      tl::widen_window<T>(win(b), stack + w.k * layer, w, A, B, wrap,
                          tid);
      if constexpr (kLight)
        tl::widen_window<T>(lwin(b), light + w.k * layer, w, A, B, wrap,
                            tid);
    }
    __syncthreads();

    // The column's taps as warp_scatter adds them (the Line's weights at
    // the layer offsets), its runs and the warp's longest run.
    const tl::Line col = cols_l[tx];
    const int2 cg = cols_g[tx];
    const tl::Line col_g{cg.x, cg.y, col.w0, col.w1};
    const tl::Runs runs = tl::runs_of(col_g);
    const int span = (int)__reduce_max_sync(
        tl::kFull, (unsigned)(tx + 1 - min(runs.start0, runs.start1)));
    const bool col_ok = col.o0 >= 0 && j < Wb;
    const T* const g_layer = stack + w.k * layer;
    bool live = false;
#pragma unroll
    for (int p = 0; p < tl::kPix; ++p) {
      // The row, and so the branch, is the warp's own.
      if (!(tl::kGroups * p < rows_left)) continue;
      const tl::Line row = rows_l[ty + tl::kGroups * p];
      const bool act = col_ok && row.o0 >= 0 &&
                       (!emission || trans[p] > P.thresh);
      float du = cw[p], dl = 0.f;
      if (emission && act) {
        const float g = w.staged ? tl::tap_sum<true, T>(win(b), row, col)
                                 : tl::tap_sum<false, T>(g_layer, row, col);
        const float sigma = P.sscale * g;
        const float e = sweep::extinction(P, sigma, seg[p]);
        const float alpha = 1.f - e;
        float dsigma;
        if constexpr (kLight) {
          const float lT =
              w.staged ? tl::tap_sum<true, T>(lwin(b), row, col)
                       : tl::tap_sum<false, T>(light + w.k * layer, row,
                                               col);
          const float shade = tl::shade_of(lT, P.ambient);
          wr[p] += (trans[p] * alpha) * shade;
          const float a_til = bct[p] - cw[p] * wr[p];
          dsigma =
              P.density * seg[p] * (cw[p] * trans[p] * shade * e - a_til);
          dl = tl::shade_grad(lT, P.ambient, cw[p], trans[p], alpha);
        } else {
          wr[p] += trans[p] * alpha;
          const float a_til = bct[p] - cw[p] * wr[p];
          dsigma = P.density * seg[p] * (cw[p] * trans[p] * e - a_til);
        }
        trans[p] *= 1.f - alpha;
        du = dsigma * P.sscale;
      }
      if (!act) du = 0.f;
      if (__any_sync(tl::kFull, act)) {
        const int2 rg = rows_g[ty + tl::kGroups * p];
        const tl::Line row_g{rg.x, rg.y, row.w0, row.w1};
        tl::warp_scatter<true>(dstack + w.k * layer, row_g, col_g, runs, du,
                               span);
        if constexpr (kLight)
          tl::warp_scatter<true>(dlight + w.k * layer, row_g, col_g, runs,
                                 dl, span);
      }
      live = live || (j < Wb && (!emission || trans[p] > P.thresh));
    }
    ++n_done;
    if (!w.staged) ++n_global;
    const bool any = __syncthreads_or(live);
    if (!any) break;
    s = sn;
    b ^= 1;
  }
  tl::copy_wait_all();
  if (tid == 0 && counts) {
    atomicAdd(counts + tl::kCountDone, n_done);
    atomicAdd(counts + tl::kCountGlobal, n_global);
  }
}

template <typename T>
int launch(const void* stack_v, const void* light_v, const float* slice_z,
           const float* v_grid, const float* u_grid, const float* seglen,
           const float* params, const float* ct_acc, const float* ct_trans,
           const float* ct_wsum, const float* trans_out,
           const float* wsum_out, float* dstack, float* dlight, int S, int A,
           int B, int Hb, int Wb, int emission, int flip, int wrap, int cap,
           unsigned long long* counts, cudaStream_t st) {
  const T* stack = static_cast<const T*>(stack_v);
  const T* light = static_cast<const T*>(light_v);
  const dim3 block(tl::kCols, tl::kGroups);
  const dim3 grid((Wb + tl::kCols - 1) / tl::kCols,
                  (Hb + tl::kRows - 1) / tl::kRows);
  const size_t smem = tl::smem_bytes(S, light ? 4 : 2, cap);
  cudaError_t err;
  if (light) {
    err = tl::allow_smem(sweep_bwd_kernel<true, T>, smem,
                           kStaticSmemBwd);
    if (err == cudaSuccess)
      sweep_bwd_kernel<true, T><<<grid, block, smem, st>>>(
          stack, light, slice_z, v_grid, u_grid, seglen, params, ct_acc,
          ct_trans, ct_wsum, trans_out, wsum_out, dstack, dlight, S, A, B,
          Hb, Wb, emission, flip, wrap, cap, counts);
  } else {
    err = tl::allow_smem(sweep_bwd_kernel<false, T>, smem,
                           kStaticSmemBwd);
    if (err == cudaSuccess)
      sweep_bwd_kernel<false, T><<<grid, block, smem, st>>>(
          stack, light, slice_z, v_grid, u_grid, seglen, params, ct_acc,
          ct_trans, ct_wsum, trans_out, wsum_out, dstack, dlight, S, A, B,
          Hb, Wb, emission, flip, wrap, cap, counts);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the backward sweep on `stream` and returns the CUDA error (0
// when the launch was accepted). `elem` is the texel type of `stack` and
// `light`: sweep::kElemF32 or sweep::kElemBF16 (anything else is refused
// with cudaErrorInvalidValue). Emission reads ct_trans, ct_wsum and the
// forward's trans and wsum maps; absorption reads ct_acc. The maps are
// (Hb, Wb) float32; the pointers a mode does not read may be null. `dstack`
// is the zeroed (S, A, B) float32 gradient. `light` is the (S, A, B) light
// stack the forward read and `dlight` its zeroed float32 gradient, or both
// null for no light volume (emission only). `cap` and `counts` as in
// sweep_fwd_launch; the launch takes 16 * S + (light ? 4 : 2) * cap * 4
// bytes of dynamic shared memory (the window table and the staged texels),
// as sweep_fwd_launch does.
extern "C" int sweep_bwd_launch(const void* stack, const void* light,
                                const float* slice_z, const float* v_grid,
                                const float* u_grid, const float* seglen,
                                const float* params, const float* ct_acc,
                                const float* ct_trans, const float* ct_wsum,
                                const float* trans_out, const float* wsum_out,
                                float* dstack, float* dlight, int S, int A,
                                int B, int Hb, int Wb, int emission, int flip,
                                int wrap, int elem, int cap, void* counts,
                                void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned long long* cnt = static_cast<unsigned long long*>(counts);
  if (elem == sweep::kElemF32)
    return launch<float>(stack, light, slice_z, v_grid, u_grid, seglen,
                         params, ct_acc, ct_trans, ct_wsum, trans_out,
                         wsum_out, dstack, dlight, S, A, B, Hb, Wb, emission,
                         flip, wrap, cap, cnt, st);
  if (elem == sweep::kElemBF16)
    return launch<__nv_bfloat16>(stack, light, slice_z, v_grid, u_grid,
                                 seglen, params, ct_acc, ct_trans, ct_wsum,
                                 trans_out, wsum_out, dstack, dlight, S, A, B,
                                 Hb, Wb, emission, flip, wrap, cap, cnt, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
