// Backward slice sweep of the 4-channel reference medium for Hopper
// (sm_90a): the adjoint of sweep_ref_fwd.cu with respect to the pre-lerped
// channel slabs L.
//
// Replaces the TPU kernel volumetricrenderer_tpu/kernels/sweep_pallas.py
// `_bwd_kernel_ref` / `_run_bwd_ref`, its light-volume branch included. It
// computes that kernel's function, not its schedule: no chunk checkpoints
// (each tile replays its rays from T = 1), no one-hot
// scatter matrices on the MXU and no per-(slice, channel) scratch.
//
// The function, per base pixel, front to back at the forward's taps:
//   * Emission, with cw = ct_wsum and bct = ct_trans * trans_S +
//     cw * wsum_S from the forward's outputs: from T = 1 and Wr = 0, per
//     slice
//       E = exp(-density * sigma * seg), alpha = 1 - E,
//       Wr += T * alpha, A~ = bct - cw * Wr,
//       dsigma = density * seg * (cw * T * E - A~),  T *= 1 - alpha.
//     The four channel samples, sigma and E are the forward's arithmetic,
//     and Wr is updated exactly as the forward updates wsum, so T is the
//     forward's bit for bit and the live gate T > thresh stops the replay
//     at the slice where the forward stopped.
//   * Emission with light slabs (the light branch, a template parameter; a
//     null light pointer launches the kernel without it): shade and lT at
//     the unscaled, clipped taps, as in the forward; Wr += (T * alpha) *
//     shade, dsigma = density * seg * (cw * T * shade * E - A~), and the
//     second output dlight: dlT = cw * T * alpha * (1 - ambient) *
//     clip'(lT) through those taps.
//   * Absorption: dsigma = ct_acc * seg on every in-box, in-front sample.
//   * The product rule of sigma = (r0 * r1) * (r2 + r3) * sample_scale,
//     with d = dsigma * sample_scale:
//       dr0 = d * r1 * (r2 + r3), dr1 = d * r0 * (r2 + r3),
//       dr2 = dr3 = d * r0 * r1.
//   * The scatter: each dr_c goes through the bilinear adjoint to the four
//     mirrored taps of L[s, c]. Where the mirror puts both taps of an axis
//     on one texel, both weights land there.
//
// What bounds it on this card. The function needs 101 float operations per
// in-box sample and 30 per row and column (3.66 GFLOP at the reference
// preset: 0.055 ms at 67 TFLOP/s). The first design, one thread per base
// pixel (PR 3) with 16 global float atomics per live sample (20 with
// light), ran at 3.1 ms (3.7 with light) on an NVIDIA H100 80GB HBM3 at
// 700 W. This design runs the same work in 1.6-1.74 ms (2.1-2.3 with
// light) on that card, 1.85x its parent in turns (PERF.md §6). What bounds
// it now is the scatter's run sums: up to five shuffle steps (the warp's
// longest run) for each of four channels (five with light) per pixel and
// slice, and the per-slice work around them; the global-memory path
// (stage 0) is within 12 % of the staged one, and faster at 256^3 x 4,
// where the stage takes 85 KB of shared memory a CTA (2 CTAs an SM).
//
// Design (sweep_ref_tile.cuh, K4's schedule; K2's scatter). One CTA per 32
// x 32 base tile, a thread replaying 4 pixels (T and Wr in registers, seg,
// cw and bct in shared memory); the tile replays its active slices
// together from T = 1 with the channel and light windows staged as in the
// forward. The scatter: a warp is one tile row, so its lanes share the row
// taps and fall on a few column taps of each channel in runs of
// neighbouring lanes, rising (or falling) with the lane in the window's
// unmirrored slots. The warp that made a channel's column lines also finds
// their runs and the longest, once per slice; per pixel and channel, warp
// shuffles sum du * wb0 and du * wb1 over each run (as far as the longest
// run) and the run's last lane adds the sums into the warp's own
// accumulation window of that channel in shared memory, no atomic needed.
// After the slice's barrier the eight warps' windows are summed slot by
// slot and each nonzero slot is added to its texel mirror(lo + m) of dL
// with one atomicAdd; two slots of a fold add to one texel there. A
// tile-slice whose windows exceed the stage reads through global memory and
// adds its run sums there with atomicAdd, and is counted.
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

#include "sweep_ref_tile.cuh"

namespace {

namespace tl = sweep::tile;
namespace rt = sweep::tile::ref;

// 3 CTAs an SM (85 registers): the column lines and each pixel's seg, cw
// and bct are read from shared memory rather than held, which keeps every
// instantiation spill-free there.
template <bool kLight, typename T>
__global__ void __launch_bounds__(tl::kThreads, 3) sweep_ref_bwd_kernel(
    const T* __restrict__ L, const T* __restrict__ light,
    const float* __restrict__ slice_z,
    const float* __restrict__ v_grid, const float* __restrict__ u_grid,
    const float* __restrict__ seglen, const float* __restrict__ params,
    const float* __restrict__ ct_acc, const float* __restrict__ ct_trans,
    const float* __restrict__ ct_wsum, const float* __restrict__ trans_out,
    const float* __restrict__ wsum_out, float* __restrict__ dL,
    float* __restrict__ dlight, int S, int A, int B, int Hb, int Wb,
    int emission, int cap, unsigned long long* __restrict__ counts) {
  constexpr int NW = rt::kWindows<kLight>;
  constexpr int NCH = sweep::NCH;
  // The window table (NW * S entries), then [buffer][window][cap] staged
  // texels, then [window][warp][cap] accumulation windows.
  extern __shared__ int4 smem[];
  __shared__ tl::Line rows_l[NW * tl::kRows], cols_l[NW * tl::kCols];
  __shared__ int runs_l[NW * tl::kCols];
  __shared__ float pix_l[3][tl::kPix][tl::kThreads];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * tl::kCols + tx;
  const sweep::Params P = sweep::load_params(params);
  const size_t layer = (size_t)A * B;
  int4* const tab = smem;
  float* const stage = reinterpret_cast<float*>(smem + NW * S);
  float* const acc = stage + 2 * NW * cap;
  rt::fill_windows<NW>(tab, P, sweep::load_ref_params(params), slice_z,
                       v_grid, u_grid, S, A, B, Hb, Wb, tid);
  for (int m = tid; m < tl::kGroups * NW * cap; m += tl::kThreads)
    acc[m] = 0.f;

  // Per pixel p (row tile_row0 + ty + 8p, column j). Emission: seg, cw,
  // bct and the replay's (T, Wr); absorption: d = ct_acc * seg * sscale
  // in cw.
  const int j = tl::tile_col0() + tx;
  const int rows_left = Hb - tl::tile_row0() - ty;
  // Per pixel p, this thread's slots of pix_l: seg, cw and bct.
  const auto seg = [&](int p) -> float& { return pix_l[0][p][tid]; };
  const auto cw = [&](int p) -> float& { return pix_l[1][p][tid]; };
  const auto bct = [&](int p) -> float& { return pix_l[2][p][tid]; };
  float trans[tl::kPix], wr[tl::kPix];
#pragma unroll
  for (int p = 0; p < tl::kPix; ++p) {
    const bool ok = tl::kGroups * p < rows_left && j < Wb;
    const size_t pix =
        ok ? (size_t)(tl::tile_row0() + ty + tl::kGroups * p) * Wb + j : 0;
    seg(p) = ok ? seglen[pix] : 0.f;
    trans[p] = 1.f;
    wr[p] = 0.f;
    cw(p) = bct(p) = 0.f;
    if (ok && emission) {
      cw(p) = ct_wsum[pix];
      bct(p) = ct_trans[pix] * trans_out[pix] + cw(p) * wsum_out[pix];
    } else if (ok) {
      cw(p) = ct_acc[pix] * seg(p) * P.sscale;
    }
  }
  __syncthreads();  // the window table and the zeroed windows

  const auto win = [&](int bb, int w) {
    return stage + (bb * NW + w) * cap;
  };
  // This warp's accumulation window of window w.
  const auto wacc = [&](int w) { return acc + (w * tl::kGroups + ty) * cap; };
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
    rt::make_lines<kLight, T>(rows_l, cols_l, runs_l, P, params, tab, s,
                              staged, delta, v_grid, u_grid, A, B, Hb, Wb);
    tl::copy_wait_prior();
    if (staged)
      rt::widen_windows<NW, T>(win(b, 0), cap, tab, s, A, B, tid, half);
    __syncthreads();

    const auto colw = [&](int w) { return cols_l[w * tl::kCols + tx]; };
    const bool col_ok = cols_l[tx].o0 >= 0 && j < Wb;
    const T* const g_slab = L + (size_t)s * NCH * layer;
    float* const d_slab = dL + (size_t)s * NCH * layer;
    bool live = false;
#pragma unroll
    for (int p = 0; p < tl::kPix; ++p) {
      // The row, and so the branch, is the warp's own.
      if (!(tl::kGroups * p < rows_left)) continue;
      const int rr = ty + tl::kGroups * p;
      const bool act = col_ok && rows_l[rr].o0 >= 0 &&
                       (!emission || trans[p] > P.thresh);
      float dr[NCH] = {0.f, 0.f, 0.f, 0.f};
      float dl = 0.f;
      if (act) {
        float r[NCH];
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          const tl::Line row = rows_l[c * tl::kRows + rr];
          r[c] = staged ? tl::tap_sum<true, T>(win(b, c), row, colw(c))
                        : tl::tap_sum<false, T>(g_slab + c * layer, row,
                                                colw(c));
        }
        float d = cw(p);
        if (emission) {
          const float sigma = sweep::ref_sigma(r, P.sscale);
          const float e = sweep::extinction(P, sigma, seg(p));
          const float alpha = 1.f - e;
          float dsigma;
          if constexpr (kLight) {
            const tl::Line row = rows_l[rt::kLightWin * tl::kRows + rr];
            const tl::Line lc = colw(rt::kLightWin);
            const float lT =
                staged ? tl::tap_sum<true, T>(win(b, rt::kLightWin), row, lc)
                       : tl::tap_sum<false, T>(light + (size_t)s * layer,
                                               row, lc);
            const float shade = tl::shade_of(lT, P.ambient);
            wr[p] += (trans[p] * alpha) * shade;
            const float a_til = bct(p) - cw(p) * wr[p];
            dsigma =
                P.density * seg(p) * (cw(p) * trans[p] * shade * e - a_til);
            dl = tl::shade_grad(lT, P.ambient, cw(p), trans[p], alpha);
          } else {
            wr[p] += trans[p] * alpha;
            const float a_til = bct(p) - cw(p) * wr[p];
            dsigma = P.density * seg(p) * (cw(p) * trans[p] * e - a_til);
          }
          trans[p] *= 1.f - alpha;
          d = dsigma * P.sscale;
        }
        // The product rule of sigma = (r0 * r1) * (r2 + r3) * sscale.
        const float s34 = r[2] + r[3];
        const float r01 = r[0] * r[1];
        dr[0] = d * r[1] * s34;
        dr[1] = d * r[0] * s34;
        dr[2] = d * r01;
        dr[3] = d * r01;
      }
      if (__any_sync(tl::kFull, act)) {
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          const tl::Line row = rows_l[w * tl::kRows + rr];
          const int packed = runs_l[w * tl::kCols + tx];
          const tl::Runs q = rt::unpack_runs(packed);
          const int span = rt::unpack_span(packed);
          const tl::Line cl = colw(w);
          const float du = w < NCH ? dr[w < NCH ? w : 0] : dl;
          if (staged)
            tl::warp_scatter<false>(wacc(w), row, cl, q, du, span);
          else
            tl::warp_scatter<true>(w < NCH ? d_slab + w * layer
                                           : dlight + (size_t)s * layer,
                                   row, cl, q, du, span);
        }
      }
      live = live || (j < Wb && (!emission || trans[p] > P.thresh));
    }
    ++n_done;
    if (!staged) ++n_global;
    const bool any = __syncthreads_or(live);
    // This slice's sums, complete at the barrier; the next slice's first
    // barrier orders the zeroed windows before its adds.
    if (staged)
      rt::flush_windows<NW>(acc, cap, tab, s, dL, dlight, A, B, tid);
    if (!any) break;
    s = sn;
    b ^= 1;
    half = half_next;
  }
  tl::copy_wait_all();
  if (tid == 0 && counts) {
    atomicAdd(counts + tl::kCountDone, n_done);
    atomicAdd(counts + tl::kCountGlobal, n_global);
  }
}

// The kernel's static shared memory: the Line records, the runs and the
// per-pixel constants.
template <bool kLight>
constexpr size_t kStaticSmem =
    rt::kWindows<kLight> * tl::kCols * (2 * sizeof(tl::Line) + sizeof(int)) +
    3 * tl::kPix * tl::kThreads * sizeof(float);

template <bool kLight, typename T>
cudaError_t launch_one(const T* L, const T* light, const float* slice_z,
                       const float* v_grid, const float* u_grid,
                       const float* seglen, const float* params,
                       const float* ct_acc, const float* ct_trans,
                       const float* ct_wsum, const float* trans_out,
                       const float* wsum_out, float* dL, float* dlight,
                       int S, int A, int B, int Hb, int Wb, int emission,
                       int cap, unsigned long long* counts, cudaStream_t st) {
  constexpr int NW = rt::kWindows<kLight>;
  if ((long long)NW * cap > rt::kMaxSlots) return cudaErrorInvalidValue;
  const dim3 block(tl::kCols, tl::kGroups);
  const dim3 grid((Wb + tl::kCols - 1) / tl::kCols,
                  (Hb + tl::kRows - 1) / tl::kRows);
  const size_t smem =
      rt::smem_bytes(S, NW, (2 + tl::kGroups) * NW, cap);
  const cudaError_t err = tl::allow_smem(sweep_ref_bwd_kernel<kLight, T>, smem,
                                         kStaticSmem<kLight>);
  if (err != cudaSuccess) return err;
  sweep_ref_bwd_kernel<kLight, T><<<grid, block, smem, st>>>(
      L, light, slice_z, v_grid, u_grid, seglen, params, ct_acc, ct_trans,
      ct_wsum, trans_out, wsum_out, dL, dlight, S, A, B, Hb, Wb, emission,
      cap, counts);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* L_v, const void* light_v, const float* slice_z,
           const float* v_grid, const float* u_grid, const float* seglen,
           const float* params, const float* ct_acc, const float* ct_trans,
           const float* ct_wsum, const float* trans_out,
           const float* wsum_out, float* dL, float* dlight, int S, int A,
           int B, int Hb, int Wb, int emission, int cap,
           unsigned long long* counts, cudaStream_t st) {
  const T* L = static_cast<const T*>(L_v);
  const T* light = static_cast<const T*>(light_v);
  const cudaError_t err =
      light ? launch_one<true, T>(L, light, slice_z, v_grid, u_grid, seglen,
                                  params, ct_acc, ct_trans, ct_wsum,
                                  trans_out, wsum_out, dL, dlight, S, A, B,
                                  Hb, Wb, emission, cap, counts, st)
            : launch_one<false, T>(L, light, slice_z, v_grid, u_grid, seglen,
                                   params, ct_acc, ct_trans, ct_wsum,
                                   trans_out, wsum_out, dL, dlight, S, A, B,
                                   Hb, Wb, emission, cap, counts, st);
  return static_cast<int>(err);
}

}  // namespace

// Launches the backward sweep on `stream` and returns the CUDA error (0
// when the launch was accepted). `elem` is the texel type of `L` and
// `light`: sweep::kElemF32 or sweep::kElemBF16 (anything else is refused
// with cudaErrorInvalidValue). Emission reads ct_trans, ct_wsum and the
// forward's trans and wsum maps; absorption reads ct_acc. The maps are
// (Hb, Wb) float32; the pointers a mode does not read may be null. `dL` is
// the zeroed (S, 4, A, B) float32 gradient. `light` is the (S, A, B) light
// slabs the forward read and `dlight` their zeroed float32 gradient, or
// both null for no light volume (emission only). `cap` and `counts` as in
// sweep_ref_fwd_launch; the launch takes 16 * NW * S + 10 * NW * cap * 4
// bytes of dynamic shared memory (the window table, the staged texels and
// the eight warps' accumulation windows), NW = 4 windows, 5 with light.
extern "C" int sweep_ref_bwd_launch(
    const void* L, const void* light, const float* slice_z,
    const float* v_grid, const float* u_grid, const float* seglen,
    const float* params, const float* ct_acc, const float* ct_trans,
    const float* ct_wsum, const float* trans_out, const float* wsum_out,
    float* dL, float* dlight, int S, int A, int B, int Hb, int Wb,
    int emission, int elem, int cap, void* counts, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned long long* cnt = static_cast<unsigned long long*>(counts);
  if (elem == sweep::kElemF32)
    return launch<float>(L, light, slice_z, v_grid, u_grid, seglen, params,
                         ct_acc, ct_trans, ct_wsum, trans_out, wsum_out, dL,
                         dlight, S, A, B, Hb, Wb, emission, cap, cnt, st);
  if (elem == sweep::kElemBF16)
    return launch<__nv_bfloat16>(L, light, slice_z, v_grid, u_grid, seglen,
                                 params, ct_acc, ct_trans, ct_wsum, trans_out,
                                 wsum_out, dL, dlight, S, A, B, Hb, Wb,
                                 emission, cap, cnt, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
