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
// The function, per base pixel (i, j) and slice s in front-to-back order,
// with delta = slice_z[s] - e_k:
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
//     later slice, so the pixel stops there with the same result;
//   * emission with a light volume (the kernels' light branch): the light
//     stack has the grid's layout and is read at the same layer k and the
//     same taps; lT is its bilinear sample, shade = ambient + (1 - ambient)
//     * clip(lT, 0, 1) and wsum += (T * alpha) * shade. The TPU kernels'
//     second row matmul and column stage for the light volume are not
//     carried over. The branch is a template parameter: a null light
//     pointer launches the instantiation without it;
//   * absorption: acc += sigma * seg, hit = 1.
// `flip` and the lerped sub-voxel stack (n_slices != depth) are decided by
// the wrapper: it passes the stack already in slice order with flip = 0.
//
// What bounds it on this card. The function needs 18 float operations per
// in-box sample and a few per line (2.9 GFLOP at the flagship, 1536^2 base,
// 256 slices: 0.044 ms at 67 TFLOP/s) and reads each texel once (0.034 ms
// of device memory). The first design, one thread per base pixel, ran at
// 1.1 ms on an NVIDIA H100 80GB HBM3 at 700 W: every sample recomputed both
// axes' taps and issued four scattered loads, and the next slice's loads
// waited behind the live gate; this design runs the same work in 0.75 ms
// on that card (PERF.md §6).
//
// Design (sweep_tile.cuh). One CTA of 256 threads per 32 x 32 base tile, a
// thread holding (acc, T, wsum, hit) of 4 pixels of its column in
// registers; the tile walks its active slices (its slice range) together.
// Per slice, one thread per row and per column computes the line's taps
// and rounded weights into shared memory; the tile's tap window of layer k
// (and of the light layer) is copied into shared memory with cp.async one
// active slice ahead, so a sample is four shared-memory reads and the
// float32 arithmetic. __syncthreads_or ends the walk when no pixel of the
// tile is live. A tile-slice whose window exceeds the stage the host sized
// reads global memory at the same taps, and is counted.
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
// Numerics: expf, not __expf, and the build passes --fmad=false, so every
// product and sum is rounded as the plain PyTorch version rounds it. The
// tap math lives in sweep_common.cuh and sweep_tile.cuh, shared with the
// backward kernel (sweep_bwd.cu), whose replay of the transmittance must
// reproduce this kernel's bit for bit; it is the per-pixel kernel's
// arithmetic, so the tiled schedule changes no output bit.

#include "sweep_tile.cuh"

namespace {

namespace tl = sweep::tile;

// 64 registers (4 CTAs an SM) leave the bfloat16 light instantiation a few
// spilled bytes; it gets up to 85 (3 CTAs).
template <bool kLight, typename T>
__global__ void __launch_bounds__(tl::kThreads,
                                  kLight && sizeof(T) == 2 ? 3 : 4)
    sweep_fwd_kernel(
    const T* __restrict__ stack, const T* __restrict__ light,
    const float* __restrict__ slice_z,
    const float* __restrict__ v_grid, const float* __restrict__ u_grid,
    const float* __restrict__ seglen, const float* __restrict__ params,
    float* __restrict__ out, int S, int A, int B, int Hb, int Wb,
    int emission, int flip, int wrap, int cap,
    unsigned long long* __restrict__ counts) {
  // The window table (S entries), then [stack, light][buffer][cap].
  extern __shared__ int4 smem[];
  __shared__ tl::Line rows_l[tl::kRows], cols_l[tl::kCols];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * tl::kCols + tx;
  const sweep::Params P = sweep::load_params(params);
  const size_t layer = (size_t)A * B;
  int4* const tab = smem;
  float* const stage = reinterpret_cast<float*>(smem + S);
  tl::fill_windows(tab, P, slice_z, v_grid, u_grid, S, A, B, Hb, Wb, wrap,
                   tid);

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

  const auto win = [&](int bb) { return stage + bb * cap; };
  const auto lwin = [&](int bb) { return stage + (2 + bb) * cap; };
  unsigned long long n_done = 0, n_global = 0;
  int s = tl::next_active(tab, 0, S);
  if (s < S) {
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
    if (sn < S) {
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
    tl::copy_wait_prior();
    if (w.staged) {
      tl::widen_window<T>(win(b), stack + w.k * layer, w, A, B, wrap,
                          tid);
      if constexpr (kLight)
        tl::widen_window<T>(lwin(b), light + w.k * layer, w, A, B, wrap,
                            tid);
    }
    __syncthreads();

    const tl::Line col = cols_l[tx];
    const T* const g_layer = stack + w.k * layer;
    const T* const l_layer = kLight ? light + w.k * layer : nullptr;
    bool live = false;
#pragma unroll
    for (int p = 0; p < tl::kPix; ++p) {
      if (!(tl::kGroups * p < rows_left)) continue;
      if (emission && !(c0[p] > P.thresh)) continue;
      const tl::Line row = rows_l[ty + tl::kGroups * p];
      if (col.o0 >= 0 && row.o0 >= 0) {
        const float g = w.staged ? tl::tap_sum<true, T>(win(b), row, col)
                                 : tl::tap_sum<false, T>(g_layer, row, col);
        const float sigma = P.sscale * g;
        if (emission) {
          const float alpha = 1.f - sweep::extinction(P, sigma, seg[p]);
          if constexpr (kLight) {
            const float lT = w.staged
                                 ? tl::tap_sum<true, T>(lwin(b), row, col)
                                 : tl::tap_sum<false, T>(l_layer, row, col);
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
    if (!w.staged) ++n_global;
    if (!__syncthreads_or(live)) break;
    s = sn;
    b ^= 1;
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

template <typename T>
int launch(const void* stack_v, const void* light_v, const float* slice_z,
           const float* v_grid, const float* u_grid, const float* seglen,
           const float* params, float* out, int S, int A, int B, int Hb,
           int Wb, int emission, int flip, int wrap, int cap,
           unsigned long long* counts, cudaStream_t st) {
  const T* stack = static_cast<const T*>(stack_v);
  const T* light = static_cast<const T*>(light_v);
  const dim3 block(tl::kCols, tl::kGroups);
  const dim3 grid((Wb + tl::kCols - 1) / tl::kCols,
                  (Hb + tl::kRows - 1) / tl::kRows);
  const size_t smem = tl::smem_bytes(S, light ? 4 : 2, cap);
  cudaError_t err;
  if (light) {
    err = tl::allow_smem(sweep_fwd_kernel<true, T>, smem,
                           tl::kStaticSmem);
    if (err == cudaSuccess)
      sweep_fwd_kernel<true, T><<<grid, block, smem, st>>>(
          stack, light, slice_z, v_grid, u_grid, seglen, params, out, S, A,
          B, Hb, Wb, emission, flip, wrap, cap, counts);
  } else {
    err = tl::allow_smem(sweep_fwd_kernel<false, T>, smem,
                           tl::kStaticSmem);
    if (err == cudaSuccess)
      sweep_fwd_kernel<false, T><<<grid, block, smem, st>>>(
          stack, light, slice_z, v_grid, u_grid, seglen, params, out, S, A,
          B, Hb, Wb, emission, flip, wrap, cap, counts);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the sweep on `stream` and returns the CUDA error (0 when the
// launch was accepted). `elem` is the texel type of `stack` and `light`:
// sweep::kElemF32 or sweep::kElemBF16 (anything else is refused with
// cudaErrorInvalidValue). `light` is the (S, A, B) light-transmittance
// stack in the stack's layer order and type, or null for no light volume
// (emission only). `out` is (4, Hb, Wb) float32: acc, trans, wsum, hit.
// `cap` is the stage: texel slots per window buffer (0 reads every
// tile-slice through global memory); the launch takes 16 * S + (light ? 4
// : 2) * cap * 4 bytes of dynamic shared memory. `counts`, if not null, is the
// (2,) int64 tile-slice tally (sweep_tile.cuh kCountDone, kCountGlobal),
// added to.
extern "C" int sweep_fwd_launch(const void* stack, const void* light,
                                const float* slice_z, const float* v_grid,
                                const float* u_grid, const float* seglen,
                                const float* params, float* out, int S, int A,
                                int B, int Hb, int Wb, int emission, int flip,
                                int wrap, int elem, int cap, void* counts,
                                void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned long long* cnt = static_cast<unsigned long long*>(counts);
  if (elem == sweep::kElemF32)
    return launch<float>(stack, light, slice_z, v_grid, u_grid, seglen,
                         params, out, S, A, B, Hb, Wb, emission, flip, wrap,
                         cap, cnt, st);
  if (elem == sweep::kElemBF16)
    return launch<__nv_bfloat16>(stack, light, slice_z, v_grid, u_grid,
                                 seglen, params, out, S, A, B, Hb, Wb,
                                 emission, flip, wrap, cap, cnt, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
