// The tiled schedule of the single-channel slice-sweep kernels K1
// (sweep_fwd.cu) and K2 (sweep_bwd.cu): one CTA per base tile of
// kRows x kCols pixels, the tile's tap window of each slice staged in shared
// memory ahead of use, and the bilinear taps computed once per line.
//
// The tile. 256 threads, threadIdx.x the tile column (a warp is one row of
// the tile), threadIdx.y one of 8 row groups; a thread holds the carries of
// kPix = 4 pixels of its column, rows threadIdx.y + 8 * q. The tile's
// threads walk the slices front to back together.
//
// The tile-slice window. v_grid and u_grid are monotone (tan of increasing
// angles, ops/sweep.py), and e + delta * q and floor(x * n - 0.5) keep that
// order under float32 rounding. So on slice s every in-box tap of the tile
// lies between the taps of its first and last row (column), each clamped to
// [0, 1] first: for mirror and clamp, the clipped index range [lo, hi]; for
// wrap, the unwrapped range, read modulo n. A slice where the tile has no
// row or no column in the box, or which lies behind the eye, is inactive.
// The CTA's threads compute the windows of all S slices once, into a table
// in shared memory, and the walk skips inactive slices with no work and no
// barrier: that is the tile's slice range. The host mirror of this
// arithmetic (kernels/build.py tile_spans) sizes the stage and is held to
// the sample taps by the CPU tests.
//
// Per-line taps. On slice s the row taps (a0, a1, fa) depend on (s, row)
// only and the column taps (b0, b1, fb) on (s, column) only: a01 = e_a +
// delta * v[i], b01 = e_b + delta * u[j]. One thread per row and one per
// column compute them (floor_tap: sweep_common.cuh's axis_taps, the same
// float32 expressions) into a Line record in shared memory, with the
// bilinear weights already rounded as round_weight<T> rounds them; every
// pixel of the line reads it. A sample is then four texel reads and the
// float32 sum of bilinear_at<T>, in the same order, so K1's outputs and
// K2's replay of T are the per-pixel kernels' bit for bit.
//
// The stage. The window of the layer k (k = S - 1 - s with flip) is copied
// into shared memory with cp.async, 4 bytes a texel slot, double-buffered:
// the copy for the tile's next active slice is issued before the present
// one is computed. A bfloat16 texel is copied as the aligned 4-byte word
// that holds it and widened in place, by the thread that copied it, once
// the copy has landed. A tile-slice whose window holds more texels than the
// stage (`cap`, sized by the host from the plan) reads the stack through
// global memory instead, at the same taps and with the same arithmetic; the
// kernels count those tile-slices.
//
// K2's scatter. The lanes of a warp (one tile row, 32 neighbouring columns)
// share their row taps, and their column taps fall on a few texels in runs
// of neighbouring lanes. warp_scatter adds each run's contributions with
// warp shuffles, as many rounds as the slice's longest run needs, and the
// run's last lane adds the sums to the global gradient layer with
// atomicAdd, staged tile-slice or not: the stage holds the texels K2
// reads, not the sums it writes.
#pragma once

#include <stdint.h>
#include <string.h>

#include "sweep_common.cuh"

namespace sweep {
namespace tile {

constexpr int kCols = 32;          // base columns per tile (threadIdx.x)
constexpr int kGroups = 8;         // row groups (threadIdx.y), one warp each
constexpr int kPix = 4;            // pixels per thread
constexpr int kRows = kGroups * kPix;
constexpr int kThreads = kCols * kGroups;
constexpr unsigned kFull = 0xffffffffu;

// The C launchers' `counts` (2,) int64: tile-slices computed, and of those
// the ones that read through global memory.
constexpr int kCountDone = 0;
constexpr int kCountGlobal = 1;

// cp.async of one 4-byte slot; the host build (no __CUDA_ARCH__) copies.
__device__ __forceinline__ void copy_slot(float* dst, const void* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
#else
  memcpy(dst, src, 4);
#endif
}

__device__ __forceinline__ void copy_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

// Waits until at most one committed group (the newest) is in flight.
__device__ __forceinline__ void copy_wait_prior() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group 1;\n" ::);
#endif
}

__device__ __forceinline__ void copy_wait_all() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::);
#endif
}

// axis_taps' arithmetic without the address mode: the unwrapped tap
// floor(x01 * n - 0.5) and its fraction, the same float32 expressions.
__device__ __forceinline__ int floor_tap(float x01, int n, float& f) {
  const float p = x01 * (float)n - 0.5f;
  const float p0 = floorf(p);
  f = p - p0;
  return (int)p0;
}

// One axis of a tile-slice: the window's index range [lo, hi] (clipped for
// mirror and clamp, unwrapped for wrap) and whether any line can be in the
// box, from the coordinates of the tile's first and last line.
struct Span {
  int lo, hi;
  bool any;
};

__device__ __forceinline__ Span axis_span(float e, float delta, float q0,
                                          float q1, int n, int wrap) {
  const float x0 = e + delta * q0;
  const float x1 = e + delta * q1;
  const float lo = fminf(x0, x1), hi = fmaxf(x0, x1);
  Span sp;
  sp.any = hi >= 0.f && lo <= 1.f;
  float f;
  const int t_lo = floor_tap(fminf(fmaxf(lo, 0.f), 1.f), n, f);
  const int t_hi = floor_tap(fminf(fmaxf(hi, 0.f), 1.f), n, f) + 1;
  sp.lo = wrap ? t_lo : clip_index(t_lo, n);
  sp.hi = wrap ? t_hi : clip_index(t_hi, n);
  return sp;
}

// The tile's first base row and column.
__device__ __forceinline__ int tile_row0() { return blockIdx.y * kRows; }
__device__ __forceinline__ int tile_col0() { return blockIdx.x * kCols; }

// Fills the CTA's window table, one int4 per slice: (a_lo, b_lo, rows <<
// 16 | cols, delta's bits), or all zero for an inactive slice. The caller
// synchronises before reading it.
__device__ __forceinline__ void fill_windows(
    int4* tab, const Params& P, const float* __restrict__ slice_z,
    const float* __restrict__ v_grid, const float* __restrict__ u_grid,
    int S, int A, int B, int Hb, int Wb, int wrap, int tid) {
  const int r0 = tile_row0(), c0 = tile_col0();
  const float v0 = v_grid[r0], v1 = v_grid[min(r0 + kRows, Hb) - 1];
  const float u0 = u_grid[c0], u1 = u_grid[min(c0 + kCols, Wb) - 1];
  for (int s = tid; s < S; s += kThreads) {
    const float delta = slice_z[s] - P.e_k;
    int4 e = make_int4(0, 0, 0, 0);
    if (in_front(P, delta)) {
      const Span ra = axis_span(P.e_a, delta, v0, v1, A, wrap);
      const Span rb = axis_span(P.e_b, delta, u0, u1, B, wrap);
      if (ra.any && rb.any) {
        e.x = ra.lo;
        e.y = rb.lo;
        e.z = ((ra.hi - ra.lo + 1) << 16) | (rb.hi - rb.lo + 1);
        e.w = __float_as_int(delta);
      }
    }
    tab[s] = e;
  }
}

// The first active slice at or after s, or S.
__device__ __forceinline__ int next_active(const int4* tab, int s, int S) {
  while (s < S && tab[s].z == 0) ++s;
  return s;
}

// One active tile-slice: its slice s and layer k, its window's origin and
// extent, whether the window is staged (fits `cap`) or read through global
// memory, and delta = slice_z[s] - e_k.
struct Window {
  int s, k, a_lo, b_lo, rows, cols;
  bool staged;
  float delta;
};

__device__ __forceinline__ Window window_at(const int4* tab, int s, int S,
                                            int flip, int cap) {
  const int4 e = tab[s];
  Window w;
  w.s = s;
  w.k = flip ? S - 1 - s : s;
  w.a_lo = e.x;
  w.b_lo = e.y;
  w.rows = e.z >> 16;
  w.cols = e.z & 0xffff;
  w.staged = w.rows * w.cols <= cap;
  w.delta = __int_as_float(e.w);
  return w;
}

// The texel of an (A, B) layer that window slot m holds.
__device__ __forceinline__ size_t slot_texel(const Window& w, int m, int A,
                                             int B, int wrap) {
  const int r = m / w.cols;
  const int c = m - r * w.cols;
  int a = w.a_lo + r, b = w.b_lo + c;
  if (wrap) {
    a = wrap_index(a, A);
    b = wrap_index(b, B);
  }
  return (size_t)a * B + b;
}

// The 4-byte aligned word that holds texel p.
__device__ __forceinline__ const void* slot_source(const float* p) {
  return p;
}

__device__ __forceinline__ const void* slot_source(const __nv_bfloat16* p) {
  return reinterpret_cast<const char*>(p) -
         (reinterpret_cast<uintptr_t>(p) & 2);
}

// Issues the copy of the window of `layer` into `dst`, one slot a texel:
// slot m by thread m % 256, so a small window takes few warps.
template <typename T>
__device__ __forceinline__ void stage_window(float* dst, const T* layer,
                                             const Window& w, int A, int B,
                                             int wrap, int tid) {
  const int n = w.rows * w.cols;
  for (int m = tid; m < n; m += kThreads)
    copy_slot(dst + m, slot_source(layer + slot_texel(w, m, A, B, wrap)));
}

// After the copy has landed: a bfloat16 slot holds the aligned word of its
// texel; keep the texel's half, widened. The float slots are the texels.
// Each thread widens the slots it copied.
template <typename T>
__device__ __forceinline__ void widen_window(float*, const T*, const Window&,
                                             int, int, int, int) {}

template <>
__device__ __forceinline__ void widen_window<__nv_bfloat16>(
    float* dst, const __nv_bfloat16* layer, const Window& w, int A, int B,
    int wrap, int tid) {
  const int n = w.rows * w.cols;
  for (int m = tid; m < n; m += kThreads) {
    const uintptr_t addr =
        reinterpret_cast<uintptr_t>(layer + slot_texel(w, m, A, B, wrap));
    const unsigned word = __float_as_uint(dst[m]);
    dst[m] = __uint_as_float((addr & 2) ? (word & 0xffff0000u)
                                        : (word << 16));
  }
}

// The taps of one line of a tile-slice: offsets of tap 0 and tap 1 (a
// row's pre-multiplied by its stride) into the staged window or, for a
// tile-slice read through global memory, into the (A, B) layer; and the
// two weights as round_weight<T> holds them. o0 < 0: the line leaves the
// box, its samples are skipped.
struct Line {
  int o0, o1;
  float w0, w1;
};

// The Line of coordinate x01 on an axis of n texels. lo, extent: the
// window's origin and size along the axis; win_stride, layer_stride: the
// offset of one step along it in the window and in the layer.
template <typename T>
__device__ __forceinline__ Line make_line(float x01, int n, int wrap,
                                          bool staged, int lo, int extent,
                                          int win_stride, int layer_stride) {
  Line l;
  if (!(x01 >= 0.f && x01 <= 1.f)) {
    l.o0 = l.o1 = -1;
    l.w0 = l.w1 = 0.f;
    return l;
  }
  float f;
  const int t = floor_tap(x01, n, f);
  if (staged) {
    // Window-relative; the clamp only guards shared memory against a plan
    // whose slopes are not monotone (plan_sweep's always are).
    const int i0 = (wrap ? t : clip_index(t, n)) - lo;
    const int i1 = (wrap ? t + 1 : clip_index(t + 1, n)) - lo;
    l.o0 = min(max(i0, 0), extent - 1) * win_stride;
    l.o1 = min(max(i1, 0), extent - 1) * win_stride;
  } else {
    l.o0 = (wrap ? wrap_index(t, n) : clip_index(t, n)) * layer_stride;
    l.o1 = (wrap ? wrap_index(t + 1, n) : clip_index(t + 1, n)) *
           layer_stride;
  }
  l.w0 = round_weight<T>(1.f - f);
  l.w1 = round_weight<T>(f);
  return l;
}

// The tile's Line records of slice w: one thread per column (threadIdx.y
// 0) and one per row (threadIdx.y 1). The caller synchronises before they
// are read.
template <typename T>
__device__ __forceinline__ void make_lines(
    Line* rows, Line* cols, const Params& P, const Window& w,
    const float* __restrict__ v_grid, const float* __restrict__ u_grid,
    int A, int B, int Hb, int Wb, int wrap) {
  const int y = threadIdx.y, x = threadIdx.x;
  if (y == 0) {
    const int j = tile_col0() + x;
    cols[x] = j < Wb ? make_line<T>(P.e_b + w.delta * u_grid[j], B, wrap,
                                    w.staged, w.b_lo, w.cols, 1, 1)
                     : Line{-1, -1, 0.f, 0.f};
  } else if (y == 1) {
    const int i = tile_row0() + x;
    rows[x] = i < Hb ? make_line<T>(P.e_a + w.delta * v_grid[i], A, wrap,
                                    w.staged, w.a_lo, w.rows, w.cols, B)
                     : Line{-1, -1, 0.f, 0.f};
  }
}

// The bilinear sample at a row and a column Line: from the staged window
// (kShared) or the global layer of texel type T. bilinear_at<T>'s products
// and sums in its order, so the same float.
template <bool kShared, typename T>
__device__ __forceinline__ float tap_sum(const void* base, const Line& r,
                                         const Line& c) {
  float g00, g01, g10, g11;
  if constexpr (kShared) {
    const float* p = static_cast<const float*>(base);
    g00 = p[r.o0 + c.o0];
    g01 = p[r.o0 + c.o1];
    g10 = p[r.o1 + c.o0];
    g11 = p[r.o1 + c.o1];
  } else {
    const T* p = static_cast<const T*>(base);
    g00 = load_texel(p + r.o0 + c.o0);
    g01 = load_texel(p + r.o0 + c.o1);
    g10 = load_texel(p + r.o1 + c.o0);
    g11 = load_texel(p + r.o1 + c.o1);
  }
  return r.w0 * (c.w0 * g00 + c.w1 * g01) + r.w1 * (c.w0 * g10 + c.w1 * g11);
}

// light_shade with the light sample taken at the Lines.
__device__ __forceinline__ float shade_of(float lT, float ambient) {
  return ambient + (1.f - ambient) * fminf(fmaxf(lT, 0.f), 1.f);
}

// light_shade_adjoint's dlT.
__device__ __forceinline__ float shade_grad(float lT, float ambient,
                                            float cw, float trans,
                                            float alpha) {
  const float clip_g = (lT > 0.f && lT < 1.f)
                           ? 1.f
                           : ((lT == 0.f || lT == 1.f) ? 0.5f : 0.f);
  return cw * trans * alpha * (1.f - ambient) * clip_g;
}

// The runs of neighbouring lanes of a warp whose column tap 0 (tap 1) is
// the same texel: the first lane of this lane's run, and whether this lane
// is the run's last. They depend on the column Line only, so a slice
// computes them once for all its pixels and both gradients. Every lane of
// the warp calls it.
struct Runs {
  int start0, start1;
  bool last0, last1;
};

__device__ __forceinline__ Runs runs_of(const Line& c) {
  const int lane = threadIdx.x;
  const unsigned below = kFull >> (31 - lane);  // lanes 0 .. lane
  const int up0 = __shfl_up_sync(kFull, c.o0, 1);
  const int up1 = __shfl_up_sync(kFull, c.o1, 1);
  const int dn0 = __shfl_down_sync(kFull, c.o0, 1);
  const int dn1 = __shfl_down_sync(kFull, c.o1, 1);
  const unsigned h0 = __ballot_sync(kFull, lane == 0 || up0 != c.o0);
  const unsigned h1 = __ballot_sync(kFull, lane == 0 || up1 != c.o1);
  Runs q;
  q.start0 = 31 - __clz(h0 & below);
  q.start1 = 31 - __clz(h1 & below);
  q.last0 = lane == 31 || dn0 != c.o0;
  q.last1 = lane == 31 || dn1 != c.o1;
  return q;
}

// bilinear_adjoint<T>'s scatter of du at a row and a column Line, for the
// whole warp: the row is the warp's own; warp shuffles sum du * wb0 over
// each run of lanes on one column tap 0, and du * wb1 on one tap 1, and
// each run's last lane adds its sums once. kAtomic: into the global
// gradient layer with atomicAdd; else into the warp's own shared
// accumulation window with plain adds. Lanes without a sample pass du = 0.
// `span`: no run of the warp is longer, so the sums stop at that distance
// (K4/K5 pass it; K1/K2 take 32). Every lane of the warp calls it.
template <bool kAtomic>
__device__ __forceinline__ void warp_scatter(float* base, const Line& r,
                                             const Line& c, const Runs& q,
                                             float du, int span = 32) {
  const int lane = threadIdx.x;
  float s0 = du * c.w0, s1 = du * c.w1;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    if (d >= span) break;
    const float o0 = __shfl_up_sync(kFull, s0, d);
    const float o1 = __shfl_up_sync(kFull, s1, d);
    if (lane - d >= q.start0) s0 += o0;
    if (lane - d >= q.start1) s1 += o1;
  }
  if (q.last0 && c.o0 >= 0 && s0 != 0.f) {
    if constexpr (kAtomic) {
      atomicAdd(base + r.o0 + c.o0, r.w0 * s0);
      atomicAdd(base + r.o1 + c.o0, r.w1 * s0);
    } else {
      base[r.o0 + c.o0] += r.w0 * s0;
      base[r.o1 + c.o0] += r.w1 * s0;
    }
  }
  __syncwarp();  // a tap-1 run may end on the texel of a tap-0 run
  if (q.last1 && c.o1 >= 0 && s1 != 0.f) {
    if constexpr (kAtomic) {
      atomicAdd(base + r.o0 + c.o1, r.w0 * s1);
      atomicAdd(base + r.o1 + c.o1, r.w1 * s1);
    } else {
      base[r.o0 + c.o1] += r.w0 * s1;
      base[r.o1 + c.o1] += r.w1 * s1;
    }
  }
  __syncwarp();
}

// Dynamic shared memory of a launch: the S-entry window table, then
// `buffers` windows of `cap` float slots.
inline size_t smem_bytes(int S, int buffers, int cap) {
  return (size_t)S * sizeof(int4) +
         (size_t)buffers * (size_t)cap * sizeof(float);
}

// The static shared memory of K1 and K2: their rows_l and cols_l Line
// records (sweep_fwd.cu, sweep_bwd.cu; K2 counts its layer offsets
// besides). The 48 KB default covers static and dynamic together, so
// allow_smem must count these too.
constexpr size_t kStaticSmem = (kRows + kCols) * sizeof(Line);

// Allows a kernel more than the default 48 KB of shared memory: `bytes`
// of dynamic shared memory beside `static_bytes` of static.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes,
                              size_t static_bytes = 0) {
  if (bytes + static_bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace tile
}  // namespace sweep
