// The tiled schedule of the 4-channel reference-medium kernels K4
// (sweep_ref_fwd.cu) and K5 (sweep_ref_bwd.cu): sweep_tile.cuh's tile,
// slice range, per-line taps, cp.async stage and warp-summed scatter, with
// one tap window per channel (and one for the light slabs).
//
// Channel windows in unmirrored index space. Channel c taps at
// q = x01 * sc_c + off_c, t = floor(q * n - 0.5), and its two texels are
// t and t + 1 reflected with period 2n (chan_tap, mirror_index). x01 maps
// to t in order under float32 rounding (increasing for sc > 0, decreasing
// for sc < 0), so the channel taps of a tile-slice's in-box lines lie in
// the unmirrored range [lo, hi + 1] spanned by the taps of its first and
// last line, each clamped to the box first: chan_span. The window holds
// that range slot by slot, slot m the texel mirror_index(lo + m, n), as
// K1's wrap window holds slot m modulo n. A line's window offsets are then
// t - lo and t + 1 - lo, with no mirror in the sample loop, and the sample
// is the same four texels with the same weights, summed in the same order:
// K4's maps are the per-pixel kernel's bit for bit and K5's replay of T is
// K4's. Where the range crosses a fold two slots hold one texel (-1 and 0
// both hold texel 0); reads do not care, and K5's flush adds both slots to
// that texel with its atomicAdd. The light slabs are sampled at the
// unscaled, clipped taps (sweep::sample_taps), so their window is K1's
// (axis_span with clipping), a fifth window.
//
// The window table. Per slice NW int4 (NW = 4 windows, 5 with light), each
// (lo_a, lo_b, rows << 16 | cols, delta's bits), all zero for an inactive
// slice: 16 * NW * S bytes of shared memory, 8 KB at the reference preset
// (S = 128, no light) and 20 KB at S = 256 with light. The stage and K5's
// accumulation windows come on top: with the preset's largest windows (14
// x 14 slots) a CTA of K4 takes ~18 KB of shared memory and one of K5 ~56
// KB (its eight warps' windows, and the per-pixel constants it keeps
// there), so the three CTAs an SM that their registers allow fit in its
// 227 KB (sweep_ref_fwd.cu, _bwd.cu).
//
// The stage. One buffer of `cap` 4-byte slots per window, double-buffered;
// a tile-slice is staged when each of its windows fits `cap`, else all its
// samples read (and K5 scatters) through global memory at the same taps,
// and the kernels count it. The slots of the NW windows are numbered as
// one run (for_each_slot) and handed out to the threads in order, so the
// copies of a slice (4 x 36 to 4 x 196 slots at the reference preset)
// take the fewest warps whatever the windows' shapes; a slot's row in its
// window is found with a float reciprocal (exact for the few thousand
// slots a stage holds), not an integer division. A bfloat16 slot is copied
// as the aligned word that holds its texel; the copying thread keeps which
// half in a bit of a 64-bit mask and widens the slot from it once the copy
// has landed, without recomputing the address. The host caps a stage at 64
// slots a thread (kMaxSlots).
//
// Lines. Per active slice one thread per (channel, tile column) and one per
// (channel, tile row) computes the line's taps and rounded weights:
// 4 x 32 + 4 x 32 = 256 lines, one a thread; with light threadIdx.y 0 and 1
// also make the light window's 32 + 32 (make_line, K1's).
#pragma once

#include "sweep_ref_common.cuh"
#include "sweep_tile.cuh"

namespace sweep {
namespace tile {
namespace ref {

constexpr int kLightWin = NCH;  // the light's window follows the channels'
constexpr int kMaxSlots = 64 * kThreads;  // staged slots of a tile-slice

template <bool kLight>
constexpr int kWindows = kLight ? NCH + 1 : NCH;

// One window of a tile-slice: its origin (unmirrored for a channel,
// clipped for the light) and its extent.
struct Win {
  int a_lo, b_lo, rows, cols;
};

__device__ __forceinline__ Win win_at(const int4* tab, int NW, int s,
                                      int w) {
  const int4 e = tab[s * NW + w];
  return Win{e.x, e.y, e.z >> 16, e.z & 0xffff};
}

// A channel's unmirrored tap range [lo, hi] along one axis of a
// tile-slice, from the coordinates of the tile's first and last line
// clamped to the box.
__device__ __forceinline__ Span chan_span(float e, float delta, float q0,
                                          float q1, float sc, float off,
                                          int n) {
  const float x0 = e + delta * q0;
  const float x1 = e + delta * q1;
  const float lo = fminf(x0, x1), hi = fmaxf(x0, x1);
  Span sp;
  sp.any = hi >= 0.f && lo <= 1.f;
  float f;
  const int t0 = chan_tap(fminf(fmaxf(lo, 0.f), 1.f), sc, off, n, f);
  const int t1 = chan_tap(fminf(fmaxf(hi, 0.f), 1.f), sc, off, n, f);
  sp.lo = min(t0, t1);
  sp.hi = max(t0, t1) + 1;
  return sp;
}

__device__ __forceinline__ int4 table_entry(const Span& ra, const Span& rb,
                                            float delta) {
  return make_int4(ra.lo, rb.lo,
                   ((ra.hi - ra.lo + 1) << 16) | (rb.hi - rb.lo + 1),
                   __float_as_int(delta));
}

// Fills the CTA's window table, NW entries per slice: the NCH channel
// windows, then (NW > NCH) the light's. The caller synchronises before
// reading it.
template <int NW>
__device__ __forceinline__ void fill_windows(
    int4* tab, const Params& P, const RefParams& R,
    const float* __restrict__ slice_z, const float* __restrict__ v_grid,
    const float* __restrict__ u_grid, int S, int A, int B, int Hb, int Wb,
    int tid) {
  const int r0 = tile_row0(), c0 = tile_col0();
  const float v0 = v_grid[r0], v1 = v_grid[min(r0 + kRows, Hb) - 1];
  const float u0 = u_grid[c0], u1 = u_grid[min(c0 + kCols, Wb) - 1];
  for (int s = tid; s < S; s += kThreads) {
    const float delta = slice_z[s] - P.e_k;
    bool on = false;
    Span ra{0, 0, false}, rb{0, 0, false};
    if (in_front(P, delta)) {
      ra = axis_span(P.e_a, delta, v0, v1, A, 0);
      rb = axis_span(P.e_b, delta, u0, u1, B, 0);
      on = ra.any && rb.any;
    }
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      int4 e = make_int4(0, 0, 0, 0);
      if (on)
        e = table_entry(
            chan_span(P.e_a, delta, v0, v1, R.sc[c], R.offa[c], A),
            chan_span(P.e_b, delta, u0, u1, R.sc[c], R.offb[c], B), delta);
      tab[s * NW + c] = e;
    }
    if (NW > NCH)
      tab[s * NW + kLightWin] =
          on ? table_entry(ra, rb, delta) : make_int4(0, 0, 0, 0);
  }
}

// The first active slice at or after s, or S.
__device__ __forceinline__ int next_active(const int4* tab, int NW, int s,
                                           int S) {
  while (s < S && tab[s * NW].z == 0) ++s;
  return s;
}

// Whether every window of active slice s fits `cap` slots.
template <int NW>
__device__ __forceinline__ bool staged_at(const int4* tab, int s, int cap) {
  bool ok = true;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const Win x = win_at(tab, NW, s, w);
    ok = ok && x.rows * x.cols <= cap;
  }
  return ok;
}

// Calls fn(w, m, k, texel) for this thread's slots of slice s's windows:
// the windows' slots numbered as one run, slot tid + 256 k of the run
// being slot m of window w, which holds texel `texel` of its (A, B) layer
// (mirrored for a channel window; the light window is clipped already).
template <int NW, typename F>
__device__ __forceinline__ void for_each_slot(const int4* tab, int s, int A,
                                              int B, int tid, F&& fn) {
  int total = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const Win x = win_at(tab, NW, s, w);
    total += x.rows * x.cols;
  }
  int w = 0, first = 0;
  Win x = win_at(tab, NW, s, 0);
  int n = x.rows * x.cols;
  float inv = 1.f / (float)x.cols;
  int k = 0;
  for (int mf = tid; mf < total; mf += kThreads, ++k) {
    while (mf >= first + n) {
      first += n;
      ++w;
      x = win_at(tab, NW, s, w);
      n = x.rows * x.cols;
      inv = 1.f / (float)x.cols;
    }
    const int m = mf - first;
    const int r = (int)(((float)m + 0.5f) * inv);
    int a = x.a_lo + r, b = x.b_lo + (m - r * x.cols);
    if (w < NCH) {
      a = mirror_index(a, A);
      b = mirror_index(b, B);
    }
    fn(w, m, k, (size_t)a * B + b);
  }
}

// Issues the copies of slice s's windows into `dst` (window w at dst + w
// * cap). `L` is the (S, NCH, A, B) slab stack, `light` the (S, A, B)
// light slabs (read when NW > NCH). For bfloat16, `half` gets which half
// of each copied word is the texel, bit k for this thread's k-th slot.
template <int NW, typename T>
__device__ __forceinline__ void stage_windows(
    float* dst, int cap, const int4* tab, int s, const T* __restrict__ L,
    const T* __restrict__ light, int A, int B, int tid,
    unsigned long long& half) {
  const size_t layer = (size_t)A * B;
  half = 0ull;
  for_each_slot<NW>(tab, s, A, B, tid,
                    [&](int w, int m, int k, size_t texel) {
    const T* p = (w < NCH ? L + ((size_t)s * NCH + w) * layer
                          : light + (size_t)s * layer) + texel;
    copy_slot(dst + w * cap + m, slot_source(p));
    if (sizeof(T) == 2)
      half |= (unsigned long long)((reinterpret_cast<uintptr_t>(p) >> 1) &
                                   1u) << k;
  });
}

// After the copy has landed: each bfloat16 slot keeps its texel's half of
// the word, widened, by the thread that copied it. Float slots are the
// texels.
template <int NW, typename T>
__device__ __forceinline__ void widen_windows(float* dst, int cap,
                                              const int4* tab, int s, int A,
                                              int B, int tid,
                                              unsigned long long half) {
  if (sizeof(T) != 2) return;
  for_each_slot<NW>(tab, s, A, B, tid, [&](int w, int m, int k, size_t) {
    float* slot = dst + w * cap + m;
    const unsigned word = __float_as_uint(*slot);
    *slot = __uint_as_float(((half >> k) & 1ull) ? (word & 0xffff0000u)
                                                 : (word << 16));
  });
}

// Adds the kGroups warps' accumulation windows (window w of warp g at acc
// + (w * kGroups + g) * cap) to dL[s, w] (dlight[s] for the light window),
// one atomicAdd per nonzero slot, and zeroes them for their next use.
template <int NW>
__device__ __forceinline__ void flush_windows(float* acc, int cap,
                                              const int4* tab, int s,
                                              float* dL, float* dlight,
                                              int A, int B, int tid) {
  const size_t layer = (size_t)A * B;
  for_each_slot<NW>(tab, s, A, B, tid,
                    [&](int w, int m, int, size_t texel) {
    float v = 0.f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      float* slot = acc + (w * kGroups + g) * cap + m;
      v += *slot;
      *slot = 0.f;
    }
    if (v != 0.f)
      atomicAdd((w < NCH ? dL + ((size_t)s * NCH + w) * layer
                         : dlight + (size_t)s * layer) + texel, v);
  });
}

// The Line of a channel's coordinate x01 * sc + off on an axis of n
// texels (make_line's contract): window-relative offsets t - lo and
// t + 1 - lo when staged (the clamp only guards shared memory against a
// plan whose slopes are not monotone), else the mirrored texels' offsets
// in the layer. o0 < 0: the unscaled x01 leaves the box.
template <typename T>
__device__ __forceinline__ Line make_chan_line(float x01, float sc,
                                               float off, int n, bool staged,
                                               int lo, int extent,
                                               int win_stride,
                                               int layer_stride) {
  Line l;
  if (!(x01 >= 0.f && x01 <= 1.f)) {
    l.o0 = l.o1 = -1;
    l.w0 = l.w1 = 0.f;
    return l;
  }
  float f;
  const int t = chan_tap(x01, sc, off, n, f);
  if (staged) {
    l.o0 = min(max(t - lo, 0), extent - 1) * win_stride;
    l.o1 = min(max(t + 1 - lo, 0), extent - 1) * win_stride;
  } else {
    l.o0 = mirror_index(t, n) * layer_stride;
    l.o1 = mirror_index(t + 1, n) * layer_stride;
  }
  l.w0 = round_weight<T>(1.f - f);
  l.w1 = round_weight<T>(f);
  return l;
}

__device__ __forceinline__ Runs unpack_runs(int p) {
  return Runs{p & 31, (p >> 5) & 31, ((p >> 10) & 1) != 0,
              ((p >> 11) & 1) != 0};
}

// runs_of's result and the warp's longest run of lanes on one texel (of
// tap 0 or tap 1), `span`, in one int: start0, start1 (5 bits each),
// last0, last1, span (6 bits). The warp that made the column lines calls
// it, every lane.
__device__ __forceinline__ int pack_runs(const Line& c) {
  const Runs q = runs_of(c);
  const int lane = threadIdx.x;
  const unsigned h0 = __ballot_sync(kFull, lane == q.start0);
  const unsigned h1 = __ballot_sync(kFull, lane == q.start1);
  const unsigned above = ~((2u << lane) - 1u);  // lanes lane + 1 .. 31
  const auto len = [&](unsigned h) {
    const unsigned next = h & above;
    return ((h >> lane) & 1u) ? (next ? __ffs(next) - 1 : 32) - lane : 0;
  };
  const int span = (int)__reduce_max_sync(
      kFull, (unsigned)max(len(h0), len(h1)));
  return q.start0 | (q.start1 << 5) | ((int)q.last0 << 10) |
         ((int)q.last1 << 11) | (span << 12);
}

__device__ __forceinline__ int unpack_span(int p) { return p >> 12; }

// The tile's Line records of active slice s: cols[w * kCols + x] and
// rows[w * kRows + x] for window w. Thread row y < NCH makes channel y's
// column lines, y >= NCH channel y - NCH's row lines; with light, rows 0
// and 1 also make the light window's. With `runs` (K5), the warp that made
// a window's column lines also writes their runs of lanes (pack_runs) to
// runs[w * kCols + x], once for the eight warps that scatter with them.
// The caller synchronises before they are read.
template <bool kLight, typename T>
__device__ __forceinline__ void make_lines(
    Line* rows, Line* cols, int* runs, const Params& P,
    const float* __restrict__ prm, const int4* tab, int s, bool staged,
    float delta, const float* __restrict__ v_grid,
    const float* __restrict__ u_grid, int A, int B, int Hb, int Wb) {
  constexpr int NW = kWindows<kLight>;
  const int y = threadIdx.y, x = threadIdx.x;
  const int j = tile_col0() + x, i = tile_row0() + x;
  const Line none{-1, -1, 0.f, 0.f};
  if (y < NCH) {
    const Win w = win_at(tab, NW, s, y);
    const Line l =
        j < Wb ? make_chan_line<T>(P.e_b + delta * u_grid[j], prm[8 + y],
                                   prm[12 + y], B, staged, w.b_lo, w.cols, 1,
                                   1)
               : none;
    cols[y * kCols + x] = l;
    if (runs) runs[y * kCols + x] = pack_runs(l);
  } else {
    const int c = y - NCH;
    const Win w = win_at(tab, NW, s, c);
    rows[c * kRows + x] =
        i < Hb ? make_chan_line<T>(P.e_a + delta * v_grid[i], prm[8 + c],
                                   prm[16 + c], A, staged, w.a_lo, w.rows,
                                   w.cols, B)
               : none;
  }
  if constexpr (kLight) {
    const Win w = win_at(tab, NW, s, kLightWin);
    if (y == 0) {
      const Line l = j < Wb ? make_line<T>(P.e_b + delta * u_grid[j], B, 0,
                                           staged, w.b_lo, w.cols, 1, 1)
                            : none;
      cols[kLightWin * kCols + x] = l;
      if (runs) runs[kLightWin * kCols + x] = pack_runs(l);
    } else if (y == 1) {
      rows[kLightWin * kRows + x] =
          i < Hb ? make_line<T>(P.e_a + delta * v_grid[i], A, 0, staged,
                                w.a_lo, w.rows, w.cols, B)
                 : none;
    }
  }
}

// Dynamic shared memory of a launch: the NW-entry window table of S
// slices, then `buffers` windows of `cap` float slots.
inline size_t smem_bytes(int S, int NW, int buffers, int cap) {
  return (size_t)S * NW * sizeof(int4) +
         (size_t)buffers * (size_t)cap * sizeof(float);
}

}  // namespace ref
}  // namespace tile
}  // namespace sweep
