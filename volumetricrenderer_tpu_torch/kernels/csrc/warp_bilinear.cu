// The screen warp of the slice sweep for Hopper (sm_90a): the bilinear
// gather from the base grid to the camera pixels with its miss select, and
// its adjoint, the splat of the pixel cotangents into the base grid; one
// kernel each way.
//
// It replaces no Pallas kernel. The JAX package's warp is plain XLA, a
// custom VJP (volumetricrenderer_tpu/ops/sweep.py _warp_bilinear :1097,
// its backward _splat_windowed :1130) around a windowed gather. The port
// ran it as torch ops in ops/sweep.py _WarpBilinear: the taps' arithmetic,
// four advanced-indexing gathers, the products and a torch.where, about 25
// launches forward; four index_add_ and their products backward, about 35.
// Those index_add_ added every pixel, the out-of-footprint ones too, whose
// cotangent the miss select makes exactly zero: at 512^3 and 1920x1080
// from (3, 3, 3), 73 % of the adds, tens of thousands of them piled on one
// clamped edge texel by each index_add_.
//
// The function (the plain version is kernels/warp_bilinear.py
// warp_reference and splat_reference). For a base (Hb, Wb, C) and a pixel
// at (q_r, q_c) = (rows01, cols01), along each axis of n texels the
// clip-then-tent taps
//   p = clamp(q * n - 0.5, 0, n - 1),  i0 = floor(p),
//   i1 = min(i0 + 1, n - 1),  f = p - i0
// and per channel
//   out = (1 - fc) * ((1 - fr) * b00 + fr * b10)
//         + fc * ((1 - fr) * b01 + fr * b11)
// with b_rc = base[i_r, i_c]; where `miss` is given, a pixel outside the
// footprint (q_r or q_c outside [0, 1]) takes miss[ch] instead. Each
// multiply and add is its own correctly rounded intrinsic, in the plain
// version's order (and the build's --fmad=false contracts nothing), so
// the forward equals the plain version's torch ops on the card bit for bit.
// The adjoint adds ct * (1 - fc) * (1 - fr) to b00, ct * (1 - fc) * fr to
// b10, ct * fc * (1 - fr) to b01 and ct * fc * fr to b11, the products
// formed in the plain version's order; where `miss` was given, an
// out-of-footprint pixel adds nothing (its cotangent through the select is
// zero, so it only ever added +-0). The adds are float atomics: a texel's
// sum follows the order they land in, and so is not reproducible bit for
// bit from run to run, as the index_add_ splat before it.
//
// What bounds it. Each way moves 16 B a pixel at C = 2 (the two coordinate
// maps; the two output channels or the two cotangents) and the base once
// (Hb * Wb * C * 4 B): 52 MB at 1920x1080 on a 1536^2 base, 0.016 ms at
// 3.35 TB/s. About 20 operations a pixel is far below the card's 20 a
// byte: bytes bound it, and latency, since each pixel's four taps are
// gathers. The design:
//   - one thread a pixel, consecutive threads on consecutive pixels, so
//     the maps, the output and the cotangents move as whole lines; the
//     taps of neighbouring pixels are neighbouring texels, which L1 and L2
//     serve;
//   - C a template parameter (1 to 4), so a pixel's channels are a
//     register array and its loops unroll;
//   - the forward reads no texel for an out-of-footprint pixel when `miss`
//     is given, and the adjoint adds nothing for one;
//   - the adjoint's zeroing of the gradient is a memset on the same stream,
//     no kernel; its atomics compile to reductions (RED), since no result
//     is read; each block writes its count of splatted pixels
//     (__syncthreads_count) to its own slot, so the count costs no atomic;
//   - one atomic add a tap and channel, unmerged. Merging the adds of a
//     warp's lanes on one texel (__match_any_sync, the lowest lane adding
//     the group's sum) was measured on an NVIDIA H100 80GB HBM3, the
//     card's time alone: with the miss, merged 0.070 ms against 0.068-
//     0.069 unmerged at 512^3 and 1920x1080, 0.060 against 0.055 at 256^3
//     and 1024^2: slower, since in-footprint taps rarely share a texel;
//     without the miss 0.20 against 1.75, every outside pixel on an edge
//     texel, but every caller of the warp passes a miss.
// Each of the two is one launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // kernels/warp_bilinear.py BLOCK_PIXELS
constexpr int kMaxChannels = 4;

struct Miss {
  float v[kMaxChannels];
};

struct Tap {
  int i0, i1;
  float f;
};

// _taps along an axis of n texels, the plain version's operations in its
// order. A NaN position clamps to texel 0 here (torch.clamp would keep the
// NaN and the plain version's index would be out of range).
__device__ __forceinline__ Tap tap(float q, int n) {
  float p = __fsub_rn(__fmul_rn(q, static_cast<float>(n)), 0.5f);
  p = fminf(fmaxf(p, 0.0f), static_cast<float>(n - 1));
  const float i0f = floorf(p);
  Tap t;
  t.i0 = static_cast<int>(i0f);
  t.i1 = min(t.i0 + 1, n - 1);
  t.f = __fsub_rn(p, i0f);
  return t;
}

__device__ __forceinline__ bool in01(float q) {
  return q >= 0.0f && q <= 1.0f;
}

template <int C>
__global__ void __launch_bounds__(kThreads)
warp_fwd(const float* __restrict__ base, const float* __restrict__ rows01,
         const float* __restrict__ cols01, float* __restrict__ out,
         long long n, int Hb, int Wb, int has_miss, Miss miss) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads
      + threadIdx.x;
  if (i >= n) return;
  const float qr = rows01[i], qc = cols01[i];
  float* o = out + i * C;
  if (has_miss && !(in01(qr) && in01(qc))) {
#pragma unroll
    for (int ch = 0; ch < C; ++ch) o[ch] = miss.v[ch];
    return;
  }
  const Tap r = tap(qr, Hb), c = tap(qc, Wb);
  const float* b00 = base + (static_cast<long long>(r.i0) * Wb + c.i0) * C;
  const float* b10 = base + (static_cast<long long>(r.i1) * Wb + c.i0) * C;
  const float* b01 = base + (static_cast<long long>(r.i0) * Wb + c.i1) * C;
  const float* b11 = base + (static_cast<long long>(r.i1) * Wb + c.i1) * C;
  const float omfr = __fsub_rn(1.0f, r.f), omfc = __fsub_rn(1.0f, c.f);
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    const float top = __fadd_rn(__fmul_rn(omfr, __ldg(b00 + ch)),
                                __fmul_rn(r.f, __ldg(b10 + ch)));
    const float bot = __fadd_rn(__fmul_rn(omfr, __ldg(b01 + ch)),
                                __fmul_rn(r.f, __ldg(b11 + ch)));
    o[ch] = __fadd_rn(__fmul_rn(omfc, top), __fmul_rn(c.f, bot));
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
warp_bwd(const float* __restrict__ ct, const float* __restrict__ rows01,
         const float* __restrict__ cols01, float* __restrict__ grad,
         int* __restrict__ block_counts, long long n, int Hb, int Wb,
         int masked) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads
      + threadIdx.x;
  float qr = 0.0f, qc = 0.0f;
  bool live = i < n;
  if (live) {
    qr = rows01[i];
    qc = cols01[i];
    if (masked) live = in01(qr) && in01(qc);
  }
  // every thread of the block reaches this, the out-of-range ones too
  const int count = __syncthreads_count(live);
  if (threadIdx.x == 0) block_counts[blockIdx.x] = count;
  if (!live) return;
  const Tap r = tap(qr, Hb), c = tap(qc, Wb);
  float* g00 = grad + (static_cast<long long>(r.i0) * Wb + c.i0) * C;
  float* g10 = grad + (static_cast<long long>(r.i1) * Wb + c.i0) * C;
  float* g01 = grad + (static_cast<long long>(r.i0) * Wb + c.i1) * C;
  float* g11 = grad + (static_cast<long long>(r.i1) * Wb + c.i1) * C;
  const float omfr = __fsub_rn(1.0f, r.f), omfc = __fsub_rn(1.0f, c.f);
  const float* t = ct + i * C;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    const float g = t[ch];
    const float left = __fmul_rn(g, omfc), right = __fmul_rn(g, c.f);
    atomicAdd(g00 + ch, __fmul_rn(left, omfr));
    atomicAdd(g10 + ch, __fmul_rn(left, r.f));
    atomicAdd(g01 + ch, __fmul_rn(right, omfr));
    atomicAdd(g11 + ch, __fmul_rn(right, r.f));
  }
}

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

bool bad_shape(long long n, int Hb, int Wb, int C) {
  return n < 0 || n > static_cast<long long>(0x7fffffff) * kThreads
      || Hb < 1 || Wb < 1 || C < 1 || C > kMaxChannels;
}

}  // namespace

// The warp of n pixels: out (n, C) from base (Hb, Wb, C) at rows01 and
// cols01 (n each), all contiguous float32 on the current device, on
// `stream`. has_miss: out-of-footprint pixels take miss0..miss3 (the
// first C of them). Returns the launch's cudaGetLastError().
extern "C" int warp_bilinear_fwd_launch(const float* base,
                                        const float* rows01,
                                        const float* cols01, float* out,
                                        long long n, int Hb, int Wb, int C,
                                        int has_miss, float miss0,
                                        float miss1, float miss2, float miss3,
                                        void* stream) {
  if (bad_shape(n, Hb, Wb, C)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const Miss miss = {{miss0, miss1, miss2, miss3}};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = blocks_for(n);
  switch (C) {
    case 1: warp_fwd<1><<<blocks, kThreads, 0, st>>>(
        base, rows01, cols01, out, n, Hb, Wb, has_miss, miss); break;
    case 2: warp_fwd<2><<<blocks, kThreads, 0, st>>>(
        base, rows01, cols01, out, n, Hb, Wb, has_miss, miss); break;
    case 3: warp_fwd<3><<<blocks, kThreads, 0, st>>>(
        base, rows01, cols01, out, n, Hb, Wb, has_miss, miss); break;
    default: warp_fwd<4><<<blocks, kThreads, 0, st>>>(
        base, rows01, cols01, out, n, Hb, Wb, has_miss, miss); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// The adjoint of n pixels: grad (Hb, Wb, C) zeroed, then every pixel's
// cotangent ct (n, C) splatted into it (masked: the in-footprint pixels
// only); block_counts (one int a block of kThreads pixels, blocks_for(n)
// of them) gets each block's count of splatted pixels. Contiguous, on the
// current device, on `stream`. Returns cudaGetLastError() after the
// launch, or the memset's error.
extern "C" int warp_bilinear_bwd_launch(const float* ct, const float* rows01,
                                        const float* cols01, float* grad,
                                        int* block_counts, long long n,
                                        int Hb, int Wb, int C, int masked,
                                        void* stream) {
  if (bad_shape(n, Hb, Wb, C)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t zeroed = cudaMemsetAsync(
      grad, 0, static_cast<size_t>(Hb) * Wb * C * sizeof(float), st);
  if (zeroed != cudaSuccess) return static_cast<int>(zeroed);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const unsigned blocks = blocks_for(n);
  switch (C) {
    case 1: warp_bwd<1><<<blocks, kThreads, 0, st>>>(
        ct, rows01, cols01, grad, block_counts, n, Hb, Wb, masked); break;
    case 2: warp_bwd<2><<<blocks, kThreads, 0, st>>>(
        ct, rows01, cols01, grad, block_counts, n, Hb, Wb, masked); break;
    case 3: warp_bwd<3><<<blocks, kThreads, 0, st>>>(
        ct, rows01, cols01, grad, block_counts, n, Hb, Wb, masked); break;
    default: warp_bwd<4><<<blocks, kThreads, 0, st>>>(
        ct, rows01, cols01, grad, block_counts, n, Hb, Wb, masked); break;
  }
  return static_cast<int>(cudaGetLastError());
}
