// The light sweep for Hopper (sm_90a): the scan that builds the
// light-transmittance volume, forward and adjoint, in one launch each.
//
// It replaces no Pallas kernel. The JAX package's sweep is two jnp matmuls
// per step inside lax.scan (volumetricrenderer_tpu/ops/lighting.py:98-104),
// left to XLA; the port ran the same step as two dense cuBLAS products in
// a host loop of S - 1 steps, so a config-4 frame paid ~1,000 launches and
// 17 GFLOP of dense products for ~0.2 GFLOP of needed work, paced by the
// host's enqueue. This kernel runs the whole scan in one launch.
//
// The function (ops/lighting.py; the plain version is
// kernels/light_sweep.py light_sweep_reference). sigma is a contiguous
// (S, A, B) stack, the slice order q_0, q_1, ... runs from `first` by
// `step`, and the shear along each in-plane axis is a table of taps: output
// row a of the A shear is sum_t w[a][t] * in[idx[a][t]] (the non-zeros of
// the dense shear matrix's row a, in order), likewise along B:
//   carry_0 = 0,  out[q_0] = f(0)
//   carry_j = ShearB(ShearA(carry_{j-1} + g(q_{j-1}))),  out[q_j] = f(carry_j)
// forward: g(q) = sigma[q] * dl and f(c) = exp(-density * c), the light
// volume L; adjoint (the same scan in reverse slice order, with the
// transposed tables): g(q) = (-density * L[q]) * dL[q] and f(c) = dl * c,
// the gradient of sigma. Every multiply and add is rounded on its own, in
// the order of the plain version (built with --fmad=false), and exp is
// expf, as PyTorch's float32 exp on the card: the forward equals the plain
// version bit for bit on the card. The sum of a tap row starts with tap 0.
//
// What bounds it on this card. The needed work is O(volume): read sigma
// once and write L once, 2 x 67 MB at config 4 (256^3), 0.040 ms at
// 3.35 TB/s; the operations (about 12 a voxel) are far below that. But the
// S - 1 steps are sequential, each needing the whole previous carry plane:
// the scan is bound by the latency of one step (the reads of the carry,
// the two shears, a barrier), S - 1 times, not by bytes. A first design
// with the carry in L2 took 6.5 us a step at config 4 on an NVIDIA H100
// 80GB HBM3 (1.65 ms a sweep): each step waited on L2 round trips for the
// carry and for sigma, with little work per SM to hide them.
//
// Design. One thread-block cluster (16 CTAs where the card schedules that
// many, else 8) of 1024 threads runs the whole scan; CTA c owns a band of
// rows of A. light_sweep_shared, for two-tap tables, rows of a multiple of
// 4 floats and planes whose bands fit shared memory (config 4's 256 x 256;
// up to about 300 x 300): each CTA keeps its band of the carry,
// double-buffered, in its own shared memory and reads the rows of its taps
// that other CTAs own through distributed shared memory. The inputs of the
// step after next (sigma, or L and dL, at the band's tap rows) are copied
// into a ring of three stages with cp.async while the current step runs.
// A step: (1) each CTA forms Y = carry + g at its tap rows and shears it
// along A into shared memory, 4 columns a thread; (2) it shears its rows
// along B into the next carry buffer, one column a thread; (3) it arrives
// at the cluster barrier (release), then writes out[q_j] from its carry and
// issues the next copy, and only then waits (acquire): the output's stores
// and exp leave the dependent chain. 2.8 us a step, 0.71 ms a sweep at
// config 4 on that card. light_sweep_global takes every other case: the
// carry double-buffered in global memory (in L2: st.cg, ld.cg, since the
// SMs' L1 caches are not coherent across the cluster), the band sheared in
// groups of rows that fit a shared-memory stage, the next step's input
// lines prefetched into L2. Both take any shift, sign and axis through the
// tables.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kSlots = 3;               // light_sweep_shared's input stages
constexpr int kGroupBytes = 96 * 1024;  // light_sweep_global's row groups
constexpr int kMaxSmem = 227 * 1024;    // what a block may take
constexpr int kMaxTaps = 4;             // taps of a table row, at most
constexpr int kClusterWide = 16;             // non-portable cluster size
constexpr int kClusterPortable = 8;
constexpr int kNeedsCarry = -1;  // light_sweep_launch: global, carry null

struct Scan {
  const float* src;  // (S, A, B): sigma, or L in the adjoint
  const float* aux;  // (S, A, B): dL in the adjoint, else null
  float* out;        // (S, A, B): L, or the gradient of sigma
  float* carry;      // (2, A, B) scratch of light_sweep_global, else null
  int S, A, B, first, step;
  const int* row_idx;  // (A, row_taps)
  const float* row_w;
  int row_taps;
  const int* col_idx;  // (B, col_taps)
  const float* col_w;
  int col_taps;
  float scale_in;   // dl, or -density in the adjoint
  float scale_out;  // -density, or dl in the adjoint
  int reach;        // the largest |row_idx[a][t] - a|
  int band;         // rows of A a CTA owns
  int group;        // light_sweep_global: rows of A sheared at once
  int rows;         // light_sweep_shared: rows a CTA stages, band + 2 * reach
};

// g at one element: sigma * dl, or (-density * L) * dL.
template <bool kAdjoint>
__device__ __forceinline__ float term(float scale_in, float s, float d) {
  if (kAdjoint) return __fmul_rn(__fmul_rn(scale_in, s), d);
  return __fmul_rn(s, scale_in);
}

// f(c), written to out[q_j].
template <bool kAdjoint>
__device__ __forceinline__ float emit(float scale_out, float c) {
  if (kAdjoint) return __fmul_rn(scale_out, c);
  return expf(__fmul_rn(scale_out, c));
}

// The tap-row range of a CTA's band [a_lo, a_hi): [lo, lo + rows).
__device__ __forceinline__ int first_tap_row(const Scan& P, int a_lo) {
  return max(0, min(a_lo - P.reach, P.A - P.rows));
}

__device__ __forceinline__ void prefetch_l2(const float* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Starts copies of n floats from global memory into shared memory with
// cp.async, in 16-byte pieces where both ends allow it.
__device__ __forceinline__ void stage_copy(float* dst, const float* src,
                                           int n, bool vec) {
  if (vec) {
    for (int i = 4 * threadIdx.x; i < n; i += 4 * kThreads)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                       smem_addr(dst + i)),
                   "l"(src + i));
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                       smem_addr(dst + i)),
                   "l"(src + i));
  }
}

// The elements e = V * (threadIdx.x + k * kThreads) of a band of rows of
// width B (a multiple of V), walked as (row, column) pairs with no division
// per element: V = 4 in the A shear (16-byte accesses), 1 in the B shear.
template <int V>
struct Walk {
  int ra, b, dq, dr;  // V * kThreads = dq * B + dr
  __device__ __forceinline__ explicit Walk(int B)
      : ra(V * threadIdx.x / B), b(V * threadIdx.x % B), dq(V * kThreads / B),
        dr(V * kThreads % B) {}
  __device__ __forceinline__ void next(int B) {
    b += dr;
    ra += dq;
    if (b >= B) {
      b -= B;
      ++ra;
    }
  }
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// light_sweep_shared's shared memory, in floats from the start: the carry (2,
// band, B), the A-sheared rows (band, B), the input stages (kSlots, rows,
// B) for src and, in the adjoint, for aux, the carry-row pointers (rows,
// 8 bytes each), the band's row table (band, 2) and the column table
// (2, B). Each part starts on 16 bytes.
struct Layout {
  int carry, z, src, aux, ptrs, ridx, rw, cidx, cw, end;
};

__host__ __device__ __forceinline__ int round16(int floats) {
  return (floats + 3) & ~3;
}

__host__ __device__ __forceinline__ Layout shared_layout(const Scan& P,
                                                         bool adjoint) {
  Layout L;
  const int plane = P.band * P.B, stage = round16(P.rows * P.B);
  L.carry = 0;
  L.z = L.carry + round16(2 * plane);
  L.src = L.z + round16(plane);
  L.aux = L.src + kSlots * stage;
  L.ptrs = L.aux + (adjoint ? kSlots * stage : 0);
  L.ridx = L.ptrs + round16(2 * P.rows);
  L.rw = L.ridx + round16(2 * P.band);
  L.cidx = L.rw + round16(2 * P.band);
  L.cw = L.cidx + round16(2 * P.B);
  L.end = L.cw + round16(2 * P.B);
  return L;
}

// Starts the copies of step j's inputs (slice q_{j-1}, at the band's tap
// rows) into slot j % kSlots; none past the last step.
template <bool kAdjoint>
__device__ __forceinline__ void stage_step(const Scan& P, const Layout& L,
                                           float* sm, int lo, int j,
                                           bool vec) {
  if (j >= P.S) return;
  const size_t at = (static_cast<size_t>(P.first + (j - 1) * P.step) * P.A
                     + lo) * P.B;
  const int slot = (j % kSlots) * round16(P.rows * P.B);
  stage_copy(sm + L.src + slot, P.src + at, P.rows * P.B, vec);
  if (kAdjoint) stage_copy(sm + L.aux + slot, P.aux + at, P.rows * P.B, vec);
}

// Waits for this thread's copies; the next barrier publishes them to the
// CTA.
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The scan with the carry in the cluster's shared memory (the module's
// design note), for two-tap tables and rows of a multiple of 4 floats. In
// the A shear a thread takes 4 consecutive columns (16-byte accesses); the
// B shear and the output take one column a thread, consecutive in a warp.
template <bool kAdjoint>
__global__ void __launch_bounds__(kThreads, 1)
    light_sweep_shared(const Scan P) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const Layout L = shared_layout(P, kAdjoint);
  const int rank = static_cast<int>(cluster.block_rank());
  const int B = P.B, band = P.band;
  const int a_lo = min(P.A, rank * band);
  const int a_hi = min(P.A, a_lo + band);
  const int lo = first_tap_row(P, a_lo);
  const int n = (a_hi - a_lo) * B;
  const int plane = band * B, stage = round16(P.rows * B);
  const size_t volume_plane = static_cast<size_t>(P.A) * B;
  float* carry = sm + L.carry;
  float* zs = sm + L.z;
  float** rowp = reinterpret_cast<float**>(sm + L.ptrs);
  int* ridx = reinterpret_cast<int*>(sm + L.ridx);
  float* rw = sm + L.rw;
  int* cidx = reinterpret_cast<int*>(sm + L.cidx);
  float* cw = sm + L.cw;

  // The inputs of steps 1 and 2 start on their way first.
  const bool vec = aligned16(P.src)
                   && (!kAdjoint || aligned16(P.aux));
  stage_step<kAdjoint>(P, L, sm, lo, 1, vec);
  stage_step<kAdjoint>(P, L, sm, lo, 2, vec);
  // Tap row r of the band's range lies in CTA r / band's carry: this
  // CTA's own rows are read from its shared memory, the others' through
  // distributed shared memory.
  for (int r = threadIdx.x; r < P.rows; r += kThreads) {
    const int row = min(lo + r, P.A - 1), owner = row / band;
    float* at = owner == rank ? carry : cluster.map_shared_rank(carry, owner);
    rowp[r] = at + (row - owner * band) * B;
  }
  for (int i = threadIdx.x; i < (a_hi - a_lo) * 2; i += kThreads) {
    ridx[i] = P.row_idx[a_lo * 2 + i] - lo;
    rw[i] = P.row_w[a_lo * 2 + i];
  }
  // The column table tap-major, (2, B): a warp reads it without bank
  // conflicts.
  for (int i = threadIdx.x; i < B * 2; i += kThreads) {
    cidx[(i & 1) * B + i / 2] = P.col_idx[i];
    cw[(i & 1) * B + i / 2] = P.col_w[i];
  }
  {  // slice q_0: the carry is 0
    float* out0 = P.out + static_cast<size_t>(P.first) * volume_plane
                  + static_cast<size_t>(a_lo) * B;
    const float e0 = emit<kAdjoint>(P.scale_out, 0.0f);
    for (int e = threadIdx.x; e < n; e += kThreads) {
      carry[e] = 0.0f;
      out0[e] = e0;
    }
  }
  stage_wait();
  cluster.sync();

  for (int j = 1; j < P.S; ++j) {
    const int cur = ((j - 1) & 1) * plane, nxt = (j & 1) * plane;
    const float* ss = sm + L.src + (j % kSlots) * stage;
    const float* sa = sm + L.aux + (j % kSlots) * stage;
    // (1) Y = carry + g at the tap rows, sheared along A.
    Walk<4> w(B);
    for (int e = 4 * threadIdx.x; e < n; e += 4 * kThreads, w.next(B)) {
      const int r0 = ridx[2 * w.ra], r1 = ridx[2 * w.ra + 1];
      const float w0 = rw[2 * w.ra], w1 = rw[2 * w.ra + 1];
      const float4 c0 = *reinterpret_cast<const float4*>(rowp[r0] + cur + w.b);
      const float4 c1 = *reinterpret_cast<const float4*>(rowp[r1] + cur + w.b);
      const float4 x0 = *reinterpret_cast<const float4*>(ss + r0 * B + w.b);
      const float4 x1 = *reinterpret_cast<const float4*>(ss + r1 * B + w.b);
      float4 d0 = x0, d1 = x1;
      if (kAdjoint) {
        d0 = *reinterpret_cast<const float4*>(sa + r0 * B + w.b);
        d1 = *reinterpret_cast<const float4*>(sa + r1 * B + w.b);
      }
      const auto lerp = [&](float c0_, float x0_, float d0_, float c1_,
                            float x1_, float d1_) {
        return __fadd_rn(
            __fmul_rn(w0, __fadd_rn(c0_, term<kAdjoint>(P.scale_in, x0_, d0_))),
            __fmul_rn(w1, __fadd_rn(c1_, term<kAdjoint>(P.scale_in, x1_, d1_))));
      };
      *reinterpret_cast<float4*>(zs + e) = make_float4(
          lerp(c0.x, x0.x, d0.x, c1.x, x1.x, d1.x),
          lerp(c0.y, x0.y, d0.y, c1.y, x1.y, d1.y),
          lerp(c0.z, x0.z, d0.z, c1.z, x1.z, d1.z),
          lerp(c0.w, x0.w, d0.w, c1.w, x1.w, d1.w));
    }
    __syncthreads();
    // (2) The band's rows sheared along B, one column a thread: the next
    // carry.
    Walk<1> w1(B);
    for (int e = threadIdx.x; e < n; e += kThreads, w1.next(B)) {
      const float* zrow = zs + w1.ra * B;
      carry[nxt + e] = __fadd_rn(__fmul_rn(cw[w1.b], zrow[cidx[w1.b]]),
                                 __fmul_rn(cw[B + w1.b], zrow[cidx[B + w1.b]]));
    }
    // (3) Publish the carry and step j + 1's inputs (copied during step
    // j - 1); meanwhile write out[q_j] (each thread the elements it wrote)
    // and start step j + 2's inputs into the slot step j - 1 read.
    stage_wait();
    cluster_arrive();
    {
      float* outq = P.out
                    + static_cast<size_t>(P.first + j * P.step) * volume_plane
                    + static_cast<size_t>(a_lo) * B;
      for (int e = threadIdx.x; e < n; e += kThreads)
        outq[e] = emit<kAdjoint>(P.scale_out, carry[nxt + e]);
    }
    stage_step<kAdjoint>(P, L, sm, lo, j + 2, vec);
    cluster_wait();
  }
}

// The scan with the carry in global memory, for what light_sweep_shared
// does not take (the module's design note).
template <bool kAdjoint>
__global__ void __launch_bounds__(kThreads, 1)
    light_sweep_global(const Scan P) {
  extern __shared__ __align__(16) float zs[];
  cg::cluster_group cluster = cg::this_cluster();
  const int a_lo = min(P.A, static_cast<int>(cluster.block_rank()) * P.band);
  const int a_hi = min(P.A, a_lo + P.band);
  const size_t plane = static_cast<size_t>(P.A) * P.B;
  const int B = P.B;

  {  // slice q_0: the carry is 0
    float* out0 = P.out + static_cast<size_t>(P.first) * plane;
    const float e0 = emit<kAdjoint>(P.scale_out, 0.0f);
    for (int i = a_lo * B + threadIdx.x; i < a_hi * B; i += kThreads) {
      __stcg(P.carry + i, 0.0f);
      out0[i] = e0;
    }
  }
  cluster.sync();

  for (int j = 1; j < P.S; ++j) {
    const int qp = P.first + (j - 1) * P.step;
    const int q = qp + P.step;
    const float* cin = P.carry + static_cast<size_t>((j - 1) & 1) * plane;
    float* cout = P.carry + static_cast<size_t>(j & 1) * plane;
    const float* src = P.src + static_cast<size_t>(qp) * plane;
    const float* aux = kAdjoint ? P.aux + static_cast<size_t>(qp) * plane
                                : nullptr;
    // The next step's inputs are slice q's.
    const bool ahead = j + 1 < P.S;
    const float* src_next = P.src + static_cast<size_t>(q) * plane;
    const float* aux_next = kAdjoint ? P.aux + static_cast<size_t>(q) * plane
                                     : nullptr;
    float* outq = P.out + static_cast<size_t>(q) * plane;

    for (int r0 = a_lo; r0 < a_hi; r0 += P.group) {
      const int n = (min(a_hi, r0 + P.group) - r0) * B;
      // (1) Y = carry + g at the tap rows, sheared along A.
      for (int e = threadIdx.x; e < n; e += kThreads) {
        const int a = r0 + e / B;
        const int b = e - (a - r0) * B;
        float acc = 0.0f;
        for (int t = 0; t < P.row_taps; ++t) {
          const int k = a * P.row_taps + t;
          const size_t off = static_cast<size_t>(__ldg(P.row_idx + k)) * B + b;
          const float y = __fadd_rn(
              __ldcg(cin + off),
              term<kAdjoint>(P.scale_in, __ldg(src + off),
                             kAdjoint ? __ldg(aux + off) : 0.0f));
          const float p = __fmul_rn(__ldg(P.row_w + k), y);
          acc = t == 0 ? p : __fadd_rn(acc, p);
          if (ahead && (b & 31) == 0) {
            prefetch_l2(src_next + off);
            if (kAdjoint) prefetch_l2(aux_next + off);
          }
        }
        zs[e] = acc;
      }
      __syncthreads();
      // (2) The rows sheared along B: the new carry and out[q].
      for (int e = threadIdx.x; e < n; e += kThreads) {
        const int ra = e / B;
        const int b = e - ra * B;
        const float* zrow = zs + ra * B;
        const int k0 = b * P.col_taps;
        float acc = __fmul_rn(__ldg(P.col_w + k0), zrow[__ldg(P.col_idx + k0)]);
        for (int t = 1; t < P.col_taps; ++t)
          acc = __fadd_rn(acc, __fmul_rn(__ldg(P.col_w + k0 + t),
                                         zrow[__ldg(P.col_idx + k0 + t)]));
        const size_t o = static_cast<size_t>(r0 + ra) * B + b;
        __stcg(cout + o, acc);
        outq[o] = emit<kAdjoint>(P.scale_out, acc);
      }
      __syncthreads();
    }
    // (3) Publish the carry to the cluster before the next step reads it.
    cluster.sync();
  }
}

cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int size,
                                  int smem, cudaStream_t st) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = size;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(size);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Allows a kernel the most shared memory and the wide cluster (once per
// kernel and device) and returns the cluster size the device schedules for
// it: kClusterWide where it fits, else the portable size; 0 if neither.
template <typename Kernel>
int cluster_size(Kernel kern, int (&cached)[64]) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev]) return cached[dev];
  cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kMaxSmem);
  const int sizes[2] = {kClusterWide, kClusterPortable};
  for (int size : sizes) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(&attr, size, kMaxSmem,
                                                  nullptr);
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg) == cudaSuccess
        && clusters > 0)
      return cached[dev] = size;
    cudaGetLastError();  // clear a refused query
  }
  return 0;
}

template <bool kAdjoint>
int launch_shared(Scan P, int size, cudaStream_t st) {
  static int cached[64] = {};
  auto kern = light_sweep_shared<kAdjoint>;
  if (cluster_size(kern, cached) != size)
    return static_cast<int>(cudaErrorNotSupported);
  cudaLaunchAttribute attr;
  const int smem = shared_layout(P, kAdjoint).end * static_cast<int>(sizeof(float));
  const cudaLaunchConfig_t cfg = cluster_config(&attr, size, smem, st);
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kern, P));
}

template <bool kAdjoint>
int launch(Scan P, cudaStream_t st) {
  static int cached[64] = {};
  auto global = light_sweep_global<kAdjoint>;
  const int size = cluster_size(global, cached);
  if (size == 0) return static_cast<int>(cudaErrorNotSupported);
  const size_t row_bytes = static_cast<size_t>(P.B) * sizeof(float);
  if (row_bytes > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  P.band = (P.A + size - 1) / size;
  P.rows = min(P.A, P.band + 2 * P.reach);
  if (P.row_taps == 2 && P.col_taps == 2 && (P.B & 3) == 0
      && static_cast<size_t>(shared_layout(P, kAdjoint).end) * sizeof(float)
             <= static_cast<size_t>(kMaxSmem)) {
    const int rc = launch_shared<kAdjoint>(P, size, st);
    if (rc != static_cast<int>(cudaErrorNotSupported))
      return rc ? rc : static_cast<int>(cudaGetLastError());
  }
  if (P.carry == nullptr) return kNeedsCarry;
  P.group = static_cast<int>(kGroupBytes / row_bytes);
  P.group = P.group < 1 ? 1 : (P.group > P.band ? P.band : P.group);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      &attr, size, static_cast<int>(P.group * row_bytes), st);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, global, P);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One scan on `stream` (kernels/light_sweep.py launch_kernel): the forward
// (adjoint = 0, aux null) or the adjoint. reach: the largest distance
// between a row and one of its taps, over the row table. carry: the (2, A,
// B) scratch light_sweep_global needs; may be null, and then a scan that
// needs it launches nothing and returns kNeedsCarry (-1). Otherwise returns
// a CUDA error code, 0 when the launch was accepted.
extern "C" int light_sweep_launch(const float* src, const float* aux,
                                  float* out, float* carry, int S, int A,
                                  int B, int first, int step,
                                  const int* row_idx, const float* row_w,
                                  int row_taps, const int* col_idx,
                                  const float* col_w, int col_taps,
                                  int reach, float scale_in, float scale_out,
                                  int adjoint, void* stream) {
  if (S < 1 || A < 1 || B < 1 || row_taps < 1 || row_taps > kMaxTaps
      || col_taps < 1 || col_taps > kMaxTaps || reach < 0
      || (adjoint && aux == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Scan P = {src, aux, out, carry, S, A, B, first, step, row_idx, row_w,
            row_taps, col_idx, col_w, col_taps, scale_in, scale_out, reach,
            0, 0, 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return adjoint ? launch<true>(P, st) : launch<false>(P, st);
}
