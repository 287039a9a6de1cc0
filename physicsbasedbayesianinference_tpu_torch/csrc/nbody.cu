// Kernel E: all-pairs gravitational accelerations for Hopper (sm_90a), with
// a plain C interface loaded through ctypes (ops/_build.py, ops/kernels.py
// nbody_accelerations_tiled).
//
//   pbbi_nbody_accelerations  replaces nbody_accelerations_pallas
//                             (physicsbasedbayesianinference_tpu/ops/
//                             pallas_kernels.py:252)
//
//   a_i = G sum_{j != i} m_j (x_j - x_i) / (|x_j - x_i|^2 + eps^2)^{3/2}
//
// for x [N, 3] and m [N], row-major, float32 or float64. The sources j
// are a separate array (x_src [N_src, 3], m_src [N_src]) beside the
// targets i: the one-set launch passes the bodies as both, and a block of
// the ring N-body sweep (parallel/ring.py) its own bodies as targets and
// the block passing by as sources. The TPU's ring computed that tile in jnp
// (physicsbasedbayesianinference_tpu/parallel/ring.py _block_accel).
//
// Bound: arithmetic. A pair needs 12 instructions of the FP32 pipe (3
// subtractions, 3 multiply-adds for r^2, 3 multiplications for m / r^3, 3
// multiply-adds into a) and one reciprocal square root on the
// special-function pipe, against one 16-byte broadcast read of shared
// memory; x and m (16 N bytes) fit in L2. So N^2 pairs x 12 over the
// H100's 33.5e12 lane-instructions/s is the least time: 0.096 ms at
// N = 16384, where this kernel takes 0.166 ms (NVIDIA H100 80GB HBM3,
// 700 W; the one-thread-per-target kernel before it took 2.233 ms). Below
// a few thousand bodies a launch's own 2 microseconds are the bound.
//
// Design, for a card with 132 SMs of 2048 threads:
//   * `split` consecutive lanes of a warp (a power of two, 1..32) share one
//     target body, so that N targets make N * split threads: the host
//     (ops/kernels.py nbody_split) picks the smallest split that fills the
//     card. Lane s takes the sources s, s + split, ... of each tile, so
//     the lanes of a warp read consecutive 16-byte records (no bank
//     conflict) or the same one (a broadcast).
//   * each lane keeps kUnroll independent partial sums, so that kUnroll
//     pairs are in flight: a pair's chain (subtract, r^2, rsqrt, cube,
//     accumulate) is some 60 cycles long.
//   * the partial sums are joined in a fixed order: sums 0..kUnroll-1 left
//     to right, then an xor butterfly over the target's lanes (offsets
//     split/2 .. 1). No atomics: two launches give the same bits.
//   * 1 / r is one rsqrt (float32: the approximate `rsqrt.approx.ftz.f32`,
//     2 ulp; float64: rsqrt(), 1 ulp) instead of an IEEE square root and an
//     IEEE division, and the multiply-adds are written as fma(), whatever
//     the build's contraction flag says.
//   * the self-pair needs no index test, so the sources may be any array:
//     with eps > 0 its term is exactly
//     zero (dx = dy = dz = 0), and with eps = 0 the weight of every pair at
//     r^2 = 0 is selected to zero (a second instantiation: the compare and
//     select cost 19% at N = 16384, and eps > 0 does not need them). That
//     makes zero-mass padding safe, so the last tile is padded (mass 0 at
//     the origin) to a multiple of kUnroll * split sources and the sweep
//     has no bounds check. (The TPU kernel padded without the select,
//     pallas_kernels.py:269-272, and gave 0 * inf = NaN for a body at the
//     origin with eps = 0.) Distinct bodies at the same place with eps = 0
//     contribute nothing here, where the plain version gives inf.
//   * blocks of 512 threads sweep tiles of 1024 (float32) or 512 (float64)
//     sources: a block's fill of a tile serves 512 / split targets, and
//     with 256 threads and tiles of 256 the fills and barriers took a
//     fifth of the time. A tile is fetched by coalesced loads of
//     consecutive coordinates and masses into registers while the tile
//     before it is swept, then written into the other of two shared
//     buffers as (x, y, z, m) records, one barrier a tile; a pair reads
//     its record back as one 16-byte (float32) or two 16-byte (float64)
//     loads.
//   * kThreads and kUnroll are compile-time constants so that
//     tools/kernel_sweeps.py can vary them.

#include <cuda_runtime.h>
#include <math.h>

#include <limits>

#ifndef PBBI_E_UNROLL
#define PBBI_E_UNROLL 4
#endif
#ifndef PBBI_E_THREADS
#define PBBI_E_THREADS 512
#endif

namespace {

constexpr int kThreads = PBBI_E_THREADS;
constexpr int kUnroll = PBBI_E_UNROLL;

template <typename T>
struct alignas(16) Body {
  T x, y, z, m;
};

__device__ __forceinline__ float inv_sqrt(float v) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ double inv_sqrt(double v) { return rsqrt(v); }

// kSoftened: eps^2 is a normal number of T, so r^2 >= eps^2 > 0 for every
// pair (not flushed to zero either) and the select on r^2 = 0 is left out.
template <typename T, bool kSoftened>
__global__ void __launch_bounds__(kThreads) nbody_kernel(
    const T* __restrict__ x, int n, const T* __restrict__ xs,
    const T* __restrict__ ms, int ns, T* __restrict__ acc, int split, T soft2,
    T g_const) {
  // a thread fetches 32 bytes of records a tile: 2 in float32, 1 in
  // float64, so both types keep 2 x 16 KB of tiles at 512 threads
  constexpr int kPerThread = 32 / (int)sizeof(Body<T>);
  constexpr int kTile = kPerThread * kThreads;  // sources per tile
  static_assert(kTile % (32 * kUnroll) == 0,
                "a tile is a multiple of kUnroll * split for every split");
  __shared__ Body<T> tiles[2][kTile];
  const int lane = threadIdx.x % split;
  const int i = blockIdx.x * (kThreads / split) + threadIdx.x / split;
  const bool valid = i < n;
  const T xi = valid ? x[3 * i] : T(0);
  const T yi = valid ? x[3 * i + 1] : T(0);
  const T zi = valid ? x[3 * i + 2] : T(0);
  T ax[kUnroll], ay[kUnroll], az[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) ax[u] = ay[u] = az[u] = T(0);
  const int stride = kUnroll * split;

  // The tile after the one being swept waits in registers: coordinate
  // f = threadIdx.x + c * kThreads of its 3 * kTile (coalesced) and mass
  // threadIdx.x + c * kThreads, zero beyond the last source.
  T coords[3 * kPerThread], masses[kPerThread];
  const auto fetch = [&](int start) {
    const int count = min(kTile, ns - start);
#pragma unroll
    for (int c = 0; c < 3 * kPerThread; ++c) {
      const int f = threadIdx.x + c * kThreads;
      coords[c] = f < 3 * count ? xs[3 * (long long)start + f] : T(0);
    }
#pragma unroll
    for (int c = 0; c < kPerThread; ++c) {
      const int k = threadIdx.x + c * kThreads;
      masses[c] = k < count ? ms[start + k] : T(0);
    }
  };
  fetch(0);
  for (int start = 0, buf = 0; start < ns; start += kTile, buf ^= 1) {
    // coordinate f = 3 k + e goes to record k, field e. The other buffer
    // may still be read by a warp that is behind; this one was last read
    // before the previous barrier.
    T* const flat = reinterpret_cast<T*>(tiles[buf]);
#pragma unroll
    for (int c = 0; c < 3 * kPerThread; ++c) {
      const int f = threadIdx.x + c * kThreads;
      const int k = f / 3;
      flat[4 * k + (f - 3 * k)] = coords[c];
    }
#pragma unroll
    for (int c = 0; c < kPerThread; ++c)
      flat[4 * (threadIdx.x + c * kThreads) + 3] = masses[c];
    __syncthreads();
    if (start + kTile < ns) fetch(start + kTile);  // in flight over the sweep

    const Body<T>* const tile = tiles[buf];
    const int count = min(kTile, ns - start);
    const int limit = (count + stride - 1) / stride * stride;  // <= kTile
    for (int k = lane; k < limit; k += stride) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const Body<T> b = tile[k + u * split];
        const T dx = b.x - xi, dy = b.y - yi, dz = b.z - zi;
        const T r2 = fma(dz, dz, fma(dy, dy, fma(dx, dx, soft2)));
        const T inv = (kSoftened || r2 > T(0)) ? inv_sqrt(r2) : T(0);
        const T w = b.m * (inv * inv * inv);
        ax[u] = fma(w, dx, ax[u]);
        ay[u] = fma(w, dy, ay[u]);
        az[u] = fma(w, dz, az[u]);
      }
    }
  }
  T sx = ax[0], sy = ay[0], sz = az[0];
#pragma unroll
  for (int u = 1; u < kUnroll; ++u) {
    sx += ax[u];
    sy += ay[u];
    sz += az[u];
  }
  for (int off = split >> 1; off > 0; off >>= 1) {
    sx += __shfl_xor_sync(0xffffffffu, sx, off);
    sy += __shfl_xor_sync(0xffffffffu, sy, off);
    sz += __shfl_xor_sync(0xffffffffu, sz, off);
  }
  if (valid && lane == 0) {
    acc[3 * i] = g_const * sx;
    acc[3 * i + 1] = g_const * sy;
    acc[3 * i + 2] = g_const * sz;
  }
}

template <typename T>
int launch(const void* x, int n, const void* xs, const void* ms, int ns,
           void* acc, int split, double softening, double g_const,
           void* stream) {
  const int targets = kThreads / split;
  const unsigned blocks = (unsigned)((n + targets - 1) / targets);
  const T soft2 = T(softening * softening);
  const auto kernel = soft2 >= std::numeric_limits<T>::min()
                          ? &nbody_kernel<T, true>
                          : &nbody_kernel<T, false>;
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), n, static_cast<const T*>(xs),
      static_cast<const T*>(ms), ns, static_cast<T*>(acc), split, soft2,
      T(g_const));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype 0 float32, 1 float64. x: the n targets; x_src, m_src: the n_src
// sources (x and its masses for the one-set launch, which then runs as it
// did before sources were separate). split: lanes per target, a power of
// two in 1..32 (ops/kernels.py nbody_split). softening is eps
// (r^2 + eps^2), g_const G.
int pbbi_nbody_accelerations(int dtype, const void* x, int n,
                             const void* x_src, const void* m_src, int n_src,
                             void* acc, int split, double softening,
                             double g_const, void* stream) {
  if (n <= 0 || n_src <= 0 || split < 1 || split > 32 ||
      (split & (split - 1)))
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return launch<float>(x, n, x_src, m_src, n_src, acc, split, softening,
                           g_const, stream);
    case 1:
      return launch<double>(x, n, x_src, m_src, n_src, acc, split, softening,
                            g_const, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
