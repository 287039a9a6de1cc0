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
// for x [N, 3] and m [N], row-major, float32 or float64. The classic tiled
// design: one thread per target body, its position and its three sums in
// registers; the block stages tiles of kTile sources (x, y, z, m) in shared
// memory and every thread of the block sweeps each tile. Self-pairs are
// excluded by index (j == i), and the tail of the last tile by a bounds
// check, so no padded source takes part: the TPU kernel padded the sources
// with zero-mass bodies at the origin (pallas_kernels.py:269-272), whose
// weight is 0 * inf = NaN for a body at the origin with eps = 0. Sums run
// in source index order.
//
// Bound: 20-odd flops, one square root and one division per pair (IEEE
// rounding, as the plain version rounds) against 16 or 32 bytes of shared
// memory read per pair per warp broadcast: arithmetic bound. At N = 16384
// the grid is only N / kTile blocks, so the card is far from full; several
// targets per thread, a split of the source range over blocks and rsqrt
// variants are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 128;

template <typename T>
struct Body {
  T x, y, z, m;
};

template <typename T>
__global__ void __launch_bounds__(kTile) nbody_kernel(
    const T* __restrict__ x, const T* __restrict__ mass, T* __restrict__ acc,
    int n, T soft2, T g_const) {
  __shared__ Body<T> tile[kTile];
  const int i = blockIdx.x * kTile + threadIdx.x;
  const bool valid = i < n;
  const T xi = valid ? x[3 * i] : T(0);
  const T yi = valid ? x[3 * i + 1] : T(0);
  const T zi = valid ? x[3 * i + 2] : T(0);
  T ax = T(0), ay = T(0), az = T(0);
  for (int start = 0; start < n; start += kTile) {
    const int j = start + threadIdx.x;
    if (j < n)
      tile[threadIdx.x] =
          Body<T>{x[3 * j], x[3 * j + 1], x[3 * j + 2], mass[j]};
    __syncthreads();
    const int count = min(kTile, n - start);
    for (int k = 0; k < count; ++k) {
      if (start + k == i) continue;
      const Body<T> b = tile[k];
      const T dx = b.x - xi, dy = b.y - yi, dz = b.z - zi;
      const T r2 = dx * dx + dy * dy + dz * dz + soft2;
      const T inv = T(1) / sqrt(r2);
      const T w = b.m * (inv * inv * inv);
      ax += w * dx;
      ay += w * dy;
      az += w * dz;
    }
    __syncthreads();
  }
  if (valid) {
    acc[3 * i] = g_const * ax;
    acc[3 * i + 1] = g_const * ay;
    acc[3 * i + 2] = g_const * az;
  }
}

template <typename T>
int launch(const void* x, const void* mass, void* acc, int n,
           double softening, double g_const, void* stream) {
  const unsigned blocks = (unsigned)((n + kTile - 1) / kTile);
  nbody_kernel<T><<<blocks, kTile, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(mass),
      static_cast<T*>(acc), n, T(softening * softening), T(g_const));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype 0 float32, 1 float64. softening is eps (r^2 + eps^2), g_const G.
int pbbi_nbody_accelerations(int dtype, const void* x, const void* mass,
                             void* acc, int n, double softening,
                             double g_const, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return launch<float>(x, mass, acc, n, softening, g_const, stream);
    case 1:
      return launch<double>(x, mass, acc, n, softening, g_const, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
