// Device forms of the potentials, shared by kernel B (fused_hmc.cu) and
// kernel D (leapfrog.cu), and the warp layout they run in.
//
// Layout: a walker's dims are split into dim-groups of four. T =
// min(32, next_pow2(ceil(D / 4))) consecutive lanes of a warp form a lane
// group, lane l owning dim-group l (so D <= 4 * 32 = 128) of the group's R
// walkers (the walker tile, 1, 2 or 4; ops/kernels.py walker_tile). The
// group's walkers are consecutive: group s of block b owns walkers
// (b * kBlock / T + s) * R + r, r < R. Per-walker sums are xor-butterfly
// shuffles over the T lanes; a lane group never leaves its warp, so
// __syncwarp() orders its traffic through shared memory.
//
// A form stages its parameters in shared memory (stage) and evaluates, for
// the lane's four dims, the gradient (grad) and the walker's value (value,
// on every lane). Sums over dimensions run in index order, the order of the
// plain versions (ops/kernels.py), so that both round alike. Forms that
// couple a walker's dims read them from the walker's shared buffer, a row
// of 4 T + kBufPad floats; the rows of a lane group's R walkers lie
// row_step floats apart.
//
// The Gaussian is the form with arithmetic enough to bound a kernel (a
// D x D matvec per leapfrog step: D^2 multiply-adds a walker against 4 D
// floats moved), and the only one that takes R > 1 (kTiled): a thread
// keeps the [R][4] tile of the gradient in registers and reads each row of
// P once for its R walkers (GaussianForm::grad). The other forms take one
// walker a lane group, as written for it.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

#ifndef PBBI_BLOCK
#define PBBI_BLOCK 256
#endif
constexpr int kBlock = PBBI_BLOCK;
// blocks of kernels B and D that the compiler must fit on an SM: 2 caps a
// thread at 128 registers, which the Gaussian form at R = 4 would exceed
// (143-160) for no gain: 16 warps an SM hide the shared loads better than
// 8 (tools/kernel_sweeps.py)
#ifndef PBBI_BD_MIN_BLOCKS
#define PBBI_BD_MIN_BLOCKS 2
#endif
constexpr int kMinBlocks = PBBI_BD_MIN_BLOCKS;
constexpr int kMaxGenericDims = 128;
// chunks of four rows of P that one pass of the matvec loop takes
#ifndef PBBI_G_UNROLL
#define PBBI_G_UNROLL 4
#endif
constexpr int kGaussianUnroll = PBBI_G_UNROLL;

int threads_per_walker(int num_dims) {
  const int groups = (num_dims + 3) / 4;
  int t = 1;
  while (t < groups && t < 32) t <<= 1;
  return t;
}

inline bool misaligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 != 0;
}

// Sum over aligned segments of `width` lanes (a power of two <= 32); every
// lane of the warp must call it.
__device__ __forceinline__ float segment_sum(float v, int width) {
  for (int off = width >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// A lane's four floats of a row-major [W, D] array, at element `at` of it;
// `left` of them exist (<= 0: none, the lane reads zeros). With kVec (D a
// multiple of 4 and the array 16-byte aligned, checked by the launcher)
// they are one 16-byte access.
template <bool kVec>
__device__ __forceinline__ void load_group(const float* __restrict__ src,
                                           long long at, int left,
                                           float v[4]) {
  if (kVec) {
    const float4 x = left > 0 ? *reinterpret_cast<const float4*>(src + at)
                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = e < left ? src[at + e] : 0.0f;
  }
}

template <bool kVec>
__device__ __forceinline__ void store_group(float* __restrict__ dst,
                                            long long at, int left,
                                            const float v[4]) {
  if (kVec) {
    if (left > 0)
      *reinterpret_cast<float4*>(dst + at) =
          make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < left) dst[at + e] = v[e];
  }
}

// The walker's q into its shared buffer, readable by all its lanes. The
// caller issues __syncwarp() once it is done reading.
__device__ __forceinline__ void share_walker(const float qv[4], int lane,
                                             int d, float* buf) {
  const int base = 4 * lane;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (base + e < d) buf[base + e] = qv[e];
  __syncwarp();
}

// U = 0.5 sum_d k_d (q_d - mu_d)^2 (kernel A's targets); gradient
// k_d (q_d - mu_d), separable, so no walker buffer.
struct DiagQuadraticForm {
  const float* k;     // [D]
  const float* mean;  // [D]
  static constexpr bool kTiled = false;
  static constexpr int kBufPad = 1;

  __host__ __device__ int shared_floats(int d, int) const { return 2 * d; }

  __device__ void stage(float* sh, int d, int) const {
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      sh[i] = k[i];
      sh[d + i] = mean[i];
    }
  }

  __device__ void grad(const float qv[4], float gv[4], int lane, int,
                       int d, const float* sh, float*) const {
    const int base = 4 * lane;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      gv[e] = (base + e < d)
                  ? sh[base + e] * (qv[e] - sh[d + base + e])
                  : 0.0f;
  }

  __device__ float value(const float qv[4], const float[4], int lane,
                         int tpw, int d, const float* sh, float*) const {
    const int base = 4 * lane;
    float part = 0.0f;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (base + e < d) {
        const float qc = qv[e] - sh[d + base + e];
        part += sh[base + e] * qc * qc;
      }
    return 0.5f * segment_sum(part, tpw);
  }
};

// U = 0.5 (q - mu)^T P (q - mu); gradient (q - mu) @ P, accumulated over
// rows of P in index order, each step one fused multiply-add (named, since
// the library is built without contraction): g_i = fma(d_j, P_ji, g_i) for
// j = 0 .. D-1, d = q - mu, whatever R is.
//
// P and mu are staged once a block, padded with zeros to 4 ceil(D / 4)
// rows and 4 T columns, so the loop has no bound test and every load is an
// aligned 16-byte one. The lane group's walkers write q - mu into their
// buffer rows ([walker][dim], one 16-byte store a lane and walker). Then,
// per chunk of four rows of P, a lane loads its four columns of the four
// rows (4 loads) and each walker's four d_j (R loads, the same address for
// all lanes of the group: a broadcast) and does 16 R multiply-adds into
// its [R][4] tile of g: for R = 4, 8 loads to 64 multiply-adds, P read
// once for four walkers. Padded rows and columns are zero, so lanes and
// dims past D compute zeros.
//
// What bounds it: 2 bytes from shared memory a multiply-add at R = 4 (4
// at R = 1). An SM's shared memory returns 128 bytes a clock, broadcast
// or not, and its FP32 lanes take 128 multiply-adds a clock, so the loop
// runs at the shared-memory rate, half the multiply-add rate at R = 4: 4
// byte loads of P in place of 16-byte ones cost nothing, a separate
// multiply and add only a quarter more (tools/kernel_sweeps.py). A larger
// tile would need fewer bytes, but q, p and g of the tile stay in
// registers for the whole trajectory: R = 8 (1.5 bytes a multiply-add,
// built with -DPBBI_G_TILE8) takes 217-250 registers (nvcc -Xptxas -v),
// leaves 8 warps an SM and is no faster (tools/kernel_sweeps.py). R = 4 is
// capped at 128 registers (kMinBlocks = 2), 16 warps.
struct GaussianForm {
  const float* mean;  // [D]
  const float* prec;  // [D, D] row-major
  static constexpr bool kTiled = true;
  static constexpr int kBufPad = 4;  // rows stay 16-byte aligned

  __host__ __device__ static int chunks(int d) { return (d + 3) / 4; }

  __host__ __device__ int shared_floats(int d, int tpw) const {
    return 4 * tpw * (4 * chunks(d) + 1);
  }

  __device__ void stage(float* sh, int d, int tpw) const {
    const int cols = 4 * tpw, rows = 4 * chunks(d);
    for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
      const int r = i / cols, c = i - r * cols;
      sh[i] = (r < d && c < d) ? prec[r * d + c] : 0.0f;
    }
    for (int i = threadIdx.x; i < cols; i += blockDim.x)
      sh[rows * cols + i] = i < d ? mean[i] : 0.0f;
  }

  __device__ __forceinline__ static float madd(float a, float b, float c) {
#ifdef PBBI_G_NO_FMA
    return a * b + c;  // two roundings (measured by tools/kernel_sweeps.py)
#else
    return fmaf(a, b, c);
#endif
  }

  // g + d.x a + d.y b + d.z c + d.w e, added in that order
  __device__ __forceinline__ static float madd4(float4 d, float a, float b,
                                                float c, float e, float g) {
    return madd(d.w, e, madd(d.z, c, madd(d.y, b, madd(d.x, a, g))));
  }

  // the lane's four columns of row j of P
  __device__ __forceinline__ static float4 prec_row(const float* sh, int j,
                                                    int tpw, int lane) {
#ifdef PBBI_G_SCALAR_P
    const float* row = sh + 4 * (j * tpw + lane);  // four 4-byte loads
    return make_float4(row[0], row[1], row[2], row[3]);
#else
    return reinterpret_cast<const float4*>(sh)[j * tpw + lane];
#endif
  }

  template <int R>
  __device__ __forceinline__ void grad(const float (*qv)[4], float (*gv)[4],
                                       int lane, int tpw, int d,
                                       const float* sh, float* buf,
                                       int row_step) const {
    const int nc = chunks(d);
    const float4 mu =
        reinterpret_cast<const float4*>(sh)[4 * nc * tpw + lane];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      *reinterpret_cast<float4*>(buf + r * row_step + 4 * lane) =
          make_float4(qv[r][0] - mu.x, qv[r][1] - mu.y, qv[r][2] - mu.z,
                      qv[r][3] - mu.w);
#pragma unroll
      for (int e = 0; e < 4; ++e) gv[r][e] = 0.0f;
    }
    __syncwarp();
#pragma unroll kGaussianUnroll
    for (int m = 0; m < nc; ++m) {
      const float4 p0 = prec_row(sh, 4 * m, tpw, lane);
      const float4 p1 = prec_row(sh, 4 * m + 1, tpw, lane);
      const float4 p2 = prec_row(sh, 4 * m + 2, tpw, lane);
      const float4 p3 = prec_row(sh, 4 * m + 3, tpw, lane);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 dv =
            *reinterpret_cast<const float4*>(buf + r * row_step + 4 * m);
        float* g = gv[r];
        g[0] = madd4(dv, p0.x, p1.x, p2.x, p3.x, g[0]);
        g[1] = madd4(dv, p0.y, p1.y, p2.y, p3.y, g[1]);
        g[2] = madd4(dv, p0.z, p1.z, p2.z, p3.z, g[2]);
        g[3] = madd4(dv, p0.w, p1.w, p2.w, p3.w, g[3]);
      }
    }
    __syncwarp();
  }

  // 0.5 (q - mu) . g with the g the last grad left (dims past D add zeros)
  __device__ float value(const float qv[4], const float gv[4], int lane,
                         int tpw, int d, const float* sh, float*) const {
    const float4 mu =
        reinterpret_cast<const float4*>(sh)[4 * chunks(d) * tpw + lane];
    float part = 0.0f;
    part += (qv[0] - mu.x) * gv[0];
    part += (qv[1] - mu.y) * gv[1];
    part += (qv[2] - mu.z) * gv[2];
    part += (qv[3] - mu.w) * gv[3];
    return 0.5f * segment_sum(part, tpw);
  }
};

// Neal's funnel, q = (v, x): U = v^2 / (2 s^2) + (D-1)/2 v + e^-v |x|^2 / 2.
// params = (2 s^2, (D-1)/2).
struct FunnelForm {
  const float* params;  // [2]

  static constexpr bool kTiled = false;
  static constexpr int kBufPad = 1;

  __host__ __device__ int shared_floats(int, int) const { return 2; }

  __device__ void stage(float* sh, int, int) const {
    if (threadIdx.x < 2) sh[threadIdx.x] = params[threadIdx.x];
  }

  // v and sum_{i >= 1} x_i^2 of the walker, on every lane
  __device__ static void reduce(const float qv[4], int lane, int d,
                                float* buf, float* v, float* sx) {
    share_walker(qv, lane, d, buf);
    float s = 0.0f;
    for (int j = 1; j < d; ++j) s += buf[j] * buf[j];
    *v = buf[0];
    *sx = s;
    __syncwarp();
  }

  __device__ void grad(const float qv[4], float gv[4], int lane, int,
                       int d, const float* sh, float* buf) const {
    float v, sx;
    reduce(qv, lane, d, buf, &v, &sx);
    const float ev = expf(-v);
    const int base = 4 * lane;
#pragma unroll
    for (int e = 0; e < 4; ++e) gv[e] = (base + e < d) ? ev * qv[e] : 0.0f;
    if (lane == 0) gv[0] = 2.0f * v / sh[0] + sh[1] - 0.5f * ev * sx;
  }

  __device__ float value(const float qv[4], const float[4], int lane, int,
                         int d, const float* sh, float* buf) const {
    float v, sx;
    reduce(qv, lane, d, buf, &v, &sx);
    return v * v / sh[0] + sh[1] * v + 0.5f * expf(-v) * sx;
  }
};

// Rosenbrock's banana, D = 2 (so one lane owns the walker):
// U = (a - q0)^2 + b (q1 - q0^2)^2. params = (a, b).
struct BananaForm {
  const float* params;  // [2]

  static constexpr bool kTiled = false;
  static constexpr int kBufPad = 1;

  __host__ __device__ int shared_floats(int, int) const { return 2; }

  __device__ void stage(float* sh, int, int) const {
    if (threadIdx.x < 2) sh[threadIdx.x] = params[threadIdx.x];
  }

  __device__ void grad(const float qv[4], float gv[4], int, int, int,
                       const float* sh, float*) const {
    const float a = sh[0], b = sh[1];
    const float t = qv[1] - qv[0] * qv[0];
    gv[0] = -2.0f * (a - qv[0]) - ((4.0f * b) * qv[0]) * t;
    gv[1] = (2.0f * b) * t;
    gv[2] = gv[3] = 0.0f;
  }

  __device__ float value(const float qv[4], const float[4], int, int, int,
                         const float* sh, float*) const {
    const float a = sh[0], b = sh[1];
    const float t = qv[1] - qv[0] * qv[0];
    return (a - qv[0]) * (a - qv[0]) + b * (t * t);
  }
};

// Isotropic Gaussian mixture of K components:
// U = -logsumexp_c (log w_c - inv_var |q - mu_c|^2 / 2). The gradient is
// inv_var sum_c r_c (q - mu_c) with r = softmax of the component terms.
struct MixtureForm {
  const float* means;    // [K, D]
  const float* log_w;    // [K]
  const float* inv_var;  // [1]
  int k;

  static constexpr bool kTiled = false;
  static constexpr int kBufPad = 1;

  __host__ __device__ int shared_floats(int d, int) const {
    return k * d + k + 1;
  }

  __device__ void stage(float* sh, int d, int) const {
    for (int i = threadIdx.x; i < k * d; i += blockDim.x) sh[i] = means[i];
    for (int i = threadIdx.x; i < k; i += blockDim.x) sh[k * d + i] = log_w[i];
    if (threadIdx.x == 0) sh[k * d + k] = inv_var[0];
  }

  __device__ float component(const float* sh, const float* buf, int c,
                             int d) const {
    const float* mu = sh + c * d;
    float s = 0.0f;
    for (int j = 0; j < d; ++j) {
      const float diff = buf[j] - mu[j];
      s += diff * diff;
    }
    return sh[k * d + c] - (0.5f * sh[k * d + k]) * s;
  }

  // The largest component term m and s = sum_c exp(term_c - m); with `num`
  // also sum_c exp(term_c - m) (q - mu_c) over the lane's dims.
  __device__ void reduce(const float qv[4], int lane, int d, const float* sh,
                         float* buf, float* m, float* s, float* num) const {
    share_walker(qv, lane, d, buf);
    float mx = -INFINITY;
    for (int c = 0; c < k; ++c) mx = fmaxf(mx, component(sh, buf, c, d));
    float sum = 0.0f;
    const int base = 4 * lane;
    for (int c = 0; c < k; ++c) {
      const float ex = expf(component(sh, buf, c, d) - mx);
      sum += ex;
      if (num != nullptr) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (base + e < d) num[e] += ex * (qv[e] - sh[c * d + base + e]);
      }
    }
    __syncwarp();
    *m = mx;
    *s = sum;
  }

  __device__ void grad(const float qv[4], float gv[4], int lane, int, int d,
                       const float* sh, float* buf) const {
    float m, s, num[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    reduce(qv, lane, d, sh, buf, &m, &s, num);
    const float iv = sh[k * d + k];
#pragma unroll
    for (int e = 0; e < 4; ++e) gv[e] = (iv * num[e]) / s;
  }

  __device__ float value(const float qv[4], const float[4], int lane, int,
                         int d, const float* sh, float* buf) const {
    float m, s;
    reduce(qv, lane, d, sh, buf, &m, &s, nullptr);
    return -(m + logf(s));
  }
};

// Gravitational N-body over the flattened configuration q = x [N, S], with
// S = D / N space dims: U = -G sum_{i<j} m_i m_j / r_ij, r_ij softened as
// sqrt(|x_j - x_i|^2 + eps^2); dU/dx_i = -m_i G sum_{j != i} m_j
// (x_j - x_i) / r_ij^3. params = masses [N], (G, eps^2).
struct NbodyForm {
  const float* mass;    // [N]
  const float* consts;  // [2]
  int n;

  static constexpr bool kTiled = false;
  static constexpr int kBufPad = 1;

  __host__ __device__ int shared_floats(int, int) const { return n + 2; }

  __device__ void stage(float* sh, int, int) const {
    for (int i = threadIdx.x; i < n; i += blockDim.x) sh[i] = mass[i];
    if (threadIdx.x < 2) sh[n + threadIdx.x] = consts[threadIdx.x];
  }

  __device__ static float inv_dist(const float* buf, int i, int j, int s,
                                   float eps2) {
    float d2 = 0.0f;
    for (int c = 0; c < s; ++c) {
      const float r = buf[j * s + c] - buf[i * s + c];
      d2 += r * r;
    }
    return 1.0f / sqrtf(d2 + eps2);
  }

  __device__ void grad(const float qv[4], float gv[4], int lane, int, int d,
                       const float* sh, float* buf) const {
    share_walker(qv, lane, d, buf);
    const int s = d / n, base = 4 * lane;
    const float big_g = sh[n], eps2 = sh[n + 1];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      gv[e] = 0.0f;
      const int dim = base + e;
      if (dim >= d) continue;
      const int i = dim / s, c = dim % s;
      float acc = 0.0f;
      for (int j = 0; j < n; ++j) {
        if (j == i) continue;
        const float inv = inv_dist(buf, i, j, s, eps2);
        acc += (sh[j] * (inv * inv * inv)) * (buf[j * s + c] - buf[i * s + c]);
      }
      gv[e] = -sh[i] * (big_g * acc);
    }
    __syncwarp();
  }

  __device__ float value(const float qv[4], const float[4], int lane, int,
                         int d, const float* sh, float* buf) const {
    share_walker(qv, lane, d, buf);
    const int s = d / n;
    float total = 0.0f;
    for (int i = 0; i < n; ++i) {
      float row = 0.0f;
      for (int j = 0; j < n; ++j)
        if (j != i) row += sh[j] * inv_dist(buf, i, j, s, sh[n + 1]);
      total += sh[i] * row;
    }
    __syncwarp();
    return (-0.5f * sh[n]) * total;
  }
};

// Bayesian logistic regression, q = (w [P], b), D = P + 1, over N rows of
// data (x [N, P], y [N]):
//   U = 0.5 |q|^2 + D log(2 pi) / 2 + sum_n softplus(z_n) - y_n z_n,
//   z = x w + b;  dU/dw = w + x^T (sigmoid(z) - y),  dU/db = b + sum_n
//   (sigmoid(z_n) - y_n):
// the potential of models/examples.py logistic_regression (N(0, 1) priors on
// w and b, Bernoulli-logits likelihood), constants included. It is the
// data-matmul potential that the TPU ran through its walker-packed kernel.
//
// x is staged once a block with a column of ones appended (so that b is
// one more weight), padded with zeros to 4 T columns plus 4 (a row stride of
// 4 T + 4 floats keeps the rows that a walker's lanes read together in
// different banks) and to a multiple of T rows; y after it. Both products
// with x run here, in T-row chunks: lane l of the walker takes row c + l,
// its z a full dot product against the walker's q in its shared buffer row
// (index order), then the residual sigmoid(z) - y; the T residuals of the
// chunk go from lane to lane by shuffle, in row order, and each lane adds
// r_n x[n][its four dims] into its gradient. So the sums over n and over
// dims run in index order, as in the plain version, and no residual is
// stored. The value's sum over rows is per lane (rows l, l + T, ...) and
// then a butterfly over the lanes.
//
// What holds it back: each multiply-add pair of the z pass loads 8 bytes
// from shared memory (x and q), of the gradient pass 4, so the loop runs at
// the shared-memory rate, several times under the arithmetic rate; a tile
// of rows or walkers in registers, as the Gaussian form has, is the next
// step.
struct LogisticForm {
  const float* x;  // [N, D - 1] row-major
  const float* y;  // [N]
  int n;

  static constexpr bool kTiled = false;
  static constexpr int kBufPad = 4;  // rows stay 16-byte aligned

  __host__ __device__ int rows(int tpw) const {
    return (n + tpw - 1) / tpw * tpw;
  }
  __host__ __device__ static int stride(int tpw) { return 4 * tpw + 4; }

  // x rows and y, rounded up to whole 16 bytes
  __host__ __device__ int shared_floats(int, int tpw) const {
    return (rows(tpw) * (stride(tpw) + 1) + 3) / 4 * 4;
  }

  __device__ void stage(float* sh, int d, int tpw) const {
    const int st = stride(tpw), nr = rows(tpw);
    for (int i = threadIdx.x; i < nr * st; i += blockDim.x) {
      const int r = i / st, c = i - r * st;
      float v = 0.0f;
      if (r < n) v = c < d - 1 ? x[r * (d - 1) + c] : (c == d - 1 ? 1.0f : 0.0f);
      sh[i] = v;
    }
    for (int i = threadIdx.x; i < nr; i += blockDim.x)
      sh[nr * st + i] = i < n ? y[i] : 0.0f;
  }

  // z of row `row` for the walker whose q lies in buf
  __device__ __forceinline__ static float logit(const float* sh,
                                                const float* buf, int row,
                                                int st, int tpw) {
    const float4* xr = reinterpret_cast<const float4*>(sh + row * st);
    const float4* qs = reinterpret_cast<const float4*>(buf);
    float z = 0.0f;
    for (int k = 0; k < tpw; ++k) {
      const float4 xv = xr[k], qq = qs[k];
      z += xv.x * qq.x;
      z += xv.y * qq.y;
      z += xv.z * qq.z;
      z += xv.w * qq.w;
    }
    return z;
  }

  __device__ __forceinline__ static void share(const float qv[4], int lane,
                                               float* buf) {
    *reinterpret_cast<float4*>(buf + 4 * lane) =
        make_float4(qv[0], qv[1], qv[2], qv[3]);  // zeros past D
    __syncwarp();
  }

  __device__ void grad(const float qv[4], float gv[4], int lane, int tpw,
                       int, const float* sh, float* buf) const {
    share(qv, lane, buf);
    const int st = stride(tpw), nr = rows(tpw);
    const float* ys = sh + nr * st;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int c = 0; c < nr; c += tpw) {
      const int row = c + lane;
      const float z = logit(sh, buf, row, st, tpw);
      const float r = row < n ? 1.0f / (1.0f + expf(-z)) - ys[row] : 0.0f;
      for (int j = 0; j < tpw; ++j) {
        const float rj = __shfl_sync(0xffffffffu, r, j, tpw);
        const float4 xv =
            reinterpret_cast<const float4*>(sh + (c + j) * st)[lane];
        acc[0] += rj * xv.x;
        acc[1] += rj * xv.y;
        acc[2] += rj * xv.z;
        acc[3] += rj * xv.w;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) gv[e] = qv[e] + acc[e];
    __syncwarp();
  }

  __device__ float value(const float qv[4], const float[4], int lane, int tpw,
                         int d, const float* sh, float* buf) const {
    share(qv, lane, buf);
    const int st = stride(tpw), nr = rows(tpw);
    const float* ys = sh + nr * st;
    float lik = 0.0f;
    for (int row = lane; row < n; row += tpw) {
      const float z = logit(sh, buf, row, st, tpw);
      lik += (fmaxf(z, 0.0f) + log1pf(expf(-fabsf(z)))) - ys[row] * z;
    }
    __syncwarp();
    float quad = 0.0f;
#pragma unroll
    for (int e = 0; e < 4; ++e) quad += qv[e] * qv[e];
    return (0.5f * segment_sum(quad, tpw) + segment_sum(lik, tpw)) +
           0.918938533204672742f * (float)d;
  }
};

// Non-centred eight schools over J groups, q = (mu, log tau, theta [J]),
// D = J + 2, data y [J], sigma [J]: the potential of models/examples.py
// eight_schools_noncentered in unconstrained coordinates,
//   U = mu^2 / 50 + log1p((tau / 5)^2) - log tau + |theta|^2 / 2
//       + sum_j ((y_j - mu - tau theta_j) / sigma_j)^2 / 2 + c,  tau = e^q1,
// from mu ~ N(0, 5), tau ~ HalfCauchy(5) with the Jacobian of tau = e^q1,
// theta ~ N(0, 1) and y_j ~ N(mu + tau theta_j, sigma_j); c collects the
// normalising constants (consts[0], summed on the host in float64). Every
// lane of the walker runs the J terms in index order.
struct EightSchoolsForm {
  const float* y;       // [J]
  const float* sigma;   // [J]
  const float* consts;  // [1]
  int j;

  static constexpr bool kTiled = false;
  static constexpr int kBufPad = 1;

  __host__ __device__ int shared_floats(int, int) const { return 2 * j + 1; }

  __device__ void stage(float* sh, int, int) const {
    for (int i = threadIdx.x; i < j; i += blockDim.x) {
      sh[i] = y[i];
      sh[j + i] = sigma[i];
    }
    if (threadIdx.x == 0) sh[2 * j] = consts[0];
  }

  // ((y_i - (mu + tau theta_i)) / sigma_i
  __device__ __forceinline__ float resid(const float* sh, const float* buf,
                                         int i, float mu, float tau) const {
    return (sh[i] - (mu + tau * buf[2 + i])) / sh[j + i];
  }

  __device__ void grad(const float qv[4], float gv[4], int lane, int, int d,
                       const float* sh, float* buf) const {
    share_walker(qv, lane, d, buf);
    const float mu = buf[0], tau = expf(buf[1]);
    float s1 = 0.0f, s2 = 0.0f;
    for (int i = 0; i < j; ++i) {
      const float e = resid(sh, buf, i, mu, tau) / sh[j + i];
      s1 += e;
      s2 += e * buf[2 + i];
    }
    const int base = 4 * lane;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int dim = base + e;
      float v = 0.0f;
      if (dim == 0) {
        v = mu / 25.0f - s1;
      } else if (dim == 1) {
        const float t = tau / 5.0f;
        v = ((2.0f * (t * t)) / (1.0f + t * t) - 1.0f) - tau * s2;
      } else if (dim < d) {
        const int i = dim - 2;
        v = qv[e] - tau * (resid(sh, buf, i, mu, tau) / sh[j + i]);
      }
      gv[e] = v;
    }
    __syncwarp();
  }

  __device__ float value(const float qv[4], const float[4], int lane, int,
                         int d, const float* sh, float* buf) const {
    share_walker(qv, lane, d, buf);
    const float mu = buf[0], lt = buf[1], tau = expf(buf[1]);
    float st = 0.0f, sz = 0.0f;
    for (int i = 0; i < j; ++i) {
      const float z = resid(sh, buf, i, mu, tau);
      st += buf[2 + i] * buf[2 + i];
      sz += z * z;
    }
    __syncwarp();
    const float t = tau / 5.0f;
    return ((((mu * mu) / 50.0f + log1pf(t * t)) - lt) + 0.5f * st) +
           0.5f * sz + sh[2 * j];
  }
};

// The gradients and the values of a lane group's R walkers: a tiled form
// takes them together, any other one walker after the other (R = 1 for
// them, see with_tile).
template <int R, class Form>
__device__ __forceinline__ void grad_walkers(const Form& form,
                                             const float (*qv)[4],
                                             float (*gv)[4], int lane, int tpw,
                                             int d, const float* sh,
                                             float* buf, int row_step) {
  if constexpr (Form::kTiled) {
    form.template grad<R>(qv, gv, lane, tpw, d, sh, buf, row_step);
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r)
      form.grad(qv[r], gv[r], lane, tpw, d, sh, buf + r * row_step);
  }
}

template <int R, class Form>
__device__ __forceinline__ void value_walkers(const Form& form,
                                              const float (*qv)[4],
                                              const float (*gv)[4], int lane,
                                              int tpw, int d, const float* sh,
                                              float* buf, int row_step,
                                              float u[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
    u[r] = form.value(qv[r], gv[r], lane, tpw, d, sh, buf + r * row_step);
}

// Bytes of dynamic shared memory of a block: the form's parameters, then
// a buffer row for each of its kBlock / T * R walkers.
template <class Form>
size_t shared_bytes(const Form& form, int num_dims, int tpw, int tile) {
  return sizeof(float) * (form.shared_floats(num_dims, tpw) +
                          kBlock / tpw * tile * (4 * tpw + Form::kBufPad));
}

// Run `body(std::integral_constant<int, R>)` for the walker tile R = `tile`:
// 1, 2 or 4 for a tiled form, 1 for any other.
template <class Form, class Body>
int with_tile(int tile, Body body) {
  if constexpr (Form::kTiled) {
#ifdef PBBI_G_TILE8  // for tools/kernel_sweeps.py only: never the chooser's
    if (tile == 8) return body(std::integral_constant<int, 8>{});
#endif
    if (tile == 4) return body(std::integral_constant<int, 4>{});
    if (tile == 2) return body(std::integral_constant<int, 2>{});
  }
  if (tile != 1) return (int)cudaErrorInvalidValue;
  return body(std::integral_constant<int, 1>{});
}

// Run `body(form)` with the device form numbered `form` (ops/kernels.py
// FORM_IDS): 0 Gaussian (param0 mean, param1 precision), 1 funnel
// (param0), 2 banana (param0; D = 2), 3 mixture (param0 means, param1 log
// weights, param2 inv_var; count = K), 4 N-body (param0 masses, param1
// (G, eps^2); count = N, D a multiple of N), 5 diagonal quadratic (param0
// k, param1 mean), 6 logistic regression (param0 x, param1 y; count = N
// rows, D - 1 columns), 7 non-centred eight schools (param0 y, param1
// sigma, param2 the constant; count = J = D - 2). Returns
// cudaErrorInvalidValue for a form or parameter count it does not take.
template <class Body>
int with_form(int form, const float* param0, const float* param1,
              const float* param2, int count, int num_dims, Body body) {
  switch (form) {
    case 0:
      return body(GaussianForm{param0, param1});
    case 1:
      return body(FunnelForm{param0});
    case 2:
      if (num_dims != 2) return (int)cudaErrorInvalidValue;
      return body(BananaForm{param0});
    case 3:
      if (count <= 0) return (int)cudaErrorInvalidValue;
      return body(MixtureForm{param0, param1, param2, count});
    case 4:
      if (count <= 0 || num_dims % count != 0)
        return (int)cudaErrorInvalidValue;
      return body(NbodyForm{param0, param1, count});
    case 5:
      return body(DiagQuadraticForm{param0, param1});
    case 6:
      if (count <= 0) return (int)cudaErrorInvalidValue;
      return body(LogisticForm{param0, param1, count});
    case 7:
      if (count <= 0 || num_dims != count + 2)
        return (int)cudaErrorInvalidValue;
      return body(EightSchoolsForm{param0, param1, param2, count});
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
