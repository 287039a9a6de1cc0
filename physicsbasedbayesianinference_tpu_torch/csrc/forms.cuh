// Device forms of the potentials, shared by kernel B (fused_hmc.cu) and
// kernel D (leapfrog.cu), and the warp layout they run in (the lane-group
// layout; the eight-schools, funnel, N-body and mixture forms also run one
// walker a thread, thread_layout.cu).
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
// The Gaussian and the logistic and linear regressions are the forms with
// arithmetic enough to bound a kernel (a D x D matvec, or two N x D
// products, per leapfrog step against 4 D floats moved), and the ones that
// take R > 1 (kTiled): a thread keeps the [R][4] tile of the gradient in
// registers and reads each operand from shared memory once for its R
// walkers (GaussianForm::grad, LogisticForm::grad). A tiled form may keep scratch
// for each lane group after the walkers' buffer rows (scratch_floats), and
// may evaluate the R values together (kTiledValue). The other forms take
// one walker a lane group, as written for it.

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
// rows of x that a lane of the logistic form takes together (its row tile)
#ifndef PBBI_L_ROWS
#define PBBI_L_ROWS 4
#endif
constexpr int kLogisticRows = PBBI_L_ROWS;

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

// A 16-byte load from shared memory at p that stays where it is written
// (asm volatile). A form's parameters do not change within a
// trajectory, and the compiler, free to hoist their loads out of the
// loop, holds every one of them in registers: the mixture's KP N means
// one walker a thread spilled 500-870 bytes a thread at KP = 8 (nvcc
// -Xptxas -v, tools/kernel_sweeps.py --only registers).
__device__ __forceinline__ float4 shared_load4(const float* p) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"((unsigned)__cvta_generic_to_shared(p)));
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

// U = 0.5 sum_d k_d (q_d - mu_d)^2 + c (kernel A's targets, with c = 0;
// c is a model's normalising constant, the funnel model's under
// reparam="auto"); gradient k_d (q_d - mu_d), separable, so no walker
// buffer.
struct DiagQuadraticForm {
  const float* k;                 // [D]
  const float* mean;              // [D]
  const float* consts = nullptr;  // [1]: c, or null for 0
  static constexpr bool kTiled = false;
  static constexpr int kBufPad = 1;

  __host__ __device__ int shared_floats(int d, int) const {
    return 2 * d + 1;
  }

  __device__ void stage(float* sh, int d, int) const {
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      sh[i] = k[i];
      sh[d + i] = mean[i];
    }
    if (threadIdx.x == 0) sh[2 * d] = consts != nullptr ? consts[0] : 0.0f;
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
    return 0.5f * segment_sum(part, tpw) + sh[2 * d];
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
  static constexpr bool kTiledValue = false;
  static constexpr int kBufPad = 4;  // rows stay 16-byte aligned

  __host__ __device__ static int chunks(int d) { return (d + 3) / 4; }

  __host__ __device__ int shared_floats(int d, int tpw) const {
    return 4 * tpw * (4 * chunks(d) + 1);
  }
  __host__ __device__ static int scratch_floats(int, int) { return 0; }

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

// Whether dim e of a walker held in N = 4 ceil(D / 4) registers is one of
// its d: always below N - 3, which the compiler folds (d >= N - 3).
template <int N>
__device__ __forceinline__ bool in_dims(int e, int d) {
  return e < N - 3 || e < d;
}

// Neal's funnel, q = (v, x): U = v^2 / (2 s^2) + (D-1)/2 v + e^-v |x|^2 / 2
// + c. params = (2 s^2, (D-1)/2); c = 0 for the analytic target, the
// normalising constant for the funnel model of the DSL.
//
// Two layouts with the same arithmetic (sx = sum_{j >= 1} x_j^2 in index
// order, one e^-v, then g_j = e^-v x_j and g_0 = 2 v / (2 s^2) + (D-1)/2 -
// (e^-v / 2) sx), so that both and the plain versions (ops/kernels.py
// _funnel_vg) round alike: one walker a thread (grad_thread, value_thread;
// thread_layout.cu, up to D = 16), the walker's dims in registers; T lanes
// a walker above that (grad, value), each lane reading the walker from its
// buffer row and running the sum alone.
struct FunnelForm {
  const float* params;            // [2]
  const float* consts = nullptr;  // [1]: c, or null for 0

  static constexpr bool kTiled = false;
  static constexpr int kBufPad = 1;

  __host__ __device__ int shared_floats(int, int) const { return 3; }

  __device__ void stage(float* sh, int, int) const {
    if (threadIdx.x < 2) sh[threadIdx.x] = params[threadIdx.x];
    if (threadIdx.x == 2) sh[2] = consts != nullptr ? consts[0] : 0.0f;
  }

  // sum_{1 <= j < d} q_j^2 of a walker in registers
  template <int N>
  __device__ __forceinline__ static float sum_x2(const float q[N], int d) {
    float s = 0.0f;
#pragma unroll
    for (int e = 1; e < N; ++e)
      if (in_dims<N>(e, d)) s += q[e] * q[e];
    return s;
  }

  // One walker a thread: its N >= D dims in registers (zeros past D).
  template <int N>
  __device__ __forceinline__ void grad_thread(const float q[N], float g[N],
                                              int d, const float* sh) const {
    const float v = q[0], sx = sum_x2<N>(q, d);
    const float ev = expf(-v);
#pragma unroll
    for (int e = 1; e < N; ++e) g[e] = in_dims<N>(e, d) ? ev * q[e] : 0.0f;
    g[0] = 2.0f * v / sh[0] + sh[1] - 0.5f * ev * sx;
  }

  template <int N>
  __device__ __forceinline__ float value_thread(const float q[N], int d,
                                                const float* sh) const {
    const float v = q[0], sx = sum_x2<N>(q, d);
    return v * v / sh[0] + sh[1] * v + 0.5f * expf(-v) * sx + sh[2];
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
    return v * v / sh[0] + sh[1] * v + 0.5f * expf(-v) * sx + sh[2];
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
//
// Two layouts with the same arithmetic, so that both and the plain version
// (ops/kernels.py _mixture_vg) round alike: the terms t_c = log w_c -
// (inv_var / 2) s_c with s_c = sum_j (q_j - mu_cj)^2 in j order, m = fmaxf
// over c in order, s = sum_c e^(t_c - m) and num_j = sum_c e^(t_c - m)
// (q_j - mu_cj) in c order, then g_j = (inv_var num_j) / s and U = -(m +
// log s). T lanes a walker (this struct: grad, value), every lane reading
// the walker from its buffer row; one walker a thread (MixtureThreadForm,
// thread_layout.cu).
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

// Components the mixture's thread layout takes (thread_layout.cu): every
// driven mixture has two (parallel tempering's bimodal target), so only
// KP = 2 is built; a mixture of more components runs in the lane groups.
// A larger KP is one more case in thread_layout.cu's with_thread_form
// (KP = 4 and 8 were built and swept: PERF.md).
constexpr int kMaxMixture = 2;

// The mixture one walker a thread (thread_layout.cu, up to kMaxMixture
// components and D = 16: ops/kernels.py walker_layout), with the K
// components padded to KP, a number fixed at compile time, so
// that the KP terms live in registers and every loop is unrolled: the
// walker's q stays in its registers, the terms are taken once a gradient
// (the lane groups take each twice, once for the max and once for the
// exponentials), and the means are 16-byte broadcasts from shared memory.
// A padding component has log w = -inf and a mean of zeros, so its term is
// -inf, its e^(t - m) exactly 0, and it adds exactly 0 to s and +-0 to
// num_j (which is never -0): a padded K keeps the bits of K. Dims past D
// (the N - D of the registers) are skipped, and g there is 0.
//
// Shared memory: the means as KP rows of N = 4 ceil(D / 4) floats (zeros
// past D and past K), then the KP log weights, then inv_var.
template <int KP>
struct MixtureThreadForm : MixtureForm {
  __host__ __device__ static int stride(int d) { return (d + 3) / 4 * 4; }

  __host__ __device__ int shared_floats(int d, int) const {
    return KP * stride(d) + KP + 1;
  }

  __device__ void stage(float* sh, int d, int) const {
    const int n = stride(d);
    for (int i = threadIdx.x; i < KP * n; i += blockDim.x) {
      const int c = i / n, j = i - c * n;
      sh[i] = (c < k && j < d) ? means[c * d + j] : 0.0f;
    }
    for (int c = threadIdx.x; c < KP; c += blockDim.x)
      sh[KP * n + c] = c < k ? log_w[c] : -INFINITY;
    if (threadIdx.x == 0) sh[KP * n + KP] = inv_var[0];
  }

  // Component c's mean, dims 4 m .. 4 m + 3: one 16-byte broadcast, read
  // where it is used (shared_load4).
  template <int N>
  __device__ __forceinline__ static float4 mean4(const float* sh, int c,
                                                 int m) {
    return shared_load4(sh + c * N + 4 * m);
  }

  // The KP component terms into t, and their max.
  template <int N>
  __device__ __forceinline__ float terms(const float q[N], int d,
                                         const float* sh, float t[KP]) const {
    const float half_iv = 0.5f * sh[KP * N + KP];
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < KP; ++c) {
      float s = 0.0f;
#pragma unroll
      for (int m = 0; m < N / 4; ++m) {
        const float4 mu = mean4<N>(sh, c, m);
        const float mv[4] = {mu.x, mu.y, mu.z, mu.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (in_dims<N>(4 * m + e, d)) {
            const float diff = q[4 * m + e] - mv[e];
            s += diff * diff;
          }
        }
      }
      t[c] = sh[KP * N + c] - half_iv * s;
      mx = fmaxf(mx, t[c]);
    }
    return mx;
  }

  template <int N>
  __device__ __forceinline__ void grad_thread(const float q[N], float g[N],
                                              int d, const float* sh) const {
    float t[KP];
    const float mx = terms<N>(q, d, sh, t);
    float s = 0.0f;
#pragma unroll
    for (int e = 0; e < N; ++e) g[e] = 0.0f;
#pragma unroll
    for (int c = 0; c < KP; ++c) {
      const float ex = expf(t[c] - mx);
      s += ex;
#pragma unroll
      for (int m = 0; m < N / 4; ++m) {
        const float4 mu = mean4<N>(sh, c, m);
        const float mv[4] = {mu.x, mu.y, mu.z, mu.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 4 * m + e;
          if (in_dims<N>(j, d)) g[j] += ex * (q[j] - mv[e]);
        }
      }
    }
    const float iv = sh[KP * N + KP];
#pragma unroll
    for (int e = 0; e < N; ++e)
      if (in_dims<N>(e, d)) g[e] = (iv * g[e]) / s;
  }

  template <int N>
  __device__ __forceinline__ float value_thread(const float q[N], int d,
                                                const float* sh) const {
    float t[KP];
    const float mx = terms<N>(q, d, sh, t);
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < KP; ++c) s += expf(t[c] - mx);
    return -(mx + logf(s));
  }
};

// Gravitational N-body over the flattened configuration q = x [N, S], with
// S = D / N space dims: U = -G sum_{i<j} m_i m_j / r_ij, r_ij softened as
// sqrt(|x_j - x_i|^2 + eps^2); dU/dx_i = -m_i G sum_{j != i} m_j
// (x_j - x_i) / r_ij^3. params = masses [N], (G, eps^2).
//
// Two layouts, the same sums (ops/kernels.py _nbody_vg): each body's
// acc_i = sum_{j != i} (m_j inv_ij^3) (x_j - x_i) and row_i = sum_{j != i}
// m_j inv_ij in increasing j, then g_i = -m_i (G acc_i) and U = (-G / 2)
// sum_i m_i row_i in increasing i, with inv_ij = 1 / sqrtf(d2 + eps^2) and
// d2 = sum_c (x_jc - x_ic)^2 in c order.
// * T lanes a walker (grad, value): each of the walker's D dims is a
//   lane's, and recomputes inv_ij to all N - 1 partners of its body; every
//   lane runs all N^2 pairs of the value.
// * one walker a thread (NbodyThreadForm<S>: grad_thread, value_thread;
//   thread_layout.cu, S = 2 or 3 up to D = 24): the pairs i < j once each,
//   in index order, i outer. A pair's inv serves both bodies: acc_i gains
//   (m_j inv^3) (x_j - x_i) and acc_j gains (m_i inv^3) (x_i - x_j). So a
//   body gains its partners below it in earlier outer passes and those
//   above it in its own, in increasing order, and as (x_i - x_j)^2 rounds
//   as (x_j - x_i)^2, every term is the lane groups' term: the same bits.
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

// The N-body form one walker a thread at S space dims: the thread's N >= D
// registers hold bodies 0 .. N / S - 1 (zeros past D), of which the first
// n are the walker's (NbodyForm's comment).
template <int S>
struct NbodyThreadForm : NbodyForm {
  // Whether body i of the N / S in registers is one of the walker's n:
  // always below ceil((N - 3) / S), which the compiler folds.
  template <int N>
  __device__ __forceinline__ bool is_body(int i) const {
    return i < (N - 3 + S - 1) / S || i < n;
  }

  // 1 / r of bodies i < j
  template <int N>
  __device__ __forceinline__ static float inv_pair(const float q[N], int i,
                                                   int j, float eps2,
                                                   float r[S]) {
    float d2 = 0.0f;
#pragma unroll
    for (int c = 0; c < S; ++c) {
      r[c] = q[j * S + c] - q[i * S + c];
      d2 += r[c] * r[c];
    }
    return 1.0f / sqrtf(d2 + eps2);
  }

  template <int N>
  __device__ __forceinline__ void grad_thread(const float q[N], float g[N],
                                              int, const float* sh) const {
    constexpr int kBodies = N / S;
    const float big_g = sh[n], eps2 = sh[n + 1];
#pragma unroll
    for (int e = 0; e < N; ++e) g[e] = 0.0f;
#pragma unroll
    for (int i = 0; i < kBodies; ++i) {
#pragma unroll
      for (int j = i + 1; j < kBodies; ++j) {
        if (is_body<N>(j)) {
          float r[S];
          const float inv = inv_pair<N>(q, i, j, eps2, r);
          const float inv3 = inv * inv * inv;
          const float to_i = sh[j] * inv3, to_j = sh[i] * inv3;
#pragma unroll
          for (int c = 0; c < S; ++c) {
            g[i * S + c] += to_i * r[c];
            g[j * S + c] += to_j * -r[c];
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kBodies; ++i) {
      if (is_body<N>(i)) {
#pragma unroll
        for (int c = 0; c < S; ++c)
          g[i * S + c] = -sh[i] * (big_g * g[i * S + c]);
      }
    }
  }

  template <int N>
  __device__ __forceinline__ float value_thread(const float q[N], int,
                                                const float* sh) const {
    constexpr int kBodies = N / S;
    const float eps2 = sh[n + 1];
    float row[kBodies];
#pragma unroll
    for (int i = 0; i < kBodies; ++i) row[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < kBodies; ++i) {
#pragma unroll
      for (int j = i + 1; j < kBodies; ++j) {
        if (is_body<N>(j)) {
          float r[S];
          const float inv = inv_pair<N>(q, i, j, eps2, r);
          row[i] += sh[j] * inv;
          row[j] += sh[i] * inv;
        }
      }
    }
    float total = 0.0f;
#pragma unroll
    for (int i = 0; i < kBodies; ++i)
      if (is_body<N>(i)) total += sh[i] * row[i];
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
// one more weight), padded with zeros to 4 T columns plus 4 (a row stride
// of 4 T + 4 floats puts the rows that a lane group reads together in
// different banks) and to a multiple of a chunk of C = T kRows rows; y
// after it. A lane group owns R walkers (the walker tile) and takes the
// rows a chunk at a time, each chunk in two passes, both register-tiled:
//
// * z pass: lane l takes the kRows rows c + m T + l (m < kRows) for all R
//   walkers, a [kRows][R] tile of accumulators. Per dim-group k it loads
//   the four floats of x of each of its rows and the four of q of each
//   walker (from the walkers' buffer rows; the same address for the
//   group's lanes) and does 4 kRows R multiply-adds: every operand feeds
//   R or kRows of them. Each z sums its dims in index order, one fmaf a
//   dim. The residuals sigmoid(z) - y go to the group's scratch, a
//   [C][R] tile (rows past N give 0).
// * gradient pass: lane l keeps its four dims of the R walkers' gradient
//   (the [R][4] tile the kernels hold) and, per row j of the chunk, loads
//   the row's four x floats (one load) and its R residuals (one load, the
//   same address for the group's lanes): 4 R multiply-adds, summed over
//   the rows in index order, one fmaf each. g = q + that sum.
//
// So every sum runs in index order as the plain version's does, which
// rounds each multiply-add once as well (ops/kernels.py _logistic_vg). The
// value takes the z pass alone; lane l's likelihood terms are its rows l,
// l + T, ... in turn, then a butterfly over the lanes.
//
// What bounds it, at kRows = R = 4 (the chooser's tile at W = 102400, D =
// 32): a z-pass dim-group is 8 16-byte loads a lane for 64 multiply-adds,
// a gradient-pass row 2 for 16: 2 bytes from shared memory a multiply-add
// in both passes (the residual tile adds 1/16 of a load a row). A warp's
// 16-byte load costs four wavefronts of 128 bytes, broadcast or not (the
// Gaussian form's sweep, tools/kernel_sweeps.py), and an SM takes one
// wavefront and four warp-wide FP32 instructions a clock, so both passes
// run 2 warp-wide multiply-add instructions a wavefront: half the FP32
// rate (8 a wavefront if a broadcast cost one). The sigmoid adds about 8
// instructions a row and walker. x, y, the buffer rows and the residual
// tiles take 72.5 KB a block at N = 256, D = 32, R = 4; the registers (q,
// g, p: 12 R floats, the z tile 16, its operands 20) cap it at 2 blocks,
// 128 registers a thread with 16-28 bytes of spill at R = 4 (none at R =
// 1, 2; nvcc -Xptxas -v). Measured on an H100 at 700 W: kernel B 2.71 ms
// at W = 102400, D = 32, N = 256, L = 16 (5.11 before the tile), 36% of
// its FP32 bound; the row tile (2, 4, 8) and the step from R = 2 to 4 move
// it by 6% or less, an approximate sigmoid by 10%, and 8 warps an SM in
// place of 16 (no register cap) make it 25% slower (tools/kernel_sweeps.py
// --only logistic): at R = 4 a warp waits on each dim-group's loads
// before its multiply-adds, more than on the shared-memory rate (PERF.md).
struct LogisticForm {
  const float* x;  // [N, D - 1] row-major
  const float* y;  // [N]
  int n;

  static constexpr bool kTiled = true;
  static constexpr bool kTiledValue = true;
  static constexpr int kBufPad = 4;  // rows stay 16-byte aligned

  __host__ __device__ static int chunk(int tpw) { return kLogisticRows * tpw; }
  __host__ __device__ int rows(int tpw) const {
    return (n + chunk(tpw) - 1) / chunk(tpw) * chunk(tpw);
  }
  __host__ __device__ static int stride(int tpw) { return 4 * tpw + 4; }
  // a lane group's residual tile; the 4 floats more put neighbouring
  // groups' tiles in different banks
  __host__ __device__ static int tile_floats(int tpw, int tile) {
    return chunk(tpw) * tile + 4;
  }

  // x rows and y, rounded up to whole 16 bytes
  __host__ __device__ int shared_floats(int, int tpw) const {
    return (rows(tpw) * (stride(tpw) + 1) + 3) / 4 * 4;
  }
  __host__ __device__ static int scratch_floats(int tpw, int tile) {
    return kBlock / tpw * tile_floats(tpw, tile);
  }

  // x's `cols` columns, then a column of ones, zeros after; then y
  __device__ void stage_rows(float* sh, int cols, int tpw) const {
    const int st = stride(tpw), nr = rows(tpw);
    for (int i = threadIdx.x; i < nr * st; i += blockDim.x) {
      const int r = i / st, c = i - r * st;
      float v = 0.0f;
      if (r < n) v = c < cols ? x[r * cols + c] : (c == cols ? 1.0f : 0.0f);
      sh[i] = v;
    }
    for (int i = threadIdx.x; i < nr; i += blockDim.x)
      sh[nr * st + i] = i < n ? y[i] : 0.0f;
  }

  __device__ void stage(float* sh, int d, int tpw) const {
    stage_rows(sh, d - 1, tpw);
  }

  // the R walkers' q into their buffer rows (zeros past D)
  template <int R>
  __device__ __forceinline__ static void share(const float (*qv)[4], int lane,
                                               float* buf, int row_step) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      *reinterpret_cast<float4*>(buf + r * row_step + 4 * lane) =
          make_float4(qv[r][0], qv[r][1], qv[r][2], qv[r][3]);
    __syncwarp();
  }

  // z[m][r] of row row0 + m T for walker r, over the dims in index order
  template <int R>
  __device__ __forceinline__ static void logits(const float* sh,
                                                const float* buf,
                                                int row_step, int row0,
                                                int st, int tpw, int d,
                                                float (*z)[R]) {
#pragma unroll
    for (int m = 0; m < kLogisticRows; ++m)
#pragma unroll
      for (int r = 0; r < R; ++r) z[m][r] = 0.0f;
    const float* xr = sh + row0 * st;
    const int groups = (d + 3) / 4;  // the dim-groups past D add zeros
    for (int k = 0; k < groups; ++k) {
      float4 xv[kLogisticRows];
#pragma unroll
      for (int m = 0; m < kLogisticRows; ++m)
        xv[m] = reinterpret_cast<const float4*>(xr + m * tpw * st)[k];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 qq =
            reinterpret_cast<const float4*>(buf + r * row_step)[k];
#pragma unroll
        for (int m = 0; m < kLogisticRows; ++m)
          z[m][r] = fmaf(xv[m].w, qq.w,
                         fmaf(xv[m].z, qq.z,
                              fmaf(xv[m].y, qq.y,
                                   fmaf(xv[m].x, qq.x, z[m][r]))));
      }
    }
  }

  // this lane group's residual tile, after the block's walker buffer rows
  template <int R>
  __device__ __forceinline__ float* residuals(const float* sh, int d,
                                              int tpw, int row_step) const {
    const int slot = threadIdx.x / tpw;
    return const_cast<float*>(sh) + shared_floats(d, tpw) + R * row_step +
           slot * tile_floats(tpw, R);
  }

  template <int R>
  __device__ __forceinline__ static void store_tile(float* at,
                                                    const float v[R]) {
    if constexpr (R == 4) {
      *reinterpret_cast<float4*>(at) = make_float4(v[0], v[1], v[2], v[3]);
    } else if constexpr (R == 2) {
      *reinterpret_cast<float2*>(at) = make_float2(v[0], v[1]);
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) at[r] = v[r];
    }
  }

  template <int R>
  __device__ __forceinline__ static void load_tile(const float* at,
                                                   float v[R]) {
    if constexpr (R == 4) {
      const float4 t = *reinterpret_cast<const float4*>(at);
      v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
    } else if constexpr (R == 2) {
      const float2 t = *reinterpret_cast<const float2*>(at);
      v[0] = t.x, v[1] = t.y;
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = at[r];
    }
  }

  // the gradient pass over a chunk of rows from row c: gv[r] += x_j
  // res[j][r] for the chunk's rows j in index order, one fmaf each
  template <int R>
  __device__ __forceinline__ static void accumulate_rows(
      const float* sh, const float* res, int c, int st, int ch, int lane,
      float (*gv)[4]) {
    const float4* xc = reinterpret_cast<const float4*>(sh + c * st) + lane;
#pragma unroll 4
    for (int j = 0; j < ch; ++j) {
      const float4 xv = xc[j * (st / 4)];
      float rv[R];
      load_tile<R>(res + j * R, rv);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        gv[r][0] = fmaf(rv[r], xv.x, gv[r][0]);
        gv[r][1] = fmaf(rv[r], xv.y, gv[r][1]);
        gv[r][2] = fmaf(rv[r], xv.z, gv[r][2]);
        gv[r][3] = fmaf(rv[r], xv.w, gv[r][3]);
      }
    }
  }

  template <int R>
  __device__ __forceinline__ void grad(const float (*qv)[4], float (*gv)[4],
                                       int lane, int tpw, int d,
                                       const float* sh, float* buf,
                                       int row_step) const {
    share<R>(qv, lane, buf, row_step);
    const int st = stride(tpw), nr = rows(tpw), ch = chunk(tpw);
    const float* ys = sh + nr * st;
    float* res = residuals<R>(sh, d, tpw, row_step);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) gv[r][e] = 0.0f;
    for (int c = 0; c < nr; c += ch) {
      float z[kLogisticRows][R];
      logits<R>(sh, buf, row_step, c + lane, st, tpw, d, z);
#pragma unroll
      for (int m = 0; m < kLogisticRows; ++m) {
        const int row = c + m * tpw + lane;
        float rv[R];
#pragma unroll
        for (int r = 0; r < R; ++r)
#ifdef PBBI_L_FAST_SIGMOID  // tools/kernel_sweeps.py only: not the plain's
          rv[r] = row < n ? __fdividef(1.0f, 1.0f + __expf(-z[m][r])) - ys[row]
                          : 0.0f;
#else
          rv[r] = row < n ? 1.0f / (1.0f + expf(-z[m][r])) - ys[row] : 0.0f;
#endif
        store_tile<R>(res + (m * tpw + lane) * R, rv);
      }
      __syncwarp();
      accumulate_rows<R>(sh, res, c, st, ch, lane, gv);
      __syncwarp();  // the tile is rewritten by the next chunk
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) gv[r][e] = qv[r][e] + gv[r][e];
  }

  template <int R>
  __device__ __forceinline__ void values(const float (*qv)[4], int lane,
                                         int tpw, int d, const float* sh,
                                         float* buf, int row_step,
                                         float u[R]) const {
    share<R>(qv, lane, buf, row_step);
    const int st = stride(tpw), nr = rows(tpw), ch = chunk(tpw);
    const float* ys = sh + nr * st;
    float lik[R];
#pragma unroll
    for (int r = 0; r < R; ++r) lik[r] = 0.0f;
    for (int c = 0; c < nr; c += ch) {
      float z[kLogisticRows][R];
      logits<R>(sh, buf, row_step, c + lane, st, tpw, d, z);
#pragma unroll
      for (int m = 0; m < kLogisticRows; ++m) {
        const int row = c + m * tpw + lane;
        if (row < n) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float zz = z[m][r];
            lik[r] += (fmaxf(zz, 0.0f) + log1pf(expf(-fabsf(zz)))) -
                      ys[row] * zz;
          }
        }
      }
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float quad = 0.0f;
#pragma unroll
      for (int e = 0; e < 4; ++e) quad += qv[r][e] * qv[r][e];
      u[r] = (0.5f * segment_sum(quad, tpw) + segment_sum(lik[r], tpw)) +
             0.918938533204672742f * (float)d;
    }
  }
};

// Bayesian linear regression, q = (w [P], b, s), D = P + 2, s the log of
// the noise scale sigma, over N rows of data (x [N, P], y [N]): the
// potential of models/examples.py linear_regression (w, b ~ N(0, prior^2),
// sigma ~ HalfNormal(1) with the Jacobian of sigma = e^s, y ~ N(x w + b,
// sigma)) in unconstrained coordinates,
//   U = (|w|^2 + b^2) / (2 prior^2) + sigma^2 / 2 - s + N s
//       + sum_n r_n^2 / (2 sigma^2) + c,   r = x w + b - y,
// c its normalising constants (summed on the host in float64). consts =
// (1 / prior^2, c).
//
// It is the logistic form's register tile with an identity link: x is
// staged with a column of ones (b's) and one of zeros (s's, so that z = x
// w + b takes all D dims in the same pass), the z pass and the x^T r pass
// are LogisticForm's, and the residual tile holds r_n e^-2s. The sums of
// r_n^2 (the value's, and the gradient's in s, sigma^2 - 1 + N - e^-2s
// sum_n r_n^2) run as the value's likelihood terms do: lane l its rows l,
// l + T, ... in turn, then a butterfly.
struct LinearForm : LogisticForm {
  const float* consts;  // [2]

  __device__ void stage(float* sh, int d, int tpw) const {
    stage_rows(sh, d - 2, tpw);
  }

  // s of each of the R walkers, from their buffer rows
  template <int R>
  __device__ __forceinline__ static void log_scales(const float* buf,
                                                    int row_step, int d,
                                                    float s[R]) {
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = buf[r * row_step + d - 1];
  }

  template <int R>
  __device__ __forceinline__ void grad(const float (*qv)[4], float (*gv)[4],
                                       int lane, int tpw, int d,
                                       const float* sh, float* buf,
                                       int row_step) const {
    share<R>(qv, lane, buf, row_step);
    const int st = stride(tpw), nr = rows(tpw), ch = chunk(tpw);
    const float* ys = sh + nr * st;
    float* res = residuals<R>(sh, d, tpw, row_step);
    float s[R], iv[R], ss[R];
    log_scales<R>(buf, row_step, d, s);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      iv[r] = expf(-2.0f * s[r]);
      ss[r] = 0.0f;
#pragma unroll
      for (int e = 0; e < 4; ++e) gv[r][e] = 0.0f;
    }
    for (int c = 0; c < nr; c += ch) {
      float z[kLogisticRows][R];
      logits<R>(sh, buf, row_step, c + lane, st, tpw, d, z);
#pragma unroll
      for (int m = 0; m < kLogisticRows; ++m) {
        const int row = c + m * tpw + lane;
        float rv[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          rv[r] = 0.0f;
          if (row < n) {
            const float rr = z[m][r] - ys[row];
            ss[r] += rr * rr;
            rv[r] = rr * iv[r];
          }
        }
        store_tile<R>(res + (m * tpw + lane) * R, rv);
      }
      __syncwarp();
      accumulate_rows<R>(sh, res, c, st, ch, lane, gv);
      __syncwarp();  // the tile is rewritten by the next chunk
    }
    const float ip = consts[0], nf = (float)n;
    const int base = 4 * lane;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float s2 = segment_sum(ss[r], tpw);
      const float gs = ((expf(2.0f * s[r]) - 1.0f) + nf) - iv[r] * s2;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        gv[r][e] = base + e == d - 1 ? gs : qv[r][e] * ip + gv[r][e];
    }
  }

  template <int R>
  __device__ __forceinline__ void values(const float (*qv)[4], int lane,
                                         int tpw, int d, const float* sh,
                                         float* buf, int row_step,
                                         float u[R]) const {
    share<R>(qv, lane, buf, row_step);
    const int st = stride(tpw), nr = rows(tpw), ch = chunk(tpw);
    const float* ys = sh + nr * st;
    float s[R], lik[R];
    log_scales<R>(buf, row_step, d, s);
#pragma unroll
    for (int r = 0; r < R; ++r) lik[r] = 0.0f;
    for (int c = 0; c < nr; c += ch) {
      float z[kLogisticRows][R];
      logits<R>(sh, buf, row_step, c + lane, st, tpw, d, z);
#pragma unroll
      for (int m = 0; m < kLogisticRows; ++m) {
        const int row = c + m * tpw + lane;
        if (row < n) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float rr = z[m][r] - ys[row];
            lik[r] += rr * rr;
          }
        }
      }
    }
    __syncwarp();
    const float ip = consts[0], cst = consts[1], nf = (float)n;
    const int base = 4 * lane;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float quad = 0.0f;  // |w|^2 + b^2: s left out
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = base + e < d - 1 ? qv[r][e] : 0.0f;
        quad += v * v;
      }
      const float iv = expf(-2.0f * s[r]), sig2 = expf(2.0f * s[r]);
      u[r] = (((((0.5f * ip) * segment_sum(quad, tpw) + 0.5f * sig2) - s[r]) +
               nf * s[r]) +
              (0.5f * iv) * segment_sum(lik[r], tpw)) +
             cst;
    }
  }
};

// The two eight-schools forms stage, once a block, each school's pair (y_i,
// r_i = 1 / sigma_i), the reciprocal taken as it is staged, and the
// normalising constant after the pairs (consts[0], summed on the host in
// float64). A school's data is then one 8-byte shared load, the same
// address for every thread (a broadcast), and its terms are products where
// they were divisions. Each form runs in two layouts with the same
// arithmetic, so that the layouts and the plain versions (ops/kernels.py
// _eight_schools_vg, _eight_schools_centred_vg) round alike:
//
// * one walker a thread (thread_layout.cu, up to D = 16, the centred form
//   in kernel D up to 12: ops/kernels.py walker_layout). The thread holds the walker's N = 4 ceil(D / 4) dims in
//   registers, zeros past D, and runs the J terms once a gradient
//   (grad_thread, value_thread): no shared buffer, no warp barrier, no
//   shuffle.
// * T lanes a walker above that, this file's layout: every lane shares the
//   walker through its buffer row, runs the J terms, and takes its own four
//   dims (grad, value).
//
// Sums over the schools run in index order in both; 1 / 25, 1 / 50 and
// 1 / 5 are the products by 0.04, 0.02 and 0.2 (rounded to float32).
__device__ __forceinline__ void stage_schools(float* sh, const float* y,
                                              const float* sigma,
                                              const float* consts, int j) {
  for (int i = threadIdx.x; i < j; i += blockDim.x) {
    sh[2 * i] = y[i];
    sh[2 * i + 1] = 1.0f / sigma[i];
  }
  if (threadIdx.x == 0) sh[2 * j] = consts[0];
}

// Non-centred eight schools over J groups, q = (mu, log tau, theta [J]),
// D = J + 2, data y [J], sigma [J]: the potential of models/examples.py
// eight_schools_noncentered in unconstrained coordinates,
//   U = mu^2 / 50 + log1p((tau / 5)^2) - log tau + |theta|^2 / 2
//       + sum_j ((y_j - mu - tau theta_j) / sigma_j)^2 / 2 + c,  tau = e^q1,
// from mu ~ N(0, 5), tau ~ HalfCauchy(5) with the Jacobian of tau = e^q1,
// theta ~ N(0, 1) and y_j ~ N(mu + tau theta_j, sigma_j); c collects the
// normalising constants. With z_j = (y_j - (mu + tau theta_j)) r_j and
// e_j = z_j r_j: dU/dmu = mu / 25 - sum_j e_j, dU/dq1 = 2 t^2 / (1 + t^2)
// - 1 - tau sum_j e_j theta_j (t = tau / 5), dU/dtheta_j = theta_j - tau
// e_j.
struct EightSchoolsForm {
  const float* y;       // [J]
  const float* sigma;   // [J]
  const float* consts;  // [1]
  int j;

  static constexpr bool kTiled = false;
  static constexpr int kBufPad = 1;

  __host__ __device__ int shared_floats(int, int) const { return 2 * j + 1; }

  __device__ void stage(float* sh, int, int) const {
    stage_schools(sh, y, sigma, consts, j);
  }

  // (z_i, e_i) of the school whose pair is yr
  __device__ __forceinline__ static float2 terms(float2 yr, float mu,
                                                 float tau, float th) {
    const float z = (yr.x - (mu + tau * th)) * yr.y;
    return make_float2(z, z * yr.y);
  }

  __device__ __forceinline__ static float grad_log_tau(float tau, float s2) {
    const float t = tau * 0.2f;
    return ((2.0f * (t * t)) / (1.0f + t * t) - 1.0f) - tau * s2;
  }

  __device__ __forceinline__ float total(float mu, float lt, float tau,
                                         float st, float sz,
                                         const float* sh) const {
    const float t = tau * 0.2f;
    return ((((mu * mu) * 0.02f + log1pf(t * t)) - lt) + 0.5f * st) +
           0.5f * sz + sh[2 * j];
  }

  // One walker a thread: its N >= D dims in registers.
  template <int N>
  __device__ __forceinline__ void grad_thread(const float q[N], float g[N],
                                              int, const float* sh) const {
    const float2* yr = reinterpret_cast<const float2*>(sh);
    const float mu = q[0], tau = expf(q[1]);
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < N - 2; ++i) {
      g[2 + i] = 0.0f;
      if (i < j) {
        const float th = q[2 + i];
        const float e = terms(yr[i], mu, tau, th).y;
        s1 += e;
        s2 += e * th;
        g[2 + i] = th - tau * e;
      }
    }
    g[0] = mu * 0.04f - s1;
    g[1] = grad_log_tau(tau, s2);
  }

  template <int N>
  __device__ __forceinline__ float value_thread(const float q[N], int,
                                                const float* sh) const {
    const float2* yr = reinterpret_cast<const float2*>(sh);
    const float mu = q[0], lt = q[1], tau = expf(lt);
    float st = 0.0f, sz = 0.0f;
#pragma unroll
    for (int i = 0; i < N - 2; ++i) {
      if (i < j) {
        const float th = q[2 + i];
        const float z = terms(yr[i], mu, tau, th).x;
        st += th * th;
        sz += z * z;
      }
    }
    return total(mu, lt, tau, st, sz, sh);
  }

  // T lanes a walker: the lane's four dims.
  __device__ void grad(const float qv[4], float gv[4], int lane, int, int d,
                       const float* sh, float* buf) const {
    share_walker(qv, lane, d, buf);
    const float2* yr = reinterpret_cast<const float2*>(sh);
    const float mu = buf[0], tau = expf(buf[1]);
    float s1 = 0.0f, s2 = 0.0f;
    for (int i = 0; i < j; ++i) {
      const float th = buf[2 + i];
      const float e = terms(yr[i], mu, tau, th).y;
      s1 += e;
      s2 += e * th;
    }
    const int base = 4 * lane;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int dim = base + e;
      float v = 0.0f;
      if (dim == 0) {
        v = mu * 0.04f - s1;
      } else if (dim == 1) {
        v = grad_log_tau(tau, s2);
      } else if (dim < d) {
        v = qv[e] - tau * terms(yr[dim - 2], mu, tau, qv[e]).y;
      }
      gv[e] = v;
    }
    __syncwarp();
  }

  __device__ float value(const float qv[4], const float[4], int lane, int,
                         int d, const float* sh, float* buf) const {
    share_walker(qv, lane, d, buf);
    const float2* yr = reinterpret_cast<const float2*>(sh);
    const float mu = buf[0], lt = buf[1], tau = expf(buf[1]);
    float st = 0.0f, sz = 0.0f;
    for (int i = 0; i < j; ++i) {
      const float th = buf[2 + i];
      const float z = terms(yr[i], mu, tau, th).x;
      st += th * th;
      sz += z * z;
    }
    __syncwarp();
    return total(mu, lt, tau, st, sz, sh);
  }
};

// Centred eight schools over J groups, q = (mu, log tau, theta [J]), D = J
// + 2, data y [J], sigma [J]: the potential of models/examples.py
// eight_schools in unconstrained coordinates,
//   U = mu^2 / 50 + log1p((tau / 5)^2) - log tau + J log tau
//       + sum_j ((theta_j - mu) / tau)^2 / 2 + sum_j ((y_j - theta_j) /
//       sigma_j)^2 / 2 + c,  tau = e^q1,
// from mu ~ N(0, 5), tau ~ HalfCauchy(5) with the Jacobian of tau = e^q1,
// theta_j ~ N(mu, tau) and y_j ~ N(theta_j, sigma_j); c (consts[0]) the
// normalising constants, which are the non-centred model's. With 1 / tau
// taken as e^-q1: z_j = (theta_j - mu) e^-q1 and o_j = (y_j - theta_j) r_j;
// dU/dmu = mu / 25 - e^-q1 sum_j z_j, dU/dq1 = 2 t^2 / (1 + t^2) - 1 + J -
// sum_j z_j^2, dU/dtheta_j = z_j e^-q1 - o_j r_j.
struct EightSchoolsCentredForm {
  const float* y;       // [J]
  const float* sigma;   // [J]
  const float* consts;  // [1]
  int j;

  static constexpr bool kTiled = false;
  static constexpr int kBufPad = 1;

  __host__ __device__ int shared_floats(int, int) const { return 2 * j + 1; }

  __device__ void stage(float* sh, int, int) const {
    stage_schools(sh, y, sigma, consts, j);
  }

  // (z_i, o_i) of the school whose pair is yr
  __device__ __forceinline__ static float2 terms(float2 yr, float mu,
                                                 float itau, float th) {
    return make_float2((th - mu) * itau, (yr.x - th) * yr.y);
  }

  __device__ __forceinline__ static float grad_theta(float2 zo, float itau,
                                                     float r) {
    return zo.x * itau - zo.y * r;
  }

  __device__ __forceinline__ float grad_log_tau(float tau, float s2) const {
    const float t = tau * 0.2f;
    return (((2.0f * (t * t)) / (1.0f + t * t) - 1.0f) + (float)j) - s2;
  }

  __device__ __forceinline__ float total(float mu, float lt, float tau,
                                         float s2, float sz,
                                         const float* sh) const {
    const float t = tau * 0.2f;
    return (((((mu * mu) * 0.02f + log1pf(t * t)) - lt) + (float)j * lt) +
            0.5f * s2) +
           0.5f * sz + sh[2 * j];
  }

  // One walker a thread: its N >= D dims in registers.
  template <int N>
  __device__ __forceinline__ void grad_thread(const float q[N], float g[N],
                                              int, const float* sh) const {
    const float2* yr = reinterpret_cast<const float2*>(sh);
    const float mu = q[0], tau = expf(q[1]), itau = expf(-q[1]);
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < N - 2; ++i) {
      g[2 + i] = 0.0f;
      if (i < j) {
        const float2 pair = yr[i];
        const float2 zo = terms(pair, mu, itau, q[2 + i]);
        s1 += zo.x;
        s2 += zo.x * zo.x;
        g[2 + i] = grad_theta(zo, itau, pair.y);
      }
    }
    g[0] = mu * 0.04f - s1 * itau;
    g[1] = grad_log_tau(tau, s2);
  }

  template <int N>
  __device__ __forceinline__ float value_thread(const float q[N], int,
                                                const float* sh) const {
    const float2* yr = reinterpret_cast<const float2*>(sh);
    const float mu = q[0], lt = q[1], tau = expf(lt), itau = expf(-lt);
    float s2 = 0.0f, sz = 0.0f;
#pragma unroll
    for (int i = 0; i < N - 2; ++i) {
      if (i < j) {
        const float2 zo = terms(yr[i], mu, itau, q[2 + i]);
        s2 += zo.x * zo.x;
        sz += zo.y * zo.y;
      }
    }
    return total(mu, lt, tau, s2, sz, sh);
  }

  // T lanes a walker: the lane's four dims.
  __device__ void grad(const float qv[4], float gv[4], int lane, int, int d,
                       const float* sh, float* buf) const {
    share_walker(qv, lane, d, buf);
    const float2* yr = reinterpret_cast<const float2*>(sh);
    const float mu = buf[0], tau = expf(buf[1]), itau = expf(-buf[1]);
    float s1 = 0.0f, s2 = 0.0f;
    for (int i = 0; i < j; ++i) {
      const float z = terms(yr[i], mu, itau, buf[2 + i]).x;
      s1 += z;
      s2 += z * z;
    }
    const int base = 4 * lane;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int dim = base + e;
      float v = 0.0f;
      if (dim == 0) {
        v = mu * 0.04f - s1 * itau;
      } else if (dim == 1) {
        v = grad_log_tau(tau, s2);
      } else if (dim < d) {
        const float2 pair = yr[dim - 2];
        v = grad_theta(terms(pair, mu, itau, qv[e]), itau, pair.y);
      }
      gv[e] = v;
    }
    __syncwarp();
  }

  __device__ float value(const float qv[4], const float[4], int lane, int,
                         int d, const float* sh, float* buf) const {
    share_walker(qv, lane, d, buf);
    const float2* yr = reinterpret_cast<const float2*>(sh);
    const float mu = buf[0], lt = buf[1], tau = expf(buf[1]),
                itau = expf(-buf[1]);
    float s2 = 0.0f, sz = 0.0f;
    for (int i = 0; i < j; ++i) {
      const float2 zo = terms(yr[i], mu, itau, buf[2 + i]);
      s2 += zo.x * zo.x;
      sz += zo.y * zo.y;
    }
    __syncwarp();
    return total(mu, lt, tau, s2, sz, sh);
  }
};

// Independent coins on the logit scale, D = K: the potential of
// models/examples.py coin_toss (p_k ~ Uniform(0, 1) through p = sigmoid(x)
// with its Jacobian, Bernoulli observations reduced on the host to heads
// and tails per coin),
//   U = sum_k a_k softplus(-x_k) + b_k softplus(x_k),  a = heads + 1,
//   b = tails + 1,
// whose normalising constant is 0; gradient b_k sigmoid(x_k) - a_k
// sigmoid(-x_k). A dim takes one exponential, e = e^-|x|, for both: the
// gradient is (b - a e) / (1 + e) for x >= 0 and (b e - a) / (1 + e) for
// x < 0 (one IEEE division), the term (a + b) log1p(e) + a max(-x, 0) + b
// max(x, 0), both finite for any finite x (e underflows to 0 past |x| of
// 103, leaving b, -a and the linear terms). The plain version
// (ops/kernels.py _coin_vg) takes the same operations.
//
// Separable, so no walker buffer: a lane takes its four dims, a dim past D
// none of this arithmetic (a branch on dim < d), the value's terms summed
// lane by lane, then a butterfly. The pairs (a_k, b_k) are staged
// interleaved, one 8-byte broadcast a dim. The lane groups stay its layout:
// one walker a thread was 2-41% slower at D = 2, 8 and 16 (PERF.md).
struct CoinForm {
  const float* a;  // [D]
  const float* b;  // [D]

  static constexpr bool kTiled = false;
  static constexpr int kBufPad = 1;

  __host__ __device__ int shared_floats(int d, int) const { return 2 * d; }

  __device__ void stage(float* sh, int d, int) const {
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      sh[2 * i] = a[i];
      sh[2 * i + 1] = b[i];
    }
  }

  // dU/dx of one coin, ab = (a, b)
  __device__ __forceinline__ static float grad1(float x, float2 ab) {
    const float e = expf(-fabsf(x));
    const float num = x >= 0.0f ? ab.y - ab.x * e : ab.y * e - ab.x;
    return num / (1.0f + e);
  }

  // a softplus(-x) + b softplus(x) of one coin
  __device__ __forceinline__ static float term(float x, float2 ab) {
    const float e = expf(-fabsf(x));
    return ((ab.x + ab.y) * log1pf(e) + ab.x * fmaxf(-x, 0.0f)) +
           ab.y * fmaxf(x, 0.0f);
  }

  __device__ void grad(const float qv[4], float gv[4], int lane, int, int d,
                       const float* sh, float*) const {
    const float2* ab = reinterpret_cast<const float2*>(sh);
    const int base = 4 * lane;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      gv[e] = 0.0f;
      if (base + e < d) gv[e] = grad1(qv[e], ab[base + e]);
    }
  }

  __device__ float value(const float qv[4], const float[4], int lane,
                         int tpw, int d, const float* sh, float*) const {
    const float2* ab = reinterpret_cast<const float2*>(sh);
    const int base = 4 * lane;
    float part = 0.0f;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (base + e < d) part += term(qv[e], ab[base + e]);
    return segment_sum(part, tpw);
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

// Whether a form evaluates its R values together (values<R>).
template <class Form>
__host__ __device__ constexpr bool tiled_value() {
  if constexpr (Form::kTiled) {
    return Form::kTiledValue;
  } else {
    return false;
  }
}

template <int R, class Form>
__device__ __forceinline__ void value_walkers(const Form& form,
                                              const float (*qv)[4],
                                              const float (*gv)[4], int lane,
                                              int tpw, int d, const float* sh,
                                              float* buf, int row_step,
                                              float u[R]) {
  if constexpr (tiled_value<Form>()) {
    form.template values<R>(qv, lane, tpw, d, sh, buf, row_step, u);
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r)
      u[r] = form.value(qv[r], gv[r], lane, tpw, d, sh, buf + r * row_step);
  }
}

// Bytes of dynamic shared memory of a block: the form's parameters, then
// a buffer row for each of its kBlock / T * R walkers, then a tiled form's
// scratch.
template <class Form>
size_t shared_bytes(const Form& form, int num_dims, int tpw, int tile) {
  size_t floats = form.shared_floats(num_dims, tpw) +
                  kBlock / tpw * tile * (4 * tpw + Form::kBufPad);
  if constexpr (Form::kTiled) floats += Form::scratch_floats(tpw, tile);
  return sizeof(float) * floats;
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
// sigma, param2 the constant; count = J = D - 2), and the example models'
// forms: 8 linear regression (param0 x, param1 y, param2 (1 / prior^2, the
// constant); count = N rows, D - 2 columns), 9 centred eight schools (as
// 7), 10 coins (param0 heads + 1, param1 tails + 1), 11 the funnel model
// (param0 as 1, param1 the constant), 12 the diagonal form with a
// constant (param0, param1 as 5, param2 the constant). Returns
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
    case 8:
      if (count <= 0 || num_dims < 2) return (int)cudaErrorInvalidValue;
      return body(LinearForm{{param0, param1, count}, param2});
    case 9:
      if (count <= 0 || num_dims != count + 2)
        return (int)cudaErrorInvalidValue;
      return body(EightSchoolsCentredForm{param0, param1, param2, count});
    case 10:
      return body(CoinForm{param0, param1});
    case 11:
      return body(FunnelForm{param0, param1});
    case 12:
      return body(DiagQuadraticForm{param0, param1, param2});
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
