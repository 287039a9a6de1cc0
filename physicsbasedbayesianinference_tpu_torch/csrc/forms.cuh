// Device forms of the potentials, shared by kernel B (fused_hmc.cu) and
// kernel D (leapfrog.cu), and the warp layout they run in.
//
// Layout: a walker's dims are split into dim-groups of four. The
// T = min(32, next_pow2(ceil(D / 4))) consecutive lanes of a warp own one
// walker, lane l owning group l (so D <= 4 * 32 = 128); per-walker sums
// are xor-butterfly shuffles over those T lanes.
//
// A form stages its parameters in shared memory (stage) and evaluates, for
// the lane's four dims, the gradient (grad) and the walker's value (value,
// on every lane). Sums over dimensions run in index order, the order of the
// plain versions (ops/kernels.py), so that both round alike. Forms that
// couple a walker's dims read them from the walker's shared buffer.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlock = 256;
constexpr int kMaxGenericDims = 128;

int threads_per_walker(int num_dims) {
  const int groups = (num_dims + 3) / 4;
  int t = 1;
  while (t < groups && t < 32) t <<= 1;
  return t;
}

// Sum over aligned segments of `width` lanes (a power of two <= 32); every
// lane of the warp must call it.
__device__ __forceinline__ float segment_sum(float v, int width) {
  for (int off = width >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
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

  __host__ __device__ int shared_floats(int d) const { return 2 * d; }

  __device__ void stage(float* sh, int d) const {
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
// rows of P in index order. Mean and P are staged in shared memory per
// block; the walker's q - mu is broadcast to its lanes through its buffer.
struct GaussianForm {
  const float* mean;  // [D]
  const float* prec;  // [D, D] row-major

  __host__ __device__ int shared_floats(int d) const { return d * d + d; }

  __device__ void stage(float* sh, int d) const {
    for (int i = threadIdx.x; i < d * d; i += blockDim.x) sh[i] = prec[i];
    for (int i = threadIdx.x; i < d; i += blockDim.x) sh[d * d + i] = mean[i];
  }

  __device__ void grad(const float qv[4], float gv[4], int lane, int tpw,
                       int d, const float* sh, float* buf) const {
    const int base = 4 * lane;
    const float* mu = sh + d * d;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (base + e < d) buf[base + e] = qv[e] - mu[base + e];
    __syncwarp();
#pragma unroll
    for (int e = 0; e < 4; ++e) gv[e] = 0.0f;
    for (int j = 0; j < d; ++j) {
      const float dj = buf[j];
      const float* row = sh + j * d + base;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (base + e < d) gv[e] += dj * row[e];
    }
    __syncwarp();
  }

  __device__ float value(const float qv[4], const float gv[4], int lane,
                         int tpw, int d, const float* sh, float*) const {
    const int base = 4 * lane;
    const float* mu = sh + d * d;
    float part = 0.0f;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (base + e < d) part += (qv[e] - mu[base + e]) * gv[e];
    return 0.5f * segment_sum(part, tpw);
  }
};

// Neal's funnel, q = (v, x): U = v^2 / (2 s^2) + (D-1)/2 v + e^-v |x|^2 / 2.
// params = (2 s^2, (D-1)/2).
struct FunnelForm {
  const float* params;  // [2]

  __host__ __device__ int shared_floats(int) const { return 2; }

  __device__ void stage(float* sh, int) const {
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

  __host__ __device__ int shared_floats(int) const { return 2; }

  __device__ void stage(float* sh, int) const {
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

  __host__ __device__ int shared_floats(int d) const { return k * d + k + 1; }

  __device__ void stage(float* sh, int d) const {
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

  __host__ __device__ int shared_floats(int) const { return n + 2; }

  __device__ void stage(float* sh, int) const {
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

// Run `body(form)` with the device form numbered `form` (ops/kernels.py
// FORM_IDS): 0 Gaussian (param0 mean, param1 precision), 1 funnel
// (param0), 2 banana (param0; D = 2), 3 mixture (param0 means, param1 log
// weights, param2 inv_var; count = K), 4 N-body (param0 masses, param1
// (G, eps^2); count = N, D a multiple of N), 5 diagonal quadratic (param0
// k, param1 mean; only where kWithDiag). Returns cudaErrorInvalidValue for
// a form or parameter count the caller does not take.
template <bool kWithDiag, class Body>
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
      if constexpr (kWithDiag) return body(DiagQuadraticForm{param0, param1});
      return (int)cudaErrorInvalidValue;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
