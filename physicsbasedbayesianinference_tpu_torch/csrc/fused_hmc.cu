// Fused ensemble-HMC transitions for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (ops/_build.py, ops/kernels.py).
//
// One launch is one whole HMC transition for every walker: thermal momentum
// refresh from the shared Philox stream (philox.cuh), a merged-kick leapfrog
// trajectory (half kick in, L x (drift + full kick), half kick undone),
// beta * (H1 - H0) with every non-finite value set to +inf, the divergence
// test, the Metropolis test and the accept-select. Nothing between the
// momentum draw and the selected state touches device memory.
//
//   pbbi_fused_hmc_diag_quadratic  replaces make_fused_hmc_diag_quadratic
//   pbbi_fused_hmc_transition      replaces make_fused_hmc_transition and
//                                  make_fused_hmc_packed (one kernel per
//                                  device form of the potential)
// (physicsbasedbayesianinference_tpu/ops/pallas_kernels.py). The TPU's two
// generic variants differ in layout only (walker-packed lanes for D | 128);
// here one layout serves every D, with C's gradient-only trajectory loop
// and the potential's value taken once, at the endpoint.
//
// Layout (forms.cuh): a walker's dims are split into Philox dim-groups of
// four. The T = min(32, next_pow2(ceil(D / 4))) consecutive lanes of a warp
// own one walker, lane l owning groups l, l + T, ... (kernel A; kernel B
// takes D <= 128, one group per lane); per-walker sums (H0, H1, U) are
// xor-butterfly shuffles over those T lanes. The TPU version's 128-lane
// walker packing and its segment-sum matmuls have no counterpart: the
// reductions are shuffles here.
//
// Bound: kernel A at the bench shape (W = 102400, D = 32, L = 16) reads q
// (13 MB) and writes q' and g' (26 MB): ~40 MB per transition, with about
// six flops per dim and step in registers, so it is bound by memory traffic
// and by Philox/Box-Muller latency, not by arithmetic. Kernel B adds a
// D x D matvec per step for the Gaussian, read from shared memory.
//
// Scalars (step size, beta, potential scale) come from a device array, so
// adapting the step size never needs a host read-back. Outputs are
// allocated by the caller; no kernel allocates or synchronises.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "forms.cuh"
#include "philox.cuh"

namespace {

struct Decision {
  float energy_error;
  float accept_prob;
  bool accepted;
};

__device__ __forceinline__ Decision metropolis(float h0, float h1, float beta,
                                               float threshold, uint32_t t,
                                               uint32_t w, uint32_t k0,
                                               uint32_t k1) {
  float derr = beta * (h1 - h0);
  if (!isfinite(derr)) derr = INFINITY;  // -inf and NaN included
  const bool divergent = derr > threshold;
  const float log_u = logf(pbbi::accept_uniform(t, w, k0, k1));
  Decision d;
  d.energy_error = derr;
  d.accepted = (log_u < -derr) && !divergent;
  d.accept_prob = divergent ? 0.0f : expf(fminf(0.0f, -derr));
  return d;
}

// ---------------------------------------------------------------------------
// Kernel A: U = 0.5 sum_d k_d (q_d - mu_d)^2, separable by dimension.
// Each group's trajectory runs in registers; q' and g' are written as soon
// as the group is done and rewritten from q for rejected walkers, so any D
// works with a fixed register budget.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kBlock) diag_quadratic_kernel(
    const float* __restrict__ q, const float* __restrict__ kdiag,
    const float* __restrict__ mean, const float* __restrict__ inv_mass,
    const float* __restrict__ p_std, const float* __restrict__ scalars,
    float* __restrict__ q_out, float* __restrict__ g_out,
    float* __restrict__ u_out, float* __restrict__ acc_out,
    uint8_t* __restrict__ taken_out, float* __restrict__ derr_out,
    int num_walkers, int num_dims, int tpw, int num_steps, float threshold,
    uint32_t k0, uint32_t k1, uint32_t t) {
  const int lane = threadIdx.x % tpw;
  const long long w =
      (long long)blockIdx.x * (kBlock / tpw) + threadIdx.x / tpw;
  const bool valid = w < num_walkers;
  const long long row = w * num_dims;
  const int groups = (num_dims + 3) / 4;
  const float dt = scalars[0], beta = scalars[1], scale = scalars[2];
  const float ck = dt * scale;

  float u0 = 0.0f, kin0 = 0.0f, u1 = 0.0f, kin1 = 0.0f;  // lane partials
  if (valid) {
    for (int g = lane; g < groups; g += tpw) {
      float n[4];
      pbbi::momentum_normals4(t, (uint32_t)w, (uint32_t)g, k0, k1, n);
      float qv[4], pv[4], kv[4], mv[4], imv[4], dtim[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * g + e;
        const bool in = d < num_dims;
        qv[e] = in ? q[row + d] : 0.0f;
        kv[e] = in ? kdiag[d] : 0.0f;
        mv[e] = in ? mean[d] : 0.0f;
        imv[e] = in ? inv_mass[d] : 0.0f;
        const float p0 = in ? p_std[d] * n[e] : 0.0f;
        const float qc = qv[e] - mv[e];
        u0 += kv[e] * qc * qc;
        kin0 += p0 * p0 * imv[e];
        dtim[e] = dt * imv[e];
        pv[e] = p0 - (0.5f * ck) * (kv[e] * qc);
      }
      for (int s = 0; s < num_steps; ++s) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          qv[e] += pv[e] * dtim[e];
          pv[e] -= ck * (kv[e] * (qv[e] - mv[e]));
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * g + e;
        const float qc = qv[e] - mv[e];
        pv[e] += (0.5f * ck) * (kv[e] * qc);
        u1 += kv[e] * qc * qc;
        kin1 += pv[e] * pv[e] * imv[e];
        if (d < num_dims) {
          q_out[row + d] = qv[e];
          g_out[row + d] = kv[e] * qc;
        }
      }
    }
  }
  const float uu0 = 0.5f * segment_sum(u0, tpw);
  const float uu1 = 0.5f * segment_sum(u1, tpw);
  const float h0 = 0.5f * segment_sum(kin0, tpw) + scale * uu0;
  const float h1 = 0.5f * segment_sum(kin1, tpw) + scale * uu1;
  const Decision dec =
      metropolis(h0, h1, beta, threshold, t, (uint32_t)w, k0, k1);
  if (!valid) return;
  if (lane == 0) {
    u_out[w] = dec.accepted ? uu1 : uu0;
    acc_out[w] = dec.accept_prob;
    taken_out[w] = dec.accepted ? 1 : 0;
    derr_out[w] = dec.energy_error;
  }
  if (!dec.accepted) {
    for (int g = lane; g < groups; g += tpw) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * g + e;
        if (d < num_dims) {
          const float qv = q[row + d];
          q_out[row + d] = qv;
          g_out[row + d] = kdiag[d] * (qv - mean[d]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Kernel B: any potential with a device form, D <= kMaxGenericDims, so that
// every lane owns exactly one dim-group. Takes the cached (u, g) and returns
// them unscaled; forces and H use scale * U. The device forms are in
// forms.cuh.
// ---------------------------------------------------------------------------

template <class Form>
__global__ void __launch_bounds__(kBlock) generic_kernel(
    Form form, const float* __restrict__ q, const float* __restrict__ u,
    const float* __restrict__ g, const float* __restrict__ inv_mass,
    const float* __restrict__ p_std, const float* __restrict__ scalars,
    float* __restrict__ q_out, float* __restrict__ u_out,
    float* __restrict__ g_out, float* __restrict__ acc_out,
    uint8_t* __restrict__ taken_out, float* __restrict__ derr_out,
    int num_walkers, int num_dims, int tpw, int num_steps, float threshold,
    uint32_t k0, uint32_t k1, uint32_t t) {
  extern __shared__ float smem[];
  form.stage(smem, num_dims);
  __syncthreads();

  const int lane = threadIdx.x % tpw;
  const int slot = threadIdx.x / tpw;
  // one extra float per walker buffer keeps neighbouring walkers' reads of
  // buf[j] in different banks
  float* buf = smem + form.shared_floats(num_dims) + slot * (4 * tpw + 1);
  const long long w = (long long)blockIdx.x * (kBlock / tpw) + slot;
  const bool valid = w < num_walkers;
  const long long row = valid ? w * num_dims : 0;
  const int base = 4 * lane;
  const float dt = scalars[0], beta = scalars[1], scale = scalars[2];
  const float ck = dt * scale;

  float n[4];
  pbbi::momentum_normals4(t, (uint32_t)w, (uint32_t)lane, k0, k1, n);
  float q0[4], g0[4], qv[4], gv[4], pv[4], imv[4], dtim[4];
  float kin0 = 0.0f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int d = base + e;
    const bool in = valid && d < num_dims;
    q0[e] = in ? q[row + d] : 0.0f;
    g0[e] = in ? g[row + d] : 0.0f;
    imv[e] = in ? inv_mass[d] : 0.0f;
    const float p0 = in ? p_std[d] * n[e] : 0.0f;
    kin0 += p0 * p0 * imv[e];
    dtim[e] = dt * imv[e];
    pv[e] = p0 - (0.5f * ck) * g0[e];
    qv[e] = q0[e];
    gv[e] = g0[e];
  }
  const float u0 = valid ? u[w] : 0.0f;
  const float h0 = 0.5f * segment_sum(kin0, tpw) + scale * u0;

  for (int s = 0; s < num_steps; ++s) {
#pragma unroll
    for (int e = 0; e < 4; ++e) qv[e] += pv[e] * dtim[e];
    form.grad(qv, gv, lane, tpw, num_dims, smem, buf);
#pragma unroll
    for (int e = 0; e < 4; ++e) pv[e] -= ck * gv[e];
  }
  const float u1 =
      num_steps > 0 ? form.value(qv, gv, lane, tpw, num_dims, smem, buf)
                    : u0;
  float kin1 = 0.0f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    pv[e] += (0.5f * ck) * gv[e];
    kin1 += pv[e] * pv[e] * imv[e];
  }
  const float h1 = 0.5f * segment_sum(kin1, tpw) + scale * u1;
  const Decision dec =
      metropolis(h0, h1, beta, threshold, t, (uint32_t)w, k0, k1);
  if (!valid) return;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int d = base + e;
    if (d < num_dims) {
      q_out[row + d] = dec.accepted ? qv[e] : q0[e];
      g_out[row + d] = dec.accepted ? gv[e] : g0[e];
    }
  }
  if (lane == 0) {
    u_out[w] = dec.accepted ? u1 : u0;
    acc_out[w] = dec.accept_prob;
    taken_out[w] = dec.accepted ? 1 : 0;
    derr_out[w] = dec.energy_error;
  }
}

template <class Form>
int launch_generic(Form form, const float* q, const float* u, const float* g,
                   const float* inv_mass, const float* p_std,
                   const float* scalars, float* q_out, float* u_out,
                   float* g_out, float* acc_out, uint8_t* taken_out,
                   float* derr_out, int num_walkers, int num_dims,
                   int num_steps, float threshold, uint64_t seed,
                   uint32_t counter, void* stream) {
  if (num_walkers <= 0 || num_dims <= 0 || num_dims > kMaxGenericDims ||
      num_steps < 0)
    return (int)cudaErrorInvalidValue;
  const int tpw = threads_per_walker(num_dims);
  const int wpb = kBlock / tpw;
  const size_t smem =
      sizeof(float) * (form.shared_floats(num_dims) + wpb * (4 * tpw + 1));
  const cudaError_t err = cudaFuncSetAttribute(
      generic_kernel<Form>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((num_walkers + wpb - 1) / wpb);
  generic_kernel<Form><<<blocks, kBlock, smem, (cudaStream_t)stream>>>(
      form, q, u, g, inv_mass, p_std, scalars, q_out, u_out, g_out, acc_out,
      taken_out, derr_out, num_walkers, num_dims, tpw, num_steps, threshold,
      (uint32_t)seed, (uint32_t)(seed >> 32), counter);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* pbbi_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int pbbi_fused_hmc_diag_quadratic(
    const float* q, const float* kdiag, const float* mean,
    const float* inv_mass, const float* p_std, const float* scalars,
    float* q_out, float* g_out, float* u_out, float* acc_out,
    uint8_t* taken_out, float* derr_out, int num_walkers, int num_dims,
    int num_steps, float threshold, uint64_t seed, uint32_t counter,
    void* stream) {
  if (num_walkers <= 0 || num_dims <= 0 || num_steps < 0)
    return (int)cudaErrorInvalidValue;
  const int tpw = threads_per_walker(num_dims);
  const int wpb = kBlock / tpw;
  const unsigned blocks = (unsigned)((num_walkers + wpb - 1) / wpb);
  diag_quadratic_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
      q, kdiag, mean, inv_mass, p_std, scalars, q_out, g_out, u_out, acc_out,
      taken_out, derr_out, num_walkers, num_dims, tpw, num_steps, threshold,
      (uint32_t)seed, (uint32_t)(seed >> 32), counter);
  return (int)cudaGetLastError();
}

// Kernel B for the device form `form` (forms.cuh with_form; ops/kernels.py
// FORM_IDS), every form but the diagonal quadratic (kernel A's).
int pbbi_fused_hmc_transition(
    int form, const float* param0, const float* param1, const float* param2,
    int count, const float* q, const float* u, const float* g,
    const float* inv_mass, const float* p_std, const float* scalars,
    float* q_out, float* u_out, float* g_out, float* acc_out,
    uint8_t* taken_out, float* derr_out, int num_walkers, int num_dims,
    int num_steps, float threshold, uint64_t seed, uint32_t counter,
    void* stream) {
  return with_form<false>(
      form, param0, param1, param2, count, num_dims, [&](auto f) {
        return launch_generic(f, q, u, g, inv_mass, p_std, scalars, q_out,
                              u_out, g_out, acc_out, taken_out, derr_out,
                              num_walkers, num_dims, num_steps, threshold,
                              seed, counter, stream);
      });
}

}  // extern "C"
