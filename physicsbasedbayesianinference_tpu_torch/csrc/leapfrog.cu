// Kernel D: the L-step kick-drift-kick leapfrog trajectory of every walker
// in one launch, for Hopper (sm_90a), with a plain C interface loaded
// through ctypes (ops/_build.py, ops/kernels.py leapfrog_trajectory).
//
//   pbbi_leapfrog_trajectory  replaces make_pallas_leapfrog
//                             (physicsbasedbayesianinference_tpu/ops/
//                             pallas_kernels.py:140)
//
// Per walker and step, as the TPU kernel's loop body (pallas_kernels.py:
// 188-194): p -= dt/2 g; q += dt p inv_mass; (u, g) at q; p -= dt/2 g.
// No momentum refresh and no Metropolis test: the caller (the composed HMC
// step) does both. q, p and g stay in registers for the whole trajectory;
// q', p', g' and u' are written once at the end.
//
// The TPU traced any jnp potential into the kernel. Here the potential is
// one of the device forms of forms.cuh (kernel B's Gaussian, funnel,
// banana, mixture and N-body, plus the diagonal quadratic of kernel A's
// targets), in kernel B's warp layout: T lanes per walker, one dim-group of
// four per lane, so D <= 128.
//
// The gradient on entry: the TPU kernel recomputes (u, g) at q
// (pallas_kernels.py:186). This one takes the caller's cached (u, g) when
// both pointers are given and evaluates g at q in the kernel otherwise.
// u' is the form's value at the final q (the cached u when num_steps = 0).
//
// dt comes from a device scalar, so adapting the step size needs no host
// read and no host-to-device copy per call. Bound: at the bench shape (W =
// 102400, D = 32, L = 16) it moves 2 x 13 MB in and 3 x 13 MB out; the
// diagonal form does a few flops per dim and step, so memory traffic and
// launch latency bound it; the Gaussian form adds a D x D matvec per step
// from shared memory, which bounds it instead.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "forms.cuh"

namespace {

template <class Form>
__global__ void __launch_bounds__(kBlock) leapfrog_kernel(
    Form form, const float* __restrict__ q, const float* __restrict__ p,
    const float* __restrict__ u, const float* __restrict__ g,
    const float* __restrict__ inv_mass, const float* __restrict__ step,
    float* __restrict__ q_out, float* __restrict__ p_out,
    float* __restrict__ u_out, float* __restrict__ g_out, int num_walkers,
    int num_dims, int tpw, int num_steps) {
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
  const bool cached = g != nullptr;
  const float dt = step[0];
  const float half = 0.5f * dt;

  // Lanes of walkers past the end run along on zeros (every lane of the
  // warp takes part in the forms' shuffles and warp barriers) and write
  // nothing.
  float qv[4], pv[4], gv[4], imv[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int d = base + e;
    const bool in = valid && d < num_dims;
    qv[e] = in ? q[row + d] : 0.0f;
    pv[e] = in ? p[row + d] : 0.0f;
    gv[e] = (in && cached) ? g[row + d] : 0.0f;
    imv[e] = in ? inv_mass[d] : 0.0f;
  }
  if (!cached) form.grad(qv, gv, lane, tpw, num_dims, smem, buf);

  for (int s = 0; s < num_steps; ++s) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      pv[e] -= half * gv[e];
      qv[e] += (dt * pv[e]) * imv[e];
    }
    form.grad(qv, gv, lane, tpw, num_dims, smem, buf);
#pragma unroll
    for (int e = 0; e < 4; ++e) pv[e] -= half * gv[e];
  }
  float u1;
  if (cached && num_steps == 0)
    u1 = valid ? u[w] : 0.0f;
  else
    u1 = form.value(qv, gv, lane, tpw, num_dims, smem, buf);
  if (!valid) return;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int d = base + e;
    if (d < num_dims) {
      q_out[row + d] = qv[e];
      p_out[row + d] = pv[e];
      g_out[row + d] = gv[e];
    }
  }
  if (lane == 0) u_out[w] = u1;
}

template <class Form>
int launch_leapfrog(Form form, const float* q, const float* p, const float* u,
                    const float* g, const float* inv_mass, const float* step,
                    float* q_out, float* p_out, float* u_out, float* g_out,
                    int num_walkers, int num_dims, int num_steps,
                    void* stream) {
  const int tpw = threads_per_walker(num_dims);
  const int wpb = kBlock / tpw;
  const size_t smem =
      sizeof(float) * (form.shared_floats(num_dims) + wpb * (4 * tpw + 1));
  const cudaError_t err = cudaFuncSetAttribute(
      leapfrog_kernel<Form>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((num_walkers + wpb - 1) / wpb);
  leapfrog_kernel<Form><<<blocks, kBlock, smem, (cudaStream_t)stream>>>(
      form, q, p, u, g, inv_mass, step, q_out, p_out, u_out, g_out,
      num_walkers, num_dims, tpw, num_steps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernel D for the device form `form` (forms.cuh with_form, every form).
// u and g are both given (the cached pair at q) or both null. step is a
// device float holding dt.
int pbbi_leapfrog_trajectory(
    int form, const float* param0, const float* param1, const float* param2,
    int count, const float* q, const float* p, const float* u, const float* g,
    const float* inv_mass, const float* step, float* q_out, float* p_out,
    float* u_out, float* g_out, int num_walkers, int num_dims, int num_steps,
    void* stream) {
  if (num_walkers <= 0 || num_dims <= 0 || num_dims > kMaxGenericDims ||
      num_steps < 0 || (u == nullptr) != (g == nullptr))
    return (int)cudaErrorInvalidValue;
  return with_form<true>(
      form, param0, param1, param2, count, num_dims, [&](auto f) {
        return launch_leapfrog(f, q, p, u, g, inv_mass, step, q_out, p_out,
                               u_out, g_out, num_walkers, num_dims, num_steps,
                               stream);
      });
}

}  // extern "C"
