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
// one of the device forms of forms.cuh (the Gaussian, funnel, banana,
// mixture, N-body, diagonal quadratic, and the example models' logistic and
// linear regression, both eight schools and the coins), in kernel B's warp
// layout: T lanes per walker, one dim-group of four per lane, so D <= 128;
// with the Gaussian, logistic and linear forms a lane group owns R walkers
// (1, 2 or 4), whose 4 x R tile of the gradient a lane keeps in registers
// (forms.cuh). The two eight-schools forms run one walker a thread up to
// D = 16, in thread_layout.cu's kernel D (ops/kernels.py walker_layout).
//
// The gradient on entry: the TPU kernel recomputes (u, g) at q
// (pallas_kernels.py:186). This one takes the caller's cached (u, g) when
// both pointers are given and evaluates g at q in the kernel otherwise.
// u' is the form's value at the final q (the cached u when num_steps = 0).
//
// dt comes from a device scalar, so adapting the step size needs no host
// read and no host-to-device copy per call. Bound: at the bench shape (W =
// 102400, D = 32, L = 16) it moves 2 x 13 MB in (3 with the cached
// gradient) and 3 x 13 MB out. The
// diagonal form does a few flops per dim and step, so memory traffic
// bounds it: with kVec (D % 4 == 0 and every array 16-byte aligned, checked
// by the launcher) a lane's four floats are one 16-byte access, 0.033 ms
// against 0.039 ms with scalar accesses and a bytes bound of 0.020 ms. The
// Gaussian form adds a D x D matvec per step, which bounds it instead
// (0.060 ms at the FP32 rate); its operands come from shared memory, and
// that rate, not the multiply-add rate, is what the register tile runs at:
// 0.134 ms, from 0.325 ms without it (H100 80GB HBM3, 700 W;
// tools/compare_builds.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "forms.cuh"

namespace {

template <class Form, int R, bool kVec>
__global__ void __launch_bounds__(kBlock, kMinBlocks) leapfrog_kernel(
    Form form, const float* __restrict__ q, const float* __restrict__ p,
    const float* __restrict__ u, const float* __restrict__ g,
    const float* __restrict__ inv_mass, const float* __restrict__ step,
    float* __restrict__ q_out, float* __restrict__ p_out,
    float* __restrict__ u_out, float* __restrict__ g_out, int num_walkers,
    int num_dims, int tpw, int num_steps) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  form.stage(smem, num_dims, tpw);
  __syncthreads();

  const int lane = threadIdx.x % tpw;
  const int slot = threadIdx.x / tpw;
  const int groups = kBlock / tpw;
  // buffer rows as in kernel B: walker r of the lane group has row
  // r * groups + slot
  const int stride = 4 * tpw + Form::kBufPad;
  const int row_step = groups * stride;
  float* buf = smem + form.shared_floats(num_dims, tpw) + slot * stride;
  const long long first = ((long long)blockIdx.x * groups + slot) * R;
  const int base = 4 * lane;
  const bool cached = g != nullptr;
  const float dt = step[0];
  const float half = 0.5f * dt;

  float imv[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    imv[e] = base + e < num_dims ? inv_mass[base + e] : 0.0f;

  // Lanes of walkers past the end run along on zeros (every lane of the
  // warp takes part in the forms' shuffles and warp barriers) and write
  // nothing.
  float qv[R][4], pv[R][4], gv[R][4];
  int left[R];  // the lane's dims of walker r that exist: 0 past the end
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long w = first + r;
    const bool valid = w < num_walkers;
    left[r] = valid ? num_dims - base : 0;
    const long long at = valid ? w * num_dims + base : 0;
    load_group<kVec>(q, at, left[r], qv[r]);
    load_group<kVec>(p, at, left[r], pv[r]);
    load_group<kVec>(g, at, cached ? left[r] : 0, gv[r]);
  }
  if (!cached)
    grad_walkers<R>(form, qv, gv, lane, tpw, num_dims, smem, buf, row_step);

  for (int s = 0; s < num_steps; ++s) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pv[r][e] -= half * gv[r][e];
        qv[r][e] += (dt * pv[r][e]) * imv[e];
      }
    grad_walkers<R>(form, qv, gv, lane, tpw, num_dims, smem, buf, row_step);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[r][e] -= half * gv[r][e];
  }
  float u1[R];
  if (cached && num_steps == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      u1[r] = first + r < num_walkers ? u[first + r] : 0.0f;
  } else {
    value_walkers<R>(form, qv, gv, lane, tpw, num_dims, smem, buf, row_step,
                     u1);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long w = first + r;
    if (w >= num_walkers) continue;
    const long long at = w * num_dims + base;
    store_group<kVec>(q_out, at, left[r], qv[r]);
    store_group<kVec>(p_out, at, left[r], pv[r]);
    store_group<kVec>(g_out, at, left[r], gv[r]);
    if (lane == 0) u_out[w] = u1[r];
  }
}

template <class Form>
int launch_leapfrog(Form form, const float* q, const float* p, const float* u,
                    const float* g, const float* inv_mass, const float* step,
                    float* q_out, float* p_out, float* u_out, float* g_out,
                    int num_walkers, int num_dims, int num_steps,
                    int walker_tile, void* stream) {
  const int tpw = threads_per_walker(num_dims);
  // g may be null (no cached gradient): null is aligned
  const bool vec = num_dims % 4 == 0 && !misaligned16(q) &&
                   !misaligned16(p) && !misaligned16(g) &&
                   !misaligned16(q_out) && !misaligned16(p_out) &&
                   !misaligned16(g_out);
  return with_tile<Form>(walker_tile, [&](auto tile) {
    constexpr int R = decltype(tile)::value;
    const auto kernel = vec ? &leapfrog_kernel<Form, R, true>
                            : &leapfrog_kernel<Form, R, false>;
    const size_t smem = shared_bytes(form, num_dims, tpw, R);
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int wpb = kBlock / tpw * R;
    const unsigned blocks = (unsigned)((num_walkers + wpb - 1) / wpb);
    kernel<<<blocks, kBlock, smem, (cudaStream_t)stream>>>(
        form, q, p, u, g, inv_mass, step, q_out, p_out, u_out, g_out,
        num_walkers, num_dims, tpw, num_steps);
    return (int)cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// Kernel D for the device form `form` (forms.cuh with_form, every form).
// u and g are both given (the cached pair at q) or both null. step is a
// device float holding dt. walker_tile: walkers a lane group owns, 1, 2 or
// 4 for the Gaussian, logistic and linear forms (ops/kernels.py walker_tile,
// logistic_tile), 1 for any other.
int pbbi_leapfrog_trajectory(
    int form, const float* param0, const float* param1, const float* param2,
    int count, const float* q, const float* p, const float* u, const float* g,
    const float* inv_mass, const float* step, float* q_out, float* p_out,
    float* u_out, float* g_out, int num_walkers, int num_dims, int num_steps,
    int walker_tile, void* stream) {
  if (num_walkers <= 0 || num_dims <= 0 || num_dims > kMaxGenericDims ||
      num_steps < 0 || (u == nullptr) != (g == nullptr))
    return (int)cudaErrorInvalidValue;
  return with_form(
      form, param0, param1, param2, count, num_dims, [&](auto f) {
        return launch_leapfrog(f, q, p, u, g, inv_mass, step, q_out, p_out,
                               u_out, g_out, num_walkers, num_dims, num_steps,
                               walker_tile, stream);
      });
}

}  // extern "C"
