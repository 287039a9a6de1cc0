// Kernels B and D in the thread layout, for Hopper (sm_90a), with a plain
// C interface loaded through ctypes (ops/_build.py, ops/kernels.py):
//
//   pbbi_fused_hmc_transition_threads  kernel B (fused_hmc.cu's
//                                      generic_kernel), replacing
//                                      make_fused_hmc_transition and
//                                      make_fused_hmc_packed
//   pbbi_leapfrog_trajectory_threads   kernel D (leapfrog.cu's
//                                      leapfrog_kernel), replacing
//                                      make_pallas_leapfrog
// (physicsbasedbayesianinference_tpu/ops/pallas_kernels.py:373, :576 and
// :140), for the two eight-schools forms (forms.cuh EightSchoolsForm and
// EightSchoolsCentredForm) up to D = kMaxThreadDims = 16, where
// ops/kernels.py walker_layout chooses it (the centred form in D up to 12).
// Above that the forms run in the lane-group layout of fused_hmc.cu and
// leapfrog.cu.
//
// Why a layout of its own: the lane-group layout gives a walker T =
// next_pow2(ceil(D / 4)) lanes, four dims a lane, and its sums over dims
// are shuffles. An eight-schools gradient couples every dim to every
// school: each of the T lanes ran the whole J loop (and at D = 10 lane 3
// owned no dim at all), shared the walker through a buffer row under a
// warp barrier and evaluated tau once more. Here one thread holds one
// walker's N = 4 ceil(D / 4) dims (q, p, g in registers, zeros past D) and
// runs the J terms once a gradient: no shared walker buffer, no warp
// barrier, no shuffle in the trajectory. The forms' arithmetic is the
// lane-group layout's, term for term, so both layouts give the same bits.
//
// The same draws: the momenta of dim-group k are momentum_normals4(t,
// w0 + w, k, ...), as lane k of the lane-group layout draws them, and the
// accept uniform is the walker's; the kinetic sums add the groups' partial
// sums in the order of that layout's xor butterfly over T lanes
// (lane_sum), so the energy error rounds as there too.
//
// Memory: a walker's row is 4 D bytes (40 at D = 10), which neighbouring
// threads would read 4 D bytes apart. The block's rows of every [W, D]
// input are copied into shared memory by the whole block, neighbouring
// threads on neighbouring floats, and each thread then takes its own row
// from there; outputs go back the same way. A rejected walker's start is
// still in the buffer at the end, so nothing is read twice. Each thread
// reading and writing its own row in device memory instead measured 5%
// faster in B with the count fixed at D = 10, 12% slower with the proposal
// outputs and 3% slower in D, and at D = 16 15-60% slower (PERF.md).
//
// What bounds it: the arithmetic. Rows are read and written once a
// transition against 17 gradients of some 10 J + 4 D operations each, so
// the bytes (0.005 ms at W = 102400, D = 10) are far below the
// instructions (PERF.md). The J loop's schools are independent but for
// their running sums, which gives the scheduler work between the
// dependent operations of one school. At W = 102400 the launch is 800
// blocks of 128 threads, 6.1 a SM: all resident at once at 64 registers a
// thread (thread_min_blocks).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "forms.cuh"
#include "philox.cuh"
#include "transition.cuh"

namespace {

// threads a block: at W = 102400, 800 blocks, 6 or 7 an SM, all resident
// at once; 64 is no faster at D = 10 and 16, 256 (3 or 4 an SM) 7% slower
// uncapped
#ifndef PBBI_THREAD_BLOCK
#define PBBI_THREAD_BLOCK 128
#endif
constexpr int kThreadBlock = PBBI_THREAD_BLOCK;
// Blocks of kThreadBlock threads the compiler must fit on an SM (0: by N,
// thread_min_blocks).
#ifndef PBBI_THREAD_MIN_BLOCKS
#define PBBI_THREAD_MIN_BLOCKS 0
#endif
constexpr int kMaxThreadDims = 16;

// Up to N = 12, 8 blocks: 64 registers a thread, 32 warps an SM. Uncapped
// the kernels take 110-116 registers at N = 12 (94 in D), 16 warps an SM,
// and B takes 12% more time, D 20%; caps of 80 and 48 registers 11-21%
// more (tools/kernel_sweeps.py --only threads on an H100 80GB HBM3 at 700
// W, PERF.md). Above N = 12 no cap (N = 16 takes 118-128 registers, and a
// cap of 80 is 4-9% slower in B).
template <int N>
constexpr int thread_min_blocks() {
  return PBBI_THREAD_MIN_BLOCKS > 0 ? PBBI_THREAD_MIN_BLOCKS
                                    : (N <= 12 ? 8 : 1);
}

// The sum of G dim-groups' partial sums as segment_sum leaves it on lane 0
// of T = next_pow2(G) lanes (lanes past G adding zeros): offsets T/2 .. 1,
// lane l adding lane l ^ off.
template <int G>
__device__ __forceinline__ float lane_sum(const float part[G]) {
  constexpr int T = G <= 1 ? 1 : G <= 2 ? 2 : G <= 4 ? 4 : 8;
  float v[T];
#pragma unroll
  for (int l = 0; l < T; ++l) v[l] = l < G ? part[l] : 0.0f;
#pragma unroll
  for (int off = T / 2; off > 0; off /= 2) {
    float next[T];
#pragma unroll
    for (int l = 0; l < T; ++l) next[l] = v[l] + v[l ^ off];
#pragma unroll
    for (int l = 0; l < T; ++l) v[l] = next[l];
  }
  return v[0];
}

// Floats of shared memory before the row buffers: the form's parameters,
// rounded up to whole 16 bytes.
template <class Form>
__host__ __device__ int params_floats(const Form& form, int d) {
  return (form.shared_floats(d, 1) + 3) / 4 * 4;
}

// The block's rows [first, first + rows) of a row-major [W, d] array into
// buf.
__device__ __forceinline__ void load_rows(const float* __restrict__ src,
                                          long long first, int rows, int d,
                                          float* buf) {
  const float* from = src + first * d;
  for (int i = threadIdx.x; i < rows * d; i += kThreadBlock) buf[i] = from[i];
}

__device__ __forceinline__ void store_rows(float* __restrict__ dst,
                                           long long first, int rows, int d,
                                           const float* buf) {
  float* to = dst + first * d;
  for (int i = threadIdx.x; i < rows * d; i += kThreadBlock) to[i] = buf[i];
}

// The block's row i, from buf, into v[N] (zeros past d).
template <int N>
__device__ __forceinline__ void read_row(const float* buf, int i, int d,
                                         float v[N]) {
  const float* row = buf + i * d;
#pragma unroll
  for (int e = 0; e < N; ++e) v[e] = e < d ? row[e] : 0.0f;
}

// ... and back into the block's buffer, which store_rows stores once
// every thread is done.
template <int N>
__device__ __forceinline__ void write_row(float* buf, int i, int d,
                                          const float v[N]) {
  float* row = buf + i * d;
#pragma unroll
  for (int e = 0; e < N; ++e)
    if (e < d) row[e] = v[e];
}

// Kernel B: one HMC transition of each walker, as fused_hmc.cu's
// generic_kernel (the count fixed or read from device memory, kDyn; the
// endpoint (q1, -p1) stored, kProp).
template <class Form, int N, bool kDyn, bool kProp>
__global__ void __launch_bounds__(kThreadBlock, thread_min_blocks<N>())
thread_transition_kernel(
    Form form, const float* __restrict__ q, const float* __restrict__ u,
    const float* __restrict__ g, const float* __restrict__ inv_mass,
    const float* __restrict__ p_std, const float* __restrict__ scalars,
    float* __restrict__ q_out, float* __restrict__ u_out,
    float* __restrict__ g_out, float* __restrict__ acc_out,
    uint8_t* __restrict__ taken_out, float* __restrict__ derr_out,
    float* __restrict__ q_prop, float* __restrict__ p_prop,
    const int* __restrict__ steps_dev, int num_walkers, int num_dims,
    int num_steps, float threshold, uint32_t k0, uint32_t k1, uint32_t t,
    uint32_t w0) {
  constexpr int G = N / 4;
  if (kDyn) num_steps = device_steps(steps_dev, num_steps);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int d = num_dims;
  form.stage(smem, d, 1);
  // q and g in, q' and g' out; the proposal's q1 and -p1
  float* qb = smem + params_floats(form, d);
  float* gb = qb + kThreadBlock * d;
  float* xb = gb + kThreadBlock * d;
  float* yb = xb + kThreadBlock * d;
  const long long first = (long long)blockIdx.x * kThreadBlock;
  const int rows = (int)min((long long)kThreadBlock, num_walkers - first);
  load_rows(q, first, rows, d, qb);
  load_rows(g, first, rows, d, gb);
  __syncthreads();

  const int i = threadIdx.x;
  if (i < rows) {
    const long long w = first + i;
    const float dt = scalars[0], beta = scalars[1], scale = scalars[2];
    const float ck = dt * scale;
    float qv[N], gv[N], pv[N], dtim[N], part[G];
    read_row<N>(qb, i, d, qv);
    read_row<N>(gb, i, d, gv);
#pragma unroll
    for (int k = 0; k < G; ++k) {
      float n[4];
      pbbi::momentum_normals4(t, w0 + (uint32_t)w, (uint32_t)k, k0, k1, n);
      float kin0 = 0.0f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int at = 4 * k + e;
        const bool in = at < d;
        const float imv = in ? inv_mass[at] : 0.0f;
        const float p0 = in ? p_std[at] * n[e] : 0.0f;
        kin0 += p0 * p0 * imv;
        dtim[at] = dt * imv;
        pv[at] = p0 - (0.5f * ck) * gv[at];
      }
      part[k] = kin0;
    }
    const float u0 = u[w];
    const float h0 = 0.5f * lane_sum<G>(part) + scale * u0;

    for (int s = 0; s < num_steps; ++s) {
#pragma unroll
      for (int e = 0; e < N; ++e) qv[e] += pv[e] * dtim[e];
      form.template grad_thread<N>(qv, gv, smem);
#pragma unroll
      for (int e = 0; e < N; ++e) pv[e] -= ck * gv[e];
    }
    const float u1 =
        num_steps > 0 ? form.template value_thread<N>(qv, smem) : u0;
#pragma unroll
    for (int k = 0; k < G; ++k) {
      float kin1 = 0.0f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int at = 4 * k + e;
        const float imv = at < d ? inv_mass[at] : 0.0f;
        pv[at] += (0.5f * ck) * gv[at];
        kin1 += pv[at] * pv[at] * imv;
      }
      part[k] = kin1;
    }
    const float h1 = 0.5f * lane_sum<G>(part) + scale * u1;
    const Decision dec =
        metropolis(h0, h1, beta, threshold,
                   logf(pbbi::accept_uniform(t, w0 + (uint32_t)w, k0, k1)));
    if (kProp) {  // the endpoint (q1, -p1), whatever the decision
#pragma unroll
      for (int e = 0; e < N; ++e) pv[e] = -pv[e];
      write_row<N>(xb, i, d, qv);
      write_row<N>(yb, i, d, pv);
    }
    if (!dec.accepted) {  // back to the start
      read_row<N>(qb, i, d, qv);
      read_row<N>(gb, i, d, gv);
    }
    write_row<N>(qb, i, d, qv);
    write_row<N>(gb, i, d, gv);
    u_out[w] = dec.accepted ? u1 : u0;
    acc_out[w] = dec.accept_prob;
    taken_out[w] = dec.accepted ? 1 : 0;
    derr_out[w] = dec.energy_error;
  }
  __syncthreads();
  store_rows(q_out, first, rows, d, qb);
  store_rows(g_out, first, rows, d, gb);
  if (kProp) {
    store_rows(q_prop, first, rows, d, xb);
    store_rows(p_prop, first, rows, d, yb);
  }
}

// Kernel D: num_steps kick-drift-kick steps of each walker, as
// leapfrog.cu's leapfrog_kernel (the cached (u, g) when g is given, else g
// evaluated at q).
template <class Form, int N>
__global__ void __launch_bounds__(kThreadBlock, thread_min_blocks<N>())
thread_leapfrog_kernel(Form form, const float* __restrict__ q,
                       const float* __restrict__ p,
                       const float* __restrict__ u,
                       const float* __restrict__ g,
                       const float* __restrict__ inv_mass,
                       const float* __restrict__ step,
                       float* __restrict__ q_out, float* __restrict__ p_out,
                       float* __restrict__ u_out, float* __restrict__ g_out,
                       int num_walkers, int num_dims, int num_steps) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int d = num_dims;
  form.stage(smem, d, 1);
  float* qb = smem + params_floats(form, d);
  float* pb = qb + kThreadBlock * d;
  float* gb = pb + kThreadBlock * d;
  const long long first = (long long)blockIdx.x * kThreadBlock;
  const int rows = (int)min((long long)kThreadBlock, num_walkers - first);
  const bool cached = g != nullptr;
  load_rows(q, first, rows, d, qb);
  load_rows(p, first, rows, d, pb);
  if (cached) load_rows(g, first, rows, d, gb);
  __syncthreads();

  const int i = threadIdx.x;
  if (i < rows) {
    const long long w = first + i;
    const float dt = step[0];
    const float half = 0.5f * dt;
    float qv[N], pv[N], gv[N], imv[N];
#pragma unroll
    for (int e = 0; e < N; ++e) imv[e] = e < d ? inv_mass[e] : 0.0f;
    read_row<N>(qb, i, d, qv);
    read_row<N>(pb, i, d, pv);
    if (cached) {
      read_row<N>(gb, i, d, gv);
    } else {
      form.template grad_thread<N>(qv, gv, smem);
    }
    for (int s = 0; s < num_steps; ++s) {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        pv[e] -= half * gv[e];
        qv[e] += (dt * pv[e]) * imv[e];
      }
      form.template grad_thread<N>(qv, gv, smem);
#pragma unroll
      for (int e = 0; e < N; ++e) pv[e] -= half * gv[e];
    }
    u_out[w] = cached && num_steps == 0
                   ? u[w]
                   : form.template value_thread<N>(qv, smem);
    write_row<N>(qb, i, d, qv);
    write_row<N>(pb, i, d, pv);
    write_row<N>(gb, i, d, gv);
  }
  __syncthreads();
  store_rows(q_out, first, rows, d, qb);
  store_rows(p_out, first, rows, d, pb);
  store_rows(g_out, first, rows, d, gb);
}

// Run `body(form, std::integral_constant<int, N>)` for form 7 or 9
// (forms.cuh with_form) at D = count + 2 <= kMaxThreadDims, N = 4 ceil(D /
// 4); cudaErrorInvalidValue for any other form or shape.
template <class Body>
int with_thread_form(int form, const float* param0, const float* param1,
                     const float* param2, int count, int num_dims,
                     Body body) {
  if (count <= 0 || num_dims != count + 2 || num_dims > kMaxThreadDims)
    return (int)cudaErrorInvalidValue;
  auto dims = [&](auto f) {
    switch ((num_dims + 3) / 4) {
      case 1: return body(f, std::integral_constant<int, 4>{});
      case 2: return body(f, std::integral_constant<int, 8>{});
      case 3: return body(f, std::integral_constant<int, 12>{});
      case 4: return body(f, std::integral_constant<int, 16>{});
      default: return (int)cudaErrorInvalidValue;
    }
  };
  if (form == 7) return dims(EightSchoolsForm{param0, param1, param2, count});
  if (form == 9)
    return dims(EightSchoolsCentredForm{param0, param1, param2, count});
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of a block: the form's parameters and `buffers`
// row buffers of kThreadBlock walkers.
template <class Form>
size_t thread_shared_bytes(const Form& form, int d, int buffers) {
  return sizeof(float) * (params_floats(form, d) + buffers * kThreadBlock * d);
}

template <class Kernel, class... Args>
int launch(Kernel kernel, size_t smem, int num_walkers, void* stream,
           Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks =
      (unsigned)((num_walkers + kThreadBlock - 1) / kThreadBlock);
  kernel<<<blocks, kThreadBlock, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernel B in the thread layout: pbbi_fused_hmc_transition's arguments
// (fused_hmc.cu), for forms 7 and 9 at D = count + 2 <= 16; walker_tile
// must be 1.
int pbbi_fused_hmc_transition_threads(
    int form, const float* param0, const float* param1, const float* param2,
    int count, const float* q, const float* u, const float* g,
    const float* inv_mass, const float* p_std, const float* scalars,
    float* q_out, float* u_out, float* g_out, float* acc_out,
    uint8_t* taken_out, float* derr_out, float* q_prop, float* p_prop,
    const int* steps_dev, int num_walkers, int num_dims, int num_steps,
    int walker_tile, float threshold, uint64_t seed, uint32_t counter,
    uint32_t walker_offset, void* stream) {
  if (num_walkers <= 0 || num_steps < 0 || walker_tile != 1 ||
      (q_prop == nullptr) != (p_prop == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool dyn = steps_dev != nullptr, prop = q_prop != nullptr;
  return with_thread_form(
      form, param0, param1, param2, count, num_dims, [&](auto f, auto n) {
        using Form = decltype(f);
        constexpr int N = decltype(n)::value;
        using Kernel =
            decltype(&thread_transition_kernel<Form, N, false, false>);
        static const Kernel table[4] = {
            &thread_transition_kernel<Form, N, false, false>,
            &thread_transition_kernel<Form, N, false, true>,
            &thread_transition_kernel<Form, N, true, false>,
            &thread_transition_kernel<Form, N, true, true>};
        return launch(table[2 * dyn + prop],
                      thread_shared_bytes(f, num_dims, prop ? 4 : 2),
                      num_walkers, stream, f, q, u, g, inv_mass, p_std,
                      scalars, q_out, u_out, g_out, acc_out, taken_out,
                      derr_out, q_prop, p_prop, steps_dev, num_walkers,
                      num_dims, num_steps, threshold, (uint32_t)seed,
                      (uint32_t)(seed >> 32), counter, walker_offset);
      });
}

// Kernel D in the thread layout: pbbi_leapfrog_trajectory's arguments
// (leapfrog.cu), for forms 7 and 9 at D = count + 2 <= 16; walker_tile
// must be 1.
int pbbi_leapfrog_trajectory_threads(
    int form, const float* param0, const float* param1, const float* param2,
    int count, const float* q, const float* p, const float* u, const float* g,
    const float* inv_mass, const float* step, float* q_out, float* p_out,
    float* u_out, float* g_out, int num_walkers, int num_dims, int num_steps,
    int walker_tile, void* stream) {
  if (num_walkers <= 0 || num_steps < 0 || walker_tile != 1 ||
      (u == nullptr) != (g == nullptr))
    return (int)cudaErrorInvalidValue;
  return with_thread_form(
      form, param0, param1, param2, count, num_dims, [&](auto f, auto n) {
        using Form = decltype(f);
        constexpr int N = decltype(n)::value;
        return launch(&thread_leapfrog_kernel<Form, N>,
                      thread_shared_bytes(f, num_dims, 3), num_walkers,
                      stream, f, q, p, u, g, inv_mass, step, q_out, p_out,
                      u_out, g_out, num_walkers, num_dims, num_steps);
      });
}

}  // extern "C"
