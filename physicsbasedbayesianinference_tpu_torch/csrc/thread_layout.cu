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
// :140), for the forms whose gradient couples a walker's dims (forms.cuh):
// the two eight-schools forms and the two funnel forms up to D = 16, the
// N-body form in 2 or 3 space dims up to D = 24 (kMaxDims,
// kMaxNbodyDims) and the Gaussian mixture of up to kMaxMixture components
// up to D = 16, where ops/kernels.py walker_layout chooses it
// (THREAD_LAYOUT_DIMS). Above that the forms run in the lane-group layout
// of fused_hmc.cu and leapfrog.cu.
//
// Why a layout of its own: the lane-group layout gives a walker T =
// next_pow2(ceil(D / 4)) lanes, four dims a lane, and its sums over dims
// are shuffles. Where a gradient couples every dim to the others (an
// eight-schools gradient to every school, the funnel's to sum x_j^2, an
// N-body force to every other body), each of the T lanes shared the
// walker through a buffer row under a warp barrier and ran the whole
// coupling sum alone (at D = 10 lane 3 owned no dim at all; at 8 bodies in
// 3-D lanes 6 and 7 idled and each pair's distance was taken 6 times; the
// mixture at D = 2 had one lane, which still wrote its walker to the
// buffer, waited at the barrier and took each component's term twice from
// loops whose counts it learned at run time).
// Here one thread holds one walker's N = 4 ceil(D / 4) dims (q, p, g in
// registers, zeros past D) and runs the sum once a gradient, the N-body
// pairs once each: no shared walker buffer, no warp barrier, no shuffle in
// the trajectory. The forms' arithmetic is the lane-group layout's, term
// for term, so both layouts give the same bits.
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
// outputs and 3% slower in D, and at D = 16 15-60% slower (PERF.md). The
// drift's metric (dt / m in B, 1 / m in D) is staged once a block too and
// read in 16-byte broadcasts each step rather than held in N registers.
//
// What bounds it: the arithmetic. Rows are read and written once a
// transition against 17 gradients of some 7-8 J + 9-13 (eight schools),
// 2 D + 6 (funnel) or N (N - 1) / 2 (3 S + 7) + 2 D (N-body) operations
// each, plus each exponential, division and root at the length of its
// instruction sequence (chip_smoke.py gradient_ops), so at D = 10 and 16
// the bytes and the operations are of one size (0.005-0.008 ms at W =
// 102400, PERF.md) and at 8 bodies the operations lead. At W = 102400 the
// launch is 800 blocks of 128 threads, 6.1 a SM. A parallel-tempering
// sweep of the mixture (6 rungs of 16384 walkers at D = 2) is 768 blocks,
// and each walker's chain of 10 steps of exponentials and divisions is
// long against what the card has to do: its time is that chain's latency
// unless every block is resident at once (thread_min_blocks).

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
// Blocks of kThreadBlock threads the compiler must fit on an SM, for every
// form (0: by form and N, thread_min_blocks).
#ifndef PBBI_THREAD_MIN_BLOCKS
#define PBBI_THREAD_MIN_BLOCKS 0
#endif
// Dims the eight-schools, funnel and mixture forms take here, and the
// N-body form.
constexpr int kMaxDims = 16;
constexpr int kMaxNbodyDims = 24;

// The register policy, by form and N (tools/kernel_sweeps.py --only
// threads on an H100 80GB HBM3 at 700 W, PERF.md). The eight-schools forms:
// up to N = 12, 8 blocks, 64 registers a thread, 32 warps an SM (uncapped
// the kernels took 110-116 registers at N = 12, 94 in D, and B 12% more
// time, D 20%; caps of 80 and 48 registers 11-21% more); above N = 12 no
// cap (N = 16 took 118-128 registers, and a cap of 80 was 4-9% slower in
// B). The funnel and N-body forms: 4 blocks, 128 registers, at every N
// (the funnel's B at N = 12 takes 14% less time than under 64 registers;
// N-body B at 8 bodies in 3-D 24% less than uncapped at 152-154 registers
// and 9% less than under 64; within 6% of the fastest cap at every shape
// swept but B at 12 bodies in 2-D, where 64 registers take 12% less with
// the count fixed and 20% more with the proposal outputs). The mixture
// (KP = 2): 8 blocks (64 registers) up to N = 8, 4 (128) above (at N = 16
// the cap of 64 took 12% more time than 128 in B, 15% in D; at N = 4 and 8
// every cap from 1 to 8 blocks was within 3% of the others, the
// parallel-tempering sweep within 1.1%).
template <class Form, int N>
constexpr int thread_min_blocks() {
  if constexpr (PBBI_THREAD_MIN_BLOCKS > 0) {
    return PBBI_THREAD_MIN_BLOCKS;
  } else if constexpr (std::is_same_v<Form, EightSchoolsForm> ||
                       std::is_same_v<Form, EightSchoolsCentredForm>) {
    return N <= 12 ? 8 : 1;
  } else if constexpr (std::is_same_v<Form, MixtureThreadForm<kMaxMixture>>) {
    return N <= 8 ? 8 : 4;
  } else {
    return 4;
  }
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

// Floats of the staged metric after the parameters: N = 4 ceil(d / 4).
__host__ __device__ inline int metric_floats(int d) { return (d + 3) / 4 * 4; }

// The drift's metric, scale * inv_mass (zeros past d), staged by the block
// at `to` for the N dims of a thread's walker.
__device__ __forceinline__ void stage_metric(const float* __restrict__ inv_mass,
                                             float scale, int d, float* to) {
  for (int i = threadIdx.x; i < metric_floats(d); i += kThreadBlock)
    to[i] = i < d ? scale * inv_mass[i] : 0.0f;
}

// The staged metric's dims 4 k .. 4 k + 3: one 16-byte broadcast (the
// same address for every thread)
__device__ __forceinline__ void metric4(const float* m, int k, float v[4]) {
  const float4 m4 = reinterpret_cast<const float4*>(m)[k];
  v[0] = m4.x, v[1] = m4.y, v[2] = m4.z, v[3] = m4.w;
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
__global__ void __launch_bounds__(kThreadBlock, thread_min_blocks<Form, N>())
thread_transition_kernel(
    Form form, const float* __restrict__ q, const float* __restrict__ u,
    const float* __restrict__ g, const float* __restrict__ inv_mass,
    const float* __restrict__ p_std, const float* __restrict__ scalars,
    float* __restrict__ q_out, float* __restrict__ u_out,
    float* __restrict__ g_out, float* __restrict__ acc_out,
    uint8_t* __restrict__ taken_out, float* __restrict__ derr_out,
    float* __restrict__ q_prop, float* __restrict__ p_prop,
    const int* __restrict__ steps_dev, int num_walkers, int num_dims,
    int num_steps, float threshold,
    const __grid_constant__ RungKeys keys, uint32_t t, uint32_t w0) {
  constexpr int G = N / 4;
  if (kDyn) num_steps = device_steps(steps_dev, num_steps);
  const Rung rung = this_rung(keys, num_walkers);
  const uint32_t k0 = rung.k0, k1 = rung.k1;
  p_std += rung.index * num_dims;
  scalars += 3 * rung.index;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int d = num_dims;
  form.stage(smem, d, 1);
  // dt / m of the drift; q and g in, q' and g' out; the proposal's q1 and
  // -p1
  float* dtm = smem + params_floats(form, d);
  stage_metric(inv_mass, scalars[0], d, dtm);
  float* qb = dtm + metric_floats(d);
  float* gb = qb + kThreadBlock * d;
  float* xb = gb + kThreadBlock * d;
  float* yb = xb + kThreadBlock * d;
  // the block's first walker: within its rung, and its row in the arrays
  const long long first = (long long)blockIdx.x * kThreadBlock;
  const long long at = rung.row + first;
  const int rows = (int)min((long long)kThreadBlock, num_walkers - first);
  load_rows(q, at, rows, d, qb);
  load_rows(g, at, rows, d, gb);
  __syncthreads();

  const int i = threadIdx.x;
  if (i < rows) {
    const long long w = first + i;
    const float dt = scalars[0], beta = scalars[1], scale = scalars[2];
    const float ck = dt * scale;
    float qv[N], gv[N], pv[N], part[G];
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
        pv[at] = p0 - (0.5f * ck) * gv[at];
      }
      part[k] = kin0;
    }
    const float u0 = u[at + i];
    const float h0 = 0.5f * lane_sum<G>(part) + scale * u0;

    for (int s = 0; s < num_steps; ++s) {
#pragma unroll
      for (int k = 0; k < G; ++k) {
        float m[4];
        metric4(dtm, k, m);
#pragma unroll
        for (int e = 0; e < 4; ++e) qv[4 * k + e] += pv[4 * k + e] * m[e];
      }
      form.template grad_thread<N>(qv, gv, d, smem);
#pragma unroll
      for (int e = 0; e < N; ++e) pv[e] -= ck * gv[e];
    }
    const float u1 =
        num_steps > 0 ? form.template value_thread<N>(qv, d, smem) : u0;
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
    u_out[at + i] = dec.accepted ? u1 : u0;
    acc_out[at + i] = dec.accept_prob;
    taken_out[at + i] = dec.accepted ? 1 : 0;
    derr_out[at + i] = dec.energy_error;
  }
  __syncthreads();
  store_rows(q_out, at, rows, d, qb);
  store_rows(g_out, at, rows, d, gb);
  if (kProp) {
    store_rows(q_prop, at, rows, d, xb);
    store_rows(p_prop, at, rows, d, yb);
  }
}

// Kernel D: num_steps kick-drift-kick steps of each walker, as
// leapfrog.cu's leapfrog_kernel (the cached (u, g) when g is given, else g
// evaluated at q).
template <class Form, int N>
__global__ void __launch_bounds__(kThreadBlock, thread_min_blocks<Form, N>())
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
  // 1 / m of the drift; q, p and g in, q', p' and g' out
  float* im = smem + params_floats(form, d);
  stage_metric(inv_mass, 1.0f, d, im);
  float* qb = im + metric_floats(d);
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
    float qv[N], pv[N], gv[N];
    read_row<N>(qb, i, d, qv);
    read_row<N>(pb, i, d, pv);
    if (cached) {
      read_row<N>(gb, i, d, gv);
    } else {
      form.template grad_thread<N>(qv, gv, d, smem);
    }
    for (int s = 0; s < num_steps; ++s) {
#pragma unroll
      for (int k = 0; k < N / 4; ++k) {
        float m[4];
        metric4(im, k, m);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int at = 4 * k + e;
          pv[at] -= half * gv[at];
          qv[at] += (dt * pv[at]) * m[e];
        }
      }
      form.template grad_thread<N>(qv, gv, d, smem);
#pragma unroll
      for (int e = 0; e < N; ++e) pv[e] -= half * gv[e];
    }
    u_out[w] = cached && num_steps == 0
                   ? u[w]
                   : form.template value_thread<N>(qv, d, smem);
    write_row<N>(qb, i, d, qv);
    write_row<N>(pb, i, d, pv);
    write_row<N>(gb, i, d, gv);
  }
  __syncthreads();
  store_rows(q_out, first, rows, d, qb);
  store_rows(p_out, first, rows, d, pb);
  store_rows(g_out, first, rows, d, gb);
}

// Run `body(form, std::integral_constant<int, N>)` at N = 4 ceil(D / 4)
// for D <= kMax; cudaErrorInvalidValue past it.
template <int kMax, class Form, class Body>
int with_dims(const Form& form, int num_dims, Body body) {
  if (num_dims < 1 || num_dims > kMax) return (int)cudaErrorInvalidValue;
  switch ((num_dims + 3) / 4) {
    case 1: return body(form, std::integral_constant<int, 4>{});
    case 2: return body(form, std::integral_constant<int, 8>{});
    case 3: return body(form, std::integral_constant<int, 12>{});
    case 4: return body(form, std::integral_constant<int, 16>{});
    case 5:
      if constexpr (kMax >= 20)
        return body(form, std::integral_constant<int, 20>{});
      break;
    case 6:
      if constexpr (kMax >= 24)
        return body(form, std::integral_constant<int, 24>{});
      break;
  }
  return (int)cudaErrorInvalidValue;
}

// Run `body(form, std::integral_constant<int, N>)` for the forms of this
// layout (forms.cuh with_form's numbering): 7 and 9 at D = count + 2 <=
// kMaxDims, 1 and 11 at D <= kMaxDims, 3 at D <= kMaxDims with count = K
// <= kMaxMixture (padded to KP = kMaxMixture), 4 at D = count S <=
// kMaxNbodyDims with S = 2 or 3; cudaErrorInvalidValue for any other form
// or shape.
template <class Body>
int with_thread_form(int form, const float* param0, const float* param1,
                     const float* param2, int count, int num_dims,
                     Body body) {
  switch (form) {
    case 1:
      return with_dims<kMaxDims>(FunnelForm{param0}, num_dims, body);
    case 11:
      return with_dims<kMaxDims>(FunnelForm{param0, param1}, num_dims, body);
    case 3: {
      const MixtureForm mix{param0, param1, param2, count};
      if (count <= 0 || count > kMaxMixture) break;
      return with_dims<kMaxDims>(MixtureThreadForm<kMaxMixture>{mix},
                                 num_dims, body);
    }
    case 4:
      if (count <= 0 || num_dims % count != 0) break;
      if (num_dims / count == 2)
        return with_dims<kMaxNbodyDims>(
            NbodyThreadForm<2>{{param0, param1, count}}, num_dims, body);
      if (num_dims / count == 3)
        return with_dims<kMaxNbodyDims>(
            NbodyThreadForm<3>{{param0, param1, count}}, num_dims, body);
      break;
    case 7:
      if (count <= 0 || num_dims != count + 2) break;
      return with_dims<kMaxDims>(
          EightSchoolsForm{param0, param1, param2, count}, num_dims, body);
    case 9:
      if (count <= 0 || num_dims != count + 2) break;
      return with_dims<kMaxDims>(
          EightSchoolsCentredForm{param0, param1, param2, count}, num_dims,
          body);
  }
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of a block: the form's parameters, the drift's
// metric and `buffers` row buffers of kThreadBlock walkers.
template <class Form>
size_t thread_shared_bytes(const Form& form, int d, int buffers) {
  return sizeof(float) * (params_floats(form, d) + metric_floats(d) +
                          buffers * kThreadBlock * d);
}

// num_rungs: the launch's rungs (transition.cuh), blockIdx.y.
template <class Kernel, class... Args>
int launch(Kernel kernel, size_t smem, int num_walkers, int num_rungs,
           void* stream, Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(
      (unsigned)((num_walkers + kThreadBlock - 1) / kThreadBlock), num_rungs);
  kernel<<<grid, kThreadBlock, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernel B in the thread layout: pbbi_fused_hmc_transition's arguments
// (fused_hmc.cu), its rung axis included, for the forms and shapes of
// with_thread_form; walker_tile must be 1.
int pbbi_fused_hmc_transition_threads(
    int form, const float* param0, const float* param1, const float* param2,
    int count, const float* q, const float* u, const float* g,
    const float* inv_mass, const float* p_std, const float* scalars,
    float* q_out, float* u_out, float* g_out, float* acc_out,
    uint8_t* taken_out, float* derr_out, float* q_prop, float* p_prop,
    const int* steps_dev, int num_walkers, int num_dims, int num_steps,
    int walker_tile, float threshold, int num_rungs, const uint64_t* seeds,
    uint32_t counter, uint32_t walker_offset, void* stream) {
  RungKeys keys;
  if (num_walkers <= 0 || num_steps < 0 || walker_tile != 1 ||
      (q_prop == nullptr) != (p_prop == nullptr) ||
      !rung_keys(num_rungs, seeds, &keys))
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
                      num_walkers, num_rungs, stream, f, q, u, g, inv_mass,
                      p_std, scalars, q_out, u_out, g_out, acc_out,
                      taken_out, derr_out, q_prop, p_prop, steps_dev,
                      num_walkers, num_dims, num_steps, threshold, keys,
                      counter, walker_offset);
      });
}

// Kernel D in the thread layout: pbbi_leapfrog_trajectory's arguments
// (leapfrog.cu), for the forms and shapes of with_thread_form; walker_tile
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
                      thread_shared_bytes(f, num_dims, 3), num_walkers, 1,
                      stream, f, q, p, u, g, inv_mass, step, q_out, p_out,
                      u_out, g_out, num_walkers, num_dims, num_steps);
      });
}

}  // extern "C"
