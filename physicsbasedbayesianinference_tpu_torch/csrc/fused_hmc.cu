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
// own one walker, lane l owning groups l, l + T, ... (kernel A), or, in
// kernel B (D <= 128, one group per lane), the R walkers of their lane
// group; per-walker sums (H0, H1, U) are xor-butterfly shuffles over those
// T lanes. The TPU version's 128-lane walker packing and its segment-sum
// matmuls have no counterpart: the reductions are shuffles here.
//
// Bound: kernel A at the bench shape (W = 102400, D = 32, L = 16) must read
// q (13.1 MB) and write q' and g' (26.2 MB): 39.3 MB, 0.0117 ms at the
// H100's 3.35 TB/s, and that is all it moves. Its arithmetic in registers
// (six operations per dim and step, a Philox block and two Box-Muller
// pairs per four dims, one more Philox block per walker) is of the same
// order, so the kernel sits between the two bounds. Kernel B with the
// Gaussian form is bound by its D x D matvec per step instead: 17 x 1024
// multiply-adds a walker at that shape, 0.060 ms at the FP32 rate, against
// 52 MB (0.016 ms). What holds it is neither: the operands come from
// shared memory, whose 128 bytes a clock and SM feed a quarter of the
// multiply-add rate at one 4-byte operand each. So a lane keeps a 4-dim x
// R-walker tile of the gradient in registers (R = 4: 2 bytes a
// multiply-add, forms.cuh), and the kernel runs at the shared-memory rate:
// 0.137 ms on an H100 80GB HBM3 at 700 W, from 0.334 ms without the tile
// (tools/compare_builds.py, tools/kernel_sweeps.py). The logistic form is
// bound the same way by its two N x D products per step, and tiled the
// same way (forms.cuh LogisticForm).
//
// Scalars (step size, beta, potential scale) come from a device array, so
// adapting the step size never needs a host read-back. Outputs are
// allocated by the caller; no kernel allocates or synchronises.
//
// Rungs (transition.cuh): blockIdx.y is the rung of a parallel-tempering
// ladder, each rung an ensemble of W rows with its own Philox key, scalars
// and momentum std, so one launch sweeps a block of rungs. Launched one
// rung at a time, phase 10's ladder (6 rungs of 16384 walkers in 2-D, the
// mixture form) was six launches of 64 blocks of 256 threads on the card's
// 132 SMs, each a serial chain of 10 leapfrog steps bound by latency and
// not by bytes or arithmetic, each with its own host work; as one launch it
// is 384 blocks. A launch of one rung is the case R = 1 of the same code.
//
// The TPU kernels' dynamic_steps and emit_proposal (what ChEES-HMC needs)
// are template flags here, so that the kernels without them are unchanged:
// kDyn reads the leapfrog count from device memory and clips it to [1,
// max_steps] (device_steps; uniform over the grid, so the trajectory loop,
// whose bound was a run-time value already, stays as it was); kProp (kernel
// B) stores every walker's endpoint (q1, -p1) before the accept-select, from
// the registers that hold it, so that a rejected walker's start is still
// read again and not kept. Kernel A has no proposal outputs, as on the TPU:
// kernel B takes the diagonal form where they are asked for. The TPU's
// kernel C was also its route for the models' data-matmul potentials; here
// those are device forms of kernel B (forms.cuh: LogisticForm, LinearForm,
// and the other example models' EightSchoolsForm, EightSchoolsCentredForm,
// CoinForm and the funnel and diagonal forms with a constant). The two
// eight-schools forms run one walker a thread up to D = 16, in
// thread_layout.cu's kernel B (ops/kernels.py walker_layout); this file's
// layout takes them above that.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "forms.cuh"
#include "philox.cuh"
#include "transition.cuh"

namespace {

// ---------------------------------------------------------------------------
// Kernel A: U = 0.5 sum_d k_d (q_d - mu_d)^2, separable by dimension.
//
// D <= 128 (every lane owns one dim-group): diag_quadratic_kernel. The lane
// keeps q0 and the endpoint (q1, p1) in registers, the walker's lanes take
// the decision, and each lane stores the selected q' and g' once: q in,
// q' and g' out and nothing else, with no second pass over memory. The
// per-dimension parameters are staged in shared memory once a block, padded
// with zeros to whole dim-groups, and read as one 16-byte load each. With
// kVec (D % 4 == 0 and q, q', g' 16-byte aligned, checked by the launcher)
// the lane's four floats of q, q' and g' are one 16-byte access each;
// otherwise they are scalar accesses with a bound test.
//
// D > 128: diag_quadratic_loop_kernel, a lane owning several groups in
// turn. Each group's trajectory runs in registers; q' and g' are written
// as soon as the group is done and rewritten from q for rejected walkers,
// so any D works with a fixed register budget.
//
// Both draw the same Philox bits and round every sum in the same order.
//
// kBf16 (D <= 128 only; the TPU kernel's trajectory_dtype=bfloat16): the
// drift/kick chain runs on bfloat16 pairs. q0, the momentum after the
// first half kick, k, mu, dt * inv_mass and dt * scale are rounded to
// bfloat16 (to nearest even), each of the chain's operations is one
// correctly rounded __nv_bfloat162 instruction (the _rn forms, which the
// compiler never contracts into a multiply-add: the plain version rounds
// each operation once, as torch's bfloat16 tensors do), and the end point
// comes back to float32 for the last half kick, both energies and the
// Metropolis test. A lane's four dims are two pairs, so a step is six
// paired instructions where float32 takes twelve (no contraction here
// either): the chain is what bounds kernel A by instruction issue.
// ---------------------------------------------------------------------------

#ifndef PBBI_A_BLOCK
#define PBBI_A_BLOCK 256
#endif
#ifndef PBBI_A_MIN_BLOCKS
#define PBBI_A_MIN_BLOCKS 1
#endif
constexpr int kBlockA = PBBI_A_BLOCK;

// L steps of q += p dtim; p -= ck (k (q - mu)) on the lane's four dims as
// two bfloat16 pairs, from and back to float32
__device__ __forceinline__ void bf16_chain(float qv[4], float pv[4],
                                           const float kv[4],
                                           const float mv[4],
                                           const float dtim[4], float ck,
                                           int num_steps) {
  __nv_bfloat162 qb[2], pb[2], kb[2], mb[2], db[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qb[h] = __floats2bfloat162_rn(qv[2 * h], qv[2 * h + 1]);
    pb[h] = __floats2bfloat162_rn(pv[2 * h], pv[2 * h + 1]);
    kb[h] = __floats2bfloat162_rn(kv[2 * h], kv[2 * h + 1]);
    mb[h] = __floats2bfloat162_rn(mv[2 * h], mv[2 * h + 1]);
    db[h] = __floats2bfloat162_rn(dtim[2 * h], dtim[2 * h + 1]);
  }
  const __nv_bfloat162 cb = __float2bfloat162_rn(ck);
  for (int s = 0; s < num_steps; ++s) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      qb[h] = __hadd2_rn(qb[h], __hmul2_rn(pb[h], db[h]));
      pb[h] = __hsub2_rn(
          pb[h], __hmul2_rn(cb, __hmul2_rn(kb[h], __hsub2_rn(qb[h], mb[h]))));
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qv[2 * h] = __low2float(qb[h]);
    qv[2 * h + 1] = __high2float(qb[h]);
    pv[2 * h] = __low2float(pb[h]);
    pv[2 * h + 1] = __high2float(pb[h]);
  }
}

template <bool kVec, bool kDyn, bool kBf16>
__global__ void __launch_bounds__(kBlockA, PBBI_A_MIN_BLOCKS)
diag_quadratic_kernel(
    const float* __restrict__ q, const float* __restrict__ kdiag,
    const float* __restrict__ mean, const float* __restrict__ inv_mass,
    const float* __restrict__ p_std, const float* __restrict__ scalars,
    float* __restrict__ q_out, float* __restrict__ g_out,
    float* __restrict__ u_out, float* __restrict__ acc_out,
    uint8_t* __restrict__ taken_out, float* __restrict__ derr_out,
    const int* __restrict__ steps_dev, int num_walkers, int num_dims, int tpw,
    int num_steps, float threshold,
    const __grid_constant__ RungKeys keys, uint32_t t, uint32_t w0) {
  if (kDyn) num_steps = device_steps(steps_dev, num_steps);
  const Rung rung = this_rung(keys, num_walkers);
  const uint32_t k0 = rung.k0, k1 = rung.k1;
  p_std += rung.index * num_dims;
  scalars += 3 * rung.index;
  // k, mean, inv_mass, p_std, each padded with zeros to 4 * tpw floats
  __shared__ float4 params[kMaxGenericDims];
  // log of the Metropolis uniform of each of the block's walkers, drawn by
  // the block's first threads, one walker each, and not by every lane
  __shared__ float log_u[kBlockA];
  const int wpb = kBlockA / tpw;
  if (threadIdx.x < wpb)
    log_u[threadIdx.x] = logf(pbbi::accept_uniform(
        t, w0 + (uint32_t)((long long)blockIdx.x * wpb + threadIdx.x), k0,
        k1));
  {
    float* sh = reinterpret_cast<float*>(params);
    const int padded = 4 * tpw;
    for (int i = threadIdx.x; i < padded; i += kBlockA) {
      const bool in = i < num_dims;
      sh[i] = in ? kdiag[i] : 0.0f;
      sh[padded + i] = in ? mean[i] : 0.0f;
      sh[2 * padded + i] = in ? inv_mass[i] : 0.0f;
      sh[3 * padded + i] = in ? p_std[i] : 0.0f;
    }
  }
  __syncthreads();

  const int lane = threadIdx.x % tpw;
  const int slot = threadIdx.x / tpw;
  const long long w = (long long)blockIdx.x * wpb + slot;
  const int base = 4 * lane;
  const bool active = w < num_walkers && base < num_dims;
  const long long at = (rung.row + w) * num_dims + base;
  const float dt = scalars[0], beta = scalars[1], scale = scalars[2];
  const float ck = dt * scale;

  float kv[4], mv[4], imv[4], sd[4];
  *reinterpret_cast<float4*>(kv) = params[lane];
  *reinterpret_cast<float4*>(mv) = params[tpw + lane];
  *reinterpret_cast<float4*>(imv) = params[2 * tpw + lane];
  *reinterpret_cast<float4*>(sd) = params[3 * tpw + lane];
  float q0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (active) {
    if (kVec) {
      *reinterpret_cast<float4*>(q0) =
          *reinterpret_cast<const float4*>(q + at);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (base + e < num_dims) q0[e] = q[at + e];
    }
  }
  float n[4];
  pbbi::momentum_normals4(t, w0 + (uint32_t)w, (uint32_t)lane, k0, k1,
                          n);

  float u0 = 0.0f, kin0 = 0.0f, u1 = 0.0f, kin1 = 0.0f;  // lane partials
  float qv[4], pv[4], dtim[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float p0 = sd[e] * n[e];  // 0 beyond D: p_std is padded with 0
    const float qc = q0[e] - mv[e];
    u0 += kv[e] * qc * qc;
    kin0 += p0 * p0 * imv[e];
    dtim[e] = dt * imv[e];
    pv[e] = p0 - (0.5f * ck) * (kv[e] * qc);
    qv[e] = q0[e];
  }
  if (kBf16) {
    bf16_chain(qv, pv, kv, mv, dtim, ck, num_steps);
  } else {
    for (int s = 0; s < num_steps; ++s) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        qv[e] += pv[e] * dtim[e];
        pv[e] -= ck * (kv[e] * (qv[e] - mv[e]));
      }
    }
  }
  float g1[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float qc = qv[e] - mv[e];
    g1[e] = kv[e] * qc;
    pv[e] += (0.5f * ck) * g1[e];
    u1 += g1[e] * qc;
    kin1 += pv[e] * pv[e] * imv[e];
  }
  const float uu0 = 0.5f * segment_sum(u0, tpw);
  const float uu1 = 0.5f * segment_sum(u1, tpw);
  const float h0 = 0.5f * segment_sum(kin0, tpw) + scale * uu0;
  const float h1 = 0.5f * segment_sum(kin1, tpw) + scale * uu1;
  const Decision dec = metropolis(h0, h1, beta, threshold, log_u[slot]);
  if (w >= num_walkers) return;
  if (lane == 0) {
    const long long row = rung.row + w;
    u_out[row] = dec.accepted ? uu1 : uu0;
    acc_out[row] = dec.accept_prob;
    taken_out[row] = dec.accepted ? 1 : 0;
    derr_out[row] = dec.energy_error;
  }
  if (!active) return;
  float qs[4], gs[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    qs[e] = dec.accepted ? qv[e] : q0[e];
    gs[e] = dec.accepted ? g1[e] : kv[e] * (q0[e] - mv[e]);
  }
  if (kVec) {
    *reinterpret_cast<float4*>(q_out + at) =
        *reinterpret_cast<const float4*>(qs);
    *reinterpret_cast<float4*>(g_out + at) =
        *reinterpret_cast<const float4*>(gs);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (base + e < num_dims) {
        q_out[at + e] = qs[e];
        g_out[at + e] = gs[e];
      }
  }
}

template <bool kDyn>
__global__ void __launch_bounds__(kBlock) diag_quadratic_loop_kernel(
    const float* __restrict__ q, const float* __restrict__ kdiag,
    const float* __restrict__ mean, const float* __restrict__ inv_mass,
    const float* __restrict__ p_std, const float* __restrict__ scalars,
    float* __restrict__ q_out, float* __restrict__ g_out,
    float* __restrict__ u_out, float* __restrict__ acc_out,
    uint8_t* __restrict__ taken_out, float* __restrict__ derr_out,
    const int* __restrict__ steps_dev, int num_walkers, int num_dims, int tpw,
    int num_steps, float threshold,
    const __grid_constant__ RungKeys keys, uint32_t t, uint32_t w0) {
  if (kDyn) num_steps = device_steps(steps_dev, num_steps);
  const Rung rung = this_rung(keys, num_walkers);
  const uint32_t k0 = rung.k0, k1 = rung.k1;
  p_std += rung.index * num_dims;
  scalars += 3 * rung.index;
  const int lane = threadIdx.x % tpw;
  const long long w =
      (long long)blockIdx.x * (kBlock / tpw) + threadIdx.x / tpw;
  const bool valid = w < num_walkers;
  const long long row = (rung.row + w) * num_dims;
  const int groups = (num_dims + 3) / 4;
  const float dt = scalars[0], beta = scalars[1], scale = scalars[2];
  const float ck = dt * scale;

  float u0 = 0.0f, kin0 = 0.0f, u1 = 0.0f, kin1 = 0.0f;  // lane partials
  if (valid) {
    for (int g = lane; g < groups; g += tpw) {
      float n[4];
      pbbi::momentum_normals4(t, w0 + (uint32_t)w, (uint32_t)g, k0, k1,
                              n);
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
      metropolis(h0, h1, beta, threshold,
                 logf(pbbi::accept_uniform(t, w0 + (uint32_t)w, k0, k1)));
  if (!valid) return;
  if (lane == 0) {
    u_out[rung.row + w] = dec.accepted ? uu1 : uu0;
    acc_out[rung.row + w] = dec.accept_prob;
    taken_out[rung.row + w] = dec.accepted ? 1 : 0;
    derr_out[rung.row + w] = dec.energy_error;
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
//
// A lane keeps its dim-group of the lane group's R walkers in registers
// (q, g, p: 12 R floats) for the whole transition; a rejected walker's
// start (q, g) is read again at the end, so that the registers go to the
// tile and not to a copy of the start. R > 1 is for the tiled forms, the
// Gaussian and the logistic regression, whose products per step bound the
// kernel by arithmetic and not by bytes: their gradients read each operand
// once for R walkers (forms.cuh).
// With kVec (D % 4 == 0 and q, g, q', g' 16-byte aligned, checked by the
// launcher) the lane's four floats of each are one 16-byte access;
// otherwise scalar accesses with a bound test. The Philox counter names
// (transition, walker, dim-group), so the draws depend on neither R nor
// kVec.
// ---------------------------------------------------------------------------

template <class Form, int R, bool kVec, bool kDyn, bool kProp>
__global__ void __launch_bounds__(kBlock, kMinBlocks) generic_kernel(
    Form form, const float* __restrict__ q, const float* __restrict__ u,
    const float* __restrict__ g, const float* __restrict__ inv_mass,
    const float* __restrict__ p_std, const float* __restrict__ scalars,
    float* __restrict__ q_out, float* __restrict__ u_out,
    float* __restrict__ g_out, float* __restrict__ acc_out,
    uint8_t* __restrict__ taken_out, float* __restrict__ derr_out,
    float* __restrict__ q_prop, float* __restrict__ p_prop,
    const int* __restrict__ steps_dev, int num_walkers, int num_dims, int tpw,
    int num_steps, float threshold,
    const __grid_constant__ RungKeys keys, uint32_t t, uint32_t w0) {
  if (kDyn) num_steps = device_steps(steps_dev, num_steps);
  const Rung rung = this_rung(keys, num_walkers);
  const uint32_t k0 = rung.k0, k1 = rung.k1;
  p_std += rung.index * num_dims;
  scalars += 3 * rung.index;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  form.stage(smem, num_dims, tpw);
  __syncthreads();

  const int lane = threadIdx.x % tpw;
  const int slot = threadIdx.x / tpw;
  const int groups = kBlock / tpw;
  // walker r of the lane group has the buffer row r * groups + slot: the
  // rows that a warp reads together are neighbours; a row's kBufPad keeps
  // neighbouring rows in different banks
  const int stride = 4 * tpw + Form::kBufPad;
  const int row_step = groups * stride;
  float* buf = smem + form.shared_floats(num_dims, tpw) + slot * stride;
  const long long first = ((long long)blockIdx.x * groups + slot) * R;
  const int base = 4 * lane;
  const float dt = scalars[0], beta = scalars[1], scale = scalars[2];
  const float ck = dt * scale;

  float imv[4], sdv[4], dtim[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const bool in = base + e < num_dims;
    imv[e] = in ? inv_mass[base + e] : 0.0f;
    sdv[e] = in ? p_std[base + e] : 0.0f;
    dtim[e] = dt * imv[e];
  }

  // Lanes of walkers past the end run along on zeros (every lane of the
  // warp takes part in the shuffles and warp barriers) and write nothing.
  float qv[R][4], gv[R][4], pv[R][4], u0[R], h0[R];
  int left[R];  // the lane's dims of walker r that exist: 0 past the end
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long w = first + r;
    const bool valid = w < num_walkers;
    left[r] = valid ? num_dims - base : 0;
    const long long at = valid ? (rung.row + w) * num_dims + base : 0;
    load_group<kVec>(q, at, left[r], qv[r]);
    load_group<kVec>(g, at, left[r], gv[r]);
    float n[4];
    pbbi::momentum_normals4(t, w0 + (uint32_t)w, (uint32_t)lane, k0, k1,
                            n);
    float kin0 = 0.0f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p0 = e < left[r] ? sdv[e] * n[e] : 0.0f;
      kin0 += p0 * p0 * imv[e];
      pv[r][e] = p0 - (0.5f * ck) * gv[r][e];
    }
    u0[r] = valid ? u[rung.row + w] : 0.0f;
    h0[r] = 0.5f * segment_sum(kin0, tpw) + scale * u0[r];
  }

  for (int s = 0; s < num_steps; ++s) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) qv[r][e] += pv[r][e] * dtim[e];
    grad_walkers<R>(form, qv, gv, lane, tpw, num_dims, smem, buf, row_step);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[r][e] -= ck * gv[r][e];
  }
  float u1[R];
  if (num_steps > 0) {
    value_walkers<R>(form, qv, gv, lane, tpw, num_dims, smem, buf, row_step,
                     u1);
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) u1[r] = u0[r];
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long w = first + r;
    float kin1 = 0.0f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      pv[r][e] += (0.5f * ck) * gv[r][e];
      kin1 += pv[r][e] * pv[r][e] * imv[e];
    }
    const float h1 = 0.5f * segment_sum(kin1, tpw) + scale * u1[r];
    const Decision dec =
        metropolis(h0[r], h1, beta, threshold,
                   logf(pbbi::accept_uniform(t, w0 + (uint32_t)w, k0, k1)));
    if (w >= num_walkers) continue;
    const long long at = (rung.row + w) * num_dims + base;
    if (kProp) {  // the endpoint (q1, -p1), whatever the decision
      const float flipped[4] = {-pv[r][0], -pv[r][1], -pv[r][2], -pv[r][3]};
      store_group<kVec>(q_prop, at, left[r], qv[r]);
      store_group<kVec>(p_prop, at, left[r], flipped);
    }
    if (!dec.accepted) {  // back to the start, read once more
      load_group<kVec>(q, at, left[r], qv[r]);
      load_group<kVec>(g, at, left[r], gv[r]);
    }
    store_group<kVec>(q_out, at, left[r], qv[r]);
    store_group<kVec>(g_out, at, left[r], gv[r]);
    if (lane == 0) {
      u_out[rung.row + w] = dec.accepted ? u1[r] : u0[r];
      acc_out[rung.row + w] = dec.accept_prob;
      taken_out[rung.row + w] = dec.accepted ? 1 : 0;
      derr_out[rung.row + w] = dec.energy_error;
    }
  }
}

template <class Form, int R>
auto pick_variant(bool vec, bool dyn, bool prop) {
  using Kernel = decltype(&generic_kernel<Form, R, true, false, false>);
  static const Kernel table[8] = {
      &generic_kernel<Form, R, false, false, false>,
      &generic_kernel<Form, R, false, false, true>,
      &generic_kernel<Form, R, false, true, false>,
      &generic_kernel<Form, R, false, true, true>,
      &generic_kernel<Form, R, true, false, false>,
      &generic_kernel<Form, R, true, false, true>,
      &generic_kernel<Form, R, true, true, false>,
      &generic_kernel<Form, R, true, true, true>};
  return table[4 * vec + 2 * dyn + prop];
}

template <class Form>
int launch_generic(Form form, const float* q, const float* u, const float* g,
                   const float* inv_mass, const float* p_std,
                   const float* scalars, float* q_out, float* u_out,
                   float* g_out, float* acc_out, uint8_t* taken_out,
                   float* derr_out, float* q_prop, float* p_prop,
                   const int* steps_dev, int num_walkers, int num_dims,
                   int num_steps, int walker_tile, float threshold,
                   int num_rungs, const RungKeys& keys, uint32_t counter,
                   uint32_t walker_offset, void* stream) {
  if (num_walkers <= 0 || num_dims <= 0 || num_dims > kMaxGenericDims ||
      num_steps < 0 || (q_prop == nullptr) != (p_prop == nullptr))
    return (int)cudaErrorInvalidValue;
  const int tpw = threads_per_walker(num_dims);
  // q_prop and p_prop may be null (no proposal outputs): null is aligned
  const bool vec = num_dims % 4 == 0 && !misaligned16(q) &&
                   !misaligned16(g) && !misaligned16(q_out) &&
                   !misaligned16(g_out) && !misaligned16(q_prop) &&
                   !misaligned16(p_prop);
  const bool dyn = steps_dev != nullptr, prop = q_prop != nullptr;
  return with_tile<Form>(walker_tile, [&](auto tile) {
    constexpr int R = decltype(tile)::value;
    // the fixed count without proposals is run_hmc's kernel; the others
    // are ChEES's: the count from device memory, with the proposal
    // (warmup) or without (sampling)
    const auto kernel =
        pick_variant<Form, R>(vec, dyn, prop);
    const size_t smem = shared_bytes(form, num_dims, tpw, R);
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int wpb = kBlock / tpw * R;
    const dim3 grid((unsigned)((num_walkers + wpb - 1) / wpb), num_rungs);
    kernel<<<grid, kBlock, smem, (cudaStream_t)stream>>>(
        form, q, u, g, inv_mass, p_std, scalars, q_out, u_out, g_out, acc_out,
        taken_out, derr_out, q_prop, p_prop, steps_dev, num_walkers, num_dims,
        tpw, num_steps, threshold, keys, counter, walker_offset);
    return (int)cudaGetLastError();
  });
}

}  // namespace

extern "C" {

const char* pbbi_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Kernel A. steps_dev: null, or a device int holding the leapfrog count,
// and num_steps is then the most it may be. trajectory_bf16: nonzero runs
// the drift/kick chain in bfloat16 (D <= 128; above, cudaErrorInvalidValue
// and no launch). num_rungs, seeds: the launch's rungs (transition.cuh),
// 1 to kMaxRungs, and their 64-bit Philox keys; q is [num_rungs, W, D],
// scalars [num_rungs, 3], p_std [num_rungs, D]. walker_offset: the global
// index of row 0 of each rung, the walker index of its Philox draws (0 for
// a whole ensemble; a process holding rows [o, o + W) of a sharded one
// passes o and draws what the whole launch draws for those rows).
int pbbi_fused_hmc_diag_quadratic(
    const float* q, const float* kdiag, const float* mean,
    const float* inv_mass, const float* p_std, const float* scalars,
    float* q_out, float* g_out, float* u_out, float* acc_out,
    uint8_t* taken_out, float* derr_out, const int* steps_dev,
    int trajectory_bf16, int num_walkers, int num_dims, int num_steps,
    float threshold, int num_rungs, const uint64_t* seeds, uint32_t counter,
    uint32_t walker_offset, void* stream) {
  RungKeys keys;
  if (num_walkers <= 0 || num_dims <= 0 || num_steps < 0 ||
      !rung_keys(num_rungs, seeds, &keys))
    return (int)cudaErrorInvalidValue;
  const int tpw = threads_per_walker(num_dims);
  const bool looped = (num_dims + 3) / 4 > tpw;  // D > kMaxGenericDims
  if (looped && trajectory_bf16) return (int)cudaErrorInvalidValue;
  const int wpb = (looped ? kBlock : kBlockA) / tpw;
  const dim3 grid((unsigned)((num_walkers + wpb - 1) / wpb), num_rungs);
  const bool vec = num_dims % 4 == 0 && !misaligned16(q) &&
                   !misaligned16(q_out) && !misaligned16(g_out);
  using Kernel = decltype(&diag_quadratic_loop_kernel<false>);
  const bool dyn = steps_dev != nullptr;
  // [bf16][vec][dyn]
  static const Kernel grouped[2][2][2] = {
      {{&diag_quadratic_kernel<false, false, false>,
        &diag_quadratic_kernel<false, true, false>},
       {&diag_quadratic_kernel<true, false, false>,
        &diag_quadratic_kernel<true, true, false>}},
      {{&diag_quadratic_kernel<false, false, true>,
        &diag_quadratic_kernel<false, true, true>},
       {&diag_quadratic_kernel<true, false, true>,
        &diag_quadratic_kernel<true, true, true>}}};
  const Kernel kernel =
      looped ? (dyn ? &diag_quadratic_loop_kernel<true>
                    : &diag_quadratic_loop_kernel<false>)
             : grouped[trajectory_bf16 != 0][vec][dyn];
  kernel<<<grid, looped ? kBlock : kBlockA, 0, (cudaStream_t)stream>>>(
      q, kdiag, mean, inv_mass, p_std, scalars, q_out, g_out, u_out, acc_out,
      taken_out, derr_out, steps_dev, num_walkers, num_dims, tpw, num_steps,
      threshold, keys, counter, walker_offset);
  return (int)cudaGetLastError();
}

// Kernel B for the device form `form` (forms.cuh with_form; ops/kernels.py
// FORM_IDS). walker_tile: walkers a lane group owns, 1, 2 or 4 for the
// Gaussian, logistic and linear forms (ops/kernels.py walker_tile,
// logistic_tile), 1 for any other. q_prop and
// p_prop: both null, or where to write every walker's endpoint (q1, -p1).
// steps_dev: null, or a device int holding the leapfrog count, and
// num_steps is then the most it may be. num_rungs, seeds and walker_offset:
// as kernel A's; q, g and the outputs are [num_rungs, W, D], u [num_rungs,
// W].
int pbbi_fused_hmc_transition(
    int form, const float* param0, const float* param1, const float* param2,
    int count, const float* q, const float* u, const float* g,
    const float* inv_mass, const float* p_std, const float* scalars,
    float* q_out, float* u_out, float* g_out, float* acc_out,
    uint8_t* taken_out, float* derr_out, float* q_prop, float* p_prop,
    const int* steps_dev, int num_walkers, int num_dims, int num_steps,
    int walker_tile, float threshold, int num_rungs, const uint64_t* seeds,
    uint32_t counter, uint32_t walker_offset, void* stream) {
  RungKeys keys;
  if (!rung_keys(num_rungs, seeds, &keys)) return (int)cudaErrorInvalidValue;
  return with_form(
      form, param0, param1, param2, count, num_dims, [&](auto f) {
        return launch_generic(f, q, u, g, inv_mass, p_std, scalars, q_out,
                              u_out, g_out, acc_out, taken_out, derr_out,
                              q_prop, p_prop, steps_dev, num_walkers, num_dims,
                              num_steps, walker_tile, threshold, num_rungs,
                              keys, counter, walker_offset, stream);
      });
}

}  // extern "C"
