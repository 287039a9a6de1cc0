// The pieces of a fused HMC transition that every layout of kernels A and B
// shares (fused_hmc.cu, thread_layout.cu): the rung axis, the leapfrog
// count read from device memory and the Metropolis decision.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// The rung axis. A launch sweeps R = gridDim.y independent ensembles of
// num_walkers rows each (a parallel-tempering ladder's rungs), stored one
// after another: q, g and the [W, D] outputs as [R, W, D], u and the [W]
// outputs as [R, W]. Rung r (blockIdx.y) has its own Philox key key[r], its
// scalars (step size, beta, potential scale) at scalars + 3 r and its
// thermal momentum std at p_std + D r; the form's parameters and inv_mass
// are shared. The walker word of its draws is the walker's index within
// its rung (plus the launch's walker offset), so rung r's rows are the bits
// of a launch of rung r alone: that launch is the case R = 1. The keys
// travel by value in the launch's parameters, so a launch reads no key from
// device memory and its caller copies none there; a longer ladder is
// launched in blocks of at most kMaxRungs rungs.
constexpr int kMaxRungs = 16;

struct RungKeys {
  uint64_t key[kMaxRungs];
};

// This block's rung: its index, its first row in the [R, W] arrays and the
// two words of its Philox key. The kernels index the arrays by rung.row +
// w and keep their pointers as given.
struct Rung {
  long long index, row;
  uint32_t k0, k1;
};

// The kernels take the keys as `const __grid_constant__ RungKeys`: indexed
// by blockIdx.y, a plain by-value array was copied to every thread's stack
// (128 bytes a thread, kernel A 26-28% slower at the bench shape on an
// H100, PERF.md), and so it was when picked by selects over constant
// indices; a grid constant is read where the launch put it.
__device__ __forceinline__ Rung this_rung(const RungKeys& keys,
                                          int num_walkers) {
  const uint64_t key = keys.key[blockIdx.y];
  return Rung{(long long)blockIdx.y, (long long)blockIdx.y * num_walkers,
              (uint32_t)key, (uint32_t)(key >> 32)};
}

// The host side: the keys of rungs [0, num_rungs) from `seeds`, or false
// where the count is out of [1, kMaxRungs].
inline bool rung_keys(int num_rungs, const uint64_t* seeds, RungKeys* keys) {
  if (num_rungs < 1 || num_rungs > kMaxRungs || seeds == nullptr)
    return false;
  for (int r = 0; r < kMaxRungs; ++r)
    keys->key[r] = r < num_rungs ? seeds[r] : 0;
  return true;
}

struct Decision {
  float energy_error;
  float accept_prob;
  bool accepted;
};

// The leapfrog count of a launch that takes it from device memory: the
// value the caller's adaptation left there, clipped to [1, max_steps]; the
// same for every thread of the grid, so the trajectory loops stay uniform.
__device__ __forceinline__ int device_steps(const int* __restrict__ steps_dev,
                                            int max_steps) {
  return min(max(steps_dev[0], 1), max_steps);
}

// log_u: the log of the walker's Metropolis uniform.
__device__ __forceinline__ Decision metropolis(float h0, float h1, float beta,
                                               float threshold, float log_u) {
  float derr = beta * (h1 - h0);
  if (!isfinite(derr)) derr = INFINITY;  // -inf and NaN included
  const bool divergent = derr > threshold;
  Decision d;
  d.energy_error = derr;
  d.accepted = (log_u < -derr) && !divergent;
  d.accept_prob = divergent ? 0.0f : expf(fminf(0.0f, -derr));
  return d;
}

}  // namespace
