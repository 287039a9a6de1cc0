// The pieces of a fused HMC transition that every layout of kernels A and B
// shares (fused_hmc.cu, thread_layout.cu): the leapfrog count read from
// device memory and the Metropolis decision.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

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
