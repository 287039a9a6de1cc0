// Counter-based Philox4x32-10 (Salmon et al., SC'11; Random123's
// philox4x32_10) shared by the fused HMC kernels. ops/philox.py is the
// plain-torch version and draws the same bits.
//
// Counter layout: key = the run's 64-bit seed (k0 low word, k1 high word);
// counter = (transition index, walker, dim-group, draw site). A dim-group
// is four consecutive dimensions 4g..4g+3; site 0 is the momentum refresh,
// site 1 the Metropolis uniform. The walker word is the walker's global
// index: a launch on rows [o, o + W) of a sharded ensemble is given the
// offset o, and draws for those rows what a launch on the whole ensemble
// draws.
#pragma once

#include <cstdint>

namespace pbbi {

constexpr uint32_t kSiteMomentum = 0;
constexpr uint32_t kSiteAccept = 1;

struct Philox4 {
  uint32_t w0, w1, w2, w3;
};

__device__ __forceinline__ Philox4 philox4x32_10(uint32_t c0, uint32_t c1,
                                                 uint32_t c2, uint32_t c3,
                                                 uint32_t k0, uint32_t k1) {
  // An opaque copy of the key, so that each call derives its round keys
  // anew: with the key loaded at run time (a rung's, transition.cuh) the
  // compiler held the round keys in registers from one draw to the next.
  // Without this copy kernel B's mixture form took 94 registers a thread
  // (78 with it) and the eight-schools forms' thread layout spilled more
  // (PERF.md).
  asm("" : "+r"(k0), "+r"(k1));
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return Philox4{c0, c1, c2, c3};
}

// uint32 -> (0, 1]: top 24 bits / 2^24 + 2^-25 (the largest word rounds to
// exactly 1.0, as in the JAX kernels' conversion). The product is exact, and
// the explicit round-to-nearest intrinsics keep nvcc from contracting the
// pair, so the value is bit-identical to the torch version.
__device__ __forceinline__ float uniform_from_bits(uint32_t x) {
  return __fadd_rn(__fmul_rn(__uint2float_rn(x >> 8), 5.9604644775390625e-08f),
                   2.98023223876953125e-08f);
}

// Box-Muller with both branches: one log/sqrt serves two normals.
__device__ __forceinline__ void box_muller(uint32_t a, uint32_t b, float* n0,
                                           float* n1) {
  const float u1 = uniform_from_bits(a);
  const float u2 = uniform_from_bits(b);
  const float r = sqrtf(-2.0f * logf(u1));
  float s, c;
  sincosf(6.283185307179586f * u2, &s, &c);
  *n0 = r * c;
  *n1 = r * s;
}

// The four momentum normals of dims 4g..4g+3 of walker w at transition t.
__device__ __forceinline__ void momentum_normals4(uint32_t t, uint32_t w,
                                                  uint32_t g, uint32_t k0,
                                                  uint32_t k1, float n[4]) {
  const Philox4 x = philox4x32_10(t, w, g, kSiteMomentum, k0, k1);
  box_muller(x.w0, x.w1, &n[0], &n[1]);
  box_muller(x.w2, x.w3, &n[2], &n[3]);
}

// The Metropolis uniform of walker w at transition t.
__device__ __forceinline__ float accept_uniform(uint32_t t, uint32_t w,
                                                uint32_t k0, uint32_t k1) {
  return uniform_from_bits(philox4x32_10(t, w, 0, kSiteAccept, k0, k1).w0);
}

}  // namespace pbbi
