// What the two candidate-selection kernels share (select_words.cu, the
// word level; select_positions.cu, the position level): the threads per
// block, the per-position cost delta and the overshoot cost in float32.
//
// The helpers are __host__ __device__, with host twins of the CUDA
// intrinsics they use (__popc, __clz, __fmul_rn), so that the position
// level's walk (select_walk.cuh) also builds with a host compiler and can
// be tested without a card (built with -ffp-contract=off: the float32
// product must not be fused).

#pragma once

#include <cmath>
#include <cstdint>

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#define SASSY_HD __host__ __device__ __forceinline__
#else
#define SASSY_HD inline
#endif

namespace {

constexpr int kSelThreads = 256;

// __popc, and its host twin.
SASSY_HD int popc32(uint32_t x) {
#if defined(__CUDA_ARCH__)
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

// __clz (32 for 0), and its host twin.
SASSY_HD int clz32(uint32_t x) {
#if defined(__CUDA_ARCH__)
  return __clz(x);
#else
  return x == 0 ? 32 : __builtin_clz(x);
#endif
}

// __fmul_rn (a float32 product rounded to nearest, never fused), and its
// host twin.
SASSY_HD float fmul_rn(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

// floor(float32(alpha) * float32(max(over, 0))), as int64: the reference's
// overshoot cost (semantics.py; minima.overshoot_floor). The product is
// rounded to float32 before the floor (no contraction); a float64 product
// gives other costs.
SASSY_HD int64_t overshoot_floor(float alpha, int64_t over) {
  if (over <= 0) return 0;
  return static_cast<int64_t>(floorf(fmul_rn(alpha, static_cast<float>(over))));
}

// Bit b of vp minus bit b of vm: the cost delta of one position.
SASSY_HD int bit_delta(uint32_t vp, uint32_t vm, int b) {
  return static_cast<int>((vp >> b) & 1u) - static_cast<int>((vm >> b) & 1u);
}

}  // namespace
