// What the two candidate-selection kernels share (select_words.cu, the
// word level; select_positions.cu, the position level): the threads per
// block, the per-position cost delta and the overshoot cost in float32.
//
// Both kernels run in two passes over the same walk: the first counts the
// candidates (per block, or per thread), the second (after a prefix sum of
// the counts in PyTorch and one host read of the total) writes them at
// their offsets, so the output order is the threads' order and no atomics
// are needed.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kSelThreads = 256;

// floor(float32(alpha) * float32(max(over, 0))), as int64: the reference's
// overshoot cost (semantics.py; minima.overshoot_floor). The product is
// rounded to float32 before the floor (__fmul_rn: no contraction); a
// float64 product gives other costs.
__device__ __forceinline__ int64_t overshoot_floor(float alpha, int64_t over) {
  if (over <= 0) return 0;
  return static_cast<int64_t>(floorf(__fmul_rn(alpha, static_cast<float>(over))));
}

// Bit b of vp minus bit b of vm: the cost delta of one position.
__device__ __forceinline__ int bit_delta(uint32_t vp, uint32_t vm, int b) {
  return static_cast<int>((vp >> b) & 1u) - static_cast<int>((vm >> b) & 1u);
}

}  // namespace
