// The Myers'99 step of one pattern row on a word of 32 text positions, the
// one step of the port's kernels: the scans' row step (myers_step.cuh) and
// the traceback's fill (trace.cuh). __host__ __device__, so that a host
// build of trace.cuh (tests/torch_trace_host.cc) runs the same step.

#pragma once

#include <cstdint>

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#define MYERS_HD __host__ __device__ __forceinline__
#else
#define MYERS_HD inline
#endif

namespace {

// The Myers step of one pattern row on 32 text positions (reference
// bitpacking.rs:63-85): hp_j/hm_j are the row's horizontal deltas entering
// the word, hp_o/hm_o its horizontal delta words (bit 31 leaves the word);
// vp/vm flow down the rows. With the text along the word, bit b of vp/vm
// after row j is D[j, b + 1] - D[j, b] (+1 / -1, along the row) and bit b
// of hp_o/hm_o is D[j, b + 1] - D[j - 1, b + 1] (down the column), column
// 0 the position before the word.
MYERS_HD void myers_step(uint32_t eq, uint32_t hp_j, uint32_t hm_j,
                         uint32_t& vp, uint32_t& vm, uint32_t& hp_o,
                         uint32_t& hm_o) {
  const uint32_t vx = eq | vm;
  const uint32_t eqh = eq | hm_j;
  const uint32_t hx = (((eqh & vp) + vp) ^ vp) | eqh;
  hp_o = vm | ~(hx | vp);
  hm_o = vp & hx;
  const uint32_t hp_sh = (hp_o << 1) | hp_j;
  const uint32_t hm_sh = (hm_o << 1) | hm_j;
  vp = hm_sh | ~(vx | hp_sh);
  vm = hp_sh & vx;
}

}  // namespace
