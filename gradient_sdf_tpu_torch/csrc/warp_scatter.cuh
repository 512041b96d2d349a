// Warp-aggregated row reductions of the scatter kernel (scatter_add.cu);
// fusion's integrate pass (fuse_integrate.cu) sends its rows with the same
// vector reductions (reduce_row).
//
// The lanes of a warp that hold the same destination (__match_any_sync) sum
// their fields by shuffles into the group's lowest lane, taking the peers'
// values one by one in ascending lane order, so the sum inside a warp is
// the same in every run. The leader alone sends the reduction: a row that
// starts on a 32-byte boundary goes out as ONE red.global.add.v4.f32 plus
// one scalar or v2 reduction, any other row as F scalar ones. See
// scatter_add.cu for what this cuts (the L2's same-address reductions).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace gsdf {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ void red_add_v4(float* a, float x, float y, float z,
                                           float w) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};"
               :: "l"(a), "f"(x), "f"(y), "f"(z), "f"(w) : "memory");
}

__device__ __forceinline__ void red_add_v2(float* a, float x, float y) {
  asm volatile("red.global.add.v2.f32 [%0], {%1, %2};"
               :: "l"(a), "f"(x), "f"(y) : "memory");
}

// One row's reduction. VEC: the row starts on a 32-byte boundary.
template <int F, bool VEC>
__device__ __forceinline__ void reduce_row(float* o, const float (&x)[F]) {
  if constexpr (!VEC || F == 1) {
#pragma unroll
    for (int f = 0; f < F; ++f) atomicAdd(o + f, x[f]);
  } else if constexpr (F == 2) {
    red_add_v2(o, x[0], x[1]);
  } else if constexpr (F == 3) {
    red_add_v2(o, x[0], x[1]);
    atomicAdd(o + 2, x[2]);
  } else {
    red_add_v4(o, x[0], x[1], x[2], x[3]);
    if constexpr (F == 5) atomicAdd(o + 4, x[4]);
  }
}

// Called by all 32 lanes of a warp. `i` is the lane's destination row, -1
// for a lane with nothing to add (dropped lanes form a group too, which has
// nothing to sum). Returns true in the lane that leads its group and has a
// destination; that lane's `x` then holds the group's sum.
template <int F>
__device__ __forceinline__ bool warp_aggregate(int32_t i, float (&x)[F]) {
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(kFullMask, i);
  const int leader = __ffs(peers) - 1;
  unsigned rest = (lane == leader && i >= 0) ? peers & (peers - 1) : 0u;
  while (__any_sync(kFullMask, rest != 0u)) {
    const int src = rest ? __ffs(rest) - 1 : lane;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const float y = __shfl_sync(kFullMask, x[f], src);
      if (rest) x[f] += y;
    }
    rest &= rest - 1;
  }
  return lane == leader && i >= 0;
}

}  // namespace gsdf
