// window_rows.cuh: what the renderer's two window kernels
// (render_windows.cu, prior_windows.cu) share: an exact division by a
// launch-wide divisor through a multiply-high, and the store of a row of
// windows as 16-byte rows of four.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace gsdf_windows {

// n / d for 0 <= n < 2^31 by a multiply-high (PyTorch's IntDivider:
// Granlund and Montgomery's round-up method, exact for 1 <= d < 2^31)
struct Div {
  unsigned m, s;
};

inline Div make_div(int d) {
  unsigned s = 0;
  while ((1u << s) < static_cast<unsigned>(d)) ++s;
  const uint64_t one = 1;
  return {static_cast<unsigned>(((one << 32) * ((one << s) - d)) / d + 1), s};
}

__device__ __forceinline__ int div_by(int n, Div v) {
  return static_cast<int>((__umulhi(static_cast<unsigned>(n), v.m) + n) >> v.s);
}

// Writes the `len` windows at lo/hi + g0 .. g0 + len - 1, element j taking
// val(j) (a float2 of lo, hi), with `nl` lanes (`lane` of them): a scalar
// head up to the first 16-byte boundary, 16-byte rows of four, a scalar
// tail. `quad`: every four elements of a row of four share one value.
template <class F>
__device__ __forceinline__ void store_row(float* __restrict__ lo,
                                          float* __restrict__ hi, int g0,
                                          int len, int lane, int nl, bool quad,
                                          F val) {
  const int head = min(len, (4 - (g0 & 3)) & 3);
  const int nq = (len - head) >> 2;
  for (int j = lane; j < head; j += nl) {
    const float2 w = val(j);
    lo[g0 + j] = w.x;
    hi[g0 + j] = w.y;
  }
  for (int q = lane; q < nq; q += nl) {
    const int j = head + 4 * q;
    float4 l, h;
    if (quad) {
      const float2 w = val(j);
      l = make_float4(w.x, w.x, w.x, w.x);
      h = make_float4(w.y, w.y, w.y, w.y);
    } else {
      const float2 w0 = val(j), w1 = val(j + 1), w2 = val(j + 2), w3 = val(j + 3);
      l = make_float4(w0.x, w1.x, w2.x, w3.x);
      h = make_float4(w0.y, w1.y, w2.y, w3.y);
    }
    *reinterpret_cast<float4*>(lo + g0 + j) = l;
    *reinterpret_cast<float4*>(hi + g0 + j) = h;
  }
  for (int j = head + 4 * nq + lane; j < len; j += nl) {
    const float2 w = val(j);
    lo[g0 + j] = w.x;
    hi[g0 + j] = w.y;
  }
}

// the smallest power of two >= (len + 3) / 4, at most 32: the lanes that
// write one row
__device__ __forceinline__ int row_lanes(int len) {
  const int q = max((len + 3) >> 2, 1);
  return min(32, 1 << (32 - __clz(q - 1)));
}

}  // namespace gsdf_windows
