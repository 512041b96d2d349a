// prior_windows: the full-resolution march windows of the renderer's two
// priors, in one launch, one thread a pixel.
//
// Replaces the window build of the JAX package's `render_depth_normal`
// (gradient_sdf_tpu/ops/raycast.py:803-820 and :857-880, with
// `_neighborhood_minmax` :714-733), which XLA fuses; in the port's plain
// version (ops/kernels/prior_windows.py) it is ~40 small launches. Two
// modes of one kernel:
//   stride (the stride prior): the coarse march's bracket midpoints
//     `s_mid` and hit mask `found`, [hc, wc]. Pixel (y, x) takes coarse
//     cell (y / stride, x / stride) and forms the min, the max and the
//     any-hit of the hits among the cell's 3x3 neighbours, cells past the
//     border counting as "no entry" (a wrap would import windows from the
//     opposite border);
//   depth (a depth prior, the incremental mode): the previous render's
//     camera-z depth over inv_hnorm is the ray parameter sp, ok = prior > 0.
// Either way lo = ok ? max(mn - margin, s_min) : miss_lo and
// hi = ok ? min(mx + margin, s_max) : miss_hi, where (miss_lo, miss_hi) is
// (s_max, s_min - 1), an empty window, when misses are skipped and (s_min,
// s_max) otherwise; then `raycast`'s clamps to [s_min, s_max]. The result
// is written at full resolution straight away, [H, W]: the repeat
// expansion of the plain version is the index arithmetic here.
//
// The arithmetic is the plain version's float32 operations (built with
// -fmad=false, IEEE division); min and max are exact, so the windows equal
// the plain version's bit for bit.
//
// What bounds it on an H100: bytes, 8 B of windows written a pixel (2.46 MB
// at VGA) plus the inputs: 5 B a coarse cell (stride mode; a pixel's nine
// reads come from L1) or 8 B a pixel (depth mode). ~0.0008 and ~0.0015 ms
// at 3.35 TB/s; at VGA the launch itself is of the same order.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Prior {
  int width, height, n;
  int stride, hc, wc;            // stride mode
  float margin, s_min, s_max, miss_lo, miss_hi;
};

template <bool kDepth>
__global__ void __launch_bounds__(kThreads)
prior_windows(const float* __restrict__ val, const uint8_t* __restrict__ found,
              const float* __restrict__ inv_hnorm, Prior p,
              float* __restrict__ lo, float* __restrict__ hi) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= p.n) return;
  bool ok;
  float mn, mx;
  if (kDepth) {
    const float prior = val[j];
    mn = mx = prior / inv_hnorm[j];
    ok = prior > 0.f;
  } else {
    const int y = j / p.width, x = j - y * p.width;
    const int cy = y / p.stride, cx = x / p.stride;
    mn = INFINITY;
    mx = -INFINITY;
    ok = false;
    for (int dy = -1; dy <= 1; ++dy) {
      const int ny = cy + dy;
      if (ny < 0 || ny >= p.hc) continue;
      for (int dx = -1; dx <= 1; ++dx) {
        const int nx = cx + dx;
        if (nx < 0 || nx >= p.wc || !found[ny * p.wc + nx]) continue;
        const float v = val[ny * p.wc + nx];
        mn = fminf(mn, v);
        mx = fmaxf(mx, v);
        ok = true;
      }
    }
  }
  float l = ok ? fmaxf(mn - p.margin, p.s_min) : p.miss_lo;
  float h = ok ? fminf(mx + p.margin, p.s_max) : p.miss_hi;
  lo[j] = fmaxf(l, p.s_min);
  hi[j] = fminf(h, p.s_max);
}

__global__ void empty_kernel() {}

}  // namespace

// gsdf_prior_windows_f32: one launch on `stream`, no synchronization;
// returns cudaGetLastError() (0 = success).
//
// depth = 0 (stride mode): val f32 [hc * wc] (the coarse bracket
// midpoints), found u8 [hc * wc], inv_hnorm unused; height = hc stride and
// width = wc stride. depth = 1: val f32 [height * width] (camera-z prior,
// 0 for a hole), inv_hnorm f32 [height * width], found unused. lo, hi f32
// [height * width].
extern "C" int gsdf_prior_windows_f32(
    int depth, const void* val, const void* found, const void* inv_hnorm,
    int width, int height, int stride, float margin, float s_min,
    float s_max, float miss_lo, float miss_hi, void* lo, void* hi,
    void* stream) {
  if (width <= 0 || height <= 0 ||
      static_cast<long long>(width) * height >= INT32_MAX ||
      (!depth && (stride <= 0 || width % stride || height % stride)))
    return cudaErrorInvalidValue;
  const int n = width * height;
  Prior p = {width, height, n, depth ? 1 : stride,
             depth ? height : height / stride, depth ? width : width / stride,
             margin, s_min, s_max, miss_lo, miss_hi};
  const dim3 grid((n + kThreads - 1) / kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(val);
  float* l = static_cast<float*>(lo);
  float* h = static_cast<float*>(hi);
  if (depth)
    prior_windows<true><<<grid, kThreads, 0, s>>>(
        v, nullptr, static_cast<const float*>(inv_hnorm), p, l, h);
  else
    prior_windows<false><<<grid, kThreads, 0, s>>>(
        v, static_cast<const uint8_t*>(found), nullptr, p, l, h);
  return static_cast<int>(cudaGetLastError());
}

// gsdf_prior_windows_empty: an empty kernel at the launch of n windows.
extern "C" int gsdf_prior_windows_empty(int n, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  empty_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
