// prior_windows: the full-resolution march windows of the renderer's two
// priors, one launch a call.
//
// Replaces the window build of the JAX package's `render_depth_normal`
// (gradient_sdf_tpu/ops/raycast.py:803-820 and :857-880, with
// `_neighborhood_minmax` :714-733), which XLA fuses; in the port's plain
// version (ops/kernels/prior_windows.py) it is ~40 small launches. Two
// modes:
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
// Stride mode, `stride_windows`: a CTA of 256 threads owns a rectangle of
// 32 x 8 coarse cells (128 x 32 pixels at stride 4; 75 CTAs at VGA, one
// wave). (1) It stages the rectangle and its one-cell halo of s_mid and
// found in shared memory, both loads of a cell in flight together, a cell
// past the image border stored as "no entry" (min candidate +inf, max
// candidate -inf, not found). (2) One thread a cell forms its 3x3 min, max
// and any-hit and its final [lo, hi] once, into shared memory. (3) The CTA
// writes its pixels row by row, a group of lanes a row, as 16-byte rows of
// four windows (a scalar head and tail where a row does not start or end on
// a 16-byte boundary); where stride % 4 == 0 the four share one cell. The
// cell of a pixel row or column comes from the CTA's coordinates through
// a multiply-high by a precomputed magic number (`Div`), no runtime
// division a pixel.
// Depth mode, `depth_windows`: a thread four pixels, 16-byte loads of the
// prior and inv_hnorm (scalar loads where a pointer is not 16-byte
// aligned), 16-byte stores, a scalar tail when H W % 4 != 0; 300 CTAs of
// 256 at VGA, one wave.
//
// The arithmetic is the plain version's float32 operations (built with
// -fmad=false, IEEE division); min and max are exact, so the windows equal
// the plain version's bit for bit.
//
// What bounds it on an H100: bytes, 8 B of windows written a pixel (2.46 MB
// at VGA) plus the inputs: 5 B a coarse cell (stride mode) or 8 B a pixel
// (depth mode). ~0.0008 and ~0.0015 ms at 3.35 TB/s; at VGA the launch
// itself (~0.002-0.003 ms) is larger.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "window_rows.cuh"

namespace {

using gsdf_windows::Div;
using gsdf_windows::div_by;
using gsdf_windows::make_div;
using gsdf_windows::row_lanes;
using gsdf_windows::store_row;

constexpr int kThreads = 256;
constexpr int kCellsX = 32, kCellsY = 8;    // a CTA's coarse cells; one thread a cell
constexpr int kHaloX = kCellsX + 2, kHaloY = kCellsY + 2;
static_assert(kCellsX * kCellsY == kThreads, "one thread a cell");

struct Prior {
  int width, n;                 // n = width * height
  int stride, hc, wc;           // stride mode
  Div by_stride;
  float margin, s_min, s_max, miss_lo, miss_hi;
};

__device__ __forceinline__ float2 window(bool ok, float mn, float mx,
                                         const Prior& p) {
  const float l = ok ? fmaxf(mn - p.margin, p.s_min) : p.miss_lo;
  const float h = ok ? fminf(mx + p.margin, p.s_max) : p.miss_hi;
  return make_float2(fmaxf(l, p.s_min), fminf(h, p.s_max));
}

__global__ void __launch_bounds__(kThreads)
stride_windows(const float* __restrict__ val, const uint8_t* __restrict__ found,
               Prior p, float* __restrict__ lo, float* __restrict__ hi) {
  __shared__ float s_mn[kHaloY][kHaloX];    // found ? s_mid : +inf
  __shared__ float s_mx[kHaloY][kHaloX];    // found ? s_mid : -inf
  __shared__ uint8_t s_ok[kHaloY][kHaloX];
  __shared__ float2 cell[kCellsY][kCellsX]; // the finished [lo, hi]
  const int tid = threadIdx.x;
  const int cx0 = blockIdx.x * kCellsX, cy0 = blockIdx.y * kCellsY;
  // 1. stage the rectangle and its halo
  for (int k = tid; k < kHaloY * kHaloX; k += kThreads) {
    const int hy = k / kHaloX, hx = k - hy * kHaloX;
    const int y = cy0 + hy - 1, x = cx0 + hx - 1;
    const bool in = y >= 0 && y < p.hc && x >= 0 && x < p.wc;
    const int i = in ? y * p.wc + x : 0;
    const float v = val[i];
    const uint8_t fb = found[i];
    const bool f = in && fb;
    s_mn[hy][hx] = f ? v : INFINITY;
    s_mx[hy][hx] = f ? v : -INFINITY;
    s_ok[hy][hx] = f;
  }
  __syncthreads();
  // 2. the cell pass: a thread a cell
  {
    const int cy = tid / kCellsX, cx = tid - cy * kCellsX;
    float mn = INFINITY, mx = -INFINITY;
    bool ok = false;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        mn = fminf(mn, s_mn[cy + dy][cx + dx]);
        mx = fmaxf(mx, s_mx[cy + dy][cx + dx]);
        ok |= s_ok[cy + dy][cx + dx] != 0;
      }
    cell[cy][cx] = window(ok, mn, mx, p);
  }
  __syncthreads();
  // 3. the stores: a group of lanes a pixel row
  const int ncx = min(kCellsX, p.wc - cx0), ncy = min(kCellsY, p.hc - cy0);
  const int len = ncx * p.stride, rows = ncy * p.stride;
  const int x0 = cx0 * p.stride, y0 = cy0 * p.stride;
  const int nl = row_lanes(len);
  const int lane = tid & (nl - 1);
  const bool quad = (p.stride & 3) == 0;
  for (int r = tid / nl; r < rows; r += kThreads / nl) {
    const float2* crow = cell[div_by(r, p.by_stride)];
    const int g0 = (y0 + r) * p.width + x0;
    store_row(lo, hi, g0, len, lane, nl, quad && (g0 & 3) == 0,
              [&](int j) { return crow[div_by(j, p.by_stride)]; });
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
depth_windows(const float* __restrict__ prior,
              const float* __restrict__ inv_hnorm, Prior p,
              float* __restrict__ lo, float* __restrict__ hi) {
  const int j = 4 * (blockIdx.x * kThreads + threadIdx.x);
  if (j >= p.n) return;
  if (kVec && j + 4 <= p.n) {
    const float4 a = *reinterpret_cast<const float4*>(prior + j);
    const float4 b = *reinterpret_cast<const float4*>(inv_hnorm + j);
    const float sp[4] = {a.x / b.x, a.y / b.y, a.z / b.z, a.w / b.w};
    const float pr[4] = {a.x, a.y, a.z, a.w};
    float2 w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = window(pr[k] > 0.f, sp[k], sp[k], p);
    *reinterpret_cast<float4*>(lo + j) = make_float4(w[0].x, w[1].x, w[2].x, w[3].x);
    *reinterpret_cast<float4*>(hi + j) = make_float4(w[0].y, w[1].y, w[2].y, w[3].y);
    return;
  }
  for (int k = j; k < min(j + 4, p.n); ++k) {
    const float pr = prior[k];
    const float sp = pr / inv_hnorm[k];
    const float2 w = window(pr > 0.f, sp, sp, p);
    lo[k] = w.x;
    hi[k] = w.y;
  }
}

__global__ void empty_kernel() {}

dim3 stride_grid(int hc, int wc) {
  return dim3((wc + kCellsX - 1) / kCellsX, (hc + kCellsY - 1) / kCellsY);
}

int depth_grid(int n) {
  return ((n + 3) / 4 + kThreads - 1) / kThreads;
}

bool aligned16(const void* a) {
  return (reinterpret_cast<uintptr_t>(a) & 15) == 0;
}

}  // namespace

// gsdf_prior_windows_f32: one launch on `stream`, no synchronization;
// returns cudaGetLastError() (0 = success).
//
// depth = 0 (stride mode): val f32 [hc * wc] (the coarse bracket
// midpoints), found u8 [hc * wc], inv_hnorm unused; height = hc stride and
// width = wc stride. depth = 1: val f32 [height * width] (camera-z prior,
// 0 for a hole), inv_hnorm f32 [height * width], found unused. lo, hi f32
// [height * width], 16-byte aligned.
extern "C" int gsdf_prior_windows_f32(
    int depth, const void* val, const void* found, const void* inv_hnorm,
    int width, int height, int stride, float margin, float s_min,
    float s_max, float miss_lo, float miss_hi, void* lo, void* hi,
    void* stream) {
  if (width <= 0 || height <= 0 ||
      static_cast<long long>(width) * height >= INT32_MAX ||
      !aligned16(lo) || !aligned16(hi) ||
      (!depth && (stride <= 0 || width % stride || height % stride)))
    return cudaErrorInvalidValue;
  const int n = width * height;
  const int st = depth ? 1 : stride;
  Prior p = {width, n, st, height / st, width / st, make_div(st),
             margin, s_min, s_max, miss_lo, miss_hi};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(val);
  float* l = static_cast<float*>(lo);
  float* h = static_cast<float*>(hi);
  if (!depth) {
    stride_windows<<<stride_grid(p.hc, p.wc), kThreads, 0, s>>>(
        v, static_cast<const uint8_t*>(found), p, l, h);
  } else {
    const float* ih = static_cast<const float*>(inv_hnorm);
    if (aligned16(v) && aligned16(ih))
      depth_windows<true><<<depth_grid(n), kThreads, 0, s>>>(v, ih, p, l, h);
    else
      depth_windows<false><<<depth_grid(n), kThreads, 0, s>>>(v, ih, p, l, h);
  }
  return static_cast<int>(cudaGetLastError());
}

// gsdf_prior_windows_empty: an empty kernel at the launch of a call with
// these arguments (the launch floor).
extern "C" int gsdf_prior_windows_empty(int depth, int width, int height,
                                        int stride, void* stream) {
  if (width <= 0 || height <= 0 || (!depth && stride <= 0))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (depth)
    empty_kernel<<<depth_grid(width * height), kThreads, 0, s>>>();
  else
    empty_kernel<<<stride_grid(height / stride, width / stride), kThreads, 0,
                   s>>>();
  return static_cast<int>(cudaGetLastError());
}
