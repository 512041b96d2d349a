// render_windows: the renderer's exact march windows from the active blocks,
// rasterized to screen tiles, in one launch with nothing read on the host.
//
// Replaces `block_raster_windows` of the JAX package's renderer
// (gradient_sdf_tpu/ops/raycast.py:544-694), which XLA fuses; the port's
// plain version (`render_windows_reference` in
// ops/kernels/render_windows.py) is ~100 small launches: the [cap, 4, 4]
// index tensors, two scatter_reduce_ calls and the repeat_interleave
// expansion. Per block slot i < min(cap, num_active), `num_active` read on
// the device:
//   centre c = (b B + (B - 1) / 2) vs, q = R^T (c - t), s_c = |q|,
//   r = B vs sqrt(3) / 2, the block's ray-parameter range
//   [lo_b, hi_b] = [max(s_c - r, 0), s_c + r];
//   behind (q_z + r <= 0): nothing; near (q_z <= r, straddles the camera
//   plane): [lo_b, hi_b] goes into a global pair; otherwise the block is
//   projected, its conservative silhouette half-extents ru, rv (scaled by
//   s_c / q_z) give its tile span [tx0, tx1] x [ty0, ty1]; off-screen
//   blocks are dropped, wide ones (a span of >= max_span tiles) go into the
//   global pair, the rest min/max their range into every tile they cover.
// Tiles then take min(tile_lo, glob_lo), max(tile_hi, glob_hi); more active
// blocks than `cap` turn every window into [0, inf] (the escape: never a
// silent truncation). A pixel takes its tile's window; an empty tile keeps
// [inf, -inf], an empty window, which the march never probes.
//
// The design: the tile grid is cut into patches of PX x PY tiles, one CTA
// of 1024 threads a patch (faster than 512 at 1433 and 4096 blocks), the patch's lo/hi as int32 in shared memory.
// A patch starts at 4 x 2 tiles and doubles along its shorter side while
// the grid has more patches than the H100 has SMs (132) and the patch
// fewer than 4096 tiles (32 KB): VGA at 16 px is 80 patches of 4 x 4,
// 1920x1080 72 of 16 x 8, 3840x2160 72 of 32 x 16; so a grid fits at any
// image size and no CTA waits on another. Each CTA:
//   1. reads num_active, K, R, t and its first block slot together (a slot
//      below `cap` is read before the count says whether it is live);
//   2. projects every live block slot with the plain version's float32
//      operations, the next slot's load in flight;
//   3. min/maxes each block's range into the tiles where its tile span
//      meets the patch (atomicMin / atomicMax on the float's bits as int32:
//      every value is >= +0, lo_b clamped at 0 and hi_b = s_c + r > 0, so
//      the integer order is the float order, -inf's bits a negative int
//      below them all; exact and order-free, equal to the plain version's
//      scatter_reduce_ bit for bit), and reduces the near/wide global pair
//      itself, in registers and then by shuffles, one atomic pair a warp;
//      it applies the `active_cap` escape from its own read of num_active;
//   4. after one __syncthreads writes the windows of its patch's pixels
//      straight from shared memory: every pixel, or only the strided
//      pixels (offset + k stride) the stride prior's coarse march reads
//      (its output rows and columns found once a CTA), a group of lanes an
//      output row, as 16-byte rows of four (four adjacent pixels share a
//      tile when the tile is a multiple of 4 px) with a scalar head and
//      tail, optionally with `raycast`'s clamps to [s_min, s_max].
// The cost of this design is that every CTA projects every block (1433 x
// 80 at the render scene): ~1.1-1.8 us an iteration of the slot loop on
// an H100 (the exact projection and the atomics), most of the kernel's
// time at VGA. Tried and
// measured no faster at both 1433 and 4096 blocks (raycast_bench.py
// --windows): sharing the projection over a thread-block cluster of 8
// (atomics into the owner's patch through distributed shared memory; its
// barriers cost more than the split saved), a cheap cull before the exact
// projection (alone, a warp still runs the exact path when one lane needs
// it; with a per-warp queue of exact work, faster only at 4096 blocks),
// and a thread's slots loaded all at once.
//
// Arithmetic is the plain version's float32 operations in its order (the
// source builds with -fmad=false, IEEE division and square root), the
// division by the tile size a multiplication by its reciprocal as PyTorch
// does on the card for a division by a Python number; the tile of a pixel
// index is an exact integer division through a multiply-high (`Div`).
//
// What bounds it on an H100: bytes, and at these sizes latency. It reads
// 12 B a live block slot (17 KB at 1433 blocks) and writes 8 B a window
// (2.46 MB for every VGA pixel, 0.15 MB at stride 4): ~0.0007 ms and
// ~0.00005 ms at 3.35 TB/s. A launch is a few microseconds, one round trip
// for the reads, the projection (issue slots, growing with the active
// blocks) and the stores.

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

constexpr int kThreads = 1024;
constexpr int kTargetCtas = 132;      // the H100's SMs: one patch an SM
constexpr int kMaxPatchTiles = 4096;  // 32 KB of shared memory
constexpr int kInfBits = 0x7f800000;                        // +inf
constexpr int kNegInfBits = static_cast<int>(0xff800000u);  // -inf
struct Raster {
  const float* K;             // f32 [3, 3]
  const float* R;             // f32 [3, 3], camera-to-world
  const float* t;             // f32 [3]
  const int* block_coords;    // int32 [num_blocks, 3]
  const int* num_active;      // int32 [1]
  int cap;
  float bs;                   // block shape
  float half_span;            // 0.5 (B - 1)
  float vs;
  float r;                    // bounding radius
  float width, height;
  float inv_tile;
  int WT, HT, max_span;
  int PX, PY;                 // a patch, in tiles
  int W, H, tile, stride, offset, hs, ws;
  Div by_tile;
  int clamp;
  float s_min, s_max;
};

__device__ __forceinline__ int tile_of(float x, float inv_tile, int last) {
  // torch.clamp(torch.floor(x / tile), 0, last).to(int32)
  const float f = fminf(fmaxf(floorf(x * inv_tile), 0.f),
                        static_cast<float>(last));
  return static_cast<int>(f);
}

// the first k >= 0 with offset + k stride >= a, at most `count`
__device__ __forceinline__ int first_at(int a, int offset, int stride,
                                        int count) {
  return a <= offset ? 0 : min(count, (a - offset + stride - 1) / stride);
}

__global__ void __launch_bounds__(kThreads)
render_windows(Raster a, float* __restrict__ lo, float* __restrict__ hi) {
  extern __shared__ int smem[];   // the patch: lo [PY, PX], then hi
  __shared__ int glob[2];         // [lo, hi] of the near and wide blocks
  const int tid = threadIdx.x;
  const int np = a.PX * a.PY;
  int* lo_s = smem;
  int* hi_s = smem + np;
  const int px0 = blockIdx.x * a.PX, py0 = blockIdx.y * a.PY;
  const int px1 = min(px0 + a.PX, a.WT) - 1, py1 = min(py0 + a.PY, a.HT) - 1;
  // 1. the reads, all in flight together
  const int na = *a.num_active;
  const float fx = a.K[0], cx = a.K[2], fy = a.K[4], cy = a.K[5];
  const float R00 = a.R[0], R01 = a.R[1], R02 = a.R[2];
  const float R10 = a.R[3], R11 = a.R[4], R12 = a.R[5];
  const float R20 = a.R[6], R21 = a.R[7], R22 = a.R[8];
  const float tx = a.t[0], ty = a.t[1], tz = a.t[2];
  int i = tid;
  int b0 = 0, b1 = 0, b2 = 0;   // the slot's block coordinates
  if (i < a.cap) {
    b0 = a.block_coords[3 * i];
    b1 = a.block_coords[3 * i + 1];
    b2 = a.block_coords[3 * i + 2];
  }
  for (int k = tid; k < np; k += kThreads) {
    lo_s[k] = kInfBits;
    hi_s[k] = kNegInfBits;
  }
  if (tid == 0) {
    glob[0] = kInfBits;
    glob[1] = kNegInfBits;
  }
  __syncthreads();
  const bool over = na > a.cap;
  if (!over) {
    // 2. the projection
    const float fxr = fx * a.r, fyr = fy * a.r;
    const int n = min(na, a.cap);
    int g_lo = kInfBits, g_hi = kNegInfBits;   // this thread's global pair
    for (; i < n; i += kThreads) {
      const float dx = (static_cast<float>(b0) * a.bs + a.half_span) * a.vs - tx;
      const float dy = (static_cast<float>(b1) * a.bs + a.half_span) * a.vs - ty;
      const float dz = (static_cast<float>(b2) * a.bs + a.half_span) * a.vs - tz;
      if (i + kThreads < n) {   // the next slot's load in flight
        const int* b = a.block_coords + 3 * (i + kThreads);
        b0 = b[0];
        b1 = b[1];
        b2 = b[2];
      }
      const float qx = R00 * dx + R10 * dy + R20 * dz;
      const float qy = R01 * dx + R11 * dy + R21 * dz;
      const float qz = R02 * dx + R12 * dy + R22 * dz;
      const float s_c = sqrtf(qx * qx + qy * qy + qz * qz);
      const float lo_raw = s_c - a.r;
      const float lo_b = lo_raw < 0.f ? 0.f : lo_raw;
      const float hi_b = s_c + a.r;
      if (qz + a.r <= 0.f) continue;            // behind: no forward ray
      bool glob_block = qz <= a.r;              // near: straddles the plane
      if (!glob_block) {
        const float u = fx * qx / qz + cx;
        const float v = fy * qy / qz + cy;
        const float sil = s_c / qz;
        const float den = fmaxf(qz - a.r, 1e-6f);
        const float ru = fxr * sil / den;
        const float rv = fyr * sil / den;
        if (u + ru < 0.f || u - ru >= a.width || v + rv < 0.f ||
            v - rv >= a.height)
          continue;                             // off-screen
        const int tx0 = tile_of(u - ru, a.inv_tile, a.WT - 1);
        const int tx1 = tile_of(u + ru, a.inv_tile, a.WT - 1);
        const int ty0 = tile_of(v - rv, a.inv_tile, a.HT - 1);
        const int ty1 = tile_of(v + rv, a.inv_tile, a.HT - 1);
        glob_block = tx1 - tx0 >= a.max_span || ty1 - ty0 >= a.max_span;
        if (!glob_block) {
          // 3. the atomics, where the span meets the patch
          const int lo_bits = __float_as_int(lo_b), hi_bits = __float_as_int(hi_b);
          const int x0 = max(tx0, px0), x1 = min(tx1, px1);
          const int y1 = min(ty1, py1);
          for (int yy = max(ty0, py0); yy <= y1; ++yy)
            for (int xx = x0; xx <= x1; ++xx) {
              const int k = (yy - py0) * a.PX + (xx - px0);
              atomicMin(lo_s + k, lo_bits);
              atomicMax(hi_s + k, hi_bits);
            }
        }
      }
      if (glob_block) {                         // near or wide
        g_lo = min(g_lo, __float_as_int(lo_b));
        g_hi = max(g_hi, __float_as_int(hi_b));
      }
    }
    // the global pair: a warp's reduced by shuffles, one atomic pair a warp
    for (int m = 16; m > 0; m >>= 1) {
      g_lo = min(g_lo, __shfl_xor_sync(0xffffffffu, g_lo, m));
      g_hi = max(g_hi, __shfl_xor_sync(0xffffffffu, g_hi, m));
    }
    if ((tid & 31) == 0 && g_lo != kInfBits) atomicMin(glob, g_lo);
    if ((tid & 31) == 0 && g_hi != kNegInfBits) atomicMax(glob + 1, g_hi);
  }
  __syncthreads();
  // 4. the stores: the output rows and columns whose pixels lie in the patch
  const int ylo = py0 * a.tile, yhi = min((py1 + 1) * a.tile, a.H);
  const int xlo = px0 * a.tile, xhi = min((px1 + 1) * a.tile, a.W);
  const int r0 = first_at(ylo, a.offset, a.stride, a.hs);
  const int r1 = first_at(yhi, a.offset, a.stride, a.hs);
  const int c0 = first_at(xlo, a.offset, a.stride, a.ws);
  const int len = first_at(xhi, a.offset, a.stride, a.ws) - c0;
  if (len <= 0) return;
  const int glo = glob[0], ghi = glob[1];
  const int nl = row_lanes(len);
  const int lane = tid & (nl - 1);
  // four adjacent windows share a tile
  const bool quad = a.stride == 1 && (a.tile & 3) == 0 && (a.offset & 3) == 0;
  const int x_first = a.offset + c0 * a.stride;
  for (int r = r0 + tid / nl; r < r1; r += kThreads / nl) {
    const int row = (div_by(a.offset + r * a.stride, a.by_tile) - py0) * a.PX;
    const int g0 = r * a.ws + c0;
    store_row(lo, hi, g0, len, lane, nl, quad && (g0 & 3) == 0, [&](int j) {
      const int k = row + div_by(x_first + j * a.stride, a.by_tile) - px0;
      float l = over ? 0.f : __int_as_float(min(lo_s[k], glo));
      float h = over ? INFINITY : __int_as_float(max(hi_s[k], ghi));
      if (a.clamp) {   // raycast's torch.clamp(s_lo, min=s_min), (s_hi, max=s_max)
        l = fmaxf(l, a.s_min);
        h = fminf(h, a.s_max);
      }
      return make_float2(l, h);
    });
  }
}

__global__ void empty_kernel() {}

// The patch (PX, PY) of a WT x HT tile grid: 4 x 2 tiles, doubled along
// the shorter side (a side that covers the grid stays) while the grid has
// more than kTargetCtas patches and a patch fewer than kMaxPatchTiles.
void patch_shape(int WT, int HT, int* px, int* py) {
  long long x = 4, y = 2;
  auto count = [&] { return ((WT + x - 1) / x) * ((HT + y - 1) / y); };
  while (count() > kTargetCtas && x * y < kMaxPatchTiles) {
    const bool gx = x < WT, gy = y < HT;
    if (gx && (x <= y || !gy))
      x *= 2;
    else if (gy)
      y *= 2;
    else
      break;
  }
  *px = static_cast<int>(x);
  *py = static_cast<int>(y);
}

// A launch for a width x height image at `tile` px: the patch and the grid
// of patches.
struct Launch {
  int WT, HT, PX, PY;
  dim3 grid;
  Launch(int width, int height, int tile) {
    WT = (width + tile - 1) / tile;
    HT = (height + tile - 1) / tile;
    patch_shape(WT, HT, &PX, &PY);
    grid = dim3((WT + PX - 1) / PX, (HT + PY - 1) / PY);
  }
};

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

bool bad_image(int width, int height, int tile) {
  return width <= 0 || height <= 0 || tile <= 0 ||
         static_cast<long long>(width) + tile >= INT32_MAX ||
         static_cast<long long>(height) + tile >= INT32_MAX;
}

}  // namespace

// gsdf_render_windows_shape: the launch of a width x height image at
// `tile` px: out[0..3] = patch tiles PX, PY, CTAs, threads a CTA.
extern "C" int gsdf_render_windows_shape(int width, int height, int tile,
                                         int* out) {
  if (bad_image(width, height, tile)) return cudaErrorInvalidValue;
  const Launch l(width, height, tile);
  out[0] = l.PX;
  out[1] = l.PY;
  out[2] = static_cast<int>(l.grid.x * l.grid.y);
  out[3] = kThreads;
  return 0;
}

// gsdf_render_windows_f32: one launch on `stream`, no synchronization;
// returns cudaGetLastError() after it (0 = success).
//
// K, R f32 [3, 3] and t f32 [3] on the device; block_coords int32
// [num_blocks, 3] (cap <= num_blocks); num_active int32 [1]; lo, hi f32
// [hs * ws], 16-byte aligned: the windows of the pixels (offset + row
// stride, offset + col stride), row < hs, col < ws, each clamped to
// [s_min, s_max] when `clamp` is set.
extern "C" int gsdf_render_windows_f32(
    const void* K, const void* R, const void* t, const void* block_coords,
    const void* num_active, int cap, int block_shape, float vs, float r,
    int width, int height, int tile, float inv_tile, int max_span,
    int stride, int offset, int hs, int ws, int clamp, float s_min,
    float s_max, void* lo, void* hi, void* stream) {
  if (bad_image(width, height, tile) || cap < 0 || stride <= 0 ||
      offset < 0 || hs <= 0 || ws <= 0 ||
      offset + (hs - 1) * stride >= height ||
      offset + (ws - 1) * stride >= width ||
      static_cast<long long>(hs) * ws >= INT32_MAX ||
      !aligned16(lo) || !aligned16(hi))
    return cudaErrorInvalidValue;
  const Launch l(width, height, tile);
  if (l.grid.y > 65535) return cudaErrorInvalidValue;
  const size_t smem = 2 * static_cast<size_t>(l.PX) * l.PY * sizeof(int);
  Raster a = {static_cast<const float*>(K), static_cast<const float*>(R),
              static_cast<const float*>(t),
              static_cast<const int*>(block_coords),
              static_cast<const int*>(num_active), cap,
              static_cast<float>(block_shape),
              0.5f * static_cast<float>(block_shape - 1), vs, r,
              static_cast<float>(width), static_cast<float>(height),
              inv_tile, l.WT, l.HT, max_span, l.PX, l.PY, width, height,
              tile, stride, offset, hs, ws, make_div(tile), clamp, s_min,
              s_max};
  render_windows<<<l.grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<float*>(lo), static_cast<float*>(hi));
  return static_cast<int>(cudaGetLastError());
}

// gsdf_render_windows_empty: an empty kernel at the launch of a width x
// height image at `tile` px: the launch floor.
extern "C" int gsdf_render_windows_empty(int width, int height, int tile,
                                         void* stream) {
  if (bad_image(width, height, tile)) return cudaErrorInvalidValue;
  const Launch l(width, height, tile);
  empty_kernel<<<l.grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
