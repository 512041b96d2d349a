// render_windows: the renderer's exact march windows from the active blocks,
// rasterized to screen tiles, in two launches with nothing read on the host.
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
// Launch 1, `raster_tiles`: one CTA of 1024 threads. The reduction across
// blocks is what a second pass or atomics would be for across CTAs; one CTA
// needs neither (the render scene has 1433 active blocks: under two a
// thread). Every scattered value is >= +0 (lo_b is clamped at 0, hi_b =
// s_c + r > 0), so atomicMin / atomicMax on the float's bits as int32 are
// exact and order-free (-inf's bits are a negative int, below every
// positive float's): the tiles equal the plain version's scatter_reduce_
// bit for bit. The tile grid lives in shared memory while it fits: 48 KB
// (6143 tiles, VGA's 1200 at 16 px) without opting in, the device's opt-in
// limit beyond that (227 KB on an H100: 29055 tiles, 1920x1080's 8160).
// A larger grid (3840x2160 is 32400 tiles) lives in the output buffer in
// global memory, the same atomics in L2, still one CTA and two launches
// (__syncthreads orders a CTA's global accesses as it does its shared
// ones). The CTA writes the finished tiles, f32 [2, nt].
// Launch 2, `expand_windows`: one thread an output window. It writes every
// pixel (raster mode) or only the strided pixels (offset + k stride) the
// stride prior's coarse march reads, 1/16 of the bytes at stride 4, and
// optionally applies `raycast`'s clamps to [s_min, s_max].
//
// Arithmetic is the plain version's float32 operations in its order (the
// source builds with -fmad=false, IEEE division and square root), the
// division by the tile size a multiplication by its reciprocal as PyTorch
// does on the card for a division by a Python number.
//
// What bounds it on an H100: bytes, and at these sizes latency. Launch 1
// reads 12 B a live block slot (17 KB at 1433 blocks) and writes 8 B a tile
// (9.6 KB at VGA); launch 2 writes 8 B a window (2.46 MB for every VGA
// pixel, 0.15 MB at stride 4): ~0.0007 ms and ~0.00005 ms at 3.35 TB/s.
// Each launch is a few microseconds of launch and one or two dependent
// round trips; launch 1 runs on one SM, which is the design's cost: its
// time grows with the active blocks (about 4 a thread at the 4096 cap).

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRasterThreads = 1024;
constexpr int kExpandThreads = 256;
// the shared memory a CTA may take without opting in
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kInfBits = 0x7f800000;               // +inf
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
};

__device__ __forceinline__ int tile_of(float x, float inv_tile, int last) {
  // torch.clamp(torch.floor(x / tile), 0, last).to(int32)
  const float f = fminf(fmaxf(floorf(x * inv_tile), 0.f),
                        static_cast<float>(last));
  return static_cast<int>(f);
}

__global__ void __launch_bounds__(kRasterThreads)
raster_tiles(Raster a, int in_smem, float* tiles) {
  // the tile grid: two int32 a tile, in shared memory or, past what a CTA
  // may take there, in `tiles` itself (each thread finishes the entries it
  // reads, so the final pass may write in place)
  extern __shared__ int smem[];
  __shared__ int glob[2];      // [lo, hi]
  const int nt = a.WT * a.HT;
  int* lo_s = in_smem ? smem : reinterpret_cast<int*>(tiles);
  int* hi_s = lo_s + nt;
  for (int i = threadIdx.x; i < nt; i += blockDim.x) {
    lo_s[i] = kInfBits;
    hi_s[i] = kNegInfBits;
  }
  if (threadIdx.x == 0) {
    glob[0] = kInfBits;
    glob[1] = kNegInfBits;
  }
  const int na = *a.num_active;
  const bool over = na > a.cap;
  __syncthreads();
  if (!over) {
    const float fx = a.K[0], cx = a.K[2], fy = a.K[4], cy = a.K[5];
    const float R00 = a.R[0], R01 = a.R[1], R02 = a.R[2];
    const float R10 = a.R[3], R11 = a.R[4], R12 = a.R[5];
    const float R20 = a.R[6], R21 = a.R[7], R22 = a.R[8];
    const float tx = a.t[0], ty = a.t[1], tz = a.t[2];
    const float fxr = fx * a.r, fyr = fy * a.r;
    const int n = min(na, a.cap);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int* b = a.block_coords + 3 * i;
      const float dx = (static_cast<float>(b[0]) * a.bs + a.half_span) * a.vs - tx;
      const float dy = (static_cast<float>(b[1]) * a.bs + a.half_span) * a.vs - ty;
      const float dz = (static_cast<float>(b[2]) * a.bs + a.half_span) * a.vs - tz;
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
          const int lo_bits = __float_as_int(lo_b), hi_bits = __float_as_int(hi_b);
          for (int yy = ty0; yy <= ty1; ++yy)
            for (int xx = tx0; xx <= tx1; ++xx) {
              atomicMin(lo_s + yy * a.WT + xx, lo_bits);
              atomicMax(hi_s + yy * a.WT + xx, hi_bits);
            }
        }
      }
      if (glob_block) {                         // near or wide
        atomicMin(glob, __float_as_int(lo_b));
        atomicMax(glob + 1, __float_as_int(hi_b));
      }
    }
  }
  __syncthreads();
  const int glo = glob[0], ghi = glob[1];
  for (int i = threadIdx.x; i < nt; i += blockDim.x) {
    const int l = lo_s[i], h = hi_s[i];
    tiles[i] = over ? 0.f : __int_as_float(min(l, glo));
    tiles[nt + i] = over ? INFINITY : __int_as_float(max(h, ghi));
  }
}

struct Expand {
  int nt, WT, tile, stride, offset, ws, n;
  int clamp;
  float s_min, s_max;
};

__global__ void __launch_bounds__(kExpandThreads)
expand_windows(const float* __restrict__ tiles, Expand e,
               float* __restrict__ lo, float* __restrict__ hi) {
  const int j = blockIdx.x * kExpandThreads + threadIdx.x;
  if (j >= e.n) return;
  const int row = j / e.ws, col = j - row * e.ws;
  const int y = e.offset + row * e.stride, x = e.offset + col * e.stride;
  const int k = (y / e.tile) * e.WT + x / e.tile;
  float l = tiles[k], h = tiles[e.nt + k];
  if (e.clamp) {   // raycast's torch.clamp(s_lo, min=s_min), (s_hi, max=s_max)
    l = fmaxf(l, e.s_min);
    h = fminf(h, e.s_max);
  }
  lo[j] = l;
  hi[j] = h;
}

__global__ void empty_kernel() {}

}  // namespace

// The tiles whose grid fits in one CTA's shared memory on the current
// device with opting in (the static pair beside it), read once a device;
// else a CUDA error.
static int smem_tiles(int* out) {
  constexpr int kDevices = 64;
  static int known[kDevices];   // 0: not read yet (racing readers agree)
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < kDevices && known[dev] > 0) {
    *out = known[dev];
    return 0;
  }
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int bytes = optin > kDefaultSmem ? optin : kDefaultSmem;
  *out = (bytes - 2 * static_cast<int>(sizeof(int))) /
         (2 * static_cast<int>(sizeof(int)));
  if (dev < kDevices) known[dev] = *out;
  return 0;
}

// gsdf_render_windows_smem_tiles: the largest tile grid that launch 1 keeps
// in shared memory on the current device (larger ones go to global
// memory), or -1 on a CUDA error.
extern "C" int gsdf_render_windows_smem_tiles() {
  int n = 0;
  return smem_tiles(&n) == 0 ? n : -1;
}

// gsdf_render_windows_f32: both launches on `stream`, no synchronization;
// returns cudaGetLastError() after them (0 = success).
//
// K, R f32 [3, 3] and t f32 [3] on the device; block_coords int32
// [num_blocks, 3]; num_active int32 [1]; tiles f32 [2, WT * HT] (scratch,
// the finished tile grid afterwards); lo, hi f32 [hs * ws]: the windows of
// the pixels (offset + row stride, offset + col stride), row < hs, col <
// ws, each clamped to [s_min, s_max] when `clamp` is set.
extern "C" int gsdf_render_windows_f32(
    const void* K, const void* R, const void* t, const void* block_coords,
    const void* num_active, int cap, int block_shape, float vs, float r,
    int width, int height, int tile, float inv_tile, int max_span,
    int stride, int offset, int hs, int ws, int clamp, float s_min,
    float s_max, void* tiles, void* lo, void* hi, void* stream) {
  const int WT = (width + tile - 1) / tile, HT = (height + tile - 1) / tile;
  const long long nt_l = static_cast<long long>(WT) * HT;
  if (width <= 0 || height <= 0 || tile <= 0 || nt_l >= INT32_MAX / 2 || cap < 0 ||
      stride <= 0 || offset < 0 || hs <= 0 || ws <= 0 ||
      offset + (hs - 1) * stride >= height ||
      offset + (ws - 1) * stride >= width ||
      static_cast<long long>(hs) * ws >= INT32_MAX)
    return cudaErrorInvalidValue;
  const int nt = static_cast<int>(nt_l);
  int fit = 0;
  cudaError_t e = static_cast<cudaError_t>(smem_tiles(&fit));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int in_smem = nt <= fit;
  const size_t smem = in_smem ? 2 * static_cast<size_t>(nt) * sizeof(int) : 0;
  if (smem + 2 * sizeof(int) > static_cast<size_t>(kDefaultSmem)) {
    e = cudaFuncSetAttribute(raster_tiles,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Raster a = {static_cast<const float*>(K), static_cast<const float*>(R),
              static_cast<const float*>(t),
              static_cast<const int*>(block_coords),
              static_cast<const int*>(num_active), cap,
              static_cast<float>(block_shape),
              0.5f * static_cast<float>(block_shape - 1), vs, r,
              static_cast<float>(width), static_cast<float>(height),
              inv_tile, WT, HT, max_span};
  raster_tiles<<<1, kRasterThreads, smem, s>>>(a, in_smem,
                                               static_cast<float*>(tiles));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n = hs * ws;
  Expand x = {nt, WT, tile, stride, offset, ws, n, clamp, s_min, s_max};
  expand_windows<<<(n + kExpandThreads - 1) / kExpandThreads, kExpandThreads,
                   0, s>>>(static_cast<const float*>(tiles), x,
                           static_cast<float*>(lo), static_cast<float*>(hi));
  return static_cast<int>(cudaGetLastError());
}

// gsdf_render_windows_empty: empty kernels at both launches' grids for n
// output windows: the launch floor.
extern "C" int gsdf_render_windows_empty(int n, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  empty_kernel<<<1, kRasterThreads, 0, s>>>();
  empty_kernel<<<(n + kExpandThreads - 1) / kExpandThreads, kExpandThreads, 0,
                 s>>>();
  return static_cast<int>(cudaGetLastError());
}
