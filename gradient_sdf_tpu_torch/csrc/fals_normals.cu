// fals_normals: a depth frame's FALS unit normals in one launch.
//
// Replaces, on the card, the per-frame part of the JAX package's
// `gradient_sdf_tpu/ops/normals.py::compute_normals` (called from
// `ops/fusion.py:459`), which XLA fuses into a few passes around banded
// matrix products; it has no TPU kernel. The port's plain version is
// `ops/normals.compute_normals` with its float64 `box_filter`:
//
//   z_inv = depth != 0 ? 1 / depth : 0                       (float32)
//   a = (x0_n_sq_inv z_inv, y0_n_sq_inv z_inv, n_sq_inv z_inv) (float32)
//   b = the window x window box sums of a, BORDER_REFLECT_101, summed in
//       float64 and rounded to float32
//   n = Q b (Q the cache's packed symmetric 3x3 per pixel), n / |n|
//
//   fals_normals: a CTA of 256 threads owns a tile of kTileX x kTileY =
//     64 x 16 output pixels (300 CTAs at 640x480: one wave at three CTAs
//     an SM):
//     1. the halo's products a (the tile and r = window / 2 pixels on each
//        side, the reflect-101 border folded into the source indices),
//        each converted to float64 once, into shared memory, twelve
//        pixels' loads in flight a thread; then the loads of the Q of its four
//        step-4 pixels into registers, in flight through steps 2-3;
//     2. down each halo column, a running sum of `window` values (add the
//        entering row, subtract the leaving one), written in place over
//        the column's first kTileY rows;
//     3. along each output row, a thread a channel's strip of kStrip = 16
//        outputs, the running sum of `window` of those column sums,
//        rounded to float32 into shared memory (a half-warp's lanes are
//        the 16 rows, so the reads are free of bank conflicts with an odd
//        row pitch);
//     4. a thread a pixel, 32 consecutive pixels a warp: n = Q b and n /
//        |n| (b written out in coalesced rows), into shared memory;
//     5. the tile's rows of normals out, in 16-byte stores.
//
// Precision: the 3x3 systems are nearly singular (121 nearly parallel
// rays: cond ~1e3), so a rounding error of ~1e-6 in a window sum becomes
// ~1e-3 in the normal, enough to flip a pixel at fusion's normal gates. The
// sums are therefore taken in float64, as the plain version takes them:
// float64 holds every partial sum of a frame's float32 terms exactly (the
// plain version's own prefix sums over whole rows and columns rely on the
// same), so any order of additions and subtractions gives the plain
// version's bits; after the same rounding to float32 the product Q b, the
// norm and the division are the plain version's float32 operations in its
// order. This file is compiled with -fmad=false (see _build.SOURCE_FLAGS)
// and with IEEE division and square root (no --use_fast_math): the normals
// are then the plain version's bit for bit. A window without depth gives
// 0 / 0 = NaN, as there: fusion gates on isfinite. (A NaN or infinite
// product, which no depth frame gives, would spoil the rest of its strip.)
//
// What bounds it on an H100: bytes. A pixel reads 4 B of depth, 12 B of
// rays and 24 B of Q and writes 12 B of normal (~16 MB a VGA frame, 0.00477
// ms at 3.35 TB/s); its float64 additions (~2.7 a channel and pass with
// running sums) and the halo's once-only conversions take far less at the
// card's rates. The halo (26 x 74 pixels of input for 64 x 16 outputs at
// window 11) is read 1.9 times on average, the neighbours' share from the
// L2. Measured on golden frame 5 (NVIDIA H100 80GB HBM3, 700 W power
// limit; PERF.md): 0.0105-0.0110 ms (the previous design, a CTA of 512
// threads a 32 x 16 tile, 600 CTAs in two waves, 11 conversions and terms
// an output and pass: 0.0162-0.0165 ms in the same calls) above an empty
// launch of 0.0019-0.0021; 75 registers, no spills. What holds it: the
// phases do not overlap, since every CTA of the one wave is in the same
// one: the halo's loads take ~0.0026 ms above the floor, the products and
// the two passes in shared memory ~0.003, Q's last arrivals ~0.0007, the
// normals ~0.0015 and their stores ~0.0004.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileX = 64;
constexpr int kTileY = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStrip = 16;                           // outputs a thread, step 3
constexpr int kStrips = 3 * kTileY * (kTileX / kStrip);  // step 3's threads
constexpr int kPixels = kTileX * kTileY / kThreads;  // pixels a thread, step 4
// step 1: a warp's halo rows kHaloRows at a time, 3 x 32 columns each
constexpr int kHaloRows = 4;
constexpr int kHalo = 3 * kHaloRows;   // pixels a thread loads at once
static_assert(kTileY == 16 && kStrips <= kThreads, "step 3: lanes = rows");
constexpr int kBPitch = kTileX + 1;   // the rounded sums' row pitch (odd)
constexpr int kMaxDevices = 64;

// the reflect-101 source index of i: -1 -> 1, n -> n - 2. Exact for i in
// [-r, n - 1 + r], which is all an output pixel of the image reads; the
// halo of a tile that reaches past the image's edge also holds entries
// further out, which feed only outputs outside the image and are clamped
// into it so that no read leaves the image.
__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// a read-only 8-byte load the compiler keeps where it stands (volatile), so
// that the Q loads issued after step 1 stay in flight through steps 2-3 and
// are not sunk to step 4, where their values are used
__device__ __forceinline__ float2 ldg_now(const float2* p) {
  float2 v;
  asm volatile("ld.global.nc.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y) : "l"(p));
  return v;
}

// v / norm, the IEEE division, with the quotients by +0 (a window without
// depth: n = 0, |n| = +0) written out: NaN for v = 0, else +-inf, the
// values the division gives, without its slow path, which a warp of such
// pixels would otherwise take for every lane
__device__ __forceinline__ float div_norm(float v, float norm) {
  if (norm == 0.0f)
    return v == 0.0f ? __int_as_float(0x7fffffff)
                     : copysignf(__int_as_float(0x7f800000), v);
  return v / norm;
}

// the halo's row pitch in doubles: odd, so that the 16 rows step 3's
// half-warps read at once fall in 16 different banks
__host__ __device__ inline int pitch_of(int r) { return (kTileX + 2 * r) | 1; }

// Shared memory for window radius r: the halo's float64 products, three
// channels of (kTileY + 2r) rows (the column sums replace the first
// kTileY), then the rounded window sums, three channels of the tile.
__host__ __device__ inline size_t smem_bytes(int r) {
  const size_t rows = kTileY + 2 * r;
  return 3 * rows * pitch_of(r) * sizeof(double) +
         3 * kTileY * kBPitch * sizeof(float);
}

__global__ void __launch_bounds__(kThreads, 3)
fals_normals(const float* __restrict__ depth, const float* __restrict__ x0n,
             const float* __restrict__ y0n, const float* __restrict__ nsq,
             const float* __restrict__ Q, float* __restrict__ out,
             float* __restrict__ b_out, int H, int W, int r, bool vec_out) {
  extern __shared__ double smem[];
  const int rows = kTileY + 2 * r, cols = kTileX + 2 * r, win = 2 * r + 1;
  const int pitch = pitch_of(r), plane = rows * pitch;
  double* P = smem;                                   // [3][rows][pitch]
  float* B = reinterpret_cast<float*>(P + 3 * plane);  // [3][kTileY][kBPitch]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = blockIdx.x * kTileX, ty = blockIdx.y * kTileY;

  // 1. the halo's products in float64, kHalo pixels' loads in flight a thread
  const int x0 = tx - r, y0 = ty - r;
  for (int hy0 = warp; hy0 < rows; hy0 += kHaloRows * kWarps) {
    for (int hx0 = 0; hx0 < cols; hx0 += 3 * 32) {
      float d[kHalo], u[kHalo], v[kHalo], w[kHalo];
#pragma unroll
      for (int j = 0; j < kHalo; ++j) {
        const int hy = hy0 + (j / 3) * kWarps, hx = hx0 + (j % 3) * 32 + lane;
        d[j] = u[j] = v[j] = w[j] = 0.0f;
        if (hy < rows && hx < cols) {
          const int p = reflect101(y0 + hy, H) * W + reflect101(x0 + hx, W);
          d[j] = __ldg(depth + p);
          u[j] = __ldg(x0n + p);
          v[j] = __ldg(y0n + p);
          w[j] = __ldg(nsq + p);
        }
      }
#pragma unroll
      for (int j = 0; j < kHalo; ++j) {
        const int hy = hy0 + (j / 3) * kWarps, hx = hx0 + (j % 3) * 32 + lane;
        if (hy < rows && hx < cols) {
          const float zi = d[j] != 0.0f ? 1.0f / d[j] : 0.0f;
          double* dst = P + hy * pitch + hx;
          dst[0] = static_cast<double>(u[j] * zi);
          dst[plane] = static_cast<double>(v[j] * zi);
          dst[2 * plane] = static_cast<double>(w[j] * zi);
        }
      }
    }
  }
  // the Q of this thread's step-4 pixels, (tid / kTileX + k kThreads /
  // kTileX, tid % kTileX) of the tile: loaded once step 1's loads are out,
  // so that they do not compete with them, and in flight through steps 2-3
  const int px = tx + (tid & (kTileX - 1)), py0 = ty + tid / kTileX;
  constexpr int kRowStep = kThreads / kTileX;
  float2 q[kPixels][3];
#pragma unroll
  for (int k = 0; k < kPixels; ++k) {
    const int y = py0 + k * kRowStep;
    if (px < W && y < H) {
      const float2* src = reinterpret_cast<const float2*>(Q) +
                          3 * (static_cast<int64_t>(y) * W + px);
#pragma unroll
      for (int m = 0; m < 3; ++m) q[k][m] = ldg_now(src + m);
    }
  }
  __syncthreads();

  // 2. down each halo column: row y's sum of rows [y, y + 2r], in place
  for (int it = tid; it < 3 * cols; it += kThreads) {
    const int c = it / cols, hx = it - c * cols;
    double* col = P + c * plane + hx;
    double s = 0.0;
    for (int k = 0; k < win; ++k) s += col[k * pitch];
    double leave = col[0];
    col[0] = s;
#pragma unroll
    for (int y = 1; y < kTileY; ++y) {
      const double enter = col[(y + 2 * r) * pitch];
      const double next = col[y * pitch];
      s += enter;
      s -= leave;
      col[y * pitch] = s;
      leave = next;
    }
  }
  __syncthreads();

  // 3. along each output row: lane & 15 the row, the rest a channel and a
  //    strip of kStrip outputs; the window sums rounded to float32, as the
  //    plain version rounds
  if (tid < kStrips) {
    const int y = tid & (kTileY - 1), rest = tid / kTileY;
    const int c = rest / (kTileX / kStrip);
    const int xs = (rest - c * (kTileX / kStrip)) * kStrip;
    const double* row = P + c * plane + y * pitch + xs;
    float* b = B + (c * kTileY + y) * kBPitch + xs;
    double s = 0.0;
    for (int k = 0; k < win; ++k) s += row[k];
    b[0] = static_cast<float>(s);
#pragma unroll
    for (int j = 1; j < kStrip; ++j) {
      s += row[j + 2 * r];
      s -= row[j - 1];
      b[j] = static_cast<float>(s);
    }
  }
  __syncthreads();

  // 4. n = Q b in the plain version's order, then n / |n|, into shared
  //    memory (the halo's, free after step 3) as the tile's rows of normals
  float* N = reinterpret_cast<float*>(P);   // [kTileY][3 kTileX]
  const int64_t HW = static_cast<int64_t>(H) * W;
#pragma unroll
  for (int k = 0; k < kPixels; ++k) {
    const int y = py0 + k * kRowStep;
    if (px >= W || y >= H) continue;
    const int i = (y - ty) * kBPitch + (px - tx);
    const float b0 = B[i], b1 = B[kTileY * kBPitch + i],
                b2 = B[2 * kTileY * kBPitch + i];
    const int64_t p = static_cast<int64_t>(y) * W + px;
    if (b_out != nullptr) {
      b_out[p] = b0;
      b_out[HW + p] = b1;
      b_out[2 * HW + p] = b2;
    }
    const float q0 = q[k][0].x, q1 = q[k][0].y, q2 = q[k][1].x,
                q3 = q[k][1].y, q4 = q[k][2].x, q5 = q[k][2].y;
    const float nx = b0 * q0 + b1 * q1 + b2 * q2;
    const float ny = b0 * q1 + b1 * q3 + b2 * q4;
    const float nz = b0 * q2 + b1 * q4 + b2 * q5;
    const float norm = sqrtf(nx * nx + ny * ny + nz * nz);
    float* o = N + (y - ty) * 3 * kTileX + 3 * (px - tx);
    o[0] = div_norm(nx, norm);
    o[1] = div_norm(ny, norm);
    o[2] = div_norm(nz, norm);
  }
  __syncthreads();
  // 5. the rows out, in 16-byte stores where the row's span allows them
  const int nf = 3 * min(kTileX, W - tx);   // floats of a tile row
  constexpr int kQuads = 3 * kTileX / 4;
  for (int i = tid; i < kTileY * kQuads; i += kThreads) {
    const int row = i / kQuads, qd = i - row * kQuads;
    if (ty + row >= H || 4 * qd >= nf) continue;
    float* dst = out + 3 * (static_cast<int64_t>(ty + row) * W + tx);
    const float* src = N + row * 3 * kTileX;
    if (vec_out && 4 * qd + 4 <= nf) {
      reinterpret_cast<float4*>(dst)[qd] =
          reinterpret_cast<const float4*>(src)[qd];
    } else {
      for (int m = 4 * qd; m < 4 * qd + 4 && m < nf; ++m) dst[m] = src[m];
    }
  }
}

__global__ void __launch_bounds__(kThreads, 3) fals_normals_empty() {}

// Raises the kernel's shared-memory limit on the current device to `smem`
// when a launch needs more than the default 48 KB (the attribute holds per
// device and function). Returns a CUDA error code.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t* allowed, size_t smem) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem <= 48 * 1024 || smem <= allowed[dev]) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  allowed[dev] = smem;
  return 0;
}

size_t smem_allowed[kMaxDevices] = {};
size_t empty_smem_allowed[kMaxDevices] = {};

int check(int H, int W, int window) {
  const int r = window / 2;
  if (H <= 0 || W <= 0 || window < 1 || window % 2 == 0 || r >= H || r >= W)
    return cudaErrorInvalidValue;
  return 0;
}

dim3 grid_of(int H, int W) {
  return dim3((W + kTileX - 1) / kTileX, (H + kTileY - 1) / kTileY);
}

}  // namespace

// C entry points (bound with ctypes). Each launches on `stream`, does not
// synchronize, and returns cudaGetLastError() of the launch (0 = success).
//
// gsdf_fals_normals_f32: `depth`, `x0n`, `y0n`, `nsq` f32 [H, W] (the
// cache's x0 / |h|^2, y0 / |h|^2, 1 / |h|^2); `Q` f32 [H, W, 6], 8-byte
// aligned; `out` f32 [H, W, 3] unit normals; `b_out` f32 [3, H, W] the
// rounded window sums, or null. `window` odd, with window / 2 < H and < W
// (reflect-101 needs an interior pixel to mirror).
extern "C" int gsdf_fals_normals_f32(const void* depth, const void* x0n,
                                     const void* y0n, const void* nsq,
                                     const void* Q, void* out, void* b_out,
                                     int H, int W, int window, void* stream) {
  int e = check(H, W, window);
  if (e == 0 && reinterpret_cast<uintptr_t>(Q) % 8 != 0)
    e = cudaErrorMisalignedAddress;
  const size_t smem = smem_bytes(window / 2);
  if (e == 0) e = allow_smem(fals_normals, smem_allowed, smem);
  if (e != 0) return e;
  fals_normals<<<grid_of(H, W), kThreads, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(depth), static_cast<const float*>(x0n),
      static_cast<const float*>(y0n), static_cast<const float*>(nsq),
      static_cast<const float*>(Q), static_cast<float*>(out),
      static_cast<float*>(b_out), H, W, window / 2,
      W % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0);
  return static_cast<int>(cudaGetLastError());
}

// gsdf_fals_normals_empty: an empty kernel at the launch of a frame of H x
// W at `window` (grid, threads and shared memory): the launch floor.
extern "C" int gsdf_fals_normals_empty(int H, int W, int window, void* stream) {
  int e = check(H, W, window);
  const size_t smem = smem_bytes(window / 2);
  if (e == 0) e = allow_smem(fals_normals_empty, empty_smem_allowed, smem);
  if (e != 0) return e;
  fals_normals_empty<<<grid_of(H, W), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
