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
//   fals_normals: a CTA of kTileX x kTileY threads owns a tile of as many
//     output pixels. It computes `a` for the tile and its halo of r =
//     window / 2 pixels on each side, the reflect-101 border folded into
//     the halo's source indices, into shared memory; takes the horizontal
//     sums of `window` values of each halo row in float64, again into
//     shared memory; then each thread sums `window` of those down its
//     column, rounds the three sums to float32 and forms the normal.
//
// Precision: the 3x3 systems are nearly singular (121 nearly parallel
// rays: cond ~1e3), so a rounding error of ~1e-6 in a window sum becomes
// ~1e-3 in the normal, enough to flip a pixel at fusion's normal gates. The
// sums are therefore taken in float64, as the plain version takes them:
// float64 holds the sum of 121 float32 terms of a frame exactly, so any
// order gives the plain version's bits, and after the same rounding to
// float32 the product Q b, the norm and the division are the plain
// version's float32 operations in its order. This file is compiled with
// -fmad=false (see _build.SOURCE_FLAGS) and with IEEE division and square
// root (no --use_fast_math): the normals are then the plain version's bit
// for bit. A window without depth gives 0 / 0 = NaN, as there: fusion gates
// on isfinite.
//
// What bounds it on an H100: bytes. A pixel reads 4 B of depth, 12 B of
// rays and 24 B of Q and writes 12 B of normal (~16 MB a VGA frame, ~0.005
// ms at 3.35 TB/s); its ~70 float64 additions (two separable passes of 11
// over 3 channels) are ~0.0006 ms at the card's float64 rate. The halo
// (26 x 42 pixels of input for 16 x 32 outputs at window 11) is read 1.7
// times on average, from the L2 for the neighbours' share. The plain
// version spent ~0.6 ms of host time in 43 launches on the same work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 16;
constexpr int kThreads = kTileX * kTileY;

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

// Shared memory for window radius r: the halo's float32 products, three
// channels of (kTileY + 2r) x (kTileX + 2r), then the float64 horizontal
// sums, three channels of (kTileY + 2r) x kTileX.
__host__ __device__ inline size_t smem_bytes(int r) {
  const size_t rows = kTileY + 2 * r, cols = kTileX + 2 * r;
  return 3 * rows * kTileX * sizeof(double) + 3 * rows * cols * sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
fals_normals(const float* __restrict__ depth, const float* __restrict__ x0n,
             const float* __restrict__ y0n, const float* __restrict__ nsq,
             const float* __restrict__ Q, float* __restrict__ out,
             float* __restrict__ b_out, int H, int W, int r) {
  extern __shared__ double smem[];
  const int rows = kTileY + 2 * r, cols = kTileX + 2 * r, win = 2 * r + 1;
  double* hsum = smem;                                          // [3][rows][kTileX]
  float* a = reinterpret_cast<float*>(smem + 3 * rows * kTileX);  // [3][rows][cols]
  const int tid = threadIdx.y * kTileX + threadIdx.x;
  const int x0 = blockIdx.x * kTileX - r, y0 = blockIdx.y * kTileY - r;
  // 1. the halo's products, the border reflected into the image
  for (int i = tid; i < rows * cols; i += kThreads) {
    const int hy = i / cols, hx = i - hy * cols;
    const int sy = reflect101(y0 + hy, H), sx = reflect101(x0 + hx, W);
    const int p = sy * W + sx;
    const float d = __ldg(depth + p);
    const float zi = d != 0.0f ? 1.0f / d : 0.0f;
    a[i] = __ldg(x0n + p) * zi;
    a[rows * cols + i] = __ldg(y0n + p) * zi;
    a[2 * rows * cols + i] = __ldg(nsq + p) * zi;
  }
  __syncthreads();
  // 2. each halo row's sums of `win` values, in float64 (exact)
  for (int i = tid; i < 3 * rows * kTileX; i += kThreads) {
    const int c = i / (rows * kTileX), rem = i - c * rows * kTileX;
    const int hy = rem / kTileX, tx = rem - hy * kTileX;
    const float* src = a + c * rows * cols + hy * cols + tx;
    double s = 0.0;
    for (int k = 0; k < win; ++k) s += static_cast<double>(src[k]);
    hsum[i] = s;
  }
  __syncthreads();
  // 3. the column sums, rounded to float32 as the plain version rounds
  const int x = blockIdx.x * kTileX + threadIdx.x;
  const int y = blockIdx.y * kTileY + threadIdx.y;
  if (x >= W || y >= H) return;
  float b[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const double* src = hsum + c * rows * kTileX + threadIdx.y * kTileX + threadIdx.x;
    double s = 0.0;
    for (int k = 0; k < win; ++k) s += src[k * kTileX];
    b[c] = static_cast<float>(s);
  }
  const int p = y * W + x;
  if (b_out != nullptr) {
    b_out[p] = b[0];
    b_out[H * W + p] = b[1];
    b_out[2 * H * W + p] = b[2];
  }
  // 4. n = Q b in the plain version's order, then n / |n|
  const float* q = Q + 6 * static_cast<int64_t>(p);
  const float q0 = __ldg(q), q1 = __ldg(q + 1), q2 = __ldg(q + 2),
              q3 = __ldg(q + 3), q4 = __ldg(q + 4), q5 = __ldg(q + 5);
  const float nx = b[0] * q0 + b[1] * q1 + b[2] * q2;
  const float ny = b[0] * q1 + b[1] * q3 + b[2] * q4;
  const float nz = b[0] * q2 + b[1] * q4 + b[2] * q5;
  const float norm = sqrtf(nx * nx + ny * ny + nz * nz);
  float* o = out + 3 * static_cast<int64_t>(p);
  o[0] = nx / norm;
  o[1] = ny / norm;
  o[2] = nz / norm;
}

// the shared-memory size the attribute was last raised to
size_t smem_allowed = 48 * 1024;

}  // namespace

// C entry point (bound with ctypes). Launches on `stream`, does not
// synchronize, returns cudaGetLastError() of the launch (0 = success).
//
// `depth`, `x0n`, `y0n`, `nsq` f32 [H, W] (the cache's x0 / |h|^2, y0 /
// |h|^2, 1 / |h|^2); `Q` f32 [H, W, 6]; `out` f32 [H, W, 3] unit normals;
// `b_out` f32 [3, H, W] the rounded window sums, or null. `window` odd, with
// window / 2 < H and < W (reflect-101 needs an interior pixel to mirror).
extern "C" int gsdf_fals_normals_f32(const void* depth, const void* x0n,
                                     const void* y0n, const void* nsq,
                                     const void* Q, void* out, void* b_out,
                                     int H, int W, int window, void* stream) {
  const int r = window / 2;
  if (H <= 0 || W <= 0 || window < 1 || window % 2 == 0 || r >= H || r >= W)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(r);
  if (smem > smem_allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        fals_normals, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_allowed = smem;
  }
  const dim3 grid((W + kTileX - 1) / kTileX, (H + kTileY - 1) / kTileY);
  fals_normals<<<grid, dim3(kTileX, kTileY), smem,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(depth), static_cast<const float*>(x0n),
      static_cast<const float*>(y0n), static_cast<const float*>(nsq),
      static_cast<const float*>(Q), static_cast<float*>(out),
      static_cast<float*>(b_out), H, W, r);
  return static_cast<int>(cudaGetLastError());
}
