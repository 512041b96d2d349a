// merge_clear: fold the frame accumulator into the running voxel state and
// zero the accumulator, over the allocated block slots only.
//
// Replaces what the JAX package leaves to XLA as one fused dense pass
// (gradient_sdf_tpu/ops/fusion.py, `_merge_accumulators` and the fresh
// accumulator of `_zero_accs`): per voxel
//     W' = W + w
//     d' = W' > 0 ? (d W + wd) / max(W', 1e-30) : d
//     g' = g + wn                      (skipped without gradients)
// with (w, wd, wn_x, wn_y, wn_z) the first five floats of the voxel's
// 32-byte accumulator row and (W, d, g) the grid's SoA fields.
//
// What bounds it on an H100: bytes. Run densely over the app-default grid
// (16384 blocks x 512 voxels) the pass moves every field and the whole
// accumulator, ~0.7 GB in this kernel's terms and far more as eager tensor
// ops, for a scene that has allocated ~130 blocks. The design moves only
// what is live: block slots are handed out contiguously from 0, so the rows
// [0, num_active * voxels_per_block) are all there is to merge. The kernel
// reads `num_active` from device memory itself (the host never waits for
// it) and bounds its grid-stride loop by it. That restriction is exact, not
// approximate: an unallocated slot has W = 0 and an all-zero accumulator
// row, for which the formula above is the identity.
//
// The accumulator row is loaded as two 16-byte vectors and written back as
// zeros in the same pass, so the accumulator is all-zero between frames
// without any memset. Arithmetic uses the _rn intrinsics, which the
// compiler never contracts into fused multiply-adds, and an IEEE division:
// the results equal the plain PyTorch version's bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256)
merge_clear_rows(float4* __restrict__ acc, float* __restrict__ weight,
                 float* __restrict__ dist, float* __restrict__ grad_x,
                 float* __restrict__ grad_y, float* __restrict__ grad_z,
                 const int32_t* __restrict__ num_active, int64_t num_blocks,
                 int64_t voxels_per_block, bool with_grad) {
  int64_t active = *num_active;
  if (active > num_blocks) active = num_blocks;
  const int64_t rows = active * voxels_per_block;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       r < rows; r += stride) {
    const float4 a = acc[2 * r];       // w, wd, wn_x, wn_y
    const float4 b = acc[2 * r + 1];   // wn_z, padding
    const float w_old = weight[r];
    const float w_new = __fadd_rn(w_old, a.x);
    if (w_new > 0.0f) {
      dist[r] = __fdiv_rn(__fadd_rn(__fmul_rn(dist[r], w_old), a.y),
                          fmaxf(w_new, 1e-30f));
    }
    weight[r] = w_new;
    if (with_grad) {
      grad_x[r] = __fadd_rn(grad_x[r], a.z);
      grad_y[r] = __fadd_rn(grad_y[r], a.w);
      grad_z[r] = __fadd_rn(grad_z[r], b.x);
    }
    acc[2 * r] = zero;
    acc[2 * r + 1] = zero;
  }
}

}  // namespace

// C entry point (bound with ctypes). `acc` is f32 [num_blocks *
// voxels_per_block, 8], 32-byte aligned; the fields are f32 [num_blocks,
// voxels_per_block]; `num_active` points to one int32 in device memory.
// Launches on `stream`, does not synchronize, and returns
// cudaGetLastError() of the launch (0 = success).
extern "C" int gsdf_merge_clear_f32(void* acc, void* weight, void* dist,
                                    void* grad_x, void* grad_y, void* grad_z,
                                    const void* num_active, int64_t num_blocks,
                                    int64_t voxels_per_block, int with_grad,
                                    void* stream) {
  if (num_blocks <= 0 || voxels_per_block <= 0) return 0;
  // the live row count is known only on the device: launch enough blocks to
  // fill the card, the loop bound does the rest
  const int64_t total = num_blocks * voxels_per_block;
  int64_t blocks = (total + 255) / 256;
  if (blocks > 132 * 8) blocks = 132 * 8;
  merge_clear_rows<<<dim3(static_cast<unsigned>(blocks)), 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<float4*>(acc), static_cast<float*>(weight),
      static_cast<float*>(dist), static_cast<float*>(grad_x),
      static_cast<float*>(grad_y), static_cast<float*>(grad_z),
      static_cast<const int32_t*>(num_active), num_blocks, voxels_per_block,
      with_grad != 0);
  return static_cast<int>(cudaGetLastError());
}

namespace {

__global__ void empty_kernel() {}

}  // namespace

// The launch floor that `merge_clear` and every other kernel pays: a kernel
// that does nothing, launched on `stream` with `blocks` x `threads`. Used by
// the measurements only (chip_smoke.py phase 2b), never by the package.
extern "C" int gsdf_empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<dim3(static_cast<unsigned>(blocks)),
                 dim3(static_cast<unsigned>(threads)), 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
