// Multi-field scatter-add: out[idx[j], f] += vals[j, f] for f < F.
//
// Replaces the Pallas TPU kernels of
// gradient_sdf_tpu/ops/pallas/scatter_add.py (scatter_add_multi with its
// body _multi_kernel, and scatter_add_rows with _kernel, its F = 1 case).
// It computes what they compute, not how: the TPU kernels keep the whole
// destination resident in VMEM, lane-packed 25 destinations to a 128-lane
// row, and walk the samples serially on the scalar core. Here every thread
// takes samples in a grid-stride loop and adds each field with a float
// atomic straight into the caller-owned row-major [out_size, F] f32 tensor
// in device memory. Indices outside [0, out_size) are dropped; offsets are
// 64-bit. The destination is updated in place, which is the carry-in.
//
// What bounds it on an H100: random f32 atomics (reductions, since the old
// value is unused) into device memory — one 4-byte RED per field and sample,
// each touching its own 32-byte sector. At the app default the destination
// is 16384 blocks x 512 voxels x 5 fields = 168 MB, more than the 50 MB L2,
// but fusion's samples concentrate: the ~115 blocks the golden scene touches
// (~1.2 MB of destination) stay in L2, so the atomics mostly resolve there.
// Making it fast is later work: sm_90 vector reductions
// (red.global.add.v4.f32) into a padded [nvox, 8] row, or fusing the ray
// sample walk into this kernel so the [N, F] payload never reaches memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <int F>
__global__ void scatter_add_fixed(const int32_t* __restrict__ idx,
                                  const float* __restrict__ vals,
                                  float* __restrict__ out, int64_t n,
                                  int64_t out_size) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < n; j += stride) {
    const int64_t i = idx[j];
    if (i < 0 || i >= out_size) continue;
    const float* v = vals + j * F;
    float* o = out + i * F;
#pragma unroll
    for (int f = 0; f < F; ++f) atomicAdd(o + f, v[f]);
  }
}

}  // namespace

// C entry point (bound with ctypes) for 1 <= nf <= 5 fields. Launches on
// `stream`, does not synchronize, and returns cudaGetLastError() of the
// launch (0 = success; cudaErrorInvalidValue for another nf).
extern "C" int gsdf_scatter_add_f32(const void* idx, const void* vals,
                                    void* out, int64_t n, int64_t out_size,
                                    int nf, void* stream) {
  if (n <= 0) return 0;
  constexpr int kThreads = 256;
  // enough blocks to fill 132 SMs several times; the grid-stride loop
  // covers the rest
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  const dim3 grid(static_cast<unsigned>(blocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ip = static_cast<const int32_t*>(idx);
  const float* vp = static_cast<const float*>(vals);
  float* op = static_cast<float*>(out);
  switch (nf) {
    case 1: scatter_add_fixed<1><<<grid, kThreads, 0, s>>>(ip, vp, op, n, out_size); break;
    case 2: scatter_add_fixed<2><<<grid, kThreads, 0, s>>>(ip, vp, op, n, out_size); break;
    case 3: scatter_add_fixed<3><<<grid, kThreads, 0, s>>>(ip, vp, op, n, out_size); break;
    case 4: scatter_add_fixed<4><<<grid, kThreads, 0, s>>>(ip, vp, op, n, out_size); break;
    case 5: scatter_add_fixed<5><<<grid, kThreads, 0, s>>>(ip, vp, op, n, out_size); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
