// Multi-field scatter-add: out[idx[j], f] += vals[j, f] for f < F.
//
// Replaces the Pallas TPU kernels of
// gradient_sdf_tpu/ops/pallas/scatter_add.py (scatter_add_multi with its
// body _multi_kernel, and scatter_add_rows with _kernel, its F = 1 case).
// It computes what they compute, not how: the TPU kernels keep the whole
// destination resident in VMEM, lane-packed 25 destinations to a 128-lane
// row, and walk the samples serially on the scalar core. Here the
// destination stays in device memory, caller-owned and updated in place
// (which is the carry-in); indices outside [0, out_size) are dropped;
// offsets are 64-bit.
//
// What bounds it on an H100: bytes, on paper (4 B of index and 4 F B of
// payload per sample, plus each touched row once: 2.4 us for a golden
// frame's 327,580 samples) — but what it waited for was the L2's reduction
// units. Fusion lands ~30 samples on each touched voxel and neighbouring
// samples hit the same voxel, so the same 32-byte sector takes reduction
// after reduction, and same-address reductions serialise. The design
// therefore cuts the number of reductions that reach the L2, not the bytes
// (on an NVIDIA H100 80GB HBM3 at 700.00 W: 27.9 us with one scalar
// reduction per field and sample, 13.4 us warp-aggregated, 8.0 us with
// vector reductions as well, against 2.7 us for a launch of this kernel
// on 32 samples; PERF.md has the runs):
//
//   * Row layout. Fusion's accumulator is f32 [out_size, 8]: one 32-byte
//     sector per destination, so a row never straddles two sectors. With
//     that stride (and a 32-byte aligned base) a row's fields go out as ONE
//     red.global.add.v4.f32 plus one scalar or v2 reduction, instead of F
//     scalar ones. Any other row stride takes scalar reductions.
//   * Warp aggregation. Before touching memory, the lanes of a warp that
//     hold the same destination (__match_any_sync) sum their fields by
//     shuffles into the group's lowest lane, which alone sends the
//     reduction. The lanes are added in ascending lane order, so the sum
//     inside a warp is the same in every run; only the order in which
//     warps reach the L2 still varies. This device code lives in
//     warp_scatter.cuh, which fusion's integrate pass (fuse_integrate.cu)
//     shares.
//   * Loads. The payload comes as F field pointers and one sample stride:
//     (vals + f, F) for a row-major [N, F] array, (field_f, 1) for F
//     separate [N] arrays. Fusion hands its five fields over separately,
//     so no [N, F] copy is ever built and every load is coalesced.
//
// Tried and dropped (NVIDIA H100 80GB HBM3, 700.00 W; golden frame 5's
// 327,580 samples): a per-block pass that pre-reduces in a shared-memory
// hash table (1024 slots, 2048 samples a block) before going to the L2 took
// 0.0222 ms against this kernel's 0.0078 ms — after warp aggregation the
// kernel is one short wave of latency, and the table adds a serial loop,
// two barriers and a flush to it.

#include <cstdint>
#include <cuda_runtime.h>

#include "warp_scatter.cuh"

namespace {

constexpr int kMaxFields = 5;
constexpr int kVecRowStride = 8;   // floats: one 32-byte sector per row

struct FieldPtrs {
  const float* p[kMaxFields];
};

template <int F, bool VEC>
__global__ void __launch_bounds__(256)
scatter_add_warp(const int32_t* __restrict__ idx, FieldPtrs v,
                 int64_t sample_stride, float* __restrict__ out,
                 int64_t row_stride, int64_t n, int64_t out_size) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  // whole warps stay in the loop (block size and stride are multiples of
  // 32), so every shuffle in warp_aggregate has all 32 lanes
  const int64_t n_up = (n + 31) & ~static_cast<int64_t>(31);
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < n_up; j += stride) {
    int32_t i = -1;   // dropped: past the end, or outside [0, out_size)
    if (j < n) {
      i = idx[j];
      if (i < 0 || i >= out_size) i = -1;
    }
    float x[F];
#pragma unroll
    for (int f = 0; f < F; ++f) x[f] = i >= 0 ? v.p[f][j * sample_stride] : 0.0f;
    if (gsdf::warp_aggregate<F>(i, x))
      gsdf::reduce_row<F, VEC>(out + static_cast<int64_t>(i) * row_stride, x);
  }
}

template <int F>
void launch(dim3 grid, cudaStream_t s, bool vec, const int32_t* idx,
            const FieldPtrs& v, int64_t sample_stride, float* out,
            int64_t row_stride, int64_t n, int64_t out_size) {
  if (vec)
    scatter_add_warp<F, true><<<grid, 256, 0, s>>>(idx, v, sample_stride, out,
                                                   row_stride, n, out_size);
  else
    scatter_add_warp<F, false><<<grid, 256, 0, s>>>(idx, v, sample_stride, out,
                                                    row_stride, n, out_size);
}

}  // namespace

// C entry point (bound with ctypes) for 1 <= nf <= 5 fields. Field f of
// sample j is read at v<f>[j * sample_stride] (pointers past nf are
// ignored); destination row i starts at out + i * row_stride floats. Launches on
// `stream`, does not synchronize, and returns cudaGetLastError() of the
// launch (0 = success; cudaErrorInvalidValue for another nf or a row stride
// below nf).
extern "C" int gsdf_scatter_add_f32(const void* idx, const void* v0,
                                    const void* v1, const void* v2,
                                    const void* v3, const void* v4,
                                    int64_t sample_stride, void* out,
                                    int64_t row_stride, int64_t n,
                                    int64_t out_size, int nf, void* stream) {
  if (nf < 1 || nf > kMaxFields || row_stride < nf)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0 || out_size <= 0) return 0;
  // enough blocks to fill 132 SMs several times; the grid-stride loop
  // covers the rest
  int64_t blocks = (n + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  const dim3 grid(static_cast<unsigned>(blocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ip = static_cast<const int32_t*>(idx);
  float* op = static_cast<float*>(out);
  FieldPtrs v;
  const void* raw[kMaxFields] = {v0, v1, v2, v3, v4};
  for (int f = 0; f < kMaxFields; ++f)
    v.p[f] = static_cast<const float*>(raw[f < nf ? f : 0]);
  const bool vec = row_stride == kVecRowStride &&
                   reinterpret_cast<uintptr_t>(out) % 32 == 0;
  switch (nf) {
    case 1: launch<1>(grid, s, vec, ip, v, sample_stride, op, row_stride, n, out_size); break;
    case 2: launch<2>(grid, s, vec, ip, v, sample_stride, op, row_stride, n, out_size); break;
    case 3: launch<3>(grid, s, vec, ip, v, sample_stride, op, row_stride, n, out_size); break;
    case 4: launch<4>(grid, s, vec, ip, v, sample_stride, op, row_stride, n, out_size); break;
    default: launch<5>(grid, s, vec, ip, v, sample_stride, op, row_stride, n, out_size); break;
  }
  return static_cast<int>(cudaGetLastError());
}
