// merge_clear: fold a frame's summed accumulator rows into the running voxel
// state, one CTA a listed block, in two modes of one kernel body.
//
// Replaces what the JAX package leaves to XLA: the mesh's merge of the
// world-summed compact rows into each device's resident shard
// (gradient_sdf_tpu/parallel/sharding.py:244-288: `dest_row` scatters the
// rows into a dense [nb_local, B^3] buffer, then the dense `merge` runs
// over the whole shard), and one device's dense `_merge_accumulators` with
// the fresh accumulator of `_zero_accs` (gradient_sdf_tpu/ops/fusion.py:362).
// Per voxel
//     W' = W + w
//     d' = W' > 0 ? (d W + wd) / max(W', 1e-30) : d
//     g' = g + wn                      (skipped without gradients)
// with (w, wd, wn_x, wn_y, wn_z) the first five floats of the voxel's
// source row and (W, d, g) the grid's SoA fields.
//
//   merge_touched (the mesh): the source is the world-summed rows `red`,
//     f32 [rows, 5], 20 bytes a row, and the list is the frame's touched
//     block slots `tidx` (ascending, int64, on the device; its length is
//     known on the host). CTA i reads entry i and keeps it only if the
//     rank's slot window [lo, lo + m) holds it: the ownership filter runs
//     on the device, so the host never reads the list, and a rank that
//     owns none of the touched blocks launches CTAs that exit at once.
//     Block i's source rows are red[i B^3 : (i + 1) B^3] (the compact
//     path) or red[tidx[i] B^3 : ...] (the full path, whose sums cover
//     every slot): read in place, nothing copied into an accumulator.
//     Each thread first issues the loads of its voxel's five fields (they
//     are contiguous per slot, so a warp's loads and stores are
//     coalesced); then the CTA brings a chunk of up to kThreads source rows
//     in with 16-byte loads (10,240 contiguous bytes for an 8^3 block) into
//     shared memory, so that both travel in one round trip; after the
//     barrier each thread takes its voxel's five floats at a stride of 5
//     words (odd, so a warp's reads hit 32 different banks) and writes the
//     merged fields. The source is left as it is.
//   merge_clear (one map's accumulator, f32 [nvox, 8], 32-byte rows): the
//     identity list over the allocated slots [0, num_active), with the
//     rows zeroed after the merge so that the accumulator is all-zero
//     between frames without a memset. `num_active` is read on the device
//     (the host never waits for it), so the grid is sized to the card
//     (kClearCtas) and each CTA walks the blocks below it. Each thread
//     loads its row as two 16-byte vectors. Restricting the merge to the
//     allocated slots is exact: slots are handed out contiguously from 0,
//     and an unallocated slot has W = 0 and an all-zero accumulator row,
//     for which the formula is the identity.
//
// Arithmetic uses the _rn intrinsics, which the compiler never contracts
// into fused multiply-adds, and an IEEE division: the results equal the
// plain PyTorch versions' bit for bit. A block the list leaves out is not
// touched at all. Where a dense merge (the JAX package's, and the mesh's
// merge of every allocated slot before this design) adds a zero row to a
// voxel with W > 0, it computes (d W) / W, which differs from d by an ulp
// for some d and W: such voxels keep their bits here, as in one card's
// fusion (fuse_integrate.cu), which merges the touched blocks only.
//
// What bounds it on an H100: bytes. merge_touched moves, per row of an
// owned touched block, 20 B of `red` read and 20 B of fields read and
// written, plus the list: on the golden protocol's frame 5 at 2 block
// ranks, 84 x 512 rows on rank 0, 2.58 MB, ~0.00077 ms at 3.35 TB/s. The
// step it replaced copied those rows into a persistent [m B^3, 8]
// accumulator (eager ops with two host syncs), then merged and cleared
// every allocated slot of the shard (115 x 512 x 80 B, 0.00141 ms bound).
// At this size what is left is latency: an empty launch at the same grid
// takes about two thirds of the kernel's time, and loading the fields
// together with the source rows saves one of its round trips (PERF.md,
// `tools/fusion_bench.py --mesh-merge`).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;        // threads a CTA at most (an 8^3 block)
constexpr int kClearCtas = 132 * 4;  // merge_clear's grid: 4 CTAs an SM

struct Fields {
  float* weight;
  float* dist;
  float* grad_x;
  float* grad_y;
  float* grad_z;
};

// The old values of a voxel's fields, loaded before its source row arrives.
struct Voxel {
  float w, d, gx, gy, gz;
};

__device__ __forceinline__ Voxel load_voxel(const Fields& f, int64_t r,
                                            bool with_grad) {
  Voxel v{f.weight[r], f.dist[r], 0.0f, 0.0f, 0.0f};
  if (with_grad) {
    v.gx = f.grad_x[r];
    v.gy = f.grad_y[r];
    v.gz = f.grad_z[r];
  }
  return v;
}

__device__ __forceinline__ void merge_voxel(const Fields& f, int64_t r,
                                            const Voxel& o, float w, float wd,
                                            float nx, float ny, float nz,
                                            bool with_grad) {
  const float w_new = __fadd_rn(o.w, w);
  if (w_new > 0.0f) {
    f.dist[r] = __fdiv_rn(__fadd_rn(__fmul_rn(o.d, o.w), wd),
                          fmaxf(w_new, 1e-30f));
  }
  f.weight[r] = w_new;
  if (with_grad) {
    f.grad_x[r] = __fadd_rn(o.gx, nx);
    f.grad_y[r] = __fadd_rn(o.gy, ny);
    f.grad_z[r] = __fadd_rn(o.gz, nz);
  }
}

// Bring the `nf` floats at `p` (nf <= 5 blockDim.x) into shared memory,
// all of a thread's loads issued before its stores: 16-byte loads (at most
// two a thread) where `p` is 16-byte aligned and nf a multiple of 4.
__device__ __forceinline__ void stage_rows(const float* __restrict__ p,
                                           int nf, float4* stage) {
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0 && (nf & 3) == 0) {
    const float4* p4 = reinterpret_cast<const float4*>(p);
    const int n4 = nf / 4;
    const int k0 = threadIdx.x, k1 = threadIdx.x + blockDim.x;
    float4 x0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), x1 = x0;
    if (k0 < n4) x0 = __ldg(p4 + k0);
    if (k1 < n4) x1 = __ldg(p4 + k1);
    if (k0 < n4) stage[k0] = x0;
    if (k1 < n4) stage[k1] = x1;
    return;
  }
  float* staged = reinterpret_cast<float*>(stage);
  float x[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const int k = threadIdx.x + j * blockDim.x;
    x[j] = k < nf ? __ldg(p + k) : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const int k = threadIdx.x + j * blockDim.x;
    if (k < nf) staged[k] = x[j];
  }
}

__global__ void __launch_bounds__(kThreads)
merge_touched_blocks(const float* __restrict__ red,
                     const int64_t* __restrict__ list, int64_t lo, int64_t m,
                     bool compact, Fields f, int vpb, bool with_grad) {
  __shared__ float4 stage[kThreads * 5 / 4];
  const int64_t entry = list[blockIdx.x];
  const int64_t slot = entry - lo;
  if (slot < 0 || slot >= m) return;   // another rank's block
  const int64_t src_block = compact ? static_cast<int64_t>(blockIdx.x) : entry;
  const float* src = red + src_block * vpb * 5;
  for (int c0 = 0; c0 < vpb; c0 += blockDim.x) {
    const int rows = min(static_cast<int>(blockDim.x), vpb - c0);
    const int v = threadIdx.x;
    const int64_t r = slot * vpb + c0 + v;
    // the fields' loads go out with the source's: one round trip, not two
    Voxel old{};
    if (v < rows) old = load_voxel(f, r, with_grad);
    stage_rows(src + static_cast<int64_t>(c0) * 5, rows * 5, stage);
    __syncthreads();
    if (v < rows) {
      const float* a = reinterpret_cast<const float*>(stage) + v * 5;
      merge_voxel(f, r, old, a[0], a[1], a[2], a[3], a[4], with_grad);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
merge_clear_blocks(float4* __restrict__ acc, Fields f,
                   const int32_t* __restrict__ num_active, int64_t num_blocks,
                   int vpb, bool with_grad) {
  int64_t active = *num_active;
  if (active > num_blocks) active = num_blocks;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int64_t b = blockIdx.x; b < active; b += gridDim.x) {
    for (int v = threadIdx.x; v < vpb; v += blockDim.x) {
      const int64_t r = b * vpb + v;
      const float4 a = acc[2 * r];       // w, wd, wn_x, wn_y
      const float4 c = acc[2 * r + 1];   // wn_z, padding
      merge_voxel(f, r, load_voxel(f, r, with_grad), a.x, a.y, a.z, a.w, c.x,
                  with_grad);
      acc[2 * r] = zero;
      acc[2 * r + 1] = zero;
    }
  }
}

unsigned threads_for(int64_t vpb) {
  const int64_t t = (vpb + 31) / 32 * 32;
  return static_cast<unsigned>(t < kThreads ? t : kThreads);
}

}  // namespace

// C entry points (bound with ctypes). The fields are f32 [num_blocks or m,
// voxels_per_block] each, contiguous. Each launches on `stream`, does not
// synchronize, and returns cudaGetLastError() of the launch (0 = success;
// nothing is launched for an empty list or grid).

// merge_touched: `red` f32 [rows, 5] (contiguous; rows cover the list's
// source blocks), `list` int64 [n_list] on the device, the rank's slots
// [lo, lo + m); `compact` nonzero takes block i's rows at i, zero at
// list[i].
extern "C" int gsdf_merge_touched_f32(const void* red, const void* list,
                                      int64_t n_list, int64_t lo, int64_t m,
                                      int compact, void* weight, void* dist,
                                      void* grad_x, void* grad_y,
                                      void* grad_z, int64_t voxels_per_block,
                                      int with_grad, void* stream) {
  if (n_list <= 0 || m <= 0 || voxels_per_block <= 0) return 0;
  const Fields f{static_cast<float*>(weight), static_cast<float*>(dist),
                 static_cast<float*>(grad_x), static_cast<float*>(grad_y),
                 static_cast<float*>(grad_z)};
  merge_touched_blocks<<<dim3(static_cast<unsigned>(n_list)),
                         threads_for(voxels_per_block), 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(red), static_cast<const int64_t*>(list), lo,
      m, compact != 0, f, static_cast<int>(voxels_per_block), with_grad != 0);
  return static_cast<int>(cudaGetLastError());
}

// merge_clear: `acc` f32 [num_blocks * voxels_per_block, 8], 32-byte
// aligned; `num_active` points to one int32 in device memory.
extern "C" int gsdf_merge_clear_f32(void* acc, void* weight, void* dist,
                                    void* grad_x, void* grad_y, void* grad_z,
                                    const void* num_active, int64_t num_blocks,
                                    int64_t voxels_per_block, int with_grad,
                                    void* stream) {
  if (num_blocks <= 0 || voxels_per_block <= 0) return 0;
  const Fields f{static_cast<float*>(weight), static_cast<float*>(dist),
                 static_cast<float*>(grad_x), static_cast<float*>(grad_y),
                 static_cast<float*>(grad_z)};
  const int64_t ctas = num_blocks < kClearCtas ? num_blocks : kClearCtas;
  merge_clear_blocks<<<dim3(static_cast<unsigned>(ctas)),
                       threads_for(voxels_per_block), 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<float4*>(acc), f, static_cast<const int32_t*>(num_active),
      num_blocks, static_cast<int>(voxels_per_block), with_grad != 0);
  return static_cast<int>(cudaGetLastError());
}

// The launch shapes above, for the measurements: out[0] = CTAs, out[1] =
// threads of a launch over `n` list entries (merge_touched) or of a grid
// of `n` blocks (merge_clear, `clear` nonzero).
extern "C" int gsdf_merge_launch_shape(int64_t n, int64_t voxels_per_block,
                                       int clear, void* out) {
  int* o = static_cast<int*>(out);
  o[0] = static_cast<int>(clear && n > kClearCtas ? kClearCtas : n);
  o[1] = static_cast<int>(threads_for(voxels_per_block));
  return 0;
}

namespace {

__global__ void empty_kernel() {}

}  // namespace

// The launch floor that `merge_clear` and every other kernel pays: a kernel
// that does nothing, launched on `stream` with `blocks` x `threads`. Used by
// the measurements only (chip_smoke.py phases 2b and 15e), never by the
// package.
extern "C" int gsdf_empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<dim3(static_cast<unsigned>(blocks)),
                 dim3(static_cast<unsigned>(threads)), 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
