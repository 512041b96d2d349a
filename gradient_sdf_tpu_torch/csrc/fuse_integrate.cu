// fuse_integrate: one depth frame's fusion on one card, in two launches —
// the sample walk, the block lookup, the scatter into the frame
// accumulator and the merge into the running voxel state.
//
// Replaces, for single-card fusion, what the JAX package does in
// gradient_sdf_tpu/ops/fusion.py as XLA-fused passes around its one Pallas
// kernel: the pixel gates of `_pixel_rays`, the sample walk of
// `_ray_samples` (:131), the lookups of `_alloc_slots` (:240), the scatter
// of `_scatter_samples` (:330, whose Pallas form is scatter_add_multi,
// gradient_sdf_tpu/ops/pallas/scatter_add.py:103), the merge of
// `_merge_accumulators` (:362) and the touched mask of the visibility bits.
// The claim of new blocks (`voxel_grid.insert_new`) stays plain PyTorch
// between the two launches, fed by the first.
//
//   1. fuse_claim: one thread per pixel. It gates the pixel, walks its
//      K = 2 * floor(T / vs) + 1 samples and looks each live sample's block
//      up in the dense directory. Candidate c = pixel * K + k over ALL
//      pixels of the frame (no compaction: candidate order is the
//      compacted order, since compaction keeps the pixel order) gets
//      mark[c] = 1 and keys[c] = its block key if the sample is live and
//      its block missing; the marks are all-zero before (the host clears
//      the ones it took). It counts the misses and the live samples outside
//      the directory's range in a two-int status, the host's only read of
//      the frame. The host takes the marked candidates in order
//      (`nonzero_static` with the miss count: no sync, no sort) and hands
//      their keys to `insert_new`.
//   2. fuse_integrate: ONE cooperative launch. Phase A walks every pixel's
//      samples again, looks them up (after the claim) and adds (w,
//      w * trunc(sdf), w * R n) into the voxel's 32-byte accumulator row
//      with the scatter kernel's warp-aggregated device code
//      (warp_scatter.cuh), marking each touched block slot. grid.sync().
//      Phase B merges and clears the rows of the marked blocks only, with
//      merge_clear.cu's arithmetic, ORs the keyframe bit into `vis` for
//      every row that received a sample, and clears the marks. Rows of an
//      unmarked block have an all-zero accumulator, so the accumulator is
//      all-zero on exit.
//
// What bounds it on an H100: neither bytes nor operations. A golden frame
// needs ~5 MB of the frame's images and a few MB of accumulator traffic
// (~2 us at 3.35 TB/s); the plain walk it replaces ran ~300 small kernels
// and three host syncs for ~1 ms of device work. The design removes the
// launches and syncs: two launches and one 8-byte status read a frame. A
// grid-wide barrier needs every CTA resident: the integrate kernel runs
// only through cudaLaunchCooperativeKernel with the grid the card can hold
// (occupancy x SMs), and refuses to launch otherwise.
//
// Bits: the keys, and so the claim order and every slot id, must equal the
// plain version's on the card bit for bit. The source is built with
// -fmad=false (_build.SOURCE_FLAGS) and applies the plain version's float32
// operations in its order: p = (z + k vs) Rh + t, vi = rint(p * (1/vs))
// with 1/vs rounded to float32 once, floor division for block coordinates,
// and 1 - sdf * (1/T) with 1/T rounded to float32 once, which is what
// PyTorch on the card does for a division by a Python number.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "warp_scatter.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

// The arguments, as the wrapper hands them over: every field is 8 bytes,
// so a ctypes structure of c_void_p / c_int64 / c_double in this order has
// this layout. The doubles hold float32 values exactly.
struct FuseArgs {
  const void* depth;       // f32 [H, W]
  const void* normals;     // f32 [H, W, 3]
  const void* x0;          // f32 [H, W]: the pixel's ray (x0, y0, 1)
  const void* y0;
  const void* n_sq_inv;    // f32 [H, W]: 1 / |(x0, y0, 1)|^2
  const void* R;           // f32 [3, 3] on the device
  const void* t;           // f32 [3]
  const void* directory;   // int32 [dir_dim^3]
  void* cand_mark;         // uint8 [H * W * K], all-zero (claim)
  void* cand_keys;         // int32 [H * W * K] (claim)
  void* status;            // int32 [2]: misses, oob (claim)
  void* acc;               // f32 [num_blocks * B^3, 8] (integrate)
  void* weight;            // f32 [num_blocks, B^3] each
  void* dist;
  void* grad_x;
  void* grad_y;
  void* grad_z;
  void* marks;             // int32 [num_blocks], zero between frames
  const void* num_active;  // int32 []
  void* vis;               // int32 [num_blocks, B^3, vis_words], or null
  int64_t height, width, factor, dir_dim, block_shape, stride, cosine;
  int64_t num_blocks, vis_words, kf_word, kf_bit;
  double vs, inv_vs, trunc, inv_trunc, z_min, z_max, normal_sq_min,
      view_cos_sq;
};

struct Params {
  const float* depth;
  const float* normals;
  const float* x0;
  const float* y0;
  const float* n_sq_inv;
  const float* R;
  const float* t;
  const int32_t* directory;
  uint8_t* cand_mark;
  int32_t* cand_keys;
  int32_t* status;
  float* acc;
  float* weight;
  float* dist;
  float* grad[3];
  int32_t* marks;
  const int32_t* num_active;
  int32_t* vis;
  int64_t n_pix;
  int32_t width, factor, dir_dim, block_shape, vpb, stride, cosine;
  int32_t vis_words, kf_word;
  uint32_t kf_mask;
  int64_t num_blocks;
  float vs, inv_vs, trunc, inv_trunc, z_min, z_max, normal_sq_min,
      view_cos_sq;
};

Params unpack(const FuseArgs& a) {
  Params p;
  p.depth = static_cast<const float*>(a.depth);
  p.normals = static_cast<const float*>(a.normals);
  p.x0 = static_cast<const float*>(a.x0);
  p.y0 = static_cast<const float*>(a.y0);
  p.n_sq_inv = static_cast<const float*>(a.n_sq_inv);
  p.R = static_cast<const float*>(a.R);
  p.t = static_cast<const float*>(a.t);
  p.directory = static_cast<const int32_t*>(a.directory);
  p.cand_mark = static_cast<uint8_t*>(a.cand_mark);
  p.cand_keys = static_cast<int32_t*>(a.cand_keys);
  p.status = static_cast<int32_t*>(a.status);
  p.acc = static_cast<float*>(a.acc);
  p.weight = static_cast<float*>(a.weight);
  p.dist = static_cast<float*>(a.dist);
  p.grad[0] = static_cast<float*>(a.grad_x);
  p.grad[1] = static_cast<float*>(a.grad_y);
  p.grad[2] = static_cast<float*>(a.grad_z);
  p.marks = static_cast<int32_t*>(a.marks);
  p.num_active = static_cast<const int32_t*>(a.num_active);
  p.vis = static_cast<int32_t*>(a.vis);
  p.n_pix = a.height * a.width;
  p.width = static_cast<int32_t>(a.width);
  p.factor = static_cast<int32_t>(a.factor);
  p.dir_dim = static_cast<int32_t>(a.dir_dim);
  p.block_shape = static_cast<int32_t>(a.block_shape);
  p.vpb = p.block_shape * p.block_shape * p.block_shape;
  p.stride = static_cast<int32_t>(a.stride);
  p.cosine = static_cast<int32_t>(a.cosine);
  p.vis_words = static_cast<int32_t>(a.vis_words);
  p.kf_word = static_cast<int32_t>(a.kf_word);
  p.kf_mask = 1u << static_cast<uint32_t>(a.kf_bit & 31);
  p.num_blocks = a.num_blocks;
  p.vs = static_cast<float>(a.vs);
  p.inv_vs = static_cast<float>(a.inv_vs);
  p.trunc = static_cast<float>(a.trunc);
  p.inv_trunc = static_cast<float>(a.inv_trunc);
  p.z_min = static_cast<float>(a.z_min);
  p.z_max = static_cast<float>(a.z_max);
  p.normal_sq_min = static_cast<float>(a.normal_sq_min);
  p.view_cos_sq = static_cast<float>(a.view_cos_sq);
  return p;
}

// The pose, in shared memory (R row-major, then t): read there, it holds
// no registers across the walk.
struct Pose {
  float v[12];
  __device__ __forceinline__ float R(int i) const { return v[i]; }
  __device__ __forceinline__ float t(int i) const { return v[9 + i]; }
};

__device__ __forceinline__ void load_pose(const Params& p, Pose& q) {
  if (threadIdx.x < 9)
    q.v[threadIdx.x] = __ldg(p.R + threadIdx.x);
  else if (threadIdx.x < 12)
    q.v[threadIdx.x] = __ldg(p.t + threadIdx.x - 9);
  __syncthreads();
}

// One pixel's ray (fusion._pixel_rays, then the per-ray part of
// _ray_samples), in the plain version's order of operations.
struct Ray {
  float z;
  float rh[3];   // R h, h = (x0, y0, 1)
  float rn[3];   // R n
  float cos_scale;
};

__device__ __forceinline__ bool pixel_ray(const Params& p, const Pose& q,
                                          int32_t pix, Ray& r) {
  if (pix >= p.n_pix) return false;
  const float z = __ldg(p.depth + pix);
  const float* n = p.normals + 3 * static_cast<int64_t>(pix);
  const float nx = __ldg(n);
  const float ny = __ldg(n + 1);
  const float nz = __ldg(n + 2);
  if (!(isfinite(nx) && isfinite(ny) && isfinite(nz))) return false;
  const float hx = __ldg(p.x0 + pix);
  const float hy = __ldg(p.y0 + pix);
  const float n_sq = (nx * nx + ny * ny) + nz * nz;
  const float ndoth = (nx * hx + ny * hy) + nz;
  if (!(z > p.z_min && z < p.z_max && n_sq >= p.normal_sq_min &&
        (ndoth * ndoth) * __ldg(p.n_sq_inv + pix) >= p.view_cos_sq))
    return false;
  if (p.stride > 1) {
    const int32_t y = pix / p.width;
    const int32_t x = pix - y * p.width;
    if (y % p.stride != 0 || x % p.stride != 0) return false;
  }
  r.z = z;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    r.rh[i] = (q.R(3 * i) * hx + q.R(3 * i + 1) * hy) + q.R(3 * i + 2);
    r.rn[i] = (q.R(3 * i) * nx + q.R(3 * i + 1) * ny) + q.R(3 * i + 2) * nz;
  }
  r.cos_scale = 1.0f;
  if (p.cosine) {
    // |n.h| / max(|n| |h|, 1e-12), clamped to [0.1, 1]
    const float n_norm = sqrtf(n_sq);
    const float h_norm = sqrtf((hx * hx + hy * hy) + 1.0f);
    const float c = fabsf(ndoth) / fmaxf(n_norm * h_norm, 1e-12f);
    r.cos_scale = fminf(fmaxf(c, 0.1f), 1.0f);
  }
  return true;
}

// floor(a / b) for b > 0, as torch.div(..., rounding_mode="floor")
__device__ __forceinline__ int32_t floor_div(int32_t a, int32_t b) {
  const int32_t q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// Sample k (in -factor..factor) of a ray: its packed block key (-1 outside
// the directory's range), its voxel's offset in the block, its weight w
// (w > 0: live) and w * trunc(sdf).
struct Sample {
  int32_t key;
  int32_t local;
  float w;
  float wd;
};

__device__ __forceinline__ Sample walk(const Params& p, const Pose& q,
                                       const Ray& r, int k) {
  const float dk = r.z + static_cast<float>(k) * p.vs;
  int32_t vi[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    vi[i] = __float2int_rz(rintf((dk * r.rh[i] + q.t(i)) * p.inv_vs));
  // projective SDF: column 2 of R dotted with (voxel centre - t), minus z
  float sdf = ((q.R(2) * (static_cast<float>(vi[0]) * p.vs - q.t(0)) +
                q.R(5) * (static_cast<float>(vi[1]) * p.vs - q.t(1))) +
               q.R(8) * (static_cast<float>(vi[2]) * p.vs - q.t(2))) -
              r.z;
  if (p.cosine) sdf = sdf * r.cos_scale;
  Sample s;
  // Sdf.h:76-85; a NaN stays NaN and is not live, as in the plain version
  const float drop = 1.0f - sdf * p.inv_trunc;
  s.w = sdf <= 0.0f ? 1.0f : (drop < 0.0f ? 0.0f : drop);
  s.wd = s.w * fminf(fmaxf(sdf, -p.trunc), p.trunc);
  const int32_t b = p.block_shape;
  const int32_t half = p.dir_dim / 2;
  int32_t bc[3], lc[3];
  bool in_range = true;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    bc[i] = floor_div(vi[i], b);
    lc[i] = vi[i] - bc[i] * b;
    const int32_t c = bc[i] + half;
    in_range = in_range && c >= 0 && c < p.dir_dim;
    bc[i] = c;
  }
  s.local = (lc[2] * b + lc[1]) * b + lc[0];
  s.key = in_range ? (bc[0] * p.dir_dim + bc[1]) * p.dir_dim + bc[2] : -1;
  return s;
}

__global__ void __launch_bounds__(kThreads) fuse_claim(Params p) {
  const int32_t pix = blockIdx.x * kThreads + threadIdx.x;
  __shared__ Pose q;
  load_pose(p, q);
  Ray r;
  const bool valid = pixel_ray(p, q, pix, r);
  int32_t oob = 0;
  int32_t misses = 0;
  if (pix < p.n_pix) {
    const int64_t c0 =
        static_cast<int64_t>(pix) * (2 * p.factor + 1) + p.factor;
    for (int k = -p.factor; valid && k <= p.factor; ++k) {
      const Sample s = walk(p, q, r, k);
      if (!(s.w > 0.0f)) continue;
      if (s.key < 0) {
        ++oob;
      } else if (__ldg(p.directory + s.key) < 0) {
        p.cand_mark[c0 + k] = 1;
        p.cand_keys[c0 + k] = s.key;
        ++misses;
      }
    }
  }
  // every lane of the warp exists (the grid covers whole blocks)
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    oob += __shfl_down_sync(gsdf::kFullMask, oob, off);
    misses += __shfl_down_sync(gsdf::kFullMask, misses, off);
  }
  if ((threadIdx.x & 31) == 0) {
    if (misses) atomicAdd(p.status, misses);
    if (oob) atomicAdd(p.status + 1, oob);
  }
}

// Phase B for one marked block: merge_clear.cu's arithmetic on its rows,
// the keyframe bit for every row that received a sample (its weight sum
// is > 0: every live sample has w > 0), then the rows zeroed.
template <bool WITH_GRAD>
__device__ __forceinline__ void merge_block(const Params& p, int64_t b) {
  for (int j = threadIdx.x; j < p.vpb; j += kThreads) {
    const int64_t r = b * p.vpb + j;
    float4* row = reinterpret_cast<float4*>(p.acc) + 2 * r;
    const float4 a = __ldcg(row);       // w, wd, wn_x, wn_y
    const float4 c = __ldcg(row + 1);   // wn_z, padding
    const float w_old = p.weight[r];
    const float w_new = __fadd_rn(w_old, a.x);
    if (w_new > 0.0f)
      p.dist[r] = __fdiv_rn(__fadd_rn(__fmul_rn(p.dist[r], w_old), a.y),
                            fmaxf(w_new, 1e-30f));
    p.weight[r] = w_new;
    if constexpr (WITH_GRAD) {
      p.grad[0][r] = __fadd_rn(p.grad[0][r], a.z);
      p.grad[1][r] = __fadd_rn(p.grad[1][r], a.w);
      p.grad[2][r] = __fadd_rn(p.grad[2][r], c.x);
    }
    if (p.vis != nullptr && a.x > 0.0f)
      p.vis[r * p.vis_words + p.kf_word] |= static_cast<int32_t>(p.kf_mask);
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    row[0] = zero;
    row[1] = zero;
  }
}

// At least 2 CTAs an SM: with the thread count alone as a bound ptxas
// spilled 4 bytes in both instances (48 and 64 registers); with this one it
// uses 56 and 72 and spills nothing (sm_90a, nvcc of CUDA 12.8).
template <int F>
__global__ void __launch_bounds__(kThreads, 2) fuse_integrate(Params p) {
  // phase A: walk, look up, scatter, mark
  {
    __shared__ Pose q;
    load_pose(p, q);
    const int32_t stride = gridDim.x * kThreads;
    // whole warps stay in the loop (block size and stride are multiples of
    // 32), so every warp-wide step has all 32 lanes
    const int32_t n_up = (static_cast<int32_t>(p.n_pix) + 31) & ~31;
    for (int32_t pix = blockIdx.x * kThreads + threadIdx.x; pix < n_up;
         pix += stride) {
      Ray r;
      const bool valid = pixel_ray(p, q, pix, r);
      if (!__any_sync(gsdf::kFullMask, valid)) continue;
      for (int k = -p.factor; k <= p.factor; ++k) {
        int32_t i = -1;    // the voxel's accumulator row; -1: nothing to add
        int32_t slot = -1;
        float x[F];
#pragma unroll
        for (int f = 0; f < F; ++f) x[f] = 0.0f;
        if (valid) {
          const Sample s = walk(p, q, r, k);
          if (s.w > 0.0f && s.key >= 0) {
            slot = __ldg(p.directory + s.key);
            if (slot >= 0) {
              i = slot * p.vpb + s.local;
              x[0] = s.w;
              x[1] = s.wd;
              if constexpr (F == 5) {
                x[2] = s.w * r.rn[0];
                x[3] = s.w * r.rn[1];
                x[4] = s.w * r.rn[2];
              }
            }
          }
        }
        if (gsdf::warp_aggregate<F>(i, x)) {
          gsdf::reduce_row<F, true>(p.acc + static_cast<int64_t>(i) * 8, x);
          // a stale read only costs a second store of the same 1
          if (p.marks[slot] == 0) p.marks[slot] = 1;
        }
      }
    }
  }
  // every reduction and mark of phase A is in memory past this barrier;
  // phase B reads the accumulator and the marks through the L2 (__ldcg)
  cg::this_grid().sync();
  int64_t active = __ldcg(p.num_active);
  if (active > p.num_blocks) active = p.num_blocks;
  for (int64_t b = blockIdx.x; b < active; b += gridDim.x) {
    // the same value in every thread of the CTA: only this CTA writes it,
    // after the barrier below
    if (__ldcg(p.marks + b) == 0) continue;
    merge_block<F == 5>(p, b);
    __syncthreads();
    if (threadIdx.x == 0) p.marks[b] = 0;
  }
}

__global__ void __launch_bounds__(kThreads) coop_empty() {
  cg::this_grid().sync();
}

// CTAs per SM and SMs of the current device for the integrate kernel with
// F fields, cached per device; 0 CTAs if it cannot be placed.
struct Shape {
  int ctas_per_sm = -1;
  int sms = 0;
  int coop = 0;
};

int shape_of(int nf, Shape& out) {
  static Shape cache[2][16];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  Shape& s = cache[nf == 5 ? 1 : 0][dev & 15];
  if (s.ctas_per_sm < 0) {
    e = cudaDeviceGetAttribute(&s.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&s.coop, cudaDevAttrCooperativeLaunch, dev);
    int n = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, nf == 5 ? fuse_integrate<5> : fuse_integrate<2>, kThreads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    s.ctas_per_sm = n;
  }
  out = s;
  return 0;
}

}  // namespace

// C entry points (bound with ctypes). Each launches on `stream`, does not
// synchronize, and returns the CUDA error of its launch (0 = success).

// The claim pass: zeroes the status, then one thread per pixel. `args`
// points to a FuseArgs.
extern "C" int gsdf_fuse_claim_f32(const void* args, void* stream) {
  const Params p = unpack(*static_cast<const FuseArgs*>(args));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(p.status, 0, 2 * sizeof(int32_t), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (p.n_pix <= 0) return 0;
  const int64_t blocks = (p.n_pix + kThreads - 1) / kThreads;
  fuse_claim<<<dim3(static_cast<unsigned>(blocks)), kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// out[4]: CTAs of the integrate kernel an SM holds, SMs, threads a CTA,
// whether the device takes cooperative launches; for nf = 5 or 2 fields.
extern "C" int gsdf_fuse_integrate_shape(int nf, int* out) {
  Shape s;
  const int e = shape_of(nf, s);
  out[0] = s.ctas_per_sm;
  out[1] = s.sms;
  out[2] = kThreads;
  out[3] = s.coop;
  return e;
}

// The integrate-and-merge pass: one cooperative launch of every CTA the
// card holds. cudaErrorCooperativeLaunchTooLarge if it holds none. `args`
// points to a FuseArgs.
extern "C" int gsdf_fuse_integrate_f32(const void* args, int nf,
                                       void* stream) {
  Params p = unpack(*static_cast<const FuseArgs*>(args));
  Shape s;
  int e = shape_of(nf, s);
  if (e != 0) return e;
  if (s.ctas_per_sm < 1 || !s.coop)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* kargs[] = {&p};
  const dim3 grid(static_cast<unsigned>(s.ctas_per_sm * s.sms));
  const void* fn = nf == 5 ? reinterpret_cast<const void*>(fuse_integrate<5>)
                           : reinterpret_cast<const void*>(fuse_integrate<2>);
  e = static_cast<int>(cudaLaunchCooperativeKernel(
      fn, grid, dim3(kThreads), kargs, 0, static_cast<cudaStream_t>(stream)));
  if (e != 0) return e;
  return static_cast<int>(cudaGetLastError());
}

// The launch floor of the integrate pass: a cooperative launch at its grid
// (nf = 5) of a kernel that only crosses the grid barrier. Used by the
// measurements only, never by the package.
extern "C" int gsdf_fuse_coop_empty(void* stream) {
  Shape s;
  int e = shape_of(5, s);
  if (e != 0) return e;
  if (s.ctas_per_sm < 1 || !s.coop)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const dim3 grid(static_cast<unsigned>(s.ctas_per_sm * s.sms));
  void* none[1] = {nullptr};
  e = static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(coop_empty), grid, dim3(kThreads), none,
      0, static_cast<cudaStream_t>(stream)));
  if (e != 0) return e;
  return static_cast<int>(cudaGetLastError());
}
