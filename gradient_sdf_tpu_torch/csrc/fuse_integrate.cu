// fuse_integrate: one depth frame's fusion on one card, in two launches and
// no host sync — the sample walk, the block claim, the scatter into the
// frame accumulator and the merge into the running voxel state.
//
// Replaces, for single-card fusion, what the JAX package does in
// gradient_sdf_tpu/ops/fusion.py as XLA-fused passes around its one Pallas
// kernel: the pixel gates of `_pixel_rays`, the sample walk of
// `_ray_samples` (:131), the claim and lookups of `_alloc_slots` (:240,
// with `voxel_grid.insert_new`), the scatter of `_scatter_samples` (:330,
// whose Pallas form is scatter_add_multi,
// gradient_sdf_tpu/ops/pallas/scatter_add.py:103), the merge of
// `_merge_accumulators` (:362) and the touched mask of the visibility bits.
//
//   1. fuse_claim: a warp per 8 x 4 pixel tile, the warps of a CTA on tiles
//      spread over the image. It gates the pixels, walks each valid pixel's
//      K = 2 * floor(T / vs) + 1 samples and looks each live sample's block
//      up in the dense directory, two lookups in flight. Candidate c = pixel * K + k (over ALL pixels of the frame,
//      whatever thread walks it) of a live sample whose block is missing
//      gets mark[c] = 1 and keys[c] = its key, and claims its block: the
//      lanes of a warp that miss the same block (__match_any_sync) take
//      their lowest id (__reduce_min_sync) and one atomicMin puts it into
//      claims[key] (int32 [dir_dim^3], INT32_MAX between frames); the
//      atomicMin that finds the entry unclaimed lists the key. A tile with
//      a valid pixel is listed for the integrate pass (one atomic a warp).
//      It counts misses, oob samples, listed tiles and claimed blocks in a
//      four-int status, which nobody reads on the host; the oob count also
//      goes straight into the grid's `oob_samples`.
//   2. fuse_integrate: ONE cooperative launch.
//      Phase 0, only when the status counts claimed blocks (grid-uniform:
//      the previous launch wrote it). A warp a listed block: its winner is
//      the id in its claims entry, and its rank among the winners in
//      candidate order is the number of listed blocks whose winner's id is
//      lower, so winner r takes slot num_active + r: the JAX package's
//      `insert_new` order, with no sort. It writes the directory, coarse
//      occupancy and block coordinates, or sets `overflow` past the
//      capacity. grid.sync(); one thread stores the new block count, and
//      the claims entries go back to INT32_MAX.
//      Phase A: a unit of work is a listed tile's samples k .. k + 3; the
//      warps take the units in turn, walk again, look up (after the claim:
//      through the L2; four lookups in flight) and add (w, w * trunc(sdf),
//      w * R n) into the voxel's 32-byte accumulator row: the lanes merge
//      equal rows in five fixed shuffle steps (`warp_merge`) and each
//      remaining lane sends warp_scatter.cuh's vector reduction, marking
//      the block slot. A sample whose block the claim pass found missing
//      (now new, or dropped past the capacity) clears its candidate mark.
//      grid.sync().
//      Phase B: each CTA reads its share of the block marks in one load a
//      thread, then merges and clears the marked blocks' rows with
//      merge_clear.cu's arithmetic, ORs the keyframe bit into `vis` for
//      every row that received a sample, and clears the marks. Rows of an
//      unmarked block have an all-zero accumulator, so the accumulator is
//      all-zero on exit.
//
// What bounds it on an H100: neither bytes nor operations. A golden frame
// needs ~9 MB of the frame's images and a few MB of accumulator traffic
// (~3 us at 3.35 TB/s). Taken apart by one-switch builds (PERF.md;
// tools/fusion_bench.py --kernels), the earlier design's integrate launch spent nothing measurable on its L2 reductions;
// its phase B (a dependent scan over every active block) and its barrier
// took as long as its walk, and its block claim ran on the host. This
// design hands out the claimed blocks from their list (no scan of the
// candidates, no sort, one extra barrier), merges only the marked blocks
// after one load a thread, and walks only the listed tiles, spread over
// every warp; it does not pre-aggregate the reductions in shared memory.
// The walk is latency-bound: a unit waits for its tile's images, then its
// lookups, then its merges. A grid-wide barrier needs every CTA resident:
// the integrate kernel runs only through cudaLaunchCooperativeKernel with
// the grid the card can hold (occupancy x SMs), and refuses to launch
// otherwise.
//
// Bits: the keys, and so the claim order and every slot id, must equal the
// plain version's on the card bit for bit. The source is built with
// -fmad=false (_build.SOURCE_FLAGS) and applies the plain version's float32
// operations in its order: p = (z + k vs) Rh + t, vi = rint(p * (1/vs))
// with 1/vs rounded to float32 once, floor division for block coordinates,
// and 1 - sdf * (1/T) with 1/T rounded to float32 once, which is what
// PyTorch on the card does for a division by a Python number.

#include <climits>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "warp_scatter.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// a warp's pixel tile, lane l at (l % 8, l / 8); the tiles are numbered in
// 32 x 32 super tiles (4 x 8 tiles, row by row), the super tiles row by row
constexpr int kTileW = 8, kTileH = 4, kSuperW = 4, kSuperH = 8;
// samples of a ray walked, and their lookups issued, together (the claim
// pass, the integrate pass)
constexpr int kClaimAhead = 2, kAhead = 4;
constexpr int kCoarse = 4;   // blocks per coarse occupancy cell edge
// the status: misses, oob samples, tiles with a valid pixel, claimed blocks
constexpr int kStatus = 4;

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
  void* directory;         // int32 [dir_dim^3]
  void* coarse_occ;        // int32 [(dir_dim / 4)^3]
  void* block_coords;      // int32 [num_blocks, 3]
  void* num_active;        // int32 []
  void* overflow;          // bool []
  void* oob_samples;       // int32 []
  void* claims;            // int32 [dir_dim^3], INT32_MAX between frames
  void* cand_mark;         // uint8 [H * W * K], all-zero between frames
  void* cand_keys;         // int32 [H * W * K]
  void* tiles;             // int32: the warp tiles with a valid pixel
  void* new_keys;          // int32: the keys the claim pass claimed
  void* status;            // int32 [kStatus]
  void* acc;               // f32 [num_blocks * B^3, 8] (integrate)
  void* weight;            // f32 [num_blocks, B^3] each
  void* dist;
  void* grad_x;
  void* grad_y;
  void* grad_z;
  void* marks;             // int32 [num_blocks], zero between frames
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
  int32_t* directory;
  int32_t* coarse_occ;
  int32_t* block_coords;
  int32_t* num_active;
  uint8_t* overflow;
  int32_t* oob_samples;
  int32_t* claims;
  uint8_t* cand_mark;
  int32_t* cand_keys;
  int32_t* tiles;
  int32_t* new_keys;
  int32_t* status;
  float* acc;
  float* weight;
  float* dist;
  float* grad[3];
  int32_t* marks;
  int32_t* vis;
  int32_t height, width, supers_x, n_tiles, factor, dir_dim, block_shape,
      vpb, stride, cosine;
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
  p.directory = static_cast<int32_t*>(a.directory);
  p.coarse_occ = static_cast<int32_t*>(a.coarse_occ);
  p.block_coords = static_cast<int32_t*>(a.block_coords);
  p.num_active = static_cast<int32_t*>(a.num_active);
  p.overflow = static_cast<uint8_t*>(a.overflow);
  p.oob_samples = static_cast<int32_t*>(a.oob_samples);
  p.claims = static_cast<int32_t*>(a.claims);
  p.cand_mark = static_cast<uint8_t*>(a.cand_mark);
  p.cand_keys = static_cast<int32_t*>(a.cand_keys);
  p.tiles = static_cast<int32_t*>(a.tiles);
  p.new_keys = static_cast<int32_t*>(a.new_keys);
  p.status = static_cast<int32_t*>(a.status);
  p.acc = static_cast<float*>(a.acc);
  p.weight = static_cast<float*>(a.weight);
  p.dist = static_cast<float*>(a.dist);
  p.grad[0] = static_cast<float*>(a.grad_x);
  p.grad[1] = static_cast<float*>(a.grad_y);
  p.grad[2] = static_cast<float*>(a.grad_z);
  p.marks = static_cast<int32_t*>(a.marks);
  p.vis = static_cast<int32_t*>(a.vis);
  p.height = static_cast<int32_t>(a.height);
  p.width = static_cast<int32_t>(a.width);
  const int32_t sw = kTileW * kSuperW, sh = kTileH * kSuperH;
  p.supers_x = (p.width + sw - 1) / sw;
  p.n_tiles = p.supers_x * ((p.height + sh - 1) / sh) * kSuperW * kSuperH;
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

// The pixel of `lane` in warp tile `w` (module note); false outside the
// image.
__device__ __forceinline__ bool tile_pixel(const Params& p, int32_t w,
                                           int lane, int32_t& pix) {
  const int32_t s = w / (kSuperW * kSuperH);
  const int32_t in = w - s * (kSuperW * kSuperH);
  const int32_t sy = s / p.supers_x;
  const int32_t x = ((s - sy * p.supers_x) * kSuperW + in % kSuperW) * kTileW +
                    lane % kTileW;
  const int32_t y = (sy * kSuperH + in / kSuperW) * kTileH + lane / kTileW;
  pix = y * p.width + x;
  return w < p.n_tiles && x < p.width && y < p.height;
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

// Partial warp aggregation in fixed steps, for rows that lanes of one
// tile share: at step s (1, 2, 4, 8, 16) a lane whose bit s is clear takes
// the sums of lane + s when both still hold the same destination, and
// lane + s drops it. A destination that fills an aligned block of lanes
// (2 x 1, 4 x 1, 8 x 1, 8 x 2 or 8 x 4 pixels of the tile) ends in one
// lane; one that straddles blocks in a few. Called by all 32 lanes; `i` is
// the lane's destination row, -1 for nothing to add. Returns true in each
// lane that still holds a destination; its `x` then holds its sums. Five
// steps of F + 2 shuffles: cheaper, measured, than the group-by-group
// shuffle loop of warp_scatter.cuh's warp_aggregate, whose turns grow with
// the lanes a row has (up to 16 in a tile).
template <int F>
__device__ __forceinline__ bool warp_merge(int32_t& i, float (&x)[F]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int step = 1; step < 32; step <<= 1) {
    const int32_t up = __shfl_down_sync(gsdf::kFullMask, i, step);
    const int32_t down = __shfl_up_sync(gsdf::kFullMask, i, step);
    const bool take = (lane & step) == 0 && i >= 0 && up == i;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const float y = __shfl_down_sync(gsdf::kFullMask, x[f], step);
      if (take) x[f] += y;
    }
    if ((lane & step) != 0 && i >= 0 && down == i) i = -1;
  }
  return i >= 0;
}

__global__ void __launch_bounds__(kThreads) fuse_claim(Params p) {
  __shared__ Pose q;
  load_pose(p, q);
  const int lane = threadIdx.x & 31;
  // a CTA's warps take tiles spread over the image, so that a patch of
  // valid pixels lands on many CTAs and SMs
  const int32_t w = (threadIdx.x >> 5) * gridDim.x + blockIdx.x;
  int32_t pix;
  const bool inside = tile_pixel(p, w, lane, pix);
  Ray r;
  const bool valid = inside && pixel_ray(p, q, pix, r);
  // a tile with a valid pixel is listed for the integrate pass; the
  // atomic's answer is waited for only at the end
  const bool listed = __any_sync(gsdf::kFullMask, valid);
  int32_t at = 0;
  if (listed && lane == 0) at = atomicAdd(p.status + 2, 1);
  int32_t oob = 0;
  int32_t misses = 0;
  if (listed) {
    const int32_t c0 = valid ? pix * (2 * p.factor + 1) + p.factor : 0;
    for (int k0 = -p.factor; k0 <= p.factor; k0 += kClaimAhead) {
      int32_t key[kClaimAhead];
      int32_t slot[kClaimAhead];
#pragma unroll
      for (int j = 0; j < kClaimAhead; ++j) {
        key[j] = -1;
        slot[j] = 0;
        if (valid && k0 + j <= p.factor) {
          const Sample s = walk(p, q, r, k0 + j);
          if (s.w > 0.0f) {
            if (s.key < 0)
              ++oob;
            else
              key[j] = s.key;
          }
        }
        if (key[j] >= 0) slot[j] = __ldg(p.directory + key[j]);
      }
      // the lanes that miss one block claim it once, with their lowest
      // id: claim[j] is the block this lane claims for step j, lo[j] the id
      int32_t claim[kClaimAhead];
      int32_t lo[kClaimAhead];
#pragma unroll
      for (int j = 0; j < kClaimAhead; ++j) {
        claim[j] = -1;
        // a live sample whose block is missing
        const int32_t miss = slot[j] < 0 ? key[j] : -1;
        if (!__any_sync(gsdf::kFullMask, miss >= 0)) continue;
        const int32_t c = c0 + k0 + j;
        if (miss >= 0) {
          p.cand_mark[c] = 1;
          p.cand_keys[c] = miss;
          ++misses;
        }
        const unsigned peers = __match_any_sync(gsdf::kFullMask, miss);
        lo[j] = __reduce_min_sync(peers, miss >= 0 ? c : INT_MAX);
        if (miss >= 0 && lane == __ffs(peers) - 1) claim[j] = miss;
      }
      // the claims go out together; the one that finds its block unclaimed
      // lists the key
      int32_t old[kClaimAhead];
#pragma unroll
      for (int j = 0; j < kClaimAhead; ++j)
        old[j] = claim[j] >= 0 ? atomicMin(p.claims + claim[j], lo[j]) : 0;
#pragma unroll
      for (int j = 0; j < kClaimAhead; ++j)
        if (claim[j] >= 0 && old[j] == INT_MAX)
          p.new_keys[atomicAdd(p.status + 3, 1)] = claim[j];
    }
  }
  if (listed && lane == 0) p.tiles[at] = w;
  misses = __reduce_add_sync(gsdf::kFullMask, misses);
  oob = __reduce_add_sync(gsdf::kFullMask, oob);
  if (lane == 0) {
    if (misses) atomicAdd(p.status, misses);
    if (oob) {
      atomicAdd(p.status + 1, oob);
      atomicAdd(p.oob_samples, oob);
    }
  }
}

// Phase 0 (module note): each claimed block's winner, the lowest
// candidate id in its claims entry, takes slot na + its rank among the
// winners in candidate order, or sets `overflow` past the capacity. A warp
// a block: its lanes count the winners with a lower id. Every thread of the
// grid calls it; `na` is the block count before the frame.
__device__ void hand_out(const Params& p, int32_t n_new, int32_t na) {
  const int lane = threadIdx.x & 31;
  const int32_t warps = gridDim.x * kWarps;
  const int32_t D = p.dir_dim;
  const int32_t C = D / kCoarse;
  const int32_t half = D / 2;
  for (int32_t i = blockIdx.x * kWarps + (threadIdx.x >> 5); i < n_new;
       i += warps) {
    const int32_t key = __ldcg(p.new_keys + i);
    const int32_t c = __ldcg(p.claims + key);
    int32_t rank = 0;
    for (int32_t j = lane; j < n_new; j += 32)
      rank += __ldcg(p.claims + __ldcg(p.new_keys + j)) < c;
    const int64_t slot =
        na + static_cast<int64_t>(__reduce_add_sync(gsdf::kFullMask, rank));
    if (lane == 0 && slot >= p.num_blocks) *p.overflow = 1;
    if (lane == 0 && slot < p.num_blocks) {
      const int32_t kz = key % D;
      const int32_t ky = (key / D) % D;
      const int32_t kx = key / (D * D);
      p.directory[key] = static_cast<int32_t>(slot);
      p.coarse_occ[((kx / kCoarse) * C + ky / kCoarse) * C + kz / kCoarse] = 1;
      int32_t* bc = p.block_coords + 3 * slot;
      bc[0] = kx - half;
      bc[1] = ky - half;
      bc[2] = kz - half;
    }
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

// At least 2 CTAs an SM: with the thread count alone as a bound, ptxas
// spilled a few bytes of an earlier version.
template <int F>
__global__ void __launch_bounds__(kThreads, 2) fuse_integrate(Params p) {
  __shared__ Pose q;
  __shared__ int32_t list[kThreads];
  __shared__ int32_t n_list;
  cg::grid_group grid = cg::this_grid();
  // grid-uniform, and read before any thread writes them: the claim
  // pass's listed tiles and claimed blocks, the block count before
  const int32_t n_tiles = __ldcg(p.status + 2);
  const int32_t n_new = __ldcg(p.status + 3);
  const int32_t na = __ldcg(p.num_active);
  load_pose(p, q);
  int64_t active = na < p.num_blocks ? na : p.num_blocks;
  if (n_new > 0) {
    // phase 0: the frame's new blocks get their slots
    hand_out(p, n_new, na);
    const int64_t room = p.num_blocks > na ? p.num_blocks - na : 0;
    active = na + (n_new < room ? n_new : room);
    grid.sync();
    if (blockIdx.x == 0 && threadIdx.x == 0)
      *p.num_active = static_cast<int32_t>(active);
    for (int32_t i = blockIdx.x * kThreads + threadIdx.x; i < n_new;
         i += gridDim.x * kThreads)
      p.claims[__ldcg(p.new_keys + i)] = INT_MAX;
  }

  // phase A: walk the valid pixels, look up, scatter, mark. A unit of work
  // is a listed tile's samples k0 .. k0 + kAhead - 1.
  {
    const int lane = threadIdx.x & 31;
    const int32_t steps = (2 * p.factor + kAhead) / kAhead;
    const int32_t units = n_tiles * steps;
    for (int32_t u = blockIdx.x * kWarps + (threadIdx.x >> 5); u < units;
         u += gridDim.x * kWarps) {
      const int k0 = -p.factor + (u % steps) * kAhead;
      int32_t pix;
      Ray r;
      const bool valid = tile_pixel(p, __ldcg(p.tiles + u / steps), lane, pix) &&
                         pixel_ray(p, q, pix, r);
      Sample s[kAhead];
      int32_t slot[kAhead];
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        slot[j] = -1;
        s[j].key = -1;   // -1: no live sample in the directory's range
        if (valid && k0 + j <= p.factor) {
          s[j] = walk(p, q, r, k0 + j);
          if (!(s[j].w > 0.0f)) s[j].key = -1;
          // phase 0 wrote the directory in this launch: read it through the
          // L2
          if (s[j].key >= 0)
            slot[j] = n_new > 0 ? __ldcg(p.directory + s[j].key)
                                : __ldg(p.directory + s[j].key);
        }
      }
      // a sample whose block the claim pass found missing (new, or dropped
      // past the capacity): its mark goes back to 0. After every lookup is
      // issued: a byte store may alias the directory for the compiler.
#pragma unroll
      for (int j = 0; j < kAhead; ++j)
        if (n_new > 0 && s[j].key >= 0 && (slot[j] < 0 || slot[j] >= na))
          p.cand_mark[pix * (2 * p.factor + 1) + p.factor + k0 + j] = 0;
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        int32_t i = -1;   // the voxel's accumulator row; -1: nothing to add
        float x[F];
#pragma unroll
        for (int f = 0; f < F; ++f) x[f] = 0.0f;
        if (slot[j] >= 0) {
          i = slot[j] * p.vpb + s[j].local;
          x[0] = s[j].w;
          x[1] = s[j].wd;
          if constexpr (F == 5) {
            x[2] = s[j].w * r.rn[0];
            x[3] = s[j].w * r.rn[1];
            x[4] = s[j].w * r.rn[2];
          }
        }
        if (warp_merge<F>(i, x)) {
          gsdf::reduce_row<F, true>(p.acc + static_cast<int64_t>(i) * 8, x);
          p.marks[slot[j]] = 1;   // a store: waiting for a read costs more
        }
      }
    }
  }
  // every reduction and mark of phase A is in memory past this barrier;
  // phase B reads the accumulator and the marks through the L2 (__ldcg)
  grid.sync();

  // phase B: this CTA's share of the blocks (b = blockIdx.x mod gridDim.x),
  // a block mark a thread, the marked ones merged one after another
  const int64_t span = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t base = 0; base < active; base += span) {
    if (threadIdx.x == 0) n_list = 0;
    __syncthreads();
    const int64_t b =
        base + static_cast<int64_t>(threadIdx.x) * gridDim.x + blockIdx.x;
    if (b < active && __ldcg(p.marks + b) != 0)
      list[atomicAdd(&n_list, 1)] = static_cast<int32_t>(b);
    __syncthreads();
    const int32_t n = n_list;
    for (int32_t j = 0; j < n; ++j) merge_block<F == 5>(p, list[j]);
    if (threadIdx.x < n) p.marks[list[threadIdx.x]] = 0;
    __syncthreads();
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

// The claim pass: zeroes the status, then a warp per 8 x 4 pixel tile.
// `args` points to a FuseArgs.
extern "C" int gsdf_fuse_claim_f32(const void* args, void* stream) {
  const Params p = unpack(*static_cast<const FuseArgs*>(args));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(p.status, 0, kStatus * sizeof(int32_t), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (p.n_tiles <= 0) return 0;
  const int64_t blocks = (p.n_tiles + kWarps - 1) / kWarps;
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
  const int ctas = s.ctas_per_sm * s.sms;
  if (s.ctas_per_sm < 1 || !s.coop)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* kargs[] = {&p};
  const void* fn = nf == 5 ? reinterpret_cast<const void*>(fuse_integrate<5>)
                           : reinterpret_cast<const void*>(fuse_integrate<2>);
  e = static_cast<int>(cudaLaunchCooperativeKernel(
      fn, dim3(static_cast<unsigned>(ctas)), dim3(kThreads), kargs, 0,
      static_cast<cudaStream_t>(stream)));
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
