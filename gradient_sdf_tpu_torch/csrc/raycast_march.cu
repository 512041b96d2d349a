// raycast_march: sphere-trace one ray per thread through the block-sparse
// SDF until its first zero crossing, then tighten and interpolate the
// crossing's bracket.
//
// Replaces the march of the JAX package's renderer, which has no TPU kernel
// of its own: `_march` and the bisection and secant of `_refine` in
// gradient_sdf_tpu/ops/raycast.py (:178-244, :426-477) are a `lax.while_loop`
// over whole ray arrays that XLA compiles. There every iteration costs the
// array's full width for as long as the slowest ray lives, which is why that
// code compacts survivors into narrower buffers between rounds. A CUDA
// thread ends with its own ray, so none of that is here: one loop per ray,
// at most `max_steps` probes, then `bisect_steps` halvings and the
// centre-projected secant, and the thread is done.
//
// Per probe at p = o + s d:
//   voxel = rint(p / vs), block = floor(voxel / B), key = directory index;
//   outside the directory's range         -> coarse-empty;
//   directory[key] < 0                    -> coarse_occ of the 4^3-block cell
//                                            says block-empty or coarse-empty;
//   directory[key] = slot >= 0            -> (dist, weight) of the voxel,
//                                            observed iff weight > 0.
// Step: observed -> max(min(-dist, T), distance to the next voxel plane);
// allocated but unobserved -> T; else the distance to the next block or
// coarse-cell plane (the DDA below). A crossing is the first observed probe
// with dist >= 0; its bracket is (previous probe, this probe).
//
// The JAX renderer first builds two transient arrays per render (a
// dist-or-inf field over every voxel and the coarse mip upsampled into the
// directory, 4 bytes per voxel and per directory cell). This kernel reads
// `directory`, `coarse_occ`, `dist` and `weight` themselves: the same
// values, nothing to build, and `coarse_occ` is touched only where the
// directory says "no block".
//
// What bounds it on an H100: neither of the roofline's two sides. A probe is
// ~100 arithmetic, compare and select operations (six of them IEEE
// divisions in the DDA) and one to three dependent gathers. Neighbouring
// threads are neighbouring pixels of an image row, so a warp's probes fall
// into the same few blocks: the distinct sectors a VGA pass touches are a few
// MB, less than the ray state that is read and written once, and every
// further gather is an L1/L2 hit. Bytes and operations both bound the work
// at a few microseconds; the kernel takes an order of magnitude longer
// because each ray is a serial chain of probes, each waiting for its
// gathers, with one to two waves of warps to hide that behind. Warps diverge
// little (a warp's lanes are mostly still probing while its slowest ray
// does), so rebalancing rays is not what would help first; untried
// candidates are more independent work per thread (two rays, or the next
// probe's directory read started early) and reciprocals of d computed once
// per ray where the plain version can do the same. Left simple on purpose.
//
// Rounding: the voxel a probe reads is decided by rint((o + s d) / vs), and
// one ulp at a voxel plane reads the neighbour and can bracket another
// crossing. This file is therefore compiled with -fmad=false (the build
// passes it for this source alone): every expression below is a sequence of
// IEEE float32 multiplies, adds and divides in the order the plain PyTorch
// version applies them, and the two agree bit for bit. It must not be built
// with --use_fast_math either: the DDA relies on inf arithmetic.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct Params {
  int dir_dim;        // directory cells per axis
  int block_shape;    // voxels per block edge
  int coarse_factor;  // blocks per coarse cell edge
  float vs, inv_vs;   // voxel size and its float32 reciprocal
  float trunc;        // truncation distance T
  float step_min;     // 0.25 vs
  float half_step;    // 0.5 step_min
  float half_vox;     // 0.5 vs
  float block_m;      // block edge in metres
  float coarse_m;     // coarse cell edge in metres
  int max_steps, bisect_steps;
};

struct Grid {
  const int32_t* __restrict__ directory;
  const int32_t* __restrict__ coarse_occ;
  const float* __restrict__ dist;
  const float* __restrict__ weight;
};

// What a `stats` launch records besides the result: per ray its probes and
// the 32-byte sectors they gathered, and for the launch one byte per sector
// of directory, coarse_occ, dist and weight (in this order), set to 1 where
// any probe read it. Arrays are assumed 32-byte aligned.
struct Stats {
  int32_t* __restrict__ per_ray;  // [n, 2]
  uint8_t* __restrict__ touched;  // [off_weight + sectors of weight]
  int64_t off_coarse, off_dist, off_weight;
};

struct Probe {
  float val;      // dist where observed, else 0
  bool observed;  // allocated block and weight > 0 (and a finite dist)
  bool present;   // allocated block
  bool coarse;    // the coarse cell holds some block
};

__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  if (a - q * b < 0) q -= 1;
  return q;
}

template <bool kStats>
__device__ __forceinline__ Probe probe(const Grid& g, const Params& p,
                                       const Stats& st, float px, float py,
                                       float pz, int& sectors) {
  const int b = p.block_shape, D = p.dir_dim, half = D / 2;
  const int vx = static_cast<int>(rintf(px * p.inv_vs));
  const int vy = static_cast<int>(rintf(py * p.inv_vs));
  const int vz = static_cast<int>(rintf(pz * p.inv_vs));
  const int bx = floor_div(vx, b), by = floor_div(vy, b), bz = floor_div(vz, b);
  const int xs = bx + half, ys = by + half, zs = bz + half;
  Probe r = {0.0f, false, false, false};
  if (xs < 0 || xs >= D || ys < 0 || ys >= D || zs < 0 || zs >= D) return r;
  const int64_t key = (static_cast<int64_t>(xs) * D + ys) * D + zs;
  const int32_t slot = g.directory[key];
  if (kStats) {
    sectors += 1;
    st.touched[key >> 3] = 1;
  }
  if (slot < 0) {
    const int F = p.coarse_factor, C = D / F;
    const int64_t ckey = (static_cast<int64_t>(xs / F) * C + ys / F) * C + zs / F;
    r.coarse = g.coarse_occ[ckey] > 0;
    if (kStats) {
      sectors += 1;
      st.touched[st.off_coarse + (ckey >> 3)] = 1;
    }
    return r;
  }
  r.present = true;
  r.coarse = true;
  const int local = ((vz - bz * b) * b + (vy - by * b)) * b + (vx - bx * b);
  const int64_t lin = static_cast<int64_t>(slot) * (b * b * b) + local;
  const float w = g.weight[lin];
  const float d = g.dist[lin];
  if (kStats) {
    sectors += 2;
    st.touched[st.off_dist + (lin >> 3)] = 1;
    st.touched[st.off_weight + (lin >> 3)] = 1;
  }
  if (w > 0.0f && isfinite(d)) {
    r.observed = true;
    r.val = d;
  }
  return r;
}

__device__ __forceinline__ float dda_axis(float p, float d, float cell,
                                          float half_vox) {
  const float b = floorf((p + half_vox) / cell);
  const float bound = d > 0.0f ? (b + 1.0f) * cell : b * cell;
  return fabsf(d) > 1e-12f ? (bound - p - half_vox) / d : INFINITY;
}

// Distance along the ray to its next plane of a lattice of pitch `cell`.
// Voxel i spans [i vs - vs/2, i vs + vs/2), so the planes sit at
// k cell - vs/2. Non-positive distances become inf, then the result is
// nudged past the plane by half a minimum step.
__device__ __forceinline__ float dda(const Params& p, float px, float py,
                                     float pz, float dx, float dy, float dz,
                                     float cell) {
  float out = dda_axis(px, dx, cell, p.half_vox);
  out = fminf(out, dda_axis(py, dy, cell, p.half_vox));
  out = fminf(out, dda_axis(pz, dz, cell, p.half_vox));
  out = out > 0.0f ? out : INFINITY;
  return fmaxf(out + p.half_step, p.step_min);
}

// Ray parameter of the point closest to the centre of the voxel that holds
// o + s d (directions are unit vectors).
__device__ __forceinline__ float s_of_center(const Params& p, float s, float ox,
                                             float oy, float oz, float dx,
                                             float dy, float dz) {
  const float cx = rintf((ox + s * dx) * p.inv_vs) * p.vs;
  const float cy = rintf((oy + s * dy) * p.inv_vs) * p.vs;
  const float cz = rintf((oz + s * dz) * p.inv_vs) * p.vs;
  return (cx - ox) * dx + (cy - oy) * dy + (cz - oz) * dz;
}

template <bool kStats>
__global__ void __launch_bounds__(256)
march_rays(const float* __restrict__ origins, const float* __restrict__ dirs,
           const float* __restrict__ s0, const float* __restrict__ s_end,
           Grid g, Params p, uint8_t* __restrict__ found_out,
           float* __restrict__ s_mid_out, float* __restrict__ s_star_out,
           Stats st, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ox = origins[3 * i], oy = origins[3 * i + 1], oz = origins[3 * i + 2];
  const float dx = dirs[3 * i], dy = dirs[3 * i + 1], dz = dirs[3 * i + 2];
  const float end = s_end[i];
  float s = s0[i];
  float s_prev = s, v_prev = 0.0f;
  bool v_prev_ok = false;
  float lo = s, hi = s, v_lo = 0.0f, v_hi = 0.0f;
  bool v_lo_ok = false, found = false;
  int probes = 0, sectors = 0;

  for (int k = 0; k < p.max_steps && !found && s <= end; ++k) {
    const float px = ox + s * dx, py = oy + s * dy, pz = oz + s * dz;
    const Probe r = probe<kStats>(g, p, st, px, py, pz, sectors);
    probes += 1;
    if (r.observed && r.val >= 0.0f) {
      lo = s_prev; hi = s;
      v_lo = v_prev; v_hi = r.val;
      v_lo_ok = v_prev_ok;
      found = true;
      break;
    }
    float step;
    if (r.observed) {
      step = fmaxf(fminf(-r.val, p.trunc), dda(p, px, py, pz, dx, dy, dz, p.vs));
    } else if (r.present) {
      step = p.trunc;
    } else {
      step = dda(p, px, py, pz, dx, dy, dz, r.coarse ? p.block_m : p.coarse_m);
    }
    s_prev = s; v_prev = r.val; v_prev_ok = r.observed;
    s = s + step;
  }

  float s_mid = 0.0f, s_star = 0.0f;
  if (found) {
    s_mid = 0.5f * (lo + hi);
    for (int k = 0; k < p.bisect_steps; ++k) {
      const float mid = 0.5f * (lo + hi);
      const Probe r = probe<kStats>(g, p, st, ox + mid * dx, oy + mid * dy,
                                    oz + mid * dz, sectors);
      probes += 1;
      if (!r.observed || r.val < 0.0f) {  // still in free space
        lo = mid; v_lo = r.val; v_lo_ok = r.observed;
      } else {
        hi = mid; v_hi = r.val;
      }
    }
    // secant between the bracket voxels' centre projections where both end
    // values are usable, the bracket's midpoint otherwise
    const float s_lo_c = s_of_center(p, lo, ox, oy, oz, dx, dy, dz);
    const float s_hi_c = s_of_center(p, hi, ox, oy, oz, dx, dy, dz);
    const float dv = v_hi - v_lo;
    const bool use_sec = v_lo_ok && v_lo < 0.0f && v_hi >= 0.0f && dv > 1e-12f &&
                         s_hi_c > s_lo_c;
    s_star = use_sec ? s_lo_c + (s_hi_c - s_lo_c) * (-v_lo) / dv
                     : 0.5f * (lo + hi);
  }
  found_out[i] = found ? 1 : 0;
  s_mid_out[i] = s_mid;
  s_star_out[i] = s_star;
  if (kStats) {
    st.per_ray[2 * i] = probes;
    st.per_ray[2 * i + 1] = sectors;
  }
}

}  // namespace

// C entry point (bound with ctypes). origins, dirs: f32 [n, 3]; s0, s_end:
// f32 [n]; directory: i32 [dir_dim^3]; coarse_occ: i32
// [(dir_dim / coarse_factor)^3]; dist, weight: f32 [num_blocks,
// block_shape^3]; found: one byte per ray (0 or 1) [n]; s_mid, s_star: f32
// [n]. stats: i32 [n, 2] (probes, 32-byte sectors gathered) and touched: one
// zeroed byte per 32-byte sector of directory, coarse_occ, dist, weight
// (each array's count rounded up), both given or both null: with them the
// counting instance of the kernel runs, without them the plain one.
// Launches on `stream`, does not synchronize, and returns
// cudaGetLastError() of the launch (0 = success).
extern "C" int gsdf_raycast_march_f32(
    const void* origins, const void* dirs, const void* s0, const void* s_end,
    const void* directory, const void* coarse_occ, const void* dist,
    const void* weight, void* found, void* s_mid, void* s_star, void* stats,
    void* touched, int64_t n, int64_t num_blocks, int dir_dim, int block_shape, int coarse_factor, float vs,
    float inv_vs, float trunc, float step_min, float half_step, float half_vox,
    float block_m, float coarse_m, int max_steps, int bisect_steps,
    void* stream) {
  if (n <= 0) return 0;
  Grid g = {static_cast<const int32_t*>(directory),
            static_cast<const int32_t*>(coarse_occ),
            static_cast<const float*>(dist), static_cast<const float*>(weight)};
  Params p = {dir_dim, block_shape, coarse_factor, vs, inv_vs, trunc, step_min,
              half_step, half_vox, block_m, coarse_m, max_steps, bisect_steps};
  const int64_t blocks = (n + 255) / 256;
  const int64_t D = dir_dim, C = dir_dim / coarse_factor;
  const int64_t nvox = num_blocks * block_shape * block_shape * block_shape;
  Stats st = {static_cast<int32_t*>(stats), static_cast<uint8_t*>(touched), 0, 0, 0};
  st.off_coarse = (D * D * D + 7) / 8;
  st.off_dist = st.off_coarse + (C * C * C + 7) / 8;
  st.off_weight = st.off_dist + (nvox + 7) / 8;
  if ((stats == nullptr) != (touched == nullptr)) return cudaErrorInvalidValue;
  auto kernel = stats != nullptr ? march_rays<true> : march_rays<false>;
  kernel<<<dim3(static_cast<unsigned>(blocks)), 256, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(origins), static_cast<const float*>(dirs),
      static_cast<const float*>(s0), static_cast<const float*>(s_end), g, p,
      static_cast<uint8_t*>(found), static_cast<float*>(s_mid),
      static_cast<float*>(s_star), st, n);
  return static_cast<int>(cudaGetLastError());
}
