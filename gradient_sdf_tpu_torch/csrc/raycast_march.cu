// raycast_march: sphere-trace rays through the block-sparse SDF until their
// first zero crossing, then tighten and interpolate the crossing's bracket.
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
// directory). This kernel reads `directory`, `coarse_occ`, `dist` and
// `weight` themselves: the same values, nothing to build, and `coarse_occ`
// is touched only where the directory says "no block".
//
// What holds it on an H100, and what the design does about it. Measured
// with tools/raycast_bench.py (no profiler of the card's counters works
// where it was measured): one ray per thread is a serial chain of ~20
// probes, and the kernel's time follows the instructions the SMs must
// issue per probe. A first version spent ~500 SASS instructions in its
// march loop (IEEE divisions in the DDA, runtime integer divisions for the
// block coordinate, 64-bit indices, a DDA per branch) and used ~2/3 of the
// card's issue slots; putting any one of those back into this version slowed
// it about in proportion to the instructions it added, while halving the
// warps an SM holds (48 -> 24) cost only ~12% (PERF.md). So the design
// cuts issued instructions:
//   * block shape and coarse factor are template parameters: a block
//     coordinate is an arithmetic right shift (floor division for negative
//     voxels too), the offset in the block a mask; other shapes keep an
//     instance with runtime divisors (`pick`);
//   * the DDA multiplies by reciprocals taken once per ray (1/d) and once
//     per grid (1/cell): no division in the loop; an axis the ray runs
//     parallel to carries a NaN reciprocal that fminf drops;
//   * one DDA per probe, on the lattice the probe's outcome names;
//   * int32 keys and voxel indices (the wrapper checks that they fit);
//   * the probe has no branches: the directory's answer predicates either
//     the coarse_occ gather or the dist and weight gathers, so a warp whose
//     lanes got both answers issues both gathers together instead of in
//     two passes;
//   * 128-thread blocks of 8 x 4 pixel tiles per warp when the rays are an
//     image: a warp's rays start close together and end at similar depths
//     (0.94 of its lanes probe while its slowest ray does, 0.87 for a row
//     of 32 pixels), and small blocks leave less of a tail.
// Measured and not kept (PERF.md): two rays per thread (more
// independent gathers per thread) was slower, as the registers it needs
// halve the warps an SM holds; so were a probe that branches on the
// directory's answer and 256-thread blocks.
//
// Rounding: the voxel a probe reads is decided by rint((o + s d) / vs), and
// one ulp at a voxel plane reads the neighbour and can bracket another
// crossing. This file is therefore compiled with -fmad=false (the build
// passes it for this source alone): every expression below is a sequence of
// IEEE float32 multiplies, adds and divides in the order the plain PyTorch
// version applies them, and the two agree bit for bit. It must not be built
// with --use_fast_math either: the DDA relies on inf and NaN arithmetic.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
// A warp marches an 8 x 4 tile of pixels; a block four such tiles across.
constexpr int kWarpW = 8, kWarpH = 4, kTilesX = 4;
constexpr int kBlockW = kWarpW * kTilesX;
constexpr int kBlockH = kWarpH * (kThreads / 32 / kTilesX);

struct Params {
  int dir_dim;        // directory cells per axis
  int block_shape;    // voxels per block edge (read by the generic instance)
  int coarse_factor;  // blocks per coarse cell edge (likewise)
  float vs, inv_vs;   // voxel size and its float32 reciprocal
  float trunc;        // truncation distance T
  float step_min;     // 0.25 vs
  float half_step;    // 0.5 step_min
  float half_vox;     // 0.5 vs
  float block_m, inv_block_m;    // block edge in metres, its reciprocal
  float coarse_m, inv_coarse_m;  // coarse cell edge in metres, likewise
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

// One ray and what the DDA needs of it, computed once per ray.
struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float rx, ry, rz;  // 1 / d, NaN where |d| <= 1e-12 (that axis has no plane)
  float ux, uy, uz;  // 1 where d > 0, else 0: which plane of the cell is next
};

struct Probe {
  float val;      // dist where observed, else 0
  bool observed;  // allocated block and weight > 0 (and a finite dist)
  bool present;   // allocated block
  bool coarse;    // the coarse cell holds some block
};

// floor(a / 2^kLog2) or, for kLog2 < 0, floor(a / n). An arithmetic right
// shift is floor division for negative a too.
template <int kLog2>
__device__ __forceinline__ int floor_div(int a, int n) {
  if constexpr (kLog2 >= 0) {
    return a >> kLog2;
  } else {
    int q = a / n;
    if (a - q * n < 0) q -= 1;
    return q;
  }
}

// a - q * edge for q = floor_div(a): a mask for a power of two.
template <int kLog2>
__device__ __forceinline__ int floor_mod(int a, int q, int n) {
  if constexpr (kLog2 >= 0) {
    return a & ((1 << kLog2) - 1);
  } else {
    return a - q * n;
  }
}

// The probe at (px, py, pz). Without branches: the directory's answer
// decides, by predicate, whether coarse_occ or dist and weight are read.
template <int kLogB, int kLogF, bool kStats>
__device__ __forceinline__ Probe probe(const Grid& g, const Params& p,
                                       const Stats& st, float px, float py,
                                       float pz, int& sectors) {
  const int b = kLogB >= 0 ? 1 << kLogB : p.block_shape;
  const int F = kLogF >= 0 ? 1 << kLogF : p.coarse_factor;
  const int D = p.dir_dim, half = D >> 1, C = floor_div<kLogF>(D, F);
  const int vx = __float2int_rn(px * p.inv_vs);  // rint: half to even
  const int vy = __float2int_rn(py * p.inv_vs);
  const int vz = __float2int_rn(pz * p.inv_vs);
  const int bx = floor_div<kLogB>(vx, b), by = floor_div<kLogB>(vy, b),
            bz = floor_div<kLogB>(vz, b);
  const int xs = bx + half, ys = by + half, zs = bz + half;
  const bool inside = static_cast<unsigned>(xs) < static_cast<unsigned>(D) &&
                      static_cast<unsigned>(ys) < static_cast<unsigned>(D) &&
                      static_cast<unsigned>(zs) < static_cast<unsigned>(D);
  const int local = (floor_mod<kLogB>(vz, bz, b) * b +
                     floor_mod<kLogB>(vy, by, b)) * b +
                    floor_mod<kLogB>(vx, bx, b);
  // int32: the wrapper checks that every key and voxel index fits
  const int key = (xs * D + ys) * D + zs;
  const int ckey = (floor_div<kLogF>(xs, F) * C + floor_div<kLogF>(ys, F)) * C +
                   floor_div<kLogF>(zs, F);
  Probe r = {0.0f, false, false, false};
  const int32_t slot = inside ? g.directory[key] : -1;
  const bool empty = inside && slot < 0;
  r.present = slot >= 0;
  const int lin = (r.present ? slot : 0) * (b * b * b) + local;
  const int32_t occ = empty ? g.coarse_occ[ckey] : 0;
  const float w = r.present ? g.weight[lin] : 0.0f;
  const float d = r.present ? g.dist[lin] : 0.0f;
  r.coarse = r.present || occ > 0;
  r.observed = r.present && w > 0.0f && isfinite(d);
  r.val = r.observed ? d : 0.0f;
  if (kStats) {
    if (inside) {
      sectors += 1;
      st.touched[key >> 3] = 1;
    }
    if (empty) {
      sectors += 1;
      st.touched[st.off_coarse + (ckey >> 3)] = 1;
    }
    if (r.present) {
      sectors += 2;
      st.touched[st.off_dist + (lin >> 3)] = 1;
      st.touched[st.off_weight + (lin >> 3)] = 1;
    }
  }
  return r;
}

// Distance along the ray to the next plane of one axis: NaN where the ray
// runs parallel to it (r = NaN).
__device__ __forceinline__ float dda_axis(float p, float r, float u, float cell,
                                          float inv_cell, float half_vox) {
  const float b = floorf((p + half_vox) * inv_cell);
  const float bound = (b + u) * cell;
  return (bound - p - half_vox) * r;
}

// Distance along the ray to its next plane of a lattice of pitch `cell`.
// Voxel i spans [i vs - vs/2, i vs + vs/2), so the planes sit at
// k cell - vs/2. fminf drops the NaN of an axis the ray runs parallel to;
// non-positive distances (and all-NaN) become inf, then the result is nudged
// past the plane by half a minimum step.
__device__ __forceinline__ float dda(const Params& p, const Ray& ray, float px,
                                     float py, float pz, float cell,
                                     float inv_cell) {
  float out = dda_axis(px, ray.rx, ray.ux, cell, inv_cell, p.half_vox);
  out = fminf(out, dda_axis(py, ray.ry, ray.uy, cell, inv_cell, p.half_vox));
  out = fminf(out, dda_axis(pz, ray.rz, ray.uz, cell, inv_cell, p.half_vox));
  out = out > 0.0f ? out : INFINITY;
  return fmaxf(out + p.half_step, p.step_min);
}

// Ray parameter of the point closest to the centre of the voxel that holds
// o + s d (directions are unit vectors).
__device__ __forceinline__ float s_of_center(const Params& p, const Ray& r,
                                             float s) {
  const float cx = rintf((r.ox + s * r.dx) * p.inv_vs) * p.vs;
  const float cy = rintf((r.oy + s * r.dy) * p.inv_vs) * p.vs;
  const float cz = rintf((r.oz + s * r.dz) * p.inv_vs) * p.vs;
  return (cx - r.ox) * r.dx + (cy - r.oy) * r.dy + (cz - r.oz) * r.dz;
}

__device__ __forceinline__ float inv_or_nan(float d) {
  return fabsf(d) > 1e-12f ? 1.0f / d : NAN;
}

// One ray's march state.
struct March {
  Ray ray;
  float end, s, s_prev, v_prev, lo, hi, v_lo, v_hi;
  bool v_prev_ok, v_lo_ok, found;
  int probes, sectors;
};

__device__ __forceinline__ void start(March& m, const float* __restrict__ origins,
                                      const float* __restrict__ dirs,
                                      const float* __restrict__ s0,
                                      const float* __restrict__ s_end, int64_t i) {
  Ray& ray = m.ray;
  ray.ox = origins[3 * i], ray.oy = origins[3 * i + 1], ray.oz = origins[3 * i + 2];
  ray.dx = dirs[3 * i], ray.dy = dirs[3 * i + 1], ray.dz = dirs[3 * i + 2];
  ray.rx = inv_or_nan(ray.dx), ray.ry = inv_or_nan(ray.dy), ray.rz = inv_or_nan(ray.dz);
  ray.ux = ray.dx > 0.0f ? 1.0f : 0.0f;
  ray.uy = ray.dy > 0.0f ? 1.0f : 0.0f;
  ray.uz = ray.dz > 0.0f ? 1.0f : 0.0f;
  m.end = s_end[i];
  m.s = s0[i];
  m.s_prev = m.s, m.v_prev = 0.0f, m.v_prev_ok = false;
  m.lo = m.s, m.hi = m.s, m.v_lo = 0.0f, m.v_hi = 0.0f;
  m.v_lo_ok = false, m.found = false;
  m.probes = 0, m.sectors = 0;
}

// After a probe at (px, py, pz): the crossing, or the step to the next probe.
__device__ __forceinline__ void advance(March& m, const Probe& r, const Params& p,
                                        float px, float py, float pz) {
  m.probes += 1;
  if (r.observed && r.val >= 0.0f) {
    m.lo = m.s_prev; m.hi = m.s;
    m.v_lo = m.v_prev; m.v_hi = r.val;
    m.v_lo_ok = m.v_prev_ok;
    m.found = true;
    return;
  }
  // one DDA per probe, on the lattice the probe's outcome names
  const float cell = r.observed ? p.vs : r.coarse ? p.block_m : p.coarse_m;
  const float inv_cell = r.observed ? p.inv_vs
                         : r.coarse ? p.inv_block_m : p.inv_coarse_m;
  const float t = dda(p, m.ray, px, py, pz, cell, inv_cell);
  const float step = r.observed ? fmaxf(fminf(-r.val, p.trunc), t)
                     : r.present ? p.trunc : t;
  m.s_prev = m.s; m.v_prev = r.val; m.v_prev_ok = r.observed;
  m.s = m.s + step;
}

// Bisection and secant of a ray that crossed; the outputs of ray i.
template <int kLogB, int kLogF, bool kStats>
__device__ __forceinline__ void finish(March& m, const Grid& g, const Params& p,
                                       const Stats& st, int64_t i,
                                       uint8_t* __restrict__ found_out,
                                       float* __restrict__ s_mid_out,
                                       float* __restrict__ s_star_out) {
  float s_mid = 0.0f, s_star = 0.0f;
  const Ray& ray = m.ray;
  if (m.found) {
    float lo = m.lo, hi = m.hi, v_lo = m.v_lo, v_hi = m.v_hi;
    bool v_lo_ok = m.v_lo_ok;
    s_mid = 0.5f * (lo + hi);
    for (int k = 0; k < p.bisect_steps; ++k) {
      const float mid = 0.5f * (lo + hi);
      const Probe r = probe<kLogB, kLogF, kStats>(
          g, p, st, ray.ox + mid * ray.dx, ray.oy + mid * ray.dy,
          ray.oz + mid * ray.dz, m.sectors);
      m.probes += 1;
      if (!r.observed || r.val < 0.0f) {  // still in free space
        lo = mid; v_lo = r.val; v_lo_ok = r.observed;
      } else {
        hi = mid; v_hi = r.val;
      }
    }
    // secant between the bracket voxels' centre projections where both end
    // values are usable, the bracket's midpoint otherwise
    const float s_lo_c = s_of_center(p, ray, lo);
    const float s_hi_c = s_of_center(p, ray, hi);
    const float dv = v_hi - v_lo;
    const bool use_sec = v_lo_ok && v_lo < 0.0f && v_hi >= 0.0f && dv > 1e-12f &&
                         s_hi_c > s_lo_c;
    s_star = use_sec ? s_lo_c + (s_hi_c - s_lo_c) * (-v_lo) / dv
                     : 0.5f * (lo + hi);
  }
  found_out[i] = m.found ? 1 : 0;
  s_mid_out[i] = s_mid;
  s_star_out[i] = s_star;
  if (kStats) {
    st.per_ray[2 * i] = m.probes;
    st.per_ray[2 * i + 1] = m.sectors;
  }
}

// Rays [0, n). width == 0: thread t of the launch takes ray t. width > 0:
// the rays are the pixels of a row-major image `width` pixels wide, and each
// warp takes an 8 x 4 tile of them, so that its rays start close together,
// probe the same blocks and end at similar depths.
template <int kLogB, int kLogF, bool kStats>
__global__ void __launch_bounds__(kThreads)
march_rays(const float* __restrict__ origins, const float* __restrict__ dirs,
           const float* __restrict__ s0, const float* __restrict__ s_end,
           Grid g, Params p, uint8_t* __restrict__ found_out,
           float* __restrict__ s_mid_out, float* __restrict__ s_star_out,
           Stats st, int64_t n, int width) {
  int64_t i;
  if (width > 0) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int x = blockIdx.x * kBlockW + (warp % kTilesX) * kWarpW + lane % kWarpW;
    const int64_t y = static_cast<int64_t>(blockIdx.y) * kBlockH +
                      (warp / kTilesX) * kWarpH + lane / kWarpW;
    i = x < width ? y * width + x : n;
  } else {
    i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  }
  if (i >= n) return;
  March m;
  start(m, origins, dirs, s0, s_end, i);
  for (int k = 0; k < p.max_steps && m.s <= m.end; ++k) {
    const Ray& ray = m.ray;
    const float px = ray.ox + m.s * ray.dx;
    const float py = ray.oy + m.s * ray.dy;
    const float pz = ray.oz + m.s * ray.dz;
    const Probe r = probe<kLogB, kLogF, kStats>(g, p, st, px, py, pz, m.sectors);
    advance(m, r, p, px, py, pz);
    if (m.found) break;
  }
  finish<kLogB, kLogF, kStats>(m, g, p, st, i, found_out, s_mid_out, s_star_out);
}

typedef void (*MarchKernel)(const float*, const float*, const float*,
                            const float*, Grid, Params, uint8_t*, float*,
                            float*, Stats, int64_t, int);

// The instance for a block shape and coarse factor: shifts and masks for the
// power-of-two block shapes 2..32 with the coarse factor 4, runtime divisors
// for every other pair.
template <bool kStats>
MarchKernel pick(int block_shape, int coarse_factor) {
  if (coarse_factor == 4) {
    switch (block_shape) {
      case 2: return march_rays<1, 2, kStats>;
      case 4: return march_rays<2, 2, kStats>;
      case 8: return march_rays<3, 2, kStats>;
      case 16: return march_rays<4, 2, kStats>;
      case 32: return march_rays<5, 2, kStats>;
      default: break;
    }
  }
  return march_rays<-1, -1, kStats>;
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
// width > 0: the rays are a row-major image of that width (n a multiple of
// it), marched in 8 x 4 pixel tiles; 0: in the order given. Every directory
// key and voxel index must fit in an int32 (the wrapper checks). Launches on
// `stream`, does not synchronize, and returns cudaGetLastError() of the
// launch (0 = success).
extern "C" int gsdf_raycast_march_f32(
    const void* origins, const void* dirs, const void* s0, const void* s_end,
    const void* directory, const void* coarse_occ, const void* dist,
    const void* weight, void* found, void* s_mid, void* s_star, void* stats,
    void* touched, int64_t n, int64_t num_blocks, int width, int dir_dim,
    int block_shape, int coarse_factor, float vs, float inv_vs, float trunc,
    float step_min, float half_step, float half_vox, float block_m,
    float inv_block_m, float coarse_m, float inv_coarse_m, int max_steps,
    int bisect_steps, void* stream) {
  if (n <= 0) return 0;
  if ((stats == nullptr) != (touched == nullptr)) return cudaErrorInvalidValue;
  if (width < 0 || (width > 0 && n % width != 0)) return cudaErrorInvalidValue;
  Grid g = {static_cast<const int32_t*>(directory),
            static_cast<const int32_t*>(coarse_occ),
            static_cast<const float*>(dist), static_cast<const float*>(weight)};
  Params p = {dir_dim, block_shape, coarse_factor, vs, inv_vs, trunc,
              step_min, half_step, half_vox, block_m, inv_block_m, coarse_m,
              inv_coarse_m, max_steps, bisect_steps};
  const int64_t D = dir_dim, C = dir_dim / coarse_factor;
  const int64_t nvox = num_blocks * block_shape * block_shape * block_shape;
  Stats st = {static_cast<int32_t*>(stats), static_cast<uint8_t*>(touched), 0, 0, 0};
  st.off_coarse = (D * D * D + 7) / 8;
  st.off_dist = st.off_coarse + (C * C * C + 7) / 8;
  st.off_weight = st.off_dist + (nvox + 7) / 8;
  dim3 grid;
  if (width > 0) {
    const int64_t height = n / width;
    const int64_t gy = (height + kBlockH - 1) / kBlockH;
    if (gy > 65535) return cudaErrorInvalidValue;
    grid = dim3(static_cast<unsigned>((width + kBlockW - 1) / kBlockW),
                static_cast<unsigned>(gy));
  } else {
    grid = dim3(static_cast<unsigned>((n + kThreads - 1) / kThreads));
  }
  MarchKernel kernel = stats != nullptr ? pick<true>(block_shape, coarse_factor)
                                        : pick<false>(block_shape, coarse_factor);
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(origins), static_cast<const float*>(dirs),
      static_cast<const float*>(s0), static_cast<const float*>(s_end), g, p,
      static_cast<uint8_t*>(found), static_cast<float*>(s_mid),
      static_cast<float*>(s_star), st, n, width);
  return static_cast<int>(cudaGetLastError());
}
