// gn_track: the Gauss-Newton tracking loop of one frame, as one kernel.
//
// Replaces the JAX package's jitted `lax.while_loop`
// (gradient_sdf_tpu/models/tracker.py:201-233): its cond `k < num_iterations
// & ~converged`, and its body, the residual pass `_residual_pass` (:80-107,
// with `query.tsdf_grad` or `query.tsdf_trilinear`), the 6x6 solve, the
// flags and the gated se3 update (:206-226). None of it has a TPU kernel
// there; XLA compiles the loop into one device program and the host reads
// nothing per iteration. So does this kernel.
//
//   gn_track_loop<MODE, BS>: the grid is ONE thread-block cluster of
//     kClusterCtas CTAs x kThreads threads, launched with cudaLaunchKernelEx
//     (its CTAs are co-scheduled, so a cluster barrier is safe, and each can
//     read the others' shared memory). Per iteration, up to num_iterations:
//     1. every thread walks its compacted depth points (as many as the
//        count that the compaction, track_compact.cu, left in device
//        memory: no host read between the two) with the cluster's
//        thread count as stride, kBatch points at a time (their 12 loads
//        issued before any is used): p = R x + t, the SDF query of MODE
//        (GRAD: the nearest voxel's dist plus the stored gradient's
//        first-order correction; TRILINEAR: the 8 corners, counted only
//        where all 8 are observed), the residual's phi and J = [grad,
//        p x grad], and the 29 sums (E, g(6), the upper triangle of H (21),
//        the count) in registers;
//     2. a warp-shuffle tree and shared memory reduce them to the CTA's
//        partial, in a fixed order (`cta_sum`);
//     3. cluster barrier;
//     4. in EVERY CTA 29 threads read the CTAs' partials through
//        distributed shared memory, in rank order, and add them; one warp
//        runs the step (`gn_solve_update`: H + 1e-12 I, LU with partial
//        pivoting in float32, xi = damping x the solution, small = xi.xi <
//        conv_sq, bad = any(isnan(xi)), and where neither (R, t) <-
//        exp(-xi) (R, t)) on the CTA's copy of the pose. The same inputs
//        and the same code give every CTA the same bits, so no CTA waits for
//        a leader's result: one cluster barrier an iteration, where a
//        leader that broadcasts its step needs two. The partials take turns
//        between two buffers, so a CTA that runs ahead into the next
//        iteration does not overwrite what a slower one still reads.
//     The loop ends when `small` is set, as JAX's cond does; a NaN step is
//     skipped and the loop goes on. A last cluster barrier keeps every
//     CTA's shared memory alive until no other CTA reads it; then CTA 0
//     writes R and t in place and the status [small, bad, E, count,
//     iterations] once. No float atomics
//     and no global partials: the same inputs give the same bits on every
//     run, which the 1e-3 stopping rule needs (a last-bit difference in the
//     sums can change the iteration count).
//     With do_step = 0 and one iteration the same kernel is the one-pass
//     launch `gn_residual_reduce` of a mesh rank: the 29 sums out, over a
//     slot window [slot_lo, slot_hi) that restricts the query to the blocks
//     the rank owns (its fields hold only those rows; on one card the window
//     is every slot), for the all_reduce and `gn_step` that follow.
//   gn_step: one warp runs `gn_solve_update` on the 29 sums (the mesh's
//     step after its all_reduce) and writes the 16-byte status (small, bad,
//     E, count). The loop kernel calls the same device function, so the two
//     cannot drift.
//
// What bounds it on an H100: not bytes (a VGA frame's pass reads ~0.7 MB,
// 12 bytes a point plus the directory and field sectors its points hit, all
// in the 50 MB L2 after the first iteration) and not operations (~150 a
// point). What the previous design paid was launches and host round trips:
// two launches from Python and a 16-byte read per iteration, ~0.25 ms of
// host time against ~0.015 ms of device work, and inside its residual
// kernel a two-level reduction through global partials and an atomic ticket
// that took 0.0072 of its 0.0107 ms (PERF.md). Inside one launch what is
// left is each iteration's fixed cost (the CTA reduction, one cluster
// barrier, the step's chain of ~400 dependent float32 operations) and each
// point's chain of three dependent loads (the point, the directory, the
// fields). One cluster keeps the barrier cheap (no grid-wide sync, no
// cooperative launch), the step's elimination runs a row to a lane, and the
// loads of kBatch points go out together; the price is that one cluster
// uses kClusterCtas of the 132 SMs, so a frame with many more points than
// threads walks them serially (PERF.md records the full-frame time). The
// app's block shape is compiled in (shifts and masks where a run-time shape
// divides).
//
// Rounding: a point within an ulp of a voxel plane reads the neighbouring
// voxel, so the voxel choice must follow the plain version's arithmetic
// exactly. This file is compiled with -fmad=false (see _build.SOURCE_FLAGS):
// every expression is a sequence of IEEE float32 multiplies, adds, divides
// and square roots in the order the plain PyTorch version applies them, so
// each residual's voxel, phi and J equal the plain version's bit for bit;
// only the order of the sums differs. Do not build it with --use_fast_math.

#include <cmath>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kSums = 29;          // E, g(6), H upper triangle (21), count
constexpr int kClusterCtas = 16;   // one cluster: 16 CTAs on 16 SMs
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// points whose loads a thread issues together: 4 in grad mode, 1 in
// trilinear mode (at 2 its instance for run-time block shapes spilled
// registers at kThreads threads)
template <int MODE>
constexpr int kBatchOf = MODE == 0 ? 4 : 1;
// the app's block shape, compiled with shifts and masks; any other shape
// takes the instances that divide by g.block_shape at run time
constexpr int kFixedBlock = 8;

enum Mode { kGrad = 0, kTrilinear = 1 };

struct Grid {
  const int32_t* __restrict__ directory;
  const float* __restrict__ dist;
  const float* __restrict__ weight;
  const float* __restrict__ grad_x;
  const float* __restrict__ grad_y;
  const float* __restrict__ grad_z;
  int dir_dim, half, block_shape, voxels_per_block, slot_lo, slot_hi;
  float vs, grad_scale;
};

// floor(a / b) for b > 0: voxel indices may be negative
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// Index into the (windowed) fields of voxel (x, y, z), or -1 where its block
// is outside the directory's range (voxel_grid.pack_key_xyz), not allocated,
// or outside the slot window. BS = kFixedBlock: the block shape as a
// constant (an arithmetic shift is the floor division, a mask its
// remainder); BS = 0: g.block_shape at run time. Integer arithmetic: both
// give the same rows.
template <int BS>
__device__ __forceinline__ int voxel_row(const Grid& g, int x, int y, int z) {
  int bx, by, bz, local;
  if constexpr (BS == kFixedBlock) {
    constexpr int s = 3, m = BS - 1;
    static_assert(BS == 1 << s, "kFixedBlock is 2^s");
    bx = x >> s;
    by = y >> s;
    bz = z >> s;
    local = ((z & m) * BS + (y & m)) * BS + (x & m);
  } else {
    const int b = g.block_shape;
    bx = floor_div(x, b);
    by = floor_div(y, b);
    bz = floor_div(z, b);
    local = ((z - bz * b) * b + (y - by * b)) * b + (x - bx * b);
  }
  const int xs = bx + g.half, ys = by + g.half, zs = bz + g.half;
  const int D = g.dir_dim;
  if (xs < 0 || xs >= D || ys < 0 || ys >= D || zs < 0 || zs >= D) return -1;
  const int slot = __ldg(g.directory + (xs * D + ys) * D + zs);
  if (slot < 0 || slot < g.slot_lo || slot >= g.slot_hi) return -1;
  return (slot - g.slot_lo) * g.voxels_per_block + local;
}

// J[3..5] = p x J[0..2], in torch.linalg.cross's component order
__device__ __forceinline__ void cross_rows(const float p[3], float J[6]) {
  J[3] = p[1] * J[2] - p[2] * J[1];
  J[4] = p[2] * J[0] - p[0] * J[2];
  J[5] = p[0] * J[1] - p[1] * J[0];
}

// query.tsdf_grad at p; false where the residual does not count
template <int BS>
__device__ __forceinline__ bool grad_residual(const Grid& g, const float p[3],
                                              float& phi, float J[6]) {
  const int vx = __float2int_rn(p[0] / g.vs);
  const int vy = __float2int_rn(p[1] / g.vs);
  const int vz = __float2int_rn(p[2] / g.vs);
  const int row = voxel_row<BS>(g, vx, vy, vz);
  if (row < 0) return false;
  const float w = __ldg(g.weight + row);
  if (!(w > 0.0f)) return false;
  const float d = __ldg(g.dist + row);
  const float gx = __ldg(g.grad_x + row), gy = __ldg(g.grad_y + row),
              gz = __ldg(g.grad_z + row);
  const float norm = sqrtf(gx * gx + gy * gy + gz * gz);
  // torch.clamp(norm, min=1e-12) keeps a NaN
  const float s = g.grad_scale * (1.0f / (norm < 1e-12f ? 1e-12f : norm));
  const float c0 = static_cast<float>(vx) * g.vs - p[0];
  const float c1 = static_cast<float>(vy) * g.vs - p[1];
  const float c2 = static_cast<float>(vz) * g.vs - p[2];
  phi = d + s * (gx * c0 + gy * c1 + gz * c2);
  J[0] = s * gx;
  J[1] = s * gy;
  J[2] = s * gz;
  cross_rows(p, J);
  return true;
}

__device__ __forceinline__ float clamp01(float x) {
  return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);
}

// query.tsdf_trilinear at p; counts only where all 8 corners are observed
// (its -T and 0 branches never reach the sums). The corners are summed in
// meshgrid(indexing="ij") order, as the plain version sums them.
template <int BS>
__device__ __forceinline__ bool trilinear_residual(const Grid& g,
                                                   const float p[3],
                                                   float& phi, float J[6]) {
  const float q0 = p[0] / g.vs, q1 = p[1] / g.vs, q2 = p[2] / g.vs;
  const int b0 = static_cast<int>(floorf(q0));
  const int b1 = static_cast<int>(floorf(q1));
  const int b2 = static_cast<int>(floorf(q2));
  const float fx = clamp01(q0 - static_cast<float>(b0));
  const float fy = clamp01(q1 - static_cast<float>(b1));
  const float fz = clamp01(q2 - static_cast<float>(b2));
  float ph = 0.0f, sx = 0.0f, sy = 0.0f, sz = 0.0f;
  // unrolled where the block shape is a constant; the run-time divisions
  // of the other instance leave no registers for eight corners at once
#pragma unroll(BS == 0 ? 1 : 8)
  for (int c = 0; c < 8; ++c) {
    const int ox = c >> 2, oy = (c >> 1) & 1, oz = c & 1;
    const int row = voxel_row<BS>(g, b0 + ox, b1 + oy, b2 + oz);
    if (row < 0) return false;
    const float w = __ldg(g.weight + row);
    if (!(w > 0.0f)) return false;
    const float d = __ldg(g.dist + row);
    const float wx = ox ? fx : 1.0f - fx;
    const float wy = oy ? fy : 1.0f - fy;
    const float wz = oz ? fz : 1.0f - fz;
    const float wxy = wx * wy;
    ph = ph + wxy * wz * d;
    sx = sx + (ox ? wy : -wy) * wz * d;
    sy = sy + (oy ? wx : -wx) * wz * d;
    sz = sz + (oz ? wxy : -wxy) * d;
  }
  phi = ph;
  J[0] = sx / g.vs;
  J[1] = sy / g.vs;
  J[2] = sz / g.vs;
  cross_rows(p, J);
  return true;
}

// Sum v[k] over the CTA's threads, in a fixed order: a shuffle tree in each
// warp, then the warps in order. Thread k < kSums returns the k-th total;
// `smem` holds kWarps x kSums floats.
__device__ __forceinline__ float cta_sum(float v[kSums], float* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) smem[warp * kSums + k] = v[k];
  }
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x < kSums) {
    total = smem[threadIdx.x];
    for (int w = 1; w < kWarps; ++w) total += smem[w * kSums + threadIdx.x];
  }
  __syncthreads();   // smem may be written again by the caller's next sum
  return total;
}

// One residual's terms into the 29 sums
__device__ __forceinline__ void accumulate(float acc[kSums], float phi,
                                           const float J[6]) {
  acc[0] += phi * phi;
#pragma unroll
  for (int a = 0; a < 6; ++a) acc[1 + a] += phi * J[a];
  int k = 7;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int b = a; b < 6; ++b) acc[k++] += J[a] * J[b];
  }
  acc[kSums - 1] += 1.0f;
}

// utils/se3.so3 hat(w) @ hat(w), as a 3x3 product
__device__ __forceinline__ void hat_sq(const float W[3][3], float W2[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      W2[i][j] = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
}

// One GN step from the 29 sums, by the 32 lanes of one warp: the system
// H + 1e-12 I, g, as models/tracker.gauss_newton forms it, solved by LU with
// partial pivoting in float32 (what torch.linalg.solve does); xi = damping x
// the solution; small = xi.xi < conv_sq, bad = any(isnan(xi)) (the same in
// every lane); where neither is set, lane 0 sets (R, t) <- exp(-xi) (R, t)
// in place. R (row-major 3x3) and t may lie in global or shared memory.
// Lane i < 6 holds row i of the system in registers, and each elimination
// step updates the rows below the pivot in parallel; every element goes
// through the same float32 operations in the same order as in a serial LU,
// so the bits are the serial LU's.
__device__ __forceinline__ void gn_solve_update(const float* sums, float* R,
                                                float* t, float damping,
                                                float conv_sq, bool& small,
                                                bool& bad) {
  const unsigned int all = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int i = lane < 6 ? lane : 0;   // lanes 6-31 mirror row 0, unused
  float a[6];
#pragma unroll
  for (int b = 0; b < 6; ++b) {
    const int lo = i < b ? i : b, hi = i < b ? b : i;
    const int k = 7 + lo * 6 - lo * (lo - 1) / 2 + (hi - lo);   // TRIU order
    a[b] = sums[k] + (i == b ? 1e-12f : 0.0f);
  }
  float xr = sums[1 + i];
  // LU with partial pivoting (the first largest |pivot|, as isamax picks),
  // the forward substitution carried along
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    // every lane scans column c as a serial LU does: the same pivot in all
    float col[6];
#pragma unroll
    for (int r = c; r < 6; ++r) col[r] = __shfl_sync(all, a[c], r);
    int piv = c;
    float best = fabsf(col[c]);
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
      if (fabsf(col[r]) > best) {
        best = fabsf(col[r]);
        piv = r;
      }
    }
    if (piv != c) {   // the same in every lane: rows c and piv trade places
      const int from = lane == c ? piv : (lane == piv ? c : lane);
#pragma unroll
      for (int b = 0; b < 6; ++b) a[b] = __shfl_sync(all, a[b], from);
      xr = __shfl_sync(all, xr, from);
    }
    float prow[6];
#pragma unroll
    for (int b = c; b < 6; ++b) prow[b] = __shfl_sync(all, a[b], c);
    const float px = __shfl_sync(all, xr, c);
    if (lane > c && lane < 6) {
      const float l = a[c] / prow[c];
#pragma unroll
      for (int b = c + 1; b < 6; ++b) a[b] = a[b] - l * prow[b];
      xr = xr - l * px;
    }
  }
  // the back substitution, serial, on the rows gathered into every lane
  float U[6][6], x[6];
#pragma unroll
  for (int r = 0; r < 6; ++r) {
#pragma unroll
    for (int b = r; b < 6; ++b) U[r][b] = __shfl_sync(all, a[b], r);
    x[r] = __shfl_sync(all, xr, r);
  }
#pragma unroll
  for (int r = 5; r >= 0; --r) {
    float s = x[r];
#pragma unroll
    for (int j = r + 1; j < 6; ++j) s = s - U[r][j] * x[j];
    x[r] = s / U[r][r];
  }
  float xi[6], sq = 0.0f;
  bad = false;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    xi[a] = damping * x[a];
    sq = sq + xi[a] * xi[a];
    bad = bad || xi[a] != xi[a];   // isnan
  }
  small = sq < conv_sq;
  if (lane == 0 && !small && !bad) {
    // se3_exp(-xi): twist [v, w], R = I + a W + b W^2, t = (I + b W + c W^2) v
    const float v[3] = {-xi[0], -xi[1], -xi[2]};
    const float w[3] = {-xi[3], -xi[4], -xi[5]};
    const float theta_sq = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
    float fa, fb, fc;
    if (theta_sq < 1e-8f) {   // _sinc_factors' Taylor branch
      fa = 1.0f - theta_sq / 6.0f;
      fb = 0.5f - theta_sq / 24.0f;
      fc = static_cast<float>(1.0 / 6.0) - theta_sq / 120.0f;
    } else {
      const float theta = sqrtf(theta_sq < 1e-16f ? 1e-16f : theta_sq);
      const float sin_t = sinf(theta);
      fa = sin_t / theta;
      fb = (1.0f - cosf(theta)) / theta_sq;
      fc = (theta - sin_t) / (theta_sq * theta);
    }
    const float W[3][3] = {{0.0f, -w[2], w[1]},
                           {w[2], 0.0f, -w[0]},
                           {-w[1], w[0], 0.0f}};
    float W2[3][3], dR[3][3], V[3][3], dt[3];
    hat_sq(W, W2);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float eye = i == j ? 1.0f : 0.0f;
        dR[i][j] = eye + fa * W[i][j] + fb * W2[i][j];
        V[i][j] = eye + fb * W[i][j] + fc * W2[i][j];
      }
    }
#pragma unroll
    for (int i = 0; i < 3; ++i)
      dt[i] = V[i][0] * v[0] + V[i][1] * v[1] + V[i][2] * v[2];
    // (R, t) <- (dR R, dR t + dt)
    float Rn[9], tn[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
        Rn[3 * i + j] = dR[i][0] * R[j] + dR[i][1] * R[3 + j] + dR[i][2] * R[6 + j];
      tn[i] = dR[i][0] * t[0] + dR[i][1] * t[1] + dR[i][2] * t[2] + dt[i];
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) R[k] = Rn[k];
#pragma unroll
    for (int i = 0; i < 3; ++i) t[i] = tn[i];
  }
}

// A CTA's shared state. `part` is the CTA's partial sums, twice: the
// iterations take turns, so that a CTA can write the next iteration's
// partial while another still reads this one's; `total` the sums over the
// cluster, `pose` (R row-major, then t) and `flags` (small, bad) the CTA's
// copy of the loop's state, the same bits in every CTA.
struct LoopShared {
  float red[kWarps * kSums];
  float part[2][kSums];
  float total[kSums];
  float pose[12];
  int flags[2];
};

template <int MODE, int BS>
__global__ void __launch_bounds__(kThreads)
gn_track_loop(const float* __restrict__ pts, int64_t n_cap,
              const int* __restrict__ n_dev, float* R, float* t, Grid g,
              float* __restrict__ status, float* __restrict__ sums,
              int num_iterations, int do_step, float damping, float conv_sq) {
  __shared__ LoopShared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned int rank = cluster.block_rank();
  const int tid = threadIdx.x;
  // the point count: the compaction's, in device memory, where it left one
  const int64_t n_got = n_dev == nullptr ? n_cap : __ldg(n_dev);
  const int64_t n = n_got < n_cap ? n_got : n_cap;
  if (tid < 9) sh.pose[tid] = R[tid];
  else if (tid < 12) sh.pose[tid] = t[tid - 9];
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(kClusterCtas) * kThreads;
  int iters = 0;
  for (;;) {
    float r[9], tt[3];
#pragma unroll
    for (int k = 0; k < 9; ++k) r[k] = sh.pose[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) tt[k] = sh.pose[9 + k];
    float acc[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) acc[k] = 0.0f;
    // 1. the residuals of this thread's points, kBatch at a time
    constexpr int kBatch = kBatchOf<MODE>;
    for (int64_t i0 = static_cast<int64_t>(rank) * kThreads + tid; i0 < n;
         i0 += kBatch * stride) {
      float xs[kBatch][3];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int64_t i = i0 + b * stride;
#pragma unroll
        for (int c = 0; c < 3; ++c)
          xs[b][c] = i < n ? __ldg(pts + 3 * i + c) : 0.0f;
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (i0 + b * stride >= n) break;
        float p[3];
#pragma unroll
        for (int k = 0; k < 3; ++k)
          p[k] = r[3 * k] * xs[b][0] + r[3 * k + 1] * xs[b][1] +
                 r[3 * k + 2] * xs[b][2] + tt[k];
        float phi, J[6];
        const bool ok = MODE == kGrad ? grad_residual<BS>(g, p, phi, J)
                                      : trilinear_residual<BS>(g, p, phi, J);
        if (ok) accumulate(acc, phi, J);
      }
    }
    // 2. the CTA's partial
    const int buf = iters & 1;
    const float part = cta_sum(acc, sh.red);
    if (tid < kSums) sh.part[buf][tid] = part;
    // 3. every partial of this iteration is in place (and every CTA has
    // read the last iteration's, which the next one overwrites)
    cluster.sync();
    // 4. every CTA adds the partials in rank order and steps: the same
    // bits in each, so no CTA waits for another's result
    if (tid < kSums) {
      float s = 0.0f;
#pragma unroll
      for (int c = 0; c < kClusterCtas; ++c)
        s += cluster.map_shared_rank(sh.part[buf], static_cast<unsigned int>(c))[tid];
      sh.total[tid] = s;
      if (!do_step && rank == 0) sums[tid] = s;
    }
    __syncthreads();
    if (do_step && tid < 32) {
      bool small, bad;
      gn_solve_update(sh.total, sh.pose, sh.pose + 9, damping, conv_sq,
                      small, bad);
      if (tid == 0) {
        sh.flags[0] = small;
        sh.flags[1] = bad;
      }
    }
    __syncthreads();
    ++iters;
    if (!do_step || sh.flags[0] || iters >= num_iterations) break;
  }
  // no CTA exits while another may still read its shared memory
  cluster.sync();
  if (do_step && rank == 0 && tid == 0) {
    for (int k = 0; k < 9; ++k) R[k] = sh.pose[k];
    for (int k = 0; k < 3; ++k) t[k] = sh.pose[9 + k];
    status[0] = sh.flags[0] ? 1.0f : 0.0f;
    status[1] = sh.flags[1] ? 1.0f : 0.0f;
    status[2] = sh.total[0];
    status[3] = sh.total[kSums - 1];
    status[4] = static_cast<float>(iters);
  }
}

__global__ void gn_step(const float* __restrict__ sums, float* __restrict__ R,
                        float* __restrict__ t, float* __restrict__ status,
                        float damping, float conv_sq) {
  if (blockIdx.x != 0) return;   // one warp
  bool small, bad;
  gn_solve_update(sums, R, t, damping, conv_sq, small, bad);
  if (threadIdx.x != 0) return;
  status[0] = small ? 1.0f : 0.0f;
  status[1] = bad ? 1.0f : 0.0f;
  status[2] = sums[0];
  status[3] = sums[kSums - 1];
}

__global__ void __launch_bounds__(kThreads) cluster_empty() {}

// The launch configuration of one cluster on `stream`
struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  explicit ClusterLaunch(cudaStream_t s) : cfg(), attr() {
    cfg.gridDim = dim3(kClusterCtas);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = s;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kClusterCtas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// At first use of a kernel: allow the cluster size (above 8 CTAs it is not
// portable) and ask how many such clusters the card can hold at once. A
// shape that cannot be placed is an error: it is never shrunk. Returns 0 or
// a CUDA error; `active` gets the count.
template <typename Kernel>
int prepare(Kernel kernel, int* active) {
  if (kClusterCtas > 8) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ClusterLaunch l(nullptr);
  const cudaError_t e = cudaOccupancyMaxActiveClusters(active, kernel, &l.cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  return *active < 1 ? static_cast<int>(cudaErrorLaunchOutOfResources) : 0;
}

template <typename Kernel>
int prepare_once(Kernel kernel, int& state) {
  // state: 0 not yet checked, 1 ready, else the error of the check
  if (state == 0) {
    int active = 0;
    const int e = prepare(kernel, &active);
    state = e == 0 ? 1 : e;
  }
  return state == 1 ? 0 : state;
}

// first-use states: gn_track_loop<MODE, kFixedBlock>, <MODE, 0> for each
// mode, then cluster_empty
int ready[5] = {0, 0, 0, 0, 0};

template <int MODE, int BS>
int launch_loop(cudaStream_t s, const float* p, int64_t n, const int* n_dev,
                float* R, float* t, const Grid& g, float* status, float* sums,
                int num_iterations, int do_step, float damping,
                float conv_sq) {
  const int rc = prepare_once(gn_track_loop<MODE, BS>,
                              ready[2 * MODE + (BS == 0)]);
  if (rc != 0) return rc;
  ClusterLaunch l(s);
  const cudaError_t e = cudaLaunchKernelEx(&l.cfg, gn_track_loop<MODE, BS>, p,
                                           n, n_dev, R, t, g, status, sums,
                                           num_iterations, do_step, damping,
                                           conv_sq);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points (bound with ctypes). Each launches on `stream`, does not
// synchronize, and returns cudaGetLastError() of the launch (0 = success),
// or the error of the first-use check of the cluster shape.
//
// `pts` f32 [n, 3] (camera frame), of which the first *n_dev rows are the
// points where `n_dev` (int32 [1], on the device: the compaction's count,
// track_compact.cu) is not null, else all n; `R` f32 [3, 3], `t` f32 [3] (the pose,
// on the device); `directory` i32 [dir_dim^3]; the five fields f32
// [(slot_hi - slot_lo) * voxels_per_block] (the rows of slots
// [slot_lo, slot_hi)); `mode` 0 is the gradient query, 1 the trilinear one.
// With do_step = 1: up to num_iterations GN iterations, R and t updated in
// place, `status` f32 [5] out (small, bad, E, count, iterations), `sums`
// unused. With do_step = 0: one residual pass, `sums` f32 [29] out (E, g(6),
// H's upper triangle (21, row-major), count), R, t and `status` untouched.
extern "C" int gsdf_gn_track_loop_f32(
    const void* pts, int64_t n, const void* n_dev, void* R, void* t,
    const void* directory,
    const void* dist, const void* weight, const void* grad_x,
    const void* grad_y, const void* grad_z, void* status, void* sums,
    int mode, int dir_dim, int block_shape, int slot_lo, int slot_hi,
    int num_iterations, int do_step, float vs, float grad_scale,
    float damping, float conv_sq, void* stream) {
  if (n < 0 || dir_dim <= 0 || block_shape <= 0 || num_iterations < 1 ||
      (do_step ? status == nullptr : (sums == nullptr || num_iterations != 1)))
    return cudaErrorInvalidValue;
  Grid g = {static_cast<const int32_t*>(directory),
            static_cast<const float*>(dist), static_cast<const float*>(weight),
            static_cast<const float*>(grad_x), static_cast<const float*>(grad_y),
            static_cast<const float*>(grad_z), dir_dim, dir_dim / 2,
            block_shape, block_shape * block_shape * block_shape, slot_lo,
            slot_hi, vs, grad_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pts);
  const int* nd = static_cast<const int*>(n_dev);
  float* r = static_cast<float*>(R);
  float* tt = static_cast<float*>(t);
  float* st = static_cast<float*>(status);
  float* out = static_cast<float*>(sums);
  const bool fixed = block_shape == kFixedBlock;
  if (mode == kGrad)
    return fixed ? launch_loop<kGrad, kFixedBlock>(s, p, n, nd, r, tt, g, st, out,
                                                   num_iterations, do_step,
                                                   damping, conv_sq)
                 : launch_loop<kGrad, 0>(s, p, n, nd, r, tt, g, st, out,
                                         num_iterations, do_step, damping,
                                         conv_sq);
  if (mode == kTrilinear)
    return fixed ? launch_loop<kTrilinear, kFixedBlock>(s, p, n, nd, r, tt, g, st,
                                                        out, num_iterations,
                                                        do_step, damping,
                                                        conv_sq)
                 : launch_loop<kTrilinear, 0>(s, p, n, nd, r, tt, g, st, out,
                                              num_iterations, do_step, damping,
                                              conv_sq);
  return cudaErrorInvalidValue;
}

// The cluster shape: out[0] CTAs, out[1] threads a CTA, out[2] how many
// such clusters of gn_track_loop<mode> (at the app's block shape) the card
// holds at once.
extern "C" int gsdf_gn_cluster_shape(int mode, int* out) {
  out[0] = kClusterCtas;
  out[1] = kThreads;
  out[2] = 0;
  if (mode == kGrad)
    return prepare(gn_track_loop<kGrad, kFixedBlock>, out + 2);
  if (mode == kTrilinear)
    return prepare(gn_track_loop<kTrilinear, kFixedBlock>, out + 2);
  return cudaErrorInvalidValue;
}

// An empty kernel at the loop's launch (one cluster of the same shape): the
// floor under gn_track_loop's time.
extern "C" int gsdf_gn_cluster_empty(void* stream) {
  const int rc = prepare_once(cluster_empty, ready[4]);
  if (rc != 0) return rc;
  ClusterLaunch l(static_cast<cudaStream_t>(stream));
  const cudaError_t e = cudaLaunchKernelEx(&l.cfg, cluster_empty);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// `sums` f32 [29] (the one-pass launch's, summed over a mesh's ranks); `R`
// f32 [3, 3] and `t` f32 [3], updated in place; `status` f32 [4] out:
// small, bad, E, count.
extern "C" int gsdf_gn_step_f32(const void* sums, void* R, void* t,
                                void* status, float damping, float conv_sq,
                                void* stream) {
  gn_step<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sums), static_cast<float*>(R),
      static_cast<float*>(t), static_cast<float*>(status), damping, conv_sq);
  return static_cast<int>(cudaGetLastError());
}
