// gn_track: the body of the Gauss-Newton tracking loop, as two kernels.
//
// Replaces what the JAX package compiles into one XLA program: the residual
// pass `_residual_pass` of gradient_sdf_tpu/models/tracker.py (:80-107, with
// `query.tsdf_grad` or `query.tsdf_trilinear`) and the rest of the body of
// its `lax.while_loop` (:206-222: the 6x6 solve, the flags, the se3 update).
// Neither has a TPU kernel there. In eager PyTorch one iteration of that
// loop is ~60 small launches; here it is two, and the host reads 16 bytes.
//
//   gn_residual_reduce<MODE>: one thread per compacted depth pixel (a
//     grid-stride loop over a fixed grid of kCtas x kThreads). Per point
//     p = R x + t, the SDF query of MODE (GRAD: the nearest voxel's dist
//     plus the stored gradient's first-order correction; TRILINEAR: the 8
//     corners, counted only where all 8 are observed), and the residual's
//     phi and J = [grad, p x grad]. Each thread keeps the 29 sums (E, g(6),
//     the upper triangle of H (21), the count) in registers; a warp-shuffle
//     tree and shared memory reduce them to one partial per CTA; the last
//     CTA to finish (an atomic ticket that it resets itself) reduces the
//     partials in a fixed order. No float atomics: the same inputs give the
//     same bits on every run, which the 1e-3 stopping rule needs (a last-bit
//     difference in the sums can change the iteration count).
//     A slot window [slot_lo, slot_hi) restricts the query to the blocks a
//     mesh rank owns (its fields hold only those rows); on one card it is
//     every slot.
//   gn_step: one thread. H from its 21 sums, LU with partial pivoting of
//     H + 1e-12 I in float32 (what torch.linalg.solve does), xi = damping
//     x the solution, the flags small = xi.xi < conv_sq and bad =
//     any(isnan(xi)), and where neither is set (R, t) <- exp(-xi) (R, t),
//     in place on the device. It writes the 16-byte status (small, bad, E,
//     count) that the host reads once per iteration.
//
// What bounds it on an H100: neither kernel has work enough to leave the
// launch floor (~2.5 us). The residual pass reads 12 bytes per point plus
// the sectors of the directory and the fields its points hit (~1 us of
// bytes for a VGA frame); the step is a few hundred serial float32
// operations. So the design cuts launches and host round trips, not bytes:
// two launches per iteration where the eager loop had ~60, the pose never
// leaves the device, and no per-frame packing of the field rows (the kernel
// reads the five SoA fields where the residuals need them).
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
#include <cuda_runtime.h>

namespace {

constexpr int kSums = 29;       // E, g(6), H upper triangle (21), count
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCtas = 2 * 132;  // two CTAs per SM of an H100

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
// or outside the slot window.
__device__ __forceinline__ int voxel_row(const Grid& g, int x, int y, int z) {
  const int b = g.block_shape;
  const int bx = floor_div(x, b), by = floor_div(y, b), bz = floor_div(z, b);
  const int xs = bx + g.half, ys = by + g.half, zs = bz + g.half;
  const int D = g.dir_dim;
  if (xs < 0 || xs >= D || ys < 0 || ys >= D || zs < 0 || zs >= D) return -1;
  const int slot = __ldg(g.directory + (xs * D + ys) * D + zs);
  if (slot < 0 || slot < g.slot_lo || slot >= g.slot_hi) return -1;
  const int local = ((z - bz * b) * b + (y - by * b)) * b + (x - bx * b);
  return (slot - g.slot_lo) * g.voxels_per_block + local;
}

// J[3..5] = p x J[0..2], in torch.linalg.cross's component order
__device__ __forceinline__ void cross_rows(const float p[3], float J[6]) {
  J[3] = p[1] * J[2] - p[2] * J[1];
  J[4] = p[2] * J[0] - p[0] * J[2];
  J[5] = p[0] * J[1] - p[1] * J[0];
}

// query.tsdf_grad at p; false where the residual does not count
__device__ __forceinline__ bool grad_residual(const Grid& g, const float p[3],
                                              float& phi, float J[6]) {
  const int vx = __float2int_rn(p[0] / g.vs);
  const int vy = __float2int_rn(p[1] / g.vs);
  const int vz = __float2int_rn(p[2] / g.vs);
  const int row = voxel_row(g, vx, vy, vz);
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
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int ox = c >> 2, oy = (c >> 1) & 1, oz = c & 1;
    const int row = voxel_row(g, b0 + ox, b1 + oy, b2 + oz);
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
// warp, then the warps in order. Thread k < kSums returns the k-th total.
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

template <int MODE>
__global__ void __launch_bounds__(kThreads)
gn_residual_reduce(const float* __restrict__ pts, int64_t n,
                   const float* __restrict__ R, const float* __restrict__ t,
                   Grid g, float* __restrict__ partials,
                   unsigned int* __restrict__ ticket,
                   float* __restrict__ sums) {
  __shared__ float smem[kWarps * kSums];
  __shared__ bool last;
  float r[9], tt[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) r[k] = __ldg(R + k);
#pragma unroll
  for (int k = 0; k < 3; ++k) tt[k] = __ldg(t + k);
  float acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.0f;

  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    const float x = __ldg(pts + 3 * i), y = __ldg(pts + 3 * i + 1),
                z = __ldg(pts + 3 * i + 2);
    float p[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      p[k] = r[3 * k] * x + r[3 * k + 1] * y + r[3 * k + 2] * z + tt[k];
    float phi, J[6];
    const bool ok = MODE == kGrad ? grad_residual(g, p, phi, J)
                                  : trilinear_residual(g, p, phi, J);
    if (!ok) continue;
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

  const float part = cta_sum(acc, smem);
  if (threadIdx.x < kSums) partials[blockIdx.x * kSums + threadIdx.x] = part;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  // the last CTA: thread j takes partials j, j + kThreads, ... in order,
  // then the same fixed-order CTA sum
  __threadfence();
  float v[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) v[k] = 0.0f;
  for (int c = threadIdx.x; c < gridDim.x; c += kThreads) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) v[k] += __ldcg(partials + c * kSums + k);
  }
  const float total = cta_sum(v, smem);
  if (threadIdx.x < kSums) sums[threadIdx.x] = total;
  if (threadIdx.x == 0) *ticket = 0u;
}

// utils/se3.so3 hat(w) @ hat(w), as a 3x3 product
__device__ void hat_sq(const float W[3][3], float W2[3][3]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      W2[i][j] = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
}

__global__ void gn_step(const float* __restrict__ sums, float* __restrict__ R,
                        float* __restrict__ t, float* __restrict__ status,
                        float damping, float conv_sq) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  // the system H + 1e-12 I, g, as models/tracker.gauss_newton forms it
  float A[6][6], x[6];
  int k = 7;
  for (int a = 0; a < 6; ++a) {
    for (int b = a; b < 6; ++b) {
      A[a][b] = sums[k];
      A[b][a] = sums[k];
      ++k;
    }
  }
  for (int a = 0; a < 6; ++a) {
    for (int b = 0; b < 6; ++b) A[a][b] = A[a][b] + (a == b ? 1e-12f : 0.0f);
    x[a] = sums[1 + a];
  }
  // LU with partial pivoting (the first largest |pivot|, as isamax picks),
  // the forward substitution carried along, then the back substitution
  for (int c = 0; c < 6; ++c) {
    int piv = c;
    float best = fabsf(A[c][c]);
    for (int i = c + 1; i < 6; ++i) {
      if (fabsf(A[i][c]) > best) {
        best = fabsf(A[i][c]);
        piv = i;
      }
    }
    if (piv != c) {
      for (int j = 0; j < 6; ++j) {
        const float s = A[c][j];
        A[c][j] = A[piv][j];
        A[piv][j] = s;
      }
      const float s = x[c];
      x[c] = x[piv];
      x[piv] = s;
    }
    for (int i = c + 1; i < 6; ++i) {
      const float l = A[i][c] / A[c][c];
      for (int j = c + 1; j < 6; ++j) A[i][j] = A[i][j] - l * A[c][j];
      x[i] = x[i] - l * x[c];
    }
  }
  for (int i = 5; i >= 0; --i) {
    float s = x[i];
    for (int j = i + 1; j < 6; ++j) s = s - A[i][j] * x[j];
    x[i] = s / A[i][i];
  }
  float xi[6], sq = 0.0f;
  bool bad = false;
  for (int a = 0; a < 6; ++a) {
    xi[a] = damping * x[a];
    sq = sq + xi[a] * xi[a];
    bad = bad || xi[a] != xi[a];   // isnan
  }
  const bool small = sq < conv_sq;
  if (!small && !bad) {
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
      fa = sinf(theta) / theta;
      fb = (1.0f - cosf(theta)) / theta_sq;
      fc = (theta - sinf(theta)) / (theta_sq * theta);
    }
    const float W[3][3] = {{0.0f, -w[2], w[1]},
                           {w[2], 0.0f, -w[0]},
                           {-w[1], w[0], 0.0f}};
    float W2[3][3], dR[3][3], V[3][3], dt[3];
    hat_sq(W, W2);
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) {
        const float eye = i == j ? 1.0f : 0.0f;
        dR[i][j] = eye + fa * W[i][j] + fb * W2[i][j];
        V[i][j] = eye + fb * W[i][j] + fc * W2[i][j];
      }
    }
    for (int i = 0; i < 3; ++i)
      dt[i] = V[i][0] * v[0] + V[i][1] * v[1] + V[i][2] * v[2];
    // (R, t) <- (dR R, dR t + dt)
    float Rn[9], tn[3];
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j)
        Rn[3 * i + j] = dR[i][0] * R[j] + dR[i][1] * R[3 + j] + dR[i][2] * R[6 + j];
      tn[i] = dR[i][0] * t[0] + dR[i][1] * t[1] + dR[i][2] * t[2] + dt[i];
    }
    for (int k2 = 0; k2 < 9; ++k2) R[k2] = Rn[k2];
    for (int i = 0; i < 3; ++i) t[i] = tn[i];
  }
  status[0] = small ? 1.0f : 0.0f;
  status[1] = bad ? 1.0f : 0.0f;
  status[2] = sums[0];
  status[3] = sums[kSums - 1];
}

}  // namespace

// C entry points (bound with ctypes). Both launch on `stream`, do not
// synchronize, and return cudaGetLastError() of the launch (0 = success).
//
// `pts` f32 [n, 3] (camera frame); `R` f32 [3, 3], `t` f32 [3] (the pose,
// read on the device); `directory` i32 [dir_dim^3]; the five fields f32
// [(slot_hi - slot_lo) * voxels_per_block] (the rows of slots
// [slot_lo, slot_hi)); `partials` f32 [gsdf_gn_ctas() * 29]; `ticket` one
// u32, zero before the launch and after it; `sums` f32 [29] out. `mode` 0 is
// the gradient query, 1 the trilinear one.
extern "C" int gsdf_gn_residual_reduce_f32(
    const void* pts, int64_t n, const void* R, const void* t,
    const void* directory, const void* dist, const void* weight,
    const void* grad_x, const void* grad_y, const void* grad_z,
    void* partials, void* ticket, void* sums, int mode, int dir_dim,
    int block_shape, int slot_lo, int slot_hi, float vs, float grad_scale,
    void* stream) {
  if (n < 0 || dir_dim <= 0 || block_shape <= 0) return cudaErrorInvalidValue;
  Grid g = {static_cast<const int32_t*>(directory),
            static_cast<const float*>(dist), static_cast<const float*>(weight),
            static_cast<const float*>(grad_x), static_cast<const float*>(grad_y),
            static_cast<const float*>(grad_z), dir_dim, dir_dim / 2,
            block_shape, block_shape * block_shape * block_shape, slot_lo,
            slot_hi, vs, grad_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pts);
  const float* r = static_cast<const float*>(R);
  const float* tt = static_cast<const float*>(t);
  float* part = static_cast<float*>(partials);
  unsigned int* tk = static_cast<unsigned int*>(ticket);
  float* out = static_cast<float*>(sums);
  if (mode == kGrad) {
    gn_residual_reduce<kGrad><<<kCtas, kThreads, 0, s>>>(p, n, r, tt, g, part,
                                                         tk, out);
  } else if (mode == kTrilinear) {
    gn_residual_reduce<kTrilinear><<<kCtas, kThreads, 0, s>>>(p, n, r, tt, g,
                                                              part, tk, out);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

// The CTAs of a residual launch: the rows of its `partials`.
extern "C" int gsdf_gn_ctas() { return kCtas; }

// `sums` f32 [29] (gsdf_gn_residual_reduce_f32's); `R` f32 [3, 3] and `t`
// f32 [3], updated in place; `status` f32 [4] out: small, bad, E, count.
extern "C" int gsdf_gn_step_f32(const void* sums, void* R, void* t,
                                void* status, float damping, float conv_sq,
                                void* stream) {
  gn_step<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sums), static_cast<float*>(R),
      static_cast<float*>(t), static_cast<float*>(status), damping, conv_sq);
  return static_cast<int>(cudaGetLastError());
}
