// ray_finish: the renderer's finish, one thread a ray: the semi-implicit
// query at the march's hit, the straight-through Newton/IFT depth, the
// point, the outward normal and the camera-z depth, written in one launch.
//
// Replaces the polish of the JAX package's `_refine`
// (gradient_sdf_tpu/ops/raycast.py:479-501, over `query.tsdf_grad`) and its
// hit compaction and scatter-back (:505-531), which XLA fuses. In the
// port's plain version (`ray_finish_reference` in ops/kernels/ray_finish.py)
// it is a `nonzero` of the hit mask (a host sync), gathers of the hit rays,
// the `tsdf_grad` chain and three `index_put`s. Per ray with found set, at
// the secant point m = s_star:
//   p = o + m d, v = rint(p / vs) (as PyTorch on the card: p times the
//   float32 reciprocal of vs), the nearest voxel through `directory`
//   (the lookup of `voxel_grid.lookup_voxels` and of the march's probe);
//   present = the block is allocated and weight > 0;
//   g = the stored gradient, s = grad_scale / max(|g|, 1e-12),
//   cmp = v vs - p, phi = dist + s (g . cmp), G = s g (all 0 if absent);
//   denom = G . d, safe = present and denom > 0,
//   dc = max(denom, grad_scale / 4), s_ift = m - phi / dc,
//   s_hit = safe ? (m + s_ift) - s_ift : m   (straight-through: the value
//   is the secant's up to the rounding of that sum, the gradient the IFT
//   one; the backward is in the wrapper);
//   normal = -G / max(|G|, 1e-12), point = o + s_hit d, z = s_hit inv_hnorm.
// A ray not found gets zeros. The operations are the plain version's in its
// order (built with -fmad=false, IEEE division and square root). The plain
// version sums G . d and |G|^2 with a reduction over three entries whose
// order PyTorch picks, so depth, points and normals may differ from it by
// an ulp; `found` is taken as it is, so the hit mask is the march's.
//
// With `lin`, the launch also writes what the backward needs: the voxel's
// linear index (-1 when absent), the safe flag and [g, s, cmp, dc] (8
// floats a ray, zeros where not found). Only a caller that needs gradients
// asks for them.
//
// `finish_values` in ops/kernels/ray_finish.py is this arithmetic in
// PyTorch on whole tensors, outputs and state, which lets the CPU tests
// hold the backward to the plain autograd. It follows this kernel's order
// of operations: a change here is made there too. On a card the `gpu`
// test and phase 9b of chip_smoke.py hold the two to each other (the index
// and the safe flag exactly, every float within an ulp-scale tolerance).
//
// What bounds it on an H100: bytes. Per ray 33 B of state read (found,
// s_star, origin, direction, inv_hnorm) and 16-32 B of images written
// (depth, normal, camera-z depth; points for `raycast`), plus, per hit,
// a directory sector and the five fields' sectors of its voxel: ~20 MB at
// VGA, ~0.006 ms at 3.35 TB/s. A hit's lookup is two dependent gathers,
// which at VGA's 78k hits on 132 SMs is latency, not bandwidth.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Finish {
  const uint8_t* found;
  const float* s_star;
  const float* origins;      // f32 [n, 3]
  const float* dirs;         // f32 [n, 3]
  const float* inv_hnorm;    // f32 [n] or null
  const int* directory;      // int32 [dir_dim^3]
  const float* dist;         // f32 [num_blocks * B^3]
  const float* weight;
  const float* grad_x;
  const float* grad_y;
  const float* grad_z;
  float* depth;              // f32 [n]: ray parameter
  float* points;             // f32 [n, 3] or null
  float* normal;             // f32 [n, 3]
  float* zdepth;             // f32 [n] or null (with inv_hnorm)
  int* lin;                  // int32 [n] or null: the backward's state
  uint8_t* safe;             // u8 [n]
  float* aux;                // f32 [n, 8]
  long long n;
  int dir_dim, block_shape, vpb;
  float vs, inv_vs, grad_scale, dc_min;
};

__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && (a < 0) != (b < 0)) ? q - 1 : q;
}

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

__global__ void __launch_bounds__(kThreads) ray_finish(Finish f) {
  const long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (i >= f.n) return;
  float* nrm = f.normal + 3 * i;
  if (!f.found[i]) {
    f.depth[i] = 0.f;
    nrm[0] = nrm[1] = nrm[2] = 0.f;
    if (f.points) f.points[3 * i] = f.points[3 * i + 1] = f.points[3 * i + 2] = 0.f;
    if (f.zdepth) f.zdepth[i] = 0.f;
    if (f.lin) {
      f.lin[i] = -1;
      f.safe[i] = 0;
      for (int k = 0; k < 8; ++k) f.aux[8 * i + k] = 0.f;
    }
    return;
  }
  const float m = f.s_star[i];
  const float ox = f.origins[3 * i], oy = f.origins[3 * i + 1], oz = f.origins[3 * i + 2];
  const float dx = f.dirs[3 * i], dy = f.dirs[3 * i + 1], dz = f.dirs[3 * i + 2];
  const float px = ox + m * dx, py = oy + m * dy, pz = oz + m * dz;
  const int vx = __float2int_rn(px * f.inv_vs);
  const int vy = __float2int_rn(py * f.inv_vs);
  const int vz = __float2int_rn(pz * f.inv_vs);
  const int B = f.block_shape, D = f.dir_dim, half = D / 2;
  const int bx = floor_div(vx, B), by = floor_div(vy, B), bz = floor_div(vz, B);
  const int local = ((vz - bz * B) * B + (vy - by * B)) * B + (vx - bx * B);
  const int xs = bx + half, ys = by + half, zs = bz + half;
  int slot = -1;
  if (xs >= 0 && xs < D && ys >= 0 && ys < D && zs >= 0 && zs < D)
    slot = f.directory[(xs * D + ys) * D + zs];
  const int lin = (slot >= 0 ? slot : 0) * f.vpb + local;
  bool present = false;
  float g0 = 0.f, g1 = 0.f, g2 = 0.f, s = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f;
  float phi = 0.f, G0 = 0.f, G1 = 0.f, G2 = 0.f;
  if (slot >= 0) {
    const float w = f.weight[lin], dv = f.dist[lin];
    const float gx = f.grad_x[lin], gy = f.grad_y[lin], gz = f.grad_z[lin];
    present = w > 0.f;
    if (present) {
      g0 = gx;
      g1 = gy;
      g2 = gz;
      s = (1.0f / clamp_min(sqrtf(g0 * g0 + g1 * g1 + g2 * g2), 1e-12f)) * f.grad_scale;
      c0 = static_cast<float>(vx) * f.vs - px;
      c1 = static_cast<float>(vy) * f.vs - py;
      c2 = static_cast<float>(vz) * f.vs - pz;
      phi = dv + s * (g0 * c0 + g1 * c1 + g2 * c2);
      G0 = s * g0;
      G1 = s * g1;
      G2 = s * g2;
    }
  }
  const float denom = G0 * dx + G1 * dy + G2 * dz;
  const bool safe = present && denom > 0.f;
  const float dc = clamp_min(denom, f.dc_min);
  float s_hit = m;
  if (safe) {
    const float s_ift = m - phi / dc;
    s_hit = (m + s_ift) - s_ift;
  }
  const float cn = clamp_min(sqrtf(G0 * G0 + G1 * G1 + G2 * G2), 1e-12f);
  nrm[0] = -G0 / cn;
  nrm[1] = -G1 / cn;
  nrm[2] = -G2 / cn;
  f.depth[i] = s_hit;
  if (f.points) {
    f.points[3 * i] = ox + s_hit * dx;
    f.points[3 * i + 1] = oy + s_hit * dy;
    f.points[3 * i + 2] = oz + s_hit * dz;
  }
  if (f.zdepth) f.zdepth[i] = s_hit * f.inv_hnorm[i];
  if (f.lin) {
    f.lin[i] = present ? lin : -1;
    f.safe[i] = safe;
    float* a = f.aux + 8 * i;
    a[0] = g0;
    a[1] = g1;
    a[2] = g2;
    a[3] = s;
    a[4] = c0;
    a[5] = c1;
    a[6] = c2;
    a[7] = dc;
  }
}

__global__ void empty_kernel() {}

}  // namespace

// gsdf_ray_finish_f32: one launch on `stream`, no synchronization; returns
// cudaGetLastError() (0 = success). Pointers as in `Finish` above (fields
// f32 [num_blocks * B^3], each contiguous); points, inv_hnorm with zdepth,
// and lin with safe and aux may each be null.
extern "C" int gsdf_ray_finish_f32(
    const void* found, const void* s_star, const void* origins,
    const void* dirs, const void* inv_hnorm, const void* directory,
    const void* dist, const void* weight, const void* grad_x,
    const void* grad_y, const void* grad_z, void* depth, void* points,
    void* normal, void* zdepth, void* lin, void* safe, void* aux,
    long long n, int dir_dim, int block_shape, float vs, float inv_vs,
    float grad_scale, float dc_min, void* stream) {
  if (n <= 0 || block_shape <= 0 || dir_dim <= 0 ||
      (zdepth != nullptr) != (inv_hnorm != nullptr) ||
      (lin != nullptr) != (safe != nullptr) ||
      (lin != nullptr) != (aux != nullptr))
    return cudaErrorInvalidValue;
  Finish f = {static_cast<const uint8_t*>(found), static_cast<const float*>(s_star),
              static_cast<const float*>(origins), static_cast<const float*>(dirs),
              static_cast<const float*>(inv_hnorm),
              static_cast<const int*>(directory), static_cast<const float*>(dist),
              static_cast<const float*>(weight), static_cast<const float*>(grad_x),
              static_cast<const float*>(grad_y), static_cast<const float*>(grad_z),
              static_cast<float*>(depth), static_cast<float*>(points),
              static_cast<float*>(normal), static_cast<float*>(zdepth),
              static_cast<int*>(lin), static_cast<uint8_t*>(safe),
              static_cast<float*>(aux), n, dir_dim, block_shape,
              block_shape * block_shape * block_shape, vs, inv_vs, grad_scale,
              dc_min};
  ray_finish<<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(f);
  return static_cast<int>(cudaGetLastError());
}

// gsdf_ray_finish_empty: an empty kernel at the launch of n rays.
extern "C" int gsdf_ray_finish_empty(long long n, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  empty_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
