// ba_terms: PhotoBA's per-(voxel, frame) pass, hand-written for Hopper.
//
// Replaces, on the card, the JAX package's per-frame scan of PhotoBA
// (gradient_sdf_tpu/models/photo_ba.py: `_per_frame_terms` :84 under
// `_scan_frames` :127; the carries of `energy` :140, `solve_dist` :168
// (scan :200) and `_pose_terms` :233 (scan :253); the per-frame systems of
// `solve_pose` :259 (scan :275) built by `_make_frame_AJ` :211), which XLA
// compiles into one program; it has no TPU kernel. The port's plain version
// evaluates every frame at once on [F, V, ...] tensors
// (gradient_sdf_tpu_torch/models/photo_ba.py) and writes the image Jacobian
// [F, V, 3, 3] and the pose Jacobian [F, V, 3, 6] to device memory (110 and
// 221 MB at F = 30, V = 102400); here nothing of [F, V, ...] is written.
//
//   ba_voxel_sums (three instances, one a mode): a thread a voxel. It forms
//     the voxel's surface point x = vox vs - dist g / |g|, then walks the F
//     frames in frame order, as the JAX scan does, skipping a frame whose
//     visibility bit is off before it reads a tap. For each frame it
//     projects (p = R^T (x - t), the safe z, u and v), samples the image
//     bilinearly with the analytic dA/du and dA/dv of
//     `filters.bilinear_sample_grad` (clamp and in-bounds rule included),
//     applies the gates (visibility, in-bounds, z > 1e-12, vmask; |dist| <=
//     vs for the energy and the pose step; the TRUNC_L2 intensity gate for
//     the solvers) and adds the pair into running sums held in registers:
//       energy: n, sum A, sum |A|^2 -> the voxel's clamped energy, summed
//         over the CTA by a fixed shuffle tree and then the warps in order
//         into one partial a CTA; `ba_energy_finish` (one warp) adds the
//         partials in a fixed order. The energy is the same bits on every
//         run: the optimizer's stopping test compares energies.
//       dist: n, sum A, sum Jd, sum A Jd, sum Jd^2 with Jd = dI/dp (-R^T g)
//         (g unnormalized) -> dist - damping b / H, solveDist's closed form
//         with H += reg_weight weight and the (n > 0) & (H != 0) guard.
//       mean: n and the mean intensity, for ba_pose_systems.
//   ba_pose_systems: a thread a voxel, with kernel 1's n and mean. For each
//     frame, in frame order and in step across the CTA, the thread builds
//     the pair's pose Jacobian Jc = [-dI/dp R^T | dI/dp x p] (3 x 6) in
//     registers and forms the 21 entries of (1 - 1/n) Jc^T Jc's upper
//     triangle and the 6 of r^T Jc (r = A - mean, the pair weighted by
//     valid & (n > 0)). The 27 sums are reduced over the warp with
//     shuffles, the warps' sums (a double-buffered [2][warps][27] stage in
//     shared memory, one barrier a frame) are added in warp order, and each
//     CTA writes its [F, 27] partial; `ba_pose_finish` (a warp an entry)
//     adds the partials in a fixed order and writes H [F, 6, 6] (mirrored)
//     and b [F, 6]. No atomic decides an order: H and b are the same bits
//     on every run, so every rank of a mesh solves the same systems.
//   The F poses (12 floats a frame) sit in shared memory, read by every
//   thread at every frame; K comes from device memory (no host read).
//
// Arithmetic: the plain version's float32 operations in its order (x, p
// as d0 R[0] + d1 R[1] + d2 R[2], u = fx p0 / z + cx, the lerps, dI/dp,
// Jd, the sums), built without fused multiply-adds (_build.SOURCE_FLAGS):
// A pair's u and v are then the plain version's bits, so the same pairs
// pass the gates and the same image cells give the piecewise-constant
// gradient. The frame sums differ only in their order from the plain
// reductions, and the pose systems in the order of the (voxel, channel)
// sums.
//
// What bounds it on an H100: bytes, mostly the taps. Each participating
// pair reads 4 x 12 bytes at an image position the data decides, from 110
// MB of images at the BA scale point (beyond the 50 MB L2); the per-voxel
// inputs are read once. The operations, 76-405 float32 a pair by mode, are
// far below the card's rate. The kernels keep every intermediate in
// registers and read each tap once a pass; a simple design: no TMA, no
// tensor cores, a voxel a thread. Measured at the scale point (F = 30, V =
// 102400, 57,561 of 3.07M pairs taking part; NVIDIA H100 80GB HBM3, 700 W
// power limit; PERF.md): ba_voxel_sums 0.025-0.039 ms by mode against
// byte bounds of 0.0026-0.0031, ba_pose_systems 0.091-0.102 against
// 0.0031, an empty launch at their grid 0.0020; 48-64 registers, no
// spills. What is left is latency: a warp waits for a tap's round trip to
// memory in about half of its frames, with 3 CTAs of 256 an SM to hide
// it, and the pose kernel's barrier a frame makes each CTA wait for its
// slowest warp at every frame.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPoseTerms = 27;   // H's upper triangle (21) and b (6)
// poses in shared memory: 12 floats a frame, within the 48 KB a CTA gets
// without opting in, beside the pose kernel's 1.7 KB stage
constexpr int kMaxFrames = 960;
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kEnergy = 0, kDist = 1, kMean = 2 };

// The host's arguments, field for field `ba_terms.BAArgs` (8 bytes each).
struct BAArgs {
  const void* vox;       // int32 [V, 3]
  const void* grad;      // f32 [V, 3], unnormalized
  const void* weight;    // f32 [V]
  const void* vmask;     // bool [V]
  const void* vis;       // bool [V, F]
  const void* images;    // f32 [F, H, W, 3]
  const void* K;         // f32 [3, 3]
  const void* dist;      // f32 [V]
  const void* R;         // f32 [F, 3, 3], camera-to-world
  const void* t;         // f32 [F, 3]
  int64_t V, F, H, W;
  int64_t trunc;         // the TRUNC_L2 gate on
  int64_t channel_mix;   // dI/dp's rows reversed (channel_mix_parity)
  double vs, lambda_sq, reg_weight, damping;
};

// What the kernels read: the float32 constants rounded once from the
// host's doubles, as PyTorch rounds a Python number against a float32
// tensor.
struct Problem {
  const int* vox;
  const float* grad;
  const float* weight;
  const unsigned char* vmask;
  const unsigned char* vis;
  const float* images;
  const float* K;
  const float* dist;
  const float* R;
  const float* t;
  int V, F, H, W;
  int trunc, channel_mix;
  float vs, u_max, v_max, lambda_sq, reg_weight, damping;
};

Problem unpack(const BAArgs& a) {
  Problem p;
  p.vox = static_cast<const int*>(a.vox);
  p.grad = static_cast<const float*>(a.grad);
  p.weight = static_cast<const float*>(a.weight);
  p.vmask = static_cast<const unsigned char*>(a.vmask);
  p.vis = static_cast<const unsigned char*>(a.vis);
  p.images = static_cast<const float*>(a.images);
  p.K = static_cast<const float*>(a.K);
  p.dist = static_cast<const float*>(a.dist);
  p.R = static_cast<const float*>(a.R);
  p.t = static_cast<const float*>(a.t);
  p.V = static_cast<int>(a.V);
  p.F = static_cast<int>(a.F);
  p.H = static_cast<int>(a.H);
  p.W = static_cast<int>(a.W);
  p.trunc = static_cast<int>(a.trunc);
  p.channel_mix = static_cast<int>(a.channel_mix);
  p.vs = static_cast<float>(a.vs);
  // the sampler's clamp, W - 1.000001 and H - 1.000001 (a Python number)
  p.u_max = static_cast<float>(static_cast<double>(a.W) - 1.000001);
  p.v_max = static_cast<float>(static_cast<double>(a.H) - 1.000001);
  p.lambda_sq = static_cast<float>(a.lambda_sq);
  p.reg_weight = static_cast<float>(a.reg_weight);
  p.damping = static_cast<float>(a.damping);
  return p;
}

// The kernels index per-voxel rows (3 v + c) in int32; images and
// visibility in size_t.
bool valid_args(const BAArgs& a) {
  return a.V >= 1 && 3 * a.V < INT32_MAX && a.F >= 1 && a.F <= kMaxFrames &&
         a.H >= 1 && a.W >= 1;
}

struct Intrinsics {
  float fx, fy, cx, cy;
};

// One (voxel, frame) pair's sample: the intensity and its derivatives along
// u and v, the point in the camera frame and 1 / z.
struct Sample {
  float A[3], dAdu[3], dAdv[3];
  float p[3], z_inv;
};

// The CTA's copy of the poses (R row-major, then t; 12 floats a frame) and
// the intrinsics.
__device__ __forceinline__ Intrinsics load_frames(const Problem& P,
                                                  float* pose) {
  for (int i = threadIdx.x; i < P.F * 12; i += kThreads) {
    const int f = i / 12, j = i % 12;
    pose[i] = j < 9 ? P.R[f * 9 + j] : P.t[f * 3 + j - 9];
  }
  Intrinsics k;
  k.fx = __ldg(P.K + 0);
  k.fy = __ldg(P.K + 4);
  k.cx = __ldg(P.K + 2);
  k.cy = __ldg(P.K + 5);
  return k;
}

// x = vox vs - dist g / max(|g|, 1e-12)
__device__ __forceinline__ void surface_point(const Problem& P, int v, float d,
                                              float x[3]) {
  const float g0 = P.grad[3 * v], g1 = P.grad[3 * v + 1],
              g2 = P.grad[3 * v + 2];
  const float nrm = fmaxf(sqrtf(g0 * g0 + g1 * g1 + g2 * g2), 1e-12f);
  const float g[3] = {g0, g1, g2};
#pragma unroll
  for (int c = 0; c < 3; ++c)
    x[c] = static_cast<float>(P.vox[3 * v + c]) * P.vs - d * (g[c] / nrm);
}

// Projects x into frame f (pose Rf, tf) and, if it lands in the image in
// front of the camera, samples the image there. Returns whether it did.
__device__ __forceinline__ bool project_sample(const Problem& P,
                                               const Intrinsics& k,
                                               const float* Rf,
                                               const float* tf, int f,
                                               const float x[3], Sample& s) {
  const float d0 = x[0] - tf[0], d1 = x[1] - tf[1], d2 = x[2] - tf[2];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    s.p[c] = d0 * Rf[c] + d1 * Rf[3 + c] + d2 * Rf[6 + c];
  const float z = s.p[2];
  const float safe_z = fabsf(z) > 1e-12f ? z : 1.0f;
  s.z_inv = 1.0f / safe_z;
  const float u = k.fx * s.p[0] * s.z_inv + k.cx;
  const float v = k.fy * s.p[1] * s.z_inv + k.cy;
  if (!(u >= 0.0f && u < static_cast<float>(P.W) && v >= 0.0f &&
        v < static_cast<float>(P.H) && z > 1e-12f))
    return false;
  const float uc = fminf(fmaxf(u, 0.0f), P.u_max);
  const float vc = fminf(fmaxf(v, 0.0f), P.v_max);
  const float u0f = floorf(uc), v0f = floorf(vc);
  const int u0 = static_cast<int>(u0f), v0 = static_cast<int>(v0f);
  const int u1 = min(u0 + 1, P.W - 1), v1 = min(v0 + 1, P.H - 1);
  const float fu = uc - u0f, fv = vc - v0f;
  const float* img = P.images + static_cast<size_t>(f) * P.H * P.W * 3;
  const float* r0 = img + static_cast<size_t>(v0) * P.W * 3;
  const float* r1 = img + static_cast<size_t>(v1) * P.W * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float i00 = __ldg(r0 + 3 * u0 + c), i01 = __ldg(r0 + 3 * u1 + c);
    const float i10 = __ldg(r1 + 3 * u0 + c), i11 = __ldg(r1 + 3 * u1 + c);
    const float top = i00 + fu * (i01 - i00);
    const float bot = i10 + fu * (i11 - i10);
    s.A[c] = top + fv * (bot - top);
    s.dAdu[c] = (1.0f - fv) * (i01 - i00) + fv * (i11 - i10);
    s.dAdv[c] = (1.0f - fu) * (i10 - i00) + fu * (i11 - i01);
  }
  return true;
}

// The solvers' TRUNC_L2 gate: max_c A_c^2 <= lambda^2 (or no gate).
__device__ __forceinline__ bool trunc_pass(const Problem& P, const Sample& s) {
  if (!P.trunc) return true;
  const float m = fmaxf(fmaxf(s.A[0] * s.A[0], s.A[1] * s.A[1]),
                        s.A[2] * s.A[2]);
  return m <= P.lambda_sq;
}

// dI/dp = dA/du du/dp + dA/dv dv/dp (3 channels x 3 coordinates), rows
// reversed under channel_mix_parity. du/dp = (fx / z, 0, -fx p0 / z^2),
// dv/dp = (0, fy / z, -fy p1 / z^2).
__device__ __forceinline__ void image_jacobian(const Problem& P,
                                               const Intrinsics& k,
                                               const Sample& s,
                                               float dI[3][3]) {
  const float zi2 = s.z_inv * s.z_inv;
  const float du0 = k.fx * s.z_inv, du2 = -k.fx * s.p[0] * zi2;
  const float dv1 = k.fy * s.z_inv, dv2 = -k.fy * s.p[1] * zi2;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int r = P.channel_mix ? 2 - c : c;
    dI[r][0] = s.dAdu[c] * du0;
    dI[r][1] = s.dAdv[c] * dv1;
    dI[r][2] = s.dAdu[c] * du2 + s.dAdv[c] * dv2;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(kFull, x, off);
  return x;  // lane 0's is the warp's sum
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
    ba_voxel_sums(Problem P, float* out0, float* out1, float* partials) {
  extern __shared__ float pose[];
  __shared__ float warp_e[kWarps];
  const Intrinsics k = load_frames(P, pose);
  __syncthreads();
  const int v = blockIdx.x * kThreads + threadIdx.x;
  float e = 0.0f;
  if (v < P.V) {
    const float d = P.dist[v];
    // the energy and the pose step take voxels with |dist| <= vs; the
    // dist step every real voxel
    const bool take = P.vmask[v] != 0 && (kMode == kDist || fabsf(d) <= P.vs);
    float x[3];
    surface_point(P, v, d, x);
    const float g[3] = {P.grad[3 * v], P.grad[3 * v + 1], P.grad[3 * v + 2]};
    float n = 0.0f, sAA = 0.0f;
    float sA[3] = {0.0f, 0.0f, 0.0f}, sJ[3] = {0.0f, 0.0f, 0.0f};
    float sAJ[3] = {0.0f, 0.0f, 0.0f}, sJJ[3] = {0.0f, 0.0f, 0.0f};
    const unsigned char* vis = P.vis + static_cast<size_t>(v) * P.F;
    for (int f = 0; take && f < P.F; ++f) {
      if (!vis[f]) continue;
      const float* Rf = pose + 12 * f;
      Sample s;
      if (!project_sample(P, k, Rf, Rf + 9, f, x, s)) continue;
      if (kMode != kEnergy && !trunc_pass(P, s)) continue;
      n += 1.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c) sA[c] += s.A[c];
      if (kMode == kEnergy)
        sAA += s.A[0] * s.A[0] + s.A[1] * s.A[1] + s.A[2] * s.A[2];
      if (kMode == kDist) {
        float dI[3][3];
        image_jacobian(P, k, s, dI);
        float Rtg[3];  // -R^T g
#pragma unroll
        for (int c = 0; c < 3; ++c)
          Rtg[c] = -(g[0] * Rf[c] + g[1] * Rf[3 + c] + g[2] * Rf[6 + c]);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float Jd = dI[c][0] * Rtg[0] + dI[c][1] * Rtg[1] +
                           dI[c][2] * Rtg[2];
          sJ[c] += Jd;
          sAJ[c] += s.A[c] * Jd;
          sJJ[c] += Jd * Jd;
        }
      }
    }
    if (kMode == kEnergy) {
      // sum_i |A_i - mean|^2 = sum |A|^2 - |sum A|^2 / n, clamped at 0
      const float ev = fmaxf(
          sAA - (sA[0] * sA[0] + sA[1] * sA[1] + sA[2] * sA[2]) / fmaxf(n, 1.0f),
          0.0f);
      e = n > 0.0f ? ev : 0.0f;
    } else if (kMode == kDist) {
      const float inv_n = 1.0f / fmaxf(n, 1.0f);
      float H = (sJJ[0] + sJJ[1] + sJJ[2]) -
                inv_n * (sJ[0] * sJ[0] + sJ[1] * sJ[1] + sJ[2] * sJ[2]);
      const float b = (sAJ[0] + sAJ[1] + sAJ[2]) -
                      inv_n * (sA[0] * sJ[0] + sA[1] * sJ[1] + sA[2] * sJ[2]);
      H = H + P.reg_weight * P.weight[v];
      const float step = (n > 0.0f && H != 0.0f) ? P.damping * b / H : 0.0f;
      out0[v] = d - step;
    } else {
      const float inv_n = 1.0f / fmaxf(n, 1.0f);
      out0[v] = n;
#pragma unroll
      for (int c = 0; c < 3; ++c) out1[3 * v + c] = sA[c] * inv_n;
    }
  }
  if (kMode == kEnergy) {
    e = warp_sum(e);
    if ((threadIdx.x & 31) == 0) warp_e[threadIdx.x >> 5] = e;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.0f;
      for (int w = 0; w < kWarps; ++w) s += warp_e[w];
      partials[blockIdx.x] = s;
    }
  }
}

// One warp: the CTAs' energies added in a fixed order.
__global__ void ba_energy_finish(const float* partials, int count,
                                 float* out) {
  float s = 0.0f;
  for (int i = threadIdx.x; i < count; i += 32) s += partials[i];
  s = warp_sum(s);
  if (threadIdx.x == 0) out[0] = s;
}

__global__ void __launch_bounds__(kThreads)
    ba_pose_systems(Problem P, const float* n_in, const float* mean_in,
                    float* partials) {
  extern __shared__ float pose[];
  __shared__ float stage[2][kWarps][kPoseTerms];
  const Intrinsics k = load_frames(P, pose);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int v = blockIdx.x * kThreads + threadIdx.x;
  bool active = false;
  float x[3] = {0.0f, 0.0f, 0.0f}, mean[3] = {0.0f, 0.0f, 0.0f}, wh = 0.0f;
  if (v < P.V) {
    const float n = n_in[v], d = P.dist[v];
    active = n > 0.0f && P.vmask[v] != 0 && fabsf(d) <= P.vs;
    if (active) {
      surface_point(P, v, d, x);
#pragma unroll
      for (int c = 0; c < 3; ++c) mean[c] = mean_in[3 * v + c];
      wh = 1.0f - 1.0f / fmaxf(n, 1.0f);
    }
  }
  const unsigned char* vis =
      P.vis + static_cast<size_t>(active ? v : 0) * P.F;
  for (int f = 0; f < P.F; ++f) {
    float terms[kPoseTerms];
#pragma unroll
    for (int j = 0; j < kPoseTerms; ++j) terms[j] = 0.0f;
    const float* Rf = pose + 12 * f;
    Sample s;
    const bool take = active && vis[f] &&
                      project_sample(P, k, Rf, Rf + 9, f, x, s) &&
                      trunc_pass(P, s);
    if (take) {
      float dI[3][3];
      image_jacobian(P, k, s, dI);
      // Jc = [-dI R^T | dI x p]: row c of dI times hat(p) is dI_c x p
      float J[3][6];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
#pragma unroll
        for (int e = 0; e < 3; ++e)
          J[c][e] = -(dI[c][0] * Rf[3 * e] + dI[c][1] * Rf[3 * e + 1] +
                      dI[c][2] * Rf[3 * e + 2]);
        J[c][3] = dI[c][1] * s.p[2] - dI[c][2] * s.p[1];
        J[c][4] = dI[c][2] * s.p[0] - dI[c][0] * s.p[2];
        J[c][5] = dI[c][0] * s.p[1] - dI[c][1] * s.p[0];
      }
      int j = 0;
#pragma unroll
      for (int e = 0; e < 6; ++e) {
#pragma unroll
        for (int g = e; g < 6; ++g)
          terms[j++] = wh * J[0][e] * J[0][g] + wh * J[1][e] * J[1][g] +
                       wh * J[2][e] * J[2][g];
      }
      const float r[3] = {s.A[0] - mean[0], s.A[1] - mean[1], s.A[2] - mean[2]};
#pragma unroll
      for (int e = 0; e < 6; ++e)
        terms[21 + e] = r[0] * J[0][e] + r[1] * J[1][e] + r[2] * J[2][e];
    }
    float(*out)[kPoseTerms] = stage[f & 1];
    if (__any_sync(kFull, take)) {
#pragma unroll
      for (int j = 0; j < kPoseTerms; ++j) {
        const float t = warp_sum(terms[j]);
        if (lane == 0) out[warp][j] = t;
      }
    } else if (lane == 0) {
#pragma unroll
      for (int j = 0; j < kPoseTerms; ++j) out[warp][j] = 0.0f;
    }
    // one barrier a frame: the stage is double-buffered, and the threads
    // that read this frame's half pass the next barrier before any warp
    // writes it again
    __syncthreads();
    if (threadIdx.x < kPoseTerms) {
      float t = 0.0f;
      for (int w = 0; w < kWarps; ++w) t += out[w][threadIdx.x];
      partials[(static_cast<size_t>(blockIdx.x) * P.F + f) * kPoseTerms +
               threadIdx.x] = t;
    }
  }
}

// A warp an entry of the F systems: the CTAs' partials added in a fixed
// order, then H's upper-triangle entry written to both halves, or b's.
__global__ void __launch_bounds__(kThreads)
    ba_pose_finish(const float* partials, int ctas, int F, float* H,
                   float* b) {
  const int entry = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (entry >= F * kPoseTerms) return;  // whole warps
  const int f = entry / kPoseTerms, j = entry % kPoseTerms;
  float s = 0.0f;
  for (int c = lane; c < ctas; c += 32)
    s += partials[(static_cast<size_t>(c) * F + f) * kPoseTerms + j];
  s = warp_sum(s);
  if (lane != 0) return;
  if (j >= 21) {
    b[f * 6 + j - 21] = s;
    return;
  }
  int e = 0, g = j;  // j -> (e, g), g >= e, row by row
  while (g >= 6 - e) {
    g -= 6 - e;
    ++e;
  }
  g += e;
  H[f * 36 + e * 6 + g] = s;
  H[f * 36 + g * 6 + e] = s;
}

__global__ void __launch_bounds__(kThreads) ba_empty() {}

int ctas_for(int64_t V) { return static_cast<int>((V + kThreads - 1) / kThreads); }

size_t pose_smem(int64_t F) { return static_cast<size_t>(F) * 12 * sizeof(float); }

}  // namespace

// C entry points (bound with ctypes). Each launches on `stream`, does not
// synchronize and returns cudaGetLastError() of its launches (0 = success).
//
// gsdf_ba_ctas: the CTAs of a launch over V voxels (the length of the
// partials: one float a CTA for the energy, F x 27 for the pose systems);
// gsdf_ba_max_frames: the most frames a launch takes.
extern "C" int gsdf_ba_ctas(long long V) { return V < 1 ? -1 : ctas_for(V); }

extern "C" int gsdf_ba_max_frames() { return kMaxFrames; }

// gsdf_ba_voxel_sums_f32: `args` a BAArgs; mode 0 (energy): out0 f32 [1]
// the energy, partials f32 [ctas]; mode 1 (dist): out0 f32 [V] the stepped
// dist; mode 2 (mean): out0 f32 [V] the count n, out1 f32 [V, 3] the mean
// intensity.
extern "C" int gsdf_ba_voxel_sums_f32(const void* args, int mode, void* out0,
                                      void* out1, void* partials,
                                      void* stream) {
  const BAArgs& a = *static_cast<const BAArgs*>(args);
  if (!valid_args(a) || mode < kEnergy || mode > kMean)
    return cudaErrorInvalidValue;
  const Problem p = unpack(a);
  const int ctas = ctas_for(a.V);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o0 = static_cast<float*>(out0);
  float* o1 = static_cast<float*>(out1);
  float* part = static_cast<float*>(partials);
  if (mode == kEnergy) {
    ba_voxel_sums<kEnergy><<<ctas, kThreads, pose_smem(a.F), s>>>(p, o0, o1,
                                                                   part);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    ba_energy_finish<<<1, 32, 0, s>>>(part, ctas, o0);
  } else if (mode == kDist) {
    ba_voxel_sums<kDist><<<ctas, kThreads, pose_smem(a.F), s>>>(p, o0, o1,
                                                                 part);
  } else {
    ba_voxel_sums<kMean><<<ctas, kThreads, pose_smem(a.F), s>>>(p, o0, o1,
                                                                 part);
  }
  return static_cast<int>(cudaGetLastError());
}

// gsdf_ba_pose_systems_f32: `args` a BAArgs, n f32 [V] and mean f32 [V, 3]
// from the mean mode; partials f32 [ctas, F, 27] scratch; H f32 [F, 6, 6]
// and b f32 [F, 6] receive the systems.
extern "C" int gsdf_ba_pose_systems_f32(const void* args, const void* n,
                                        const void* mean, void* partials,
                                        void* H, void* b, void* stream) {
  const BAArgs& a = *static_cast<const BAArgs*>(args);
  if (!valid_args(a)) return cudaErrorInvalidValue;
  const Problem p = unpack(a);
  const int ctas = ctas_for(a.V);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
  ba_pose_systems<<<ctas, kThreads, pose_smem(a.F), s>>>(
      p, static_cast<const float*>(n), static_cast<const float*>(mean), part);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int warps = static_cast<int>(a.F) * kPoseTerms;
  ba_pose_finish<<<(warps * 32 + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      part, ctas, static_cast<int>(a.F), static_cast<float*>(H),
      static_cast<float*>(b));
  return static_cast<int>(cudaGetLastError());
}

// gsdf_ba_empty: an empty kernel at the launch of V voxels (ctas x 256).
// Used by the measurements only, never by the package.
extern "C" int gsdf_ba_empty(long long V, void* stream) {
  if (V < 1) return cudaErrorInvalidValue;
  ba_empty<<<ctas_for(V), kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
