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
// Both kernels run CTAs of 5 warps; a warp owns 32 consecutive voxels, a
// lane one voxel, and walks their frames in chunks of 32 (a bit a frame).
// Every global load of the first chunk (the voxel's inputs, its
// visibility bits, the poses for shared memory) is in flight before the
// first wait. A launch then takes one of two paths, chosen on the host by
// its frames and voxels (dense_launch):
//   dense (at most kDenseFrames frames and a warp a scheduler: latency
//     bounds it, as on the app's own problems): each lane walks its
//     voxel's visible frames in frame order, kDenseBatch frames at a time,
//     projecting each and loading the taps of those that land in the
//     image before it uses any: a round trip to the images a batch of
//     frames, not a frame.
//   full card (instruction throughput bounds it): the gate comes first.
//     Lane j loads frame f0 + j's visibility byte of each of the 32 rows
//     (32 loads in flight, 32 consecutive bytes a load) and projects the
//     voxels its frame sees with that frame's pose in registers (the
//     points in shared memory, no bank conflict). Only the passing pairs
//     are then sampled: numbered over the warp, a pair a lane, kBatch
//     pairs' taps in flight (one for the dist step), so a warp waits for
//     about one round trip a chunk however few of its pairs pass, and no
//     lane idles behind another's frames.
// A pair's projection is recomputed where it is used, in the same float32
// operations, so it gives the same bits as in the gate.
//
//   ba_voxel_sums (one instance a mode and path): each voxel's pairs are
//     added into running sums in frame order, as the JAX scan does (on the
//     full-card path each pair's row goes through shared memory to the
//     lane that owns its voxel):
//       energy: n, sum A, sum |A|^2 -> the voxel's clamped energy. A warp's
//         energies are added by a fixed shuffle tree into one partial a
//         warp; `ba_energy_finish` (one CTA) adds them as a thread-a-voxel
//         kernel of 256 threads a CTA would (8 warps in order, then
//         lane-strided, then a shuffle tree), so the energy keeps its bits. It is the same bits on
//         every run: the optimizer's stopping test compares energies.
//       dist: n, sum A, sum Jd, sum A Jd, sum Jd^2 with Jd = dI/dp (-R^T g)
//         (g unnormalized) -> dist - damping b / H, solveDist's closed form
//         with H += reg_weight weight and the (n > 0) & (H != 0) guard.
//       mean: n and the mean intensity, for ba_pose_systems.
//     dist, n and the mean are the same bits as a thread walking its
//     voxel's frames in order.
//   ba_pose_systems: with kernel 1's n and mean, each pair's pose Jacobian
//     Jc = [-dI/dp R^T | dI/dp x p] (3 x 6) gives 27 terms: the 21 entries
//     of (1 - 1/n) Jc^T Jc's upper triangle and the 6 of r^T Jc (r = A -
//     mean). Dense path: the warp walks the frames its voxels see in order,
//     kDenseBatch at a time, a frame's terms reduced by a fixed shuffle
//     tree into the warp's stage. Full-card path: after the gate, 32
//     ballots give each frame's mask of passing voxels and a scan numbers
//     the warp's pairs frame by frame; a pair a lane, the terms go to a row
//     of shared memory and lanes 0-26 add the rows in pair order, storing
//     a frame's sums in the warp's stage when the frame changes. Either
//     way a frame's sums have one owner in the warp and there is no
//     barrier a frame: after each chunk one barrier lets the CTA add its
//     warps' stages in warp order and write its [chunk, 27] partial,
//     contiguous; `ba_pose_finish` (launched as a programmatic dependent,
//     as the energy's finish is; 32 warps an entry block, each adding a
//     32nd of the CTAs in order) writes H [F, 6, 6] (mirrored) and b [F,
//     6]. No atomic decides an order: H and b are the same bits on every
//     run, so every rank of a mesh solves the same systems.
//   The F poses (12 floats a frame, 3 float4) sit in shared memory; K comes
//   from device memory (no host read).
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
// far below the card's rate. What is left is latency and instruction
// throughput: the projections of the visible pairs, most of which do not
// pass (98% at the scale point), and a few dependent round trips a warp;
// the paths above keep both low. No TMA, no tensor cores. Measured times: PERF.md.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 160;    // 5 warps a CTA, both kernels
constexpr int kWarps = kThreads / 32;
// CTAs an SM must hold for 640 CTAs (V = 102400) to run in one wave on 132
// SMs (the full-card paths; a dense launch has at most one CTA an SM)
constexpr int kMinCtas = 5;
constexpr int kChunk = 32;       // frames a chunk: a bit a frame in a mask
constexpr int kBatch = 2;        // passing pairs a lane samples at once
constexpr int kDenseBatch = 2;   // frames a lane samples at once, dense
// the most frames of a launch on the dense paths: a quarter of a chunk, so
// that a gate a lane a frame would leave most of a warp idle
constexpr int kDenseFrames = 8;
constexpr int kPoseTerms = 27;   // H's upper triangle (21) and b (6)
// the most frames a launch takes: the poses (12 floats a frame) sit in
// shared memory, 46 KB at 960 frames
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

// A (voxel, frame) pair's projection: the point in the camera frame, 1 / z
// and the pixel position.
struct Proj {
  float p[3], z_inv, u, v;
};

// The four taps of a bilinear sample (3 channels each) and its fractions.
struct Taps {
  float i00[3], i01[3], i10[3], i11[3];
  float fu, fv;
};

// The intensity and its derivatives along u and v.
struct Sample {
  float A[3], dAdu[3], dAdv[3];
};

// The CTA's copy of the poses (R row-major, then t; 12 floats a frame: 3
// float4) and the intrinsics.
__device__ __forceinline__ Intrinsics load_frames(const Problem& P,
                                                  float4* pose) {
  float* flat = reinterpret_cast<float*>(pose);
  for (int i = threadIdx.x; i < P.F * 12; i += kThreads) {
    const int f = i / 12, j = i % 12;
    flat[i] = j < 9 ? P.R[f * 9 + j] : P.t[f * 3 + j - 9];
  }
  Intrinsics k;
  k.fx = __ldg(P.K + 0);
  k.fy = __ldg(P.K + 4);
  k.cx = __ldg(P.K + 2);
  k.cy = __ldg(P.K + 5);
  return k;
}

// One frame's pose out of shared memory: R row-major in R[0..8], t.
struct Pose {
  float R[9], t[3];
};

__device__ __forceinline__ Pose pose_of(const float4* pose, int f) {
  const float4 a = pose[3 * f], b = pose[3 * f + 1], c = pose[3 * f + 2];
  return Pose{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x}, {c.y, c.z, c.w}};
}

// A voxel's index, gradient (unnormalized) and dist, loaded at once (zeros
// beyond V).
struct Voxel {
  int vox[3];
  float g[3], d;
};

__device__ __forceinline__ Voxel load_voxel(const Problem& P, int v) {
  const bool real = v < P.V;
  Voxel o;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    o.vox[c] = real ? P.vox[3 * v + c] : 0;
    o.g[c] = real ? P.grad[3 * v + c] : 0.0f;
  }
  o.d = real ? P.dist[v] : 0.0f;
  return o;
}

// x = vox vs - dist g / max(|g|, 1e-12)
__device__ __forceinline__ void surface_point(const Problem& P, const Voxel& o,
                                              float x[3]) {
  const float nrm = fmaxf(
      sqrtf(o.g[0] * o.g[0] + o.g[1] * o.g[1] + o.g[2] * o.g[2]), 1e-12f);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    x[c] = static_cast<float>(o.vox[c]) * P.vs - o.d * (o.g[c] / nrm);
}

// Lane j's mask of the warp's voxels that frame f0 + j sees (bit r: voxel
// v0 + r). Lane j loads frame f0 + j's byte of each of the 32 rows: 32
// loads in flight, the lanes of one load on 32 consecutive bytes.
__device__ __forceinline__ unsigned visible_voxels(const Problem& P, int v0,
                                                   int f0, int lane) {
  const int f = f0 + lane;
  unsigned char b[32];
#pragma unroll
  for (int r = 0; r < 32; ++r)
    b[r] = (f < P.F && v0 + r < P.V)
               ? __ldg(P.vis + static_cast<size_t>(v0 + r) * P.F + f)
               : 0;
  unsigned col = 0;
#pragma unroll
  for (int r = 0; r < 32; ++r) col |= (b[r] != 0 ? 1u : 0u) << r;
  return col;
}

// The lanes' 32 x 32 bit matrix transposed: bit j of lane r's result is
// bit r of lane j's mask (a ballot for each bit that some lane has).
__device__ __forceinline__ unsigned transpose_bits(unsigned m, int lane) {
  unsigned out = 0;
  for (unsigned any = __reduce_or_sync(kFull, m); any != 0; any &= any - 1) {
    const int r = __ffs(any) - 1;
    const unsigned b = __ballot_sync(kFull, (m >> r) & 1u);
    if (lane == r) out = b;
  }
  return out;
}

// Projects x into the frame of pose `o`. Returns whether it lands in the
// image in front of the camera.
__device__ __forceinline__ bool project(const Problem& P, const Intrinsics& k,
                                        const Pose& o, const float x[3],
                                        Proj& q) {
  const float d0 = x[0] - o.t[0], d1 = x[1] - o.t[1], d2 = x[2] - o.t[2];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    q.p[c] = d0 * o.R[c] + d1 * o.R[3 + c] + d2 * o.R[6 + c];
  const float z = q.p[2];
  const float safe_z = fabsf(z) > 1e-12f ? z : 1.0f;
  q.z_inv = 1.0f / safe_z;
  q.u = k.fx * q.p[0] * q.z_inv + k.cx;
  q.v = k.fy * q.p[1] * q.z_inv + k.cy;
  return q.u >= 0.0f && q.u < static_cast<float>(P.W) && q.v >= 0.0f &&
         q.v < static_cast<float>(P.H) && z > 1e-12f;
}

// The gate a lane a frame: lane j, its frame's pose in registers, projects
// the voxels of `vis` (bit r: voxel r, whose point is xs[3r..3r+2], the
// warp's copy in shared memory). Returns lane j's mask of the voxels whose
// point lands in frame f0 + j's image. The lanes read the poses of
// consecutive frames and the points of distinct voxels: no bank conflict.
__device__ __forceinline__ unsigned gate_by_frame(const Problem& P,
                                                  const Intrinsics& k,
                                                  const float4* pose, int f0,
                                                  unsigned vis,
                                                  const float* xs, int lane) {
  if (f0 + lane >= P.F) return 0u;
  const Pose o = pose_of(pose, f0 + lane);
  unsigned pass = 0;
  for (unsigned m = vis; m != 0; m &= m - 1) {
    const int r = __ffs(m) - 1;
    const float x[3] = {xs[3 * r], xs[3 * r + 1], xs[3 * r + 2]};
    Proj q;
    if (project(P, k, o, x, q)) pass |= 1u << r;
  }
  return pass;
}

// Loads the taps of frame f at (u, v) under the sampler's clamp and
// in-bounds rule (`filters.bilinear_sample_grad`).
__device__ __forceinline__ void load_taps(const Problem& P, int f, float u,
                                          float v, Taps& t) {
  const float uc = fminf(fmaxf(u, 0.0f), P.u_max);
  const float vc = fminf(fmaxf(v, 0.0f), P.v_max);
  const float u0f = floorf(uc), v0f = floorf(vc);
  const int u0 = static_cast<int>(u0f), v0 = static_cast<int>(v0f);
  const int u1 = min(u0 + 1, P.W - 1), v1 = min(v0 + 1, P.H - 1);
  t.fu = uc - u0f;
  t.fv = vc - v0f;
  const float* img = P.images + static_cast<size_t>(f) * P.H * P.W * 3;
  const float* r0 = img + static_cast<size_t>(v0) * P.W * 3;
  const float* r1 = img + static_cast<size_t>(v1) * P.W * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    t.i00[c] = __ldg(r0 + 3 * u0 + c);
    t.i01[c] = __ldg(r0 + 3 * u1 + c);
    t.i10[c] = __ldg(r1 + 3 * u0 + c);
    t.i11[c] = __ldg(r1 + 3 * u1 + c);
  }
}

// The bilinear sample with the analytic dA/du and dA/dv.
__device__ __forceinline__ void bilinear(const Taps& t, Sample& s) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float top = t.i00[c] + t.fu * (t.i01[c] - t.i00[c]);
    const float bot = t.i10[c] + t.fu * (t.i11[c] - t.i10[c]);
    s.A[c] = top + t.fv * (bot - top);
    s.dAdu[c] = (1.0f - t.fv) * (t.i01[c] - t.i00[c]) +
                t.fv * (t.i11[c] - t.i10[c]);
    s.dAdv[c] = (1.0f - t.fu) * (t.i10[c] - t.i00[c]) +
                t.fu * (t.i11[c] - t.i01[c]);
  }
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
                                               const Proj& q, const Sample& s,
                                               float dI[3][3]) {
  const float zi2 = q.z_inv * q.z_inv;
  const float du0 = k.fx * q.z_inv, du2 = -k.fx * q.p[0] * zi2;
  const float dv1 = k.fy * q.z_inv, dv2 = -k.fy * q.p[1] * zi2;
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

// Exclusive prefix sum of `c` over the lanes; `total` the warp's sum.
__device__ __forceinline__ int lane_offsets(int c, int lane, int& total) {
  int off = c;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int o = __shfl_up_sync(kFull, off, s);
    if (lane >= s) off += o;
  }
  total = __shfl_sync(kFull, off, 31);
  return off - c;
}

// The lane that holds item i of a numbering in lane order: the last lane
// whose first item (`off`, non-decreasing over the lanes) is <= i.
__device__ __forceinline__ int owner_lane(int off, int i) {
  int L = 0;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const int o = __shfl_sync(kFull, off, L + s);
    if (o <= i) L += s;
  }
  return L;
}

// The position of the k-th (from 0) set bit of m; m has more than k.
__device__ __forceinline__ int nth_bit(unsigned m, int k) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const int c = __popc(m & ((1u << w) - 1u));
    if (k >= c) {
      k -= c;
      m >>= w;
      pos += w;
    }
  }
  return pos;
}

// A voxel's running sums over its pairs, in frame order.
template <int kMode>
struct Sums {
  float n = 0.0f, sAA = 0.0f;
  float sA[3] = {0.0f, 0.0f, 0.0f}, sJ[3] = {0.0f, 0.0f, 0.0f};
  float sAJ[3] = {0.0f, 0.0f, 0.0f}, sJJ[3] = {0.0f, 0.0f, 0.0f};

  __device__ __forceinline__ void add(const float A[3], const float Jd[3]) {
    n += 1.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) sA[c] += A[c];
    if (kMode == kEnergy) sAA += A[0] * A[0] + A[1] * A[1] + A[2] * A[2];
    if (kMode == kDist) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        sJ[c] += Jd[c];
        sAJ[c] += A[c] * Jd[c];
        sJJ[c] += Jd[c] * Jd[c];
      }
    }
  }
};

// The dist step's Jd = dI/dp (-R^T g) of a pair (g unnormalized).
__device__ __forceinline__ void pair_jd(const Problem& P, const Intrinsics& k,
                                        const Pose& o, const float x[3],
                                        const float g[3], const Sample& s,
                                        float Jd[3]) {
  Proj q;
  project(P, k, o, x, q);
  float Rtg[3];  // -R^T g, formed before dI/dp: the pose is then dead
#pragma unroll
  for (int c = 0; c < 3; ++c)
    Rtg[c] = -(g[0] * o.R[c] + g[1] * o.R[3 + c] + g[2] * o.R[6 + c]);
  float dI[3][3];
  image_jacobian(P, k, q, s, dI);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    Jd[c] = dI[c][0] * Rtg[0] + dI[c][1] * Rtg[1] + dI[c][2] * Rtg[2];
}

// A passing pair's row in shared memory, for the lane that sums its voxel:
// A, then (dist) Jd, then (mean, dist) whether it passes the intensity
// gate. Odd strides.
// kWarpFloats: the shared memory of ba_voxel_sums a warp takes after the
// poses, its copy of its points (3 floats a voxel), then its rows.
// kPairs: the pairs a lane samples a round on the full-card path. The dist
// step's larger terms leave registers for one, and its 12 channel sums
// live in shared memory there (kSums floats a lane): no spills at 72.
template <int kMode>
struct RowOf {
  static constexpr int kFloats = kMode == kEnergy ? 3 : (kMode == kMean ? 5 : 7);
  static constexpr int kPairs = kMode == kDist ? 1 : kBatch;
  static constexpr int kSums = kMode == kDist ? 12 : 0;
  static constexpr int kWarpFloats = 3 * 32 + 32 * kPairs * kFloats + 32 * kSums;
};

// Programmatic dependent launch: the kernels' finishes are launched as
// dependents of their kernel, which lets them start (its CTAs all resident)
// and wait on the card instead of after a full launch.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;");
}

// In a dependent: waits until the primary grid has finished and its
// writes are visible.
__device__ __forceinline__ void wait_for_primary() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Bit j of the result: frame f0 + j sees voxel v (its own row of
// visibility bytes; the dense paths).
__device__ __forceinline__ unsigned own_visible_frames(const Problem& P, int v,
                                                       int f0) {
  unsigned m = 0;
  if (v < P.V) {
    const unsigned char* row = P.vis + static_cast<size_t>(v) * P.F + f0;
    const int n = min(kChunk, P.F - f0);
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (j < n && __ldg(row + j) != 0) m |= 1u << j;
  }
  return m;
}

// kDense: each lane walks its own voxel's visible frames in order,
// kDenseBatch frames at a time, their taps in flight together (short
// launches, which latency bounds; dense_launch). Otherwise the gate
// first, then the warp's passing pairs compacted and sampled a pair a lane
// (launches that fill the card, bound by instruction throughput).
template <int kMode, bool kDense>
__global__ void __launch_bounds__(kThreads, kDense ? 1 : kMinCtas)
    ba_voxel_sums(Problem P, float* out0, float* out1, float* partials) {
  constexpr int kRow = RowOf<kMode>::kFloats;
  constexpr int kPairs = RowOf<kMode>::kPairs;
  constexpr int kRound = 32 * kPairs;  // passing pairs a round
  if (kMode == kEnergy) launch_dependents();  // the finish may start
  extern __shared__ float4 smem4[];
  float4* pose = smem4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* xs = reinterpret_cast<float*>(smem4 + 3 * P.F) +
              warp * RowOf<kMode>::kWarpFloats;
  float* rows = xs + 3 * 32;
  const int v0 = blockIdx.x * kThreads + 32 * warp;
  const int v = v0 + lane;
  const bool real = v < P.V;
  // the loads of the first chunk all in flight before the first wait
  const unsigned vis0 =
      kDense ? own_visible_frames(P, v, 0) : visible_voxels(P, v0, 0, lane);
  const Voxel vx = load_voxel(P, v);
  const bool vm = real && P.vmask[v] != 0;
  const Intrinsics k = load_frames(P, pose);
  const float d = vx.d;
  const float g[3] = {vx.g[0], vx.g[1], vx.g[2]};
  // the energy and the pose step take voxels with |dist| <= vs; the dist
  // step every real voxel
  const bool take = vm && (kMode == kDist || fabsf(d) <= P.vs);
  float x[3];
  surface_point(P, vx, x);
  __syncthreads();
  if (v0 >= P.V) return;  // whole warps
  Sums<kMode> acc;
  if constexpr (kDense) {
    for (int f0 = 0; f0 < P.F; f0 += kChunk) {
      unsigned left =
          take ? (f0 == 0 ? vis0 : own_visible_frames(P, v, f0)) : 0u;
      while (__any_sync(kFull, left != 0)) {
        int fs[kDenseBatch];
        Taps t[kDenseBatch];
#pragma unroll
        for (int b = 0; b < kDenseBatch; ++b) {
          fs[b] = -1;
          if (left == 0) continue;
          const int f = f0 + __ffs(left) - 1;
          left &= left - 1;
          Proj q;
          if (project(P, k, pose_of(pose, f), x, q)) {
            fs[b] = f;
            load_taps(P, f, q.u, q.v, t[b]);
          }
        }
#pragma unroll
        for (int b = 0; b < kDenseBatch; ++b) {
          if (fs[b] < 0) continue;
          Sample s;
          bilinear(t[b], s);
          if (kMode != kEnergy && !trunc_pass(P, s)) continue;
          float Jd[3] = {0.0f, 0.0f, 0.0f};
          if (kMode == kDist) pair_jd(P, k, pose_of(pose, fs[b]), x, g, s, Jd);
          acc.add(s.A, Jd);
        }
      }
    }
  } else {
    // the dist step's channel sums: sA, sJ, sAJ, sJJ (3 each), a column a
    // lane
    float* sums = rows + kRound * kRow + lane;
#pragma unroll
    for (int c = 0; c < RowOf<kMode>::kSums; ++c) sums[32 * c] = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) xs[3 * lane + c] = x[c];
    __syncwarp();
    const unsigned takes = __ballot_sync(kFull, take);
    for (int f0 = 0; f0 < P.F; f0 += kChunk) {
      // lane r: the frames of the chunk whose image its voxel's point lands in
      const unsigned vis =
          (f0 == 0 ? vis0 : visible_voxels(P, v0, f0, lane)) & takes;
      const unsigned pass =
          transpose_bits(gate_by_frame(P, k, pose, f0, vis, xs, lane), lane);
      const int cnt = __popc(pass);
      int total;
      const int off = lane_offsets(cnt, lane, total);
      // the warp's passing pairs numbered voxel by voxel, frame by frame, a
      // pair a lane, kPairs pairs' taps in flight; each pair's row goes to
      // shared memory for the lane that sums its voxel
      for (int base = 0; base < total; base += kRound) {
        int fs[kPairs], L[kPairs];
        Taps t[kPairs];
#pragma unroll
        for (int b = 0; b < kPairs; ++b) {
          fs[b] = -1;
          if (base + 32 * b >= total) continue;  // the whole warp
          const int i = base + 32 * b + lane;
          L[b] = owner_lane(off, i);
          const unsigned pm = __shfl_sync(kFull, pass, L[b]);
          const int first = __shfl_sync(kFull, off, L[b]);
          if (i < total) {
            fs[b] = f0 + nth_bit(pm, i - first);
            const float xr[3] = {xs[3 * L[b]], xs[3 * L[b] + 1],
                                 xs[3 * L[b] + 2]};
            Proj q;
            project(P, k, pose_of(pose, fs[b]), xr, q);
            load_taps(P, fs[b], q.u, q.v, t[b]);
          }
        }
#pragma unroll
        for (int b = 0; b < kPairs; ++b) {
          if (fs[b] < 0) continue;
          Sample s;
          bilinear(t[b], s);
          float* row = rows + (32 * b + lane) * kRow;
#pragma unroll
          for (int c = 0; c < 3; ++c) row[c] = s.A[c];
          if (kMode == kMean) row[3] = trunc_pass(P, s) ? 1.0f : 0.0f;
          if (kMode == kDist) {
            const bool taken = trunc_pass(P, s);
            row[6] = taken ? 1.0f : 0.0f;
            if (taken) {
              const float xr[3] = {xs[3 * L[b]], xs[3 * L[b] + 1],
                                   xs[3 * L[b] + 2]};
              float gr[3];
#pragma unroll
              for (int c = 0; c < 3; ++c) gr[c] = P.grad[3 * (v0 + L[b]) + c];
              pair_jd(P, k, pose_of(pose, fs[b]), xr, gr, s, row + 3);
            }
          }
        }
        __syncwarp();
        // each lane adds its voxel's rows of this round, in frame order
        const int hi = min(off + cnt, base + kRound);
        for (int r = max(off, base); r < hi; ++r) {
          const float* row = rows + (r - base) * kRow;
          if (kMode == kMean && row[3] == 0.0f) continue;
          if (kMode == kDist && row[6] == 0.0f) continue;
          const float A[3] = {row[0], row[1], row[2]};
          if constexpr (kMode == kDist) {
            // Sums::add's sums, each in the same order
            acc.n += 1.0f;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              const float Jd = row[3 + c];
              sums[32 * c] += A[c];
              sums[32 * (3 + c)] += Jd;
              sums[32 * (6 + c)] += A[c] * Jd;
              sums[32 * (9 + c)] += Jd * Jd;
            }
          } else {
            const float Jd[3] = {0.0f, 0.0f, 0.0f};
            acc.add(A, Jd);
          }
        }
        __syncwarp();
      }
    }
    if constexpr (kMode == kDist) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        acc.sA[c] = sums[32 * c];
        acc.sJ[c] = sums[32 * (3 + c)];
        acc.sAJ[c] = sums[32 * (6 + c)];
        acc.sJJ[c] = sums[32 * (9 + c)];
      }
    }
  }
  if (kMode == kEnergy) {
    // sum_i |A_i - mean|^2 = sum |A|^2 - |sum A|^2 / n, clamped at 0
    const float ev = fmaxf(
        acc.sAA - (acc.sA[0] * acc.sA[0] + acc.sA[1] * acc.sA[1] +
                   acc.sA[2] * acc.sA[2]) / fmaxf(acc.n, 1.0f),
        0.0f);
    const float e = warp_sum(acc.n > 0.0f ? ev : 0.0f);
    if (lane == 0) partials[v0 >> 5] = e;
  } else if (v < P.V) {
    const float inv_n = 1.0f / fmaxf(acc.n, 1.0f);
    if (kMode == kDist) {
      float H = (acc.sJJ[0] + acc.sJJ[1] + acc.sJJ[2]) -
                inv_n * (acc.sJ[0] * acc.sJ[0] + acc.sJ[1] * acc.sJ[1] +
                         acc.sJ[2] * acc.sJ[2]);
      const float b = (acc.sAJ[0] + acc.sAJ[1] + acc.sAJ[2]) -
                      inv_n * (acc.sA[0] * acc.sJ[0] + acc.sA[1] * acc.sJ[1] +
                               acc.sA[2] * acc.sJ[2]);
      H = H + P.reg_weight * P.weight[v];
      const float step =
          (acc.n > 0.0f && H != 0.0f) ? P.damping * b / H : 0.0f;
      out0[v] = P.dist[v] - step;
    } else {
      out0[v] = acc.n;
#pragma unroll
      for (int c = 0; c < 3; ++c) out1[3 * v + c] = acc.sA[c] * inv_n;
    }
  }
}

// The warps' energies added as a thread-a-voxel kernel of 256 threads a
// CTA would add them: each 8 warps (256 voxels) in warp order, then lane l
// of one warp those sums l, l + 32, ... in order, then a shuffle tree.
constexpr int kFinishThreads = 512;

__global__ void __launch_bounds__(kFinishThreads)
    ba_energy_finish(const float* partials, int warps, float* out) {
  __shared__ float tile[kFinishThreads];
  wait_for_primary();
  const int tiles = (warps + 7) / 8;
  float s = 0.0f;
  for (int base = 0; base < tiles; base += kFinishThreads) {
    const int t = base + threadIdx.x;
    float w[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      w[i] = 8 * t + i < warps ? partials[8 * t + i] : 0.0f;
    float ts = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) ts += w[i];
    tile[threadIdx.x] = ts;
    __syncthreads();
    if (threadIdx.x < 32)
      for (int i = threadIdx.x; i < kFinishThreads && base + i < tiles;
           i += 32)
        s += tile[i];
    __syncthreads();
  }
  if (threadIdx.x < 32) {
    s = warp_sum(s);
    if (threadIdx.x == 0) out[0] = s;
  }
}

// Shared memory of the pose kernel, after the poses: each warp's stage (its
// sums of the chunk's frames), its rows of pair terms, their frames and its
// copy of its points.
constexpr int kStageFloats = kWarps * kChunk * kPoseTerms;
constexpr int kTermFloats = kWarps * 32 * kPoseTerms;

// A pair's pose Jacobian Jc = [-dI/dp R^T | dI/dp x p] (3 x 6): row c of
// dI/dp times hat(p) is dI_c x p.
__device__ __forceinline__ void pose_jacobian(const Problem& P,
                                              const Intrinsics& k,
                                              const Pose& o, const Proj& q,
                                              const Sample& s, float J[3][6]) {
  float dI[3][3];
  image_jacobian(P, k, q, s, dI);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int e = 0; e < 3; ++e)
      J[c][e] = -(dI[c][0] * o.R[3 * e] + dI[c][1] * o.R[3 * e + 1] +
                  dI[c][2] * o.R[3 * e + 2]);
    J[c][3] = dI[c][1] * q.p[2] - dI[c][2] * q.p[1];
    J[c][4] = dI[c][2] * q.p[0] - dI[c][0] * q.p[2];
    J[c][5] = dI[c][0] * q.p[1] - dI[c][1] * q.p[0];
  }
}

// A pair's 27 pose terms from its Jacobian J, its weight wh (1 - 1/n, or 0
// for a pair that does not count) and r = A - mean: the 21 entries of
// wh Jc^T Jc's upper triangle, row by row, then the 6 of r^T Jc. Each goes
// to emit(t, value) as it is formed.
template <class Emit>
__device__ __forceinline__ void pose_terms(const float J[3][6], float wh,
                                           const float r[3], Emit emit) {
  int t = 0;
#pragma unroll
  for (int e = 0; e < 6; ++e) {
#pragma unroll
    for (int h = e; h < 6; ++h)
      emit(t++, wh * J[0][e] * J[0][h] + wh * J[1][e] * J[1][h] +
                    wh * J[2][e] * J[2][h]);
  }
#pragma unroll
  for (int e = 0; e < 6; ++e)
    emit(21 + e, r[0] * J[0][e] + r[1] * J[1][e] + r[2] * J[2][e]);
}

// kDense: the warp walks the frames its voxels see in order, kDenseBatch at
// a time, each lane its own voxel's pair, the pairs' taps in flight
// together; a frame's 27 sums are reduced by a fixed shuffle tree into the
// warp's stage (short launches; dense_launch). Otherwise the
// gate first, then the warp's passing pairs numbered frame by frame and
// sampled a pair a lane, their terms added in pair order by lanes 0-26
// (launches that fill the card).
template <bool kDense>
__global__ void __launch_bounds__(kThreads, kDense ? 1 : kMinCtas)
    ba_pose_systems(Problem P, const float* n_in, const float* mean_in,
                    float* partials) {
  launch_dependents();  // the finish may start
  extern __shared__ float4 smem4[];
  float4* pose = smem4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* stage = reinterpret_cast<float*>(smem4 + 3 * P.F);
  float* my_stage = stage + warp * kChunk * kPoseTerms;
  float* my_terms = stage + kStageFloats + warp * 32 * kPoseTerms;
  int* my_frame =
      reinterpret_cast<int*>(stage + kStageFloats + kTermFloats) + warp * 32;
  float* xs = stage + kStageFloats + kTermFloats + kWarps * 32 + warp * 3 * 32;
  const int v0 = blockIdx.x * kThreads + 32 * warp;
  const int v = v0 + lane;
  const bool real = v < P.V;
  // the loads of the first chunk all in flight before the first wait
  const unsigned vis0 =
      kDense ? own_visible_frames(P, v, 0) : visible_voxels(P, v0, 0, lane);
  const Voxel vx = load_voxel(P, v);
  const float n = real ? n_in[v] : 0.0f;
  const bool vm = real && P.vmask[v] != 0;
  float mean[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) mean[c] = real ? mean_in[3 * v + c] : 0.0f;
  const Intrinsics k = load_frames(P, pose);
  const bool active = n > 0.0f && vm && fabsf(vx.d) <= P.vs;
  float x[3] = {0.0f, 0.0f, 0.0f}, wh = 0.0f;
  if (active) {
    surface_point(P, vx, x);
    wh = 1.0f - 1.0f / fmaxf(n, 1.0f);
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) mean[c] = 0.0f;
  }
  if (!kDense) {
#pragma unroll
    for (int c = 0; c < 3; ++c) xs[3 * lane + c] = x[c];
  }
  const unsigned actives = __ballot_sync(kFull, active);
  for (int f0 = 0; f0 < P.F; f0 += kChunk) {
    const int fc = min(kChunk, P.F - f0);
    // the poses are in; the previous chunk's stages are read
    __syncthreads();
    for (int i = lane; i < kChunk * kPoseTerms; i += 32) my_stage[i] = 0.0f;
    __syncwarp();
    if constexpr (kDense) {
      const unsigned seen =
          active ? (f0 == 0 ? vis0 : own_visible_frames(P, v, f0)) : 0u;
      // the frames some lane sees, in order, the same on every lane
      for (unsigned frames = __reduce_or_sync(kFull, seen); frames != 0;) {
        int js[kDenseBatch];
        bool took[kDenseBatch];
        Taps t[kDenseBatch];
#pragma unroll
        for (int b = 0; b < kDenseBatch; ++b) {
          js[b] = -1;
          took[b] = false;
          if (frames == 0) continue;
          js[b] = __ffs(frames) - 1;
          frames &= frames - 1;
          Proj q;
          if (((seen >> js[b]) & 1u) &&
              project(P, k, pose_of(pose, f0 + js[b]), x, q)) {
            took[b] = true;
            load_taps(P, f0 + js[b], q.u, q.v, t[b]);
          }
        }
#pragma unroll
        for (int b = 0; b < kDenseBatch; ++b) {
          if (js[b] < 0) continue;
          // a lane whose pair does not count adds zeros
          float J[3][6], r[3] = {0.0f, 0.0f, 0.0f}, w = 0.0f;
#pragma unroll
          for (int c = 0; c < 3; ++c)
#pragma unroll
            for (int e = 0; e < 6; ++e) J[c][e] = 0.0f;
          bool counted = false;
          if (took[b]) {
            Sample s;
            bilinear(t[b], s);
            if (trunc_pass(P, s)) {
              const Pose o = pose_of(pose, f0 + js[b]);
              Proj q;
              project(P, k, o, x, q);
              pose_jacobian(P, k, o, q, s, J);
#pragma unroll
              for (int c = 0; c < 3; ++c) r[c] = s.A[c] - mean[c];
              w = wh;
              counted = true;
            }
          }
          if (!__any_sync(kFull, counted)) continue;
          float* out = my_stage + js[b] * kPoseTerms;
          pose_terms(J, w, r, [&](int e, float value) {
            const float sum = warp_sum(value);
            if (lane == 0) out[e] = sum;
          });
        }
      }
    } else {
      // lane j: the voxels that pass in frame f0 + j; off its first pair's
      // number in the warp's frame-major order
      const unsigned vis =
          (f0 == 0 ? vis0 : visible_voxels(P, v0, f0, lane)) & actives;
      const unsigned by_frame = gate_by_frame(P, k, pose, f0, vis, xs, lane);
      int total;
      const int off = lane_offsets(__popc(by_frame), lane, total);
      // lanes 0-26: the running sum of term `lane` of frame f0 + cur
      float sum = 0.0f;
      int cur = -1;
      for (int base = 0; base < total; base += 32) {
        // pair i: frame j, voxel the (i - off_j)-th of its passing voxels
        const int i = base + lane;
        const int j = owner_lane(off, i);
        const unsigned fb = __shfl_sync(kFull, by_frame, j);
        const int first = __shfl_sync(kFull, off, j);
        const int r = i < total ? nth_bit(fb, i - first) : lane;
        float xr[3], mr[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          xr[c] = __shfl_sync(kFull, x[c], r);
          mr[c] = __shfl_sync(kFull, mean[c], r);
        }
        const float whr = __shfl_sync(kFull, wh, r);
        if (i < total) {
          const Pose o = pose_of(pose, f0 + j);
          Proj q;
          project(P, k, o, xr, q);
          Taps t;
          load_taps(P, f0 + j, q.u, q.v, t);
          Sample s;
          bilinear(t, s);
          float* row = my_terms + lane * kPoseTerms;
          if (trunc_pass(P, s)) {
            float J[3][6];
            pose_jacobian(P, k, o, q, s, J);
            const float rr[3] = {s.A[0] - mr[0], s.A[1] - mr[1],
                                 s.A[2] - mr[2]};
            pose_terms(J, whr, rr, [&](int e, float value) { row[e] = value; });
          } else {
#pragma unroll
            for (int e = 0; e < kPoseTerms; ++e) row[e] = 0.0f;
          }
          my_frame[lane] = j;
        }
        __syncwarp();
        if (lane < kPoseTerms) {
          const int rows = min(32, total - base);
          for (int ii = 0; ii < rows; ++ii) {
            const int fj = my_frame[ii];
            if (fj != cur) {
              if (cur >= 0) my_stage[cur * kPoseTerms + lane] = sum;
              sum = 0.0f;
              cur = fj;
            }
            sum += my_terms[ii * kPoseTerms + lane];
          }
        }
        __syncwarp();
      }
      if (lane < kPoseTerms && cur >= 0) my_stage[cur * kPoseTerms + lane] = sum;
    }
    __syncthreads();
    // the CTA's sums of the chunk's frames, its warps' in warp order, as
    // one contiguous run of its [F, 27] partial
    float* out = partials + (static_cast<size_t>(blockIdx.x) * P.F + f0) *
                                kPoseTerms;
    for (int e = threadIdx.x; e < fc * kPoseTerms; e += kThreads) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += stage[w * kChunk * kPoseTerms + e];
      out[e] = s;
    }
  }
}

// The F systems from the CTAs' [F, 27] partials: a CTA takes 32 entries, a
// lane one; warp w adds the CTAs of its contiguous 32nd in order (a warp
// reads 32 neighbouring floats a CTA), then warp 0 adds the 32 sums in
// warp order and writes H's upper-triangle entry to both halves, or b's.
constexpr int kPoseFinishWarps = 32;

__global__ void __launch_bounds__(32 * kPoseFinishWarps)
    ba_pose_finish(const float* partials, int ctas, int F, float* H,
                   float* b) {
  __shared__ float part[kPoseFinishWarps][32];
  wait_for_primary();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int entries = F * kPoseTerms;
  const int entry = blockIdx.x * 32 + lane;
  const int per = (ctas + kPoseFinishWarps - 1) / kPoseFinishWarps;
  const int lo = warp * per, hi = min(ctas, lo + per);
  float s = 0.0f;
  if (entry < entries) {
#pragma unroll 8
    for (int c = lo; c < hi; ++c)
      s += partials[static_cast<size_t>(c) * entries + entry];
  }
  part[warp][lane] = s;
  __syncthreads();
  if (warp != 0 || entry >= entries) return;
  s = 0.0f;
#pragma unroll
  for (int w = 0; w < kPoseFinishWarps; ++w) s += part[w][lane];
  const int f = entry / kPoseTerms, j = entry % kPoseTerms;
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

size_t pose_bytes(int64_t F) { return static_cast<size_t>(F) * 12 * sizeof(float); }

// dynamic shared memory of ba_voxel_sums in `mode`
size_t sums_smem(int64_t F, int mode) {
  const int warp = mode == kEnergy ? RowOf<kEnergy>::kWarpFloats
                                   : (mode == kMean ? RowOf<kMean>::kWarpFloats
                                                    : RowOf<kDist>::kWarpFloats);
  return pose_bytes(F) + static_cast<size_t>(kWarps) * warp * 4;
}

size_t pose_smem(int64_t F) {
  return pose_bytes(F) +
         (kStageFloats + kTermFloats + kWarps * 32 + kWarps * 3 * 32) * 4;
}

// Launches `kernel` as a programmatic dependent of the kernel before it on
// `s` (it waits for it in `wait_for_primary`).
template <class... Params, class... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), int ctas, int threads,
                             cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(threads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

// Lets `kernel` take `smem` bytes of dynamic shared memory (beyond 48 KB
// only on request).
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The SMs of the current device, read once a device.
int sm_count() {
  constexpr int kDevices = 64;
  static int sms_of[kDevices] = {};
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  if (dev < kDevices && sms_of[dev] > 0) return sms_of[dev];
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (dev < kDevices) sms_of[dev] = sms;
  return sms;
}

// Whether a launch over V voxels and F frames takes the kernels' dense
// paths: at most kDenseFrames frames and at most a warp a scheduler (4 an
// SM). Measured on an H100 over F = 4-30 and V = 4608-102400
// (`tools/ba_bench.py --sweep`, PERF.md): beyond either the full-card paths
// take less time an alternation.
bool dense_launch(int64_t V, int64_t F) {
  const int sms = sm_count();
  return F <= kDenseFrames && (V + 31) / 32 <= 4 * static_cast<int64_t>(sms);
}

template <int kMode>
cudaError_t launch_sums(bool dense, const Problem& p, int ctas, size_t smem,
                        cudaStream_t s, float* o0, float* o1, float* part) {
  void (*kernel)(Problem, float*, float*, float*) =
      dense ? ba_voxel_sums<kMode, true> : ba_voxel_sums<kMode, false>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<ctas, kThreads, smem, s>>>(p, o0, o1, part);
  return cudaGetLastError();
}

}  // namespace

// C entry points (bound with ctypes). Each launches on `stream`, does not
// synchronize and returns cudaGetLastError() of its launches (0 = success).
//
// gsdf_ba_ctas: the CTAs of a launch over V voxels (the pose systems'
// partials are [ctas, F, 27] floats; the energy's partials one a warp of 32
// voxels); gsdf_ba_max_frames: the most frames a launch takes;
// gsdf_ba_dense: 1 if a launch over V voxels and F frames takes the dense
// paths on the current device, 0 if the full-card ones (for the tests and
// measurements).
extern "C" int gsdf_ba_ctas(long long V) { return V < 1 ? -1 : ctas_for(V); }

extern "C" int gsdf_ba_max_frames() { return kMaxFrames; }

extern "C" int gsdf_ba_dense(long long V, long long F) {
  return V < 1 || F < 1 ? -1 : (dense_launch(V, F) ? 1 : 0);
}

// gsdf_ba_voxel_sums_f32: `args` a BAArgs; mode 0 (energy): out0 f32 [1]
// the energy, partials f32 [ceil(V / 32)]; mode 1 (dist): out0 f32 [V] the
// stepped dist; mode 2 (mean): out0 f32 [V] the count n, out1 f32 [V, 3]
// the mean intensity.
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
  const size_t smem = sums_smem(a.F, mode);
  const bool dense = dense_launch(a.V, a.F);
  cudaError_t e;
  if (mode == kEnergy) {
    e = launch_sums<kEnergy>(dense, p, ctas, smem, s, o0, o1, part);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = launch_dependent(ba_energy_finish, 1, kFinishThreads, s,
                         static_cast<const float*>(part),
                         static_cast<int>((a.V + 31) / 32), o0);
  } else if (mode == kDist) {
    e = launch_sums<kDist>(dense, p, ctas, smem, s, o0, o1, part);
  } else {
    e = launch_sums<kMean>(dense, p, ctas, smem, s, o0, o1, part);
  }
  return static_cast<int>(e);
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
  const size_t smem = pose_smem(a.F);
  void (*kernel)(Problem, const float*, const float*, float*) =
      dense_launch(a.V, a.F) ? ba_pose_systems<true> : ba_pose_systems<false>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<ctas, kThreads, smem, s>>>(
      p, static_cast<const float*>(n), static_cast<const float*>(mean), part);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int entries = static_cast<int>(a.F) * kPoseTerms;
  e = launch_dependent(ba_pose_finish, (entries + 31) / 32,
                       32 * kPoseFinishWarps, s,
                       static_cast<const float*>(part), ctas,
                       static_cast<int>(a.F), static_cast<float*>(H),
                       static_cast<float*>(b));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// gsdf_ba_empty: an empty kernel at the launch of V voxels (ctas x 160).
// Used by the measurements only, never by the package.
extern "C" int gsdf_ba_empty(long long V, void* stream) {
  if (V < 1) return cudaErrorInvalidValue;
  ba_empty<<<ctas_for(V), kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// gsdf_ba_occupancy: for F frames, out[0..3] the CTAs an SM holds of
// ba_voxel_sums (energy, dist, mean) and ba_pose_systems on the full-card
// paths, out[6..9] on the dense paths (the occupancy API), out[4] the SMs,
// out[5] the threads a CTA. Used by the measurements only.
extern "C" int gsdf_ba_occupancy(long long F, int* out) {
  int dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&out[4], cudaDevAttrMultiProcessorCount, dev);
  out[5] = kThreads;
  for (int dense = 0; dense < 2; ++dense) {
    int* o = out + (dense ? 6 : 0);
    void (*sums[3])(Problem, float*, float*, float*) = {
        dense ? ba_voxel_sums<kEnergy, true> : ba_voxel_sums<kEnergy, false>,
        dense ? ba_voxel_sums<kDist, true> : ba_voxel_sums<kDist, false>,
        dense ? ba_voxel_sums<kMean, true> : ba_voxel_sums<kMean, false>};
    for (int m = 0; m < 3; ++m) {
      allow_smem(sums[m], sums_smem(F, m));
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o[m], sums[m], kThreads,
                                                    sums_smem(F, m));
    }
    void (*pose)(Problem, const float*, const float*, float*) =
        dense ? ba_pose_systems<true> : ba_pose_systems<false>;
    allow_smem(pose, pose_smem(F));
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o[3], pose, kThreads,
                                                  pose_smem(F));
  }
  return static_cast<int>(cudaGetLastError());
}
