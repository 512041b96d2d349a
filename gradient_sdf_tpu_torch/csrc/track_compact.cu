// track_compact: a depth frame's tracking points, compacted in order on the
// card, with the count left in device memory.
//
// Replaces, on the card, the JAX package's `backproject_grid`
// (gradient_sdf_tpu/models/tracker.py:162) and the compaction of the
// z-gated pixels in its `track_frame` (:194, :235-254), which XLA fuses;
// it has no TPU kernel. The port's plain version is
// `models/tracker.compact_points`, `pts_cam[mask]`: a `nonzero` whose size
// the host must read before the gather, one host sync a frame.
//
//   track_compact: a CTA of kThreads threads a tile of kTile = kItems x
//     kThreads strided pixels (i = row * Ws + col: pixel (row * s, col * s)
//     of the image), thread tid taking pixels tile + k * kThreads + tid, so
//     that the tile's order is (k, warp, lane). A CTA takes its tile from a
//     counter, in launch order. It reads its depths (kItems loads in flight
//     a thread), keeps the pixels with z_min < z < z_max (a NaN fails both),
//     ballots a warp and item, and scans the kItems x kWarps warp counts in
//     shared memory. Then the single-pass scan with decoupled look-back
//     (Merrill and Garland): warp 0 publishes the tile's aggregate in its
//     status word, reads the words of the 32 tiles before it (each word
//     holds an epoch, a flag and a value in one 64-bit store, so a read sees
//     all three or none), adds the aggregates back to the nearest published
//     prefix, and publishes its own inclusive prefix. Every kept pixel's row
//     is then the kept pixels before its tile + those before it in the
//     tile; it backprojects the pixel, (x - cx) / fx * z, (y - cy) / fy * z,
//     z, and writes the point there. The last tile writes the count and
//     puts the tile counter back to 0. The epoch, new every launch, tells
//     this launch's status words from older ones, so they need no clearing.
//   The points land in row-major pixel order, the order of pts_cam[mask]; no
//   atomic decides where a point goes: the same frame gives the same buffer
//   on every run, and the GN sums over it the same bits.
//
// Arithmetic: true IEEE divisions by fx and fy and separate products, as
// the plain version computes them (it divides by a tensor, and this file
// is built with -fmad=false; see _build.SOURCE_FLAGS): the points are the
// plain version's bit for bit.
//
// What bounds it on an H100: bytes, 4 B of depth a strided pixel and 12 B
// a kept point (~1.6 MB a golden frame, ~0.0005 ms at 3.35 TB/s), not
// operations. A golden frame is 150 tiles, one wave of CTAs that each read
// their depth once; what is left is a load's latency, two barriers and the
// look-back's reads of other tiles' words. It removes the host's wait for
// the size of the compaction. (PERF.md: a first design, one thread-block
// cluster that counted its chunks, barriered and walked them again, took
// 0.0396 ms a golden frame on 8 SMs and 0.0272 on 16.)

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                     // pixels a thread takes
constexpr int kTile = kItems * kThreads;      // pixels a CTA takes
constexpr int kScan = kItems * kWarps / 32;   // scan entries a lane takes
static_assert(kItems * kWarps % 32 == 0, "the scan splits over a warp");
// status word of a tile: epoch << 34 | flag << 32 | value
constexpr unsigned long long kAggregate = 1ull, kPrefix = 2ull;
constexpr int kEpochShift = 34;
// a look-back that waits longer than this for a predecessor gives up
// instead of hanging, and sets the count to -1. It cannot happen in a
// correct launch (the tiles are taken in launch order, so every tile waited
// for belongs to a running CTA); if it did, the tests' bit-for-bit checks of
// the points and the count would see it
constexpr int kMaxSpins = 1 << 22;

struct Frame {
  const float* __restrict__ depth;
  int W, s, Ws, n;
  float fx, fy, cx, cy, z_min, z_max;
};

__device__ __forceinline__ float depth_at(const Frame& f, int i) {
  const int row = i / f.Ws, col = i - row * f.Ws;
  return __ldg(f.depth + static_cast<int64_t>(row) * f.s * f.W + col * f.s);
}

__device__ __forceinline__ bool kept(const Frame& f, float z) {
  return z > f.z_min && z < f.z_max;
}

__device__ __forceinline__ void publish(unsigned long long* status, int t,
                                        unsigned long long epoch,
                                        unsigned long long flag,
                                        unsigned int value) {
  atomicExch(status + t, epoch << kEpochShift | flag << 32 | value);
}

// The kept pixels before tile t (t > 0), by warp 0: its lanes read the
// status words of tiles t - 1 - lane, waiting until each holds this
// launch's epoch; the nearest tile with a prefix ends the walk, else the
// 32 aggregates are added and the window moves 32 tiles back. Returns -1
// if a predecessor never published (a fault).
__device__ long long look_back(const unsigned long long* status, int t,
                               unsigned long long epoch) {
  const int lane = threadIdx.x & 31;
  long long sum = 0;
  for (int j = t - 1;; j -= 32) {
    const int k = j - lane;
    unsigned long long w = epoch << kEpochShift | kPrefix << 32;  // before tile 0
    if (k >= 0) {
      int spins = 0;
      do {
        w = *reinterpret_cast<const volatile unsigned long long*>(status + k);
      } while ((w >> kEpochShift) != epoch && ++spins < kMaxSpins);
    }
    if (__any_sync(0xffffffffu, (w >> kEpochShift) != epoch)) return -1;
    const unsigned int prefix = __ballot_sync(
        0xffffffffu, ((w >> 32) & 3ull) == kPrefix);
    // lanes up to the nearest prefix (the lowest lane that holds one)
    const int last = prefix ? __ffs(prefix) - 1 : 31;
    long long v = lane <= last ? static_cast<long long>(w & 0xffffffffull) : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    sum += __shfl_sync(0xffffffffu, v, 0);
    if (prefix) return sum;
  }
}

__global__ void __launch_bounds__(kThreads)
track_compact(Frame f, float* __restrict__ pts, int* __restrict__ count,
              unsigned long long* __restrict__ status,
              int* __restrict__ next_tile, unsigned long long epoch) {
  __shared__ int tile_sh;
  __shared__ int rows[kItems * kWarps];   // exclusive scan, (k, warp) order
  __shared__ int tile_kept;
  __shared__ long long first_row;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // tiles are taken in launch order, so every tile a CTA waits for belongs
  // to a CTA that is already running
  if (tid == 0) tile_sh = atomicAdd(next_tile, 1);
  __syncthreads();
  const int t = tile_sh, base = t * kTile;
  float z[kItems];
  bool keep[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = base + k * kThreads + tid;
    z[k] = i < f.n ? depth_at(f, i) : 0.0f;
  }
  const unsigned int below = (1u << lane) - 1u;
  int before[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    keep[k] = base + k * kThreads + tid < f.n && kept(f, z[k]);
    const unsigned int m = __ballot_sync(0xffffffffu, keep[k]);
    before[k] = __popc(m & below);
    if (lane == 0) rows[k * kWarps + warp] = __popc(m);
  }
  __syncthreads();
  if (warp == 0) {
    // lane L scans entries [kScan L, kScan (L + 1)), in (k, warp) order
    int v[kScan], sum = 0;
#pragma unroll
    for (int j = 0; j < kScan; ++j) {
      v[j] = sum;
      sum += rows[kScan * lane + j];
    }
    int incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += u;
    }
#pragma unroll
    for (int j = 0; j < kScan; ++j) rows[kScan * lane + j] = incl - sum + v[j];
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    // the tile's aggregate out first, then the kept pixels before it
    long long before_tile = 0;
    if (t > 0) {
      if (lane == 0) publish(status, t, epoch, kAggregate, total);
      before_tile = look_back(status, t, epoch);
    }
    if (lane == 0) {
      if (before_tile >= 0)
        publish(status, t, epoch, kPrefix,
                static_cast<unsigned int>(before_tile + total));
      tile_kept = total;
      first_row = before_tile;
    }
  }
  __syncthreads();
  const long long row0 = first_row;
  if (t == static_cast<int>(gridDim.x) - 1 && tid == 0) {
    // the last tile: every CTA has taken its tile, so the counter can go
    // back to 0 for the next launch
    *count = row0 < 0 ? -1 : static_cast<int>(row0 + tile_kept);
    *next_tile = 0;
  }
  if (row0 < 0) {   // a predecessor never published: a fault, never a result
    if (tid == 0) atomicExch(count, -1);
    return;
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (!keep[k]) continue;
    const int i = base + k * kThreads + tid;
    const int row = i / f.Ws, col = i - row * f.Ws;
    const float x0 = (static_cast<float>(col * f.s) - f.cx) / f.fx;
    const float y0 = (static_cast<float>(row * f.s) - f.cy) / f.fy;
    float* p = pts + 3 * (row0 + rows[k * kWarps + warp] + before[k]);
    p[0] = x0 * z[k];
    p[1] = y0 * z[k];
    p[2] = z[k];
  }
}

}  // namespace

// C entry points (bound with ctypes).
//
// gsdf_track_compact_tiles: the number of tiles (CTAs) for a frame of H x W
// at `sampling`, the length of the status words the launch needs.
extern "C" int gsdf_track_compact_tiles(int H, int W, int sampling) {
  if (H <= 0 || W <= 0 || sampling < 1) return -1;
  const int64_t n = static_cast<int64_t>((H + sampling - 1) / sampling) *
                    ((W + sampling - 1) / sampling);
  return static_cast<int>((n + kTile - 1) / kTile);
}

// gsdf_track_compact_f32: launches on `stream`, does not synchronize,
// returns cudaGetLastError() of the launch (0 = success).
//
// `depth` f32 [H, W]; the strided pixels are (row * sampling, col *
// sampling) for row < ceil(H / sampling), col < ceil(W / sampling); `pts`
// f32 [ceil(H / s) * ceil(W / s), 3] receives the kept pixels' camera-frame
// points in row-major pixel order, `count` int32 [1] their number (the
// rows past it are left as they were). `status` u64 [tiles] (zero when
// allocated) and `next_tile` int32 [1] (zero between launches, and left
// so) are the look-back's scratch; `epoch` in [1, 2^30) must differ from
// the epoch of every earlier launch on the same `status`.
extern "C" int gsdf_track_compact_f32(const void* depth, int H, int W,
                                      int sampling, float fx, float fy,
                                      float cx, float cy, float z_min,
                                      float z_max, void* pts, void* count,
                                      void* status, void* next_tile,
                                      long long epoch, void* stream) {
  const int tiles = gsdf_track_compact_tiles(H, W, sampling);
  if (tiles < 1 || epoch < 1 || epoch >= (1ll << 30))
    return cudaErrorInvalidValue;
  const int64_t n = static_cast<int64_t>(tiles) * kTile;
  if (n >= INT32_MAX) return cudaErrorInvalidValue;
  Frame f = {static_cast<const float*>(depth), W, sampling,
             (W + sampling - 1) / sampling,
             ((H + sampling - 1) / sampling) * ((W + sampling - 1) / sampling),
             fx, fy, cx, cy, z_min, z_max};
  track_compact<<<tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      f, static_cast<float*>(pts), static_cast<int*>(count),
      static_cast<unsigned long long*>(status), static_cast<int*>(next_tile),
      static_cast<unsigned long long>(epoch));
  return static_cast<int>(cudaGetLastError());
}
