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
//   track_compact: a CTA of kThreads threads a tile of whole strided rows
//     (pixel (row, col) of the strided image is pixel (row * s, col * s) of
//     the depth frame): min(kTileRows, kCapacity / Ws) rows, so 4 rows of
//     640 pixels and 120 tiles for a VGA frame at stride 1, at most 128
//     before any tile, so that warp 0's one read of kLook status words a
//     lane covers every predecessor. A CTA takes its tile from a counter,
//     in launch order. Thread tid takes the groups of 4 consecutive pixels
//     4 (k kThreads + tid) of the tile, k < kRounds, so that the tile's
//     order is (k, warp, lane, pixel of the group); their rows and columns
//     come from a per-thread counter (one division at the start), and at
//     stride 1 with W % 4 == 0 each group is one 16-byte load. While the
//     loads are in flight the CTA divides out x0 of every column and y0 of
//     its rows into shared memory. It keeps the pixels with z_min < z <
//     z_max (a NaN fails both), ballots them, and every warp scans the
//     kRounds x kWarps warp counts from shared memory. Then the single-pass
//     scan with decoupled look-back (Merrill and Garland): warp 0 publishes
//     the tile's aggregate in its status word, reads the words of the 128
//     tiles before it (each word holds an epoch, a flag and a value in one
//     64-bit store, so a read sees all three or none), adds the aggregates
//     back to the nearest published prefix (tile 0's, within the one read
//     for a frame of at most 129 tiles), and publishes its own inclusive
//     prefix. Between the publication and the read, each kept pixel's
//     point, x0 z, y0 z, z, goes into shared memory at its place in the
//     tile's span of points; once the span's start is known, the CTA
//     writes it with 16-byte stores. The last tile writes the count and
//     puts the tile counter back to 0. The epoch, new every launch, tells
//     this launch's status words from older ones, so they need no
//     clearing.
//   The points land in row-major pixel order, the order of pts_cam[mask]; no
//   atomic decides where a point goes: the same frame gives the same buffer
//   on every run, and the GN sums over it the same bits.
//
// Arithmetic: x0 = (col s - cx) / fx and y0 = (row s - cy) / fy are true
// IEEE divisions, then separate products, as the plain version computes
// them (it divides by a tensor, and this file is built with -fmad=false;
// see _build.SOURCE_FLAGS): the points are the plain version's bit for bit.
//
// What bounds it on an H100: bytes, 4 B of depth a strided pixel and 12 B
// a kept point (~1.6 MB a golden frame, 0.00053 ms at 3.35 TB/s), not
// operations. What is left is latency: the counter's round trip, one
// load's, the barriers and one read of the status words. Measured on golden
// frame 5 (NVIDIA H100 80GB HBM3, 700 W power limit; PERF.md):
// 0.0084-0.0089 ms, events around each launch, above an empty launch of
// 0.0047-0.0051 under the same timer; 48 registers, no spills. Of the rest
// the look-back takes ~0.0007, the points' staging ~0.0010 and their
// stores ~0.0004; the counter nothing measurable (0.0083 from blockIdx).
// The previous design's 2048-pixel tiles, 150 a golden frame, walked back
// up to 5 rounds of 32 words and wrote three scalars a point: 0.0098-0.0099
// ms in the same calls. Tiles of 16 rows (30 a frame, one 32-word read)
// took 0.0109-0.0121: they put every point's work on 30 SMs. A one-cluster
// design before that took 0.0396 ms on 8 SMs and 0.0272 on 16.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 4;                       // pixels a thread loads at once
constexpr int kRounds = 3;                      // groups a thread takes
constexpr int kCapacity = kRounds * kGroup * kThreads;   // pixels a tile
constexpr int kTileRows = 4;                    // strided rows a tile, at most
constexpr int kLook = 4;                        // status words a lane reads
constexpr int kEntries = kRounds * kWarps;      // warp counts of a tile
static_assert(kEntries <= 3 * 32, "a lane scans three entries");
// shared memory: the stage of a tile's points, then x0 of each strided
// column and y0 of each of the tile's rows
constexpr int kStage = 3 * kCapacity;
constexpr size_t kMaxSmem = (kStage + kCapacity + kTileRows) * sizeof(float);
constexpr int kMaxDevices = 64;
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
  int W, s, Ws, Hs, rows_per_tile;
  bool vec;   // stride 1, W % 4 == 0, 16-byte aligned depth: float4 groups
  float fx, fy, cx, cy, z_min, z_max;
};

__device__ __forceinline__ bool kept(const Frame& f, float z) {
  return z > f.z_min && z < f.z_max;
}

__device__ __forceinline__ void publish(unsigned long long* status, int t,
                                        unsigned long long epoch,
                                        unsigned long long flag,
                                        unsigned int value) {
  atomicExch(status + t, epoch << kEpochShift | flag << 32 | value);
}

__device__ __forceinline__ unsigned long long read_word(
    const unsigned long long* status, int k) {
  return *reinterpret_cast<const volatile unsigned long long*>(status + k);
}

// The kept pixels before tile t (t > 0), by warp 0: lane L reads the status
// words of tiles t - 1 - (32 m + L), m < kLook (the words of the 128 tiles
// before t, all four loads in flight), waiting until each holds this
// launch's epoch; the nearest tile with a prefix ends the walk, else the
// 128 aggregates are added and the window moves 128 tiles back. Returns -1
// if a predecessor never published (a fault).
__device__ long long look_back(const unsigned long long* status, int t,
                               unsigned long long epoch) {
  const int lane = threadIdx.x & 31;
  const unsigned long long before0 = epoch << kEpochShift | kPrefix << 32;
  long long sum = 0;
  for (int j = t - 1;; j -= 32 * kLook) {
    unsigned long long w[kLook];
#pragma unroll
    for (int m = 0; m < kLook; ++m) {
      const int k = j - 32 * m - lane;
      w[m] = k >= 0 ? read_word(status, k) : before0;   // before tile 0
    }
    bool late = false;
#pragma unroll
    for (int m = 0; m < kLook; ++m) {
      const int k = j - 32 * m - lane;
      int spins = 0;
      while ((w[m] >> kEpochShift) != epoch && ++spins < kMaxSpins)
        w[m] = read_word(status, k);
      late |= (w[m] >> kEpochShift) != epoch;
    }
    if (__any_sync(0xffffffffu, late)) return -1;
    // the nearest prefix: the first m whose ballot has one, its lowest lane
    int near = 32 * kLook;
#pragma unroll
    for (int m = kLook - 1; m >= 0; --m) {
      const unsigned int prefix = __ballot_sync(
          0xffffffffu, ((w[m] >> 32) & 3ull) == kPrefix);
      if (prefix) near = 32 * m + __ffs(prefix) - 1;
    }
    long long v = 0;
#pragma unroll
    for (int m = 0; m < kLook; ++m)
      if (32 * m + lane <= near)
        v += static_cast<long long>(w[m] & 0xffffffffull);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    sum += __shfl_sync(0xffffffffu, v, 0);
    if (near < 32 * kLook) return sum;
  }
}

__global__ void __launch_bounds__(kThreads)
track_compact(Frame f, float* __restrict__ pts, int* __restrict__ count,
              unsigned long long* __restrict__ status,
              int* __restrict__ next_tile, unsigned long long epoch) {
  extern __shared__ float stage[];
  float* x0_of = stage + kStage;     // [Ws]
  float* y0_of = x0_of + f.Ws;       // [kTileRows]
  __shared__ int tile_sh;
  __shared__ int counts[kEntries];   // (k, warp) order
  __shared__ long long first_row;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // tiles are taken in launch order, so every tile a CTA waits for belongs
  // to a CTA that is already running
  if (tid == 0) tile_sh = atomicAdd(next_tile, 1);
  __syncthreads();
  const int t = tile_sh, row0 = t * f.rows_per_tile;
  const int n = min(f.rows_per_tile, f.Hs - row0) * f.Ws;   // tile's pixels

  // the groups' depths: (row, col) of group k's first pixel from a counter
  int row = (kGroup * tid) / f.Ws, col = kGroup * tid - row * f.Ws;
  int grow[kRounds], gcol[kRounds];
  float z[kRounds][kGroup];
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    if (k > 0) {
      col += kGroup * kThreads;
      while (col >= f.Ws) {
        col -= f.Ws;
        ++row;
      }
    }
    grow[k] = row;
    gcol[k] = col;
    const int i = kGroup * (k * kThreads + tid);
    if (f.vec && i < n) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(
          f.depth + static_cast<int64_t>(row0 + row) * f.W + col));
      z[k][0] = v.x;
      z[k][1] = v.y;
      z[k][2] = v.z;
      z[k][3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        int r = row, c = col + j;
        while (c >= f.Ws) {   // a group may run into the next row
          c -= f.Ws;
          ++r;
        }
        z[k][j] = i + j < n ? __ldg(f.depth + static_cast<int64_t>(row0 + r) *
                                                  f.s * f.W + c * f.s)
                            : 0.0f;
      }
    }
  }
  // while the loads are in flight: (x - cx) / fx of each column and (y -
  // cy) / fy of each of the tile's rows, the plain version's divisions
  for (int c = tid; c < f.Ws; c += kThreads)
    x0_of[c] = (static_cast<float>(c * f.s) - f.cx) / f.fx;
  if (tid < kTileRows)
    y0_of[tid] = (static_cast<float>((row0 + tid) * f.s) - f.cy) / f.fy;
  // keep bits and each kept pixel's place among its warp's in round k
  const unsigned int below = (1u << lane) - 1u;
  unsigned int keep[kRounds];
  int before[kRounds];
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    const int i = kGroup * (k * kThreads + tid);
    keep[k] = 0;
#pragma unroll
    for (int j = 0; j < kGroup; ++j)
      if (i + j < n && kept(f, z[k][j])) keep[k] |= 1u << j;
    int sum = 0, mine = 0;
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const unsigned int m = __ballot_sync(0xffffffffu, (keep[k] >> j) & 1u);
      sum += __popc(m);
      mine += __popc(m & below);
    }
    before[k] = mine;
    if (lane == 0) counts[k * kWarps + warp] = sum;
  }
  __syncthreads();

  // every warp scans the counts: lane L entries 3L .. 3L + 2
  int e[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    e[j] = 3 * lane + j < kEntries ? counts[3 * lane + j] : 0;
  int incl = e[0] + e[1] + e[2];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += u;
  }
  const int p0 = incl - e[0] - e[1] - e[2], p1 = p0 + e[0], p2 = p1 + e[1];
  const int total = __shfl_sync(0xffffffffu, incl, 31);
  int offset[kRounds];   // kept pixels of the tile before (k, this warp)
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    const int entry = k * kWarps + warp, src = entry / 3;
    const int slot = entry - 3 * src;
    const int a = __shfl_sync(0xffffffffu, p0, src),
              b = __shfl_sync(0xffffffffu, p1, src),
              c = __shfl_sync(0xffffffffu, p2, src);
    offset[k] = slot == 0 ? a : (slot == 1 ? b : c);
  }
  // the tile's aggregate out first (tile 0's is its inclusive prefix)
  if (tid == 0) {
    publish(status, t, epoch, t > 0 ? kAggregate : kPrefix, total);
    if (t == 0) first_row = 0;
  }

  // the tile's points into the stage at their places in its span (float
  // 3 place + m), while the aggregate travels
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    int place = offset[k] + before[k];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (!((keep[k] >> j) & 1u)) continue;
      int r = grow[k], c = gcol[k] + j;
      while (c >= f.Ws) {
        c -= f.Ws;
        ++r;
      }
      float* p = stage + 3 * place++;
      p[0] = x0_of[c] * z[k][j];
      p[1] = y0_of[r] * z[k][j];
      p[2] = z[k][j];
    }
  }

  // then the kept pixels before the tile (warp 0)
  if (warp == 0 && t > 0) {
    const long long before_tile = look_back(status, t, epoch);
    if (lane == 0) {
      if (before_tile >= 0)
        publish(status, t, epoch, kPrefix,
                static_cast<unsigned int>(before_tile + total));
      first_row = before_tile;
    }
  }
  __syncthreads();
  const long long first = first_row;
  if (t == static_cast<int>(gridDim.x) - 1 && tid == 0) {
    // the last tile: every CTA has taken its tile, so the counter can go
    // back to 0 for the next launch
    *count = first < 0 ? -1 : static_cast<int>(first + total);
    *next_tile = 0;
  }
  if (first < 0) {   // a predecessor never published: a fault, never a result
    if (tid == 0) atomicExch(count, -1);
    return;
  }

  // the span in 16-byte stores: global quad q0 + q holds stage floats 4 q
  // - shift .. 4 q - shift + 3, shift = (3 first) % 4; the first and last
  // quads may be partial
  const int64_t g0 = 3 * first, g1 = g0 + 3 * static_cast<int64_t>(total);
  const int64_t q0 = g0 >> 2;
  const int shift = static_cast<int>(g0 & 3);
  const int quads = total > 0 ? static_cast<int>(((g1 - 1) >> 2) - q0 + 1) : 0;
  for (int q = tid; q < quads; q += kThreads) {
    const int64_t g = (q0 + q) << 2;
    const float* src = stage + 4 * q - shift;
    if (g >= g0 && g + 4 <= g1) {
      reinterpret_cast<float4*>(pts)[q0 + q] =
          make_float4(src[0], src[1], src[2], src[3]);
    } else {
      for (int j = 0; j < 4; ++j)
        if (g + j >= g0 && g + j < g1) pts[g + j] = src[j];
    }
  }
}

__global__ void __launch_bounds__(kThreads) track_compact_empty() {}

// Raises a kernel's shared-memory limit on the current device to kMaxSmem
// (the attribute holds per device and function). Returns a CUDA error code.
template <typename Kernel>
int allow_smem(Kernel kernel, bool* allowed) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (allowed[dev]) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kMaxSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  allowed[dev] = true;
  return 0;
}

bool smem_allowed[kMaxDevices] = {};
bool empty_smem_allowed[kMaxDevices] = {};

// strided rows a tile of a frame Ws strided pixels wide takes (0: too wide)
int rows_per_tile(int Ws) {
  const int rows = kCapacity / Ws;
  return rows < kTileRows ? rows : kTileRows;
}

// a launch's shared memory for a frame Ws strided pixels wide
size_t smem_for(int Ws) { return (kStage + Ws + kTileRows) * sizeof(float); }

}  // namespace

// C entry points (bound with ctypes).
//
// gsdf_track_compact_tiles: the number of tiles (CTAs) for a frame of H x W
// at `sampling`, the length of the status words the launch needs; -1 for a
// frame the kernel does not take (more than kCapacity strided columns).
extern "C" int gsdf_track_compact_tiles(int H, int W, int sampling) {
  if (H <= 0 || W <= 0 || sampling < 1) return -1;
  const int Hs = (H + sampling - 1) / sampling;
  const int Ws = (W + sampling - 1) / sampling;
  const int rows = rows_per_tile(Ws);
  return rows < 1 ? -1 : (Hs + rows - 1) / rows;
}

// gsdf_track_compact_f32: launches on `stream`, does not synchronize,
// returns cudaGetLastError() of the launch (0 = success).
//
// `depth` f32 [H, W]; the strided pixels are (row * sampling, col *
// sampling) for row < ceil(H / sampling), col < ceil(W / sampling); `pts`
// f32 [ceil(H / s) * ceil(W / s), 3], 16-byte aligned, receives the kept
// pixels' camera-frame points in row-major pixel order, `count` int32 [1]
// their number (the rows past it are left as they were). `status` u64
// [tiles] (zero when allocated) and `next_tile` int32 [1] (zero between
// launches, and left so) are the look-back's scratch; `epoch` in [1, 2^30)
// must differ from the epoch of every earlier launch on the same `status`.
extern "C" int gsdf_track_compact_f32(const void* depth, int H, int W,
                                      int sampling, float fx, float fy,
                                      float cx, float cy, float z_min,
                                      float z_max, void* pts, void* count,
                                      void* status, void* next_tile,
                                      long long epoch, void* stream) {
  const int tiles = gsdf_track_compact_tiles(H, W, sampling);
  if (tiles < 1 || epoch < 1 || epoch >= (1ll << 30) ||
      reinterpret_cast<uintptr_t>(pts) % 16 != 0)
    return cudaErrorInvalidValue;
  const int Hs = (H + sampling - 1) / sampling;
  const int Ws = (W + sampling - 1) / sampling;
  if (static_cast<int64_t>(Hs) * Ws * 3 >= INT32_MAX)
    return cudaErrorInvalidValue;
  const int e = allow_smem(track_compact, smem_allowed);
  if (e != 0) return e;
  Frame f = {static_cast<const float*>(depth), W, sampling, Ws, Hs,
             rows_per_tile(Ws),
             sampling == 1 && W % 4 == 0 &&
                 reinterpret_cast<uintptr_t>(depth) % 16 == 0,
             fx, fy, cx, cy, z_min, z_max};
  track_compact<<<tiles, kThreads, smem_for(Ws),
                  static_cast<cudaStream_t>(stream)>>>(
      f, static_cast<float*>(pts), static_cast<int*>(count),
      static_cast<unsigned long long*>(status), static_cast<int*>(next_tile),
      static_cast<unsigned long long>(epoch));
  return static_cast<int>(cudaGetLastError());
}

// gsdf_track_compact_empty: an empty kernel at the launch of a frame of H x
// W at `sampling` (grid, threads and shared memory): the launch floor.
extern "C" int gsdf_track_compact_empty(int H, int W, int sampling,
                                        void* stream) {
  const int tiles = gsdf_track_compact_tiles(H, W, sampling);
  if (tiles < 1) return cudaErrorInvalidValue;
  const int e = allow_smem(track_compact_empty, empty_smem_allowed);
  if (e != 0) return e;
  track_compact_empty<<<tiles, kThreads,
                        smem_for((W + sampling - 1) / sampling),
                        static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
