// The segment bounds pass and the warp tiles shared by pool_cvm.cu and
// segment_sum.cu: a pool of K keys (rows of `values`, d floats each) into
// n segments by a stream of segment ids, where the ids inside [0, n) are
// nondecreasing in key order and any other id drops its key (−1 markers
// may sit anywhere, pads at the tail).
//
// Bounds: start[s] = the first key j with ids[j] == s, end[s] = the last
// one + 1 (both −1 for a segment with no key), in one pass over the keys
// with atomicMin (unsigned) / atomicMax after one memset of 0xff bytes.
// Only the first and the last key of each run of equal ids does its
// atomic. Min and max do not depend on the order of the atomics, so the
// bounds are deterministic. Because the valid ids are nondecreasing, the
// keys of a run of consecutive segments occupy ONE contiguous span of
// `values` rows, and a key inside a segment's [start, end) either has
// that segment's id or is dropped.
//
// Tiles: a warp owns T consecutive segments and dw <= 128 columns (a
// column tile), T chosen from the stream's mean keys per segment so that
// a tile's span is about one chunk. Its lanes hold the tile's bounds
// (one segment a lane), reduce them to the span [min start, max end) and
// stage that span of `values` rows, with their ids (and keep flags), in
// the warp's shared memory by cp.async, a chunk of at most kChunkFloats
// floats at a time: 16-byte copies, neighbouring lanes on neighbouring
// addresses, where the column tile is the whole row and `values` is
// 16-byte aligned (the window widened to 16-byte multiples, never past
// K * d floats), 4-byte copies otherwise. While the copy flies, the lanes
// load the bounds of the warp's next tile. Each lane then sums up to
// kPairs (segment, column) pairs in registers over the chunk's keys, in
// key order, from 0, skipping a dropped key by its own id (or keep flag):
// an inf or NaN of a dropped key stays out. Warps synchronize only with
// themselves, so one warp's copy overlaps another's sums; the grid holds
// as many warps as the card runs at once, each walking tiles with the
// grid's stride. Chunks go in key order, so a single segment of any
// length is correct; it is then one warp's serial walk, which no path of
// the port has.

#pragma once

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace segtile {

constexpr int kWarps = 4;                 // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kChunkFloats = 1024;        // 4 KB of values a warp's chunk
constexpr int kMaxChunkKeys = 256;
constexpr int kPairs = 4;                 // (segment, column) pairs a lane
constexpr int kMaxCols = 32 * kPairs;     // a column tile: dw <= 128
constexpr int kMaxTile = 32;              // segments a tile: one a lane

template <bool kHasKeep>
struct WarpSmem {
  __align__(16) float vals[kChunkFloats];
  int ids[kMaxChunkKeys];
  float keep[kHasKeep ? kMaxChunkKeys : 1];
};

// A block's buffers fit the 48 KB of dynamic shared memory a launch may
// take without opting in.
static_assert(kWarps * sizeof(WarpSmem<true>) <= 48 * 1024, "smem");

// Keys of one chunk: at most kMaxChunkKeys, and a widened window of the
// rows' floats within kChunkFloats.
inline int chunk_keys(int dw) {
  const int c = (kChunkFloats - 8) / dw;
  return c < kMaxChunkKeys ? c : kMaxChunkKeys;
}

// Segments a tile: one a lane, at most kPairs pairs a lane, and about a
// chunk of keys at the stream's mean keys a segment (k / n).
inline int tile_segments(long long k, int n, int dw) {
  long long t = kMaxCols / dw < kMaxTile ? kMaxCols / dw : kMaxTile;
  if (k > 0) {
    const long long want = static_cast<long long>(chunk_keys(dw)) * n / k;
    if (want < t) t = want;
  }
  return t < 1 ? 1 : static_cast<int>(t);
}

// The lane's pairs p = lane + 32 * i of a tile dw columns wide: segment
// toff[i] of the tile, column col[i]. The same for every tile of that
// width.
__device__ __forceinline__ void pair_slots(int dw, int (&toff)[kPairs],
                                           int (&col)[kPairs]) {
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const int p = (threadIdx.x & 31) + 32 * i;
    toff[i] = p / dw;
    col[i] = p - toff[i] * dw;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
bounds_kernel(const int* __restrict__ ids, int k, int n,
              int* __restrict__ start, int* __restrict__ end) {
  const int step = gridDim.x * blockDim.x;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < k; j += step) {
    const int s = __ldg(ids + j);
    if (s < 0 || s >= n) continue;
    if (j == 0 || __ldg(ids + j - 1) != s) {
      atomicMin(reinterpret_cast<unsigned*>(start) + s,
                static_cast<unsigned>(j));
    }
    if (j == k - 1 || __ldg(ids + j + 1) != s) atomicMax(end + s, j + 1);
  }
}

// bounds [2, n] int32: start, then end. Enqueues the memset and the pass
// on `stream`; returns the first cudaError_t. k < 2^31 - 1.
inline int launch_bounds(const int* ids, long long k, int n, int* bounds,
                         cudaStream_t stream) {
  const cudaError_t rc = cudaMemsetAsync(
      bounds, 0xff, 2 * static_cast<size_t>(n) * sizeof(int), stream);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (k > 0) {
    long long blocks = (k + kThreads - 1) / kThreads;
    if (blocks > (1LL << 20)) blocks = 1LL << 20;
    bounds_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        ids, static_cast<int>(k), n, bounds, bounds + n);
  }
  return static_cast<int>(cudaGetLastError());
}

// Blocks of a tile kernel that the card runs at once, for the
// grid-stride walk; 0 and the error in *rc when a query fails.
template <typename Kernel>
inline unsigned resident_blocks(Kernel kernel, size_t smem, int* rc) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  }
  *rc = static_cast<int>(e);
  return e == cudaSuccess ? static_cast<unsigned>(sms * per_sm) : 0;
}

// Lane's bounds of a tile: segment s0 + lane, (−1, −1) past the tile.
__device__ __forceinline__ void load_bounds(const int* __restrict__ start,
                                            const int* __restrict__ end,
                                            int s0, int tseg, int& a,
                                            int& b) {
  const int lane = threadIdx.x & 31;
  a = -1;
  b = -1;
  if (lane < tseg) {
    a = __ldg(start + s0 + lane);
    b = __ldg(end + s0 + lane);
  }
}

// Stages keys [clo, chi) of the warp's tile: the rows' columns [c0, c0 +
// dw) in w.vals (key j, column c at base + (j - clo) * stride + c), their
// ids and keep flags. Asynchronous: cp_async_wait_all, then __syncwarp.
template <bool kHasKeep>
__device__ __forceinline__ void stage_chunk(
    const float* __restrict__ values, const int* __restrict__ ids,
    const float* __restrict__ keep, long long k, int d, int c0, int dw,
    bool whole, int clo, int chi, WarpSmem<kHasKeep>& w, int& base,
    int& stride) {
  const int lane = threadIdx.x & 31;
  const int rows = chi - clo;
  if (whole) {
    const long long f0 = static_cast<long long>(clo) * d;
    const long long a0 = f0 & ~3LL;
    long long a1 = (static_cast<long long>(chi) * d + 3) & ~3LL;
    if (a1 > k * d) a1 = k * d;
    const int nvec = static_cast<int>((a1 - a0) >> 2);
    for (int i = lane; i < nvec; i += 32) {
      cp_async16(w.vals + 4 * i, values + a0 + 4 * i);
    }
    // K * d not a multiple of 4: the last few floats one by one
    for (long long i = a0 + 4LL * nvec + lane; i < a1; i += 32) {
      cp_async4(w.vals + (i - a0), values + i);
    }
    base = static_cast<int>(f0 - a0);
    stride = d;
  } else {
    for (int i = lane; i < rows * dw; i += 32) {
      const int r = i / dw;
      cp_async4(w.vals + i,
                values + static_cast<long long>(clo + r) * d + c0 + i -
                    r * dw);
    }
    base = 0;
    stride = dw;
  }
  for (int r = lane; r < rows; r += 32) {
    cp_async4(w.ids + r, ids + clo + r);
    if (kHasKeep) cp_async4(w.keep + r, keep + clo + r);
  }
}

// The warp's tile over segments [s0, s0 + tseg) and columns [c0, c0 +
// dw): acc[i] = the sum of pair i (pair_slots(dw)) over its segment's keys
// in key order, from 0 (0 where toff[i] >= tseg). (a, b) hold the lane's
// bounds of this tile on entry (load_bounds) and of the tile at next_s0
// (if >= 0) on return.
template <bool kHasKeep>
__device__ __forceinline__ void sum_tile(
    const float* __restrict__ values, const int* __restrict__ ids,
    const float* __restrict__ keep, const int* __restrict__ start,
    const int* __restrict__ end, long long k, int d, int c0, int dw,
    bool whole, int s0, int tseg, int max_keys, int next_s0, int next_tseg,
    const int (&toff)[kPairs], const int (&col)[kPairs], int& a, int& b,
    float (&acc)[kPairs], WarpSmem<kHasKeep>& w) {
  const unsigned full = 0xffffffffu;
  const int ca = a, cb = b;
  const bool live = ca < cb;
  const int lo = __reduce_min_sync(full, live ? ca : INT_MAX);
  const int hi = __reduce_max_sync(full, live ? cb : 0);
  int clo = lo, base = 0, stride = 0;
  if (clo < hi) {
    stage_chunk<kHasKeep>(values, ids, keep, k, d, c0, dw, whole, clo,
                          hi - clo < max_keys ? hi : clo + max_keys, w, base,
                          stride);
  }
  if (next_s0 >= 0) load_bounds(start, end, next_s0, next_tseg, a, b);
  int jb[kPairs], je[kPairs];
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    jb[i] = __shfl_sync(full, ca, toff[i] & 31);
    je[i] = __shfl_sync(full, cb, toff[i] & 31);
    if (toff[i] >= tseg) je[i] = -1;
    acc[i] = 0.f;
  }
  while (clo < hi) {
    const int chi = hi - clo < max_keys ? hi : clo + max_keys;
    cp_async_wait_all();
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int from = jb[i] > clo ? jb[i] : clo;
      const int to = je[i] < chi ? je[i] : chi;
      const int s = s0 + toff[i];
      for (int j = from; j < to; ++j) {
        const int r = j - clo;
        if (w.ids[r] == s && (!kHasKeep || w.keep[r] != 0.f)) {
          acc[i] += w.vals[base + r * stride + col[i]];
        }
      }
    }
    __syncwarp();  // the chunk has been read
    clo = chi;
    if (clo < hi) {
      stage_chunk<kHasKeep>(values, ids, keep, k, d, c0, dw, whole, clo,
                            hi - clo < max_keys ? hi : clo + max_keys, w,
                            base, stride);
    }
  }
}

}  // namespace segtile
