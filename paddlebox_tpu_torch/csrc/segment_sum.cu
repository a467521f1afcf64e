// Segment sum: out[s, :] = sum over keys j with ids[j] == s of values[j, :]
// for s in [0, n), f32, in key order; keys with ids outside [0, n) are
// dropped and a segment with no keys is 0.
//
// Replaces: paddlebox_tpu/ops/pallas_kernels.py _segment_sum_mxu_impl
// (kernel _seg_sum_kernel), the segment_sum_mxu of the seqpool op family:
// a one-hot x values matmul on the TPU's matrix unit over a grid of
// (output block, key block) pairs, with an XLA fallback when a key block
// spans more output blocks than the static pair budget allows.
//
// Bound on this card: bytes. Each key is read once (d floats and its id)
// and each output row written once; there is one add per key and column.
// Design: the wrapper hands over two id streams of the K keys: `ids`, the
// caller's ids, and `run`, a NONDECREASING stream in which a dropped key
// takes the id of the next kept key (n past the last one). The keys of
// segment s then lie in the run [lo, hi) of `run` equal to s, found by
// binary search, and a key of that run is summed only where ids[j] == s
// too (a dropped key inside the run adds nothing, not 0 * its value, so
// an inf or NaN of a dropped key stays out). One warp owns one segment:
// lane c sums columns c, c+32, c+64, c+96 of a 128-column tile in
// registers over the run in key order, writes them, and moves to the next
// tile, so any width works. No atomics and no shared memory: the sum
// order is fixed, so the result is deterministic, and a segment of any
// length is handled (no overflow limit). A long run costs its one warp a
// serial walk of the run.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kColsPerLane = 4;           // a tile of 128 columns a pass
constexpr int kTile = 32 * kColsPerLane;

__device__ __forceinline__ long long lower_bound(const int* __restrict__ run,
                                                 long long k, int s) {
  long long lo = 0, hi = k;
  while (lo < hi) {
    long long mid = (lo + hi) >> 1;
    if (__ldg(run + mid) < s) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void segment_sum_kernel(const float* __restrict__ values,
                                   const int* __restrict__ ids,
                                   const int* __restrict__ run,
                                   float* __restrict__ out, long long k,
                                   int n, int d) {
  const int lane = threadIdx.x & 31;
  const long long s =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (s >= n) return;  // uniform across the warp
  const int si = static_cast<int>(s);
  const long long lo = lower_bound(run, k, si);
  const long long hi = lower_bound(run, k, si + 1);
  float* o = out + s * d;
  for (int c0 = 0; c0 < d; c0 += kTile) {
    float acc[kColsPerLane];
#pragma unroll
    for (int i = 0; i < kColsPerLane; ++i) acc[i] = 0.f;
    for (long long j = lo; j < hi; ++j) {
      if (__ldg(ids + j) != si) continue;  // same branch for every lane
      const float* row = values + j * d + c0;
#pragma unroll
      for (int i = 0; i < kColsPerLane; ++i) {
        const int c = lane + 32 * i;
        if (c0 + c < d) acc[i] += __ldg(row + c);
      }
    }
#pragma unroll
    for (int i = 0; i < kColsPerLane; ++i) {
      const int c = c0 + lane + 32 * i;
      if (c < d) o[c] = acc[i];
    }
  }
}

}  // namespace

// values [k, d] f32, ids [k] i32 (the caller's), run [k] i32 (nondecreasing,
// see above), out [n, d] f32, all on the device; n >= 1, d >= 1. Returns
// the cudaError_t of the launch.
extern "C" int pbx_segment_sum(const float* values, const int* ids,
                               const int* run, float* out, long long k,
                               int n, int d, void* stream) {
  const int threads = 256;  // 8 segments per block
  long long blocks = (static_cast<long long>(n) * 32 + threads - 1) / threads;
  segment_sum_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      values, ids, run, out, k, n, d);
  return static_cast<int>(cudaGetLastError());
}
