// Fused sequence pool + CVM head over ragged (instance, slot) segments.
//
// For each output segment s in [0, n) (n = B*S):
//   pooled[c] = pad_value + sum over keys j with seg[j] == s and
//               keep[j] != 0 of values[j, c]     (f32, in key order)
// then the CVM epilogue of the mode writes out[s, :]:
//   NONE: pooled[cvm_offset + ets : d]
//   FULL: [log1p(p0), log1p(p1) - log1p(p0), pooled[cvm_offset : d]]
//   SHOW: [log1p(p0), pooled[cvm_offset : d]]
//   CONV: [log1p(p0), log1p(p1), log1p(p2) - log1p(p1), pooled[3 : d]]
// A segment with no kept key is the CVM of pad_value.
//
// Replaces: paddlebox_tpu/ops/pallas_kernels.py fused_pool_cvm_forward
// (kernel _pool_cvm_kernel, epilogue _cvm_transform_wide), which pools by
// one-hot x values matmuls on the TPU's matrix unit over a grid of
// (output block, key block) pairs and falls back to XLA when a key block
// spans too many output blocks.
//
// Bound on this card: bytes. Each key is read once (d floats of values
// plus its segment id and keep flag) and each output row written once;
// there are about d adds per key and a few logs per segment.
// Design: the wrapper hands over a NONDECREASING segment stream: a
// dropped key (id outside [0, n)) takes the id of the next valid key, or
// n past the last one, and keep = 0. The keys of a segment are then one
// contiguous run found by binary search, and the tail pads join no run.
// One warp owns one segment: it searches [lo, hi), walks the run in key order
// with lane c summing column c (c, c+32, ... up to d <= 128) in registers,
// then applies the epilogue and writes its row. No atomics, no shared
// memory, no cross-block state: the sum order is fixed, so the result is
// deterministic, and any segment length is handled (no overflow limit).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kNone = 0;
constexpr int kFull = 1;
constexpr int kShow = 2;
constexpr int kConv = 3;
constexpr int kMaxColsPerLane = 4;  // d <= 128

__device__ __forceinline__ long long lower_bound(const int* __restrict__ seg,
                                                 long long k, int s) {
  long long lo = 0, hi = k;
  while (lo < hi) {
    long long mid = (lo + hi) >> 1;
    if (__ldg(seg + mid) < s) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void pool_cvm_kernel(const float* __restrict__ values,
                                const int* __restrict__ seg,
                                const float* __restrict__ keep,
                                float* __restrict__ out, long long k, int n,
                                int d, int d_out, int mode, int cvm_offset,
                                int ets, float pad_value) {
  const int lane = threadIdx.x & 31;
  const long long s =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (s >= n) return;  // uniform across the warp
  const int si = static_cast<int>(s);
  const long long lo = lower_bound(seg, k, si);
  const long long hi = lower_bound(seg, k, si + 1);

  float acc[kMaxColsPerLane];
#pragma unroll
  for (int i = 0; i < kMaxColsPerLane; ++i) acc[i] = 0.f;
  for (long long j = lo; j < hi; ++j) {
    if (__ldg(keep + j) == 0.f) continue;  // same branch for every lane
    const float* row = values + j * d;
#pragma unroll
    for (int i = 0; i < kMaxColsPerLane; ++i) {
      int c = lane + 32 * i;
      if (c < d) acc[i] += __ldg(row + c);
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxColsPerLane; ++i) acc[i] += pad_value;

  const unsigned full = 0xffffffffu;
  const float l0 = log1pf(__shfl_sync(full, acc[0], 0));
  const float l1 = log1pf(__shfl_sync(full, acc[0], 1));
  const float l2 = log1pf(__shfl_sync(full, acc[0], 2));

  float* o = out + s * d_out;
#pragma unroll
  for (int i = 0; i < kMaxColsPerLane; ++i) {
    const int c = lane + 32 * i;
    if (c >= d) continue;
    float v = acc[i];
    int pos = -1;
    if (mode == kNone) {
      pos = c - (cvm_offset + ets);
    } else if (mode == kFull) {
      if (c == 0) {
        pos = 0;
        v = l0;
      } else if (c == 1) {
        pos = 1;
        v = l1 - l0;
      } else if (c >= cvm_offset) {
        pos = 2 + c - cvm_offset;
      }
    } else if (mode == kShow) {
      if (c == 0) {
        pos = 0;
        v = l0;
      } else if (c >= cvm_offset) {
        pos = 1 + c - cvm_offset;
      }
    } else {  // kConv
      pos = c;
      if (c == 0) {
        v = l0;
      } else if (c == 1) {
        v = l1;
      } else if (c == 2) {
        v = l2 - l1;
      }
    }
    if (pos >= 0) o[pos] = v;
  }
}

}  // namespace

// values [k, d] f32, seg [k] i32 nondecreasing, keep [k] f32 (0 drops a
// key), out [n, d_out] f32, all on the device; d <= 128. Returns the
// cudaError_t of the launch.
extern "C" int pbx_pool_cvm(const float* values, const int* seg,
                            const float* keep, float* out, long long k,
                            int n, int d, int d_out, int mode, int cvm_offset,
                            int ets, float pad_value, void* stream) {
  const int threads = 256;  // 8 segments per block
  long long blocks = (static_cast<long long>(n) * 32 + threads - 1) / threads;
  pool_cvm_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      values, seg, keep, out, k, n, d, d_out, mode, cvm_offset, ets,
      pad_value);
  return static_cast<int>(cudaGetLastError());
}
