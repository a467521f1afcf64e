// Segment sum: out[s, :] = sum over keys j with ids[j] == s of values[j, :]
// for s in [0, n), f32, in key order; keys with ids outside [0, n) are
// dropped (−1 markers may sit anywhere), the others are nondecreasing,
// and a segment with no keys is 0.
//
// Replaces: paddlebox_tpu/ops/pallas_kernels.py _segment_sum_mxu_impl
// (kernel _seg_sum_kernel), the segment_sum_mxu of the seqpool op family:
// a one-hot x values matmul on the TPU's matrix unit over a grid of
// (output block, key block) pairs, with an XLA fallback when a key block
// spans more output blocks than the static pair budget allows.
//
// Bound on this card: bytes. Each key is read once (d floats and its id)
// and each output row written once: on the seqpool family's pool stream
// (K = 532 201 keys of 11 floats, n = 106 497) about 30 MB, some 9 us at
// 3.35 TB/s. There is one add per key and column.
//
// Design (segment_tile.cuh, as pool_cvm.cu): one ctypes call enqueues a
// memset, the key-parallel bounds pass and the tile kernel.
// - No searches: each segment's [start, end) comes from one pass over the
//   ids, with no nondecreasing copy of the stream to search.
// - No idle lanes: a warp owns T consecutive segments of a column tile of
//   dw = min(d, 128) columns (tiles walk the column tiles too, so any
//   width works) and maps its lanes to (segment, column) pairs.
// - Coalesced rows: the tile's contiguous span of rows is staged in the
//   warp's shared memory (16-byte cp.async copies when a column tile is
//   the whole row) and the [T, dw] sums leave with row-contiguous stores.
// A dropped key inside a segment's span adds nothing (not 0 * its value,
// so an inf or NaN of a dropped key stays out). Sums run in key order
// from 0: deterministic, and the plain version's order. Any segment
// length: a span past one chunk is walked chunk by chunk, slowly on one
// huge segment, which no path has.

#include "segment_tile.cuh"

namespace {

__global__ void __launch_bounds__(segtile::kThreads)
segment_sum_kernel(const float* __restrict__ values,
                   const int* __restrict__ ids, const int* __restrict__ start,
                   const int* __restrict__ end, float* __restrict__ out,
                   long long k, int n, int d, int dw_max, int ncol, int tile,
                   int max_keys, int ntiles) {
  constexpr int kP = segtile::kPairs;
  extern __shared__ __align__(16) unsigned char smem[];
  segtile::WarpSmem<false>& w =
      reinterpret_cast<segtile::WarpSmem<false>*>(smem)[threadIdx.x >> 5];
  const int step = gridDim.x * segtile::kWarps;
  const bool aligned = (reinterpret_cast<uintptr_t>(values) & 15) == 0;
  int toff[kP], col[kP];
  int slot_dw = dw_max;
  segtile::pair_slots(slot_dw, toff, col);
  // tile wt: segments from (wt / ncol) * tile, columns from (wt % ncol) *
  // dw_max
  int wt = blockIdx.x * segtile::kWarps + (threadIdx.x >> 5);
  int a = -1, b = -1;
  if (wt < ntiles) {
    const int s0 = wt / ncol * tile;
    segtile::load_bounds(start, end, s0, n - s0 < tile ? n - s0 : tile, a,
                         b);
  }
  for (; wt < ntiles; wt += step) {
    const int s0 = wt / ncol * tile;
    const int tseg = n - s0 < tile ? n - s0 : tile;
    const int c0 = wt % ncol * dw_max;
    const int dw = d - c0 < dw_max ? d - c0 : dw_max;
    if (dw != slot_dw) {   // the last, narrower column tile
      slot_dw = dw;
      segtile::pair_slots(slot_dw, toff, col);
    }
    const int ns0 = wt + step < ntiles ? (wt + step) / ncol * tile : -1;
    float acc[kP];
    segtile::sum_tile<false>(
        values, ids, nullptr, start, end, k, d, c0, dw, aligned && dw == d,
        s0, tseg, max_keys, ns0, n - ns0 < tile ? n - ns0 : tile, toff, col,
        a, b, acc, w);
#pragma unroll
    for (int i = 0; i < kP; ++i) {
      if (toff[i] < tseg) {
        out[static_cast<long long>(s0 + toff[i]) * d + c0 + col[i]] =
            acc[i];
      }
    }
  }
}

}  // namespace

// ids [k] i32, bounds [2, n] i32 (start, end) on the device: the bounds
// pass alone. Returns the first cudaError_t.
extern "C" int pbx_segment_sum_bounds(const int* ids, long long k, int n,
                                      int* bounds, void* stream) {
  return segtile::launch_bounds(ids, k, n, bounds,
                                static_cast<cudaStream_t>(stream));
}

// The tile kernel alone, over bounds from pbx_segment_sum_bounds. values
// [k, d] f32, ids [k] i32, out [n, d] f32, all on the device; n >= 1,
// d >= 1.
extern "C" int pbx_segment_sum_tiles(const float* values, const int* ids,
                                     const int* bounds, float* out,
                                     long long k, int n, int d,
                                     void* stream) {
  const size_t smem = segtile::kWarps * sizeof(segtile::WarpSmem<false>);
  static int query_rc = 0;
  static const unsigned resident = segtile::resident_blocks(
      segment_sum_kernel, smem, &query_rc);
  if (query_rc != 0) return query_rc;
  const int dw_max = d < segtile::kMaxCols ? d : segtile::kMaxCols;
  const int ncol = (d + dw_max - 1) / dw_max;
  const int tile = segtile::tile_segments(k, n, dw_max);
  const long long ntiles = static_cast<long long>((n + tile - 1) / tile) *
                           ncol;
  if (ntiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const long long need = (ntiles + segtile::kWarps - 1) / segtile::kWarps;
  const unsigned blocks =
      static_cast<unsigned>(need < resident ? need : resident);
  segment_sum_kernel<<<blocks, segtile::kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      values, ids, bounds, bounds + n, out, k, n, d, dw_max, ncol, tile,
      segtile::chunk_keys(dw_max), static_cast<int>(ntiles));
  return static_cast<int>(cudaGetLastError());
}

// The whole sum: bounds pass, then tiles, on one stream (bounds is the
// caller's [2, n] i32 scratch). Returns the first cudaError_t.
extern "C" int pbx_segment_sum(const float* values, const int* ids,
                               int* bounds, float* out, long long k, int n,
                               int d, void* stream) {
  const int rc = pbx_segment_sum_bounds(ids, k, n, bounds, stream);
  if (rc != 0) return rc;
  return pbx_segment_sum_tiles(values, ids, bounds, out, k, n, d, stream);
}
