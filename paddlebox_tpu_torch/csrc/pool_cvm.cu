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
// A segment with no kept key is the CVM of pad_value. The ids inside
// [0, n) must be nondecreasing; any other id drops its key.
//
// Replaces: paddlebox_tpu/ops/pallas_kernels.py fused_pool_cvm_forward
// (kernel _pool_cvm_kernel, epilogue _cvm_transform_wide), which pools by
// one-hot x values matmuls on the TPU's matrix unit over a grid of
// (output block, key block) pairs and falls back to XLA when a key block
// spans too many output blocks.
//
// Bound on this card: bytes. Each key is read once (d floats of values,
// its segment id and keep flag, where there is a mask) and each output
// row written once: at the training path's shapes (K = 532 201 keys of 11
// floats, n = 106 496, no mask) about 30 MB, 9.0 us at 3.35 TB/s. There
// are about d adds per key and a few logs per segment.
//
// Design (segment_tile.cuh): one ctypes call enqueues a memset, the
// key-parallel bounds pass and the tile kernel.
// - No searches: each segment's [start, end) comes from one pass over the
//   ids with no copy of the stream, not from binary searches over all K
//   keys (two chains of ~19 dependent loads a segment).
// - No idle lanes: a warp owns T consecutive segments (T = 11 at d = 11
//   on the training path) and maps its lanes to (segment, column) pairs,
//   up to 4 a lane, where a warp per segment with lane c on column c
//   idles 21 of 32 lanes at d = 11.
// - Coalesced rows: the tile's segments own one contiguous span of rows,
//   staged in the warp's shared memory by 16-byte cp.async copies that
//   neighbouring lanes make on neighbouring addresses, in place of one
//   44-byte strip a key that no other warp shares. The bounds of the
//   warp's next tile load while the copy flies.
// Epilogue: the pooled tile (pad_value added, log1p taken in place on the
// head columns) goes to shared memory, and each lane writes the output
// slots it owns, so the [T, d_out] rows leave with coalesced stores. Sums
// run in key order from 0, then pad_value is added: the plain version's
// order, so the two agree bit for bit. Deterministic; any segment length
// (a span past one chunk is walked chunk by chunk, slowly on one huge
// segment: no path has one).

#include "segment_tile.cuh"

namespace {

constexpr int kNone = 0;
constexpr int kFull = 1;
constexpr int kShow = 2;   // and 3: CONV

template <bool kHasKeep>
__global__ void __launch_bounds__(segtile::kThreads)
pool_cvm_kernel(const float* __restrict__ values, const int* __restrict__ seg,
                const float* __restrict__ keep, const int* __restrict__ start,
                const int* __restrict__ end, float* __restrict__ out,
                long long k, int n, int d, int d_out, int mode,
                int cvm_offset, int ets, float pad_value, int tile,
                int max_keys, int ntiles) {
  constexpr int kP = segtile::kPairs;
  extern __shared__ __align__(16) unsigned char smem[];
  segtile::WarpSmem<kHasKeep>& w =
      reinterpret_cast<segtile::WarpSmem<kHasKeep>*>(smem)[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const int step = gridDim.x * segtile::kWarps;
  const bool whole = (reinterpret_cast<uintptr_t>(values) & 15) == 0;
  int toff[kP], col[kP];
  segtile::pair_slots(d, toff, col);
  // the head columns that take log1p in place
  const int nlog = mode == kNone ? 0 : mode == kFull ? 2 : mode == kShow ? 1
                                                                          : 3;
  // output slot m: row qt of the tile = pooled column qsrc, minus pooled
  // column qsub where qsub >= 0
  int qt[kP], qsrc[kP], qsub[kP];
#pragma unroll
  for (int m = 0; m < kP; ++m) {
    const int q = lane + 32 * m;
    qt[m] = q / d_out;
    const int oc = q - qt[m] * d_out;
    qsub[m] = -1;
    if (mode == kNone) {
      qsrc[m] = cvm_offset + ets + oc;
    } else if (mode == kFull) {
      qsrc[m] = oc < 2 ? oc : cvm_offset + oc - 2;
      if (oc == 1) qsub[m] = 0;
    } else if (mode == kShow) {
      qsrc[m] = oc == 0 ? 0 : cvm_offset + oc - 1;
    } else {  // CONV
      qsrc[m] = oc;
      if (oc == 2) qsub[m] = 1;
    }
  }
  int wt = blockIdx.x * segtile::kWarps + (threadIdx.x >> 5);
  int a = -1, b = -1;
  if (wt < ntiles) {
    segtile::load_bounds(start, end, wt * tile,
                         n - wt * tile < tile ? n - wt * tile : tile, a, b);
  }
  for (; wt < ntiles; wt += step) {
    const int s0 = wt * tile;
    const int tseg = n - s0 < tile ? n - s0 : tile;
    const int ns0 = wt + step < ntiles ? (wt + step) * tile : -1;
    float acc[kP];
    segtile::sum_tile<kHasKeep>(
        values, seg, keep, start, end, k, d, 0, d, whole, s0, tseg,
        max_keys, ns0, n - ns0 < tile ? n - ns0 : tile, toff, col, a, b,
        acc, w);
    // the pooled tile in the warp's buffer: pad_value added, the head
    // columns' log1p taken
#pragma unroll
    for (int i = 0; i < kP; ++i) {
      if (toff[i] < tseg) {
        float v = acc[i] + pad_value;
        if (col[i] < nlog) v = log1pf(v);
        w.vals[lane + 32 * i] = v;
      }
    }
    __syncwarp();
    float* o = out + static_cast<long long>(s0) * d_out;
#pragma unroll
    for (int m = 0; m < kP; ++m) {
      if (qt[m] < tseg) {
        const float* row = w.vals + qt[m] * d;
        float v = row[qsrc[m]];
        if (qsub[m] >= 0) v -= row[qsub[m]];
        o[lane + 32 * m] = v;
      }
    }
    __syncwarp();  // the buffer has been read
  }
}

template <bool kHasKeep>
int launch_tiles(const float* values, const int* seg, const float* keep,
                 const int* bounds, float* out, long long k, int n, int d,
                 int d_out, int mode, int cvm_offset, int ets,
                 float pad_value, cudaStream_t stream) {
  const size_t smem = segtile::kWarps * sizeof(segtile::WarpSmem<kHasKeep>);
  static int query_rc = 0;
  static const unsigned resident = segtile::resident_blocks(
      pool_cvm_kernel<kHasKeep>, smem, &query_rc);
  if (query_rc != 0) return query_rc;
  const int tile = segtile::tile_segments(k, n, d);
  const int ntiles = (n + tile - 1) / tile;
  const long long need = (ntiles + segtile::kWarps - 1) / segtile::kWarps;
  const unsigned blocks =
      static_cast<unsigned>(need < resident ? need : resident);
  pool_cvm_kernel<kHasKeep><<<blocks, segtile::kThreads, smem, stream>>>(
      values, seg, keep, bounds, bounds + n, out, k, n, d, d_out, mode,
      cvm_offset, ets, pad_value, tile, segtile::chunk_keys(d), ntiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// seg [k] i32, bounds [2, n] i32 (start, end) on the device: the bounds
// pass alone. Returns the first cudaError_t.
extern "C" int pbx_pool_cvm_bounds(const int* seg, long long k, int n,
                                   int* bounds, void* stream) {
  return segtile::launch_bounds(seg, k, n, bounds,
                                static_cast<cudaStream_t>(stream));
}

// The tile kernel alone, over bounds from pbx_pool_cvm_bounds. values
// [k, d] f32, seg [k] i32, keep [k] f32 or null (every key kept), out
// [n, d_out] f32, all on the device; n >= 1, 1 <= d <= 128.
extern "C" int pbx_pool_cvm_tiles(const float* values, const int* seg,
                                  const float* keep, const int* bounds,
                                  float* out, long long k, int n, int d,
                                  int d_out, int mode, int cvm_offset,
                                  int ets, float pad_value, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (keep != nullptr) {
    return launch_tiles<true>(values, seg, keep, bounds, out, k, n, d, d_out,
                              mode, cvm_offset, ets, pad_value, st);
  }
  return launch_tiles<false>(values, seg, keep, bounds, out, k, n, d, d_out,
                             mode, cvm_offset, ets, pad_value, st);
}

// The whole pool: bounds pass, then tiles, on one stream (bounds is the
// caller's [2, n] i32 scratch). Returns the first cudaError_t.
extern "C" int pbx_pool_cvm(const float* values, const int* seg,
                            const float* keep, int* bounds, float* out,
                            long long k, int n, int d, int d_out, int mode,
                            int cvm_offset, int ets, float pad_value,
                            void* stream) {
  const int rc = pbx_pool_cvm_bounds(seg, k, n, bounds, stream);
  if (rc != 0) return rc;
  return pbx_pool_cvm_tiles(values, seg, keep, bounds, out, k, n, d, d_out,
                            mode, cvm_offset, ets, pad_value, stream);
}
