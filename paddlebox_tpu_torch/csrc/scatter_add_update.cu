// Unique-row scatter-add into the embedding table, in place:
// values[rows[u], :] += deltas[u, :], with rows outside [0, c) dropped.
//
// Replaces: paddlebox_tpu/ops/pallas_index.py scatter_add_update (a Pallas
// kernel that aliases the table and adds one row block per grid step) and,
// in the port's row-major table, the XLA line scatter-add that writes
// paddlebox_tpu/ps/table.py apply_push's `new - old` deltas back. The port
// passes c = capacity, so the pads' out-of-bounds ids and the zero
// sentinel row c are never written.
//
// Bound on this card: bytes, and how many of them are in flight. Each kept
// row reads its id, its delta row and its table row and writes the table
// row back; the table rows are scattered over a table far larger than L2.
// A random DRAM access takes ~0.6-0.8 us, so 3.35 TB/s needs ~2-2.7 MB in
// flight, ~16-20 KB an SM. A table row at an arbitrary 4-byte offset
// moves whole 32-byte sectors both ways: 5.5 on average for F = 37 (148
// bytes) and 3.75 for F = 23 (92 bytes).
//
// Design: the rows are duplicate-free in bounds (the dedup contract of the
// unique-row bucket), so no two lanes touch one address and no atomics are
// needed. A warp takes the rows 32 at a time (a chunk): lane l loads the
// chunk's id l with one coalesced load, a chunk ahead of its use, and the
// lanes hand the ids out by __shfl_sync, so no data load waits on a round
// trip for its own id. The chunk's 32 delta rows are one flat block of
// 32 w units (w = F / 4 16-byte vectors when F % 4 == 0 and both bases
// are 16-byte aligned, else w = F floats); lane l takes units l, l + 32,
// ...: unit e from its flat place in `deltas` and from row e / w, unit
// e % w of the table (stepped without a division). A lane issues the
// table and delta loads of a group of units (16 floats or 4 vectors, 64
// bytes of each) into registers before its first add, then adds and
// stores the group at the table offsets kept from its loads. (A cp.async
// shared-memory ring of the same loads, the shape that won on
// csrc/row_dma.cu's scatter, ran slower at widths 37 and 23 and tied at
// 12-24; other group and block sizes, re-walking the units for the
// stores and a grid of one warp a chunk came within a few percent:
// tools/row_sweep.py, PERF.md §6.) The grid is the blocks the card holds
// at once, each warp walking the chunks with the grid's stride. Offsets
// inside a chunk are 32-bit; the chunk base and the table row offset are
// 64-bit products, with no division per element. The id is range-checked
// before an address is formed. Exact: one float add per element, as the
// reference's.

#include <cuda_runtime.h>
#include <cstdint>

#include "row_walk.cuh"

namespace {

using rowwalk::Walk;

constexpr int kThreads = 256;

// The id of this lane's row of chunk ch: -1 past u or outside [0, c).
__device__ __forceinline__ int chunk_id(const int* __restrict__ rows,
                                        long long ch, long long u, int c) {
  const long long i = (ch << 5) + (threadIdx.x & 31);
  const int r = i < u ? __ldg(rows + i) : -1;
  return (r < 0 || r >= c) ? -1 : r;
}

__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
  return a;
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
scatter_add_kernel(T* __restrict__ values, const int* __restrict__ rows,
                   const T* __restrict__ deltas, long long u, int w, int c) {
  const int lane = threadIdx.x & 31;
  const long long n_chunks = (u + 31) >> 5;
  const long long stride =
      static_cast<long long>(gridDim.x) * (kThreads / 32);
  long long ch =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const Walk start(w);
  int next = ch < n_chunks ? chunk_id(rows, ch, u, c) : -1;
  for (; ch < n_chunks; ch += stride) {
    const int id = next;
    next = ch + stride < n_chunks ? chunk_id(rows, ch + stride, u, c) : -1;
    const T* d = deltas + (ch << 5) * w;
    Walk at = start;
    for (int j0 = 0; j0 < w; j0 += G) {
      T a[G], b[G];
      long long off[G];   // each unit's table offset, -1 to skip
#pragma unroll
      for (int k = 0; k < G; ++k) {
        if (j0 + k < w) {   // the same on every lane
          const int dst = __shfl_sync(0xffffffffu, id, at.r);
          off[k] = dst >= 0 ? static_cast<long long>(dst) * w + at.c : -1;
          if (dst >= 0) {
            a[k] = values[off[k]];
            b[k] = __ldg(d + lane + 32 * (j0 + k));
          }
          at.next();
        }
      }
#pragma unroll
      for (int k = 0; k < G; ++k) {
        if (j0 + k < w && off[k] >= 0) values[off[k]] = add(a[k], b[k]);
      }
    }
  }
}

template <typename T>
int launch(float* values, const int* rows, const float* deltas, long long u,
           int c, int w, cudaStream_t s) {
  constexpr int G = 64 / static_cast<int>(sizeof(T));
  static int rc = 0;
  static const long long resident =
      rowwalk::resident_blocks(scatter_add_kernel<T, G>, kThreads, &rc);
  if (rc != 0) return rc;
  const unsigned g = rowwalk::grid(u, kThreads, resident);
  scatter_add_kernel<T, G><<<g, kThreads, 0, s>>>(
      reinterpret_cast<T*>(values), rows,
      reinterpret_cast<const T*>(deltas), u, w, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// values [c, feat] f32 (updated in place), rows [u] i32, deltas [u, feat]
// f32, all on the device. vec = 4 moves 16-byte vectors: it needs feat % 4
// == 0 and 16-byte aligned values and deltas; vec = 1 moves floats, any
// feat and 4-byte alignment. Returns the cudaError_t of the launch.
extern "C" int pbx_scatter_add_update(float* values, const int* rows,
                                      const float* deltas, long long u,
                                      long long c, int feat, int vec,
                                      void* stream) {
  if (u <= 0 || feat <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cc = static_cast<int>(c);
  return vec == 4 ? launch<float4>(values, rows, deltas, u, cc, feat / 4, s)
                  : launch<float>(values, rows, deltas, u, cc, feat, s);
}
