// Row gather of the embedding table (the pull): out[u, :] = table[r(u), :],
// where r(u) = rows[u] for 0 <= rows[u] <= cap and the zero sentinel row
// `cap` otherwise (the distinct out-of-bounds pad ids of the unique-row
// bucket).
//
// Replaces: paddlebox_tpu/ops/pallas_kernels.py gather_rows (a
// scalar-prefetch Pallas row gather over 128-lane packed lines) as used by
// paddlebox_tpu/ps/table.py gather_full_rows. The port keeps the table
// row-major [cap+1, F] f32, so one logical row is F contiguous floats.
//
// Bound on this card: bytes, and how many of them are in flight. The
// gather reads U ids and U rows of F floats scattered over a table far
// larger than L2, and writes the U rows packed. A random DRAM access takes
// ~0.6-0.8 us, so 3.35 TB/s needs ~2-2.7 MB in flight, ~16-20 KB an SM.
// A row at an arbitrary 4-byte offset also reads whole 32-byte sectors:
// ceil((offset + 4F) / 32) of them, 5.5 on average for F = 37 (148 bytes)
// and 3.75 for F = 23 (92 bytes), 19% and 30% more than its bytes.
//
// Design: a warp takes the rows 32 at a time (a chunk). Lane l loads the
// chunk's id l with one coalesced load, a chunk ahead of its use, and the
// lanes hand the ids out by __shfl_sync, so no data load waits on a round
// trip for its own id. The chunk's 32 output rows are one flat block of
// 32 w units (w = F / 4 16-byte vectors when F % 4 == 0 and both bases
// are 16-byte aligned, else w = F floats). Lane l moves units l, l + 32,
// l + 64, ...: each to its flat place in `out`, from its row's place in
// the table (row e / w, unit e % w, stepped without a division). The
// packed output rows start at u F 4 bytes, so at an odd F the source and
// destination offsets of a row differ; moving one unit at its own address
// on each side leaves the packed side fully coalesced and the table side
// reading only its row's sectors. A lane issues up to 128 bytes of loads
// (32 floats or 8 vectors) before its first store. The grid is the blocks
// the card holds at once, each warp walking the chunks with the grid's
// stride. (Groups of 64 or 256 bytes, 128 or 512 threads a block and a
// grid of one warp a chunk came within a few percent of this at widths
// 12-37, none best at every width: tools/row_sweep.py, PERF.md §6.)
// Offsets inside a chunk are 32-bit; the chunk base and the table row
// offset are 64-bit products, with no division per element. The id is
// clamped before an address is formed. Exact: a copy.

#include <cuda_runtime.h>
#include <cstdint>

#include "row_walk.cuh"

namespace {

using rowwalk::Walk;

constexpr int kThreads = 256;

__device__ __forceinline__ int chunk_id(const int* __restrict__ rows,
                                        long long ch, long long u) {
  const long long i = (ch << 5) + (threadIdx.x & 31);
  return i < u ? __ldg(rows + i) : 0;
}

// G: units a lane loads before its first store (128 bytes)
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const T* __restrict__ table, const int* __restrict__ rows,
                   T* __restrict__ out, long long u, int w, int cap) {
  const int lane = threadIdx.x & 31;
  const long long n_chunks = (u + 31) >> 5;
  const long long stride =
      static_cast<long long>(gridDim.x) * (kThreads / 32);
  long long ch =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const Walk start(w);
  int next = ch < n_chunks ? chunk_id(rows, ch, u) : 0;
  for (; ch < n_chunks; ch += stride) {
    const int id = (next < 0 || next > cap) ? cap : next;
    next = ch + stride < n_chunks ? chunk_id(rows, ch + stride, u) : 0;
    const long long base = ch << 5;
    const int n_units =
        static_cast<int>(u - base < 32 ? u - base : 32) * w;
    T* dst = out + base * w;
    Walk at = start;
    for (int j0 = 0; j0 < w; j0 += G) {
      T v[G];
#pragma unroll
      for (int k = 0; k < G; ++k) {
        if (j0 + k < w) {   // the same on every lane
          const int src = __shfl_sync(0xffffffffu, id, at.r);
          if (lane + 32 * (j0 + k) < n_units) {
            v[k] = __ldg(table + static_cast<long long>(src) * w + at.c);
          }
          at.next();
        }
      }
#pragma unroll
      for (int k = 0; k < G; ++k) {
        const int e = lane + 32 * (j0 + k);
        if (j0 + k < w && e < n_units) dst[e] = v[k];
      }
    }
  }
}

template <typename T>
int launch(const float* table, const int* rows, float* out, long long u,
           int cap, int w, cudaStream_t s) {
  constexpr int G = 128 / static_cast<int>(sizeof(T));
  static int rc = 0;
  static const long long resident =
      rowwalk::resident_blocks(gather_rows_kernel<T, G>, kThreads, &rc);
  if (rc != 0) return rc;
  const unsigned g = rowwalk::grid(u, kThreads, resident);
  gather_rows_kernel<T, G><<<g, kThreads, 0, s>>>(
      reinterpret_cast<const T*>(table), rows, reinterpret_cast<T*>(out), u,
      w, cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table [cap+1, feat] f32, rows [u] i32, out [u, feat] f32, all on the
// device. vec = 4 moves 16-byte vectors: it needs feat % 4 == 0 and 16-byte
// aligned table and out; vec = 1 moves floats, any feat and 4-byte
// alignment. Returns the cudaError_t of the launch.
extern "C" int pbx_gather_rows(const float* table, const int* rows,
                               float* out, long long u, long long cap,
                               int feat, int vec, void* stream) {
  if (u <= 0 || feat <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c = static_cast<int>(cap);
  return vec == 4 ? launch<float4>(table, rows, out, u, c, feat / 4, s)
                  : launch<float>(table, rows, out, u, c, feat, s);
}
