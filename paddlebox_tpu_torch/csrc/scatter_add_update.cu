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
// Bound on this card: bytes. Each kept row reads its id, its delta row and
// its table row and writes the table row back (4 + 3 x 64 bytes for a
// 16-float row); the rows are scattered over a table far larger than L2,
// so every row is a fresh DRAM access. Design: the rows are duplicate-free
// in bounds (the dedup contract of the unique-row bucket), so no two
// threads touch one address and no atomics are needed; one thread moves
// one 16-byte vector of a row (4 threads per 16-float row), so every load
// and store is a full 16-byte transaction and a warp keeps 8 rows in
// flight. The id is range-checked before any address is formed. Exact:
// one float add per element, as the reference's.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

template <int VEC>
__global__ void scatter_add_kernel(float* __restrict__ values,
                                   const int* __restrict__ rows,
                                   const float* __restrict__ deltas,
                                   long long n_items, int vec_per_row,
                                   long long c) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                threadIdx.x;
  if (i >= n_items) return;
  long long u = i / vec_per_row;
  int v = static_cast<int>(i - u * vec_per_row);
  long long r = __ldg(rows + u);
  if (r < 0 || r >= c) return;
  long long dst = r * vec_per_row + v;
  if (VEC == 4) {
    float4* tv = reinterpret_cast<float4*>(values) + dst;
    float4 a = *tv;
    float4 b = __ldg(reinterpret_cast<const float4*>(deltas) + i);
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
    *tv = a;
  } else {
    values[dst] += __ldg(deltas + i);
  }
}

}  // namespace

// values [c, feat] f32 (updated in place), rows [u] i32, deltas [u, feat]
// f32, all on the device. vec = 4 needs feat % 4 == 0 and 16-byte aligned
// values and deltas. Returns the cudaError_t of the launch.
extern "C" int pbx_scatter_add_update(float* values, const int* rows,
                                      const float* deltas, long long u,
                                      long long c, int feat, int vec,
                                      void* stream) {
  const int threads = 256;
  int vec_per_row = feat / vec;
  long long n_items = u * vec_per_row;
  if (n_items == 0) return 0;
  long long blocks = (n_items + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    scatter_add_kernel<4><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        values, rows, deltas, n_items, vec_per_row, c);
  } else {
    scatter_add_kernel<1><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        values, rows, deltas, n_items, vec_per_row, c);
  }
  return static_cast<int>(cudaGetLastError());
}
