// Row scatter, in place: table[r(u), :] = values[u, :], where r(u) =
// rows[u] for 0 <= rows[u] < c and the last row c - 1 (the sentinel)
// otherwise. In-bounds rows are duplicate-free; the out-of-bounds pads all
// write the sentinel row, whose content is then one of theirs (racy).
//
// Replaces: paddlebox_tpu/ops/pallas_kernels.py scatter_rows (one grid
// step per row, the output block index clamped to the last row, the
// table aliased to the output). Neither package has a consumer of it: the
// port's push writes through scatter_add_update.
//
// Bound on this card: bytes. The scatter reads U ids and U*F floats and
// writes U*F floats, with no arithmetic; rows land all over a table far
// larger than L2. Design: as gather_rows.cu with the roles of the two
// sides exchanged: a few threads per row, each moving one 16-byte vector
// (F = 16 floats = 4 threads a row) with an ordinary load and store, and
// many rows per 256-thread block. The id is clamped before the address is
// formed, so no id can write outside the table.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

template <int VEC>
__global__ void scatter_rows_kernel(float* __restrict__ table,
                                    const int* __restrict__ rows,
                                    const float* __restrict__ values,
                                    long long n_items, int vec_per_row,
                                    long long c) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                threadIdx.x;
  if (i >= n_items) return;
  long long u = i / vec_per_row;
  int col = static_cast<int>(i - u * vec_per_row);
  long long r = __ldg(rows + u);
  if (r < 0 || r >= c) r = c - 1;
  long long dst = r * vec_per_row + col;
  if (VEC == 4) {
    reinterpret_cast<float4*>(table)[dst] =
        __ldg(reinterpret_cast<const float4*>(values) + i);
  } else {
    table[dst] = __ldg(values + i);
  }
}

}  // namespace

// table [c, feat] f32, rows [u] i32, values [u, feat] f32, all on the
// device; c >= 1. vec = 4 needs feat % 4 == 0 and 16-byte aligned table
// and values. Returns the cudaError_t of the launch.
extern "C" int pbx_scatter_rows(float* table, const int* rows,
                                const float* values, long long u,
                                long long c, int feat, int vec,
                                void* stream) {
  const int threads = 256;
  int vec_per_row = feat / vec;
  long long n_items = u * vec_per_row;
  long long blocks = (n_items + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    scatter_rows_kernel<4><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        table, rows, values, n_items, vec_per_row, c);
  } else {
    scatter_rows_kernel<1><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        table, rows, values, n_items, vec_per_row, c);
  }
  return static_cast<int>(cudaGetLastError());
}
