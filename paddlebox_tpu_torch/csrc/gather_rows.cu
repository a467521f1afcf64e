// Row gather of the embedding table: out[u, :] = table[r(u), :], where
// r(u) = rows[u] for 0 <= rows[u] <= cap and the zero sentinel row `cap`
// otherwise (the distinct out-of-bounds pad ids of the unique-row bucket).
//
// Replaces: paddlebox_tpu/ops/pallas_kernels.py gather_rows (a
// scalar-prefetch Pallas row gather over 128-lane packed lines) as used by
// paddlebox_tpu/ps/table.py gather_full_rows. The port keeps the table
// row-major [cap+1, F] f32, so one logical row is F contiguous floats.
//
// Bound on this card: bytes. The gather moves U*F*4 bytes in and out and
// reads U*4 bytes of ids, with no arithmetic; rows are scattered over a
// table far larger than L2, so every row is a fresh DRAM access.
// Design: a few threads per row, each moving one 16-byte vector (F = 16
// floats = 4 threads per row), and many rows per 256-thread block, so a
// warp keeps 8 independent rows in flight and every load and store is a
// full 16-byte transaction. The id is clamped before the address is
// formed, so no id can reach outside the table. Exact: a pure copy.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

template <int VEC>
__global__ void gather_rows_kernel(const float* __restrict__ table,
                                   const int* __restrict__ rows,
                                   float* __restrict__ out,
                                   long long n_items, int vec_per_row,
                                   long long cap) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                threadIdx.x;
  if (i >= n_items) return;
  long long u = i / vec_per_row;
  int c = static_cast<int>(i - u * vec_per_row);
  long long r = __ldg(rows + u);
  if (r < 0 || r > cap) r = cap;
  long long src = r * vec_per_row + c;
  if (VEC == 4) {
    reinterpret_cast<float4*>(out)[i] =
        __ldg(reinterpret_cast<const float4*>(table) + src);
  } else {
    out[i] = __ldg(table + src);
  }
}

}  // namespace

// table [cap+1, feat] f32, rows [u] i32, out [u, feat] f32, all on the
// device. vec = 4 needs feat % 4 == 0 and 16-byte aligned table and out.
// Returns the cudaError_t of the launch.
extern "C" int pbx_gather_rows(const float* table, const int* rows,
                               float* out, long long u, long long cap,
                               int feat, int vec, void* stream) {
  const int threads = 256;
  int vec_per_row = feat / vec;
  long long n_items = u * vec_per_row;
  long long blocks = (n_items + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    gather_rows_kernel<4><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        table, rows, out, n_items, vec_per_row, cap);
  } else {
    gather_rows_kernel<1><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        table, rows, out, n_items, vec_per_row, cap);
  }
  return static_cast<int>(cudaGetLastError());
}
