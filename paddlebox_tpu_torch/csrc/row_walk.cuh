// The chunk walk shared by the row gather (gather_rows.cu) and the row
// scatter-add (scatter_add_update.cu). A warp takes the rows 32 at a time
// (a chunk) and sees the chunk's 32 packed rows of w units as one flat
// block of 32 w units; lane l takes units l, l + 32, l + 64, ..., and
// Walk steps through where each lies (its row in the chunk and its unit
// in that row) without a division. The grid is the blocks the card holds
// at once, each warp walking the chunks with the grid's stride.

#pragma once

#include <cuda_runtime.h>

namespace rowwalk {

// A lane's walk over a chunk's flat block of 32 rows x w units: unit
// e = lane + 32 j lies in row r = e / w, at unit c = e % w.
struct Walk {
  int r, c, q, m, w;
  __device__ __forceinline__ explicit Walk(int w_) : w(w_) {
    const int lane = threadIdx.x & 31;
    r = lane / w;
    c = lane - r * w;
    q = 32 / w;
    m = 32 - q * w;
  }
  __device__ __forceinline__ void next() {
    c += m;
    r += q;
    if (c >= w) {
      c -= w;
      ++r;
    }
  }
};

// Blocks of `kernel` the card runs at once at `threads` a block; 0 and
// the error in *rc when a query fails.
template <typename Kernel>
long long resident_blocks(Kernel kernel, int threads, int* rc) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, 0);
  }
  *rc = static_cast<int>(e);
  return e == cudaSuccess ? static_cast<long long>(sms) * per_sm : 0;
}

// The grid for u rows: a warp a chunk, at most `resident` blocks.
inline unsigned grid(long long u, int threads, long long resident) {
  const long long need = ((u + 31) / 32 + threads / 32 - 1) / (threads / 32);
  return static_cast<unsigned>(need < resident ? need : resident);
}

}  // namespace rowwalk
