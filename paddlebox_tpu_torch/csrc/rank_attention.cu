// Rank attention forward: for every instance row n,
//
//   out[n, :] = sum_{k < K} valid(n, k) * X[idx(n, k), :] @ P[blk(n, k)]
//
// decoded from rank_offset [N, cols] (cols >= 1 + 2K) as
// paddlebox_tpu/ops/pallas_ctr.py decode_rank_offset does: own = ro[n, 0] - 1,
// faster = ro[n, 1 + 2k] - 1, idx = clip(ro[n, 2 + 2k], 0, N - 1); the entry
// is valid when own >= 0 and faster >= 0, and then blk = clip(own, 0, K-1) * K
// + clip(faster, 0, K-1). P is [K*K, D, P] f32 (the [K*K*D, P] layout has the
// same bytes). Padding rows (all -1) and invalid entries contribute nothing.
//
// Replaces: paddlebox_tpu/ops/pallas_ctr.py _rank_attention_forward (a Pallas
// kernel holding all K*K param blocks in VMEM and folding the keep mask into
// a one-hot MXU matmul per block, over an X gather done outside by XLA).
//
// Bound on this card: operations. At the PV path's shapes (N = 4096, D = P =
// 128, K = 3) each valid entry costs 2 * D * P = 32k float32 operations on
// 512 bytes of X; the inputs and output are ~4.7 MB. Design: one block of 128
// threads per (row, chunk of 128 output columns), one output column per
// thread, so the ~1 500 live rows of a PV batch give thousands of warps to
// hide the L2 latency of the P reads (a version that staged 8 rows' grouped
// inputs in shared memory and looped over the 9 blocks had a few hundred
// warps and was latency bound). Thread 0 decodes the row's entries and
// orders them by param block (stably, so entries of one block keep their k
// order); a row without a valid entry (the batch's padded tail) writes zeros.
// Each thread then runs down column `col` of P[b] per block b (coalesced
// across the warp), the X row read at the same address by the whole warp.
// Entries that share a block are summed first, the grouped input of the JAX
// composition (einsum nkd,nkb->bnd, then bnd,bdp->np). Accumulation is a
// float32 FMA chain in (b, d) order.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;   // output columns per block
constexpr int kMaxRank = 16;    // K: entries per row

__global__ void __launch_bounds__(kThreads) rank_attention_kernel(
    const float* __restrict__ x, const int* __restrict__ ro,
    const float* __restrict__ param, float* __restrict__ out, int n, int d,
    int p, int k, int ro_cols) {
  __shared__ int s_blk[kMaxRank];
  __shared__ int s_idx[kMaxRank];
  __shared__ int s_count;
  const long long row = blockIdx.x;
  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  if (threadIdx.x == 0) {
    // the row's valid entries, ordered by param block (stable: entries of
    // one block keep their k order)
    const int* o = ro + row * ro_cols;
    const int own = o[0] - 1;
    int count = 0;
    for (int kk = 0; kk < k && own >= 0; ++kk) {
      int faster = o[1 + 2 * kk] - 1;
      if (faster < 0) continue;
      int blk = min(own, k - 1) * k + min(faster, k - 1);
      int idx = min(max(o[2 + 2 * kk], 0), n - 1);
      int j = count++;
      for (; j > 0 && s_blk[j - 1] > blk; --j) {
        s_blk[j] = s_blk[j - 1];
        s_idx[j] = s_idx[j - 1];
      }
      s_blk[j] = blk;
      s_idx[j] = idx;
    }
    s_count = count;
  }
  __syncthreads();
  if (col >= p) return;
  const int count = s_count;
  float acc = 0.0f;
  for (int e = 0; e < count;) {
    const int b = s_blk[e];
    int e2 = e + 1;
    while (e2 < count && s_blk[e2] == b) ++e2;
    const float* pb = param + static_cast<long long>(b) * d * p + col;
    if (e2 == e + 1) {
      const float* xr = x + static_cast<long long>(s_idx[e]) * d;
#pragma unroll 8
      for (int dd = 0; dd < d; ++dd)
        acc = fmaf(__ldg(xr + dd), __ldg(pb + static_cast<long long>(dd) * p),
                   acc);
    } else {
      for (int dd = 0; dd < d; ++dd) {
        float g = 0.0f;
        for (int j = e; j < e2; ++j)
          g += __ldg(x + static_cast<long long>(s_idx[j]) * d + dd);
        acc = fmaf(g, __ldg(pb + static_cast<long long>(dd) * p), acc);
      }
    }
    e = e2;
  }
  out[row * p + col] = acc;
}

}  // namespace

// x [n, d] f32, ro [n, ro_cols] i32, param [k*k, d, p] f32, out [n, p] f32,
// all on the device; 1 <= k <= 16. Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a k the kernel does not take).
extern "C" int pbx_rank_attention(const float* x, const int* ro,
                                  const float* param, float* out, int n,
                                  int d, int p, int k, int ro_cols,
                                  void* stream) {
  if (n <= 0 || p <= 0) return 0;
  if (k < 1 || k > kMaxRank || ro_cols < 1 + 2 * k || d < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 blocks(static_cast<unsigned>(n),
              static_cast<unsigned>((p + kThreads - 1) / kThreads));
  rank_attention_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      x, ro, param, out, n, d, p, k, ro_cols);
  return static_cast<int>(cudaGetLastError());
}
