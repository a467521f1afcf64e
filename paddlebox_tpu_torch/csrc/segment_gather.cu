// Segment gather, the seqpool backward: out[k, :] = src[ids[k], :], with
// ids outside [0, n) giving zero rows. In its fused epilogue mode it writes
// the whole per-key grad row of fused_seqpool_cvm instead:
//
//   out[k] = [head[ins(ids[k]), 0:H] | 0 x ets | src[ids[k], 0:w]]
//
// with ins(id) = min(floor(id / S), B-1), read as the JAX package indexes
// (a negative index counts from the end, then clamps to [0, B)). A key
// with a negative id keeps its head row and gets zero embedx columns, as
// in the reference's backward; a row is zero where ids[k] >= n or
// mask[k] == 0. In gather mode every id outside [0, n) gives a zero row.
//
// Replaces: paddlebox_tpu/ops/pallas_kernels.py segment_gather_mxu (a
// transposed one-hot matmul on the MXU over a (key block, source block)
// pair grid), as the pool backward uses it in
// paddlebox_tpu/ops/seqpool_cvm.py _bwd, plus the XLA head/zeros/concat/
// where epilogue around it there. The MXU formulation needs the in-range
// ids nondecreasing so that each key block meets few source blocks; a
// gather on this card needs no such contract and this kernel assumes none.
//
// Bound on this card: bytes. Each output element is one copy (no
// arithmetic). The kernel reads the ids once, the src rows (mostly from
// L2: consecutive keys of one segment read the same row), and writes the
// [K, D] output, which dominates (2^20 x 11 x 4 = 46 MB on the training
// path). Design: one thread per OUTPUT element, so the stores of a warp
// are 32 consecutive floats (fully coalesced) whatever D is; a thread
// reads its key's id (the same id for the D threads of one key, served
// from L1) and then one float of the head, of src or nothing. The id is
// range-checked before any address is formed. Exact: a pure copy.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__global__ void segment_gather_kernel(
    const float* __restrict__ src, long long ld, const int* __restrict__ ids,
    const float* __restrict__ head, const float* __restrict__ mask,
    float* __restrict__ out, long long k, long long n, int w, int n_head,
    int ets, int num_slots, int batch_size) {
  const int d = n_head + ets + w;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                threadIdx.x;
  if (i >= k * d) return;
  long long key = i / d;
  int c = static_cast<int>(i - key * d);
  long long id = __ldg(ids + key);
  float v = 0.0f;
  const bool in_range = id >= 0 && id < n;
  const bool live = (in_range || (head != nullptr && id < 0)) &&
                    (mask == nullptr || __ldg(mask + key) != 0.0f);
  if (live) {
    if (c < n_head) {
      long long ins = id >= 0 ? id / num_slots
                              : -((-id + num_slots - 1) / num_slots);
      if (ins > batch_size - 1) ins = batch_size - 1;
      if (ins < 0) ins += batch_size;  // from the end, then clamp
      if (ins < 0) ins = 0;
      v = __ldg(head + ins * n_head + c);
    } else if (c >= n_head + ets && in_range) {
      v = __ldg(src + id * ld + (c - n_head - ets));
    }
  }
  out[i] = v;
}

}  // namespace

// src [n, ld] f32 (the first w columns are gathered), ids [k] i32,
// out [k, n_head + ets + w] f32; head [batch_size, n_head] f32 and
// mask [k] f32 may be null (n_head = 0 without head). All on the device.
// Returns the cudaError_t of the launch.
extern "C" int pbx_segment_gather(const float* src, long long ld,
                                  const int* ids, const float* head,
                                  const float* mask, float* out, long long k,
                                  long long n, int w, int n_head, int ets,
                                  int num_slots, int batch_size,
                                  void* stream) {
  const int threads = 256;
  long long items = k * static_cast<long long>(n_head + ets + w);
  if (items == 0) return 0;
  long long blocks = (items + threads - 1) / threads;
  segment_gather_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      src, ld, ids, head, mask, out, k, n, w, n_head, ets, num_slots,
      batch_size);
  return static_cast<int>(cudaGetLastError());
}
