// Per-slot batched fully-connected layer:
//
//   out[s, n, o] = sum_i x[s, n, i] * w[s, i, o] + bias[s, o]
//
// or, in transpose mode, with w [S, O, I] read as w[s, o, i] (by index: no
// transposed copy is made). x may have any strides (the PV path passes the
// pooled [B, S, D] block as its [S, B, D] swapaxes view); w, bias and out are
// contiguous.
//
// Replaces: paddlebox_tpu/ops/pallas_ctr.py _batch_fc_forward (one slot's
// weight block resident in VMEM per grid column, TN-row input blocks
// streamed through the MXU, the bias added before the output block leaves
// VMEM; transpose mode through dot_general dimension numbers).
//
// Bound on this card: bytes. On the PV path S = 8, N = 4096, I = O = 11:
// 2 * I * O = 242 operations per output row against 88 bytes of input and
// 44 of output, far below the card's operations-per-byte balance. Design:
// one thread per output element, so a warp's stores are 32 consecutive
// floats; the threads of one (s, n) row read the same x values (served from
// L1) and the slot's small weight block stays in L1/L2. The sum is a float32
// FMA chain in i order, and the bias is added last, as the TPU kernel does.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__global__ void batch_fc_kernel(const float* __restrict__ x, long long xs0,
                                long long xs1, long long xs2,
                                const float* __restrict__ w,
                                const float* __restrict__ bias,
                                float* __restrict__ out, int s, long long n,
                                int in_dim, int out_dim, int transpose) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long total = static_cast<long long>(s) * n * out_dim;
  if (i >= total) return;
  int o = static_cast<int>(i % out_dim);
  long long rest = i / out_dim;
  long long row = rest % n;
  int sl = static_cast<int>(rest / n);
  const float* xr = x + sl * xs0 + row * xs1;
  const float* ws = w + static_cast<long long>(sl) * in_dim * out_dim;
  float acc = 0.0f;
  if (transpose) {
    const float* wr = ws + static_cast<long long>(o) * in_dim;
    for (int j = 0; j < in_dim; ++j)
      acc = fmaf(__ldg(xr + j * xs2), __ldg(wr + j), acc);
  } else {
    for (int j = 0; j < in_dim; ++j)
      acc = fmaf(__ldg(xr + j * xs2),
                 __ldg(ws + static_cast<long long>(j) * out_dim + o), acc);
  }
  out[i] = acc + __ldg(bias + static_cast<long long>(sl) * out_dim + o);
}

}  // namespace

// x [s, n, in_dim] f32 with element strides (xs0, xs1, xs2); w [s, in_dim,
// out_dim] f32, or [s, out_dim, in_dim] when transpose != 0; bias [s,
// out_dim]; out [s, n, out_dim] f32 contiguous. All on the device. Returns
// the cudaError_t of the launch.
extern "C" int pbx_batch_fc(const float* x, long long xs0, long long xs1,
                            long long xs2, const float* w, const float* bias,
                            float* out, int s, long long n, int in_dim,
                            int out_dim, int transpose, void* stream) {
  const int threads = 256;
  long long items = static_cast<long long>(s) * n * out_dim;
  if (items <= 0) return 0;
  long long blocks = (items + threads - 1) / threads;
  batch_fc_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      x, xs0, xs1, xs2, w, bias, out, s, n, in_dim, out_dim, transpose);
  return static_cast<int>(cudaGetLastError());
}
