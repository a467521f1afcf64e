// Cross-norm hadamard forward: x [B, 2*n*d] holds n field pairs (a, b) of d
// floats per row; for each (row, field f) it writes the 3d+1 columns
//
//   out[row, f*(3d+1) + c] = (feat[c] - mean[f*(3d+1) + c]) * scale[...]
//   feat = [a, b, a*b, sum(a*b)]
//
// with mean/scale the data_norm vectors derived from the summary outside.
//
// Replaces: paddlebox_tpu/ops/pallas_ctr.py _cross_norm_forward (one VMEM pass
// per (row block, field) building [a, b, a*b, a.b] and applying the
// normalization before the block leaves VMEM).
//
// Bound on this card: bytes. On the PV path (B = 4096, n = 1, d = 128) it
// reads 4 MB and writes 6.3 MB with ~5 operations per output element.
// Design: one warp per (row, field); lanes stride the d columns, so loads
// and stores of a warp are consecutive floats, and the dot is a warp-shuffle
// reduction of per-lane partial sums written by lane 0. Every column but the
// dot is bit-identical to the plain version: each product, difference and
// scaling is rounded on its own (__fmul_rn / __fsub_rn keep the compiler
// from contracting them into FMAs), and the products are summed as rounded
// values (__fadd_rn), in another order than PyTorch's sum.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__global__ void cross_norm_kernel(const float* __restrict__ x,
                                  const float* __restrict__ mean,
                                  const float* __restrict__ scale,
                                  float* __restrict__ out, long long b, int n,
                                  int d) {
  long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x +
                    threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (warp >= b * n) return;                   // whole warps leave together
  int f = static_cast<int>(warp % n);
  const int w_out = 3 * d + 1;
  const float* a = x + warp * 2LL * d;         // row-major [B, n, 2, d]
  const float* bv = a + d;
  const float* m = mean + static_cast<long long>(f) * w_out;
  const float* sc = scale + static_cast<long long>(f) * w_out;
  float* o = out + warp * static_cast<long long>(w_out);
  float dot = 0.0f;
  for (int c = lane; c < d; c += 32) {
    float av = __ldg(a + c), bb = __ldg(bv + c);
    float h = __fmul_rn(av, bb);
    dot = __fadd_rn(dot, h);
    o[c] = __fmul_rn(__fsub_rn(av, __ldg(m + c)), __ldg(sc + c));
    o[d + c] = __fmul_rn(__fsub_rn(bb, __ldg(m + d + c)), __ldg(sc + d + c));
    o[2 * d + c] =
        __fmul_rn(__fsub_rn(h, __ldg(m + 2 * d + c)), __ldg(sc + 2 * d + c));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    dot = __fadd_rn(dot, __shfl_xor_sync(0xffffffffu, dot, off));
  if (lane == 0)
    o[3 * d] = __fmul_rn(__fsub_rn(dot, __ldg(m + 3 * d)), __ldg(sc + 3 * d));
}

}  // namespace

// x [b, 2*n*d] f32, mean/scale [n*(3d+1)] f32, out [b, n*(3d+1)] f32, all on
// the device. Returns the cudaError_t of the launch.
extern "C" int pbx_cross_norm(const float* x, const float* mean,
                              const float* scale, float* out, long long b,
                              int n, int d, void* stream) {
  const int threads = 256;                     // 8 warps, 8 (row, field)s
  long long warps = b * static_cast<long long>(n);
  if (warps <= 0) return 0;
  long long blocks = (warps * 32 + threads - 1) / threads;
  cross_norm_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(x, mean, scale, out,
                                                           b, n, d);
  return static_cast<int>(cudaGetLastError());
}
