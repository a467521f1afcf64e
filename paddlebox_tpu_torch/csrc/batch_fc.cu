// Per-slot batched fully-connected layer:
//
//   out[s, n, o] = sum_i x[s, n, i] * w[s, i, o] + bias[s, o]
//
// or, in transpose mode, with w [S, O, I] read as w[s, o, i] (by index: no
// transposed copy is made). x may have any strides (the PV path passes the
// pooled [B, S, D] block as its [S, B, D] swapaxes view, strides (11, 88,
// 1)); w, bias and out are contiguous.
//
// Replaces: paddlebox_tpu/ops/pallas_ctr.py:248 _batch_fc_forward (one
// slot's weight block resident in VMEM per grid column, TN-row input blocks
// streamed through the MXU, the bias added before the output block leaves
// VMEM; transpose mode through dot_general dimension numbers).
//
// Bound on this card: bytes. On the PV path S = 8, N = 4096, I = O = 11:
// 2 * I * O = 242 operations per output row against 88 bytes of input and
// 44 of output, far below the card's operations-per-byte balance; 2.9 MB
// move in all (0.86 us), so most of a call is the launch's own floor.
//
// Design: a block per (128-row tile, slot), the TPU kernel's grid. The
// block stages the slot's weight block ([I, O], or [O, I] in transpose
// mode, read by index) and its bias in shared memory once, and the tile's
// x rows once, coalesced over the flat (row, i) range, through the
// strides the wrapper passes; every staging copy is a cp.async, so all of
// them are in flight at once (a load-then-store loop waits on each). Each thread then computes its row's outputs
// from registers (16 at a time), every thread of a warp reading the same
// weight (a broadcast). The tile's output is one contiguous span of
// [S, N, O]: it is staged in shared memory at its offset mod 16 bytes and
// stored as float4 with scalar ends. Offsets inside a block are 32-bit and
// no output float costs a division. The sum is a float32 FMA chain in i
// order with the bias added last, as the TPU kernel does.
// Shapes whose staging passes 48 KB of shared memory (I * O beyond ~10 000
// floats) take a second kernel: a thread an output float, 32-bit index
// math where the sizes allow it.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kRows = 128;         // rows a tile, a thread a row
constexpr int kThreads = kRows;
constexpr int kOutChunk = 16;      // outputs a thread holds at once
constexpr int kSmemFloats = 48 * 1024 / 4;
constexpr int kElemThreads = 256;

struct Args {
  const float* x;
  long long xs0, xs1, xs2;
  const float* w;
  const float* bias;
  float* out;
  int s, n, in_dim, out_dim, transpose;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// floats of shared memory a tile needs: w, bias, x rows, 16-byte pad, out
int tile_floats(int in_dim, int out_dim) {
  const long long f = static_cast<long long>(in_dim) * out_dim + out_dim +
                      static_cast<long long>(kRows) * in_dim + 4 +
                      static_cast<long long>(kRows) * out_dim + 3;
  return f > INT_MAX ? INT_MAX : static_cast<int>(f);
}

__global__ void __launch_bounds__(kThreads)
batch_fc_tile_kernel(Args a, int p) {
  extern __shared__ __align__(16) float smem[];
  const int in_dim = a.in_dim, out_dim = a.out_dim;
  const int io = in_dim * out_dim;
  float* s_w = smem;
  float* s_b = s_w + io;
  float* s_x = s_b + out_dim;
  float* s_o = smem + ((io + out_dim + kRows * in_dim + 3) & ~3);   // 16 B
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int rows = a.n - row0 < kRows ? a.n - row0 : kRows;
  const int xs1 = static_cast<int>(a.xs1), xs2 = static_cast<int>(a.xs2);
  for (int sl = blockIdx.y; sl < a.s; sl += gridDim.y) {
    // weights, bias and the tile's x rows into shared memory, every copy
    // in flight at once
    const float* ws = a.w + static_cast<long long>(sl) * io;
    for (int e = tid; e < io; e += kThreads) cp_async4(s_w + e, ws + e);
    const float* bs = a.bias + static_cast<long long>(sl) * out_dim;
    for (int e = tid; e < out_dim; e += kThreads) cp_async4(s_b + e, bs + e);
    const float* xt = a.x + sl * a.xs0 + row0 * a.xs1;
    for (int e = tid; e < rows * in_dim; e += kThreads) {
      const int r = e / in_dim, i = e - r * in_dim;
      cp_async4(s_x + e, xt + r * xs1 + i * xs2);
    }
    // the tile's span [g0, g1) of out, staged at its offset mod 4 floats
    const long long g0 =
        (static_cast<long long>(sl) * a.n + row0) * out_dim;
    float* st = s_o + static_cast<int>((p + g0) & 3);
    cp_async_wait_all();
    __syncthreads();
    if (tid < rows) {
      const float* xr = s_x + tid * in_dim;
      float* orow = st + tid * out_dim;
      for (int o0 = 0; o0 < out_dim; o0 += kOutChunk) {
        float acc[kOutChunk];
#pragma unroll
        for (int j = 0; j < kOutChunk; ++j) acc[j] = 0.f;
        for (int i = 0; i < in_dim; ++i) {
          const float xv = xr[i];
#pragma unroll
          for (int j = 0; j < kOutChunk; ++j) {
            if (o0 + j < out_dim) {
              const float wv = a.transpose ? s_w[(o0 + j) * in_dim + i]
                                           : s_w[i * out_dim + o0 + j];
              acc[j] = fmaf(xv, wv, acc[j]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kOutChunk; ++j) {
          if (o0 + j < out_dim) orow[o0 + j] = acc[j] + s_b[o0 + j];
        }
      }
    }
    __syncthreads();
    // scalars before the first 16-byte boundary of out (lo of them) and
    // after the last (from hi), float4 between
    const int len = rows * out_dim;
    int lo = static_cast<int>((4 - ((p + g0) & 3)) & 3);
    if (lo > len) lo = len;
    const int nvec = (len - lo) >> 2;
    const int hi = lo + 4 * nvec;
    float* og = a.out + g0;
    if (tid < lo) og[tid] = st[tid];
    if (tid >= 4 && tid < 4 + (len - hi)) {
      og[hi + tid - 4] = st[hi + tid - 4];
    }
    const float4* sv = reinterpret_cast<const float4*>(st + lo);
    float4* ov = reinterpret_cast<float4*>(og + lo);
    for (int v = tid; v < nvec; v += kThreads) ov[v] = sv[v];
    __syncthreads();   // the stage is reused by the next slot
  }
}

// A thread an output float: weight blocks too large for the tile's
// shared memory. Idx is int where every offset fits, else long long.
template <typename Idx>
__global__ void __launch_bounds__(kElemThreads)
batch_fc_elem_kernel(Args a) {
  const Idx e = static_cast<Idx>(blockIdx.x) * kElemThreads + threadIdx.x;
  const Idx per_slot = static_cast<Idx>(a.n) * a.out_dim;
  if (e >= per_slot) return;
  const Idx row = e / a.out_dim;
  const int o = static_cast<int>(e - row * a.out_dim);
  const Idx xs1 = static_cast<Idx>(a.xs1), xs2 = static_cast<Idx>(a.xs2);
  const Idx io = static_cast<Idx>(a.in_dim) * a.out_dim;
  for (int sl = blockIdx.y; sl < a.s; sl += gridDim.y) {
    const float* xr = a.x + sl * a.xs0 + row * xs1;
    const float* ws = a.w + static_cast<long long>(sl) * io;
    float acc = 0.0f;
    if (a.transpose) {
      const float* wr = ws + static_cast<Idx>(o) * a.in_dim;
      for (int j = 0; j < a.in_dim; ++j) {
        acc = fmaf(__ldg(xr + j * xs2), __ldg(wr + j), acc);
      }
    } else {
      for (int j = 0; j < a.in_dim; ++j) {
        acc = fmaf(__ldg(xr + j * xs2),
                   __ldg(ws + static_cast<Idx>(j) * a.out_dim + o), acc);
      }
    }
    a.out[static_cast<long long>(sl) * per_slot + e] =
        acc + __ldg(a.bias + static_cast<long long>(sl) * a.out_dim + o);
  }
}

unsigned slot_grid(int s) {
  return static_cast<unsigned>(s < 65535 ? s : 65535);
}

}  // namespace

// x [s, n, in_dim] f32 with element strides (xs0, xs1, xs2) >= 0; w [s,
// in_dim, out_dim] f32, or [s, out_dim, in_dim] when transpose != 0; bias
// [s, out_dim]; out [s, n, out_dim] f32 contiguous (4-byte aligned). All on
// the device. `path` 0 picks the kernel by size, 1 forces the tile kernel
// (an error where it does not fit), 2 the per-element kernel. One launch;
// returns its cudaError_t.
extern "C" int pbx_batch_fc_path(const float* x, long long xs0,
                                 long long xs1, long long xs2,
                                 const float* w, const float* bias,
                                 float* out, int s, long long n, int in_dim,
                                 int out_dim, int transpose, int path,
                                 void* stream) {
  if (s <= 0 || n <= 0 || out_dim <= 0) return 0;
  if (in_dim < 0 || n > INT_MAX || xs0 < 0 || xs1 < 0 || xs2 < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{x, xs0, xs1, xs2, w, bias, out, s, static_cast<int>(n),
               in_dim, out_dim, transpose};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int floats = tile_floats(in_dim, out_dim);
  // the tile's x offsets (r * xs1 + i * xs2) and span stay 32-bit
  const bool tile_fits =
      floats <= kSmemFloats &&
      static_cast<long long>(kRows) * xs1 + in_dim * xs2 < INT_MAX;
  if (path == 1 && !tile_fits) return static_cast<int>(cudaErrorInvalidValue);
  if (path != 2 && tile_fits) {
    const int p = static_cast<int>((reinterpret_cast<uintptr_t>(out) >> 2) &
                                   3);
    dim3 grid(static_cast<unsigned>((n + kRows - 1) / kRows), slot_grid(s));
    batch_fc_tile_kernel<<<grid, kThreads, floats * sizeof(float), st>>>(a,
                                                                         p);
    return static_cast<int>(cudaGetLastError());
  }
  const long long per_slot = n * out_dim;
  dim3 grid(static_cast<unsigned>((per_slot + kElemThreads - 1) /
                                  kElemThreads),
            slot_grid(s));
  const bool small = per_slot < INT_MAX && n * xs1 < INT_MAX &&
                     static_cast<long long>(in_dim) * xs2 < INT_MAX &&
                     static_cast<long long>(in_dim) * out_dim < INT_MAX;
  if (small) {
    batch_fc_elem_kernel<int><<<grid, kElemThreads, 0, st>>>(a);
  } else {
    batch_fc_elem_kernel<long long><<<grid, kElemThreads, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// The wrapper's entry: the kernel picked by size.
extern "C" int pbx_batch_fc(const float* x, long long xs0, long long xs1,
                            long long xs2, const float* w, const float* bias,
                            float* out, int s, long long n, int in_dim,
                            int out_dim, int transpose, void* stream) {
  return pbx_batch_fc_path(x, xs0, xs1, xs2, w, bias, out, s, n, in_dim,
                           out_dim, transpose, 0, stream);
}
