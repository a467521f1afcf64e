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
// reads 4 MB and writes 6.3 MB with ~5 operations per output element: 3.1 us
// at 3.35 TB/s. What keeps the simple form (a warp per (row, field), scalar
// loads and stores) from it: too little in flight (4 dependent trips of
// 4-byte loads a lane), mean/scale read again for every row (six loads an
// element: more L1/L2 traffic than the whole DRAM traffic), and output rows
// of 1540 bytes that start off 16 bytes, stored a float at a time.
//
// Design: the tile kernel takes R consecutive rows (R a multiple of 4, so a
// tile's input span, R * 2nd floats, and its output span, R * n(3d+1)
// floats, start on 16 bytes whatever n and d are) with all their fields:
//   1. every thread issues 16-byte cp.async copies of the tile's contiguous
//      input span into shared memory; while they fly, the block stages
//      mean/scale of every field in shared memory with coalesced loads,
//      once a block;
//   2. a warp takes a (row, field) of the tile, lanes stride the d columns
//      of shared memory (conflict-free), and writes [a, b, a*b, a.b] into a
//      shared-memory output tile;
//   3. the block stores the tile's output span as float4s.
// A ragged last tile's spans may end off 16 bytes: their last floats go by
// ordinary loads and stores. Moving a tile by two TMA bulk copies instead
// (one thread issues cp.async.bulk of the input span, completing on an
// mbarrier, and of the output span) measured slower on the card at every
// R and was dropped (PERF.md §6 keeps its numbers).
// The rows kernel takes what the tile kernel cannot: an x or out base off
// 16 bytes (a contiguous view at an odd offset), or a tile too wide for
// shared memory. It stages mean/scale once a block where they fit (else
// reads them from global memory), and a warp takes four rows of a field at
// once, so eight loads fly a lane.
// Every column but the dot is bit-identical to the plain version: each
// product, difference and scaling is rounded on its own (__fmul_rn /
// __fsub_rn keep the compiler from contracting them into FMAs). The dot is
// summed as rounded values (__fadd_rn) in one fixed order in both kernels
// (lane partials over c = lane, lane + 32, ..., then a butterfly), so the
// two kernels and two calls give the same bits.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// R, the rows of a tile: a multiple of 4 (ops/ctr_kernels.CROSS_NORM_ROWS
// mirrors it; PERF.md §6 has the sweep that chose it)
constexpr int kTileRows = 8;
static_assert(kTileRows % 4 == 0, "tile spans must start on 16 bytes");
constexpr int kQuad = 4;                   // rows a warp of the rows kernel
// dynamic shared memory a block may take: the card's 227 KB a block
// (ops/ctr_kernels.CROSS_NORM_SMEM mirrors it)
constexpr long long kSmemBudget = 227 * 1024;
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float norm(float v, float m, float s) {
  return __fmul_rn(__fsub_rn(v, m), s);
}

// The sum of a warp's lane partials, the same in every lane.
__device__ __forceinline__ float warp_sum(float p) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, off));
  return p;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One (row, field) from shared memory: a [2, d] at `in`, the field's
// mean/scale at m/s, its 3d+1 outputs to `o`.
__device__ __forceinline__ void field_from_smem(const float* in,
                                                const float* m,
                                                const float* s, float* o,
                                                int d, int lane) {
  float dot = 0.0f;
  for (int c = lane; c < d; c += 32) {
    const float av = in[c], bv = in[d + c];
    const float h = __fmul_rn(av, bv);
    dot = __fadd_rn(dot, h);
    o[c] = norm(av, m[c], s[c]);
    o[d + c] = norm(bv, m[d + c], s[d + c]);
    o[2 * d + c] = norm(h, m[2 * d + c], s[2 * d + c]);
  }
  dot = warp_sum(dot);
  if (lane == 0) o[3 * d] = norm(dot, m[3 * d], s[3 * d]);
}

// A block per tile of kTileRows rows. Shared memory: the input tile [R,
// 2nd], the output tile [R, n(3d+1)], mean and scale [n(3d+1)] each.
__global__ void __launch_bounds__(kThreads)
cross_norm_tile_kernel(const float* __restrict__ x,
                       const float* __restrict__ mean,
                       const float* __restrict__ scale,
                       float* __restrict__ out, long long b, int n, int d) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31;
  const int w = 3 * d + 1, in_row = 2 * n * d, out_row = n * w;
  const long long row0 = static_cast<long long>(blockIdx.x) * kTileRows;
  const int here =
      static_cast<int>(b - row0 < kTileRows ? b - row0 : kTileRows);
  float* s_in = smem;
  float* s_out = s_in + kTileRows * in_row;
  float* s_mean = s_out + kTileRows * out_row;
  float* s_scale = s_mean + out_row;
  const float* g_in = x + row0 * in_row;
  float* g_out = out + row0 * out_row;
  const int in_floats = here * in_row, in_vec = in_floats & ~3;
  const int out_floats = here * out_row, out_vec = out_floats & ~3;

  for (int i = tid * 4; i < in_vec; i += kThreads * 4)
    cp_async16(s_in + i, g_in + i);
  for (int i = in_vec + tid; i < in_floats; i += kThreads)
    s_in[i] = __ldg(g_in + i);
  for (int i = tid; i < out_row; i += kThreads) {
    s_mean[i] = __ldg(mean + i);
    s_scale[i] = __ldg(scale + i);
  }
  cp_async_wait_all();
  __syncthreads();

  // row r, field f is pair p = r * n + f: its input at p * 2d, output at p * w
  for (int p = tid >> 5; p < here * n; p += kWarps) {
    const int f = p % n;
    field_from_smem(s_in + p * 2 * d, s_mean + f * w, s_scale + f * w,
                    s_out + p * w, d, lane);
  }

  __syncthreads();
  for (int i = tid * 4; i < out_vec; i += kThreads * 4)
    *reinterpret_cast<float4*>(g_out + i) =
        *reinterpret_cast<const float4*>(s_out + i);
  for (int i = out_vec + tid; i < out_floats; i += kThreads)
    g_out[i] = s_out[i];
}

// A warp per (four rows, field), grid-stride; mean/scale staged in shared
// memory when `staged`, else read where they lie.
__global__ void __launch_bounds__(kThreads)
cross_norm_rows_kernel(const float* __restrict__ x,
                       const float* __restrict__ mean,
                       const float* __restrict__ scale,
                       float* __restrict__ out, long long b, int n, int d,
                       int staged) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int w = 3 * d + 1;
  const long long in_row = 2LL * n * d, out_row = static_cast<long long>(n) * w;
  const float* m_all = mean;
  const float* s_all = scale;
  if (staged) {
    for (long long i = threadIdx.x; i < out_row; i += kThreads) {
      smem[i] = __ldg(mean + i);
      smem[out_row + i] = __ldg(scale + i);
    }
    __syncthreads();
    m_all = smem;
    s_all = smem + out_row;
  }
  const long long items = (b + kQuad - 1) / kQuad * n;
  for (long long it = static_cast<long long>(blockIdx.x) * kWarps +
                      (threadIdx.x >> 5);
       it < items; it += static_cast<long long>(gridDim.x) * kWarps) {
    const long long q = it / n;
    const int f = static_cast<int>(it - q * n);
    const long long r0 = q * kQuad;
    const int nr = static_cast<int>(b - r0 < kQuad ? b - r0 : kQuad);
    const float* a = x + r0 * in_row + 2LL * f * d;
    float* o = out + r0 * out_row + static_cast<long long>(f) * w;
    const float* m = m_all + static_cast<long long>(f) * w;
    const float* s = s_all + static_cast<long long>(f) * w;
    float dot[kQuad] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int c = lane; c < d; c += 32) {
      float av[kQuad] = {}, bv[kQuad] = {};
#pragma unroll
      for (int u = 0; u < kQuad; ++u) {
        if (u < nr) {
          av[u] = __ldg(a + u * in_row + c);
          bv[u] = __ldg(a + u * in_row + d + c);
        }
      }
      const float ma = m[c], sa = s[c], mb = m[d + c], sb = s[d + c];
      const float mh = m[2 * d + c], sh = s[2 * d + c];
#pragma unroll
      for (int u = 0; u < kQuad; ++u) {
        if (u < nr) {
          const float h = __fmul_rn(av[u], bv[u]);
          dot[u] = __fadd_rn(dot[u], h);
          float* ou = o + u * out_row;
          ou[c] = norm(av[u], ma, sa);
          ou[d + c] = norm(bv[u], mb, sb);
          ou[2 * d + c] = norm(h, mh, sh);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kQuad; ++u) {
      const float t = warp_sum(dot[u]);
      if (lane == 0 && u < nr)
        o[u * out_row + 3 * d] = norm(t, m[3 * d], s[3 * d]);
    }
  }
}

// A tile kernel block's dynamic shared memory
// (ops/ctr_kernels.cross_norm_branch counts it the same way).
long long tile_bytes(int n, int d) {
  const long long out_row = static_cast<long long>(n) * (3 * d + 1);
  return 4 * (kTileRows * (2LL * n * d + out_row) + 2 * out_row);
}

// Allow `kernel` `bytes` of dynamic shared memory (the default is 48 KB).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, long long bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

}  // namespace

// x [b, 2*n*d] f32, mean/scale [n*(3d+1)] f32, out [b, n*(3d+1)] f32, all
// contiguous on the device. `path` 0 picks the kernel as the wrapper's
// helper does (ops/ctr_kernels.cross_norm_branch): the tile kernel where x
// and out start on 16 bytes and a tile fits shared memory, else the rows
// kernel; 1 forces the tile kernel (an error where it cannot run), 2 the
// rows kernel. One launch; returns its cudaError_t.
extern "C" int pbx_cross_norm_path(const float* x, const float* mean,
                                   const float* scale, float* out,
                                   long long b, int n, int d, int path,
                                   void* stream) {
  if (b <= 0 || n <= 0) return 0;
  if (d < 0 || path < 0 || path > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long smem = tile_bytes(n, d);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const bool tile = aligned && smem <= kSmemBudget;
  if (path == 0) path = tile ? 1 : 2;
  if (path == 1) {
    if (!tile) return static_cast<int>(cudaErrorInvalidValue);
    const unsigned grid =
        static_cast<unsigned>((b + kTileRows - 1) / kTileRows);
    cudaError_t err = allow_smem(cross_norm_tile_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cross_norm_tile_kernel<<<grid, kThreads, static_cast<size_t>(smem), st>>>(
        x, mean, scale, out, b, n, d);
    return static_cast<int>(cudaGetLastError());
  }
  const long long ms_bytes = 8LL * n * (3 * d + 1);
  const int staged = ms_bytes <= kSmemBudget;
  const long long items = (b + kQuad - 1) / kQuad * n;
  long long grid = (items + kWarps - 1) / kWarps;
  const long long most = 8LL * sm_count();    // 8 blocks of 256 fill an SM
  if (grid > most) grid = most;
  const long long bytes = staged ? ms_bytes : 0;
  cudaError_t err = allow_smem(cross_norm_rows_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cross_norm_rows_kernel<<<static_cast<unsigned>(grid), kThreads,
                           static_cast<size_t>(bytes), st>>>(
      x, mean, scale, out, b, n, d, staged);
  return static_cast<int>(cudaGetLastError());
}

// The kernel picked as path 0 does.
extern "C" int pbx_cross_norm(const float* x, const float* mean,
                              const float* scale, float* out, long long b,
                              int n, int d, void* stream) {
  return pbx_cross_norm_path(x, mean, scale, out, b, n, d, 0, stream);
}
