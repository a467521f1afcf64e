// Row copies between a table [cap + 1, d] and a dense block [k, d], with
// many rows in flight on every lane:
//
//   gather:  out[i, :]        = table[r(i), :]
//   scatter: table[r(i), :]   = values[i, :]      (in place)
//
// where r(i) = rows[i] for 0 <= rows[i] <= cap and the sentinel row cap
// otherwise. In-bounds scatter rows are duplicate-free; the out-of-bounds
// pads all write the sentinel row, whose content is then racy.
//
// Replaces: paddlebox_tpu/ops/pallas_kernels.py gather_rows_dma and
// scatter_rows_dma (_dma_body: a scalar loop issues one HBM->HBM DMA per
// row with 16 in flight on a ring of DMA semaphores, over grid blocks of
// 2048 rows). Both are interpret-only references in the JAX package and
// have no consumer there or in the port.
//
// Bound on this card: bytes. A row of 16 floats is 64 bytes, two 32-byte
// sectors, and the rows of the table side land all over a table far
// larger than L2, so the limit is how many row copies are in flight. A
// bulk copy engine is built for tiles, not 64-byte rows (one elected lane
// issuing one cp.async.bulk a row was 2.4-2.8x slower than 16-byte vector
// loads); here every lane moves data. A row is v = d / 4 16-byte vectors;
// a warp lays 32 / v rows side by side, one vector a lane, as a slot, and
// a chunk is 4 slots. Each lane loads the chunk's ids with one coalesced
// load a 32 rows, and takes its rows' ids from the owning lanes by
// __shfl_sync; the id is clamped before an address is formed. The lane
// copies its 4 vectors by 16-byte cp.async into its own slots of a
// two-chunk shared-memory ring, committed as one group, and stores the
// previous chunk once that chunk's group has landed (wait_group 1): two
// chunks, 8 vectors, fly a lane. Each lane reads back only its own slots,
// so no lane waits on another. (A register pipeline, 8 independent
// 16-byte loads a lane then their 8 stores, ran ~9% slower on the path's
// scatter and tied on its gather: PERF.md §6.)
// Rows that are not 16-byte vectors (d % 4 != 0, a misaligned base) or
// wider than a warp's slot (d > 128) take ordinary loads: one warp per
// row, a float per lane. Every launch is a grid of the blocks the card
// runs at once, walking the rows or chunks with the grid's stride. Exact:
// a copy.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;  // measured a little faster than 256
constexpr int kRingRows = 4;   // vectors a lane copies a chunk

__device__ __forceinline__ long long row_of(int r, long long cap) {
  return (r < 0 || r > cap) ? cap : r;
}

// The lane's R items of the chunk at `base` (R slots of rps rows each):
// for slot r, row i[r] = base + r * rps + sub of the dense block and its
// table row t[r] (-1 past k or on an idle lane).
template <int R>
__device__ __forceinline__ void chunk_items(const int* __restrict__ rows,
                                            long long base, long long k,
                                            long long cap, int rps, int sub,
                                            bool active, long long (&i)[R],
                                            long long (&t)[R]) {
  const int lane = threadIdx.x & 31;
  const int span = R * rps;   // rows of the chunk
  int ids[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const long long at = base + 32 * j + lane;
    ids[j] = 32 * j < span && at < k ? __ldg(rows + at) : 0;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int q = r * rps + sub;
    int id = 0;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (32 * j < span) {   // the same on every lane
        const int got = __shfl_sync(0xffffffffu, ids[j], q & 31);
        if ((q >> 5) == j) id = got;
      }
    }
    i[r] = base + q;
    t[r] = active && i[r] < k ? row_of(id, cap) : -1;
  }
}

struct Lanes {   // a lane's place in a slot
  int rps, sub, vec;
  bool active;
  __device__ explicit Lanes(int v) {
    const int lane = threadIdx.x & 31;
    rps = 32 / v;
    sub = lane / v;
    vec = lane - sub * v;
    active = sub < rps;
  }
};

template <bool kScatter>
__global__ void __launch_bounds__(kThreads)
rows_ordinary(float* table, const int* __restrict__ rows, float* io,
              long long k, long long cap, int d) {
  const int lane = threadIdx.x & 31;
  const long long n_warps = static_cast<long long>(gridDim.x) * kThreads / 32;
  for (long long i = (static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x) / 32;
       i < k; i += n_warps) {
    const long long r = row_of(__ldg(rows + i), cap);
    const float* src = kScatter ? io + i * d : table + r * d;
    float* dst = kScatter ? table + r * d : io + i * d;
    for (int c = lane; c < d; c += 32) dst[c] = src[c];
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

template <bool kScatter>
__global__ void __launch_bounds__(kThreads)
rows_vec(float* table, const int* __restrict__ rows, float* io,
         long long k, long long cap, int v) {
  constexpr int R = kRingRows;
  __shared__ __align__(16) float4 ring[2][R][kThreads];   // 16 KB
  const Lanes ln(v);
  const long long span = static_cast<long long>(R) * ln.rps;
  const long long n_chunks = (k + span - 1) / span;
  const long long n_warps = static_cast<long long>(gridDim.x) * kThreads / 32;
  float4* tab = reinterpret_cast<float4*>(table);
  float4* blk = reinterpret_cast<float4*>(io);
  long long pi[R], pt[R];   // the chunk in flight before this one
  // the stores of that chunk, from ring buffer b, once it has landed
  auto store = [&](int b) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (pt[r] >= 0) {
        *(kScatter ? tab + pt[r] * v + ln.vec : blk + pi[r] * v + ln.vec) =
            ring[b][r][threadIdx.x];
      }
    }
  };
  int s = 0;
  bool have = false;
  for (long long c = (static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x) / 32;
       c < n_chunks; c += n_warps) {
    long long i[R], t[R];
    chunk_items<R>(rows, c * span, k, cap, ln.rps, ln.sub, ln.active, i, t);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (t[r] >= 0) {
        cp_async16(&ring[s][r][threadIdx.x],
                   kScatter ? blk + i[r] * v + ln.vec
                            : tab + t[r] * v + ln.vec);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (have) {
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      store(s ^ 1);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      pi[r] = i[r];
      pt[r] = t[r];
    }
    have = true;
    s ^= 1;
  }
  if (have) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    store(s ^ 1);
  }
}

// Blocks of `kernel` the card runs at once; 0 and the error in *rc when a
// query fails.
template <typename Kernel>
long long resident_blocks(Kernel kernel, int* rc) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  }
  *rc = static_cast<int>(e);
  return e == cudaSuccess ? static_cast<long long>(sms) * per_sm : 0;
}

template <bool kScatter>
int run(float* table, const int* rows, float* io, long long k,
        long long cap, int d, int vec, void* stream) {
  static int rc[2] = {0, 0};
  static const long long resident[2] = {
      resident_blocks(rows_ordinary<kScatter>, &rc[0]),
      resident_blocks(rows_vec<kScatter>, &rc[1])};
  vec = vec != 0;
  if (rc[vec] != 0) return rc[vec];
  const int warps = kThreads / 32;
  // a warp a row, or a warp a chunk of kRingRows slots of 32 / v rows
  const long long span = vec ? static_cast<long long>(kRingRows) *
                                   (32 / (d / 4))
                             : 1;
  const long long need = ((k + span - 1) / span + warps - 1) / warps;
  const unsigned g = static_cast<unsigned>(
      need < resident[vec] ? need : resident[vec]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    rows_vec<kScatter><<<g, kThreads, 0, s>>>(table, rows, io, k, cap,
                                               d / 4);
  } else {
    rows_ordinary<kScatter><<<g, kThreads, 0, s>>>(table, rows, io, k, cap,
                                                    d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table [cap+1, d] f32, rows [k] i32, out [k, d] f32, all on the device;
// k >= 1. vec = 0: ordinary loads, any d; vec = 1: 16-byte vectors, needs
// d % 4 == 0, d <= 128 and 16-byte aligned table and out. Returns the
// cudaError_t of the launch.
extern "C" int pbx_gather_rows_dma(const float* table, const int* rows,
                                   float* out, long long k, long long cap,
                                   int d, int vec, void* stream) {
  return run<false>(const_cast<float*>(table), rows, out, k, cap, d, vec,
                    stream);
}

// table [cap+1, d] f32 written in place, rows [k] i32, values [k, d] f32,
// all on the device; k >= 1; vec as above. Returns the cudaError_t of
// the launch.
extern "C" int pbx_scatter_rows_dma(float* table, const int* rows,
                                    const float* values, long long k,
                                    long long cap, int d, int vec,
                                    void* stream) {
  return run<true>(table, rows, const_cast<float*>(values), k, cap, d, vec,
                   stream);
}
