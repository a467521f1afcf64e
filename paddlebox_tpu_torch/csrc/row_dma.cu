// Row copies by one bulk asynchronous copy per row, between a table
// [cap + 1, d] and a dense block [k, d]:
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
// sectors: each copy moves few bytes, so the limit is how many copies are
// in flight. Design, the Hopper counterpart of "one DMA per row, 16 in
// flight": each warp owns a ring of 16 row slots in shared memory with one
// mbarrier each. One elected lane takes 16 consecutive rows at a time,
// issues a cp.async.bulk global->shared copy per row (completion counted
// in bytes on the slot's mbarrier), then, as each slot's barrier
// completes, a cp.async.bulk shared->global copy of the slot to the row's
// destination; before the ring is reused it waits until those stores have
// read shared memory. The copy engine computes no addresses per element
// and the threads spend no registers on the data. A bulk copy needs its
// size and both addresses to be multiples of 16 bytes; rows that are not
// (d % 4 != 0, a misaligned base) or wider than 512 bytes take the
// ordinary-load branch of the same kernel: one warp per row, a float per
// lane. The id is clamped before an address is formed. Exact: a copy.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kRing = 16;   // row copies in flight per warp (_NSEM)
constexpr int kWarps = 4;   // warps per block

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(unsigned bar, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait for a slot's copy; a copy that never completes (a fault of this
// kernel) ends the launch with an error after ~10 s instead of hanging.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - start > (1LL << 34)) __trap();
  }
}

__device__ __forceinline__ void bulk_load(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, unsigned src,
                                           unsigned bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
          dst),
      "r"(src), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ long long row_of(const int* __restrict__ rows,
                                            long long i, long long cap) {
  long long r = __ldg(rows + i);
  return (r < 0 || r > cap) ? cap : r;
}

template <bool kScatter>
__global__ void row_dma_kernel(float* table, const int* __restrict__ rows,
                               float* io, long long k, long long cap, int d,
                               int bulk) {
  extern __shared__ __align__(128) unsigned char ring_all[];
  __shared__ __align__(8) unsigned long long bars[kWarps][kRing];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long gwarp = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const long long n_warps = static_cast<long long>(gridDim.x) * kWarps;

  if (!bulk) {  // ordinary loads and stores: one warp per row
    for (long long i = gwarp; i < k; i += n_warps) {
      const long long r = row_of(rows, i, cap);
      const float* src = kScatter ? io + i * d : table + r * d;
      float* dst = kScatter ? table + r * d : io + i * d;
      for (int c = lane; c < d; c += 32) dst[c] = src[c];
    }
    return;
  }
  if (lane != 0) return;  // one elected lane drives the warp's ring
  const unsigned bytes = static_cast<unsigned>(d) * 4u;
  const unsigned ring = smem_addr(ring_all) + warp * kRing * bytes;
  const unsigned bar0 = smem_addr(&bars[warp][0]);
  for (int i = 0; i < kRing; ++i) mbar_init(bar0 + 8 * i, 1);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  unsigned parity = 0;  // bit i: the phase slot i's barrier completes next
  const long long n_chunks = (k + kRing - 1) / kRing;
  for (long long chunk = gwarp; chunk < n_chunks; chunk += n_warps) {
    const long long base = chunk * kRing;
    const int m = static_cast<int>(k - base < kRing ? k - base : kRing);
    for (int i = 0; i < m; ++i) {
      const long long row = base + i;
      const float* src =
          kScatter ? io + row * d : table + row_of(rows, row, cap) * d;
      mbar_expect_tx(bar0 + 8 * i, bytes);
      bulk_load(ring + i * bytes, src, bytes, bar0 + 8 * i);
    }
    for (int i = 0; i < m; ++i) {
      const long long row = base + i;
      mbar_wait(bar0 + 8 * i, (parity >> i) & 1u);
      parity ^= 1u << i;
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      float* dst =
          kScatter ? table + row_of(rows, row, cap) * d : io + row * d;
      bulk_store(dst, ring + i * bytes, bytes);
    }
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    // the stores must have read the ring before the next chunk refills it
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

int launch(bool scatter, float* table, const int* rows, float* io,
           long long k, long long cap, int d, int bulk, void* stream) {
  const long long n_chunks = (k + kRing - 1) / kRing;
  long long blocks = bulk ? (n_chunks + kWarps - 1) / kWarps
                          : (k + kWarps - 1) / kWarps;
  if (blocks > 132 * 8) blocks = 132 * 8;  // a few waves; warps loop
  const size_t smem = bulk ? static_cast<size_t>(kWarps) * kRing * d * 4 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scatter) {
    row_dma_kernel<true><<<static_cast<unsigned>(blocks), 32 * kWarps, smem,
                           s>>>(table, rows, io, k, cap, d, bulk);
  } else {
    row_dma_kernel<false><<<static_cast<unsigned>(blocks), 32 * kWarps, smem,
                            s>>>(table, rows, io, k, cap, d, bulk);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table [cap+1, d] f32, rows [k] i32, out [k, d] f32, all on the device;
// k >= 1. bulk = 1 needs d % 4 == 0, d <= 128 and 16-byte aligned table
// and out. Returns the cudaError_t of the launch.
extern "C" int pbx_gather_rows_dma(const float* table, const int* rows,
                                   float* out, long long k, long long cap,
                                   int d, int bulk, void* stream) {
  return launch(false, const_cast<float*>(table), rows, out, k, cap, d, bulk,
                stream);
}

// table [cap+1, d] f32 written in place, rows [k] i32, values [k, d] f32,
// all on the device; k >= 1; bulk as above. Returns the cudaError_t of the
// launch.
extern "C" int pbx_scatter_rows_dma(float* table, const int* rows,
                                    const float* values, long long k,
                                    long long cap, int d, int bulk,
                                    void* stream) {
  return launch(true, table, rows, const_cast<float*>(values), k, cap, d,
                bulk, stream);
}
