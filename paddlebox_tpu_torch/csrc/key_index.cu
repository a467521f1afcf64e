// The device key index: a linear-probe hash table from 64-bit feature ids
// to table rows, over two bucket arrays in device memory (keys int64 [nb],
// rows int32 [nb]; nb a power of two; an unclaimed bucket holds row -1).
//
// Replaces: paddlebox_tpu/ops/pallas_index.py _insert_pallas (insert) and
// _lookup_pallas (lookup). The TPU kernels walk the keys on a SEQUENTIAL
// grid, so a row cursor carried in SMEM hands out first-seen rows and a
// bucket is claimed by a plain read-check-write. Blocks run in parallel and
// in no order here, so the insert is three launches instead:
//
//   1. probe: one thread per key probes from hash32(key) & (nb - 1) for at
//      most 64 buckets. An empty bucket is claimed with atomicCAS on its
//      row word (-1 -> CLAIMED), then the key is written. A prober that
//      meets a CLAIMED bucket skips it WITHOUT comparing keys: the stream
//      is deduped, so a key claimed in this call never equals the prober's,
//      and the claimant's key bytes may not be visible yet. A row >= 0 was
//      written by an earlier call and its key is safe to compare. Each
//      block counts its new keys (__syncthreads_count).
//   2. scan: one block turns the per-block counts into exclusive offsets
//      and decides the call: it fails on a probe overflow or when
//      next_row + new keys > capacity.
//   3. finalize: a block-local ballot scan gives each new key its
//      first-seen rank; on success the claimed bucket gets row
//      next_row + rank, on failure it goes back to -1, so a failed call
//      leaves the index as it found it (stale key bytes under -1 are never
//      compared).
//
// Rows and the new-mask therefore equal the XLA formulation's
// (_insert_xla: parallel claim rounds, rows from a first-seen prefix sum)
// exactly; which bucket a key lands in may differ from run to run, but
// every placement leaves the key's probe prefix occupied and nothing is
// deleted, so lookups find every key.
//
// Lookup: one thread per key, the same probe, read-only, ending at a match
// or an empty bucket; a miss gives -1.
//
// Bound on this card: bytes, and latency. Every probe step is a dependent
// random access into bucket arrays far larger than L2 (2^24 buckets = 192
// MiB at the training path's capacity): one 32-byte sector of each array
// per step. The hash is ten integer operations per key. A thread per key
// keeps as many probes in flight as the card holds threads; warp-
// cooperative probing and a bucket layout with key and row in one sector
// are later work.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kEmpty = -1;
constexpr int kClaimed = -2;
constexpr int kMaxProbe = 64;
constexpr int kBlock = 256;
constexpr int kScanThreads = 1024;

// bit for bit paddlebox_tpu/ops/pallas_index.py _hash32 over the key's
// (hi, lo) 32-bit halves
__device__ __forceinline__ uint32_t hash32(unsigned long long key) {
  uint32_t lo = static_cast<uint32_t>(key);
  uint32_t hi = static_cast<uint32_t>(key >> 32);
  uint32_t h = lo * 0x9E3779B1u + hi * 0x85EBCA77u;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  return h ^ (h >> 16);
}

__global__ void probe_claim_kernel(long long* __restrict__ bkeys,
                                   int* __restrict__ brows, uint32_t mask,
                                   const long long* __restrict__ keys,
                                   long long n, int* __restrict__ rows,
                                   int* __restrict__ is_new,
                                   int* __restrict__ slot,
                                   int* __restrict__ block_count,
                                   int* __restrict__ flags) {
  long long i = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  int won = 0;
  if (i < n) {
    long long key = __ldg(keys + i);
    uint32_t h = hash32(static_cast<unsigned long long>(key));
    int row = -1;
    int claimed = -1;
    bool done = false;
    for (int off = 0; off < kMaxProbe; ++off) {
      uint32_t b = (h + static_cast<uint32_t>(off)) & mask;
      // a stale EMPTY read only costs a failed CAS: during this launch a
      // row word moves from EMPTY to CLAIMED and nowhere else
      int r = brows[b];
      if (r == kEmpty) {
        r = atomicCAS(brows + b, kEmpty, kClaimed);
        if (r == kEmpty) {
          bkeys[b] = key;
          claimed = static_cast<int>(b);
          won = 1;
          done = true;
          break;
        }
      }
      if (r >= 0 && bkeys[b] == key) {
        row = r;
        done = true;
        break;
      }
    }
    if (!done) atomicOr(flags, 1);   // probe overflow
    rows[i] = row;
    is_new[i] = won;
    slot[i] = claimed;
  }
  int count = __syncthreads_count(won);
  if (threadIdx.x == 0) block_count[blockIdx.x] = count;
}

// block_count [nblocks] -> exclusive offsets, in one block; flags[1] = new
// keys, flags[2] = 1 when the call fails (probe or capacity overflow)
__global__ void scan_blocks_kernel(int* __restrict__ block_count,
                                   int nblocks, long long next_row,
                                   long long capacity,
                                   int* __restrict__ flags) {
  __shared__ int warp_sums[kScanThreads / 32];
  __shared__ int carry;
  int lane = threadIdx.x & 31;
  int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < nblocks; base += kScanThreads) {
    int idx = base + threadIdx.x;
    int v = idx < nblocks ? block_count[idx] : 0;
    int x = v;
    for (int d = 1; d < 32; d <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sums[lane];
      for (int d = 1; d < 32; d <<= 1) {
        int y = __shfl_up_sync(0xffffffffu, w, d);
        if (lane >= d) w += y;
      }
      warp_sums[lane] = w;
    }
    __syncthreads();
    int excl = carry + (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
    if (idx < nblocks) block_count[idx] = excl;
    __syncthreads();
    if (threadIdx.x == kScanThreads - 1) carry = excl + v;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    flags[1] = carry;
    flags[2] = (flags[0] != 0 || next_row + carry > capacity) ? 1 : 0;
  }
}

__global__ void finalize_kernel(int* __restrict__ brows,
                                const int* __restrict__ block_offset,
                                long long n, long long next_row,
                                int* __restrict__ rows,
                                const int* __restrict__ is_new,
                                const int* __restrict__ slot,
                                const int* __restrict__ flags) {
  __shared__ int warp_count[kBlock / 32];
  long long i = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  int nw = i < n ? is_new[i] : 0;
  int lane = threadIdx.x & 31;
  int warp = threadIdx.x >> 5;
  unsigned ballot = __ballot_sync(0xffffffffu, nw);
  if (lane == 0) warp_count[warp] = __popc(ballot);
  __syncthreads();
  if (!nw) return;
  int before = __popc(ballot & ((1u << lane) - 1u));
  for (int w = 0; w < warp; ++w) before += warp_count[w];
  int row = static_cast<int>(next_row + block_offset[blockIdx.x] + before);
  rows[i] = row;
  brows[slot[i]] = flags[2] ? kEmpty : row;
}

__global__ void lookup_kernel(const long long* __restrict__ bkeys,
                              const int* __restrict__ brows, uint32_t mask,
                              const long long* __restrict__ keys,
                              long long k, int* __restrict__ rows) {
  long long i = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= k) return;
  long long key = __ldg(keys + i);
  uint32_t h = hash32(static_cast<unsigned long long>(key));
  int row = -1;
  for (int off = 0; off < kMaxProbe; ++off) {
    uint32_t b = (h + static_cast<uint32_t>(off)) & mask;
    int r = __ldg(brows + b);
    if (r == kEmpty) break;
    if (r >= 0 && __ldg(bkeys + b) == key) {
      row = r;
      break;
    }
  }
  rows[i] = row;
}

}  // namespace

// Insert the deduped, first-seen-ordered key stream keys [n] int64 into the
// bucket arrays bkeys [nb] int64 / brows [nb] int32 (in place). Outputs:
// rows [n] i32 (a new key's row is next_row + its first-seen rank), is_new
// [n] i32 0/1. Scratch: slot [n] i32, block_count [ceil(n / 256)] i32.
// flags [3] i32, zeroed by the caller: [probe overflow, new keys, call
// failed]; a failed call leaves the bucket arrays as it found them.
// Returns the cudaError_t of the launches.
extern "C" int pbx_index_insert(long long* bkeys, int* brows, long long nb,
                                const long long* keys, long long n,
                                long long next_row, long long capacity,
                                int* rows, int* is_new, int* slot,
                                int* block_count, int* flags, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long blocks = (n + kBlock - 1) / kBlock;
  uint32_t mask = static_cast<uint32_t>(nb - 1);
  probe_claim_kernel<<<static_cast<unsigned>(blocks), kBlock, 0, s>>>(
      bkeys, brows, mask, keys, n, rows, is_new, slot, block_count, flags);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_blocks_kernel<<<1, kScanThreads, 0, s>>>(
      block_count, static_cast<int>(blocks), next_row, capacity, flags);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finalize_kernel<<<static_cast<unsigned>(blocks), kBlock, 0, s>>>(
      brows, block_count, n, next_row, rows, is_new, slot, flags);
  return static_cast<int>(cudaGetLastError());
}

// Probe rows for keys [k] int64: rows [k] i32, -1 for a miss. Returns the
// cudaError_t of the launch.
extern "C" int pbx_index_lookup(const long long* bkeys, const int* brows,
                                long long nb, const long long* keys,
                                long long k, int* rows, void* stream) {
  if (k == 0) return 0;
  long long blocks = (k + kBlock - 1) / kBlock;
  lookup_kernel<<<static_cast<unsigned>(blocks), kBlock, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      bkeys, brows, static_cast<uint32_t>(nb - 1), keys, k, rows);
  return static_cast<int>(cudaGetLastError());
}
