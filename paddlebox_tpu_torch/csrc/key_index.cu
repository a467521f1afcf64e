// The device key index: a linear-probe hash table from 64-bit feature ids
// to table rows, in one int32 tensor [nb, 4] of 16-byte buckets (key lo,
// key hi, row, pad; nb a power of two; an unclaimed bucket holds row -1).
// A probe step is one 16-byte load from one 32-byte sector.
//
// Replaces: paddlebox_tpu/ops/pallas_index.py _insert_pallas (insert) and
// _lookup_pallas (lookup). The TPU kernels walk the keys on a SEQUENTIAL
// grid, so a row cursor carried in SMEM hands out first-seen rows and a
// bucket is claimed by a plain read-check-write. Blocks run in parallel and
// in no order here, so the insert is one kernel over tiles of 1024 keys
// that take their ids from an atomic counter (a tile waits only on tiles
// that have started) and do, in order:
//
//   1. probe, read-only: each thread holds 4 keys and issues every key's
//      probe before it uses any result. A key is found (a match), or new:
//      its chain reached a bucket that was empty before the launch. That
//      decision never depends on this launch's claims: the stream is
//      deduped, and an existing key sits before the first bucket that was
//      empty before the launch, so a new key's probe never meets it.
//   2. count the tile's new keys (warp ballots).
//   3. the exclusive count of the tiles before it, by decoupled look-back
//      over a per-tile state word (status | count).
//   4. claim: each new key writes its key and its row next_row + first-seen
//      rank into the first empty bucket from where its probe stopped, with
//      ONE 128-bit atomicCAS of the whole bucket (row -1 -> row); a bucket
//      taken meanwhile is skipped. Then rows, the new-mask and a new key's
//      slot are written.
//
// One write a new key: random sectors written back cost more than random
// sectors read, and a second store to a claimed bucket (the key, then the
// row after the look-back) costs as much again.
//
// The last tile to finish fails the call on a probe overflow (past 64
// buckets, in the probe or the claim) or when next_row + new keys >
// capacity. A rollback kernel then puts every claimed bucket back to -1
// (it exits at once when the call succeeded), so a failed call leaves the
// index as it found it. One memset zeroes the flags and the tile states
// first.
//
// The race. A 16-byte load is not single-copy atomic, so a prober can see
// a row this launch wrote beside stale key bytes (key 0 of a fresh index,
// or a key left under a rolled-back bucket) and must not match them. The
// row of a bucket only moves -1 -> next_row + rank during a launch, and the
// key bytes of a bucket whose row was >= 0 before the launch never change.
// So a prober trusts the key bytes of its load only for 0 <= row <
// next_row (set by an earlier call); for a row >= next_row it compares an
// atomic snapshot of the bucket (the old value of a 128-bit CAS that
// writes back what it read), whose key is the claimant's, never the
// prober's, or an earlier call's. A torn load that shows -1 makes the
// claim's CAS fail and return the bucket as it is (see the claim).
//
// Rows and the new-mask therefore equal the XLA formulation's
// (_insert_xla: parallel claim rounds, rows from a first-seen prefix sum)
// exactly and deterministically; which bucket a key lands in may differ
// from run to run, but every placement leaves the key's probe prefix
// occupied and nothing is deleted, so lookups find every key.
//
// Lookup: each thread holds 4 keys, loaded as coalesced stripes, and keeps
// all their probe chains in flight; a step is one read-only 16-byte load
// (ld.global.nc.v4), then key compare, row and empty test; the chain ends
// at a match, an empty bucket or after 64 steps (a miss gives -1).
//
// Bound on this card: random sectors. Every probe step is a dependent
// random access into a bucket array far larger than L2 (2^24 buckets = 256
// MiB at the training path's capacity): one 32-byte sector a step, and for
// the insert one more written back a new key. Random sectors move far
// below the memory's streaming rate; four chains a thread keep enough of
// them in flight.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kEmpty = -1;
constexpr int kMaxProbe = 64;
constexpr int kBlock = 256;
constexpr int kKeysPerThread = 4;
constexpr int kTile = kBlock * kKeysPerThread;   // keys a tile, stripe-major
constexpr int kWarps = kBlock / 32;
constexpr int kGroups = kKeysPerThread * kWarps; // 32-key groups a tile
constexpr int kRollbackBlocks = 264;
static_assert(kGroups <= 32, "warp 0 scans one 32-key group a lane");

// scratch: kFlagWords int32 flags, then one 64-bit look-back state a tile
constexpr int kTileCounter = 0;   // tile ids handed out
constexpr int kDoneCounter = 1;   // tiles finished
constexpr int kOverflow = 2;      // a probe chain passed kMaxProbe
constexpr int kFailed = 3;        // the call failed; rows are discarded
constexpr int kNewTotal = 4;      // new keys of the call
constexpr int kFlagWords = 8;
// a tile's state: status in the high word, its count in the low word
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;

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

__device__ __forceinline__ unsigned long long pack(int lo, int hi) {
  return (static_cast<unsigned long long>(static_cast<uint32_t>(hi)) << 32)
         | static_cast<uint32_t>(lo);
}

__device__ __forceinline__ long long key_of(int4 b) {
  return static_cast<long long>(pack(b.x, b.y));
}

// the insert's loads go through L2 (coherent with the claims of other
// blocks in this launch); the lookup's through the read-only path
__device__ __forceinline__ int4 load_bucket(const int4* p) {
  return __ldcg(p);
}

__device__ __forceinline__ int4 load_bucket_ro(const int4* p) {
  return __ldg(p);
}

// 128-bit compare-and-swap of a bucket: its value before the operation,
// read atomically with it
__device__ __forceinline__ int4 cas_bucket(int4* p, int4 expect,
                                           int4 desired) {
  unsigned long long lo, hi;
  asm volatile(
      "{\n\t.reg .b128 c, v, d;\n\t"
      "mov.b128 c, {%2, %3};\n\t"
      "mov.b128 v, {%4, %5};\n\t"
      "atom.relaxed.gpu.global.cas.b128 d, [%6], c, v;\n\t"
      "mov.b128 {%0, %1}, d;\n\t}"
      : "=l"(lo), "=l"(hi)
      : "l"(pack(expect.x, expect.y)), "l"(pack(expect.z, expect.w)),
        "l"(pack(desired.x, desired.y)), "l"(pack(desired.z, desired.w)),
        "l"(p)
      : "memory");
  return make_int4(static_cast<int>(lo), static_cast<int>(lo >> 32),
                   static_cast<int>(hi), static_cast<int>(hi >> 32));
}

__device__ __forceinline__ unsigned long long load_state(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.b64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_state(unsigned long long* p,
                                            unsigned long long v) {
  asm volatile("st.release.gpu.global.b64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// Exclusive count of new keys in the tiles before `tile`, by warp 0:
// publish this tile's aggregate, then read 32 predecessors' states at a
// time (each lane spins until its tile has published), sum back to the
// nearest inclusive prefix, and publish this tile's inclusive prefix.
__device__ __forceinline__ long long look_back(
    unsigned long long* state, int tile, uint32_t total, int lane) {
  if (tile == 0) {
    if (lane == 0) store_state(state, kInclusive | total);
    return 0;
  }
  if (lane == 0) store_state(state + tile, kAggregate | total);
  long long excl = 0;
  for (int top = tile - 1;; top -= 32) {
    int p = top - lane;
    unsigned long long s = kInclusive;       // before tile 0: prefix 0
    if (p >= 0) {
      do {
        s = load_state(state + p);
      } while ((s >> 32) == 0);
    }
    unsigned incl = __ballot_sync(0xffffffffu, (s >> 32) == 2);
    int stop = incl ? __ffs(incl) - 1 : 31;
    long long v = lane <= stop ? static_cast<uint32_t>(s) : 0;
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
    excl += v;
    if (incl) break;
  }
  if (lane == 0) {
    store_state(state + tile,
                kInclusive | static_cast<uint32_t>(excl + total));
  }
  return excl;
}

__global__ void __launch_bounds__(kBlock) insert_kernel(
    int4* __restrict__ buckets, uint32_t mask,
    const long long* __restrict__ keys, long long n, long long next_row,
    long long capacity, int* __restrict__ rows, int* __restrict__ is_new,
    int* __restrict__ slot, int* __restrict__ flags,
    unsigned long long* __restrict__ state) {
  __shared__ int s_tile;
  __shared__ int s_count[kGroups];   // new keys of each 32-key group
  __shared__ int s_before[kGroups];  // new keys before each 32-key group
  __shared__ long long s_excl;     // new keys before this tile
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = atomicAdd(flags + kTileCounter, 1);
  __syncthreads();
  const int tile = s_tile;
  const long long first = static_cast<long long>(tile) * kTile
                          + threadIdx.x;

  long long key[kKeysPerThread];
  uint32_t pos[kKeysPerThread];
  int off[kKeysPerThread];
  int4 cur[kKeysPerThread];        // the bucket at pos, as last read
  int row[kKeysPerThread];
  bool live[kKeysPerThread];
  bool fresh[kKeysPerThread];      // new: the probe stopped at an empty
#pragma unroll
  for (int j = 0; j < kKeysPerThread; ++j) {
    long long i = first + j * kBlock;
    live[j] = i < n;
    fresh[j] = false;
    row[j] = -1;
    off[j] = 0;
    cur[j] = make_int4(0, 0, 0, 0);
    if (live[j]) {
      key[j] = __ldg(keys + i);
      pos[j] = hash32(static_cast<unsigned long long>(key[j])) & mask;
      cur[j] = load_bucket(buckets + pos[j]);
    }
  }
  bool overflow = false;

  // 1. probe
  for (int step = 0; step < kMaxProbe; ++step) {
    // a row of this launch is compared in an atomic snapshot
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      if (live[j] && cur[j].z >= next_row) {
        cur[j] = cas_bucket(buckets + pos[j], cur[j], cur[j]);
      }
    }
    bool any = false;
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      if (!live[j]) continue;
      int r = cur[j].z;
      bool end = true;
      if (r == kEmpty) {
        fresh[j] = true;
      } else if (r >= 0 && key_of(cur[j]) == key[j]) {
        row[j] = r;
      } else if (++off[j] == kMaxProbe) {
        overflow = true;
      } else {
        end = false;
      }
      if (end) {
        live[j] = false;
        continue;
      }
      pos[j] = (pos[j] + 1) & mask;
      cur[j] = load_bucket(buckets + pos[j]);
      any = true;
    }
    if (!any) break;
  }

  // 2, 3. first-seen ranks: the tile's keys in stream order are 32-key
  // groups g = j * kWarps + warp, a lane each
  unsigned ballot[kKeysPerThread];
#pragma unroll
  for (int j = 0; j < kKeysPerThread; ++j) {
    ballot[j] = __ballot_sync(0xffffffffu, fresh[j]);
    if (lane == 0) s_count[j * kWarps + warp] = __popc(ballot[j]);
  }
  __syncthreads();
  if (warp == 0) {
    int c = lane < kGroups ? s_count[lane] : 0;
    int x = c;
    for (int d = 1; d < 32; d <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane < kGroups) s_before[lane] = x - c;
    uint32_t total = static_cast<uint32_t>(__shfl_sync(0xffffffffu, x, 31));
    long long excl = look_back(state, tile, total, lane);
    if (lane == 0) {
      s_excl = excl;
      atomicAdd(flags + kNewTotal, static_cast<int>(total));
    }
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kKeysPerThread; ++j) {
    if (fresh[j]) {
      row[j] = static_cast<int>(next_row + s_excl
                                + s_before[j * kWarps + warp]
                                + __popc(ballot[j] & below));
    }
  }

  // 4. claim: key and row in one CAS, every claim in flight before any
  // result is used. The CAS leaves the bucket's old value in cur, and the
  // row stays -1 there only when it succeeded: within a launch the key
  // bytes under a -1 row never change, so a load that showed -1 showed
  // the whole bucket as the CAS expects it, or the bucket was taken.
  bool claim[kKeysPerThread];
  bool placed[kKeysPerThread];
#pragma unroll
  for (int j = 0; j < kKeysPerThread; ++j) {
    claim[j] = fresh[j];
    placed[j] = false;
  }
  for (int step = 0; step < kMaxProbe; ++step) {
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      if (claim[j] && cur[j].z == kEmpty) {
        cur[j] = cas_bucket(
            buckets + pos[j], cur[j],
            make_int4(static_cast<int>(key[j]),
                      static_cast<int>(key[j] >> 32), row[j], cur[j].w));
      }
    }
    bool any = false;
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      if (!claim[j]) continue;
      if (cur[j].z == kEmpty) {
        claim[j] = false;
        placed[j] = true;            // at pos[j]
        continue;
      }
      if (++off[j] == kMaxProbe) {
        overflow = true;
        claim[j] = false;
        continue;
      }
      pos[j] = (pos[j] + 1) & mask;
      cur[j] = load_bucket(buckets + pos[j]);
      any = true;
    }
    if (!any) break;
  }
  if (overflow) atomicOr(flags + kOverflow, 1);

#pragma unroll
  for (int j = 0; j < kKeysPerThread; ++j) {
    long long i = first + j * kBlock;
    if (i >= n) continue;
    rows[i] = row[j];
    is_new[i] = fresh[j] ? 1 : 0;
    if (fresh[j]) slot[i] = placed[j] ? static_cast<int>(pos[j]) : -1;
  }

  // the last tile to finish decides the call
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(flags + kDoneCounter, 1)
        == static_cast<int>(gridDim.x) - 1) {
      __threadfence();
      int ovf = atomicOr(flags + kOverflow, 0);
      long long total = atomicAdd(flags + kNewTotal, 0);
      flags[kFailed] = (ovf != 0 || next_row + total > capacity) ? 1 : 0;
    }
  }
}

// after a failed insert: every bucket claimed by it back to EMPTY (its key
// bytes stay, under a row that is never compared)
__global__ void rollback_kernel(int4* __restrict__ buckets,
                                const int* __restrict__ is_new,
                                const int* __restrict__ slot, long long n,
                                const int* __restrict__ flags) {
  if (flags[kFailed] == 0) return;
  for (long long i = static_cast<long long>(blockIdx.x) * kBlock
                     + threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * kBlock) {
    if (is_new[i] && slot[i] >= 0) buckets[slot[i]].z = kEmpty;
  }
}

__global__ void __launch_bounds__(kBlock) lookup_kernel(
    const int4* __restrict__ buckets, uint32_t mask,
    const long long* __restrict__ keys, long long k, int* __restrict__ rows) {
  const long long first = static_cast<long long>(blockIdx.x) * kTile
                          + threadIdx.x;
  long long key[kKeysPerThread];
  uint32_t pos[kKeysPerThread];
  int off[kKeysPerThread];
  int4 cur[kKeysPerThread];
  int row[kKeysPerThread];
  bool live[kKeysPerThread];
#pragma unroll
  for (int j = 0; j < kKeysPerThread; ++j) {
    long long i = first + j * kBlock;
    live[j] = i < k;
    row[j] = -1;
    off[j] = 0;
    if (live[j]) {
      key[j] = __ldg(keys + i);
      pos[j] = hash32(static_cast<unsigned long long>(key[j])) & mask;
      cur[j] = load_bucket_ro(buckets + pos[j]);
    }
  }
  for (int step = 0; step < kMaxProbe; ++step) {
    bool any = false;
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      if (!live[j]) continue;
      int r = cur[j].z;
      if (r >= 0 && key_of(cur[j]) == key[j]) row[j] = r;
      if (r == kEmpty || row[j] >= 0 || ++off[j] == kMaxProbe) {
        live[j] = false;
        continue;
      }
      pos[j] = (pos[j] + 1) & mask;
      cur[j] = load_bucket_ro(buckets + pos[j]);
      any = true;
    }
    if (!any) break;
  }
#pragma unroll
  for (int j = 0; j < kKeysPerThread; ++j) {
    long long i = first + j * kBlock;
    if (i < k) rows[i] = row[j];
  }
}

}  // namespace

// Insert the deduped, first-seen-ordered key stream keys [n] int64 into the
// buckets [nb, 4] int32 (in place; 16-byte aligned). Outputs: rows [n] i32
// (a new key's row is next_row + its first-seen rank), is_new [n] i32 0/1.
// Scratch: slot [n] i32 (for new keys only: the claimed bucket, -1 where
// none was claimed), scratch [8 + 2 *
// ceil(n / 1024)] i32, zeroed here: flags, then the tiles' look-back
// states; scratch[3] is 1 when the call failed (probe overflow, or
// next_row + new keys > capacity), and a failed call leaves the buckets as
// it found them. Returns the cudaError_t of the launches.
extern "C" int pbx_index_insert(void* buckets, long long nb,
                                const long long* keys, long long n,
                                long long next_row, long long capacity,
                                int* rows, int* is_new, int* slot,
                                int* scratch, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long tiles = (n + kTile - 1) / kTile;
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, (kFlagWords + 2 * tiles) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int4* b = static_cast<int4*>(buckets);
  insert_kernel<<<static_cast<unsigned>(tiles), kBlock, 0, s>>>(
      b, static_cast<uint32_t>(nb - 1), keys, n, next_row, capacity, rows,
      is_new, slot, scratch,
      reinterpret_cast<unsigned long long*>(scratch + kFlagWords));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = (n + kBlock - 1) / kBlock;
  rollback_kernel<<<static_cast<unsigned>(
                        blocks < kRollbackBlocks ? blocks : kRollbackBlocks),
                    kBlock, 0, s>>>(b, is_new, slot, n, scratch);
  return static_cast<int>(cudaGetLastError());
}

// Probe rows for keys [k] int64 in the buckets [nb, 4] int32: rows [k] i32,
// -1 for a miss. Returns the cudaError_t of the launch.
extern "C" int pbx_index_lookup(const void* buckets, long long nb,
                                const long long* keys, long long k,
                                int* rows, void* stream) {
  if (k == 0) return 0;
  long long blocks = (k + kTile - 1) / kTile;
  lookup_kernel<<<static_cast<unsigned>(blocks), kBlock, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(buckets), static_cast<uint32_t>(nb - 1), keys,
      k, rows);
  return static_cast<int>(cudaGetLastError());
}
