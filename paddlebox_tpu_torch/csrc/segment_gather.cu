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
// Bound on this card: bytes. The kernel reads the ids (and the mask) once,
// the head rows and the src rows (mostly from L1 and L2: about five
// consecutive keys of one segment read the same row) and writes the
// [K, d] output, which dominates: 532 201 x 11 x 4 = 23 MB for a ragged
// batch's real keys. There is no arithmetic but the head row's index.
//
// Design: work per key, store 16 bytes at a time.
// - A warp owns a tile of up to 32 consecutive keys, one a lane; the grid
//   holds the blocks the card runs at once, and each warp walks the tiles
//   with the grid's stride, synchronizing with itself only.
// - Per key, once: the id and the mask, then the offsets of its src row
//   and head row (-1 for none: a zero row, a dropped id or mask 0 reads
//   nothing). The head index is a 32-bit floor division (ids are int32);
//   no 64-bit division by a runtime value.
// - Each lane writes its key's whole row into the warp's shared-memory
//   stage, with up to 16 src loads in flight. The tile's [keys, d] output
//   is one contiguous span of the flat [K, d] block, staged at the same
//   offset mod 16 bytes as its place in `out`; the warp writes it as
//   float4 stores over the flat range. The ragged ends, at most 3 floats
//   each (rows of 44 bytes, a base that is not 16-byte aligned), take
//   scalar stores.
// - While the stores drain, each lane loads its key of the warp's next
//   tile (id and mask) into registers.
// - Index math is 32-bit where K * d, n * ld and B * H stay below 2^31,
//   64-bit (the same kernel, another instance) above.
// Rows wider than a warp's stage (d > 509 floats) take a plain branch: a
// block a key, coalesced scalar stores straight to `out`. Exact: a pure
// copy.
//
// A first design gave a block of 256 threads a tile of 256 keys behind
// two block barriers, filled one float a thread over the flat span: 33%
// of the byte bound (PERF.md §6).

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpStage = 512;   // floats of output a warp's tile stages
constexpr int kUnroll = 16;       // src loads in flight a lane
// blocks an SM holds: caps the registers at 51 a thread (unbounded, the
// kernel takes ~96 and runs 2 blocks an SM; 5 measured faster than 2 and 6)
constexpr int kMinBlocks = 5;

struct Args {
  const float* src;
  const int* ids;
  const float* head;
  const float* mask;
  float* out;
  long long ld, k, n;
  int w, n_head, ets, num_slots, batch_size;
};

// The key's src row offset (id * ld) and head row offset (ins * H), -1
// where the row reads nothing.
template <typename Idx>
__device__ __forceinline__ void key_rows(const Args& a, int id, float m,
                                         Idx& soff, Idx& hoff) {
  const bool in_range = id >= 0 && id < a.n;
  const bool live = (in_range || (a.head != nullptr && id < 0)) && m != 0.f;
  soff = live && in_range ? static_cast<Idx>(id) * static_cast<Idx>(a.ld)
                          : Idx(-1);
  hoff = Idx(-1);
  if (live && a.head != nullptr) {
    int ins = id / a.num_slots;                        // toward zero
    if (id < 0 && ins * a.num_slots != id) --ins;      // floor
    if (ins > a.batch_size - 1) ins = a.batch_size - 1;
    if (ins < 0) ins += a.batch_size;  // from the end, then clamp
    if (ins < 0) ins = 0;
    hoff = static_cast<Idx>(ins) * a.n_head;
  }
}

template <typename Idx>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
segment_gather_kernel(Args a, int tk, Idx ntiles, int p) {
  __shared__ __align__(16) float stage_all[kWarps][kWarpStage];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int d = a.n_head + a.ets + a.w;
  const int c_src = a.n_head + a.ets;   // the first src column
  const Idx k = static_cast<Idx>(a.k);
  const Idx step = static_cast<Idx>(gridDim.x) * kWarps;

  Idx t = static_cast<Idx>(blockIdx.x) * kWarps + warp;
  int id = 0;
  float m = 1.f;
  if (t < ntiles && lane < tk && t * tk + lane < k) {
    id = __ldg(a.ids + t * tk + lane);
    if (a.mask != nullptr) m = __ldg(a.mask + t * tk + lane);
  }
  for (; t < ntiles; t += step) {
    const Idx kbase = t * tk;
    const int keys = static_cast<int>(k - kbase < tk ? k - kbase : tk);
    const Idx g0 = kbase * d;
    // the tile's floats sit at the same offset mod 4 as in out
    float* st = stage_all[warp] + static_cast<int>((p + g0) & 3);
    if (lane < keys) {   // the lane's key: its whole row, into st
      Idx soff, hoff;
      key_rows<Idx>(a, id, m, soff, hoff);
      float* row = st + lane * d;
      for (int c = 0; c < a.n_head; ++c) {
        row[c] = hoff >= 0 ? __ldg(a.head + hoff + c) : 0.f;
      }
      for (int c = a.n_head; c < c_src; ++c) row[c] = 0.f;
      for (int c0 = 0; c0 < a.w; c0 += kUnroll) {
        float v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          v[u] = soff >= 0 && c0 + u < a.w ? __ldg(a.src + soff + c0 + u)
                                           : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (c0 + u < a.w) row[c_src + c0 + u] = v[u];
        }
      }
    }
    __syncwarp();   // the tile is staged
    const Idx next = t + step;
    if (next < ntiles && lane < tk && next * tk + lane < k) {
      id = __ldg(a.ids + next * tk + lane);
      if (a.mask != nullptr) m = __ldg(a.mask + next * tk + lane);
    }
    // floats [g0, g1) of out: scalars up to the first 16-byte boundary
    // (va) and after the last (vb), float4 between
    const Idx g1 = g0 + static_cast<Idx>(keys) * d;
    Idx va = ((p + g0 + 3) & ~Idx(3)) - p;
    Idx vb = ((p + g1) & ~Idx(3)) - p;
    if (va > g1) va = g1;
    if (vb < va) vb = va;
    const int n_lo = static_cast<int>(va - g0);
    const int n_hi = static_cast<int>(g1 - vb);
    if (lane < n_lo) {
      a.out[g0 + lane] = st[lane];
    } else if (lane >= 4 && lane < 4 + n_hi) {
      const int f = static_cast<int>(vb - g0) + lane - 4;
      a.out[g0 + f] = st[f];
    }
    const int nvec = static_cast<int>((vb - va) >> 2);
    const float4* sv = reinterpret_cast<const float4*>(st + n_lo);
    float4* ov = reinterpret_cast<float4*>(a.out + va);
    for (int i = lane; i < nvec; i += 32) ov[i] = sv[i];
    __syncwarp();   // the stage has been read
  }
}

// Rows wider than a tile's staging: a block a key, straight stores.
__global__ void __launch_bounds__(kThreads)
segment_gather_wide(Args a) {
  const int d = a.n_head + a.ets + a.w;
  const int c_src = a.n_head + a.ets;
  for (long long key = blockIdx.x; key < a.k; key += gridDim.x) {
    long long soff, hoff;
    key_rows<long long>(a, __ldg(a.ids + key),
                        a.mask != nullptr ? __ldg(a.mask + key) : 1.f, soff,
                        hoff);
    float* row = a.out + key * d;
    for (int c = threadIdx.x; c < d; c += kThreads) {
      float v = 0.f;
      if (c < a.n_head) {
        if (hoff >= 0) v = __ldg(a.head + hoff + c);
      } else if (c >= c_src && soff >= 0) {
        v = __ldg(a.src + soff + (c - c_src));
      }
      row[c] = v;
    }
  }
}

// Blocks of `kernel` the card runs at once; 0 and the error in *rc when a
// query fails.
template <typename Kernel>
unsigned resident_blocks(Kernel kernel, int* rc) {
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
  return e == cudaSuccess ? static_cast<unsigned>(sms * per_sm) : 0;
}

template <typename Idx>
int launch_tiles(const Args& a, int d, cudaStream_t s) {
  static int rc = 0;
  static const unsigned resident =
      resident_blocks(segment_gather_kernel<Idx>, &rc);
  if (rc != 0) return rc;
  const int tk = (kWarpStage - 3) / d < 32 ? (kWarpStage - 3) / d : 32;
  const long long ntiles = (a.k + tk - 1) / tk;
  const int p = static_cast<int>((reinterpret_cast<uintptr_t>(a.out) >> 2) &
                                 3);
  const long long need = (ntiles + kWarps - 1) / kWarps;
  const unsigned blocks = static_cast<unsigned>(
      need < resident ? need : resident);
  segment_gather_kernel<Idx><<<blocks, kThreads, 0, s>>>(
      a, tk, static_cast<Idx>(ntiles), p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src [n, ld] f32 (the first w columns are gathered), ids [k] i32,
// out [k, n_head + ets + w] f32 (4-byte aligned; any 16-byte offset);
// head [batch_size, n_head] f32 and mask [k] f32 may be null (n_head = 0
// without head); num_slots, batch_size >= 1. All on the device. One
// launch; returns its cudaError_t.
extern "C" int pbx_segment_gather(const float* src, long long ld,
                                  const int* ids, const float* head,
                                  const float* mask, float* out, long long k,
                                  long long n, int w, int n_head, int ets,
                                  int num_slots, int batch_size,
                                  void* stream) {
  const long long d = static_cast<long long>(n_head) + ets + w;
  if (k == 0 || d == 0) return 0;
  const Args a{src, ids, head, mask, out, ld, k, n, w, n_head, ets,
               num_slots, batch_size};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d > kWarpStage - 3) {
    const long long blocks = k < (1LL << 20) ? k : (1LL << 20);
    segment_gather_wide<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        a);
    return static_cast<int>(cudaGetLastError());
  }
  const long long lim = INT_MAX - 8;
  if (k * d < lim && n * ld < lim &&
      static_cast<long long>(batch_size) * n_head < lim) {
    return launch_tiles<int>(a, static_cast<int>(d), s);
  }
  return launch_tiles<long long>(a, static_cast<int>(d), s);
}
