// Rank attention forward: for every instance row n,
//
//   out[n, :] = sum_{k < K} valid(n, k) * X[idx(n, k), :] @ P[blk(n, k)]
//
// decoded from rank_offset [N, cols] (cols >= 1 + 2K) as
// paddlebox_tpu/ops/pallas_ctr.py decode_rank_offset does: own = ro[n, 0] - 1,
// faster = ro[n, 1 + 2k] - 1, idx = clip(ro[n, 2 + 2k], 0, N - 1); the entry
// is valid when own >= 0 and faster >= 0, and then blk = clip(own, 0, K-1) * K
// + clip(faster, 0, K-1). P is [K*K, D, P] f32 (the [K*K*D, P] layout has the
// same bytes). Padding rows (all -1) and invalid entries contribute nothing.
//
// Replaces: paddlebox_tpu/ops/pallas_ctr.py:138 _rank_attention_forward (a
// Pallas kernel holding all K*K param blocks in VMEM and folding the keep
// mask into a one-hot MXU matmul per block, a dense pass over all K*K blocks
// for every 128-row tile, over an X gather done outside by XLA).
//
// Bound on this card: operations, 2 * D * P float32 operations a valid entry
// (1.8 us at the PV path's 3 683 entries, N = 4096, D = P = 128, K = 3); the
// inputs and output are ~4.7 MB. What costs time is reuse and latency, not
// rate: a kernel that walks P once per row pulls a 64 KB block through L2
// for every entry (~240 MB a call for 0.59 MB of unique P), and a PV batch
// has only ~1 350 live rows, so few blocks share the card.
//
// Design: every valid entry of row n uses a block own(n) * K + f, f its
// clipped co-rank, so rows that share an own rank share their K blocks. For
// a tile of such rows the output is one GEMM of depth K * D:
//
//   out[tile] = [G_0 | ... | G_{K-1}] @ [P[own*K + 0]; ...; P[own*K + K-1]]
//
// where G_f[r] is the sum, in k order, of X[idx] over row r's valid entries
// with clipped co-rank f (zero if there is none): the grouped input of the
// JAX composition, restricted to one own rank. One C call, two kernels, no
// host synchronization, no atomics, deterministic:
// 1. rank_buckets: one block does a stable counting sort of the rows by
//    clipped own rank into K buckets plus one for own < 0, a row a thread
//    (warp ballots, warp scans). It writes the row permutation and the K + 2
//    bucket bounds into a scratch tensor the wrapper allocates.
// 2. rank_tiles: the grid is sized from N and K alone (an upper bound on
//    the tiles of all buckets); each block finds its (bucket, tile) from
//    the bounds, surplus blocks exit, and a tile never crosses a bucket
//    edge. A block takes TM = 32
//    permuted rows and TN = 64 output columns; tiles of the own < 0 bucket
//    are 8 times taller and only write zeros. The block decodes its rows'
//    entries (a thread an entry, ballots build each (row, f) entry mask),
//    then its four groups of 128 threads split the depth: group g sums the
//    chunks of 32 depths c = g, g + 4, ... Each chunk's G_f rows (the first
//    entry's x row, the others added in k order after it lands) and P rows
//    stream in by cp.async, the next set of four chunks in flight while one
//    is summed; each thread keeps a 4 x 4 register tile of float32 FMAs.
//    The groups' tiles are added in group order through shared memory and
//    each result row is written once, to its original row index, as float4
//    where aligned.
// Each P tile is read once a row tile, not once a row. A result is four
// float32 FMA chains over the depth, added in a fixed order (no TF32: the
// 132 MFLOP a call do not need tensor cores). One group of 128 threads a
// tile, at one or two blocks an SM, left most of the time to latency; the
// four groups give each SM four times the warps (PERF.md §6).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kMaxRank = 16;        // K: entries per row
constexpr int kBucketThreads = 1024;
constexpr int kBucketCache = 16384; // rows whose buckets stay in smem
constexpr int kThreads = 128;       // tile kernel
constexpr int kDepth = 32;          // depth chunk
constexpr int kStages = 8;          // chunks staged at once
constexpr int kPadTall = 8;         // a zero-only tile: kPadTall x TM rows
constexpr int kGStride = kDepth + 4;   // a G row in smem (bank offset)

__device__ __forceinline__ int own_bucket(const int* ro, int row, int cols,
                                          int k) {
  const int own = __ldg(ro + static_cast<long long>(row) * cols) - 1;
  return own < 0 ? k : (own < k - 1 ? own : k - 1);
}

// row r's bucket from the shared-memory copy (cache != null) or from ro;
// -1 past the last row
__device__ __forceinline__ int bucket_at(const int* ro,
                                         const unsigned char* cache, int r,
                                         int n, int cols, int k) {
  if (r >= n) return -1;
  return cache != nullptr ? static_cast<int>(cache[r])
                          : own_bucket(ro, r, cols, k);
}

// Stable counting sort of the rows by bucket (clipped own rank; K for
// own < 0). perm[offsets[b] .. offsets[b + 1]) holds bucket b's rows in
// row order; offsets has K + 2 entries, offsets[K + 1] = n. One block of
// 32 warps; a round is 1024 rows, a row a thread, and a warp's 32 rows are
// counted by ballots (one per bucket). The buckets of up to kBucketCache
// rows are read once into shared memory, every load in flight together.
// A first pass totals each bucket (their starts); then, kRounds rounds at
// a time, the warps' counts go to shared memory, one warp per bucket
// turns them into offsets by a scan in (round, warp) order, and each row
// lands at its warp's offset plus its rank among the warp's rows of its
// bucket. Three barriers for up to kRounds rounds.
constexpr int kRounds = 8;   // rounds whose warp counts are held at once

__global__ void __launch_bounds__(kBucketThreads)
rank_buckets_kernel(const int* __restrict__ ro, int n, int cols, int k,
                    int* __restrict__ perm, int* __restrict__ offsets) {
  constexpr int kWarps = kBucketThreads / 32;   // 32: a lane per warp
  __shared__ int s_wc[kRounds][kWarps][kMaxRank + 1];
  __shared__ int s_base[kMaxRank + 1];
  __shared__ unsigned char s_bkt[kBucketCache];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nb = k + 1;
  const unsigned char* cache = n <= kBucketCache ? s_bkt : nullptr;
  if (cache != nullptr) {
#pragma unroll 4
    for (int r = tid; r < n; r += kBucketThreads) {
      s_bkt[r] = static_cast<unsigned char>(own_bucket(ro, r, cols, k));
    }
  }
  __syncthreads();

  // bucket totals: lane b of each warp sums bucket b over the warp's rows
  int total = 0;
  for (int row = tid; row - tid < n; row += kBucketThreads) {
    const int b = bucket_at(ro, cache, row, n, cols, k);
    for (int bb = 0; bb < nb; ++bb) {
      const int c = __popc(__ballot_sync(0xffffffffu, b == bb));
      if (lane == bb) total += c;
    }
  }
  if (lane < nb) s_wc[0][warp][lane] = total;
  __syncthreads();
  if (warp == 0) {   // bucket starts: an exclusive scan across lanes
    int t = 0;
    if (lane < nb) {
      for (int w = 0; w < kWarps; ++w) t += s_wc[0][w][lane];
    }
    int incl = t;
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane < nb) {
      s_base[lane] = incl - t;
      offsets[lane] = incl - t;
    }
    if (lane == nb - 1) offsets[nb] = incl;
  }
  __syncthreads();

  for (int first = 0; first < n; first += kRounds * kBucketThreads) {
    const int left = (n - first + kBucketThreads - 1) / kBucketThreads;
    const int rounds = left < kRounds ? left : kRounds;
    // each warp's count of each bucket, per round; the row's rank among
    // its warp's rows of its bucket from that bucket's ballot
    int bkt[kRounds], rank[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      if (r >= rounds) break;
      const int b = bucket_at(ro, cache, first + r * kBucketThreads + tid, n,
                              cols, k);
      unsigned peers = 0u;
      for (int bb = 0; bb < nb; ++bb) {
        const unsigned bal = __ballot_sync(0xffffffffu, b == bb);
        if (b == bb) peers = bal;
        if (lane == bb) s_wc[r][warp][bb] = __popc(bal);
      }
      bkt[r] = b;
      rank[r] = __popc(peers & ((1u << lane) - 1u));
    }
    __syncthreads();
    if (warp < nb) {   // warp bb: bucket bb's offsets in (round, warp) order
      int carry = s_base[warp];
      for (int r = 0; r < rounds; ++r) {
        const int v = s_wc[r][lane][warp];
        int incl = v;
        for (int off = 1; off < 32; off <<= 1) {
          const int u = __shfl_up_sync(0xffffffffu, incl, off);
          if (lane >= off) incl += u;
        }
        s_wc[r][lane][warp] = carry + incl - v;
        carry += __shfl_sync(0xffffffffu, incl, 31);
      }
      if (lane == 0) s_base[warp] = carry;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      if (r >= rounds) break;
      if (bkt[r] >= 0) {
        perm[s_wc[r][warp][bkt[r]] + rank[r]] =
            first + r * kBucketThreads + tid;
      }
    }
    __syncthreads();   // s_wc and s_base are rewritten by the next rounds
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's commit groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait_sets() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct TileArgs {
  const float* x;
  const int* ro;
  const float* param;
  const int* perm;
  const int* offsets;
  float* out;
  int n, d, p, k, cols;
  int vec_x, vec_p, vec_out;   // 16-byte paths allowed
};

// The row's entries with clipped co-rank f, one bit each (k order), and
// the x row of each entry, as the tile's decode left them.
struct Entries {
  const unsigned (*mask)[kMaxRank];
  const int (*idx)[kMaxRank];
};

// Chunk c's P half into one stage: rows d0 .. d0 + 32 of the block
// pblk + f * d * p, columns c0 .. c0 + TN (f = c / nd), zeros past d and
// p. The 128 threads of one group (gt its thread) copy a chunk, by
// cp.async, left uncommitted.
template <int TN>
__device__ __forceinline__ void issue_p(const TileArgs& a, const float* pblk,
                                        int c, int nd, int c0, int gt,
                                        float* sp) {
  constexpr int TX = TN / 4;
  const int f = c / nd, d0 = (c - f * nd) * kDepth;
  const float* src = pblk + (static_cast<long long>(f) * a.d + d0) * a.p;
  if (a.vec_p) {
    for (int v = gt; v < kDepth * TX; v += kThreads) {
      const int j = v / TX, col = (v % TX) * 4;
      const int left = a.p - (c0 + col);
      const bool in = d0 + j < a.d && left > 0;
      cp_async16(sp + j * TN + col,
                 in ? src + static_cast<long long>(j) * a.p + c0 + col
                    : a.param,
                 in ? (left < 4 ? left : 4) * 4 : 0);
    }
  } else {
    for (int v = gt; v < kDepth * TN; v += kThreads) {
      const int j = v / TN, col = v % TN;
      const bool in = d0 + j < a.d && c0 + col < a.p;
      cp_async4(sp + j * TN + col,
                in ? src + static_cast<long long>(j) * a.p + c0 + col
                   : a.param,
                in ? 4 : 0);
    }
  }
}

// Chunk c's G half into one stage: for each tile row r, depths d0 .. d0 +
// 32 of x at its first entry with co-rank f, zeros past d and for a row
// without such an entry; by cp.async, left uncommitted.
template <int TM>
__device__ __forceinline__ void issue_g(const TileArgs& a, const Entries& e,
                                        int c, int nd, int gt, float* sg) {
  const int f = c / nd, d0 = (c - f * nd) * kDepth;
  if (a.vec_x) {   // d % 4 == 0: a 16-byte group is all in or all out
    for (int t = gt; t < TM * (kDepth / 4); t += kThreads) {
      const int r = t / (kDepth / 4), dd = d0 + (t % (kDepth / 4)) * 4;
      const unsigned m = e.mask[r][f];
      const bool in = m != 0u && dd < a.d;
      cp_async16(sg + r * kGStride + dd - d0,
                 in ? a.x + static_cast<long long>(e.idx[r][__ffs(m) - 1]) *
                              a.d + dd
                    : a.x,
                 in ? 16 : 0);
    }
  } else {
    for (int t = gt; t < TM * kDepth; t += kThreads) {
      const int r = t / kDepth, dd = d0 + t % kDepth;
      const unsigned m = e.mask[r][f];
      const bool in = m != 0u && dd < a.d;
      cp_async4(sg + r * kGStride + dd - d0,
                in ? a.x + static_cast<long long>(e.idx[r][__ffs(m) - 1]) *
                             a.d + dd
                   : a.x,
                in ? 4 : 0);
    }
  }
}

// After chunk c landed: where a row has more than one entry with co-rank
// f, add the others to the first, in k order. Each thread touches only
// the groups its own cp.async wrote (the same mapping as issue_g).
template <int TM>
__device__ __forceinline__ void add_repeats(const TileArgs& a,
                                            const Entries& e, int c, int nd,
                                            int gt, float* sg) {
  const int f = c / nd, d0 = (c - f * nd) * kDepth;
  const int per = a.vec_x ? 4 : 1;   // floats a copy
  for (int t = gt; t < TM * kDepth / per; t += kThreads) {
    const int r = t / (kDepth / per), dd = d0 + (t % (kDepth / per)) * per;
    unsigned m = e.mask[r][f];
    m &= m - 1u;                     // the first entry is in place
    if (m == 0u || dd >= a.d) continue;
    float* g = sg + r * kGStride + dd - d0;
    for (; m != 0u; m &= m - 1u) {
      const float* xr =
          a.x + static_cast<long long>(e.idx[r][__ffs(m) - 1]) * a.d + dd;
      for (int i = 0; i < per; ++i) g[i] += __ldg(xr + i);
    }
  }
}

// Shared memory of a tile kernel: kStages chunk stages of G [TM][kGStride]
// and P [kDepth][TN], reused at the end for the groups' partial sums.
template <int TM, int TN, int G>
constexpr int tile_smem_bytes() {
  constexpr int stages = kStages * (TM * kGStride + kDepth * TN);
  constexpr int partial = G * TM * TN;
  return (stages > partial ? stages : partial) *
         static_cast<int>(sizeof(float));
}

// A block of G groups of 128 threads takes TM permuted rows of one bucket
// and TN output columns. Group g sums the depth chunks c = g, g + G, ...
// into its own register tile; the block walks the chunks G at a time (a
// set), the next set's copies in flight while one is summed. The groups'
// tiles are then added in group order: a fixed order, so the result does
// not depend on timing.
template <int TM, int TN, int G>
__global__ void __launch_bounds__(kThreads * G)
rank_tiles_kernel(TileArgs a) {
  constexpr int RN = 4;                  // columns a thread
  constexpr int TX = TN / RN;            // threads across the columns
  constexpr int TY = kThreads / TX;      // threads down the rows
  constexpr int RM = TM / TY;            // rows a thread
  constexpr int KP = 16;                 // entry lanes a row (>= K)
  constexpr int SETS = kStages / G;      // chunk sets staged at once
  static_assert(RM * TY == TM && TX * RN == TN && RM >= 1 && SETS >= 2,
                "tile shape");
  extern __shared__ __align__(16) float smem[];
  float* s_g = smem;                             // [stage][TM][kGStride]
  float* s_p = smem + kStages * TM * kGStride;   // [stage][kDepth][TN]
  __shared__ int s_off[kMaxRank + 2];
  __shared__ int s_row[TM];
  __shared__ int s_idx[TM][kMaxRank];
  __shared__ unsigned s_mask[TM][kMaxRank];

  const int tid = threadIdx.x;
  const int grp = tid / kThreads, gt = tid % kThreads;
  const int k = a.k, d = a.d, p = a.p;
  const int ncol = (p + TN - 1) / TN;
  if (tid < k + 2) s_off[tid] = __ldg(a.offsets + tid);
  __syncthreads();
  // this block's tile: walk the buckets in order (tiles never cross one)
  int bucket = -1, start = 0, rows = 0;
  for (int b = 0, t = blockIdx.x / ncol; b <= k; ++b) {
    const int tall = b < k ? TM : TM * kPadTall;
    const int lo = s_off[b], hi = s_off[b + 1];
    const int nt = (hi - lo + tall - 1) / tall;
    if (t < nt) {
      bucket = b;
      start = lo + t * tall;
      rows = hi - start < tall ? hi - start : tall;
      break;
    }
    t -= nt;
  }
  if (bucket < 0) return;                // a surplus block
  const int lane = tid & 31;
  const int c0 = (blockIdx.x % ncol) * TN;
  if (bucket == k) {                     // rows with own < 0: zeros
    for (int q = tid; q < rows * TX; q += kThreads * G) {
      const int col = c0 + (q % TX) * RN;
      if (col >= p) continue;
      float* o = a.out + static_cast<long long>(__ldg(a.perm + start +
                                                      q / TX)) * p + col;
      if (a.vec_out && col + RN <= p) {
        *reinterpret_cast<float4*>(o) = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        for (int jj = 0; jj < RN && col + jj < p; ++jj) o[jj] = 0.f;
      }
    }
    return;
  }

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
  }
  const int nd = (d + kDepth - 1) / kDepth;
  const int nc = k * nd;
  const int tx = gt % TX, ty = gt / TX;

  if (tid < TM) s_row[tid] = tid < rows ? __ldg(a.perm + start + tid) : -1;
  __syncthreads();

  if (nc > 0) {
    // decode: entry (r, kk) on lane kk of an aligned group of KP lanes, so
    // a ballot per f gives each row its mask of entries with that f
    for (int e0 = 0; e0 < TM * KP; e0 += kThreads * G) {
      const int e = e0 + tid;
      const int r = e / KP, kk = e % KP;
      int f = -1;
      if (r < rows && kk < k) {
        const int* o = a.ro + static_cast<long long>(s_row[r]) * a.cols;
        const int faster = __ldg(o + 1 + 2 * kk) - 1;
        if (faster >= 0) {
          f = faster < k - 1 ? faster : k - 1;
          const int idx = __ldg(o + 2 + 2 * kk);
          s_idx[r][kk] = idx < 0 ? 0 : (idx > a.n - 1 ? a.n - 1 : idx);
        }
      }
      for (int ff = 0; ff < k; ++ff) {
        const unsigned bal = __ballot_sync(0xffffffffu, f == ff);
        if (kk == ff && r < TM) {
          s_mask[r][ff] = (bal >> (lane & ~(KP - 1))) & ((1u << KP) - 1u);
        }
      }
    }
    __syncthreads();

    // own rank = bucket: the K blocks bucket * K + f. Group grp copies
    // chunk set * G + grp into stage (set % SETS) * G + grp.
    const float* pblk = a.param + static_cast<long long>(bucket) * k * d * p;
    const Entries ent{s_mask, s_idx};
    const int nsets = (nc + G - 1) / G;
    auto stage = [&](int set) { return (set % SETS) * G + grp; };
    for (int set = 0; set < SETS - 1; ++set) {
      const int c = set * G + grp;
      if (c < nc) {
        issue_p<TN>(a, pblk, c, nd, c0, gt, s_p + stage(set) * kDepth * TN);
        issue_g<TM>(a, ent, c, nd, gt, s_g + stage(set) * TM * kGStride);
      }
      cp_async_commit();                 // empty past nc: keeps the count
    }
    for (int set = 0; set < nsets; ++set) {
      const int c = set * G + grp;
      float* sg = s_g + stage(set) * TM * kGStride;
      const float* sp = s_p + stage(set) * kDepth * TN;
      cp_async_wait_sets<SETS - 2>();    // this thread's copies of the set
      if (c < nc) add_repeats<TM>(a, ent, c, nd, gt, sg);
      __syncthreads();   // the set is staged; the last set's stages free
      const int cn = (set + SETS - 1) * G + grp;
      if (cn < nc) {
        const int sn = stage(set + SETS - 1);
        issue_p<TN>(a, pblk, cn, nd, c0, gt, s_p + sn * kDepth * TN);
        issue_g<TM>(a, ent, cn, nd, gt, s_g + sn * TM * kGStride);
      }
      cp_async_commit();
      if (c >= nc) continue;
#pragma unroll 2
      for (int j = 0; j < kDepth; j += 4) {
        float4 av[RM], bv[4];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          av[i] = *reinterpret_cast<const float4*>(
              sg + (ty * RM + i) * kGStride + j);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          bv[jj] = *reinterpret_cast<const float4*>(sp + (j + jj) * TN +
                                                    tx * RN);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            const float g = jj == 0 ? av[i].x : jj == 1 ? av[i].y
                          : jj == 2 ? av[i].z : av[i].w;
            acc[i][0] = fmaf(g, bv[jj].x, acc[i][0]);
            acc[i][1] = fmaf(g, bv[jj].y, acc[i][1]);
            acc[i][2] = fmaf(g, bv[jj].z, acc[i][2]);
            acc[i][3] = fmaf(g, bv[jj].w, acc[i][3]);
          }
        }
      }
    }
  }

  // the groups' tiles into shared memory (the stages are free once every
  // group is past its last chunk), then added in group order
  __syncthreads();
  float* part = smem;                    // [G][TM][TN]
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    *reinterpret_cast<float4*>(part + (grp * TM + ty * RM + i) * TN +
                               tx * RN) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
  __syncthreads();
  // each result row once, to its original row index
  for (int q = tid; q < TM * TX; q += kThreads * G) {
    const int r = q / TX, cq = (q % TX) * RN;
    const int orow = s_row[r];
    const int col = c0 + cq;
    if (orow < 0 || col >= p) continue;
    float4 v = *reinterpret_cast<const float4*>(part + r * TN + cq);
    for (int g = 1; g < G; ++g) {
      const float4 u =
          *reinterpret_cast<const float4*>(part + (g * TM + r) * TN + cq);
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    float* o = a.out + static_cast<long long>(orow) * p + col;
    if (a.vec_out && col + RN <= p) {
      *reinterpret_cast<float4*>(o) = v;
    } else {
      const float vs[RN] = {v.x, v.y, v.z, v.w};
      for (int jj = 0; jj < RN && col + jj < p; ++jj) o[jj] = vs[jj];
    }
  }
}

constexpr int kTileRows = 32, kTileCols = 64, kGroups = 4;

// The grid is a tile's column blocks side by side, tiles in bucket order,
// so the blocks of live rows come before the zero-only ones.
int launch_tiles(const TileArgs& a, cudaStream_t s) {
  constexpr int smem = tile_smem_bytes<kTileRows, kTileCols, kGroups>();
  const auto kernel = rank_tiles_kernel<kTileRows, kTileCols, kGroups>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long tiles =
      (static_cast<long long>(a.n) + static_cast<long long>(a.k + 1) *
       (kTileRows - 1)) / kTileRows;
  const long long blocks = tiles * ((a.p + kTileCols - 1) / kTileCols);
  kernel<<<static_cast<unsigned>(blocks), kThreads * kGroups, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

TileArgs tile_args(const float* x, const int* ro, const float* param,
                   const int* scratch, float* out, int n, int d, int p,
                   int k, int ro_cols) {
  return TileArgs{x, ro, param, scratch, scratch + n, out, n, d, p, k,
                  ro_cols, aligned16(x) && d % 4 == 0,
                  aligned16(param) && p % 4 == 0,
                  aligned16(out) && p % 4 == 0};
}

bool bad_shape(int n, int d, int k, int ro_cols) {
  return k < 1 || k > kMaxRank || ro_cols < 1 + 2 * k || d < 0 || n < 0;
}

}  // namespace

// The bucket pass alone: scratch [n + k + 2] i32 gets the row permutation
// (scratch[0:n]) and the K + 2 bucket bounds (scratch[n:]). One launch;
// returns its cudaError_t.
extern "C" int pbx_rank_buckets(const int* ro, int* scratch, int n, int k,
                                int ro_cols, void* stream) {
  if (bad_shape(n, 0, k, ro_cols)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  rank_buckets_kernel<<<1, kBucketThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      ro, n, ro_cols, k, scratch, scratch + n);
  return static_cast<int>(cudaGetLastError());
}

// The tile kernel alone over a scratch the bucket pass filled. One launch;
// returns its cudaError_t.
extern "C" int pbx_rank_attention_tiles(const float* x, const int* ro,
                                        const float* param,
                                        const int* scratch, float* out,
                                        int n, int d, int p, int k,
                                        int ro_cols, void* stream) {
  if (n <= 0 || p <= 0) return 0;
  if (bad_shape(n, d, k, ro_cols)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_tiles(tile_args(x, ro, param, scratch, out, n, d, p, k,
                                ro_cols),
                      static_cast<cudaStream_t>(stream));
}

// x [n, d] f32, ro [n, ro_cols] i32, param [k*k, d, p] f32, scratch
// [n + k + 2] i32, out [n, p] f32, all on the device; 1 <= k <= 16. Two
// launches (bucket pass, tile kernel); returns the first cudaError_t
// (cudaErrorInvalidValue for a shape the kernels do not take).
extern "C" int pbx_rank_attention(const float* x, const int* ro,
                                  const float* param, int* scratch,
                                  float* out, int n, int d, int p, int k,
                                  int ro_cols, void* stream) {
  if (n <= 0 || p <= 0) return 0;
  if (bad_shape(n, d, k, ro_cols)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rc = pbx_rank_buckets(ro, scratch, n, k, ro_cols, stream);
  if (rc != 0) return rc;
  return launch_tiles(tile_args(x, ro, param, scratch, out, n, d, p, k,
                                ro_cols),
                      static_cast<cudaStream_t>(stream));
}
