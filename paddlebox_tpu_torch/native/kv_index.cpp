// Host key→row hash index — the port's copy of
// paddlebox_tpu/native/kv_index.cpp (the same source: the port may not
// import the JAX package, so it builds its own library from this file,
// see paddlebox_tpu_torch/native/__init__.py).
//
// Role in the reference: the GPU-resident concurrent hash map
// (paddle/fluid/framework/fleet/heter_ps/hashtable.h:113, vendored cuDF
// concurrent_unordered_map) plus BoxPS's DedupKeysAndFillIdx host logic
// (box_wrapper_impl.h:129). In this design the index lives on the HOST
// (the device table is a plain row-major tensor addressed by row), so the
// hot path is a batched uint64→int32 assign/lookup called per batch from
// the prefetch thread, with this open-addressing table in place of a
// python dict (paddlebox_tpu_torch/ps/kv.py PyKV).
//
// Layout: power-of-2 bucket array of {key, row} plus a 1-byte state array
// (EMPTY/FULL/TOMBSTONE — tombstones keep probe chains intact after
// release()). Linear probing with a splitmix64-mixed hash. Not thread-safe
// per instance (callers hold the table's host_lock).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

enum : uint8_t { EMPTY = 0, FULL = 1, TOMB = 2 };

inline uint64_t mix(uint64_t k) {
  // splitmix64 finalizer — avalanche for clustered feasign ids
  k += 0x9e3779b97f4a7c15ull;
  k = (k ^ (k >> 30)) * 0xbf58476d1ce4e5b9ull;
  k = (k ^ (k >> 27)) * 0x94d049bb133111ebull;
  return k ^ (k >> 31);
}

// Optional slot-arena row allocator: rows are carved from fixed-size,
// chunk-aligned extents owned by one slot each, so a slot's rows cluster
// into few chunks and a (slot, local) pair addresses any row with
// local < n_chunks(slot) * chunk_size — the compact resident-pass wire
// ships per-key LOCAL rows in ~17 bits instead of per-batch dedup
// streams (train/device_pass.py). Mirrors the reference's slot-grouped
// pull/push layouts (multi-mf build groups keys by slot dim class,
// ps_gpu_wrapper.cc BuildGPUTask); here the grouping buys wire entropy.
struct Arena {
  int32_t chunk_bits = 0;  // 0 = disabled
  int32_t n_slots = 0;     // fixed at enable time (slot ids < n_slots)
  int32_t next_chunk = 0;
  int32_t max_chunks = 0;
  std::vector<int32_t> chunk_slot;   // [max_chunks] owning slot or -1
  std::vector<int32_t> chunk_rank;   // [max_chunks] rank within its slot
  std::vector<int32_t> slot_nchunks;            // [n_slots]
  std::vector<int32_t> slot_tail_chunk;         // [n_slots] current chunk
  std::vector<int32_t> slot_fill;               // rows used in tail chunk
  std::vector<std::vector<int32_t>> slot_free;  // freed global rows

  bool enabled() const { return chunk_bits > 0; }

  void init(int32_t bits, int32_t slots, int32_t max_rows) {
    chunk_bits = bits;
    n_slots = slots;
    max_chunks = (max_rows + (1 << bits) - 1) >> bits;
    chunk_slot.assign(max_chunks, -1);
    chunk_rank.assign(max_chunks, -1);
    slot_nchunks.assign(n_slots, 0);
    slot_tail_chunk.assign(n_slots, -1);
    slot_fill.assign(n_slots, 0);
    slot_free.assign(n_slots, {});
  }

  // allocate a global row from slot s's arena; -2 when out of chunks
  int32_t alloc(int32_t s, int32_t max_rows) {
    if (!slot_free[s].empty()) {
      int32_t r = slot_free[s].back();
      slot_free[s].pop_back();
      return r;
    }
    int32_t cs = 1 << chunk_bits;
    if (slot_tail_chunk[s] < 0 || slot_fill[s] == cs) {
      if (next_chunk >= max_chunks) return -2;
      int32_t c = next_chunk++;
      chunk_slot[c] = s;
      chunk_rank[c] = slot_nchunks[s]++;
      slot_tail_chunk[s] = c;
      slot_fill[s] = 0;
    }
    int32_t row = (slot_tail_chunk[s] << chunk_bits) + slot_fill[s]++;
    return row < max_rows ? row : -2;  // final partial chunk guard
  }

  // clamp out-of-range slot ids to the default (slotless) arena — the
  // caller's compact wire then sees local = -1 and falls back, instead
  // of the out-of-bounds vector writes a raw slot id would cause
  int32_t clamp_slot(int32_t s) const {
    return (s >= 0 && s < n_slots) ? s : n_slots;
  }

  // slot-local address of a global row; -1 when the row's owning arena
  // is not `s` (key previously assigned slotless or under another slot)
  int32_t local_of(int32_t row, int32_t s) const {
    if (s < 0 || s >= n_slots) return -1;  // incl. the default arena id
    int32_t c = row >> chunk_bits;
    if (chunk_slot[c] != s) return -1;
    return (chunk_rank[c] << chunk_bits) | (row & ((1 << chunk_bits) - 1));
  }
};

struct KvIndex {
  std::vector<uint64_t> keys;
  std::vector<int32_t> rows;
  std::vector<uint8_t> state;
  std::vector<int32_t> free_rows;
  uint64_t mask = 0;
  int64_t size = 0;        // live entries
  int64_t tombs = 0;       // tombstoned buckets (reclaimed only by rehash)
  int32_t next_row = 0;
  int32_t max_rows = 0;
  Arena arena;

  // per-call dedup scratch, keyed by row (rows are unique per key):
  // seen_epoch[row] == cur_epoch marks "already emitted this call";
  // seen_pos[row] is its position in the call's unique list. Lazily sized
  // max_rows+1 so the lookup sentinel row can participate too.
  std::vector<uint32_t> seen_epoch;
  std::vector<int32_t> seen_pos;
  uint32_t cur_epoch = 0;

  uint32_t next_epoch() {
    if (seen_epoch.empty()) {
      seen_epoch.assign(static_cast<size_t>(max_rows) + 1, 0);
      seen_pos.assign(static_cast<size_t>(max_rows) + 1, 0);
    }
    if (++cur_epoch == 0) {  // wrapped: stale marks could alias — clear
      std::fill(seen_epoch.begin(), seen_epoch.end(), 0);
      cur_epoch = 1;
    }
    return cur_epoch;
  }

  explicit KvIndex(int64_t capacity_hint, int32_t max_rows_) {
    uint64_t cap = 64;
    while (cap < static_cast<uint64_t>(capacity_hint) * 2) cap <<= 1;
    keys.assign(cap, 0);
    rows.assign(cap, -1);
    state.assign(cap, EMPTY);
    mask = cap - 1;
    max_rows = max_rows_;
  }

  // Rehash. Doubles when genuinely loaded; rebuilds at the same size when
  // the pressure is tombstones (assign/release churn) — reclaiming them so
  // probe chains always terminate at an EMPTY slot.
  void grow() {
    std::vector<uint64_t> ok = std::move(keys);
    std::vector<int32_t> orows = std::move(rows);
    std::vector<uint8_t> ost = std::move(state);
    uint64_t ocap = mask + 1;
    uint64_t ncap = (size * 10 >= static_cast<int64_t>(ocap) * 5)
                        ? (ocap << 1) : ocap;
    keys.assign(ncap, 0);
    rows.assign(ncap, -1);
    state.assign(ncap, EMPTY);
    mask = ncap - 1;
    for (uint64_t i = 0; i < ocap; ++i) {
      if (ost[i] == FULL) {
        uint64_t h = mix(ok[i]) & mask;
        while (state[h] == FULL) h = (h + 1) & mask;
        keys[h] = ok[i];
        rows[h] = orows[i];
        state[h] = FULL;
      }
    }
    tombs = 0;
  }

  // returns row, or -2 if table full (new key, no rows left).
  // feat_slot >= 0 routes new-key allocation to that slot's arena when
  // arena mode is on; -1 = slotless (default arena in arena mode).
  int32_t assign_one(uint64_t k, int32_t feat_slot = -1) {
    // tombstones count toward occupancy: without this, churn
    // (assign/release cycles) exhausts EMPTY slots and probes loop forever
    if ((size + tombs + 1) * 10 >= static_cast<int64_t>(mask + 1) * 7) grow();
    uint64_t h = mix(k) & mask;
    int64_t first_tomb = -1;
    for (;;) {
      uint8_t st = state[h];
      if (st == FULL && keys[h] == k) return rows[h];
      if (st == EMPTY) break;
      if (st == TOMB && first_tomb < 0) first_tomb = static_cast<int64_t>(h);
      h = (h + 1) & mask;
    }
    int32_t row;
    if (arena.enabled()) {
      int32_t s = arena.clamp_slot(feat_slot);
      row = arena.alloc(s, max_rows);
      if (row == -2) return -2;
    } else if (!free_rows.empty()) {
      row = free_rows.back();
      free_rows.pop_back();
    } else if (next_row < max_rows) {
      row = next_row++;
    } else {
      return -2;
    }
    uint64_t slot = first_tomb >= 0 ? static_cast<uint64_t>(first_tomb) : h;
    keys[slot] = k;
    rows[slot] = row;
    state[slot] = FULL;
    ++size;
    return row;
  }

  int32_t lookup_one(uint64_t k) const {
    uint64_t h = mix(k) & mask;
    for (;;) {
      uint8_t st = state[h];
      if (st == FULL && keys[h] == k) return rows[h];
      if (st == EMPTY) return -1;
      h = (h + 1) & mask;
    }
  }

  int32_t release_one(uint64_t k) {
    uint64_t h = mix(k) & mask;
    for (;;) {
      uint8_t st = state[h];
      if (st == FULL && keys[h] == k) {
        int32_t row = rows[h];
        state[h] = TOMB;
        rows[h] = -1;
        if (arena.enabled()) {  // rows return to their OWNING arena
          arena.slot_free[arena.chunk_slot[row >> arena.chunk_bits]]
              .push_back(row);
        } else {
          free_rows.push_back(row);
        }
        --size;
        ++tombs;
        return row;
      }
      if (st == EMPTY) return -1;
      h = (h + 1) & mask;
    }
  }
};

}  // namespace

extern "C" {

void* kv_create(int64_t capacity_hint, int32_t max_rows) {
  return new KvIndex(capacity_hint, max_rows);
}

void kv_destroy(void* p) { delete static_cast<KvIndex*>(p); }

int64_t kv_size(void* p) { return static_cast<KvIndex*>(p)->size; }

// assign rows for n keys; returns number assigned before the table filled
// (== n on success). rows_out[i] = row of keys[i].
int64_t kv_assign(void* p, const uint64_t* in, int64_t n, int32_t* rows_out) {
  KvIndex* kv = static_cast<KvIndex*>(p);
  constexpr int64_t PF = 16;
  for (int64_t i = 0; i < n; ++i) {
    if (i + PF < n) {
      uint64_t h = mix(in[i + PF]) & kv->mask;
      __builtin_prefetch(&kv->state[h]);
      __builtin_prefetch(&kv->keys[h]);
    }
    int32_t r = kv->assign_one(in[i]);
    if (r == -2) return i;
    rows_out[i] = r;
  }
  return n;
}

void kv_lookup(void* p, const uint64_t* in, int64_t n, int32_t* rows_out) {
  const KvIndex* kv = static_cast<KvIndex*>(p);
  for (int64_t i = 0; i < n; ++i) rows_out[i] = kv->lookup_one(in[i]);
}

// release n keys; rows_out[i] = freed row or -1; returns count freed.
int64_t kv_release(void* p, const uint64_t* in, int64_t n, int32_t* rows_out) {
  KvIndex* kv = static_cast<KvIndex*>(p);
  int64_t freed = 0;
  for (int64_t i = 0; i < n; ++i) {
    rows_out[i] = kv->release_one(in[i]);
    if (rows_out[i] >= 0) ++freed;
  }
  return freed;
}

// Fused DedupKeysAndFillIdx + assign (box_wrapper_impl.h:129 done host-side
// in ONE pass): dedup n keys in first-occurrence order, assign a row to each
// unique key, write the unique rows to uniq_rows_out (buffer sized n) and
// the key→unique-position inverse map to inverse_out (sized n). Returns the
// unique count, or -1 if the table filled. Replaces np.unique's O(n log n)
// sort with O(n) hashing — the prepare-thread hot path.
int64_t kv_assign_unique(void* p, const uint64_t* in, int64_t n,
                         int32_t* uniq_rows_out, int32_t* inverse_out) {
  KvIndex* kv = static_cast<KvIndex*>(p);
  uint32_t epoch = kv->next_epoch();
  int64_t u = 0;
  constexpr int64_t PF = 16;
  for (int64_t i = 0; i < n; ++i) {
    if (i + PF < n) {
      uint64_t h = mix(in[i + PF]) & kv->mask;
      __builtin_prefetch(&kv->state[h]);
      __builtin_prefetch(&kv->keys[h]);
    }
    int32_t row = kv->assign_one(in[i]);
    if (row == -2) return -1;
    if (kv->seen_epoch[row] != epoch) {
      kv->seen_epoch[row] = epoch;
      kv->seen_pos[row] = static_cast<int32_t>(u);
      uniq_rows_out[u] = row;
      ++u;
    }
    inverse_out[i] = kv->seen_pos[row];
  }
  return u;
}

// Read-only variant (eval/inference): unknown keys all share ONE unique
// entry holding sentinel_row (the zero row), so no index mutation happens.
int64_t kv_lookup_unique(void* p, const uint64_t* in, int64_t n,
                         int32_t sentinel_row, int32_t* uniq_rows_out,
                         int32_t* inverse_out) {
  KvIndex* kv = static_cast<KvIndex*>(p);
  uint32_t epoch = kv->next_epoch();
  int64_t u = 0;
  int32_t miss_pos = -1;
  for (int64_t i = 0; i < n; ++i) {
    int32_t row = kv->lookup_one(in[i]);
    if (row < 0) {
      if (miss_pos < 0) {
        miss_pos = static_cast<int32_t>(u);
        uniq_rows_out[u] = sentinel_row;
        ++u;
      }
      inverse_out[i] = miss_pos;
      continue;
    }
    if (kv->seen_epoch[row] != epoch) {
      kv->seen_epoch[row] = epoch;
      kv->seen_pos[row] = static_cast<int32_t>(u);
      uniq_rows_out[u] = row;
      ++u;
    }
    inverse_out[i] = kv->seen_pos[row];
  }
  return u;
}

// ---- slot arena (compact resident-pass wire) ----

// Enable chunked slot-arena allocation. Must be called before any row is
// assigned (returns -1 otherwise). slot ids must be < n_slots; slotless
// assigns draw from an internal default arena.
int32_t kv_arena_enable(void* p, int32_t chunk_bits, int32_t n_slots) {
  KvIndex* kv = static_cast<KvIndex*>(p);
  if (kv->size != 0 || kv->next_row != 0 || kv->arena.enabled()) return -1;
  kv->arena.init(chunk_bits, n_slots + 1, kv->max_rows);
  kv->arena.n_slots = n_slots;  // default arena = id n_slots (internal)
  return 0;
}

// Per-key slotted assign: rows_out[i] = global row (or the call stops at
// i and returns i when the table/arena fills); local_out[i] = slot-local
// row, or -1 when the key's row lives in another slot's arena (assigned
// earlier slotless or under a different slot) — callers seeing any -1
// fall back to the dedup wire for that pass.
int64_t kv_assign_slotted(void* p, const uint64_t* in, const uint16_t* slots,
                          int64_t n, int32_t* rows_out, int32_t* local_out) {
  KvIndex* kv = static_cast<KvIndex*>(p);
  // The per-key cost is cache misses on the bucket arrays (the table is
  // far larger than LLC at CTR scale); software-prefetch the probe
  // window a fixed distance ahead.
  constexpr int64_t PF = 16;
  for (int64_t i = 0; i < n; ++i) {
    if (i + PF < n) {
      uint64_t h = mix(in[i + PF]) & kv->mask;
      __builtin_prefetch(&kv->state[h]);
      __builtin_prefetch(&kv->keys[h]);
    }
    int32_t s = static_cast<int32_t>(slots[i]);
    int32_t r = kv->assign_one(in[i], s);
    if (r == -2) return i;
    rows_out[i] = r;
    if (local_out) local_out[i] = kv->arena.local_of(r, s);
  }
  return n;
}

// Slotted variant of kv_assign_unique (same dedup contract): new keys
// allocate in their slot's arena.
int64_t kv_assign_unique_slotted(void* p, const uint64_t* in,
                                 const uint16_t* slots, int64_t n,
                                 int32_t* uniq_rows_out,
                                 int32_t* inverse_out) {
  KvIndex* kv = static_cast<KvIndex*>(p);
  uint32_t epoch = kv->next_epoch();
  int64_t u = 0;
  constexpr int64_t PF = 16;
  for (int64_t i = 0; i < n; ++i) {
    if (i + PF < n) {
      uint64_t h = mix(in[i + PF]) & kv->mask;
      __builtin_prefetch(&kv->state[h]);
      __builtin_prefetch(&kv->keys[h]);
    }
    int32_t row = kv->assign_one(in[i], static_cast<int32_t>(slots[i]));
    if (row == -2) return -1;
    if (kv->seen_epoch[row] != epoch) {
      kv->seen_epoch[row] = epoch;
      kv->seen_pos[row] = static_cast<int32_t>(u);
      uniq_rows_out[u] = row;
      ++u;
    }
    inverse_out[i] = kv->seen_pos[row];
  }
  return u;
}

// Export the chunk ownership map: chunk_slot_out/chunk_rank_out sized
// kv_arena_chunk_count(); returns the number of allocated chunks.
// chunk_map[slot, rank] = chunk id reconstructs vectorized host-side.
int32_t kv_arena_chunk_count(void* p) {
  return static_cast<KvIndex*>(p)->arena.next_chunk;
}

int32_t kv_arena_export(void* p, int32_t* chunk_slot_out,
                        int32_t* chunk_rank_out) {
  const KvIndex* kv = static_cast<KvIndex*>(p);
  int32_t n = kv->arena.next_chunk;
  std::memcpy(chunk_slot_out, kv->arena.chunk_slot.data(),
              sizeof(int32_t) * n);
  std::memcpy(chunk_rank_out, kv->arena.chunk_rank.data(),
              sizeof(int32_t) * n);
  return n;
}

// Standalone first-seen dedup — NO index instance, a call-local
// open-addressing table over the batch only. One O(n) pass replaces the
// python oracle's three (np.unique + argsort + rank scatter,
// ps/kv.dedup_first_seen_py): uniq_out gets the distinct keys in
// first-occurrence order, first_out their first stream positions,
// inv_out each key's unique rank. Buffers sized n. Returns the unique
// count.
int64_t kv_dedup_first_seen(const uint64_t* in, int64_t n,
                            uint64_t* uniq_out, int64_t* first_out,
                            int32_t* inv_out) {
  uint64_t cap = 64;
  while (cap < static_cast<uint64_t>(n) * 2) cap <<= 1;
  uint64_t mask = cap - 1;
  std::vector<uint64_t> keys(cap);
  std::vector<int32_t> pos(cap, -1);
  int64_t u = 0;
  constexpr int64_t PF = 16;
  for (int64_t i = 0; i < n; ++i) {
    if (i + PF < n) {
      uint64_t ph = mix(in[i + PF]) & mask;
      __builtin_prefetch(&pos[ph]);
      __builtin_prefetch(&keys[ph]);
    }
    uint64_t k = in[i];
    uint64_t h = mix(k) & mask;
    while (pos[h] >= 0 && keys[h] != k) h = (h + 1) & mask;
    if (pos[h] < 0) {
      keys[h] = k;
      pos[h] = static_cast<int32_t>(u);
      uniq_out[u] = k;
      first_out[u] = i;
      ++u;
    }
    inv_out[i] = pos[h];
  }
  return u;
}

// dump all live (key,row) pairs; buffers must hold kv_size entries.
void kv_items(void* p, uint64_t* keys_out, int32_t* rows_out) {
  const KvIndex* kv = static_cast<KvIndex*>(p);
  int64_t j = 0;
  for (uint64_t i = 0; i <= kv->mask; ++i) {
    if (kv->state[i] == FULL) {
      keys_out[j] = kv->keys[i];
      rows_out[j] = kv->rows[i];
      ++j;
    }
  }
}

}  // extern "C"
