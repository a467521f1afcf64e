"""Tiered sharded PS in the multi-process form — counterpart of
``paddlebox_tpu/ps/tiered_multihost.py``.

Reference: each AIBox node owns its slice of the PS — SSD + host memory
are per-node, coordinated over MPI (box_wrapper.h:446-450; SURVEY §2.6
multi-node rows). The port's mapping: one rank process per node
(``train/multihost.Pod``); rank r holds the window states of its owned
shards (``pod.owned``) on its device, and this table puts those shards'
HOST TIERS (``HostStore``) in the same process:

- key→row indexes and ``_touched`` stay replicated on every rank — the
  SPMD host contract (every rank builds identical batches and routing
  plans) makes every assign/evict deterministic and identical, so the
  bookkeeping needs no communication;
- host value stores exist only for owned shards. ``stage`` fetches only
  owned shards' missing keys (the ``_fetch_stage_values`` seam);
  ``begin_pass`` runs the shared reconcile/evict core for every shard
  (bookkeeping) and moves values only for owned shards, by kernel row 3
  (``scatter_window_rows``) into each owned window, with no value
  crossing between ranks; ``end_pass`` writes back the owned shards'
  touched rows through kernel row 4 (``RowsToHost``) and waits for them:
  the pass lifecycle is collective, so every rank's write-back has
  landed when end_pass returns (no asynchronous epilogue here);
- save/load work per process on the owned shards (the per-node SaveBase
  files of the reference); ``feature_count`` is per process.

Every rank must call stage/begin_pass/end_pass/drop_window collectively
(same keys, same order), as it runs the step itself.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from paddlebox_tpu_torch.obs import trace
from paddlebox_tpu_torch.ps.kv import make_kv
from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
from paddlebox_tpu_torch.ps.sharded import _read_raw
from paddlebox_tpu_torch.ps.table import (RowsToHost, promote_window_delta,
                                          scatter_window_rows)
from paddlebox_tpu_torch.ps.tiered import TieredShardedEmbeddingTable
from paddlebox_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


class MultihostTieredShardedTable(TieredShardedEmbeddingTable):
    """TieredShardedEmbeddingTable whose host tiers are per process."""

    def __init__(self, pod, mf_dim: int = 8,
                 capacity_per_shard: Optional[int] = None,
                 cfg: Optional[SparseSGDConfig] = None,
                 host_capacity: Optional[int] = None,
                 host_init_rows: int = 1 << 14,
                 req_bucket_min: int = 512,
                 serve_bucket_min: int = 1024,
                 ssd_dir: Optional[str] = None) -> None:
        """``pod`` (``train/multihost.global_mesh``) names the shards and
        the device; the windows of ``pod.owned`` live on ``pod.device``."""
        super().__init__(pod.n, mf_dim=mf_dim,
                         capacity_per_shard=capacity_per_shard, cfg=cfg,
                         host_capacity=host_capacity,
                         host_init_rows=host_init_rows,
                         req_bucket_min=req_bucket_min,
                         serve_bucket_min=serve_bucket_min,
                         ssd_dir=ssd_dir, _pod=pod)

    # ---- pass lifecycle (collective) -----------------------------------
    def _fetch_stage_values(self, s: int, new_keys: np.ndarray):
        return (self.hosts[s].fetch(new_keys)
                if s in self.owned else None)

    def begin_pass(self, pass_keys: Optional[np.ndarray] = None) -> int:
        with trace.span("pass.begin"):
            return self._begin_pass_mh(pass_keys)

    def _begin_pass_mh(self, pass_keys: Optional[np.ndarray]) -> int:
        st = self._resolve_stage(pass_keys)
        stats = dict(resident=0, staged=0, evicted=0, evicted_writeback=0,
                     written_back=0)
        total = 0
        rows_of: Dict[int, np.ndarray] = {}
        vals_of: Dict[int, np.ndarray] = {}
        try:
            with self.host_lock:
                self._open_keys = st.keys
                for s in range(self.n):
                    owned = s in self.owned

                    def gather(rows, s=s, owned=owned):
                        return (self._gather_rows_sync(s, rows)
                                if owned else None)

                    def writeback(ks, rs, sub, s=s, owned=owned):
                        if owned:
                            self.hosts[s].update_rows(ks, sub)

                    rows_new, still, st_s = promote_window_delta(
                        self.indexes[s], self._touched[s], self.capacity,
                        st.keys[s], st.new_keys[s],
                        gather_rows=gather, writeback=writeback,
                        pending=self._pending_of(s),
                        protect=self._queued_protect(s))
                    # pending keys promoted by THIS pass leave the pending
                    # set (the same bookkeeping on every rank)
                    self._unpin_pending(s, st.keys[s])
                    for k in st_s:
                        stats[k] = stats.get(k, 0) + st_s[k]
                    total += len(st.keys[s])
                    if owned:
                        rows_of[s] = rows_new
                        vals_of[s] = self._logical_rows(
                            {f: v[still] for f, v in st.values[s].items()})
                self._reset_dev_indexes()
                for s in rows_of:
                    scatter_window_rows(self.states[s], rows_of[s],
                                        vals_of[s])
                ev_sec, ev_rows = (self._evict_async_sec,
                                   self._evict_async_rows)
        except BaseException:
            # the base class's restore contract (PassPipeline relies on
            # it): a begin that fails after consuming a queued stage puts
            # the stage back at the head and drops the open pin
            with self.host_lock:
                if getattr(st, "from_queue", False):
                    self._stage_q.appendleft(st)
                self._open_keys = [np.empty(0, np.uint64)
                                   for _ in range(self.n)]
            raise
        self.in_pass = True
        stats["stage_wait_sec"] = round(self._last_stage_wait_sec, 6)
        stats["evict_emergency_sec"] = round(stats.pop("evict_sec", 0.0), 6)
        mark_sec, mark_rows = self._evict_async_mark
        self._evict_async_mark = (ev_sec, ev_rows)
        stats["evict_async_sec"] = round(ev_sec - mark_sec, 6)
        stats["evict_async_rows"] = int(ev_rows - mark_rows)
        self.last_pass_stats = stats
        log.info("begin_pass (mh, %d owned shards): %d rows (%d resident "
                 "%d staged %d evicted)", len(self.owned), total,
                 stats["resident"], stats["staged"], stats["evicted"])
        return total

    def end_pass(self) -> int:
        """Write back the owned shards' touched rows (kernel row 4 into
        pinned memory, waited for here) and clear every shard's flags;
        then the capacity eviction ahead of the next queued pass and the
        owned tiers' watermark demotion, inline."""
        if not self.in_pass:
            raise RuntimeError("end_pass without begin_pass")
        total = 0
        with trace.span("pass.end_submit"):
            with self.host_lock:
                for s in range(self.n):
                    keys, rows = self.indexes[s].items()
                    m = self._touched[s][rows]
                    keys, rows = keys[m], rows[m]
                    if s in self.owned and len(rows):
                        self.hosts[s].update_rows(
                            keys, RowsToHost(self.states[s], rows).wait())
                    self._touched[s][rows] = False
                    # written-back pending keys: the host value is
                    # authoritative again
                    self._unpin_pending(s, keys)
                    total += len(rows)
                self._open_keys = [np.empty(0, np.uint64)
                                   for _ in range(self.n)]
        self.in_pass = False
        self.last_pass_stats["written_back"] = total
        # replicated bookkeeping and a deterministic selection: every
        # rank frees the same rows for the next queued pass
        self._evict_ahead()
        # each node manages its own SSD tier (box_wrapper.h:446-450)
        self._demote_after_writeback()
        return total

    def drop_window(self) -> None:
        self._no_pass("drop_window")
        try:
            if self._stage_thread is not None or self._stage is not None:
                self.wait_stage_done()
        finally:
            self._stage = None
            with self.host_lock:
                self._stage_q.clear()
                self._stage_gen += 1
                self._open_keys = [np.empty(0, np.uint64)
                                   for _ in range(self.n)]
                self.indexes = [make_kv(self.capacity)
                                for _ in range(self.n)]
                self._touched[:] = False
                self._pending = [np.empty(0, np.uint64)
                                 for _ in range(self.n)]
                self._pending_chunks = [[] for _ in range(self.n)]
                for s in self.owned:
                    self.states[s].data.zero_()
                self._reset_dev_indexes()

    # ---- per-process model lifecycle (owned shards only) ---------------
    def feature_count(self) -> int:
        """Rows in THIS process's host tiers (per-node count, as each
        AIBox node reports its own shard)."""
        return sum(len(self.hosts[s]) for s in self.owned)

    def _save(self, path: str, delta: bool, clear_touched: bool) -> int:
        self._no_pass("save_delta" if delta else "save_base")
        blobs: Dict[str, np.ndarray] = {}
        total = 0
        for s in self.owned:
            keys, fields = self.hosts[s].export_rows(
                delta=delta, clear_touched=clear_touched)
            blobs[f"keys_{s}"] = keys
            for f, v in fields.items():
                blobs[f"{f}_{s}"] = v
            total += len(keys)
        np.savez(path, n=self.n, owned=np.array(self.owned), **blobs)
        return total

    def save_base(self, path: str, clear_touched: bool = True) -> int:
        """Owned shards only → a per-process file (the per-node SaveBase
        convention); each rank restores from its own file (``load``) or
        every rank from the whole set (``load_reshard``)."""
        return self._save(path, False, clear_touched)

    def save_delta(self, path: str, clear_touched: bool = True) -> int:
        return self._save(path, True, clear_touched)

    def load(self, path, merge: bool = False) -> int:
        """This rank's own per-process file (a save of a table of the
        same shard count; else raises: ``load_reshard`` takes foreign
        counts)."""
        self._no_pass("load")
        blob = _read_raw(path)
        if "n" not in blob or int(blob["n"]) != self.n:
            raise ValueError(
                f"per-process load needs a save written by an {self.n}-"
                f"shard table (got n={blob.get('n', 'missing')}); "
                "load_reshard re-splits a foreign save")
        total = 0
        for s in self.owned:
            if f"keys_{s}" not in blob:
                continue
            fields = {f: blob[f"{f}_{s}"] for f in self.hosts[s].fields
                      if f"{f}_{s}" in blob}
            total += self.hosts[s].import_rows(blob[f"keys_{s}"], fields,
                                               merge=merge)
        self.drop_window()
        return total

    def load_reshard(self, paths, merge: bool = False) -> int:
        """Re-import saves written at ANY shard count — the elastic
        re-shard path. Every rank reads EVERY file of one save epoch
        (``paths``: the whole per-process file set, or one base file),
        re-splits all keys by ``key % n`` (``_file_per_shard``) and
        imports the rows of its OWNED shards. Call in lockstep across the
        new world, outside a pass window."""
        self._no_pass("load_reshard")
        if isinstance(paths, (str, os.PathLike)):
            paths = [paths]
        total = 0
        fresh: set = set()
        for path in paths:
            blob = _read_raw(path)
            for s, (keys, fields) in enumerate(self._file_per_shard(blob)):
                if s not in self.owned or not len(keys):
                    continue
                want = set(self.hosts[s].fields)
                use = {f: v for f, v in fields.items() if f in want}
                # the first import into a shard resets it (load
                # semantics); rows of the later files merge on top
                first = not merge and s not in fresh
                fresh.add(s)
                total += self.hosts[s].import_rows(keys, use,
                                                   merge=not first)
        if not merge:
            # owned shards no file routed keys to still reset: "the file
            # set IS the model"
            for s in sorted(set(self.owned) - fresh):
                self.hosts[s].import_rows(np.empty(0, np.uint64), {},
                                          merge=False)
        self.drop_window()
        return total

    def shrink(self, delete_threshold: Optional[float] = None,
               decay: Optional[float] = None) -> int:
        self._no_pass("shrink")
        freed = sum(
            self.hosts[s].shrink(delete_threshold=delete_threshold,
                                 decay=decay,
                                 nonclk_coeff=self.cfg.nonclk_coeff,
                                 clk_coeff=self.cfg.clk_coeff)
            for s in self.owned)
        self.drop_window()
        return freed

    def spill_cold(self, path_prefix: str, threshold: float) -> int:
        self._no_pass("spill_cold")
        return sum(
            self.hosts[s].spill_cold(
                f"{path_prefix}.s{s}.npz", threshold,
                nonclk_coeff=self.cfg.nonclk_coeff,
                clk_coeff=self.cfg.clk_coeff)
            for s in self.owned)

    def merge_model(self, path) -> int:
        self._no_pass("merge_model")
        blob = _read_raw(path)
        total = 0
        for s, (keys, fields) in enumerate(self._file_per_shard(blob)):
            if s in self.owned:
                total += self.hosts[s].merge_model_rows(keys, fields)
        self.drop_window()
        return total
