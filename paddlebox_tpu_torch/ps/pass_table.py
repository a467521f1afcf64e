"""Pass-scoped table: a persistent pass window on the card over a HostStore
— the port of ``paddlebox_tpu/ps/pass_table.py``.

Reference lifecycle (SURVEY.md §3.3): ``BeginFeedPass`` schedules SSD→mem
for the pass's key set, ``BeginPass`` buffers the pass embeddings into
device memory, training pulls and pushes only that working set, and
``EndPass`` writes back device→mem (box_wrapper.cc:129-186).

The single-table mirror of ``ps/tiered.TieredShardedEmbeddingTable``:
rows stay RESIDENT across passes. ``stage`` fetches host values only for
keys NOT in the window and is legal while a pass is open (missing keys
are outside the open pass's write-back set); ``begin_pass`` reconciles
(a key that entered the window mid-pass keeps its fresher row), evicts
only under capacity pressure (clean rows first; dirty evictees write
back) and scatters only the delta (kernel row 3); ``end_pass`` gathers
only the rows touched since the last write-back (kernel row 4) and
writes them back on the epilogue worker (``ps/epilogue.py``).

The window is the table's own ``state.data``, updated IN PLACE: a
``Trainer`` holding the table sees each new window without an adopt
step, and ``drop_window`` zeroes the rows without rebinding the tensor.

Host-tier mutations outside the pass protocol (``host.load`` /
``shrink`` / ``merge``) must be followed by ``drop_window()``: resident
rows would otherwise shadow the updated host values (``BoxPSHelper``
does this for its lifecycle methods).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from paddlebox_tpu_torch.config import FLAGS
from paddlebox_tpu_torch.ps.epilogue import PassEpilogue, fence_under_pressure
from paddlebox_tpu_torch.ps.host_store import HostStore
from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig, opt_ext_width
from paddlebox_tpu_torch.ps.table import (EmbeddingTable, RowsToHost,
                                          promote_window_delta,
                                          rows_from_store_fields,
                                          scatter_window_rows)
from paddlebox_tpu_torch.resilience import faults

log = logging.getLogger(__name__)


class PassStage:
    """Host-side staging of one pass: the full key set, the keys that
    were missing from the window at stage time, and their host values."""

    def __init__(self, keys: np.ndarray, new_keys: np.ndarray,
                 values: Dict[str, np.ndarray]):
        self.keys = keys
        self.new_keys = new_keys
        self.values = values


class PassScopedTable(EmbeddingTable):
    """EmbeddingTable whose rows are a persistent window of the working
    set; the full model lives in the backing HostStore."""

    # stage() is legal while a pass is open (BoxPSHelper.stage_pass)
    supports_overlap_stage = True

    def __init__(self, host: HostStore, pass_capacity: Optional[int] = None,
                 cfg: Optional[SparseSGDConfig] = None, seed: int = 0,
                 unique_bucket_min: int = 1024,
                 device: Union[str, torch.device] = "cuda") -> None:
        need = opt_ext_width(cfg, host.mf_dim) if cfg is not None else 0
        have = getattr(host, "opt_ext", 0)
        if need > have:
            raise ValueError(
                f"optimizer needs a {need}-wide extension block but the "
                f"HostStore persists {have} — construct "
                f"HostStore(mf_dim=..., opt_ext={need}) so SparseAdam "
                "state survives pass windows.")
        if need < have:
            raise ValueError(
                f"the HostStore carries a {have}-wide optimizer "
                f"extension but this table's optimizer uses {need} — "
                "pass the matching SparseAdamConfig (rebuilding the "
                "store with a smaller block would DISCARD the persisted "
                "optimizer state).")
        super().__init__(mf_dim=host.mf_dim,
                         capacity=pass_capacity or
                         FLAGS.table_capacity_per_shard,
                         cfg=cfg, seed=seed,
                         unique_bucket_min=unique_bucket_min, device=device)
        self.host = host
        self._stage: Optional[PassStage] = None
        self._stage_thread: Optional[threading.Thread] = None
        self._stage_exc: Optional[BaseException] = None
        self.in_pass = False
        # end_pass gathers and copies, the worker writes back; every
        # HostStore read entry point fences first
        self._epilogue = PassEpilogue(name="pass-endpass")
        host.read_barrier = self._epilogue.fence
        # per-pass delta accounting (the tiered table's keys)
        self.last_pass_stats: Dict[str, float] = {}

    def fence(self) -> None:
        """Drain the asynchronous end_pass write-back and raise the first
        failure (``PassEpilogue.fence``). Implicit on every ``self.host``
        read entry point."""
        self._epilogue.fence()

    def endpass_stats(self) -> Dict[str, float]:
        """Cumulative epilogue accounting."""
        return self._epilogue.stats()

    def spill_manifest(self) -> Optional[dict]:
        """Checkpoint spill manifest of the backing store's SSD tier
        (``train/checkpoint.py``), single-shard shape; None without a
        tier."""
        self.fence()
        m = self.host.spill_manifest()
        if m is None:
            return None
        return {"version": 1, "shards": {"0": m},
                "live_rows": m["live_rows"]}

    def ssd_stats(self) -> Dict[str, float]:
        return self.host.ssd_stats()

    def _logical_rows(self, vals: Dict[str, np.ndarray]) -> np.ndarray:
        return rows_from_store_fields(vals, self.mf_dim, self.opt_ext)

    def _gather_rows_device(self, rows: np.ndarray) -> np.ndarray:
        """Window rows → host [k, feat], synchronously (the dirty
        evictees of begin_pass): the gather is enqueued ahead of the
        scatter that will overwrite the rows."""
        return RowsToHost(self.state, rows).wait()

    # ---- feed-pass staging (BeginFeedPass/EndFeedPass) ----
    def stage(self, pass_keys: np.ndarray, background: bool = True) -> None:
        """Fetch host values for the pass keys NOT already resident.
        Legal while a pass is open (see the module docstring)."""
        if self._stage_thread is not None or self._stage is not None:
            raise RuntimeError("a feed pass is already staging")
        pass_keys = np.unique(np.ascontiguousarray(pass_keys, np.uint64))
        if len(pass_keys) > self.capacity:
            raise ValueError(
                f"pass working set ({len(pass_keys)}) exceeds table "
                f"capacity ({self.capacity})")
        with self.host_lock:
            new = pass_keys[self.index.lookup(pass_keys) < 0]
        self._stage_exc = None

        def run() -> None:
            try:
                self._stage = PassStage(pass_keys, new,
                                        self.host.fetch(new))
            except BaseException as e:
                self._stage_exc = e

        if background:
            self._stage_thread = threading.Thread(target=run, daemon=True)
            self._stage_thread.start()
        else:
            run()
            if self._stage_exc is not None:
                raise self._stage_exc

    def wait_stage_done(self) -> None:
        if self._stage_thread is not None:
            self._stage_thread.join()
            self._stage_thread = None
        if self._stage_exc is not None:
            exc, self._stage_exc = self._stage_exc, None
            raise exc

    # ---- pass window (BeginPass/EndPass) ----
    def begin_pass(self, pass_keys: Optional[np.ndarray] = None) -> int:
        """Promote the staged (or given) working set into the window:
        reconcile against live residency, evict only under capacity
        pressure, scatter only the new rows. Returns the number of
        working-set rows."""
        if self.in_pass:
            raise RuntimeError("begin_pass while a pass is open")
        if pass_keys is not None:
            pass_keys = np.unique(
                np.ascontiguousarray(pass_keys, np.uint64))
            if self._stage_thread is not None or self._stage is not None:
                # a stage exists: it must be for the same key set
                self.wait_stage_done()
                if (self._stage is None
                        or not np.array_equal(self._stage.keys, pass_keys)):
                    raise RuntimeError(
                        "begin_pass keys differ from the staged key set")
            else:
                self.stage(pass_keys, background=False)
        self.wait_stage_done()
        st = self._stage
        if st is None:
            raise RuntimeError("begin_pass with nothing staged")
        self._stage = None

        self.host_lock.acquire()
        try:
            # eviction under pressure: order the dirty evictees'
            # write-backs (and released rows' later re-fetches) after the
            # in-flight epilogue, fencing outside the lock
            fence_sec = fence_under_pressure(
                self.host_lock, self._epilogue.fence,
                lambda: (len(self.index) + len(st.new_keys)
                         > self.capacity))
            rows_new, still, stats = promote_window_delta(
                self.index, self._touched, self.capacity,
                st.keys, st.new_keys,
                gather_rows=self._gather_rows_device,
                writeback=lambda ks, rs, sub: self.host.update_rows(
                    ks, sub,
                    slot_override=self.slot_host[rs].astype(np.float32)),
                on_freed=lambda freed:
                    self.slot_host.__setitem__(freed, 0))
            # the promote assigned and released kv rows behind the device
            # index: re-seed (or degrade) on the next bulk assign
            self._reset_dev_index()
            ins_vals = {f: v[still] for f, v in st.values.items()}
            self.slot_host[rows_new] = ins_vals["slot"].astype(np.int16)
            scatter_window_rows(self.state, rows_new,
                                self._logical_rows(ins_vals))
        finally:
            self.host_lock.release()
        stats["written_back"] = 0
        # all eviction is inline here (no stage queue)
        stats["evict_emergency_sec"] = round(
            fence_sec + stats.pop("evict_sec", 0.0), 6)
        self.in_pass = True
        self.last_pass_stats = stats
        log.info("begin_pass: %d working-set rows (%d resident, %d "
                 "staged, %d evicted) in the window", len(st.keys),
                 stats["resident"], stats["staged"], stats["evicted"])
        return len(st.keys)

    def end_pass(self) -> int:
        """Close the pass and write back ASYNCHRONOUSLY: snapshot the
        touched rows and their slots, gather them on the training stream
        into pinned host memory (``RowsToHost``), and let the epilogue
        worker wait for the copy and update the host store;
        ``FLAGS.async_end_pass=False`` runs the job inline. The window
        stays resident."""
        if not self.in_pass:
            raise RuntimeError("end_pass without begin_pass")
        t0 = time.perf_counter()
        job = None
        with self.host_lock:
            keys, rows = self.index.items()
            m = self._touched[rows]
            keys, rows = keys[m], rows[m]
            if len(rows):
                # enqueued now, ahead of the next pass's first push;
                # slot metadata snapshots HERE (the next pass's prepare
                # may rewrite slot_host before the write-back lands)
                copy = RowsToHost(self.state, rows)
                slots = self.slot_host[rows].astype(np.float32)
                self._touched[rows] = False

                def job(keys=keys, copy=copy, slots=slots) -> None:
                    faults.inject("endpass.writeback", op="single",
                                  rows=len(keys))
                    self.host.update_rows(keys, copy.wait(),
                                          slot_override=slots)
                    if self.host.ssd is not None:
                        # watermark demotion on the epilogue worker,
                        # after the write-back (barrier=False: fencing
                        # from the worker would deadlock it)
                        self.host.demote_to_watermark(barrier=False)
                        self.host.ssd.maybe_compact()
        self.in_pass = False
        self.last_pass_stats["written_back"] = len(keys)
        if job is not None:
            if FLAGS.async_end_pass:
                self._epilogue.submit(job, label="end_pass")
            else:
                job()
        self.last_pass_stats["end_pass_submit_sec"] = round(
            time.perf_counter() - t0, 6)
        log.info("end_pass: %d touched rows -> host store (%s)",
                 len(keys), "async" if FLAGS.async_end_pass else "sync")
        return len(keys)

    def shrink(self, delete_threshold: Optional[float] = None,
               decay: Optional[float] = None) -> int:
        """Age the FULL model, not just the window: fence the epilogue (a
        draining write-back's counters must land before they are decayed
        or scored), ``HostStore.shrink`` (RAM and SSD tiers), then
        ``drop_window`` so stale resident rows cannot shadow the aged
        host values. Refused mid-pass."""
        if self.in_pass:
            raise RuntimeError(
                "shrink while a pass is open — the window's updates are "
                "not written back yet; end_pass first")
        self.fence()
        freed = self.host.shrink(delete_threshold=delete_threshold,
                                 decay=decay,
                                 nonclk_coeff=self.cfg.nonclk_coeff,
                                 clk_coeff=self.cfg.clk_coeff)
        self.drop_window()
        return freed

    def drop_window(self) -> None:
        """Invalidate the window (between passes): the next begin_pass
        re-fetches everything from the host store. Required after
        host-store mutations outside the pass protocol. Discards any
        pending stage and zeroes the device rows IN PLACE (released rows
        must read as fresh zero rows; a trainer holding the state keeps
        it)."""
        if self.in_pass:
            raise RuntimeError(
                "drop_window while a pass is open — the window's updates "
                "are not in the host store yet; end_pass first")
        self.fence()  # the dropped window's write-backs land first
        try:
            if self._stage_thread is not None or self._stage is not None:
                self.wait_stage_done()
        finally:
            self._stage = None
            with self.host_lock:
                self.index = self._new_kv()
                self._touched[:] = False
                self.slot_host[:] = 0
                self.state.data.zero_()
                self._reset_dev_index()
