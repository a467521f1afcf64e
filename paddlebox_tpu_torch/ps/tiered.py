"""Tiered sharded PS: HostStore-backed PERSISTENT pass windows per shard —
the port of ``paddlebox_tpu/ps/tiered.py``.

The port's differences: each shard's window is its own ``[C+1, F]``
``TableState`` on its device (``ShardedEmbeddingTable.states``), updated
IN PLACE by training. So ``begin_pass`` scatters the staged delta into
each shard through kernel row 3 (``ps/table.scatter_window_rows``), and
``end_pass`` cannot rely on immutable buffers: it enqueues each shard's
gather of the touched rows (kernel row 4) and its copy to pinned host
memory on the steps' stream before returning, ahead of the next pass's
first push, and the epilogue job waits on the copy's event before it
updates the host store (``ps/table.RowsToHost``). ``drop_window``
zeroes the windows in place. The reference's trace spans and hub
counters wait for the observability layer (ROADMAP queue 1 item 13),
and its multi-process tier (``ps/tiered_multihost.py``) for
``torch.distributed`` (the same item).

The reference's core capability — a table BIGGER than device memory on a
multi-device PS: per pass, ``BuildPull`` fetches the pass's values from
the CPU store (ps_gpu_wrapper.cc:337), ``BuildGPUTask`` fills the per-GPU
HBM pools (:684), training hits only the resident working set, and
``EndPass`` dumps updated values back to the CPU store (:983); the SSD
tier promotes via ``LoadSSD2Mem`` (box_wrapper.cc:1415).

The composition: ``ShardedEmbeddingTable`` keeps its whole routing
machinery (key%N owner shards, the two exchanges of a step) but its
per-shard HBM slice becomes a PASS WINDOW — each shard fronted by a
``HostStore`` (host RAM + disk spill) holding the full model. The pass
lifecycle mirrors ``PassScopedTable``:

    table.stage(ds.pass_keys())     # BuildPull: host fetch per shard
    table.begin_pass()              # BuildGPUTask: scatter → HBM shards
    trainer.adopt_table()
    ...train (streaming or resident)...
    trainer.sync_table(); table.end_pass()   # EndPass: HBM → host

INCREMENTAL windows (the reference's pass machinery is incremental by
construction — BeginFeedPass schedules only SSD→mem *misses* and the HBM
table persists across BeginPass/EndPass windows, box_wrapper.cc:129-186):
rows stay RESIDENT in the HBM shards across passes. ``stage`` fetches
host values only for keys NOT already in the window; ``begin_pass``
reconciles (drops fetched values for keys that became resident
meanwhile), evicts only what capacity demands (write-back of touched
evictees), and device-scatters just the delta; ``end_pass`` gathers and
writes back only rows touched since the last write-back. Host↔HBM wire
per pass is therefore proportional to the working-set DELTA, not its
size.

ASYNC EPILOGUE (ps/epilogue.py; docs/PERFORMANCE.md): ``end_pass``
snapshots the touched-row indices, enqueues the gathers and their
copies to pinned host memory on the steps' stream, clears the flags,
and returns — the wait on the copy + HostStore write-back drain on a single
serialized background worker, overlapping pass N+1's begin/train.
``fence()`` orders every consumer: all HostStore read entry points
drain the epilogue first (HostStore.read_barrier), ``begin_pass``
fences before capacity-pressure eviction (write-back/write-back
ordering), and checkpoint capture / save / shrink / merge_model /
load / drop_window fence too, so the old bit-for-bit delta==full
semantics hold unchanged (``async_end_pass`` off is the oracle). A
write-back failure surfaces at the next fence as
``EndPassWritebackError`` — never as silent row loss. Overlapping
``begin_pass`` reconciles against in-flight write-backs by
construction: its staged values were fetched for keys OUTSIDE the open
window (the write-back set is resident-only), and any fetch that could
observe a stale host row happens behind the read barrier.

OVERLAPPED staging (pre_build_thread, ps_gpu_wrapper.cc:913): ``stage``
is legal while a pass is OPEN. Keys missing from the window are by
definition outside the open pass's write-back set, so fetching them
during training cannot race ``end_pass``; a key that does enter the
window mid-pass (streaming assigns outside the staged set) is caught by
the begin_pass reconcile, which drops its fetched value in favor of the
fresher resident row.

Contract (same as the reference's pass windows): the staged key set must
cover every key the pass's batches touch — keys outside it allocate fresh
zero rows in the window. ``ds.pass_keys()`` provides exactly that set.
Host-tier mutations outside the pass protocol (load/merge_model/shrink)
invalidate residency — the next begin_pass re-fetches everything.

OVERLAPPED PLAN BUILD (preload_into_memory, box_wrapper.h:1142-1156 —
the reference overlaps the ENTIRE next-pass feed with training):
``PassPreloader(build_fn=trainer.build_resident_pass)`` is legal over a
tiered table. The trainer brackets plan builds in ``plan_scope()``:
keys newly assigned by a future pass's routing plan are recorded
PENDING (value-less zero rows, pinned against eviction, not marked
touched); ``stage`` treats them as missing so their host values still
fetch, and ``begin_pass``'s reconcile scatters the staged values into
the plan-baked rows instead of keeping the zeros. The begin_pass
boundary is then reconcile-only — plan construction, host fetch AND
upload all ride the previous pass's training. Capacity contract: the
window must hold the UNION of the open pass's and the planned pass's
working sets (pending rows are pinned; promotion raises when eviction
cannot free enough). With a DEPTH-N preloader (train/device_pass,
FLAGS.preload_depth) several future passes' plans can be pending at
once — plan builds stay serialized in pass order on the preloader
worker, each bracketed in its own ``plan_scope``, and keys recorded by
a later pass's plan stay pinned until THAT pass's begin_pass; the
capacity union extends over every queued pass accordingly.

QUEUED STAGES + ASYNC CAPACITY EVICTION (the tiered pass pipeline,
``train/device_pass.PassPipeline``): ``stage(..., queue=True)``
runs the host fetch on the CALLING thread (the preloader worker) and
appends the result to a stage QUEUE consumed in pass order by
``begin_pass`` — with depth N several future passes' stages sit queued
at once, so the whole begin boundary (plan build, dedup/pack, H2D
wire, host fetch, SSD promote) rides the persistent worker and the
boundary itself is reconcile-only. Eviction moves off that boundary
too: right after each end_pass write-back lands on the epilogue lane
(the same slot as watermark demotion), ``_evict_ahead`` frees the rows
the NEXT queued stage will need — candidates are CLEAN by construction
(the write-back that just landed cleared their touched bits, so the
host tier already holds their values and eviction is index release +
accounting, no D2H). Never evicted: the open pass's working set, any
queued stage's working set, and plan-pending rows (the capacity-union
contract above). Rows dirtied after the end_pass snapshot are skipped
and fall to the EMERGENCY inline path in begin_pass (the pre-pipeline
eviction, with its fence + dirty write-back), reported separately as
``evict_emergency_sec`` vs ``evict_async_sec`` in the pass's
``begin_stall_breakdown``. ``FLAGS.async_capacity_evict=False``
restores fully-inline eviction.
"""
from __future__ import annotations

import collections
import contextlib
import hashlib
import logging
import threading
import time
from typing import Dict, List, Mapping, Optional, Union

import numpy as np

from paddlebox_tpu_torch.config import FLAGS
from paddlebox_tpu_torch.ps.epilogue import PassEpilogue, fence_under_pressure
from paddlebox_tpu_torch.ps.host_store import HostStore
from paddlebox_tpu_torch.ps.kv import make_kv
from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
from paddlebox_tpu_torch.ps.sharded import (Devices, ShardedEmbeddingTable,
                                            _read_raw)
from paddlebox_tpu_torch.ps.table import (RowsToHost, promote_window_delta,
                                          rows_from_store_fields,
                                          scatter_window_rows)
from paddlebox_tpu_torch.resilience import faults

log = logging.getLogger(__name__)


class _ShardStage:
    def __init__(self, keys: List[np.ndarray], new_keys: List[np.ndarray],
                 values: List[Dict[str, np.ndarray]]) -> None:
        self.keys = keys          # per shard: FULL working set (sorted)
        self.new_keys = new_keys  # per shard: keys missing at stage time
        self.values = values      # per shard: host values for new_keys


class TieredShardedEmbeddingTable(ShardedEmbeddingTable):
    """ShardedEmbeddingTable whose HBM shards hold a persistent window of
    the working set; the full model lives in N per-shard HostStores
    (+ disk spill)."""

    # stage() is legal while a pass is open (missing keys are outside
    # the open window's write-back set) — BoxPSHelper.stage_pass gates
    # on this; PassScopedTable carries the same contract single-chip
    supports_overlap_stage = True

    def __init__(self, num_shards: int, mf_dim: int = 8,
                 capacity_per_shard: Optional[int] = None,
                 cfg: Optional[SparseSGDConfig] = None,
                 host_capacity: Optional[int] = None,
                 host_init_rows: int = 1 << 14,
                 req_bucket_min: int = 512,
                 serve_bucket_min: int = 1024,
                 ssd_dir: Optional[str] = None,
                 devices: Devices = "cuda") -> None:
        super().__init__(num_shards, mf_dim=mf_dim,
                         capacity_per_shard=capacity_per_shard, cfg=cfg,
                         req_bucket_min=req_bucket_min,
                         serve_bucket_min=serve_bucket_min, devices=devices)
        # SSD third tier (ps/ssd.py): an explicit ssd_dir pins each
        # shard's tier under <dir>/s<K>; otherwise HostStore follows
        # FLAGS.ssd_dir (auto subdirs) or stays two-tier
        self.hosts = [HostStore(mf_dim, capacity=host_capacity,
                                init_rows=host_init_rows,
                                opt_ext=self.opt_ext,
                                ssd_dir=(f"{ssd_dir}/s{s}" if ssd_dir
                                         else None))
                      for s in range(self.n)]
        self.in_pass = False
        self._stage: Optional[_ShardStage] = None
        self._stage_thread: Optional[threading.Thread] = None
        self._stage_exc: Optional[BaseException] = None
        # QUEUED feed-pass stages (the depth-N pass pipeline,
        # train/device_pass.PassPipeline): stage(queue=True) appends,
        # begin_pass consumes in pass order. Guarded by host_lock.
        self._stage_q: "collections.deque[_ShardStage]" = \
            collections.deque()
        # generation counter: discard_queued_stages / drop_window bump
        # it, so an in-flight queued fetch that straddled the discard
        # cannot append a zombie stage afterwards (its raise rolls the
        # build's plan pins back through the PassPipeline bracket)
        self._stage_gen = 0
        # the IN-FLIGHT queued stage's per-shard keys: its missing
        # split is computed before the (lock-free) host fetch, so the
        # whole working set must be pinned against eviction from that
        # moment — a key it classified as resident and then lost to
        # _evict_ahead (or an emergency promote) would never be
        # re-inserted at its begin_pass. Set/cleared under host_lock.
        self._staging_keys: Optional[List[np.ndarray]] = None
        # the last consumed (≈ open) pass's per-shard working set —
        # pinned against the lane's _evict_ahead; set at stage-queue
        # pop / begin_pass, cleared at end_pass (all under host_lock)
        self._open_keys: List[np.ndarray] = [np.empty(0, np.uint64)
                                             for _ in range(self.n)]
        # async capacity-eviction accounting (cumulative; the lane
        # updates under host_lock, begin_pass diffs per pass)
        self._evict_async_sec = 0.0
        self._evict_async_rows = 0
        self._evict_async_mark = (0.0, 0)
        # async pass epilogue (ps/epilogue): end_pass hands the D2H pull
        # + host write-back to this worker; every HostStore read entry
        # point drains it first (read_barrier), so no consumer observes
        # a partially written-back pass
        self._epilogue = PassEpilogue(name="tiered-endpass")
        for h in self.hosts:
            if h is not None:
                h.read_barrier = self._epilogue.fence
        # keys assigned by a future pass's plan build (plan_scope)
        # whose values haven't been promoted yet: a consolidated sorted
        # array per shard + O(1)-append chunk lists merged lazily by
        # _pending_of (the hot plan-assign path no longer rebuilds the
        # sorted array under host_lock per call)
        self._pending: List[np.ndarray] = [np.empty(0, np.uint64)
                                           for _ in range(self.n)]
        self._pending_chunks: List[List[np.ndarray]] = [
            [] for _ in range(self.n)]
        # per-pass delta accounting (asserted by tests, reported by
        # chip_smoke): resident = working-set keys already in the window,
        # staged = keys fetched+scattered, evicted / evicted_writeback,
        # written_back = rows end_pass shipped to the host tier
        self.last_pass_stats: Dict[str, float] = {}
        self._ssd_mark: Dict[str, float] = {}
        self._last_stage_wait_sec = 0.0

    def pending_rows(self) -> int:
        """Rows a future pass's plan build assigned before their values
        staged: they pin window capacity until their begin_pass (the
        reference reports it as ``obs_stats()["pending"]``; obs_stats
        waits for the observability hub, ROADMAP queue 1 item 13)."""
        with self.host_lock:
            return int(sum(len(self._pending_of(s))
                           for s in range(self.n)))

    # ---- async epilogue fence ----------------------------------------
    def fence(self) -> None:
        """Drain the asynchronous end_pass write-back and surface the
        first failure. Called implicitly by every HostStore read entry
        point (read_barrier), by lifecycle ops, and by checkpoint
        capture; callers that white-box the host tiers directly should
        fence first."""
        self._epilogue.fence()

    def endpass_stats(self) -> Dict[str, float]:
        """Cumulative epilogue accounting (the tests and chip_smoke)."""
        return self._epilogue.stats()

    # ---- SSD third tier (ps/ssd.py; docs/STORAGE.md) -----------------
    def ssd_stats(self) -> Dict[str, float]:
        """Summed disk-tier accounting across shards (chip_smoke);
        empty when no shard has a tier."""
        out: Dict[str, float] = {}
        for h in self.hosts:
            if h is None or h.ssd is None:
                continue
            for k, v in h.ssd.stats().items():
                out[k] = out.get(k, 0.0) + v
        return out

    def spill_manifest(self) -> Optional[dict]:
        """Merged spill manifest over every shard's tier (checkpoint
        integration — train/checkpoint.py records it in the ckpt dir
        and verifies segment digests on restore); None when no tier
        holds rows. Fences first: an in-flight end_pass write-back may
        still trigger a demotion that belongs in this manifest."""
        self.fence()
        shards = {}
        for s, h in enumerate(self.hosts):
            if h is None:
                continue
            m = h.spill_manifest()
            if m is not None:
                shards[str(s)] = m
        if not shards:
            return None
        # merged reference digest: fold the per-shard tier digests in
        # shard order — the one name an artifact manifest records for
        # this whole table's spill state (artifacts.py refs block)
        h = hashlib.sha256()
        for s in sorted(shards, key=int):
            h.update(f"{s}:{shards[s].get('digest', '')}".encode())
        return {"version": 1, "shards": shards,
                "live_rows": sum(m["live_rows"] for m in shards.values()),
                "digest": h.hexdigest()}

    def rows_digest(self) -> str:
        """Full-model fingerprint: the shard host stores' read-only
        ``rows_digest`` folded in shard order (fences first so every
        in-flight write-back is included). Publish gates compare a
        consumer's adopted state against this."""
        self.fence()
        h = hashlib.sha256()
        for s, host in enumerate(self.hosts):
            if host is None:
                continue
            h.update(f"{s}:{host.rows_digest()}".encode())
        return h.hexdigest()

    def has_spilled_rows(self) -> bool:
        """Cheap guard for the preloader's promote prefetch: True when
        any shard's tier holds live rows."""
        return any(h is not None and h.ssd is not None and len(h.ssd)
                   for h in self.hosts)

    def prefetch_promote(self, pass_keys: np.ndarray) -> int:
        """LoadSSD2Mem prefetch for a FUTURE pass, run from the depth-N
        ``PassPreloader`` build stage (train/sharded.build_resident_pass):
        promote the pass keys' spilled rows SSD→host-RAM on the
        preloader worker, overlapping the open pass's training — the
        later ``stage`` fetch then hits RAM instead of stalling
        ``begin_pass`` on segment reads (chip_smoke phase 15a times
        both). Rows land in the HOST tier only;
        window promotion stays with begin_pass's reconcile."""
        total = 0
        for s, ks in enumerate(self._split_by_owner(pass_keys)):
            h = self.hosts[s]
            if h is None or h.ssd is None or not len(h.ssd) \
                    or not len(ks):
                continue
            h._barrier()  # order behind in-flight write-backs
            with h._lock:
                missing = h.index.lookup(ks) < 0
            if missing.any():
                total += h._promote(ks[missing], protect=ks)
        if total:
            log.info("prefetch_promote: %d spilled rows -> host RAM "
                     "(overlapped)", total)
        return total

    # ---- async capacity eviction (the epilogue-lane slot) -------------
    def pin_working_set(self, pass_keys: np.ndarray) -> None:
        """Pin a FUTURE pass's working set against eviction BEFORE its
        plan build starts (PassPipeline does this around build+stage):
        the build bakes row ids for RESIDENT keys too — not just the
        plan-pending new ones — so an eviction between the plan's row
        lookup and the stage() pin would leave the staged wire
        addressing a stale (possibly reassigned) row. The pin is the
        same ``_staging_keys`` slot the queued stage fetch uses;
        ``stage(queue=True)`` for the same keys keeps it, and its
        completion (or ``unpin_working_set`` on a failed build)
        releases it — from then on the queued stage itself carries the
        pin."""
        per_shard = self._split_by_owner(pass_keys)
        with self.host_lock:
            if self._staging_keys is not None:
                raise RuntimeError(
                    "a working set is already pinned — pipeline builds "
                    "serialize on one worker")
            self._staging_keys = per_shard

    def unpin_working_set(self) -> None:
        """Release a ``pin_working_set`` pin (idempotent) — the failed-
        build path; a completed ``stage(queue=True)`` releases it
        itself."""
        with self.host_lock:
            self._staging_keys = None

    def _queued_protect(self, s: int) -> Optional[np.ndarray]:
        """Shard s's eviction-pinned keys beyond the current want set
        (caller holds host_lock): the union of every QUEUED stage's
        working set plus the IN-FLIGHT stage's (_staging_keys) —
        evicting one would invalidate the missing-split its stage
        already computed (the capacity contract is the union over
        open + queued passes). THE single source of the queued-pin
        rule — _evict_ahead and the inline promote both use it."""
        arrs = [q.keys[s] for q in self._stage_q if len(q.keys[s])]
        if self._staging_keys is not None \
                and len(self._staging_keys[s]):
            arrs.append(self._staging_keys[s])
        if not arrs:
            return None
        return arrs[0] if len(arrs) == 1 else \
            np.unique(np.concatenate(arrs))

    def _evict_ahead(self) -> int:
        """Capacity-pressure eviction for the NEXT queued pass, run ON
        the epilogue lane right after an end_pass write-back lands (the
        watermark-demotion slot — strictly ordered after the
        write-back). Every candidate's latest value is already in the
        host tier (the write-back that just landed cleared its touched
        bit), so eviction here is index release + accounting — no D2H
        gather, no host write rides the lane. Clean rows only; anything
        dirtied since the snapshot keeps its row and falls to the
        emergency inline path. Pinned (never evicted): the open pass's
        working set (``_open_keys``), every queued stage's working set,
        and plan-pending rows. No-op without queued stages or with
        ``FLAGS.async_capacity_evict=False``."""
        if not FLAGS.async_capacity_evict:
            return 0
        freed_total = 0
        with self.host_lock:
            # timer starts INSIDE the lock: lane lock-wait behind a
            # main-thread promote is not eviction work
            t0 = time.perf_counter()
            if not self._stage_q:
                return 0
            head = self._stage_q[0]
            for s in range(self.n):
                # rows the head stage will allocate at its begin_pass:
                # its still-missing keys (pending keys own rows already)
                need = int((self.indexes[s].lookup(head.new_keys[s])
                            < 0).sum())
                freed_total += self._release_clean(
                    s, len(self.indexes[s]) + need - self.capacity)
            if freed_total:
                self._reset_dev_indexes()
            self._evict_async_rows += freed_total
            self._evict_async_sec += time.perf_counter() - t0
        if freed_total:
            # the evict-ahead counter waits for the hub (ROADMAP queue 1
            # item 13)
            log.info("evict_ahead: %d clean rows released on the "
                     "epilogue lane for the next queued pass",
                     freed_total)
        return freed_total

    def _release_clean(self, s: int, overflow: int) -> int:
        """Release up to ``overflow`` CLEAN rows of shard s (caller holds
        host_lock): index release and accounting, no device read. Pinned
        (never released): the open pass's working set (``_open_keys``),
        every queued and in-flight stage's (``_queued_protect``) and the
        plan-pending rows. Returns the rows released."""
        if overflow <= 0:
            return 0
        live_keys, live_rows = self.indexes[s].items()
        cand = ~self._touched[s][live_rows]   # clean rows only
        pin = [self._open_keys[s]]
        qp = self._queued_protect(s)
        if qp is not None:
            pin.append(qp)
        pend = self._pending_of(s)
        if len(pend):
            pin.append(pend)
        pin = [p for p in pin if len(p)]
        if pin:
            cand &= ~np.isin(live_keys, np.concatenate(pin))
        ck = live_keys[cand][:overflow]
        if not len(ck):
            return 0
        freed = self.indexes[s].release(ck)
        self._touched[s][freed] = False
        return len(ck)

    def _plan_headroom(self, s: int, need: int) -> None:
        """Room for ``need`` plan-assigned rows of shard s (caller holds
        host_lock; the plan-depth branch of ``_shard_rows`` calls it before
        its assign). The port's addition to the reference: a plan build
        assigns a future pass's new keys before that pass's begin_pass,
        so begin_pass never sees them missing and would never evict, and
        a window smaller than the model would fill up at the first plan
        that does not fit beside the resident rows. So the build releases
        clean, unpinned rows itself (``_release_clean``: the open pass's,
        the queued passes', the pending rows and the build's own pinned
        working set stay), on the builder's thread, booked as async
        eviction. A row released here may still have its end_pass copy in
        flight: that copy was enqueued on the steps' stream before the
        begin_pass scatter that will overwrite the row, and any fetch of
        its key fences the epilogue first. Only with a pinned working set
        (``pin_working_set``, which ``PassPipeline`` takes before every
        build): without it, a resident key this build already looked up
        could lose its row to a later batch of the same build."""
        if not FLAGS.async_capacity_evict or self._staging_keys is None:
            return
        t0 = time.perf_counter()
        freed = self._release_clean(
            s, len(self.indexes[s]) + need - self.capacity)
        if freed:
            self._reset_dev_indexes()
            self._evict_async_rows += freed
            self._evict_async_sec += time.perf_counter() - t0

    def discard_queued_stages(self) -> int:
        """Drop every queued feed-pass stage (pipeline shutdown — e.g.
        PassPipeline.drain when queued passes will never begin).
        Releases the plan-pending rows those stages' builds assigned
        (the _rollback_plan rule: untrained rows only — a row whose
        updates await write-back follows the normal resident rules) so
        abandoned stages never pin window capacity. Returns the number
        of stages discarded."""
        with self.host_lock:
            n = len(self._stage_q)
            for q in self._stage_q:
                for s in range(self.n):
                    pend = self._pending_of(s)
                    if not len(pend):
                        continue
                    ks = q.keys[s][np.isin(q.keys[s], pend)]
                    if not len(ks):
                        continue
                    rows = self.indexes[s].lookup(ks)
                    ok = rows >= 0
                    ks_ok, rows_ok = ks[ok], rows[ok]
                    untouched = ~self._touched[s][rows_ok]
                    if untouched.any():
                        self.indexes[s].release(ks_ok[untouched])
                        self._reset_dev_indexes()
                    self._unpin_pending(s, ks)
            self._stage_q.clear()
            self._stage_gen += 1   # reject straddling in-flight fetches
        return n

    def _demote_after_writeback(self) -> None:
        """Watermark demotion + compaction, run ON the epilogue lane
        right after an end_pass write-back lands (so demote IO never
        blocks host_lock and is strictly ordered AFTER the write-back —
        rows the pass just touched are marked and never selected).
        barrier=False: fencing from the single-lane worker itself would
        deadlock. (The reference's ``ssd.maintain`` trace span waits for
        the observability layer, ROADMAP queue 1 item 13.)"""
        for h in self.hosts:
            if h is not None and h.ssd is not None:
                h.demote_to_watermark(barrier=False)
                h.ssd.maybe_compact()

    # ---- overlapped plan builds (preload_into_memory) ----------------
    @contextlib.contextmanager
    def plan_scope(self):
        """Bracket a FUTURE pass's routing-plan build (the preloader's
        background thread): new-key assigns by THIS thread inside the
        scope become PENDING zero rows that the next begin_pass
        reconciles with their staged values (see module docstring).
        A build that RAISES rolls its pending records back — its pass
        will never open, and leaked pendings would pin window capacity
        forever (eviction excludes pending rows)."""
        tls = self._plan_tls
        tls.depth = getattr(tls, "depth", 0) + 1
        outer_added = getattr(tls, "added", None)
        tls.added = [[] for _ in range(self.n)]
        try:
            yield
            if outer_added is not None:  # propagate to the outer scope
                for s in range(self.n):
                    # chunk OBJECTS propagate (identity is what the
                    # outer scope's rollback removes from the queue)
                    outer_added[s].extend(tls.added[s])
        except BaseException:
            self._rollback_plan(tls.added)
            raise
        finally:
            tls.depth -= 1
            tls.added = outer_added

    def _rollback_plan(self, added_chunks: List[List[np.ndarray]]) -> None:
        """Undo a failed plan build's pending records. The expensive
        set-differences run OUTSIDE host_lock: lock pass 1
        drops this scope's unmerged chunks (by object identity) and
        releases the build's untrained rows; the consolidated-array
        filter computes unlocked and lands with a pointer swap, with an
        identity check catching a racing consolidation."""
        added = [np.unique(np.concatenate(ch)) if ch
                 else np.empty(0, np.uint64) for ch in added_chunks]
        own = [set(map(id, ch)) for ch in added_chunks]
        snap: List[Optional[np.ndarray]] = [None] * self.n
        with self.host_lock:
            for s in range(self.n):
                ks = added[s]
                if not len(ks):
                    continue
                self._pending_chunks[s] = [
                    c for c in self._pending_chunks[s]
                    if id(c) not in own[s]]
                snap[s] = self._pending[s]
                # ALSO release the rows this build assigned:
                # unpinned-but-still-assigned keys would read as
                # resident at a later pass's reconcile and silently
                # keep their zero rows over the staged values.
                # Keys a concurrent streaming assign trained
                # meanwhile (touched) stay — releasing a row whose
                # updates await write-back would corrupt it; they
                # follow the normal resident-is-fresher rule.
                rows = self.indexes[s].lookup(ks)
                ok = rows >= 0
                ks, rows = ks[ok], rows[ok]
                untouched = ~self._touched[s][rows]
                if untouched.any():
                    self.indexes[s].release(ks[untouched])
                    self._reset_dev_indexes()
        filtered: List[Optional[np.ndarray]] = [None] * self.n
        for s in range(self.n):
            p = snap[s]
            if p is None or not len(p) or not len(added[s]):
                filtered[s] = p
                continue
            filtered[s] = p[~np.isin(p, added[s])]
        with self.host_lock:
            for s in range(self.n):
                if snap[s] is None:
                    continue
                if self._pending[s] is snap[s]:
                    self._pending[s] = filtered[s]
                else:  # a reader consolidated between the locks — redo
                    self._pending[s] = self._pending[s][
                        ~np.isin(self._pending[s], added[s])]

    def _note_plan_assigned(self, s: int, new_keys: np.ndarray) -> None:
        # under host_lock (prepare_global holds it around the assign).
        # O(1) list-append: the old per-call np.union1d rebuilt the
        # sorted pending array on the preloader thread while holding
        # host_lock, serializing against the open pass's streaming
        # assigns; readers consolidate once via _pending_of
        self._pending_chunks[s].append(new_keys)
        added = getattr(self._plan_tls, "added", None)
        if added is not None:
            added[s].append(new_keys)

    def _pending_of(self, s: int) -> np.ndarray:
        """Shard s's consolidated sorted pending keys (caller holds
        host_lock): lazily merges the plan-assign chunks, once per
        reader instead of once per assign."""
        ch = self._pending_chunks[s]
        if ch:
            self._pending[s] = np.union1d(self._pending[s],
                                          np.concatenate(ch))
            ch.clear()
        return self._pending[s]

    def _unpin_pending(self, s: int, keys: np.ndarray) -> None:
        """Remove ``keys`` from shard s's pending set (under host_lock):
        their values were promoted (begin_pass) or written back
        (end_pass), so the usual resident-is-fresher reconcile and
        eviction rules apply to them again."""
        pend = self._pending_of(s)
        if len(pend) and len(keys):
            self._pending[s] = pend[~np.isin(pend, keys)]

    # ------------------------------------------------------------------
    def _gather_rows_sync(self, s: int, rows: np.ndarray) -> np.ndarray:
        """Blocking [k, feat] row read of shard s (the dirty evictees of
        begin_pass, kernel row 4): enqueued on the steps' stream ahead of
        the scatter that overwrites the rows, and waited for here."""
        return RowsToHost(self.states[s], rows).wait()

    def _split_by_owner(self, keys: np.ndarray) -> List[np.ndarray]:
        keys = np.unique(np.ascontiguousarray(keys, np.uint64))
        owners = (keys % np.uint64(self.n)).astype(np.int64)
        return [keys[owners == s] for s in range(self.n)]

    def _logical_rows(self, vals: Dict[str, np.ndarray]) -> np.ndarray:
        return rows_from_store_fields(vals, self.mf_dim, self.opt_ext)

    # ---- feed-pass staging (BuildPull, ps_gpu_wrapper.cc:337) ----
    def _fetch_stage_values(self, s: int, new_keys: np.ndarray):
        """Host values for shard s's missing keys (the seam the
        multi-process table of ROADMAP queue 1 item 13 overrides)."""
        return self.hosts[s].fetch(new_keys)

    def stage(self, pass_keys: np.ndarray, background: bool = True,
              queue: bool = False) -> None:
        """Fetch host values for the pass keys NOT already resident in
        the HBM window. Legal while a pass is open (the overlapped
        pre_build_thread, ps_gpu_wrapper.cc:913): missing keys are
        outside the open window, so the open pass's end_pass write-back
        cannot touch them; any key that becomes resident between stage
        and begin_pass has its fetched value dropped by the reconcile.

        ``queue=True`` (the depth-N pass pipeline): the fetch runs on
        the CALLING thread (the preloader worker — already background
        to training) and the completed stage is APPENDED to a queue
        that ``begin_pass`` consumes in pass order, so several future
        passes can sit staged at once. The capacity contract extends
        to the union over open + queued passes; queued working sets
        are pinned against eviction until their own begin_pass. A
        fetch failure queues nothing (the caller — the preload worker
        — holds and re-raises it at the consuming ``wait()``)."""
        if queue and background:
            raise ValueError("queued stages fetch on the calling thread "
                             "(background staging is the single-slot "
                             "protocol)")
        if self._stage_thread is not None or self._stage is not None:
            raise RuntimeError("a feed pass is already staging")
        if self._stage_q and not queue:
            raise RuntimeError(
                "queued feed-pass stages are pending — single-slot "
                "stage() cannot interleave with the stage queue "
                "(consume the queue via begin_pass, or "
                "discard_queued_stages())")
        per_shard = self._split_by_owner(pass_keys)
        for s, ks in enumerate(per_shard):
            if len(ks) > self.capacity:
                raise ValueError(
                    f"shard {s} working set ({len(ks)}) exceeds "
                    f"capacity_per_shard ({self.capacity})")
        with self.host_lock:
            if queue and self._staging_keys is not None \
                    and not all(np.array_equal(a, b) for a, b in
                                zip(self._staging_keys, per_shard)):
                # a pre-build pin_working_set for THIS pass is fine
                # (PassPipeline pins before the plan build); a
                # different in-flight stage is a protocol violation
                raise RuntimeError(
                    "a different queued feed-pass stage is already "
                    "pinned/fetching — queued stages serialize on one "
                    "worker")
            # "missing" includes PENDING plan rows: they sit in the
            # index but hold zero values, so their host values must
            # still fetch (begin_pass scatters them at the reconcile)
            new = []
            for s in range(self.n):
                ks = per_shard[s]
                miss = self.indexes[s].lookup(ks) < 0
                pend = self._pending_of(s)
                if len(pend):
                    miss |= np.isin(ks, pend)
                new.append(ks[miss])
            if queue:
                # pin the working set for the whole fetch: the missing
                # split above is only valid while no eviction touches
                # these keys (see _staging_keys)
                self._staging_keys = per_shard
                gen = self._stage_gen
        if queue:
            try:
                # queued feed-pass fetch on the preloader worker (the
                # reference's "pass.stage" trace span waits for the
                # observability layer, ROADMAP queue 1 item 13)
                vals = [self._fetch_stage_values(s, new[s])
                        for s in range(self.n)]
                with self.host_lock:
                    if self._stage_gen != gen:
                        raise RuntimeError(
                            "the stage queue was discarded while this "
                            "feed-pass fetch was in flight — the pass "
                            "will never begin")
                    self._stage_q.append(
                        _ShardStage(per_shard, new, vals))
            finally:
                with self.host_lock:
                    self._staging_keys = None
            return
        self._stage_exc = None

        def run() -> None:
            try:
                vals = [self._fetch_stage_values(s, new[s])
                        for s in range(self.n)]
                self._stage = _ShardStage(per_shard, new, vals)
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

    # ---- pass window (BuildGPUTask/EndPass, ps_gpu_wrapper.cc:684,983) --
    def _resolve_stage(self, pass_keys: Optional[np.ndarray]) -> _ShardStage:
        """Shared begin_pass prologue: consume the HEAD of the stage
        queue (pipeline mode), the pending single-slot stage (after
        validating its keys against ``pass_keys``), or stage
        synchronously."""
        if self.in_pass:
            raise RuntimeError("begin_pass while a pass is open")
        t0 = time.perf_counter()
        with self.host_lock:
            if self._stage_q:
                st = self._stage_q.popleft()
                if pass_keys is not None:
                    want = self._split_by_owner(pass_keys)
                    if not all(np.array_equal(a, b) for a, b in
                               zip(st.keys, want)):
                        self._stage_q.appendleft(st)
                        raise RuntimeError(
                            "begin_pass keys differ from the HEAD "
                            "queued stage — the pipeline consumes "
                            "stages strictly in pass order")
                # the consumed pass's working set is pinned against the
                # lane's _evict_ahead from this moment (atomically with
                # the pop, so the lane can never see it unprotected)
                self._open_keys = st.keys
                st.from_queue = True  # begin_pass restores it on failure
                self._last_stage_wait_sec = time.perf_counter() - t0
                return st
        if pass_keys is not None:
            if self._stage_thread is not None or self._stage is not None:
                self.wait_stage_done()
                want = self._split_by_owner(pass_keys)
                if (self._stage is None
                        or not all(np.array_equal(a, b) for a, b in
                                   zip(self._stage.keys, want))):
                    raise RuntimeError(
                        "begin_pass keys differ from the staged key set")
            else:
                self.stage(pass_keys, background=False)
        self.wait_stage_done()
        # critical-path stall spent WAITING on the stage (host fetch +
        # any SSD promote it triggered) — near zero when the stage
        # overlapped the previous pass's training (the begin_stall
        # breakdown; docs/STORAGE.md)
        self._last_stage_wait_sec = time.perf_counter() - t0
        st = self._stage
        if st is None:
            raise RuntimeError("begin_pass with nothing staged")
        self._stage = None
        return st

    def begin_pass(self, pass_keys: Optional[np.ndarray] = None) -> int:
        """Promote the staged (or given) working set into the HBM shards:
        reconcile the stage against the live window, evict only what
        capacity demands, scatter only the genuinely new rows. Returns
        the number of working-set rows across shards. The staged rows go
        into each shard's window by kernel row 3 (``scatter_window_rows``,
        in place on the steps' stream). (The reference's ``pass.begin``
        trace span waits for the observability layer, ROADMAP queue 1
        item 13.)"""
        # promote attribution spans since the PREVIOUS begin_pass (the
        # overlapped stage promotes during the previous pass's train)
        ssd0 = self._ssd_mark
        st = self._resolve_stage(pass_keys)

        stats = dict(resident=0, staged=0, evicted=0, evicted_writeback=0,
                     written_back=0)
        row_l: List[np.ndarray] = []
        val_l: List[np.ndarray] = []
        total = 0
        fence_sec = 0.0
        t_evict0 = time.perf_counter()
        self.host_lock.acquire()
        try:
            # capacity pressure → promote may EVICT: a dirty evictee's
            # write-back and pass N's in-flight epilogue write-back
            # could reorder on the host store, and a released row's
            # stale host value must be fully landed before a later
            # stage re-fetches it — fence first (the common
            # non-evicting boundary stays fence-free). The shared
            # fence-outside-the-lock loop (ps/epilogue.
            # fence_under_pressure) re-checks under this same lock
            # hold. With the async lane eviction this is the EMERGENCY
            # path — the lane usually freed the rows already.
            fence_sec = fence_under_pressure(
                self.host_lock, self._epilogue.fence,
                lambda: any(len(self.indexes[s]) + len(st.new_keys[s])
                            > self.capacity for s in range(self.n)))
            self._open_keys = st.keys
            for s in range(self.n):
                rows_new, still, st_s = promote_window_delta(
                    self.indexes[s], self._touched[s], self.capacity,
                    st.keys[s], st.new_keys[s],
                    gather_rows=lambda rs, s=s: self._gather_rows_sync(
                        s, rs),
                    writeback=lambda ks, rs, sub, s=s:
                        self.hosts[s].update_rows(ks, sub),
                    pending=self._pending_of(s),
                    protect=self._queued_protect(s))
                # pending keys promoted by THIS pass leave the pending
                # set; keys a concurrent plan build (the pass after
                # next) recorded stay pinned until their own begin
                self._unpin_pending(s, st.keys[s])
                ins_vals = {f: v[still] for f, v in st.values[s].items()}
                row_l.append(rows_new)
                val_l.append(self._logical_rows(ins_vals))
                for k in st_s:
                    stats[k] = stats.get(k, 0) + st_s[k]
                total += len(st.keys[s])
            # promote assigned/released kv rows behind the device
            # mirrors' back — re-seed (or degrade) on next prepare
            self._reset_dev_indexes()
            for s in range(self.n):
                scatter_window_rows(self.states[s], row_l[s], val_l[s])
            ev_sec, ev_rows = self._evict_async_sec, self._evict_async_rows
        except BaseException:
            # a begin that fails AFTER consuming a queued stage must
            # not strand the pipeline's bookkeeping: restore the stage
            # to the queue head (its pins release via drain/
            # discard_queued_stages, and the driver's key queue stays
            # aligned) and drop the open-pass pin. NOTE: promote may
            # have partially applied before the raise — the restored
            # stage exists for clean shutdown/diagnosis, not blind
            # retry.
            if getattr(st, "from_queue", False):
                self._stage_q.appendleft(st)
            self._open_keys = [np.empty(0, np.uint64)
                               for _ in range(self.n)]
            raise
        finally:
            self.host_lock.release()
        self.in_pass = True
        # begin_stall breakdown (chip_smoke phase 15): stage wait on the
        # critical path, evict+scatter time, and the SSD promote
        # seconds this pass's staging incurred (with its critical-path
        # share — overlapped promotes show promote_sec > 0 with
        # promote_wait_sec ~ 0). Eviction attribution splits into the
        # lane's overlapped work since the previous begin
        # (evict_async_*) and the inline emergency remainder
        # (evict_emergency_sec = fence wait + promote eviction wall).
        stats["stage_wait_sec"] = round(
            self._last_stage_wait_sec, 6)
        stats["evict_scatter_sec"] = round(
            time.perf_counter() - t_evict0, 6)
        stats["evict_emergency_sec"] = round(
            fence_sec + stats.pop("evict_sec", 0.0), 6)
        mark_sec, mark_rows = self._evict_async_mark
        self._evict_async_mark = (ev_sec, ev_rows)
        stats["evict_async_sec"] = round(ev_sec - mark_sec, 6)
        stats["evict_async_rows"] = int(ev_rows - mark_rows)
        ssd1 = self.ssd_stats()
        self._ssd_mark = ssd1
        for k, ok in (("promote_sec", "ssd_promote_sec"),
                      ("promote_wait_sec", "ssd_promote_wait_sec"),
                      ("promoted_rows", "ssd_promoted_rows")):
            if ssd1:
                stats[ok] = round(ssd1.get(k, 0.0) - ssd0.get(k, 0.0), 6)
        self.last_pass_stats = stats
        log.info("begin_pass: %d working-set rows (%d resident, %d staged, "
                 "%d evicted) across %d HBM shards", total,
                 stats["resident"], stats["staged"], stats["evicted"],
                 self.n)
        return total

    def end_pass(self) -> int:
        """Close the pass and WRITE BACK ASYNCHRONOUSLY: snapshot the
        touched-row indices, enqueue each shard's gather (kernel row 4)
        and its copy to pinned host memory on the steps' stream, clear
        the flags, and hand the wait on the copy + HostStore update to
        the background epilogue: end_pass returns in enqueue time, and
        pass N+1's begin/train overlap the drain (``fence()`` orders
        every consumer; see ps/epilogue.py). The window is updated in
        place, so the copies are enqueued before the next pass's first
        push. ``FLAGS.async_end_pass=False`` runs the same job inline
        (bit for bit the same model). The gather is touched-rows-sized,
        not window-sized; the window stays resident for the next
        pass's reuse."""
        if not self.in_pass:
            raise RuntimeError("end_pass without begin_pass")
        total = 0
        t0 = time.perf_counter()
        t_dispatch = 0.0
        jobs: List[tuple] = []
        with self.host_lock:
            for s in range(self.n):
                keys, rows = self.indexes[s].items()
                m = self._touched[s][rows]
                keys, rows = keys[m], rows[m]
                if len(rows):
                    # the gather (kernel row 4) and its copy to pinned
                    # host memory are enqueued NOW on the steps' stream,
                    # ahead of the next pass's first push (the window is
                    # updated in place); the worker waits on the copy's
                    # event, never the main thread
                    t_d = time.perf_counter()
                    copy = RowsToHost(self.states[s], rows)
                    t_dispatch += time.perf_counter() - t_d
                    jobs.append((s, keys, copy))
                    self._touched[s][rows] = False
                    # a PENDING key that trained anyway (a key outside
                    # its pass's staged set) is being written back — the
                    # host value is authoritative again, so the usual
                    # resident-is-fresher reconcile may resume for it
                    self._unpin_pending(s, keys)
                total += len(rows)
            # nothing is open between passes: the closed pass's set no
            # longer pins the lane's _evict_ahead (its un-shared rows
            # are exactly the right victims for the next queued pass)
            self._open_keys = [np.empty(0, np.uint64)
                               for _ in range(self.n)]
        self.in_pass = False
        self.last_pass_stats["written_back"] = total

        tiered_ssd = any(h is not None and h.ssd is not None
                         for h in self.hosts)
        if jobs or tiered_ssd or self._stage_q:
            def run(jobs=jobs) -> None:
                for s, keys, copy in jobs:
                    # chaos seam: a mid-write-back failure must surface
                    # at the fence, never as silent row loss
                    faults.inject("endpass.writeback", op=f"shard{s}",
                                  shard=s, rows=len(keys))
                    self.hosts[s].update_rows(keys, copy.wait())
                # async capacity eviction rides the SAME job, strictly
                # AFTER this pass's rows landed (their touched bits just
                # cleared, so candidates are clean and eviction is pure
                # index release): free the rows the next queued pass
                # will need so its begin_pass pays no inline eviction
                self._evict_ahead()
                # watermark demotion rides the SAME job: strictly after
                # this pass's rows landed and are marked touched —
                # selection is untouched-first, so a row whose write-back
                # just landed spills only when nothing colder exists
                # (and then its touched bit rides the tier). Off the
                # critical path; disk IO outside host_lock.
                self._demote_after_writeback()

            if FLAGS.async_end_pass:
                # (the reference's end_submit trace span and its link to
                # the write-back span wait for ROADMAP queue 1 item 13)
                self._epilogue.submit(run, label="end_pass")
            else:
                run()
        # submit-time audit: the ONLY synchronous
        # portion is touched-row snapshot + bucketed D2H dispatch —
        # split out so a regressed boundary names which half grew
        self.last_pass_stats["end_pass_submit_sec"] = round(
            time.perf_counter() - t0, 6)
        self.last_pass_stats["end_pass_dispatch_sec"] = round(
            t_dispatch, 6)
        log.info("end_pass: %d touched rows -> %d host stores (%s)",
                 total, self.n,
                 "async" if FLAGS.async_end_pass else "sync")
        return total

    def drop_window(self) -> None:
        """Invalidate HBM residency (between passes): the next begin_pass
        re-fetches everything from the host tier. Called automatically
        after host-tier mutations outside the pass protocol
        (load/merge_model/shrink), whose updates would otherwise be
        shadowed by stale resident rows; also the recovery entry point
        after a host-tier restore (LoadSSD2Mem, box_wrapper.cc:1415).

        Discards any pending stage (its fetched values predate the
        host-tier mutation, and its resident/missing split predates the
        residency drop) and zeroes the device rows (released rows must
        read as fresh zero rows if a later mid-pass assign reuses them
        before a scatter initializes them)."""
        self._no_pass("drop_window")
        self.fence()  # the dropped window's write-backs must land first
        try:
            if self._stage_thread is not None or self._stage is not None:
                self.wait_stage_done()
        finally:
            # the reset must run even when the pending stage raised —
            # callers that swallow the stage error would otherwise keep
            # pre-mutation rows resident, shadowing the host tier
            self._stage = None
            with self.host_lock:
                # queued stages predate the mutation too — their
                # fetched values and missing-splits are stale (the gen
                # bump also rejects any fetch still in flight)
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
                # in place: a trainer holding the states keeps them
                for st in self.states:
                    st.data.zero_()
                self._reset_dev_indexes()

    def _no_pass(self, what: str) -> None:
        if self.in_pass:
            raise RuntimeError(
                f"{what} while a pass is open — the window's updates are "
                "not in the host stores yet; end_pass first")

    # ---- lifecycle on the FULL (host-tier) model ------------------------
    def feature_count(self) -> int:
        return sum(len(h) for h in self.hosts)

    def save_base(self, path: str, clear_touched: bool = True) -> int:
        """Full model dump, single file, ShardedEmbeddingTable._dump
        format (n + keys_s/field_s blocks, + opt_ext_s) — includes
        disk-spilled rows (SaveBase, box_wrapper.cc:1383).
        ``clear_touched=False`` = staged artifact publish: the delta
        bookkeeping survives until the publish commits
        (``clear_touched_flags`` is the post-commit half)."""
        self._no_pass("save_base")
        blobs: Dict[str, np.ndarray] = {}
        total = 0
        for s, hs in enumerate(self.hosts):
            keys, fields = hs.export_rows(clear_touched=clear_touched)
            blobs[f"keys_{s}"] = keys
            for f, v in fields.items():
                blobs[f"{f}_{s}"] = v
            total += len(keys)
        np.savez_compressed(path, n=self.n, **blobs)
        log.info("tiered save_base: %d rows -> %s", total, path)
        return total

    def save_delta(self, path: str, clear_touched: bool = True) -> int:
        """Rows written back since the last save ("xbox delta");
        ``clear_touched=False`` = staged artifact publish (save_base)."""
        self._no_pass("save_delta")
        blobs: Dict[str, np.ndarray] = {}
        total = 0
        for s, hs in enumerate(self.hosts):
            keys, fields = hs.export_rows(delta=True,
                                          clear_touched=clear_touched)
            blobs[f"keys_{s}"] = keys
            for f, v in fields.items():
                blobs[f"{f}_{s}"] = v
            total += len(keys)
        np.savez_compressed(path, n=self.n, **blobs)
        log.info("tiered save_delta: %d rows -> %s", total, path)
        return total

    def clear_touched_flags(self) -> None:
        """Post-commit half of a staged publish: clear every shard's
        delta bookkeeping (RAM + disk tier). Fences first."""
        self.fence()
        for hs in self.hosts:
            if hs is not None:
                hs.clear_touched_flags()

    def load(self, path: Union[str, Mapping[str, np.ndarray]],
             merge: bool = False) -> int:
        self._no_pass("load")
        blob = _read_raw(path)
        total = 0
        # shard-splitting shared with the parent (same file formats)
        for s, (keys, fields) in enumerate(self._file_per_shard(blob)):
            total += self.hosts[s].import_rows(keys, fields, merge=merge)
        self.drop_window()  # resident rows may shadow the loaded values
        return total

    def merge_model(self, path: Union[str, Mapping[str, np.ndarray]]
                    ) -> int:
        """MergeModel on the full host tier (box_wrapper.h:801-803):
        shared keys accumulate show/clk/delta_score, keep live weights;
        unseen keys insert wholesale. merge_models is inherited — the
        parent loop dispatches back to these overrides."""
        self._no_pass("merge_model")
        blob = _read_raw(path)
        total = 0
        for s, (keys, fields) in enumerate(self._file_per_shard(blob)):
            total += self.hosts[s].merge_model_rows(keys, fields)
        self.drop_window()
        return total

    def shrink(self, delete_threshold: Optional[float] = None,
               decay: Optional[float] = None) -> int:
        """ShrinkTable over every shard's host store (box_wrapper.h:638)."""
        self._no_pass("shrink")
        self.fence()  # draining end_pass write-backs must land before
        # aging — per-host _barrier repeats the audit, but fencing once
        # here keeps the contract visible at the entry point
        freed = sum(h.shrink(delete_threshold=delete_threshold, decay=decay,
                             nonclk_coeff=self.cfg.nonclk_coeff,
                             clk_coeff=self.cfg.clk_coeff)
                    for h in self.hosts)
        self.drop_window()  # resident rows hold pre-decay stats
        return freed

    def spill_cold(self, path_prefix: str, threshold: float) -> int:
        """Move cold rows of every shard to disk-tier files
        ``{path_prefix}.s{K}.npz`` (the host-RAM ↔ SSD boundary). Values
        are unchanged, so HBM residency stays valid — spilled keys that
        are still resident simply keep serving from the window."""
        self._no_pass("spill_cold")
        return sum(h.spill_cold(f"{path_prefix}.s{s}.npz", threshold,
                                nonclk_coeff=self.cfg.nonclk_coeff,
                                clk_coeff=self.cfg.clk_coeff)
                   for s, h in enumerate(self.hosts))
