"""Host-RAM backing store for features beyond the card's pass window —
the port's copy of ``paddlebox_tpu/ps/host_store.py`` (host numpy only,
over the port's ``ps/kv.make_kv``, so it takes the native index route).
Its save files are the format ``EmbeddingTable.load`` reads.

Reference capability: the BoxPS closed core keeps the full table on
host-mem+SSD and promotes each pass's working set into GPU HBM
(``BeginFeedPass``/``BeginPass``/``EndPass``, fleet/box_wrapper.cc:129-186);
the open HeterPS analogue is PSGPUWrapper's build pipeline — ``BuildPull``
fetching values from the CPU PS and ``BuildGPUTask`` filling HBM pools
(ps_gpu_wrapper.cc:337,684), with ``EndPass`` dumping updated values back
(:983). PSCore's ``memory_sparse_table``/``ssd_sparse_table`` define the
save/shrink semantics.

The design: one numpy SoA per feature field, grown geometrically
up to a hard capacity, fronted by the native C++ key→row index (ps/kv.py).
Fetch/update are fully vectorized (no per-key python). The pass working
set is fetched here and scattered into the statically-shaped device
TableState by PassScopedTable; spill granularity is the pass, not the key.

THIRD TIER (ps/ssd.py, docs/STORAGE.md): rows beyond host-RAM capacity
live in an attached ``SsdTier`` — log-structured segment files with an
in-memory key→(segment, offset) index. ``fetch`` promotes spilled keys
transparently (``LoadSSD2Mem``: on the tiered pipeline this runs on the
stage thread, overlapped with training); crossing the
``FLAGS.host_demote_watermark`` capacity fraction demotes the coldest
rows (two-phase, so segment IO never holds the store lock against a
concurrent stage fetch — the background path the tiered tables drive
from the async-epilogue worker). A demoted row's un-exported update
travels as a ``touched`` bit through the tier, so ``save_delta`` stays
complete; ``save_base``/``export_rows`` merge the tier, so exports stay
complete. ``spill_cold``/``load_from_disk`` remain as thin compat shims
over the tier (one sealed segment per manual spill file).
"""

from __future__ import annotations

import hashlib
import itertools
import logging
import os
import threading
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from paddlebox_tpu_torch.config import FLAGS
from paddlebox_tpu_torch.ps.kv import make_kv
from paddlebox_tpu_torch.ps.ssd import SsdTier, read_segment_file
from paddlebox_tpu_torch.ps.table import (FIELDS, NUM_FIXED,
                                          rows_from_store_fields,
                                          store_fields_from_rows)

log = logging.getLogger(__name__)

# host SoA fields: the device rows' layout (FeatureValue,
# heter_ps/feature_value.h:570); embedx_w is the one [*, mf_dim] block
_2D_FIELDS = ("embedx_w",)

#: distinct auto-created tier directories under FLAGS.ssd_dir
_TIER_SEQ = itertools.count()


class HostStore:
    """All-features host table; thread-safe for one writer at a time."""

    def __init__(self, mf_dim: int, capacity: Optional[int] = None,
                 init_rows: int = 1 << 16, opt_ext: int = 0,
                 ssd_dir: Optional[str] = None) -> None:
        """``opt_ext`` — width of the per-row optimizer extension block
        (ps/sgd.opt_ext_width) persisted alongside the base fields, so
        pass-scoped tables keep SparseAdam state across pass windows.
        ``ssd_dir`` attaches the disk tier explicitly; with
        ``FLAGS.ssd_dir`` set, every store auto-attaches one under a
        unique subdirectory; otherwise the tier materializes lazily on
        the first ``spill_cold``."""
        self.mf_dim = mf_dim
        self.opt_ext = opt_ext
        self.fields = tuple(FIELDS) + (("opt_ext",) if opt_ext else ())
        self.capacity = capacity or FLAGS.host_store_capacity
        self.index = make_kv(self.capacity)
        self._alloc = min(init_rows, self.capacity)
        self._arr: Dict[str, np.ndarray] = {
            f: np.zeros(self._shape(f, self._alloc), np.float32)
            for f in self.fields
        }
        self._touched = np.zeros(self._alloc, dtype=bool)
        # rows selected by an in-flight two-phase demote: a concurrent
        # write clears the mark, telling the demote's confirm phase the
        # row is fresher than the copy it just wrote to disk
        self._demote_mark = np.zeros(self._alloc, dtype=bool)
        self._lock = threading.Lock()
        # disk tier (ps/ssd.SsdTier); None = two-tier store (seed shape)
        self.ssd: Optional[SsdTier] = None
        if ssd_dir is None and FLAGS.ssd_dir:
            ssd_dir = os.path.join(FLAGS.ssd_dir,
                                   f"hs{next(_TIER_SEQ):04d}")
        if ssd_dir:
            self.ssd = SsdTier(ssd_dir, self._row_width)
        # async-epilogue fence (ps/epilogue.PassEpilogue.fence, installed
        # by the pass-window tables): EVERY read/wholesale-mutate entry
        # point drains in-flight end_pass write-backs first, so no
        # consumer — save/shrink/merge/serving fetch/len — can observe a
        # partially written-back pass. ``update`` deliberately does NOT
        # barrier: the epilogue worker itself lands rows through it.
        self.read_barrier: Optional[Callable[[], None]] = None

    @property
    def _row_width(self) -> int:
        """Logical row width (rows_from_store_fields layout) — the SSD
        tier's fixed record stride."""
        return NUM_FIXED + self.mf_dim + self.opt_ext

    @property
    def _spill_files(self) -> list:
        """Compat view of the disk tier: segment paths still holding
        live (disk-only) rows, oldest first."""
        return self.ssd.segment_paths() if self.ssd is not None else []

    def _barrier(self) -> None:
        b = self.read_barrier
        if b is not None:
            b()

    def _shape(self, field: str, n: int) -> Tuple[int, ...]:
        if field == "opt_ext":
            return (n, self.opt_ext)
        return (n, self.mf_dim) if field in _2D_FIELDS else (n,)

    def _ensure(self, max_row: int) -> None:
        if max_row < self._alloc:
            return
        new = self._alloc
        while new <= max_row:
            new *= 2
        new = min(new, self.capacity)
        for f in self.fields:
            a = np.zeros(self._shape(f, new), np.float32)
            a[:self._alloc] = self._arr[f]
            self._arr[f] = a
        for name in ("_touched", "_demote_mark"):
            t = np.zeros(new, dtype=bool)
            t[:self._alloc] = getattr(self, name)
            setattr(self, name, t)
        self._alloc = new

    def __len__(self) -> int:
        self._barrier()
        return len(self.index)

    def total_rows(self) -> int:
        """Logical model size: RAM rows + disk-tier-only rows."""
        self._barrier()
        with self._lock:
            n = len(self.index)
        return n + (len(self.ssd) if self.ssd is not None else 0)

    # ---- disk tier plumbing (ps/ssd.py) --------------------------------
    def attach_ssd(self, tier: SsdTier) -> None:
        if tier.width != self._row_width:
            raise ValueError(
                f"SSD tier row width {tier.width} != store row width "
                f"{self._row_width} (mf_dim/opt_ext mismatch)")
        self.ssd = tier

    def _ensure_tier(self, root_hint: str) -> SsdTier:
        """Lazily attach a tier for the spill_cold compat shim (manual
        spills get a tier rooted next to their first spill file)."""
        if self.ssd is None:
            self.ssd = SsdTier(
                os.path.join(root_hint or ".", ".pbox_ssd"),
                self._row_width)
        return self.ssd

    def _pack_rows(self, rows: np.ndarray) -> np.ndarray:
        """Host rows (SoA field arrays at ``rows``) → logical [k, width]
        block — the demote wire format (bit-exact round trip with
        store_fields_from_rows on promote)."""
        return rows_from_store_fields(
            {f: self._arr[f][rows] for f in self.fields},
            self.mf_dim, self.opt_ext)

    def _select_cold(self, count: int,
                     exclude: Optional[np.ndarray] = None,
                     include_touched: bool = True,
                     nonclk_coeff: float = 0.1, clk_coeff: float = 1.0
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Deterministic demote victim selection (caller holds _lock):
        coldest first by (untouched-first, score asc, key asc) — the
        ctr_accessor shrink rule's heat over show/clk. Touched rows are
        LAST resorts (their delta rides the tier's touched bit)."""
        keys, rows = self.index.items()
        if len(keys) == 0 or count <= 0:
            return np.empty(0, np.uint64), np.empty(0, np.int32)
        keep = np.ones(len(keys), bool)
        if exclude is not None and len(exclude):
            keep &= ~np.isin(keys, exclude)
        if not include_touched:
            keep &= ~self._touched[rows]
        keys, rows = keys[keep], rows[keep]
        if len(keys) == 0:
            return np.empty(0, np.uint64), np.empty(0, np.int32)
        score = self._score(rows, nonclk_coeff, clk_coeff)
        order = np.lexsort((keys, score,
                            self._touched[rows].astype(np.int8)))
        sel = order[:min(count, len(order))]
        return keys[sel], rows[sel]

    def _headroom_locked(self, need: int,
                         exclude: Optional[np.ndarray] = None) -> None:
        """Free index capacity for ``need`` new rows by demoting cold
        rows synchronously (caller holds _lock; tier IO under the lock
        — the EMERGENCY path; the watermark keeps it rare). Without a
        tier this is a no-op and the index raises TableFullError as
        before."""
        if self.ssd is None:
            return
        free = self.capacity - len(self.index)
        if free >= need:
            return
        ck, cr = self._select_cold(need - free, exclude=exclude)
        if len(ck) == 0:
            return
        self.ssd.append(ck, self._pack_rows(cr),
                        touched=self._touched[cr].copy())
        self._free(ck)
        log.info("host headroom: demoted %d cold rows to the SSD tier",
                 len(ck))

    def demote_cold(self, count: Optional[int] = None,
                    include_touched: bool = True,
                    barrier: bool = True,
                    nonclk_coeff: float = 0.1,
                    clk_coeff: float = 1.0) -> int:
        """Demote the ``count`` coldest rows (None = every eligible row)
        to the SSD tier — TWO-PHASE so the segment write never holds the
        store lock against a concurrent stage fetch: select+copy under
        the lock, write outside it, then confirm-free only rows no
        writer touched meanwhile (a raced row keeps its fresher RAM
        state and its just-written disk copy is discarded).

        ``barrier=False`` is for callers already ordered BEHIND the
        async epilogue (the tiered end_pass write-back job runs this on
        the epilogue lane itself — fencing there would deadlock the
        single-lane worker)."""
        if self.ssd is None:
            return 0
        if barrier:
            self._barrier()
        with self._lock:
            if count is None:
                count = len(self.index)
            ck, cr = self._select_cold(count,
                                       include_touched=include_touched,
                                       nonclk_coeff=nonclk_coeff,
                                       clk_coeff=clk_coeff)
            if len(ck) == 0:
                return 0
            sub = self._pack_rows(cr)
            tch = self._touched[cr].copy()
            self._demote_mark[cr] = True
        # phase 2: segment IO with the store lock RELEASED
        self.ssd.append(ck, sub, touched=tch)
        # phase 3: free only rows whose mark survived (no writer raced)
        with self._lock:
            cur = self.index.lookup(ck)
            same = cur == cr          # still the same key→row binding
            ok = same.copy()
            ok[same] = self._demote_mark[cr[same]]
            self._demote_mark[cr] = False
            freed_keys = ck[ok]
            self._free(freed_keys)
            # a concurrent write superseded the copy we just demoted —
            # RAM stays authoritative, so the disk copy must not shadow
            # it. INSIDE the lock, and only while the key is still
            # RAM-live: a raced key someone ELSE demoted-and-freed
            # meanwhile has its (fresher) tier copy as the only copy
            # left — discarding that would lose the row.
            stale = ck[~ok & (cur >= 0)]
            if len(stale):
                self.ssd.discard(stale)
        if len(freed_keys):
            log.info("demote_cold: %d rows -> SSD tier (%d raced and "
                     "stayed in RAM)", len(freed_keys), len(stale))
        return int(len(freed_keys))

    def demote_to_watermark(self, barrier: bool = True) -> int:
        """Background demotion policy: above
        ``FLAGS.host_demote_watermark × capacity`` RAM rows, demote the
        coldest down to ``FLAGS.host_demote_target × capacity``. The
        tiered tables run this on the async-epilogue worker right after
        each end_pass write-back lands (ordered, off the critical
        path). No-op without a tier or below the watermark."""
        if self.ssd is None:
            return 0
        wm = FLAGS.host_demote_watermark
        if wm <= 0:
            return 0
        with self._lock:
            n = len(self.index)
        if n <= int(wm * self.capacity):
            return 0
        target = int(max(0.0, min(FLAGS.host_demote_target, wm))
                     * self.capacity)
        return self.demote_cold(count=n - target, barrier=barrier)

    def _promote(self, keys: np.ndarray,
                 protect: Optional[np.ndarray] = None) -> int:
        """LoadSSD2Mem: move ``keys``' rows (the subset found in the
        tier) back into host RAM. Promoted keys leave the tier index
        atomically with the read — no stale copy can resurrect — and a
        key that became RAM-resident meanwhile keeps its fresher RAM
        state (the promoted copy is dropped).

        ``protect``: keys the headroom demotion must not pick (the rest of
        the caller's key set, already in RAM). The port's repair of the
        reference, whose headroom excludes only the promoted keys: a
        ``fetch`` whose promote needed headroom could demote another of
        its own keys and then read that key as a zero row."""
        if self.ssd is None or len(keys) == 0:
            return 0
        fkeys, sub, tch = self.ssd.take(keys)
        if len(fkeys) == 0:
            return 0
        try:
            fields = store_fields_from_rows(sub, self.mf_dim,
                                            self.opt_ext)
            with self._lock:
                live = self.index.lookup(fkeys) >= 0
                ins = ~live                    # RAM wins over the tier
                ik = fkeys[ins]
                if len(ik):
                    self._headroom_locked(
                        len(ik), exclude=ik if protect is None
                        else np.union1d(ik, protect))
                    rows = self.index.assign(ik)
                    self._ensure(int(rows.max()))
                    for f in self.fields:
                        self._arr[f][rows] = fields[f][ins]
                    self._touched[rows] = tch[ins]
                    self._demote_mark[rows] = False
            return int(len(ik))
        except BaseException:
            # the rows left the tier but never landed in RAM — put them
            # back rather than lose them
            self.ssd.append(fkeys, sub, touched=tch)
            raise

    def spill_manifest(self) -> Optional[dict]:
        """The tier's checkpoint manifest (segment paths + sha256), or
        None without a tier / with an empty tier. Sealing side effect:
        see SsdTier.manifest."""
        self._barrier()
        return self.ssd.manifest() if self.ssd is not None else None

    def ssd_stats(self) -> Dict[str, float]:
        return self.ssd.stats() if self.ssd is not None else {}

    # ---- pass staging ----
    def fetch(self, keys: np.ndarray) -> Dict[str, np.ndarray]:
        """Values for ``keys``; unknown keys read as zero-initialized rows
        (they materialize on update — lazy feature creation). Keys that
        live only in the disk tier are promoted transparently first (the
        LoadSSD2Mem step of the pass lifecycle), so PassScopedTable.stage
        never trains a spilled feature from zero — and on the tiered
        pipeline this fetch runs on the STAGE thread, so the promotion
        IO overlaps the open pass's training."""
        self._barrier()  # in-flight end_pass write-backs land first
        keys_u64 = np.ascontiguousarray(keys, np.uint64)
        if self.ssd is not None and len(self.ssd):
            with self._lock:
                missing = self.index.lookup(keys_u64) < 0
            if missing.any():
                self._promote(keys_u64[missing], protect=keys_u64)
        with self._lock:
            rows = self.index.lookup(keys_u64)
            known = rows >= 0
            out = {}
            for f in self.fields:
                a = np.zeros(self._shape(f, len(keys)), np.float32)
                a[known] = self._arr[f][rows[known]]
                out[f] = a
            return out

    def update(self, keys: np.ndarray, data: Dict[str, np.ndarray]) -> None:
        """Write back a pass's updated rows (EndPass dump)."""
        keys_u64 = np.ascontiguousarray(keys, np.uint64)
        with self._lock:
            if self.ssd is not None:
                new = int((self.index.lookup(keys_u64) < 0).sum())
                if new:
                    self._headroom_locked(new, exclude=keys_u64)
            rows = self.index.assign(keys_u64)
            if len(rows):
                self._ensure(int(rows.max()))
            for f in self.fields:
                self._arr[f][rows] = data[f]
            self._touched[rows] = True
            self._demote_mark[rows] = False
            if self.ssd is not None and len(self.ssd):
                # tier copies of freshly written keys are stale now (a
                # key demoted earlier and re-created by this write) —
                # drop them so no export or later promote can see the
                # old values. INSIDE the store lock: released, a racing
                # demote could re-spill one of these keys and this
                # discard would then delete the only remaining copy.
                self.ssd.discard(keys_u64)

    def update_rows(self, keys: np.ndarray, sub: np.ndarray,
                    slot_override: Optional[np.ndarray] = None) -> None:
        """Batched write-back of gathered LOGICAL rows ``[k, feat]``
        (gather_full_rows layout) — the async-epilogue fast path: one
        call converts fields and lands the whole shard delta under a
        single lock acquisition, instead of the caller assembling a
        field dict first."""
        self.update(keys, store_fields_from_rows(
            sub, self.mf_dim, self.opt_ext, slot_override=slot_override))

    # ---- shared helpers (score / eviction / dump format) ----
    def _score(self, rows: np.ndarray, nonclk_coeff: float,
               clk_coeff: float) -> np.ndarray:
        """Feature heat (ctr_accessor shrink rule): coeffs over show/clk."""
        show, clk = self._arr["show"][rows], self._arr["clk"][rows]
        return nonclk_coeff * (show - clk) + clk_coeff * clk

    def _free(self, keys: np.ndarray) -> np.ndarray:
        """Release keys and zero their rows; returns freed row ids."""
        freed = self.index.release(keys)
        for f in self.fields:
            self._arr[f][freed] = 0
        self._touched[freed] = False
        self._demote_mark[freed] = False
        return freed

    # ---- checkpoint (SaveBase/SaveDelta, box_wrapper.cc:1383-1415) ----
    def _dump(self, path: str, keys: np.ndarray, rows: np.ndarray,
              extra: Optional[Dict[str, np.ndarray]] = None) -> int:
        """npz dump of rows; ``extra`` appends out-of-RAM rows (spilled
        tiers) as {field: values} with their own key array."""
        blobs = {f: self._arr[f][rows] for f in self.fields}
        if extra:
            keys = np.concatenate([keys, extra["keys"]])
            for f in self.fields:
                blobs[f] = np.concatenate([blobs[f], extra[f]])
        np.savez(path, keys=keys, mf_dim=np.int32(self.mf_dim), **blobs)
        return len(keys)

    def _ssd_extra(self, delta: bool = False,
                   clear_touched: bool = True
                   ) -> Optional[Dict[str, np.ndarray]]:
        """Tier rows for a save/export merge: {field: values, "keys"}.
        ``delta`` restricts to tier rows carrying the touched bit (their
        update never reached a save yet). RAM-live keys are filtered
        defensively — RAM is always the fresher copy."""
        if self.ssd is None or len(self.ssd) == 0:
            return None
        tk, trows, _tch = self.ssd.export_rows(delta=delta,
                                               clear_touched=clear_touched)
        if len(tk) == 0:
            return None
        dead = self.index.lookup(tk) < 0
        tk, trows = tk[dead], trows[dead]
        if len(tk) == 0:
            return None
        out = store_fields_from_rows(trows, self.mf_dim, self.opt_ext)
        out["keys"] = tk
        return out

    def save_base(self, path: str, clear_touched: bool = True) -> int:
        """Full model dump — includes rows currently spilled to the disk
        tier, so the exported base is always the COMPLETE model.
        ``clear_touched=False`` = a STAGED export (artifact publish):
        the delta bookkeeping survives until the publish commits, so a
        failed publish loses nothing (``clear_touched_flags`` is the
        post-commit half)."""
        self._barrier()
        with self._lock:
            keys, rows = self.index.items()
            n = self._dump(path, keys, rows,
                           extra=self._ssd_extra(
                               clear_touched=clear_touched))
            if clear_touched:
                self._touched[:] = False
        log.info("save_base: %d rows -> %s", n, path)
        return n

    # ---- in-memory export/import (sharded single-file save format) ----
    def export_rows(self, delta: bool = False, clear_touched: bool = True
                    ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """(keys, {field: values}) snapshot — base includes disk-tier
        rows so the export is the COMPLETE model; ``delta`` restricts to
        rows touched since the last export/save (including tier rows
        demoted with un-exported updates) and clears their flags —
        unless ``clear_touched=False`` (staged artifact publish; see
        save_base)."""
        self._barrier()
        with self._lock:
            keys, rows = self.index.items()
            if delta:
                m = self._touched[rows]
                keys, rows = keys[m], rows[m]
            out = {f: self._arr[f][rows].copy() for f in self.fields}
            extra = self._ssd_extra(delta=delta,
                                    clear_touched=clear_touched)
            if extra is not None:
                keys = np.concatenate([keys, extra["keys"]])
                for f in self.fields:
                    out[f] = np.concatenate([out[f], extra[f]])
            if clear_touched:
                if not delta:
                    self._touched[:] = False
                else:
                    self._touched[rows] = False
        return keys, out

    def clear_touched_flags(self) -> None:
        """Post-commit half of a STAGED export: clear the delta
        bookkeeping for every row, RAM and disk tier alike. Call only
        between passes (the publish protocol fences first) — a staged
        ``save_*(clear_touched=False)`` followed by this on publish
        success is equivalent to the plain clearing save, but a publish
        failure in between loses no delta rows."""
        self._barrier()
        with self._lock:
            self._touched[:] = False
            if self.ssd is not None:
                self.ssd.clear_touched()

    def rows_digest(self) -> str:
        """sha256 over the store's COMPLETE logical content (RAM + disk
        tier), keyed and sorted by feasign so row-assignment order
        cancels out. Read-only: rides ``export_rows(clear_touched=
        False)``, so it fingerprints exactly what a base export would
        dump while clearing no delta bookkeeping. The bit-identity
        oracle of the publish gates."""
        keys, out = self.export_rows(clear_touched=False)
        order = np.argsort(keys)
        h = hashlib.sha256()
        h.update(np.ascontiguousarray(keys[order]).tobytes())
        for f in sorted(out):
            h.update(f.encode())
            h.update(np.ascontiguousarray(
                out[f][order], np.float32).tobytes())
        return h.hexdigest()

    def import_rows(self, keys: np.ndarray, fields: Dict[str, np.ndarray],
                    merge: bool = False) -> int:
        """Write rows wholesale (load semantics); merge=False resets the
        store first (the old model's disk tier does not carry over).
        Missing/mismatched opt_ext starts fresh. With a tier attached,
        an import larger than the RAM watermark routes the COLDEST rows
        straight to the tier — the restore path for models bigger than
        host RAM."""
        self._barrier()  # an in-flight write-back must not land AFTER
        keys_u64 = np.ascontiguousarray(keys, np.uint64)
        with self._lock:  # a reset/load overwrote the store
            if not merge:
                self.index = make_kv(self.capacity)
                for f in self.fields:
                    self._arr[f][:] = 0
                self._touched[:] = False
                self._demote_mark[:] = False
                if self.ssd is not None:
                    self.ssd.clear()  # old model's tiers don't carry over
            ram_sel, cold_sel = self._split_import(keys_u64, fields)
            rows = self.index.assign(keys_u64[ram_sel])
            if len(rows):
                self._ensure(int(rows.max()))
            for f in self.fields:
                self._write_field(f, rows, fields, "import_rows",
                                  sel=ram_sel)
            self._demote_mark[rows] = False
            if merge and self.ssd is not None and len(self.ssd):
                # imported keys that also had a tier copy: the import
                # wins. Inside the store lock — released, a racing
                # demote could re-spill one of these keys first and
                # this discard would delete the only remaining copy.
                self.ssd.discard(keys_u64[ram_sel])
        if cold_sel is not None and cold_sel.any():
            sub = rows_from_store_fields(
                {f: (fields[f][cold_sel] if f in fields
                     else np.zeros(self._shape(f, int(cold_sel.sum())),
                                   np.float32))
                 for f in self.fields}, self.mf_dim, self.opt_ext)
            self.ssd.append(keys_u64[cold_sel], sub)
            log.info("import_rows: %d rows routed to the SSD tier "
                     "(host RAM watermark)", int(cold_sel.sum()))
        return len(keys)

    def _split_import(self, keys: np.ndarray,
                      fields: Dict[str, np.ndarray]
                      ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """(ram_mask, cold_mask) for an import: without a tier all rows
        go to RAM (TableFullError stays the relief valve); with one,
        rows beyond the watermark budget spill coldest-first (score over
        the incoming show/clk, key-tiebroken — deterministic)."""
        n = len(keys)
        all_ram = np.ones(n, bool)
        if self.ssd is None:
            return all_ram, None
        wm = FLAGS.host_demote_watermark
        budget = int((wm if wm > 0 else 1.0) * self.capacity) \
            - len(self.index)
        # re-imported keys reuse their existing rows — only truly new
        # keys consume budget
        existing = self.index.lookup(keys) >= 0
        new_n = int((~existing).sum())
        if new_n <= max(0, budget):
            return all_ram, None
        show = np.asarray(fields.get("show", np.zeros(n)), np.float32)
        clk = np.asarray(fields.get("clk", np.zeros(n)), np.float32)
        score = 0.1 * (show - clk) + 1.0 * clk
        order = np.lexsort((keys, -score))   # hottest first, key tiebreak
        keep_new = max(0, budget)
        ram = existing.copy()
        picked = 0
        for i in order.tolist():
            if ram[i]:
                continue
            if picked < keep_new:
                ram[i] = True
                picked += 1
        return ram, ~ram

    def merge_model_rows(self, keys: np.ndarray,
                         fields: Dict[str, np.ndarray]) -> int:
        """MergeModel semantics (box_wrapper.h:801-803) on the host tier:
        keys present in both ACCUMULATE show/clk/delta_score and keep the
        live weights/optimizer state; unseen keys insert wholesale.
        Tier-resident keys count as present: they promote first so the
        accumulate lands on their real values."""
        if len(keys) == 0:
            return 0
        self._barrier()
        keys = np.ascontiguousarray(keys, np.uint64)
        if self.ssd is not None and len(self.ssd):
            # accumulate needs the real rows in RAM
            self._promote(keys, protect=keys)
        with self._lock:
            existing = self.index.lookup(keys) >= 0
        new_keys = keys[~existing]
        self.import_rows(new_keys,
                         {f: v[~existing] for f, v in fields.items()},
                         merge=True)
        with self._lock:
            rows_old = self.index.lookup(keys[existing])
            for f in ("show", "clk", "delta_score"):
                self._arr[f][rows_old] += fields[f][existing]
            self._touched[rows_old] = True
            self._demote_mark[rows_old] = False
            lk = self.index.lookup(new_keys)
            rows_new = lk[lk >= 0]   # watermark may have routed some
            self._touched[rows_new] = True   # new rows to the tier
        return len(keys)

    def save_delta(self, path: str, clear_touched: bool = True) -> int:
        """Touched-rows dump ("xbox delta"); ``clear_touched=False`` =
        staged artifact publish (see save_base)."""
        self._barrier()
        with self._lock:
            keys, rows = self.index.items()
            m = self._touched[rows]
            n = self._dump(path, keys[m], rows[m],
                           extra=self._ssd_extra(
                               delta=True, clear_touched=clear_touched))
            if clear_touched:
                self._touched[:] = False
        log.info("save_delta: %d rows -> %s", n, path)
        return n

    def _write_field(self, f: str, rows, blob, who: str,
                     sel=slice(None)) -> None:
        """Write one field from a save file, tolerating files written
        WITHOUT (or with a different-width) opt_ext block — optimizer
        state then starts fresh for those rows, with a warning (the
        EmbeddingTable.load degradation contract)."""
        if f == "opt_ext" and (f not in blob
                               or blob[f].shape[1] != self.opt_ext):
            log.warning("%s: file has no matching opt_ext block; "
                        "optimizer state starts fresh for loaded rows",
                        who)
            self._arr[f][rows] = 0.0
            return
        self._arr[f][rows] = blob[f][sel]

    def load(self, path: str, merge: bool = False) -> int:
        blob = np.load(path)
        keys = blob["keys"]
        fields = {f: blob[f] for f in self.fields if f in blob}
        return self.import_rows(keys, fields, merge=merge)

    # ---- disk tier compat shims (SSD role: LoadSSD2Mem,
    # box_wrapper.cc:1415 — thin wrappers over ps/ssd.SsdTier) ----
    def spill_cold(self, path: str, threshold: float,
                   nonclk_coeff: float = 0.1, clk_coeff: float = 1.0) -> int:
        """Move COLD rows (score < threshold) into ONE sealed tier
        segment at ``path`` and free their host rows — the manual
        host-RAM ↔ SSD boundary (hot rows stay in mem, cold spill to SSD
        until a later ``load_from_disk``/``fetch`` promotes them back).

        Only rows whose updates are already exported spill here (touched
        rows stay in RAM — the conservative legacy contract; the
        watermark demoter is the path that may spill touched rows, with
        the touched bit carried through the tier)."""
        if not path.endswith(".npz"):
            path += ".npz"  # legacy savez convention; registry must match
        self._barrier()
        with self._lock:
            tier = self._ensure_tier(os.path.dirname(path))
            if tier.has_live_path(path):
                raise ValueError(
                    f"{path} already holds an active spill — overwriting "
                    "would lose its still-spilled rows; use a fresh path "
                    "per spill")
            keys, rows = self.index.items()
            if len(keys) == 0:
                return 0
            cold = self._score(rows, nonclk_coeff, clk_coeff) < threshold
            cold &= ~self._touched[rows]  # unsaved updates never spill
            ck, cr = keys[cold], rows[cold]
            if len(ck) == 0:
                return 0
            tier.append_sealed_file(path, ck, self._pack_rows(cr))
            self._free(ck)
        log.info("spill_cold: %d/%d rows -> %s", len(ck), len(keys), path)
        return int(len(ck))

    def load_from_disk(self, path: str, keys: Optional[np.ndarray] = None
                       ) -> int:
        """Promote spilled rows back into host RAM (LoadSSD2Mem). With
        ``keys``, only the requested subset (a pass working set) loads;
        rows already live in RAM keep their fresher in-memory state.

        Promoted (or RAM-superseded) keys leave the tier index — a later
        shrink of a promoted key can never resurrect its stale spilled
        copy into a base export. A path unknown to this store's tier
        (another process's spill file) is scanned directly and adopted
        row-by-row — the fresh-restore path."""
        if not path.endswith(".npz"):
            path += ".npz"
        self._barrier()  # "RAM wins" needs in-flight rows IN RAM first
        if self.ssd is not None and self.ssd.has_live_path(path):
            want = self.ssd.keys_in_path(path)
            if keys is not None:
                want = want[np.isin(want,
                                    np.ascontiguousarray(keys, np.uint64))]
            n = self._promote(want)
            log.info("load_from_disk: %d rows <- %s (tier)", n, path)
            return n
        dkeys, sub, tch = read_segment_file(path, self._row_width)
        sel = np.ones(len(dkeys), bool)
        if keys is not None:
            sel = np.isin(dkeys, np.ascontiguousarray(keys, np.uint64))
        fields = store_fields_from_rows(sub, self.mf_dim, self.opt_ext)
        with self._lock:
            live = self.index.lookup(dkeys) >= 0
            sel &= ~live  # RAM state wins over the spilled copy
            lk = dkeys[sel]
            if len(lk):
                self._headroom_locked(len(lk), exclude=lk)
                rows = self.index.assign(lk)
                self._ensure(int(rows.max()))
                for f in self.fields:
                    self._arr[f][rows] = fields[f][sel]
                self._touched[rows] = tch[sel]
                self._demote_mark[rows] = False
        log.info("load_from_disk: %d rows <- %s", len(lk), path)
        return int(len(lk))

    # ---- feature aging (ShrinkTable, box_wrapper.h:638) ----
    def shrink(self, delete_threshold: Optional[float] = None,
               decay: Optional[float] = None,
               nonclk_coeff: float = 0.1, clk_coeff: float = 1.0) -> int:
        thr = (FLAGS.shrink_delete_threshold
               if delete_threshold is None else delete_threshold)
        dk = FLAGS.show_click_decay_rate if decay is None else decay
        self._barrier()  # decay/score must see every written-back row
        freed: np.ndarray = np.empty(0, np.int64)
        with self._lock:
            keys, rows = self.index.items()
            if len(keys):
                self._arr["show"] *= dk
                self._arr["clk"] *= dk
                self._arr["delta_score"] *= dk
                drop = self._score(rows, nonclk_coeff, clk_coeff) < thr
                freed = self._free(keys[drop])
                if self.ssd is not None and len(self.ssd):
                    # an aged-out feature's disk copy must never
                    # resurrect
                    self.ssd.discard(keys[drop])
        dropped_ssd = 0
        if self.ssd is not None and len(self.ssd):
            # age the DEMOTED rows too (SsdTier.shrink) — without this
            # the disk tier is immortal and an always-on stream's SSD
            # footprint never plateaus; compact afterward so the
            # vacated + dropped copies actually free disk
            dropped_ssd = self.ssd.shrink(thr, dk, nonclk_coeff,
                                          clk_coeff)
            self.ssd.maybe_compact()
        log.info("host shrink: freed %d/%d RAM rows, %d SSD rows",
                 len(freed), len(keys), dropped_ssd)
        return int(len(freed)) + dropped_ssd
