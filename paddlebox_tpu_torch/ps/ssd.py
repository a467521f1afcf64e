"""SSD third tier: disk-backed embedding segments behind the HostStore —
the port's copy of ``paddlebox_tpu/ps/ssd.py``. Segment files are byte
for byte the reference's, so either package reads the other's. With the
telemetry hub active, ``_mirror`` adds the accounting of ``stats()`` to
the ``pbox_ssd_*`` counters and gauges.

Reference capability: the BoxPS closed core is an HBM + host-mem + SSD
hierarchy — ``BeginFeedPass`` schedules SSD→mem promotion for the pass
working set (``LoadSSD2Mem``, box_wrapper.cc:1415) and the PSCore
``ssd_sparse_table`` keeps the long tail of a trillion-feature table on
disk. This module is the third tier: rows the host RAM cannot
hold DEMOTE into append-only, log-structured segment files, and PROMOTE
back on demand (transparently inside ``HostStore.fetch`` — the stage
thread of the tiered pass pipeline, so promotion overlaps training the
way the pass pipeline overlaps the epilogue and prologue).

Design (docs/STORAGE.md):

- **Segments** are append-only files of self-describing record blocks::

      [int64 n][uint64 keys[n]][uint8 touched[n]][f32 rows[n, width]]

  ``width`` is the logical row width (ps/table.NUM_FIXED + mf_dim +
  opt_ext — exactly the ``rows_from_store_fields`` layout, so a
  demote→promote round trip is bit-exact). A segment SEALS at
  ``FLAGS.ssd_segment_rows`` rows (or at manifest time) and is immutable
  from then on — the spill manifest can record its sha256 and a later
  restore can verify it like any checkpoint chain link.
- **Index**: one in-memory ``key → (segment, byte offset, touched)``
  map. Promoted (or superseded) keys leave the index immediately, so a
  stale on-disk copy can never resurrect into a fetch or a base export;
  rows they leave behind are DEAD and only compaction reclaims them.
- **Touched bit**: a demoted row whose update has not been exported yet
  carries ``touched=True`` through the tier; ``export_rows(delta=True)``
  returns it and promotion restores the flag — demotion never loses a
  pending ``save_delta`` row.
- **Compaction**: ``maybe_compact`` rewrites sealed segments whose live
  fraction fell below ``FLAGS.ssd_compact_live_frac`` (live rows
  re-append, the old file unlinks). Segments are never rewritten in
  place, so a manifested (sealed) file either exists with its recorded
  digest or is gone — a sha256 mismatch on restore is always real
  corruption (``SegmentCorruptError`` / ``CheckpointCorruptError``).
- **Fault seam** ``ssd.io`` fires on every segment file read/write/
  unlink; transient failures retry on the seeded ``RetryPolicy``
  (site ``ssd.io``), so a fault plan can prove recovery.

Durability contract: the tier is a CAPACITY tier, not the durability
root — checkpoints stay self-contained (``save_base`` merges the tier,
``save_delta`` merges its touched rows) and the spill manifest recorded
in checkpoint meta (train/checkpoint.py) lets a restore verify that the
segment files it may promote from again are intact.
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from paddlebox_tpu_torch.obs.hub import get_hub
from paddlebox_tpu_torch.resilience import faults
from paddlebox_tpu_torch.resilience.retry import RetryPolicy

log = logging.getLogger(__name__)

_BLOCK_HDR = np.dtype(np.int64).itemsize


class SegmentCorruptError(RuntimeError):
    """A segment file's content does not match the spill manifest —
    refuse to promote from it (train/checkpoint.py re-raises this as
    ``CheckpointCorruptError`` on restore)."""


def _io_retry() -> RetryPolicy:
    """Segment file IO runs under the flag-configured retry policy —
    the same transient-NFS story as checkpoint.io."""
    return RetryPolicy.from_flags(site="ssd.io")


def file_sha256(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        while True:
            buf = fh.read(chunk)
            if not buf:
                break
            h.update(buf)
    return h.hexdigest()


class _Segment:
    __slots__ = ("seg_id", "path", "rows", "live", "nbytes", "sealed",
                 "external", "pending", "sha256")

    def __init__(self, seg_id: int, path: str,
                 external: bool = False) -> None:
        self.seg_id = seg_id
        self.path = path
        self.rows = 0      # rows ever appended (reserved included)
        self.live = 0      # rows still indexed
        self.nbytes = 0
        self.sealed = False
        # external = a caller-addressed spill file (spill_cold compat):
        # an immutable snapshot the caller may re-read from another
        # process — drop it from the registry when dead, never unlink
        self.external = external
        # blocks reserved by an in-flight append (disk write outside
        # the index lock) — guards the file against dead-segment unlink
        self.pending = 0
        # sha256 cached at first manifest after sealing (immutable from
        # then on — every checkpoint after the first reuses it)
        self.sha256: Optional[str] = None


def read_segment_file(path: str, width: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Scan a whole segment file → (keys, rows [k, width], touched).
    Later blocks supersede earlier ones for duplicate keys (append
    order), mirroring the in-memory index semantics — this is how a
    FRESH process adopts a spill file (``HostStore.load_from_disk``
    compat path) without any tier state."""
    def scan():
        faults.inject("ssd.io", path=path, op=f"read:{path}")
        with open(path, "rb") as fh:
            raw = fh.read()
        return raw
    raw = _io_retry().call(scan)
    keys_l: List[np.ndarray] = []
    rows_l: List[np.ndarray] = []
    tch_l: List[np.ndarray] = []
    off = 0
    while off < len(raw):
        if off + _BLOCK_HDR > len(raw):
            raise SegmentCorruptError(
                f"{path}: truncated block header at byte {off}")
        n = int(np.frombuffer(raw, np.int64, count=1, offset=off)[0])
        off += _BLOCK_HDR
        need = n * 8 + n + n * width * 4
        if n < 0 or off + need > len(raw):
            raise SegmentCorruptError(
                f"{path}: torn block (n={n}) at byte {off - _BLOCK_HDR}")
        keys_l.append(np.frombuffer(raw, np.uint64, count=n, offset=off))
        off += n * 8
        tch_l.append(np.frombuffer(raw, np.uint8, count=n, offset=off))
        off += n
        rows_l.append(np.frombuffer(
            raw, np.float32, count=n * width,
            offset=off).reshape(n, width))
        off += n * width * 4
    if not keys_l:
        return (np.empty(0, np.uint64), np.empty((0, width), np.float32),
                np.empty(0, bool))
    keys = np.concatenate(keys_l)
    rows = np.concatenate(rows_l)
    tch = np.concatenate(tch_l).astype(bool)
    # last write wins per key
    _, last = np.unique(keys[::-1], return_index=True)
    sel = len(keys) - 1 - last
    return keys[sel], rows[sel].copy(), tch[sel]


class SsdTier:
    """Disk tier of one ``HostStore``: log-structured segments + an
    in-memory key→location index. Thread-safe (demote runs on the
    async-epilogue worker while the stage thread promotes)."""

    def __init__(self, root: str, width: int,
                 segment_rows: Optional[int] = None,
                 compact_live_frac: Optional[float] = None,
                 name: str = "ssd") -> None:
        from paddlebox_tpu_torch.config import FLAGS
        self.root = root
        self.width = int(width)
        self.name = name
        self.segment_rows = int(segment_rows or FLAGS.ssd_segment_rows)
        self.compact_live_frac = (FLAGS.ssd_compact_live_frac
                                  if compact_live_frac is None
                                  else float(compact_live_frac))
        os.makedirs(root, exist_ok=True)
        # a previous process's leftover segments are unreachable (their
        # index died with it) and APPENDING to one would hand out byte
        # offsets into the old content — sweep them. The tier is a
        # capacity cache: checkpoints are self-contained, and a spill
        # manifest treats missing segments as legitimately gone.
        stale = [n for n in sorted(os.listdir(root))
                 if n.startswith("seg-") and n.endswith(".pbseg")]
        for n in stale:
            try:
                os.unlink(os.path.join(root, n))
            except OSError:
                log.warning("ssd tier (%s): could not sweep stale "
                            "segment %s", name, n, exc_info=True)
        if stale:
            log.warning(
                "ssd tier (%s): swept %d leftover segment file(s) from "
                "a previous process out of %s — the tier is a capacity "
                "cache; restore re-imports every row from the "
                "checkpoint", name, len(stale), root)
        # _lock guards the index + segment registry; _io_lock
        # serializes segment WRITERS (append order must match offset
        # reservation order). Disk writes run under _io_lock only, so
        # a concurrent promote (take — index lock + committed-block
        # reads) never waits out a demote's segment write.
        self._lock = threading.RLock()
        self._io_lock = threading.Lock()
        # key -> (seg_id, byte offset of the row's f32 block, touched)
        self._index: Dict[int, Tuple[int, int, bool]] = {}
        self._segments: Dict[int, _Segment] = {}
        self._next_seg = 0
        self._active: Optional[int] = None
        # cumulative accounting (``stats()``)
        self.demoted_rows = 0
        self.promoted_rows = 0
        self.compacted_rows = 0
        self.demote_sec = 0.0
        self.promote_sec = 0.0
        # promote seconds spent on the MAIN thread — the critical-path
        # share (a stage-thread promote overlaps training, exactly like
        # the epilogue's critical_fence_wait accounting)
        self.promote_wait_sec = 0.0

    # ---- introspection -------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._index)

    @property
    def live_rows(self) -> int:
        return len(self)

    def segment_paths(self) -> List[str]:
        """Paths of segments still holding live rows (oldest first) —
        the ``HostStore._spill_files`` compat view."""
        with self._lock:
            return [s.path for s in
                    sorted(self._segments.values(),
                           key=lambda s: s.seg_id) if s.live > 0]

    def has_live_path(self, path: str) -> bool:
        with self._lock:
            return any(s.path == path and s.live > 0
                       for s in self._segments.values())

    def keys_in_path(self, path: str) -> np.ndarray:
        """Live keys whose current copy resides in the segment(s) at
        ``path`` (the load_from_disk compat view of one spill file)."""
        with self._lock:
            sids = {sid for sid, s in self._segments.items()
                    if s.path == path}
            if not sids:
                return np.empty(0, np.uint64)
            out = [k for k, loc in self._index.items() if loc[0] in sids]
            return np.array(sorted(out), np.uint64)

    def contains(self, keys: np.ndarray) -> np.ndarray:
        idx = self._index
        with self._lock:
            return np.fromiter((int(k) in idx for k in keys),
                               bool, count=len(keys))

    def keys(self) -> np.ndarray:
        with self._lock:
            return np.fromiter(self._index.keys(), np.uint64,
                               count=len(self._index))

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "live_rows": len(self._index),
                "segments": sum(1 for s in self._segments.values()
                                if s.rows > 0),
                "bytes": sum(s.nbytes for s in self._segments.values()),
                "demoted_rows": self.demoted_rows,
                "promoted_rows": self.promoted_rows,
                "compacted_rows": self.compacted_rows,
                "demote_sec": self.demote_sec,
                "promote_sec": self.promote_sec,
                "promote_wait_sec": self.promote_wait_sec,
            }

    # ---- write path (demotion) -----------------------------------------
    def _new_segment(self, path: Optional[str] = None) -> _Segment:
        seg_id = self._next_seg
        self._next_seg += 1
        external = path is not None
        if path is None:
            path = os.path.join(self.root, f"seg-{seg_id:06d}.pbseg")
        seg = _Segment(seg_id, path, external=external)
        self._segments[seg_id] = seg
        return seg

    @staticmethod
    def _block_blob(keys: np.ndarray, rows: np.ndarray,
                    touched: np.ndarray) -> bytes:
        return (np.int64(len(keys)).tobytes()
                + np.ascontiguousarray(keys, np.uint64).tobytes()
                + np.ascontiguousarray(touched, np.uint8).tobytes()
                + np.ascontiguousarray(rows, np.float32).tobytes())

    def _write_at(self, seg: _Segment, base: int, blob: bytes) -> None:
        """Write one reserved block at byte ``base`` (caller holds
        ``_io_lock``, NOT ``_lock``). Truncate-then-write makes a
        retried attempt idempotent: a torn earlier try can never leave
        the file longer than its reservation."""
        def write() -> None:
            faults.inject("ssd.io", path=seg.path, op=f"append:{seg.path}")
            mode = "r+b" if os.path.exists(seg.path) else "wb"
            with open(seg.path, mode) as fh:
                fh.seek(0, os.SEEK_END)
                if fh.tell() > base:
                    fh.truncate(base)   # torn previous attempt
                fh.seek(base)
                fh.write(blob)
        _io_retry().call(write)

    def _commit_block(self, seg: _Segment, data_off: int,
                      keys: np.ndarray, touched: np.ndarray) -> None:
        """Index one written block (caller holds ``_lock``): re-appended
        keys supersede their old copy — the old row goes dead."""
        for i, k in enumerate(keys.tolist()):
            old = self._index.get(k)
            if old is not None:
                self._segments[old[0]].live -= 1
            self._index[k] = (seg.seg_id, data_off + i * self.width * 4,
                              bool(touched[i]))
        seg.live += len(keys)

    def append(self, keys: np.ndarray, rows: np.ndarray,
               touched: Optional[np.ndarray] = None,
               book: bool = True) -> int:
        """Demote ``rows`` (logical [k, width] layout) under ``keys``;
        returns the number of rows written. Three-step so the disk
        write blocks neither a concurrent promote nor the index:
        reserve the block's offsets under ``_lock``, write under
        ``_io_lock`` alone, then commit the index under ``_lock``
        (readers only ever see fully-written blocks).

        ``book=False`` (compaction's internal rewrite) skips the
        demote counters/timers and the telemetry mirror."""
        if len(keys) == 0:
            return 0
        keys = np.ascontiguousarray(keys, np.uint64)
        if touched is None:
            touched = np.zeros(len(keys), bool)
        n = len(keys)
        t0 = time.perf_counter()
        blob = self._block_blob(keys, rows, touched)
        with self._io_lock:
            with self._lock:
                seg = (self._segments.get(self._active)
                       if self._active is not None else None)
                if seg is None or seg.sealed \
                        or seg.rows >= self.segment_rows:
                    seg = self._new_segment()
                    self._active = seg.seg_id
                base = seg.nbytes
                seg.nbytes += len(blob)
                seg.rows += n
                seg.pending += 1
                sealed_here = seg.rows >= self.segment_rows
                if sealed_here:
                    seg.sealed = True
                    self._active = None
            try:
                self._write_at(seg, base, blob)
            except BaseException:
                with self._lock:   # roll the reservation back — the
                    seg.nbytes = base          # next append must land
                    seg.rows -= n              # at the true file end
                    seg.pending -= 1
                    if sealed_here:
                        seg.sealed = False
                        self._active = seg.seg_id
                raise
            with self._lock:
                self._commit_block(seg, base + _BLOCK_HDR + n * 8 + n,
                                   keys, touched)
                seg.pending -= 1
                if book:
                    self.demoted_rows += n
                    self.demote_sec += time.perf_counter() - t0
        if book:
            self._mirror()
        return n

    def append_sealed_file(self, path: str, keys: np.ndarray,
                           rows: np.ndarray,
                           touched: Optional[np.ndarray] = None) -> int:
        """One-shot sealed segment at an explicit ``path`` — the
        ``spill_cold`` compat shim (each manual spill stays one
        addressable, immutable file). Refuses a path that is already a
        live segment (overwriting would lose its still-spilled rows)."""
        keys = np.ascontiguousarray(keys, np.uint64)
        if touched is None:
            touched = np.zeros(len(keys), bool)
        n = len(keys)
        blob = self._block_blob(keys, rows, touched)
        with self._io_lock:
            with self._lock:
                for s in self._segments.values():
                    if s.path == path and s.live > 0:
                        raise ValueError(
                            f"{path} already holds an active spill — "
                            "overwriting would lose its still-spilled "
                            "rows; use a fresh path per spill")
                seg = self._new_segment(path)
                seg.nbytes = len(blob)
                seg.rows = n
                seg.pending += 1
                seg.sealed = True
            try:
                if os.path.exists(path):
                    self._unlink(path)
                self._write_at(seg, 0, blob)
            except BaseException:
                with self._lock:
                    self._segments.pop(seg.seg_id, None)
                raise
            with self._lock:
                self._commit_block(seg, _BLOCK_HDR + n * 8 + n,
                                   keys, touched)
                seg.pending -= 1
                self.demoted_rows += n
        self._mirror()
        return n

    # ---- read path (promotion) -----------------------------------------
    def _read_rows(self, path: str, offs: np.ndarray) -> np.ndarray:
        """Gather rows at byte offsets ``offs`` from one segment file."""
        def read() -> np.ndarray:
            faults.inject("ssd.io", path=path, op=f"read:{path}")
            mm = np.memmap(path, dtype=np.uint8, mode="r")
            out = np.empty((len(offs), self.width), np.float32)
            w = self.width * 4
            for i, off in enumerate(offs.tolist()):
                out[i] = np.frombuffer(mm[off:off + w].tobytes(),
                                       np.float32)
            del mm
            return out
        return _io_retry().call(read)

    def take(self, keys: np.ndarray, book: bool = True
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Promote: read + REMOVE ``keys`` (the found subset) from the
        tier → (found_keys, rows [k, width], touched). Promoted keys
        leave the index atomically with the read, so no later fetch or
        export can observe the stale disk copy. ``book=False``
        (compaction) skips the promote counters/timers + mirror."""
        if len(keys) == 0:
            return (np.empty(0, np.uint64),
                    np.empty((0, self.width), np.float32),
                    np.empty(0, bool))
        t0 = time.perf_counter()
        critical = threading.current_thread() is threading.main_thread()
        with self._lock:
            found: List[int] = []
            locs: List[Tuple[int, int, bool]] = []
            seen = set()   # a duplicated key promotes (and deletes) once
            for k in np.ascontiguousarray(keys, np.uint64).tolist():
                ik = int(k)
                if ik in seen:
                    continue
                loc = self._index.get(ik)
                if loc is not None:
                    seen.add(ik)
                    found.append(k)
                    locs.append(loc)
            if not found:
                return (np.empty(0, np.uint64),
                        np.empty((0, self.width), np.float32),
                        np.empty(0, bool))
            fkeys = np.array(found, np.uint64)
            segs = np.array([l[0] for l in locs], np.int64)
            offs = np.array([l[1] for l in locs], np.int64)
            tch = np.array([l[2] for l in locs], bool)
            rows = np.empty((len(fkeys), self.width), np.float32)
            for sid in np.unique(segs):
                m = segs == sid
                rows[m] = self._read_rows(self._segments[int(sid)].path,
                                          offs[m])
            # removal AFTER the read succeeded: a transient read failure
            # (retried/raised above) must not lose the rows
            for k, sid in zip(found, segs.tolist()):
                del self._index[int(k)]
                self._segments[int(sid)].live -= 1
            self._drop_dead_segments()
            if book:
                self.promoted_rows += len(fkeys)
                dur = time.perf_counter() - t0
                self.promote_sec += dur
                if critical:
                    self.promote_wait_sec += dur
        if book:
            self._mirror()
        return fkeys, rows, tch

    def export_rows(self, delta: bool = False, clear_touched: bool = True
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Snapshot (keys, rows, touched) of every live row —
        ``delta=True`` restricts to touched rows (a pending
        ``save_delta`` export) and, with ``clear_touched``, marks them
        exported. Rows stay in the tier (export is a read)."""
        with self._lock:
            items = [(k, loc) for k, loc in self._index.items()
                     if not delta or loc[2]]
            if not items:
                return (np.empty(0, np.uint64),
                        np.empty((0, self.width), np.float32),
                        np.empty(0, bool))
            fkeys = np.array([k for k, _ in items], np.uint64)
            segs = np.array([loc[0] for _, loc in items], np.int64)
            offs = np.array([loc[1] for _, loc in items], np.int64)
            tch = np.array([loc[2] for _, loc in items], bool)
            rows = np.empty((len(fkeys), self.width), np.float32)
            for sid in np.unique(segs):
                m = segs == sid
                rows[m] = self._read_rows(self._segments[int(sid)].path,
                                          offs[m])
            if clear_touched:
                for k in fkeys.tolist():
                    sid, off, _ = self._index[int(k)]
                    self._index[int(k)] = (sid, off, False)
            return fkeys, rows, tch

    def clear_touched(self) -> int:
        """Drop the pending-delta bit from every tier row — the
        post-commit half of a STAGED export (HostStore.
        clear_touched_flags): index-only, no segment IO. Returns how
        many rows were marked."""
        n = 0
        with self._lock:
            for k, (sid, off, tch) in list(self._index.items()):
                if tch:
                    self._index[k] = (sid, off, False)
                    n += 1
        return n

    def discard(self, keys: np.ndarray) -> int:
        """Drop keys from the tier (shrink-deleted features, superseded
        demote snapshots) — their rows go dead; no stale copy can
        resurrect. Returns how many were present."""
        n = 0
        with self._lock:
            for k in np.ascontiguousarray(keys, np.uint64).tolist():
                loc = self._index.pop(int(k), None)
                if loc is not None:
                    self._segments[loc[0]].live -= 1
                    n += 1
            if n:
                self._drop_dead_segments()
        if n:
            self._mirror()
        return n

    def shrink(self, delete_threshold: float, decay: float,
               nonclk_coeff: float = 0.1, clk_coeff: float = 1.0,
               batch: int = 65536) -> int:
        """Age DEMOTED rows — the disk half of ShrinkTable (ctr_accessor
        shrink rules applied to rows RAM never sees): decay
        show/clk/delta_score, drop rows whose decayed score falls below
        threshold, rewrite the survivors. Rewrites go through
        take/append with ``book=False`` (compaction-style internal
        churn, not demote/promote traffic), so the vacated copies age
        their old segments toward ``maybe_compact``'s live-fraction
        trigger and fully-dead segments unlink immediately. Survivors'
        pending-delta (touched) bits are preserved; the decayed values
        themselves are NOT re-marked touched — a shrink cycle must be
        followed by a BASE save (train/checkpoint), which captures every
        live row regardless. Batched so the working set stays bounded on
        a large tier. Returns rows dropped."""
        keys = self.keys()
        dropped = 0
        for i in range(0, len(keys), batch):
            fkeys, rows, tch = self.take(keys[i:i + batch], book=False)
            if not len(fkeys):
                continue
            rows[:, 0:3] *= decay  # decay show/clk/delta_score
            score = (nonclk_coeff * (rows[:, 0] - rows[:, 1])
                     + clk_coeff * rows[:, 1])
            keep = score >= delete_threshold
            dropped += int((~keep).sum())
            if keep.any():
                self.append(fkeys[keep], rows[keep],
                            touched=tch[keep], book=False)
        if dropped:
            self._mirror()
        return dropped

    def clear(self) -> None:
        """Reset the tier (a wholesale host-store load: the old model's
        tiers don't carry over). Segment files unlink — they belong to
        the discarded model. Takes the writer lock too, so no in-flight
        append can land a block in an unlinked file."""
        with self._io_lock, self._lock:
            for s in self._segments.values():
                if not s.external and os.path.exists(s.path):
                    self._unlink(s.path)
            self._segments.clear()
            self._index.clear()
            self._active = None
        self._mirror()

    # ---- compaction ----------------------------------------------------
    def _drop_dead_segments(self) -> None:
        """Unlink segments with zero live rows (caller holds lock).
        Segments with a reserved-but-uncommitted block (``pending``)
        are about to gain live rows — never unlink under a writer."""
        dead = [sid for sid, s in self._segments.items()
                if s.live <= 0 and s.rows > 0 and s.pending == 0
                and sid != self._active]
        for sid in dead:
            s = self._segments.pop(sid)
            if not s.external and os.path.exists(s.path):
                self._unlink(s.path)

    def _unlink(self, path: str) -> None:
        def rm() -> None:
            faults.inject("ssd.io", path=path, op=f"unlink:{path}")
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass
        _io_retry().call(rm)

    def maybe_compact(self) -> int:
        """Rewrite sealed segments whose live fraction fell below
        ``compact_live_frac``: live rows re-append (index moves with
        them), the old file unlinks. Returns rows rewritten. Runs on
        the background demote worker — never on the pass critical
        path."""
        thr = self.compact_live_frac
        if thr <= 0:
            return 0
        moved = 0
        seen = set()
        while True:
            with self._lock:
                victim = None
                for sid in sorted(self._segments):
                    s = self._segments[sid]
                    if (s.sealed and sid != self._active and s.rows > 0
                            and sid not in seen
                            and 0 < s.live < thr * s.rows):
                        victim = sid
                        break
                if victim is None:
                    break
                seen.add(victim)
                live_keys = np.array(
                    [k for k, loc in self._index.items()
                     if loc[0] == victim], np.uint64)
            # rewrite OUTSIDE the index lock (append takes the writer
            # lock — holding _lock across it would invert the locking
            # order); book=False keeps the rows out of the real
            # demote/promote accounting and off the promote-wait
            # critical-path attribution. A key promoted between the
            # snapshot and the take simply isn't rewritten.
            fkeys, rows, tch = self.take(live_keys, book=False)
            if len(fkeys):
                self.append(fkeys, rows, tch, book=False)
                with self._lock:
                    self.compacted_rows += len(fkeys)
                moved += len(fkeys)
        if moved:
            log.info("ssd compact (%s): rewrote %d live rows", self.name,
                     moved)
            self._mirror()
        return moved

    # ---- spill manifest (checkpoint integration) -----------------------
    def manifest(self) -> Optional[dict]:
        """Seal the active segment and describe the tier for checkpoint
        meta: per-segment path + sha256 + row accounting. Sealing means
        every manifested file is immutable from here on — appends after
        this checkpoint open a NEW segment, so a digest mismatch on
        restore is always real corruption, never a legitimate append."""
        # writer lock first: an in-flight append must commit before we
        # seal/hash (no half-written tail can enter a digest)
        with self._io_lock, self._lock:
            if self._active is not None:
                seg = self._segments.get(self._active)
                if seg is not None and seg.rows > 0:
                    seg.sealed = True
                self._active = None
            segs = [s for s in sorted(self._segments.values(),
                                      key=lambda s: s.seg_id)
                    if s.live > 0]
            if not segs:
                return None
            for s in segs:   # sealed => immutable: hash once, reuse
                if s.sha256 is None:
                    s.sha256 = _io_retry().call(file_sha256, s.path)
            m = {
                "width": self.width,
                "live_rows": len(self._index),
                "segments": [{
                    "path": os.path.abspath(s.path),
                    "sha256": s.sha256,
                    "rows": int(s.rows),
                    "live": int(s.live),
                } for s in segs],
            }
            # one digest NAMING this tier state — what an artifact
            # manifest records as its spill-manifest REFERENCE
            # (artifacts.py refs block): location-independent (segment
            # basenames, not paths), so the same tier content yields
            # the same reference wherever the registry lives
            m["digest"] = manifest_digest(m)
            return m

    # ---- telemetry -----------------------------------------------------
    _MIRRORED = (("demoted_rows", "pbox_ssd_demoted_rows_total",
                  "rows demoted host-RAM -> SSD tier"),
                 ("promoted_rows", "pbox_ssd_promoted_rows_total",
                  "rows promoted SSD tier -> host RAM"),
                 ("compacted_rows", "pbox_ssd_compacted_rows_total",
                  "live rows rewritten by segment compaction"),
                 ("demote_sec", "pbox_ssd_demote_seconds_total",
                  "seconds spent writing demoted rows to segments"),
                 ("promote_sec", "pbox_ssd_promote_seconds_total",
                  "seconds spent reading promoted rows from segments"),
                 ("promote_wait_sec",
                  "pbox_ssd_promote_wait_seconds_total",
                  "promote seconds paid on the MAIN thread (critical "
                  "path; stage-thread promotes overlap training)"))

    def _mirror(self) -> None:
        """Mirror the cumulative accounting into hub counters (inc by
        delta since the last mirror) + occupancy gauges."""
        try:
            hub = get_hub()
            if not hub.active:
                return
            st = self.stats()
            last = getattr(self, "_mirrored", None)
            if last is None:
                last = self._mirrored = {}
            for attr, name, help_ in self._MIRRORED:
                delta = st[attr] - last.get(attr, 0.0)
                if delta > 0:
                    hub.counter(name, help_).inc(delta)
                last[attr] = st[attr]
            hub.gauge("pbox_ssd_segments",
                      "live SSD tier segment files").set(st["segments"])
            hub.gauge("pbox_ssd_bytes",
                      "bytes held by SSD tier segments").set(st["bytes"])
            hub.gauge("pbox_ssd_live_rows",
                      "rows resident only in the SSD tier").set(
                          st["live_rows"])
        except Exception:
            log.debug("ssd telemetry mirror failed", exc_info=True)


def manifest_digest(manifest: dict) -> str:
    """Stable sha256 naming a spill manifest's CONTENT: the sorted
    (segment basename, sha256, rows) triples + width/live_rows. Used
    as the spill-manifest reference in artifact manifests
    (artifacts.py / train/checkpoint._publish_artifact) — two
    checkpoints whose tiers hold the same bytes reference the same
    digest, path layout notwithstanding."""
    h = hashlib.sha256()
    h.update(f"w{manifest.get('width')}:n{manifest.get('live_rows')}"
             .encode())
    for seg in sorted(manifest.get("segments", []),
                      key=lambda s: os.path.basename(s["path"])):
        h.update(os.path.basename(seg["path"]).encode())
        h.update(str(seg["sha256"]).encode())
        h.update(str(seg.get("rows", 0)).encode())
    return h.hexdigest()


def verify_manifest(manifest: dict) -> List[str]:
    """Check every manifested segment still on disk against its
    recorded sha256; raises ``SegmentCorruptError`` on the first
    mismatch. Missing files are FINE (compaction unlinks segments and
    a tier reset clears them — the checkpoint itself is self-contained)
    and are returned for the caller's log."""
    missing: List[str] = []
    for seg in manifest.get("segments", []):
        path = seg["path"]
        if not os.path.isfile(path):
            missing.append(path)
            continue
        got = _io_retry().call(file_sha256, path)
        if got != seg["sha256"]:
            raise SegmentCorruptError(
                f"SSD segment {path} is corrupt: sha256 {got[:12]}… != "
                f"manifest {seg['sha256'][:12]}… — refuse to trust the "
                "spill tier; restore re-imports rows from the "
                "checkpoint itself after the operator clears the tier "
                "directory")
    return missing
