"""Dataset hierarchy: file-loaded and streaming slot datasets with the pass
lifecycle (counterpart of ``paddlebox_tpu/data/dataset.py``).

Reference: paddle/fluid/framework/data_set.{h,cc} — ``Dataset`` interface
(data_set.h:58: filelist, thread num, load/release, local/global shuffle),
``MultiSlotDataset``, ``PadBoxSlotDataset`` (:466 — pass dataset with
preload/wait, MergeInsKeys, MPI global shuffle) — and the Python surface
python/paddle/fluid/dataset.py (``DatasetFactory`` :24, ``InMemoryDataset``
:399, ``QueueDataset`` :1191, ``BoxPSDataset`` :1313).

Readers are threads feeding a ``Channel`` (a pipe subprocess per file only
with ``pipe_command``); records are numpy-columnar; the plain in-memory
load parses whole files natively (``native/slot_parser.cpp``) straight
into the columnar store, one file per pool thread with the GIL released.
Every dataset records the route that loaded it in ``parse_route``
("native" or "python") with the reason in ``parse_route_reason``; a
native library that cannot be built raises instead of turning into the
per-line route.

Telemetry (``obs/``): ``pbox_files_quarantined_total`` with a
``file_quarantined`` event, ``pbox_records_poisoned_total``,
``pbox_stream_replayed_files_total`` with a ``stream_replay`` event, and
one ``read.file`` trace span per file on the ``stream.reader`` lane of
the per-line reader threads.
"""

from __future__ import annotations

import dataclasses
import glob as globlib
import hashlib
import logging
import os
import random
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from paddlebox_tpu_torch.config import FLAGS
from paddlebox_tpu_torch.data.batch import BatchBuilder, SlotBatch
from paddlebox_tpu_torch.data.columnar import ColumnarRecords
from paddlebox_tpu_torch.data.parser import get_parser
from paddlebox_tpu_torch.data.pv import merge_by_insid
from paddlebox_tpu_torch.data.record import SlotRecord
from paddlebox_tpu_torch.data.schema import DataFeedDesc
from paddlebox_tpu_torch.obs import trace
from paddlebox_tpu_torch.obs.hub import get_hub
from paddlebox_tpu_torch.native import NativeBuildError
from paddlebox_tpu_torch.resilience import faults
from paddlebox_tpu_torch.resilience.retry import RetryPolicy, TransientError
from paddlebox_tpu_torch.utils.channel import Channel, ChannelClosed
from paddlebox_tpu_torch.utils.monitor import stat_add

log = logging.getLogger(__name__)


def chain_digest(digest: str, files: Sequence[str]) -> str:
    """Left-fold a chained sha256 over ``files`` starting from
    ``digest`` (``""`` for an empty chain). Incremental by construction:
    ``chain_digest(chain_digest("", a), b) == chain_digest("", a + b)``
    — the stream cursor's folded-history fingerprint (a resumed run
    re-derives the whole chain from the filelist prefix and compares;
    ``Trainer._adopt_cursor`` / ``QueueDataset.adopt_stream_cursor``).
    Byte for byte the reference's, so either package adopts the other's
    cursors."""
    for f in files:
        digest = hashlib.sha256(
            (digest + "\n" + str(f)).encode()).hexdigest()
    return digest


class PoisonedFileError(RuntimeError):
    """A file blew its per-file poison-record budget
    (``FLAGS.poison_budget_records``): more lines failed to parse than
    the budget tolerates — the file is treated as corrupt as a whole and
    becomes a quarantine candidate."""

    def __init__(self, path: str, bad: int, budget: int) -> None:
        super().__init__(
            f"{path}: {bad} unparseable record(s) exceeds the per-file "
            f"poison budget ({budget}) — file is poisoned")
        self.path = path
        self.bad = bad


class PoisonBudgetExceeded(RuntimeError):
    """The load quarantined more files than ``FLAGS.poison_budget_files``
    allows — the pass is broken beyond graceful degradation."""


def shard_filelist(files: Sequence[str], rank: Optional[int] = None,
                   world: Optional[int] = None) -> List[str]:
    """This host's round-robin slice of a file list; rank/world default to
    the launcher env (PBOX_RANK / PBOX_WORLD_SIZE)."""
    if rank is None:
        rank = int(os.environ.get("PBOX_RANK", "0"))
    if world is None:
        world = int(os.environ.get("PBOX_WORLD_SIZE", "1"))
    if world <= 1:
        return list(files)
    if rank >= world or rank < 0:
        raise ValueError(f"rank {rank} out of range for world {world}")
    return list(files[rank::world])


def _slots_shuffle_columnar(col: ColumnarRecords, sel_slots: np.ndarray,
                            d: np.ndarray) -> ColumnarRecords:
    """Vectorized SlotsShuffle over a ColumnarRecords store: record i
    keeps its non-selected slots and takes the selected slots' feasigns
    from donor record ``d[i]``."""
    n = col.num_records
    if n == 0:
        return col
    counts = np.diff(col.offsets)
    rec_of_key = np.repeat(np.arange(n, dtype=np.int64), counts)
    mask = np.isin(col.key_slot, sel_slots)
    keep = ~mask
    # CSR of the selected-slot keys, per record
    mrec = rec_of_key[mask]
    mcount = np.bincount(mrec, minlength=n).astype(np.int64)
    moff = np.zeros(n + 1, np.int64)
    np.cumsum(mcount, out=moff[1:])
    glen = moff[d + 1] - moff[d]
    tot = int(glen.sum())
    # concat-of-ranges: indices into the masked arrays for each donor span
    base = np.cumsum(glen) - glen
    idx = (np.arange(tot, dtype=np.int64) - np.repeat(base, glen)
           + np.repeat(moff[d], glen))
    all_keys = np.concatenate([col.keys[keep], col.keys[mask][idx]])
    all_slot = np.concatenate([col.key_slot[keep], col.key_slot[mask][idx]])
    all_rec = np.concatenate([rec_of_key[keep],
                              np.repeat(np.arange(n, dtype=np.int64), glen)])
    order = np.lexsort((all_slot, all_rec))  # keys stay slot-grouped
    new_counts = np.bincount(all_rec, minlength=n).astype(np.int64)
    new_off = np.zeros(n + 1, np.int64)
    np.cumsum(new_counts, out=new_off[1:])
    return dataclasses.replace(col, keys=all_keys[order],
                               key_slot=all_slot[order], offsets=new_off)


class Dataset:
    """Base: file list + schema + threaded readers."""

    #: True when ``batches(start_batch=k)`` is deterministic — the
    #: in-memory datasets, whose batch order is a pure function of
    #: (filelist, seed). Streaming readers interleave threads, so the
    #: mid-pass resume cursor only applies here.
    supports_cursor_resume = False

    #: True when ``batches()`` may be called more than once and yields
    #: the SAME stream each time (the loaded order is frozen in memory).
    #: Streaming datasets consume their readers. Two-phase pass builds
    #: (the q8 streaming front, train/device_pass._front) key off this.
    supports_reiteration = False

    def __init__(self, desc: Optional[DataFeedDesc] = None) -> None:
        self.desc = desc or DataFeedDesc()
        self.filelist: List[str] = []
        self.thread_num = FLAGS.read_thread_num
        self._builder: Optional[BatchBuilder] = None
        # files isolated by the current/last load: [(path, error_repr)]
        self.quarantined_files: List[Tuple[str, str]] = []
        self._quarantine_lock = threading.Lock()
        # entries in quarantined_files that were PRESEEDED (a resumed
        # cursor's prior decisions) rather than discovered by this
        # process — they must not consume the FLAGS.poison_budget_files
        # budget
        self._quarantine_preseeded = 0
        # the route of the last load or stream: "native" (the bulk C++
        # parse) or "python" (per line over the reader threads), and why
        self.parse_route: Optional[str] = None
        self.parse_route_reason = ""

    # --- config surface (mirrors dataset.py setters) ---
    def set_feed_desc(self, desc: DataFeedDesc) -> None:
        self.desc = desc
        self._builder = None

    def set_filelist(self, files: Sequence[str],
                     shard_by_rank: bool = False) -> None:
        """``shard_by_rank=True`` keeps only this host's round-robin slice
        of the file list (multi-host input sharding — each reference MPI
        rank reads its own file subset before the cross-rank global
        shuffle). Rank/world come from the launcher's env."""
        files = list(files)
        if shard_by_rank:
            files = shard_filelist(files)
        self.filelist = files

    def set_glob(self, pattern: str, shard_by_rank: bool = False) -> None:
        self.set_filelist(sorted(globlib.glob(pattern)),
                          shard_by_rank=shard_by_rank)

    def filelist_fingerprint(self) -> str:
        """Order-sensitive digest of the pass's file list — the resume
        cursor's identity check (checkpoint ``cursor.json``): a cursor
        only applies to a pass over the SAME files in the same order.
        The reference's digest, byte for byte."""
        h = hashlib.sha256()
        for p in self.filelist:
            h.update(p.encode())
            h.update(b"\0")
        return h.hexdigest()[:16]

    def set_batch_size(self, bs: int) -> None:
        self.desc.batch_size = bs

    def set_thread(self, n: int) -> None:
        self.thread_num = n

    @property
    def builder(self) -> BatchBuilder:
        if self._builder is None:
            self._builder = BatchBuilder(self.desc)
        return self._builder

    def _set_route(self, route: str, reason: str) -> None:
        self.parse_route = route
        self.parse_route_reason = reason

    def _per_line_reason(self) -> Optional[str]:
        """Why a load of this dataset must parse per line, or None when
        the native bulk parse may run (the plain in-memory dataset with
        ``FLAGS.native_parse``, no ``pipe_command`` and no
        merge_by_lineid — the reference's rule)."""
        if not FLAGS.native_parse:
            return "FLAGS.native_parse is off"
        if self.desc.pipe_command:
            return "pipe_command"
        if type(self) is not InMemoryDataset:
            return f"{type(self).__name__} reads records"
        if getattr(self, "_merge_size", None) is not None:
            return "merge_by_lineid"
        return None

    # --- failure isolation ---
    def _reset_quarantine(self) -> None:
        with self._quarantine_lock:
            self.quarantined_files = []
            self._quarantine_preseeded = 0

    def _quarantine(self, path: str, exc: BaseException) -> bool:
        """Try to isolate a per-file failure instead of killing the load.
        Returns False (caller must abort) when the failure is not
        file-scoped (consumer gone / interrupt) or the quarantine budget
        (``FLAGS.poison_budget_files``) is spent."""
        if not isinstance(exc, Exception) or isinstance(exc, ChannelClosed):
            return False  # consumer-side close / interrupt: not the file
        budget = FLAGS.poison_budget_files
        with self._quarantine_lock:
            mine = len(self.quarantined_files) - self._quarantine_preseeded
            if budget <= 0 or mine >= budget:
                return False
            self.quarantined_files.append((path, repr(exc)))
        log.warning("quarantined bad file %s: %r (budget %d/%d)", path,
                    exc, mine + 1, budget)
        stat_add("files_quarantined", 1)
        try:
            hub = get_hub()
            hub.counter("pbox_files_quarantined_total",
                        "dataset files isolated after a failure").inc()
            if hub.active:
                hub.emit("file_quarantined", path=path, error=repr(exc))
        except Exception:
            log.debug("quarantine telemetry emit failed", exc_info=True)
        return True

    def _budget_exceeded(self, path: str, exc: Exception
                         ) -> PoisonBudgetExceeded:
        budget = FLAGS.poison_budget_files
        err = PoisonBudgetExceeded(
            f"quarantine budget exhausted ({budget} file(s), FLAGS."
            f"poison_budget_files) and {path} also failed: {exc!r}")
        err.__cause__ = exc
        return err

    # --- reading ---
    def _read_files_into(self, files: Sequence[str], out: Channel,
                         n_threads: int) -> "ReaderGroup":
        """Start ``n_threads`` reader threads that parse ``files`` (taken
        in order from a file channel) line by line into ``out``. Per-file
        failures go to the quarantine when the budget allows; anything
        else lands in the group's ``errors`` and stops that reader."""
        file_ch: Channel[str] = Channel(capacity=len(files) + 1)
        for f in files:
            file_ch.put(f)
        file_ch.close()
        group = ReaderGroup()

        pipe_cmd = self.desc.pipe_command
        record_budget = FLAGS.poison_budget_records
        open_retry = RetryPolicy.from_flags(
            site="dataset.open", retryable=(OSError, TransientError))

        def parse_lines(parser, lines, path) -> Tuple[int, int]:
            n_ok = n_bad = 0
            for line in lines:
                line = faults.inject("parser.record", line, path=path)
                rec = parser.parse(line)
                if rec is None:
                    n_bad += 1
                    if 0 <= record_budget < n_bad:
                        raise PoisonedFileError(path, n_bad, record_budget)
                    continue
                out.put(rec)
                n_ok += 1
            return n_ok, n_bad

        def open_file(path: str, mode: str):
            # the fault seam sits INSIDE the retried callable, so an
            # injected (or real) transient open failure exercises the
            # retry before it can count against the quarantine budget
            faults.inject("dataset.open", path=path)
            return open(path, mode)

        def read_one(parser, path: str) -> None:
            faults.inject("reader.file", path=path)
            if pipe_cmd:
                # LoadIntoMemoryByCommand (data_feed.h:1674): the file
                # streams through a shell command; the parser consumes
                # its stdout
                with open_retry.call(open_file, path, "rb") as fh:
                    proc = subprocess.Popen(
                        pipe_cmd, shell=True, stdin=fh,
                        stdout=subprocess.PIPE, text=True)
                    try:
                        n_ok, n_bad = parse_lines(parser, proc.stdout,
                                                  path)
                    except BaseException:
                        proc.kill()  # don't leak a blocked child
                        proc.wait()
                        raise
                    finally:
                        proc.stdout.close()
                    if proc.wait() != 0:
                        raise RuntimeError(
                            f"pipe_command {pipe_cmd!r} failed "
                            f"(rc={proc.returncode}) on {path}")
            else:
                with open_retry.call(open_file, path, "r") as fh:
                    n_ok, n_bad = parse_lines(parser, fh, path)
            stat_add("records_parsed", n_ok)
            stat_add("records_dropped", n_bad)
            if n_bad:
                get_hub().counter(
                    "pbox_records_poisoned_total",
                    "records dropped as unparseable").inc(n_bad)

        def worker() -> None:
            trace.set_lane(trace.LANE_READER)
            parser = get_parser(self.desc)
            for path in file_ch:
                try:
                    with trace.span("read.file", file=path):
                        read_one(parser, path)
                except BaseException as e:
                    if isinstance(e, ChannelClosed):
                        # the CONSUMER cancelled the output channel
                        # (abandoned stream) — a clean shutdown, never a
                        # reader error
                        return
                    # isolate the failure to this file when the poison
                    # budget allows; surviving readers drain the rest of
                    # the file list
                    if self._quarantine(path, e):
                        continue
                    if FLAGS.poison_budget_files > 0 and \
                            isinstance(e, Exception):
                        # the budget was on and is now spent: name the
                        # condition instead of surfacing whatever the
                        # last file happened to raise
                        group.errors.append(self._budget_exceeded(path, e))
                    else:
                        group.errors.append(e)
                    return

        group.threads = [threading.Thread(target=worker, daemon=True,
                                          name=f"pbox-reader-{i}")
                         for i in range(max(1, n_threads))]
        for t in group.threads:
            t.start()
        return group


class ReaderGroup:
    """Reader threads + their errors; join() re-raises the first failure so
    a dead reader never silently truncates a pass (per-file failures that
    fit the poison budget are quarantined by the dataset instead and never
    reach ``errors``)."""

    def __init__(self) -> None:
        self.threads: List[threading.Thread] = []
        self.errors: List[BaseException] = []

    def join(self) -> None:
        for t in self.threads:
            t.join()
        if self.errors:
            raise self.errors[0]


class InMemoryDataset(Dataset):
    """Load-everything-then-iterate dataset (reference dataset.py:399).

    Callers may also fill ``records`` themselves (no filelist: nothing is
    loaded or quarantined). ``pass_keys`` is the deduped pass key-set — the
    ``MergeInsKeys``/``PSAgentBase::AddKey`` role (data_set.cc:2423) that
    feeds the embedding store's per-pass working set."""

    def __init__(self, desc: Optional[DataFeedDesc] = None) -> None:
        super().__init__(desc)
        self.records: List[SlotRecord] = []
        # whether the loaded order is a pure function of (filelist,
        # seed): the native columnar load concatenates per-file chunks
        # in filelist order; the threaded per-line path's channel
        # fan-in order is timing-dependent unless ONE reader drains the
        # list. Cursor resume keys off this.
        self._det_order = True
        self._pass_keys: Optional[np.ndarray] = None
        self.columnar: Optional[ColumnarRecords] = None  # columnarize()
        self._fea_eval = False
        self._fea_eval_candidates = 10000
        self._merge_size: Optional[int] = None  # set_merge_by_lineid

    def load_into_memory(self) -> None:
        if not self.filelist:
            raise ValueError("set_filelist first")
        self._reset_quarantine()
        # native columnar fast path: only for the plain in-memory dataset —
        # subclasses (PaddleBoxDataset) run record-level pass protocols
        # (global shuffle / key merge) that need SlotRecord objects
        reason = self._per_line_reason()
        if reason is None:
            if self._load_columnar_native():
                return
            reason = f"parser {self.desc.parser!r} has no native parse"
        ch: Channel[SlotRecord] = Channel(capacity=FLAGS.channel_capacity,
                                          name="dataset.load_records")
        group = self._read_files_into(self.filelist, ch, self.thread_num)

        def closer() -> None:
            for t in group.threads:
                t.join()
            ch.close()

        threading.Thread(target=closer, daemon=True).start()
        self.records = list(ch)
        group.join()  # re-raise reader errors
        self.columnar = None
        self._pass_keys = None
        self._det_order = self.thread_num <= 1
        self._set_route("python", reason)
        log.info("loaded %d records from %d files (per line: %s)",
                 len(self.records), len(self.filelist), reason)
        if self.quarantined_files:
            log.warning("load quarantined %d file(s): %s",
                        len(self.quarantined_files),
                        [p for p, _ in self.quarantined_files])
        if self._merge_size is not None:
            self.merge_records_by_insid()

    def _load_columnar_native(self) -> bool:
        """Native bulk parse: file bytes → columnar arrays per file (C++,
        GIL released during the ctypes call so files parse in parallel),
        concatenated in filelist order straight into the ColumnarRecords
        store — the whole per-record python layer is skipped. Returns
        False when the parser has no native fast path (the per-line path
        runs instead)."""
        parser = get_parser(self.desc)

        def parse_guarded(path: str) -> Optional[dict]:
            """Per-file isolation for the native path: a file whose bulk
            parse fails is quarantined (budget permitting) instead of
            killing the load; returns None for a quarantined file."""
            try:
                faults.inject("dataset.open", path=path)
                return parser.parse_file_columnar(path)
            except NativeBuildError:
                raise  # the library, not this file: no quarantine
            except Exception as e:
                if self._quarantine(path, e):
                    return None
                if FLAGS.poison_budget_files > 0:
                    raise self._budget_exceeded(path, e) from e
                raise

        # probe the first healthy file for a native fast path at all;
        # on fallback the per-line path re-reads EVERY file, so any
        # quarantine state this aborted attempt accumulated is reset
        # (budget returned, no stale/duplicate entries)
        probe = None
        rest: List[str] = []
        for i, path in enumerate(self.filelist):
            probe = parse_guarded(path)
            if probe is not None:
                rest = list(self.filelist[i + 1:])
                break
            if not self.quarantined_files or \
                    self.quarantined_files[-1][0] != path:
                self._reset_quarantine()
                return False  # no native parser — per-line route
        else:
            self._reset_quarantine()
            return False  # every file quarantined (or list empty)
        with ThreadPoolExecutor(max(1, self.thread_num)) as ex:
            chunks = [probe] + [c for c in ex.map(parse_guarded, rest)
                                if c is not None]
        n_rec = sum(len(c["label"]) for c in chunks)
        n_drop = sum(int(c.get("dropped", 0)) for c in chunks)
        offsets = np.zeros(n_rec + 1, np.int64)
        pos, kpos = 0, 0
        for c in chunks:
            m = len(c["label"])
            offsets[pos + 1:pos + m + 1] = c["offsets"][1:] + kpos
            pos += m
            kpos += int(c["offsets"][-1])

        def cat(f: str) -> np.ndarray:
            return np.concatenate([c[f] for c in chunks])

        self.columnar = ColumnarRecords(
            keys=cat("keys"), key_slot=cat("key_slot"), offsets=offsets,
            dense=cat("dense"), label=cat("label"), show=cat("show"),
            clk=cat("clk"),
            # text formats carry no metadata columns — default like the
            # record path does (SlotRecord field defaults)
            uid=np.zeros(n_rec, np.int64), rank=np.zeros(n_rec, np.int32),
            cmatch=np.zeros(n_rec, np.int32),
            timestamp=np.zeros(n_rec, np.int64))
        self.records = []
        self._pass_keys = None
        self._det_order = True  # chunks concatenate in filelist order
        self._set_route("native", f"native {self.desc.parser} parse")
        stat_add("records_parsed", n_rec)
        stat_add("records_dropped", n_drop)
        log.info("native-parsed %d records from %d files (columnar, "
                 "%d lines dropped)", n_rec, len(self.filelist), n_drop)
        return True

    def columnarize(self) -> None:
        """Convert the loaded pass to the columnar store (data/columnar.py)
        for vectorized batch building, once per pass, and release the
        records; the batches and the resident pass's front read the store
        from then on."""
        if self.columnar is not None and not self.records:
            return  # already columnar (native load path)
        self.columnar = ColumnarRecords.from_records(self.records,
                                                     self.desc.dense_dim)
        self.records = []

    @property
    def supports_cursor_resume(self) -> bool:
        """True when ``batches(start_batch=k)`` reproduces the original
        stream: the native columnar load (filelist-order concat) always
        does; the threaded per-line path only with ONE reader thread —
        multi-thread channel fan-in order is timing-dependent, so a
        resumed process could not rebuild the same batch order and the
        cursor would splice two different streams."""
        return self._det_order

    @supports_cursor_resume.setter
    def supports_cursor_resume(self, value: bool) -> None:
        """A caller that fills ``records`` itself says whether their
        order is fixed."""
        self._det_order = bool(value)

    # once loaded, the record/columnar order is frozen in memory, so
    # batches() replays the same stream regardless of how deterministic
    # the LOAD itself was (supports_cursor_resume is about reloading in
    # a fresh process; this is about re-walking this one)
    supports_reiteration = True

    def release_memory(self) -> None:
        self.records = []
        self.columnar = None
        self._pass_keys = None

    def local_shuffle(self, seed: Optional[int] = None) -> None:
        if self.columnar is not None:
            self.columnar = self.columnar.shuffle(
                FLAGS.seed if seed is None else seed)
            return
        rng = random.Random(FLAGS.seed if seed is None else seed)
        rng.shuffle(self.records)

    def global_shuffle(self, shuffler: Optional["Shuffler"] = None,
                       seed: Optional[int] = None) -> None:
        """Cross-host record exchange by hash — data_set.cc:2573
        ShuffleData. Single-host default degenerates to local_shuffle.
        Must run BEFORE columnarize(): the exchange moves record objects
        between hosts."""
        if shuffler is not None:
            if self.columnar is not None:
                raise RuntimeError(
                    "global_shuffle(shuffler) needs record objects, but "
                    "this dataset is already columnar (columnarize() was "
                    "called, or the native parse fast path loaded it "
                    "columnar directly — set FLAGS.native_parse=False "
                    "before load_into_memory for cross-host exchange)")
            self.records = shuffler.exchange(self.records)
            self._pass_keys = None
        self.local_shuffle(seed)

    def set_merge_by_lineid(self, merge_size: int = 2) -> None:
        """Merge records sharing an ins_id after load (reference
        dataset.py ``set_merge_by_lineid``; MergeByInsId data_set.cc:1517).
        Applied by ``merge_records_by_insid`` or automatically at the end
        of ``load_into_memory`` when set."""
        self._merge_size = int(merge_size)

    def merge_records_by_insid(self) -> int:
        """Run the ins_id merge now; returns the dropped-record count."""
        if self.columnar is not None:
            raise RuntimeError("merge_by_insid needs record objects; call "
                               "it before columnarize()")
        ms = self._merge_size if self._merge_size is not None else 2
        self.records, dropped = merge_by_insid(
            self.records, ms, len(self.desc.sparse_slots))
        if dropped:
            log.warning("merge_by_insid dropped %d records", dropped)
        stat_add("records_dropped_by_merge", dropped)
        self._pass_keys = None
        return dropped

    def set_fea_eval(self, record_candidate_size: int = 10000,
                     fea_eval: bool = True) -> None:
        """Enable feature-evaluation mode — precondition for
        ``slots_shuffle`` (reference dataset.py:143 ``set_fea_eval``;
        ``slots_shuffle_fea_eval_`` guard, data_set.cc:1858)."""
        self._fea_eval = fea_eval
        self._fea_eval_candidates = int(record_candidate_size)

    def slots_shuffle(self, slots: Sequence) -> None:
        """Replace the chosen sparse slots' feasigns in every record with
        the feasigns of a RANDOM OTHER record, in place — destroying the
        slot's per-instance signal while preserving its marginal
        distribution (feature-importance eval; MultiSlotDataset::
        SlotsShuffle + GetRandomData, data_set.cc:1713-1881). The donors
        are drawn from ``FLAGS.seed``, as the reference draws them.

        ``slots`` holds sparse slot names or indices. Works on both the
        record-object store and the columnar store."""
        if not self._fea_eval:
            raise RuntimeError(
                "fea eval mode off, need set_fea_eval() for slots_shuffle")
        sel = np.array(
            [self.desc.sparse_slot_index(s) if isinstance(s, str) else int(s)
             for s in slots], dtype=np.int64)
        rng = np.random.default_rng(FLAGS.seed)
        n = len(self.columnar.label) if self.columnar is not None \
            else len(self.records)
        # donor choice: a permutation when the candidate pool spans the
        # pass; a capped random pool otherwise (RecordCandidateList
        # reservoir semantics — set_fea_eval's record_candidate_size)
        cap = self._fea_eval_candidates
        if cap >= n:
            perm = rng.permutation(n)
        else:
            pool = rng.choice(n, size=cap, replace=False)
            perm = pool[rng.integers(0, cap, size=n)]
        if self.columnar is not None:
            self.columnar = _slots_shuffle_columnar(self.columnar, sel,
                                                    perm)
        elif self.records:
            sel_set = set(int(s) for s in sel)
            num_slots = len(self.desc.sparse_slots)
            # snapshot donor spans BEFORE mutating (GetRandomData reads the
            # originals, data_set.cc:1720)
            donor_spans = [
                {s: self.records[perm[i]].slot_keys(s).copy()
                 for s in sel_set} for i in range(n)]
            for i, rec in enumerate(self.records):
                chunks, offs = [], [0]
                for s in range(num_slots):
                    span = (donor_spans[i][s] if s in sel_set
                            else rec.slot_keys(s))
                    chunks.append(span)
                    offs.append(offs[-1] + len(span))
                rec.keys = (np.concatenate(chunks) if chunks
                            else np.empty(0, np.uint64))
                rec.slot_offsets = np.array(offs, dtype=np.int32)
        self._pass_keys = None

    def pass_keys(self) -> np.ndarray:
        """Deduped uint64 key-set of the loaded pass."""
        if self._pass_keys is None:
            if self.columnar is not None:
                self._pass_keys = np.unique(self.columnar.keys)
            elif self.records:
                all_keys = np.concatenate([r.keys for r in self.records])
                self._pass_keys = np.unique(all_keys)
            else:
                self._pass_keys = np.empty(0, dtype=np.uint64)
        return self._pass_keys

    def pass_key_slots(self) -> Tuple[np.ndarray, np.ndarray]:
        """(unique keys, slot id of each) — the pass working set WITH
        slots, for tables whose routing needs the slot (multi-mf tiered:
        a key's dim class is its slot's property).

        CONTRACT: a key value must belong to exactly ONE slot (CTR
        feasigns are slot-qualified — the native parser bakes
        ``(slot+1) << 52`` into every key). A key seen under two slots
        would stage into only one dim class and silently reset its other
        class's values each pass, so that case raises here."""
        def check_and_split(all_keys, all_slots):
            keys, first = np.unique(all_keys, return_index=True)
            pairs = np.unique(np.stack(
                [all_keys, all_slots.astype(np.uint64)]), axis=1)
            if pairs.shape[1] != len(keys):
                raise ValueError(
                    "pass_key_slots: some key value appears under more "
                    "than one slot — multi-mf routing requires "
                    "slot-qualified keys (one slot per key value)")
            return keys, all_slots[first].astype(np.int32)

        if self.columnar is not None:
            return check_and_split(self.columnar.keys,
                                   self.columnar.key_slot)
        if self.records:
            all_keys = np.concatenate([r.keys for r in self.records])
            all_slots = np.concatenate([
                np.repeat(np.arange(len(r.slot_offsets) - 1,
                                    dtype=np.int32),
                          np.diff(r.slot_offsets))
                for r in self.records])
            return check_and_split(all_keys, all_slots)
        return (np.empty(0, dtype=np.uint64), np.empty(0, dtype=np.int32))

    def __len__(self) -> int:
        if self.columnar is not None and not self.records:
            return self.columnar.num_records
        return len(self.records)

    def batches(self, drop_last: bool = False,
                start_batch: int = 0) -> Iterator[SlotBatch]:
        """Batches of ``desc.batch_size`` records in order; the last one
        may be short unless ``drop_last``. ``start_batch=k`` skips the
        first k batches WITHOUT building them (cursor resume: the skipped
        prefix was already trained before the preemption)."""
        if self.columnar is not None:
            yield from self.columnar.batches(
                self.desc, len(self.desc.sparse_slots), drop_last,
                start_batch=start_batch)
            return
        bs = self.desc.batch_size
        n = len(self.records)
        for i in range(start_batch * bs, n, bs):
            chunk = self.records[i:i + bs]
            if len(chunk) < bs and drop_last:
                return
            yield self.builder.build(chunk)


class QueueDataset(Dataset):
    """Streaming dataset: batches come off the reader channel without
    materializing the pass (reference dataset.py:1191).

    **Windowed streaming** (``FLAGS.stream_window_files > 0``): the
    filelist is consumed in bounded windows of N files. No record crosses
    a window boundary (the tail batch of each window is flushed short),
    fully-consumed files are tracked across ``batches()`` calls, and the
    trainer's v2 stream cursor (``Trainer._pass_cursor`` →
    ``cursor.json``) records the completed-file set plus the open window
    — a restarted process skips completed files and REPLAYS the open
    window, so a preempted unbounded stream loses no completed-window
    data and re-trains at most one window (**at-least-once** for the open
    window, exactly-once for completed windows; never exactly-once end to
    end). ``supports_cursor_resume`` is therefore True in windowed mode
    only; the unwindowed stream keeps refusing ``start_batch != 0``.

    Window completion is tied to CONSUMPTION, not read-ahead: the
    generator records, per window, the yield count of its final batch
    (``mark``), and :meth:`stream_cursor_state` only counts a window
    completed once the trainer reports that many batches TRAINED — a
    prefetch pipeline pulling batches ahead of training can never get a
    half-trained window declared complete."""

    def __init__(self, desc: Optional[DataFeedDesc] = None) -> None:
        super().__init__(desc)
        # --- windowed streaming state (survives across batches() calls;
        # guarded by _stream_lock: the generator runs on a prefetch
        # producer thread while the trainer snapshots cursors) ---
        self._stream_lock = threading.Lock()
        self._files_completed: List[str] = []  # fully-consumed files
        # cursor compaction (fold_completed_history): the first
        # _folded_count entries of _files_completed are ALSO summarized
        # by the chained fingerprint — serialized cursors carry only
        # {count, sha256} for them, not the names
        self._folded_count = 0
        self._folded_digest = ""
        self._windows: List[dict] = []   # open pass: {"files", "mark"}
        self._skip_files: set = set()    # preseeded quarantine decisions
        self._replay_files: List[str] = []  # adopted open window
        self.windows_completed = 0
        self.files_replayed = 0

    # ---- windowed-mode surface ----
    @property
    def windowed(self) -> bool:
        return FLAGS.stream_window_files > 0

    @property
    def supports_cursor_resume(self) -> bool:
        """True only in windowed mode — and then with the AT-LEAST-ONCE
        caveat: resume replays the whole open window, it does not splice
        back into a thread-interleaved batch stream (which is why the
        unwindowed stream still refuses)."""
        return self.windowed

    @property
    def files_completed(self) -> List[str]:
        """Fully-consumed files, in consumption order. Folding is tied
        to CONSUMPTION (``note_batches_consumed``, called by the
        trainer per trained batch), never to generator read-ahead — an
        abandoned/preempted stream leaves its unconsumed windows
        unfolded, so they replay."""
        with self._stream_lock:
            return list(self._files_completed)

    def fold_completed_history(self) -> int:
        """Compact the cursor's completed-file history: fold every file
        completed so far into a count + chained ``chain_digest``
        fingerprint, so serialized cursors stop growing O(files
        consumed) on an always-on stream. The trainer calls this right
        AFTER a stream-boundary checkpoint publishes — every file folded
        here is recorded BY NAME in that durable boundary cursor, and
        rollback never reaches past the latest boundary, so the names
        are never needed explicitly again. The in-memory list keeps the
        full history; only ``stream_cursor_state``'s serialized view
        shrinks. Returns the total folded count."""
        with self._stream_lock:
            new = self._files_completed[self._folded_count:]
            if new:
                self._folded_digest = chain_digest(self._folded_digest,
                                                   new)
                self._folded_count = len(self._files_completed)
            return self._folded_count

    def note_batches_consumed(self, consumed: int) -> None:
        """Trainer callback: ``consumed`` batches of the current
        ``batches()`` call have been TRAINED — fold every window whose
        final batch lies in that prefix into the completed set. Without
        this call (a raw ``batches()`` drain with no trainer) nothing
        folds and a later ``batches()`` call re-streams the filelist,
        like the unwindowed dataset."""
        if not self.windowed:
            return
        with self._quarantine_lock:
            quarantined = {p for p, _ in self.quarantined_files}
        with self._stream_lock:
            while self._windows:
                w = self._windows[0]
                if w["mark"] is None or w["mark"] > consumed:
                    break
                self._files_completed.extend(
                    f for f in w["files"] if f not in quarantined)
                self.windows_completed += 1
                self._windows.pop(0)

    def pending_files(self) -> List[str]:
        """Files not yet consumed, not already dispatched into a window
        of the open pass, and not excluded by a (preseeded or
        discovered) quarantine decision — in filelist order."""
        with self._stream_lock:
            done = set(self._files_completed)
            for w in self._windows:
                done.update(w["files"])
        with self._quarantine_lock:
            skip = self._skip_files | {p for p, _ in self.quarantined_files}
        return [f for f in self.filelist if f not in done
                and f not in skip]

    def stream_cursor_state(self, consumed_batches: Optional[int] = None
                            ) -> Optional[dict]:
        """The dataset half of the v2 stream cursor: the files fully
        consumed once ``consumed_batches`` batches of the CURRENT
        ``batches()`` call have been trained, plus the open window those
        batches stop inside (empty at a stream boundary).
        ``consumed_batches=None`` means "between passes" (boundary
        cursor). Returns None when not in windowed mode. The JSON keys
        are the reference's."""
        if not self.windowed:
            return None
        with self._quarantine_lock:
            quarantined = {p for p, _ in self.quarantined_files}
        with self._stream_lock:
            completed = list(self._files_completed)
            n_windows = int(self.windows_completed)
            window: List[str] = []
            for w in self._windows:
                mark = w["mark"]
                if (mark is not None and consumed_batches is not None
                        and mark <= consumed_batches):
                    completed.extend(f for f in w["files"]
                                     if f not in quarantined)
                    n_windows += 1
                else:
                    window = list(w["files"])
                    break
            state = {"windowed": True,
                     # folded history is carried as count+fingerprint,
                     # not names — the cursor stays O(files since the
                     # last boundary checkpoint)
                     "files_completed": completed[self._folded_count:],
                     "window_files": window,
                     "windows_completed": n_windows}
            if self._folded_count:
                state["files_folded"] = {
                    "count": int(self._folded_count),
                    "sha256": self._folded_digest,
                }
            return state

    def adopt_stream_cursor(self, stream: dict,
                            quarantined: Sequence[str] = ()) -> None:
        """Restore the stream position from a v2 cursor's ``stream``
        block: completed files will be skipped, the open window replays
        (at-least-once), and the cursor's quarantine decisions are
        preseeded so the resumed run drops the SAME files the preempted
        one did.

        A ``files_folded`` block (compacted history) is expanded from
        THIS dataset's filelist: the first ``count`` non-quarantined
        files must reproduce the chained fingerprint — a mismatch
        raises ``ValueError`` (the filelist no longer extends the
        folded consumption order), never a silent skip of the wrong
        files."""
        completed = [str(f) for f in stream.get("files_completed", [])]
        window = [str(f) for f in stream.get("window_files", [])]
        fold = stream.get("files_folded")
        count, digest, prefix = 0, "", []
        if isinstance(fold, dict) and int(fold.get("count", 0)) > 0:
            count = int(fold["count"])
            digest = str(fold.get("sha256", ""))
            skip = {str(f) for f in quarantined}
            eligible = [f for f in self.filelist if f not in skip]
            prefix = eligible[:count]
            if len(prefix) < count \
                    or chain_digest("", prefix) != digest:
                raise ValueError(
                    f"stream cursor folded history ({count} files) does "
                    "not match this filelist — its leading files no "
                    "longer reproduce the folded fingerprint; resume "
                    "with the original filelist order or roll back to a "
                    "pass boundary")
        with self._stream_lock:
            self._files_completed = prefix + completed
            self._folded_count = count
            self._folded_digest = digest
            self._windows = []
            self._replay_files = window
            self.windows_completed = int(
                stream.get("windows_completed", 0))
        self.preseed_quarantine(quarantined)

    def preseed_quarantine(self, files: Sequence[str]) -> None:
        """Adopt prior quarantine decisions (a resumed cursor's, or a
        shared quarantine list) WITHOUT consuming the local poison
        budget: the files are excluded from future windows and reported
        in ``quarantined_files`` so later cursors carry them forward."""
        with self._quarantine_lock:
            have = {p for p, _ in self.quarantined_files}
            for f in files:
                f = str(f)
                self._skip_files.add(f)
                if f in have:
                    continue
                self.quarantined_files.append(
                    (f, "preseeded quarantine (resume cursor / mesh "
                        "consensus)"))
                self._quarantine_preseeded += 1

    # ---- batch streams ----
    def batches(self, start_batch: int = 0) -> Iterator[SlotBatch]:
        if self.windowed:
            if start_batch:
                raise ValueError(
                    "windowed QueueDataset resumes by FILE WINDOW (the "
                    "v2 stream cursor), not by batch index — resume via "
                    "Trainer.run_pass/train_stream, which adopts the "
                    "cursor and replays the open window at-least-once")
            return self._windowed_batches()
        if start_batch:
            raise ValueError(
                "QueueDataset streams through threaded readers — batch "
                "order is not deterministic, so cursor resume "
                "(start_batch) needs an in-memory dataset, or windowed "
                "streaming (FLAGS.stream_window_files > 0) with its "
                "at-least-once window replay")
        if not self.filelist:
            raise ValueError("set_filelist first")
        self._reset_quarantine()
        return self._stream_files(self.filelist)

    def _stream_files(self, files: Sequence[str]) -> Iterator[SlotBatch]:
        """Stream ``files`` through the reader group as batches, flushing
        the short tail batch at the end. Reader errors surface within one
        batch of the failure (the group is polled every loop, not only at
        stream end), and an abandoned generator cancels the channel and
        joins every reader thread before returning — no hot channel or
        orphan reader outlives the consumer."""
        bs = self.desc.batch_size
        self._set_route("python", self._per_line_reason())
        ch: Channel[SlotRecord] = Channel(capacity=FLAGS.channel_capacity,
                                          block_size=bs,
                                          name="dataset.stream_records")
        group = self._read_files_into(files, ch, self.thread_num)

        def closer() -> None:
            for t in group.threads:
                t.join()
            ch.close()

        closer_th = threading.Thread(target=closer, daemon=True)
        closer_th.start()
        try:
            pending: List[SlotRecord] = []
            while True:
                if group.errors:
                    # a reader died (budget spent / fatal): raise within
                    # one batch instead of silently draining the channel
                    raise group.errors[0]
                got = ch.get_batch(bs - len(pending))
                if not got and ch.closed and len(ch) == 0:
                    break
                pending.extend(got)
                if len(pending) >= bs:
                    yield self.builder.build(pending[:bs])
                    pending = pending[bs:]
            if pending:
                yield self.builder.build(pending)
            group.join()  # surface reader errors at stream end
        finally:
            # consumer-abandon cleanup: without this, readers blocked on
            # ch.put (and the closer waiting on them) outlive the
            # abandoned generator and the channel stays hot
            ch.cancel()
            for t in group.threads:
                t.join()
            closer_th.join()

    def _windowed_batches(self) -> Iterator[SlotBatch]:
        if not self.filelist:
            raise ValueError("set_filelist first")
        wsize = FLAGS.stream_window_files
        with self._quarantine_lock:
            # per-LOAD budget semantics (FLAGS.poison_budget_files is
            # "per load"): fold prior loads' discovered quarantines into
            # the preseeded count — still sticky (pending_files keeps
            # excluding them) but no longer charged against this load's
            # budget, so an always-on stream is not slowly exhausted by
            # bad files weeks apart
            self._quarantine_preseeded = len(self.quarantined_files)
        with self._stream_lock:
            self._windows = []  # fresh pass over the pending files
            replay = set(self._replay_files)
            self._replay_files = []
        yielded = 0
        while True:
            pending = self.pending_files()
            if not pending:
                break
            files = pending[:wsize]
            win = {"files": list(files), "mark": None}
            with self._stream_lock:
                self._windows.append(win)
                widx = self.windows_completed + len(self._windows) - 1
            hit = [f for f in files if f in replay]
            if hit:
                replay -= set(hit)
                self.files_replayed += len(hit)
                log.warning("stream resume: replaying open window "
                            "(at-least-once): %s", hit)
                try:
                    hub = get_hub()
                    hub.counter("pbox_stream_replayed_files_total",
                                "open-window files replayed after a "
                                "stream resume (at-least-once)").inc(
                                    len(hit))
                    if hub.active:
                        hub.emit("stream_replay", files=list(hit))
                except Exception:
                    log.debug("stream replay telemetry emit failed",
                              exc_info=True)
            # chaos seam: a seeded fault here breaks the window dispatch
            # deterministically
            faults.inject("stream.window", path=files[0], window=widx,
                          files=len(files))
            for batch in self._stream_files(files):
                yielded += 1
                yield batch
            # consumption-tied completion: the window only counts as
            # complete once the trainer has TRAINED `yielded` batches
            # (note_batches_consumed folds it; stream_cursor_state reads
            # unfolded marks the same way)
            with self._stream_lock:
                win["mark"] = yielded


class PaddleBoxDataset(InMemoryDataset):
    """Pass-lifecycle dataset — the ``BoxPSDataset``/``PadBoxSlotDataset``
    surface (dataset.py:1313,:1446): preload of pass k+1 on a thread while
    pass k trains, begin/end pass hooks that stage the embedding store's
    working set. It loads per line (its record-level pass protocols need
    ``SlotRecord`` objects)."""

    def __init__(self, desc: Optional[DataFeedDesc] = None) -> None:
        super().__init__(desc)
        self._preload_thread: Optional[threading.Thread] = None
        self._preload_exc: Optional[BaseException] = None
        self._date: Optional[str] = None
        self.pass_id = 0
        # hooks the trainer/PS wires up (BoxHelper Begin/EndFeedPass etc.)
        self.on_begin_pass: Optional[
            Callable[["PaddleBoxDataset"], None]] = None
        self.on_end_pass: Optional[
            Callable[["PaddleBoxDataset", bool], None]] = None

    def set_date(self, date: str) -> None:
        self._date = date

    @property
    def date(self) -> Optional[str]:
        return self._date

    def preload_into_memory(self) -> None:
        if self._preload_thread is not None:
            raise RuntimeError("preload already in flight")
        self._preload_exc = None

        def run() -> None:
            try:
                self.load_into_memory()
            except BaseException as e:  # surfaced in wait_preload_done
                self._preload_exc = e

        self._preload_thread = threading.Thread(target=run, daemon=True)
        self._preload_thread.start()

    def wait_preload_done(self) -> None:
        if self._preload_thread is None:
            return
        self._preload_thread.join()
        self._preload_thread = None
        if self._preload_exc is not None:
            raise self._preload_exc

    def begin_pass(self) -> None:
        self.pass_id += 1
        if self.on_begin_pass is not None:
            self.on_begin_pass(self)

    def end_pass(self, need_save_delta: bool = False) -> None:
        if self.on_end_pass is not None:
            self.on_end_pass(self, need_save_delta)
        self.release_memory()


class Shuffler:
    """Cross-host record exchange transport (PaddleShuffler analogue,
    data_set.cc:2573). Implementations route each record to
    ``hash(record) % world_size`` and return the records received."""

    def exchange(self, records: List[SlotRecord]) -> List[SlotRecord]:
        raise NotImplementedError


class DatasetFactory:
    """Reference: dataset.py:24."""

    _KINDS = {
        "InMemoryDataset": InMemoryDataset,
        "QueueDataset": QueueDataset,
        "PaddleBoxDataset": PaddleBoxDataset,
        "BoxPSDataset": PaddleBoxDataset,       # alias for migration
        "PadBoxSlotDataset": PaddleBoxDataset,  # alias for migration
    }

    def create_dataset(self, kind: str = "QueueDataset",
                       desc: Optional[DataFeedDesc] = None) -> Dataset:
        try:
            return self._KINDS[kind](desc)
        except KeyError:
            raise KeyError(
                f"unknown dataset kind {kind!r}; one of {sorted(self._KINDS)}"
            ) from None
