"""Embedding table — counterpart of ``paddlebox_tpu/ps/table.py``.

The device side is one plain row-major ``[C+1, 8+mf_dim+ext]`` float32
tensor (row C is a permanent zero sentinel that padding reads); the
128-lane packed line layout of the reference is a TPU artefact and is not
carried over. The key→row mapping is a host index, mirrored on the device
for the resident pass's bulk assignment when ``FLAGS.use_pallas_index``
is on (``ops/index.py``). Per-batch key dedup and row assignment happen
on the host, so the device work of a pull is
one row gather (``ops.kernels.gather_rows``) plus slicing, and the device
work of a push is the Adagrad row math plus one in-place unique-row
scatter-add of ``new − old`` (``ops.kernels.scatter_add_update``).

Table state crosses between the two packages through the ``.npz`` files
``EmbeddingTable.save_base``/``save_delta`` write in either.
"""

from __future__ import annotations

import hashlib
import logging
import threading
import time
from typing import Dict, Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from paddlebox_tpu_torch.data.batch import SlotBatch
from paddlebox_tpu_torch.device import resolve_device, seeded_generator
from paddlebox_tpu_torch.config import FLAGS
from paddlebox_tpu_torch.ops.index import DeviceKeyIndex, book_index_dispatch
from paddlebox_tpu_torch.ops.kernels import KERNELS, KernelSet
from paddlebox_tpu_torch.ps.kv import PyKV, dedup_first_seen
from paddlebox_tpu_torch.ps.sgd import (RowState, SparseSGDConfig,
                                        opt_ext_width, sparse_update)

log = logging.getLogger(__name__)

NUM_FIXED = 8  # scalar columns before the embedx block

# field-name → column mapping (save files use names)
FIELD_COL = {"show": 0, "clk": 1, "delta_score": 2, "slot": 3,
             "embed_w": 4, "embed_g2sum": 5, "embedx_g2sum": 6,
             "mf_size": 7}
FIELDS = tuple(FIELD_COL) + ("embedx_w",)


def next_bucket(minimum: int, need: int) -> int:
    """Power-of-two padding ladder: the smallest doubling of ``minimum``
    that is ≥ ``need`` (bounds the distinct batch shapes)."""
    cap = minimum
    while cap < need:
        cap *= 2
    return cap


def next_bucket_fine(minimum: int, need: int) -> int:
    """Fine padding ladder for a resident pass's uniform shapes: ``need``
    rounded up to a step of ~1/16 its magnitude (power-of-two steps of
    at least 512), so the padding stays near 6% and successive passes of
    one workload land on the same few shapes."""
    if need <= minimum:
        return minimum
    step = max(512, 1 << max(need.bit_length() - 5, 0))
    return -(-need // step) * step


def fill_oob_pads(unique_rows: np.ndarray, u: int, capacity: int) -> None:
    """Fill positions [u:] with DISTINCT out-of-bounds row ids (>
    capacity): gathers through them read the zero sentinel row, scatters
    drop them, and they never collide with real rows or each other."""
    n = len(unique_rows) - u
    unique_rows[u:] = capacity + np.arange(1, n + 1, dtype=np.int32)


class PullIndex(NamedTuple):
    """Host-built per-batch dedup index (DedupKeysAndFillIdx analogue)."""

    unique_rows: np.ndarray  # int32 [U_pad]; pads → out of bounds
    gather_idx: np.ndarray   # int32 [K_pad]; pads → sentinel slot
    num_unique: int


def host_pull_block(vals: np.ndarray, mf_dim: int) -> np.ndarray:
    """[k, F] logical rows → [k, 3+mf] pull values (show, clk, embed_w,
    mf_size-gated embedx) — the host-side CopyForPull."""
    mf_end = NUM_FIXED + mf_dim
    gate = vals[:, FIELD_COL["mf_size"]:FIELD_COL["mf_size"] + 1] > 0
    return np.concatenate(
        [vals[:, FIELD_COL["show"]:FIELD_COL["clk"] + 1],
         vals[:, FIELD_COL["embed_w"]:FIELD_COL["embed_w"] + 1],
         vals[:, NUM_FIXED:mf_end] * gate], axis=1)


def _flatten_sharded_blob(blob):
    """Adapt a sharded-format save (``n`` + per-shard ``keys_s``/field_s
    blocks) to the single-table mapping ``load`` consumes."""
    if "n" not in blob:
        return blob
    fn = int(blob["n"])
    out = {"keys": np.concatenate([blob[f"keys_{s}"] for s in range(fn)])}
    for f in list(FIELDS) + ["opt_ext"]:
        if f"{f}_0" in blob:
            out[f] = np.concatenate([blob[f"{f}_{s}"] for s in range(fn)])
    return out


class TableState:
    """The device table: ``data`` [C+1, 8+mf_dim+ext] f32, row-major.
    Columns 0..7 = show, clk, delta_score, slot, embed_w, embed_g2sum,
    embedx_g2sum, mf_size; then embedx_w [mf_dim]; then the optimizer
    extension [ext]. Row C is the zero sentinel.

    Training writes ``data`` IN PLACE (``apply_push``); the slot column
    is not maintained there (slot is host metadata,
    ``EmbeddingTable.slot_host``). A load always builds a new state, so
    a serving snapshot, which holds the state of a table that only ever
    loads, never shares a tensor that training writes."""

    def __init__(self, data: torch.Tensor, ext: int = 0) -> None:
        self.data = data
        self.ext = int(ext)

    @classmethod
    def from_logical(cls, data: np.ndarray, ext: int,
                     device: torch.device) -> "TableState":
        return cls(torch.from_numpy(data).to(device), ext)

    @property
    def capacity(self) -> int:
        return self.data.shape[0] - 1

    @property
    def feat(self) -> int:
        return self.data.shape[1]

    @property
    def mf_dim(self) -> int:
        return self.feat - NUM_FIXED - self.ext


def init_table_state(capacity: int, mf_dim: int, ext: int,
                     device: torch.device) -> TableState:
    return TableState(torch.zeros((capacity + 1, NUM_FIXED + mf_dim + ext),
                                  dtype=torch.float32, device=device), ext)


def gather_full_rows(state: TableState, unique_rows: torch.Tensor,
                     ops: KernelSet = KERNELS) -> torch.Tensor:
    """Complete feature rows for the batch's unique rows → [U, F]; pad
    ids (> C) read the zero sentinel row."""
    return ops.gather_rows(state.data, unique_rows)


def pull_values(rows_full: torch.Tensor,
                mf_dim: Optional[int] = None) -> torch.Tensor:
    """Pull-value view of gathered rows → [U, 3+mf_dim] laid out as
    [show, clk, embed_w, embedx…]; rows with mf_size == 0 read zero
    embedx, as in CopyForPull."""
    gate = (rows_full[:, 7] > 0).to(rows_full.dtype)
    end = rows_full.shape[1] if mf_dim is None else NUM_FIXED + mf_dim
    mf = rows_full[:, NUM_FIXED:end] * gate[:, None]
    return torch.cat([rows_full[:, 0:2], rows_full[:, 4:5], mf], dim=1)


def expand_pull(values_u: torch.Tensor,
                gather_idx: torch.Tensor) -> torch.Tensor:
    """[U, D] unique values → [K, D] per-key-occurrence values; indices
    past the end read the last row (the reference's clamped gather). Its
    autograd backward is the per-unique-row grad merge (an accumulating
    index_put)."""
    u = values_u.shape[0]
    return values_u[gather_idx.long().clamp(0, u - 1)]


def apply_push(state: TableState, unique_rows: torch.Tensor,
               unique_grads: torch.Tensor, cfg: SparseSGDConfig,
               generator: Optional[torch.Generator] = None,
               rows_full: Optional[torch.Tensor] = None,
               init: Optional[torch.Tensor] = None,
               ops: KernelSet = KERNELS) -> TableState:
    """In-table optimizer on merged grads (dy_mf_update_value,
    optimizer.cuh.h:80) and its write-back, IN PLACE.

    ``unique_grads`` [U_pad, 3+mf_dim] = [g_show, g_clk, g_embed,
    g_embedx…]; ``rows_full`` reuses the rows gathered for the pull. The
    write is one unique-row scatter-add of ``new − old`` (the reference
    writes ``old + (new − old)`` too, which can differ from ``new`` by
    one ulp) into rows [0, C): the pads' out-of-bounds ids drop and the
    sentinel row C stays zero. ``init`` / ``generator`` feed lazy mf
    creation (see ``sgd.adagrad_update``). Returns ``state``."""
    g = unique_grads
    cap = state.capacity
    # strictly < capacity: real rows are always below the sentinel
    touched = unique_rows < cap
    if rows_full is None:
        rows_full = gather_full_rows(state, unique_rows, ops)
    mf_end = NUM_FIXED + state.mf_dim
    rows = RowState(
        show=rows_full[:, 0], clk=rows_full[:, 1],
        delta_score=rows_full[:, 2],
        embed_w=rows_full[:, 4], embed_g2sum=rows_full[:, 5],
        embedx_w=rows_full[:, NUM_FIXED:mf_end],
        embedx_g2sum=rows_full[:, 6],
        mf_size=rows_full[:, 7],
        opt_ext=rows_full[:, mf_end:])
    new = sparse_update(rows, g[:, 0], g[:, 1], g[:, 2],
                        g[:, 3:3 + state.mf_dim], touched, cfg, init=init,
                        generator=generator)
    new_mat = torch.cat([
        new.show[:, None], new.clk[:, None], new.delta_score[:, None],
        rows_full[:, 3:4], new.embed_w[:, None], new.embed_g2sum[:, None],
        new.embedx_g2sum[:, None], new.mf_size[:, None], new.embedx_w,
        new.opt_ext], dim=1)
    # where, not multiply: an untouched row holding NaN would otherwise
    # turn its masked-out delta into NaN (0 * NaN)
    delta = torch.where(touched[:, None], new_mat - rows_full, 0.0)
    ops.scatter_add_update(state.data[:cap], unique_rows.contiguous(),
                           delta.contiguous())
    return state


class EmbeddingTable:
    """Single-shard embedding PS facade: per-batch and whole-pass row
    assignment for training, read-only lookups for serving, and the
    save/load files."""

    def __init__(self, mf_dim: int = 8, capacity: int = 1 << 20,
                 cfg: Optional[SparseSGDConfig] = None, seed: int = 0,
                 unique_bucket_min: int = 1024,
                 device: Union[str, torch.device] = "cuda") -> None:
        self.device = resolve_device(device)
        self.mf_dim = mf_dim
        self.capacity = capacity
        self.cfg = cfg or SparseSGDConfig()
        self.opt_ext = opt_ext_width(self.cfg, mf_dim)
        self.index = PyKV(capacity)
        self.state = init_table_state(capacity, mf_dim, self.opt_ext,
                                      self.device)
        self.seed = seed
        self._push_count = 0
        self.unique_bucket_min = unique_bucket_min
        # rows assigned since the last clearing save (the delta set)
        self._touched = np.zeros(capacity + 1, dtype=bool)
        # per-row slot id: HOST metadata (the FeatureValue slot field).
        # Slot never changes for a key and the host sees every key at
        # assign time, so no device work tracks it.
        self.slot_host = np.zeros(capacity + 1, dtype=np.int16)
        # serializes host-side index/touched mutation across threads
        # (prefetch prepare, save, load)
        self.host_lock = threading.Lock()
        # the device key index (FLAGS.use_pallas_index), built on first use
        self._dev_index: Optional[DeviceKeyIndex] = None
        # seconds of the last bulk assignment: host kv vs device index
        self.last_assign_seconds = {"index_host": 0.0, "index_device": 0.0}

    # ---- per-batch host prep (dedup + row assignment / lookup) ----
    def _build_index(self, batch: SlotBatch, rows: np.ndarray,
                     inv: np.ndarray) -> PullIndex:
        """Padding/bucketing tail of prepare/prepare_eval: pad positions
        (where padded keys also point) get distinct out-of-bounds rows."""
        u = len(rows)
        cap = next_bucket(self.unique_bucket_min, u + 1)
        unique_rows = np.empty(cap, dtype=np.int32)
        unique_rows[:u] = rows
        fill_oob_pads(unique_rows, u, self.capacity)
        k_pad = batch.keys.shape[0]
        gather_idx = np.full(k_pad, u, dtype=np.int32)  # pads → sentinel
        gather_idx[:batch.num_keys] = inv
        return PullIndex(unique_rows, gather_idx, u)

    def record_slots(self, rows: np.ndarray, inv: np.ndarray,
                     slot_of_key: np.ndarray) -> None:
        """Record each unique row's slot (first key occurrence wins via
        the reversed assignment). Caller holds host_lock."""
        self.slot_host[rows[inv[::-1]]] = slot_of_key[::-1]

    def bulk_assign_unique(self, keys: np.ndarray, slot_of_key: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """Whole-pass row assignment (the resident pass's build): one
        first-seen dedup of the pass's keys and ONE index round trip,
        instead of one per batch. Returns (rows of the first-seen uniques
        int32, inverse int64) and records each unique's slot (that of its
        first occurrence in the pass).

        ``FLAGS.use_pallas_index`` routes this through the device key
        index (``_bulk_assign_device``): the raw ids go to the card, dedup
        and row assignment happen there, and the host kv takes ONLY the
        new keys. A call the device route cannot serve exactly (probe or
        capacity overflow, kv divergence) is redone here, loudly, and
        counted as ``index.assign/host``."""
        keys = np.ascontiguousarray(keys, np.uint64)
        if FLAGS.use_pallas_index:
            dev = self._device_index()
            if not dev.degraded:
                out = self._bulk_assign_device(keys, slot_of_key, dev)
                if out is not None:
                    return out
            book_index_dispatch("assign", "host")
        uniq, first_idx, inv = dedup_first_seen(keys)
        slots_first = slot_of_key[first_idx]
        t1 = time.perf_counter()
        with self.host_lock:
            rows = self.index.assign(uniq)
            self.slot_host[rows] = slots_first.astype(np.int16, copy=False)
        self.last_assign_seconds = {
            "index_host": time.perf_counter() - t1, "index_device": 0.0}
        return rows, inv

    # ---- device key index (FLAGS.use_pallas_index) ----
    def _device_index(self) -> DeviceKeyIndex:
        """The table's DeviceKeyIndex, built and seeded from the host kv on
        first use; it degrades (sticky, loud) when the kv's rows are not
        dense or the seed overflows."""
        dev = self._dev_index
        if dev is None:
            dev = DeviceKeyIndex(self.capacity, device=self.device)
            with self.host_lock:
                if not dev.seed_from_kv(self.index):
                    dev.degrade("host kv rows are not dense or overflow "
                                "the device index: cannot seed")
            self._dev_index = dev
        return dev

    def _reset_dev_index(self) -> None:
        """Drop the device index after a host kv lifecycle change (load);
        the next flag-on bulk assignment seeds a new one from the kv."""
        self._dev_index = None

    def _bulk_assign_device(self, keys: np.ndarray, slot_of_key: np.ndarray,
                            dev: DeviceKeyIndex
                            ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Device route of bulk_assign_unique: first-seen dedup and hash
        insert on the card, the host kv mirrored with the NEW keys only.
        Returns None (after degrading ``dev``) whenever the result cannot
        be trusted bit for bit; the caller then redoes the call on the
        host path, which is always authoritative."""
        t0 = time.perf_counter()
        pre_rows = dev.next_row
        out = dev.assign_raw(keys)
        t_dev = time.perf_counter() - t0
        if out is None:
            dev.degrade(f"probe/capacity overflow ({len(keys)} keys at "
                        f"{pre_rows} rows, capacity {self.capacity})")
            return None
        uniq, first_idx, inv, rows_u, new_mask = out
        t1 = time.perf_counter()
        slots_first = slot_of_key[first_idx]
        with self.host_lock:
            if len(self.index) != pre_rows:
                dev.degrade(f"host kv diverged ({len(self.index)} keys vs "
                            f"{pre_rows} mirrored)")
                return None
            if new_mask.any():
                krows = self.index.assign(uniq[new_mask])
                if not np.array_equal(krows,
                                      rows_u[new_mask].astype(np.int32)):
                    dev.degrade("host kv allocated other rows than the "
                                "device index")
                    return None
            self.slot_host[rows_u] = slots_first.astype(np.int16, copy=False)
        self.last_assign_seconds = {
            "index_host": time.perf_counter() - t1, "index_device": t_dev}
        book_index_dispatch("assign", "device")
        return (rows_u.astype(np.int32, copy=False),
                inv.astype(np.int64, copy=False))

    def prepare(self, batch: SlotBatch) -> PullIndex:
        """Training prepare: dedup the batch's keys and assign rows to
        new ones (first-occurrence order), mark them touched and record
        their slots."""
        valid = batch.keys[:batch.num_keys]
        with self.host_lock:
            rows, inv = self.index.assign_unique(valid)
            self._touched[rows] = True
            self.record_slots(
                rows, inv,
                (batch.segments[:batch.num_keys]
                 % batch.num_slots).astype(np.int16))
        return self._build_index(batch, rows, inv)

    def prepare_eval(self, batch: SlotBatch) -> PullIndex:
        """Read-only prepare: unknown keys map to the zero sentinel row
        instead of allocating (no index mutation)."""
        valid = batch.keys[:batch.num_keys]
        with self.host_lock:
            rows, inv = self.index.lookup_unique(valid, self.capacity)
        return self._build_index(batch, rows, inv)

    def next_generator(self) -> torch.Generator:
        """A fresh generator on the table's device for one push (the
        counterpart of the reference's ``next_rng`` fold-in)."""
        self._push_count += 1
        return seeded_generator(self.device, self.seed, self._push_count)

    def host_pull(self, keys: np.ndarray,
                  data: Optional[np.ndarray] = None) -> np.ndarray:
        """[n] keys → [n, 3+mf] pull values on the HOST; unknown keys →
        zeros. ``data`` lets callers pass a cached logical mirror."""
        keys = np.ascontiguousarray(keys, np.uint64)
        rows, inv = self.index.lookup_unique(keys, self.capacity)
        if data is None:
            data = self.state.data.cpu().numpy()
        vals = data[np.minimum(rows, self.capacity)]
        return host_pull_block(vals, self.mf_dim)[inv]

    def rows_digest(self) -> str:
        """sha256 over the logical rows sorted by feasign — the same
        bytes the reference's ``EmbeddingTable.rows_digest`` hashes."""
        with self.host_lock:
            keys, rows = self.index.items()
        order = np.argsort(keys)
        data = self.state.data.cpu().numpy()
        h = hashlib.sha256()
        h.update(np.ascontiguousarray(keys[order]).tobytes())
        h.update(np.ascontiguousarray(data[rows[order]]).tobytes())
        return h.hexdigest()

    # ---- save files (box_wrapper.cc:1383-1415) ----
    def _gather_host(self, rows: np.ndarray) -> Dict[str, np.ndarray]:
        """Per-field host dict of ``rows`` (the save-file format). The
        slot field comes from host metadata."""
        idx = torch.from_numpy(rows.astype(np.int64)).to(self.device)
        sub = self.state.data.index_select(0, idx).cpu().numpy()
        mf_end = NUM_FIXED + self.mf_dim
        out = {f: (sub[:, NUM_FIXED:mf_end] if f == "embedx_w"
                   else sub[:, FIELD_COL[f]]) for f in FIELDS}
        out["slot"] = self.slot_host[rows].astype(np.float32)
        if self.opt_ext:
            out["opt_ext"] = sub[:, mf_end:]
        return out

    def save_base(self, path: str, clear_touched: bool = True) -> int:
        """Full model dump. Returns rows saved. ``clear_touched=False``
        keeps the delta set (a mid-pass snapshot, while a prefetch
        pipeline may have assigned rows not yet pushed)."""
        with self.host_lock:
            keys, rows = self.index.items()
            if clear_touched:
                self._touched[rows] = False
        np.savez_compressed(path, keys=keys, **self._gather_host(rows))
        return len(keys)

    def save_delta(self, path: str, clear_touched: bool = True) -> int:
        """Incremental dump of the rows touched since the last clearing
        save. Returns rows saved."""
        with self.host_lock:
            keys, rows = self.index.items()
            mask = self._touched[rows]
            keys, rows = keys[mask], rows[mask]
            if clear_touched:
                self._touched[rows] = False
        np.savez_compressed(path, keys=keys, **self._gather_host(rows))
        return len(keys)

    def clear_touched_flags(self) -> None:
        """Post-commit half of a staged export: a ``save_*(clear_touched=
        False)`` followed by this equals the plain clearing save. Call
        only between passes."""
        with self.host_lock:
            self._touched[:] = False

    # ---- loading save files ----
    def _insert_file_rows(self, data: np.ndarray, rows: np.ndarray,
                          blob) -> None:
        """Write a save file's field blocks (all but slot, which is host
        metadata) into ``data`` at ``rows``."""
        mf_end = NUM_FIXED + self.mf_dim
        for f in FIELDS:
            if f == "slot":
                continue
            if f == "embedx_w":
                data[rows, NUM_FIXED:mf_end] = blob[f]
            else:
                data[rows, FIELD_COL[f]] = blob[f]
        if self.opt_ext:
            if "opt_ext" in blob \
                    and blob["opt_ext"].shape[1] == self.opt_ext:
                data[rows, mf_end:mf_end + self.opt_ext] = blob["opt_ext"]
            else:
                log.warning("load: file has no matching opt_ext block; "
                            "optimizer state starts fresh for loaded rows")

    def load(self, path: Union[str, Mapping[str, np.ndarray]],
             merge: bool = False) -> int:
        """Load a save_base/save_delta ``.npz`` (or the same mapping in
        memory, see ``convert.table_rows_from_logical``); ``merge=True``
        keeps existing rows (delta apply), else the table starts empty.
        Sharded-format saves load too. Returns the rows in the file. The
        table gets a NEW state either way."""
        if isinstance(path, Mapping):
            blob = path
        else:
            with np.load(path) as f:
                blob = dict(f)
        blob = _flatten_sharded_blob(blob)
        keys = np.asarray(blob["keys"], np.uint64)
        with self.host_lock:
            if merge:
                data = self.state.data.cpu().numpy().copy()
            else:
                self.index = PyKV(self.capacity)
                self._touched[:] = False
                self.slot_host[:] = 0
                data = np.zeros((self.capacity + 1, self.state.feat),
                                np.float32)
            rows = self.index.assign(keys)
            self.slot_host[rows] = np.asarray(blob["slot"]).astype(np.int16)
            self._insert_file_rows(data, rows, blob)
            self.state = TableState.from_logical(data, self.opt_ext,
                                                 self.device)
        self._reset_dev_index()
        return len(keys)
