"""Embedding table, serving half — counterpart of
``paddlebox_tpu/ps/table.py``.

The device side is one plain row-major ``[C+1, 8+mf_dim+ext]`` float32
tensor (row C is a permanent zero sentinel that padding reads); the
128-lane packed line layout of the reference is a TPU artefact and is not
carried over. The key→row mapping is a host index; per-batch key dedup
happens on the host, so the device work of a pull is one row gather
(``ops.kernels.gather_rows``) plus two slicing/indexing steps.

Table state crosses from the JAX package to the port through the same
``.npz`` files ``EmbeddingTable.save_base``/``save_delta`` write there.
"""

from __future__ import annotations

import hashlib
import logging
import threading
from typing import Mapping, NamedTuple, Optional, Union

import numpy as np
import torch

from paddlebox_tpu_torch.data.batch import SlotBatch
from paddlebox_tpu_torch.device import resolve_device
from paddlebox_tpu_torch.ops.kernels import gather_rows
from paddlebox_tpu_torch.ps.kv import PyKV
from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig, opt_ext_width

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


def fill_oob_pads(unique_rows: np.ndarray, u: int, capacity: int) -> None:
    """Fill positions [u:] with DISTINCT out-of-bounds row ids (>
    capacity): gathers through them read the zero sentinel row, and they
    never collide with real rows or each other."""
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
    extension [ext]. Row C is the zero sentinel. A state is never
    written after construction: every load builds a new one."""

    def __init__(self, data: torch.Tensor, ext: int = 0) -> None:
        self.data = data
        self.ext = int(ext)

    @classmethod
    def from_logical(cls, data: np.ndarray, ext: int,
                     device: torch.device) -> "TableState":
        return cls(torch.from_numpy(data).to(device), ext)

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


def gather_full_rows(state: TableState,
                     unique_rows: torch.Tensor) -> torch.Tensor:
    """Complete feature rows for the batch's unique rows → [U, F]; pad
    ids (> C) read the zero sentinel row."""
    return gather_rows(state.data, unique_rows)


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
    past the end read the last row (the reference's clamped gather)."""
    u = values_u.shape[0]
    return values_u[gather_idx.long().clamp(0, u - 1)]


class EmbeddingTable:
    """Single-shard embedding table, read side (the serving consumer of
    the reference's save files)."""

    def __init__(self, mf_dim: int = 8, capacity: int = 1 << 20,
                 cfg: Optional[SparseSGDConfig] = None,
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
        self.unique_bucket_min = unique_bucket_min
        # serializes index replacement against readers of this table
        self.host_lock = threading.Lock()

    # ---- per-batch host prep (dedup + row lookup) ----
    def _build_index(self, batch: SlotBatch, rows: np.ndarray,
                     inv: np.ndarray) -> PullIndex:
        """Padding/bucketing tail of prepare_eval: pad positions (where
        padded keys also point) get distinct out-of-bounds rows."""
        u = len(rows)
        cap = next_bucket(self.unique_bucket_min, u + 1)
        unique_rows = np.empty(cap, dtype=np.int32)
        unique_rows[:u] = rows
        fill_oob_pads(unique_rows, u, self.capacity)
        k_pad = batch.keys.shape[0]
        gather_idx = np.full(k_pad, u, dtype=np.int32)  # pads → sentinel
        gather_idx[:batch.num_keys] = inv
        return PullIndex(unique_rows, gather_idx, u)

    def prepare_eval(self, batch: SlotBatch) -> PullIndex:
        """Read-only prepare: unknown keys map to the zero sentinel row
        instead of allocating (no index mutation)."""
        valid = batch.keys[:batch.num_keys]
        with self.host_lock:
            rows, inv = self.index.lookup_unique(valid, self.capacity)
        return self._build_index(batch, rows, inv)

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

    # ---- loading the reference's save files ----
    def _insert_file_rows(self, data: np.ndarray, rows: np.ndarray,
                          blob) -> None:
        """Write a save file's field blocks (all but slot, which the
        device table does not keep) into ``data`` at ``rows``."""
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
        Sharded-format saves load too. Returns the rows in the file."""
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
                data = np.zeros((self.capacity + 1, self.state.feat),
                                np.float32)
            rows = self.index.assign(keys)
            self._insert_file_rows(data, rows, blob)
            self.state = TableState.from_logical(data, self.opt_ext,
                                                 self.device)
        return len(keys)
