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

The pass windows of the tiered store (``ps/pass_table.py``,
``ps/tiered.py``) copy rows through two primitives here: the begin-pass
delta scatter ``scatter_window_rows`` (kernel row 3, the counterpart of
the reference's ``scatter_logical_rows``) and the end-pass read
``RowsToHost`` (kernel row 4, of ``dispatch_packed_row_gather``). The
reference chunks its scatter into ``FLAGS.scatter_chunk_rows`` rows and
warms it up (``start_scatter_warmup``) only so that XLA compiles one
executable per table geometry; a kernel launch compiles nothing, so the
port has neither.
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
from paddlebox_tpu_torch.ps.kv import (dedup_first_seen_native,
                                       dedup_first_seen_py, make_kv)
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


def dedup_first_seen(keys: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dedup ``keys`` in FIRST-SEEN order → (uniq, first_idx, inv): the
    bulk pass-assign front half (``EmbeddingTable.bulk_assign_unique``).
    First-seen order makes the single bulk ``index.assign`` allocate new
    rows in exactly the order a batch-by-batch walk of ``assign_unique``
    would. Runs the native one-pass dedup; the three-pass
    ``dedup_first_seen_py`` (the same outputs, bit for bit) where the
    native library cannot build."""
    out = dedup_first_seen_native(keys)
    if out is not None:
        return out
    return dedup_first_seen_py(keys)


def fill_oob_pads(unique_rows: np.ndarray, u: int, capacity: int) -> None:
    """Fill positions [u:] with DISTINCT out-of-bounds row ids (>
    capacity): gathers through them read the zero sentinel row, scatters
    drop them, and they never collide with real rows or each other."""
    n = len(unique_rows) - u
    unique_rows[u:] = capacity + np.arange(1, n + 1, dtype=np.int32)


def field_slice(data: np.ndarray, name: str) -> np.ndarray:
    """Column view of a field on a logical-row matrix."""
    if name == "embedx_w":
        return data[..., NUM_FIXED:]
    return data[..., FIELD_COL[name]]


def field_assign(data: np.ndarray, rows: np.ndarray, name: str,
                 values: np.ndarray) -> None:
    """Write counterpart of :func:`field_slice`: ``data[rows, <field
    columns>] = values`` (the embedx block takes the values' width)."""
    if name == "embedx_w":
        data[rows, NUM_FIXED:NUM_FIXED + values.shape[-1]] = values
    else:
        data[rows, FIELD_COL[name]] = values


def store_fields_from_rows(sub: np.ndarray, mf_dim: int, opt_ext: int,
                           slot_override: Optional[np.ndarray] = None
                           ) -> Dict[str, np.ndarray]:
    """Logical rows [k, feat] → a HostStore field dict (the write-back
    assembly of end_pass and eviction). embedx is sliced to mf_dim so the
    optimizer extension never leaks into the (k, mf_dim) block;
    ``slot_override`` substitutes host slot metadata for tables whose
    device rows do not carry the slot column."""
    mf_end = NUM_FIXED + mf_dim
    vals = {f: (sub[:, NUM_FIXED:mf_end] if f == "embedx_w"
                else field_slice(sub, f)) for f in FIELDS}
    if slot_override is not None:
        vals["slot"] = slot_override
    if opt_ext:
        vals["opt_ext"] = sub[:, mf_end:]
    return vals


def rows_from_store_fields(vals: Dict[str, np.ndarray], mf_dim: int,
                           opt_ext: int) -> np.ndarray:
    """HostStore field dict → logical rows [k, feat] (the scatter input of
    the begin-pass delta), the inverse of :func:`store_fields_from_rows`."""
    k = len(vals["show"])
    mf_end = NUM_FIXED + mf_dim
    out = np.zeros((k, mf_end + opt_ext), np.float32)
    idx = np.arange(k)
    for f in FIELDS:
        field_assign(out, idx, f, vals[f])
    if opt_ext:
        out[:, mf_end:] = vals["opt_ext"]
    return out


def promote_window_delta(index, touched: np.ndarray, capacity: int,
                         want_keys: np.ndarray, new_keys: np.ndarray,
                         gather_rows, writeback, on_freed=None,
                         pending: Optional[np.ndarray] = None,
                         protect: Optional[np.ndarray] = None):
    """The per-window delta promotion shared by the tiered shards and the
    single-table ``PassScopedTable`` (box_wrapper.cc:129-186's incremental
    window): reconcile the staged delta against the live window (keys that
    became resident since ``stage`` keep their fresher rows), evict only
    under capacity pressure (clean rows first; dirty evictees go through
    ``writeback(keys, rows, gather_rows(rows))``), and assign the
    remaining new keys as clean rows.

    ``pending`` (sorted uint64) lists keys whose rows a routing-plan
    build assigned before their values staged (``ps/tiered.plan_scope``):
    they look resident to the index but their rows hold no values of
    theirs (a fresh row, or one eviction freed, with an old key's
    values), so the staged values win, and their plan-baked rows are
    pinned against eviction. ``protect`` lists more keys pinned against
    eviction (the queued passes' working sets).

    Caller holds the host lock and scatters the staged values into the
    returned ``rows_new``. Returns (rows_new, still_missing_mask, stats);
    ``stats["evict_sec"]`` is the wall of the eviction block.
    ``on_freed(rows)`` hooks per-row host metadata cleanup. The hub
    counters of these stats wait for the observability layer (ROADMAP
    queue 1 item 13)."""
    miss = index.lookup(new_keys) < 0
    still = miss
    if pending is not None and len(pending):
        still = miss | np.isin(new_keys, pending, assume_unique=False)
    ins_keys = new_keys[still]
    stats = dict(resident=len(want_keys) - len(ins_keys),
                 staged=len(ins_keys), evicted=0, evicted_writeback=0,
                 evict_sec=0.0)
    # capacity pressure counts only truly missing keys: pending keys
    # already own rows
    overflow = len(index) + int(miss.sum()) - capacity
    if overflow > 0:
        t0 = time.perf_counter()
        live_keys, live_rows = index.items()
        cand = ~np.isin(live_keys, want_keys)
        if pending is not None and len(pending):
            # plan-baked rows of a future pass: their ids are in that
            # pass's staged wire already
            cand &= ~np.isin(live_keys, pending)
        if protect is not None and len(protect):
            cand &= ~np.isin(live_keys, protect)
        ck, cr = live_keys[cand], live_rows[cand]
        t = touched[cr]
        order = np.argsort(t, kind="stable")[:overflow]
        ck, cr, t = ck[order], cr[order], t[order]
        if t.any():
            writeback(ck[t], cr[t], gather_rows(cr[t]))
            stats["evicted_writeback"] = int(t.sum())
        freed = index.release(ck)
        touched[freed] = False
        if on_freed is not None:
            on_freed(freed)
        stats["evicted"] = len(ck)
        stats["evict_sec"] = time.perf_counter() - t0
    rows_new = index.assign(ins_keys)
    touched[rows_new] = False  # freshly loaded = clean
    return rows_new, still, stats


def _dma_rows(k: int) -> int:
    """``k`` rounded up to the DMA row kernels' count contract (a
    multiple of min(2048, k), ``ops/kernels._dma_count``)."""
    return k if k <= 2048 else -(-k // 2048) * 2048


def _pinned(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor for a copy to ``device``: pinned for the
    card (so the copy does not block the host), the array's own memory
    for the CPU."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.pin_memory() if device.type == "cuda" else t


def scatter_window_rows(state: "TableState", rows: np.ndarray,
                        values: np.ndarray, ops: KernelSet = KERNELS) -> None:
    """The begin-pass delta scatter (the counterpart of the reference's
    ``scatter_logical_rows``): ``state.data[rows[i]] = values[i]`` IN
    PLACE through kernel row 3 (``scatter_rows_dma``). The row list pads
    to the kernel's row-count contract with the sentinel row C and zero
    values, so the sentinel stays zero. On the card the values and rows
    go through pinned buffers and non-blocking copies on the current
    stream (the steps' stream: the scatter follows every gather and push
    enqueued before it). ``rows`` must be duplicate-free."""
    k = len(rows)
    if k == 0:
        return
    data = state.data
    kp = _dma_rows(k)
    r = np.full(kp, state.capacity, np.int32)
    r[:k] = rows
    v = np.zeros((kp, data.shape[1]), np.float32)
    v[:k] = values
    dev = data.device
    ops.scatter_rows_dma(data, _pinned(r, dev).to(dev, non_blocking=True),
                         _pinned(v, dev).to(dev, non_blocking=True))


class RowsToHost:
    """A device → host copy of gathered window rows in flight: the
    end-pass and dirty-evictee read through kernel row 4
    (``gather_rows_dma``; pads read the zero sentinel). On the card the
    gather runs on the current stream, its output copies into pinned host
    memory without blocking, and an event records after the copy;
    :meth:`wait` synchronizes on the event (on any thread) and returns
    the rows. The gathered device tensor stays referenced until then. On
    the CPU the plain gather's copy is the result."""

    def __init__(self, state: "TableState", rows: np.ndarray,
                 ops: KernelSet = KERNELS) -> None:
        k = len(rows)
        self.k = k
        data = state.data
        dev = data.device
        r = np.full(_dma_rows(max(k, 1)), state.capacity, np.int32)
        r[:k] = rows
        self._dev = ops.gather_rows_dma(
            data, _pinned(r, dev).to(dev, non_blocking=True))
        self._event = None
        if dev.type == "cuda":
            self._host = torch.empty(self._dev.shape, dtype=torch.float32,
                                     pin_memory=True)
            self._host.copy_(self._dev, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(dev))
        else:
            self._host = self._dev

    def wait(self) -> np.ndarray:
        """The gathered rows [k, F] on the host, once the copy landed."""
        if self._event is not None:
            self._event.synchronize()
        return self._host[:self.k].numpy()


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

    Training writes ``data`` IN PLACE (``apply_push``); the single table
    does not maintain the slot column there (slot is host metadata,
    ``EmbeddingTable.slot_host``), the sharded table's push writes it
    (``ps/sharded.py``). A load always builds a new state, so
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


def _live_keys(gather_idx: torch.Tensor, key_valid: torch.Tensor,
               num_unique: int) -> torch.Tensor:
    """Positions of the keys that merge: valid, and inside [0, U) (JAX's
    segment_sum drops the rest)."""
    return torch.nonzero((key_valid > 0) & (gather_idx >= 0)
                         & (gather_idx < num_unique)).squeeze(1)


def merge_push(key_grads: torch.Tensor, gather_idx: torch.Tensor,
               key_valid: torch.Tensor, slot_of_key: torch.Tensor,
               num_unique: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dedup-merge per-key-occurrence grads into per-unique-row grads
    (PushMergeCopy, box_wrapper.cu:417). Returns (unique_grads [U, D],
    touched [U] bool, slot_val [U]). Only the valid keys are summed, by
    an accumulating ``index_put_`` (key order): padded keys, which all
    point at one slot, never reach it."""
    live = _live_keys(gather_idx, key_valid, num_unique)
    gi = gather_idx.long()[live]
    g = key_grads.new_zeros((num_unique, key_grads.shape[1])).index_put_(
        (gi,), key_grads[live] * key_valid[live, None], accumulate=True)
    touched, slot_val = push_stats(gather_idx, key_valid, slot_of_key,
                                   num_unique)
    return g, touched, slot_val


def push_stats(gather_idx: torch.Tensor, key_valid: torch.Tensor,
               slot_of_key: torch.Tensor,
               num_unique: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-unique-row touched flag and mean slot id of the valid keys."""
    live = _live_keys(gather_idx, key_valid, num_unique)
    gi = gather_idx.long()[live]
    kv = key_valid[live].float()
    zeros = torch.zeros(num_unique, dtype=torch.float32,
                        device=key_valid.device)
    cnt = zeros.index_put((gi,), kv, accumulate=True)
    slot_sum = zeros.index_put((gi,), slot_of_key[live].float() * kv,
                               accumulate=True)
    touched = cnt > 0
    slot_val = torch.where(touched, slot_sum / cnt.clamp_min(1.0), 0.0)
    return touched, slot_val


def merge_rows(values: torch.Tensor, idx: torch.Tensor,
               num_segments: int) -> torch.Tensor:
    """Segment sum of ``values`` [M, D] by ``idx`` [M] into
    [num_segments, D] (the sharded push's merge of the grads every
    requester sent back for one served row). An accumulating
    ``index_put_``: each segment's terms add in position order on the
    CPU and, under ``torch.use_deterministic_algorithms(True)``, on the
    card too, so a run repeats bit for bit. The reference packs rows into
    128-lane lines for the TPU's scatter; the port's rows are row-major
    and need no packing."""
    out = values.new_zeros((num_segments, values.shape[1]))
    return out.index_put_((idx.long(),), values, accumulate=True)


def apply_push(state: TableState, unique_rows: torch.Tensor,
               unique_grads: torch.Tensor, cfg: SparseSGDConfig,
               generator: Optional[torch.Generator] = None,
               rows_full: Optional[torch.Tensor] = None,
               init: Optional[torch.Tensor] = None,
               ops: KernelSet = KERNELS,
               touched: Optional[torch.Tensor] = None,
               slot_val: Optional[torch.Tensor] = None,
               draw_rows: Optional[int] = None) -> TableState:
    """In-table optimizer on merged grads (dy_mf_update_value,
    optimizer.cuh.h:80) and its write-back, IN PLACE.

    ``unique_grads`` [U_pad, 3+mf_dim] = [g_show, g_clk, g_embed,
    g_embedx…]; ``rows_full`` reuses the rows gathered for the pull. The
    write is one unique-row scatter-add of ``new − old`` (the reference
    writes ``old + (new − old)`` too, which can differ from ``new`` by
    one ulp) into rows [0, C): the pads' out-of-bounds ids drop and the
    sentinel row C stays zero. ``init`` / ``generator`` / ``draw_rows``
    feed lazy mf creation (see ``sgd.adagrad_update``). ``touched`` (bool [U_pad])
    picks the rows the optimizer runs on, by default every row below the
    sentinel; ``slot_val`` (f32 [U_pad]) writes the touched rows' slot
    column, which by default keeps its value (the single table keeps
    slots on the host, the sharded table in the column). Returns
    ``state``."""
    g = unique_grads
    cap = state.capacity
    if touched is None:
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
                        generator=generator, draw_rows=draw_rows)
    slot_new = (rows_full[:, 3:4] if slot_val is None else
                torch.where(touched, slot_val, rows_full[:, 3])[:, None])
    new_mat = torch.cat([
        new.show[:, None], new.clk[:, None], new.delta_score[:, None],
        slot_new, new.embed_w[:, None], new.embed_g2sum[:, None],
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
                 device: Union[str, torch.device] = "cuda",
                 arena_slots: Optional[int] = None,
                 arena_chunk_bits: int = 12) -> None:
        """``arena_slots``: allocate rows from the kv's slot arena for that
        many feature slots: each slot's rows cluster in chunks of
        2^``arena_chunk_bits``, so the resident pass can ship the COMPACT
        wire (per-key slot-local rows, ``train/device_pass.py``). Only an
        allocation policy: every other path is unchanged. Keys that enter
        through a slotless path make the compact wire fall back to the
        dedup wire for the passes that touch them."""
        self.device = resolve_device(device)
        self.mf_dim = mf_dim
        self.capacity = capacity
        self.cfg = cfg or SparseSGDConfig()
        self.opt_ext = opt_ext_width(self.cfg, mf_dim)
        self.arena_slots = arena_slots
        self.arena_chunk_bits = arena_chunk_bits
        self.index = self._new_kv()
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

    def _new_kv(self):
        """An empty host index, its slot arena enabled for arena tables."""
        kv = make_kv(self.capacity)
        if self.arena_slots is not None:
            kv.arena_enable(self.arena_chunk_bits, self.arena_slots)
        return kv

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
        counted as ``index.assign/host``.

        Arena tables assign slotted, so a key seen here first lands in its
        slot's arena (a slotless assignment would put it in the default
        arena and keep the compact wire off for every pass with it)."""
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
            if self.index.arena_enabled:
                rows, _ = self.index.assign_slotted(
                    uniq, slots_first.astype(np.uint16, copy=False))
            else:
                rows = self.index.assign(uniq)
            self.slot_host[rows] = slots_first.astype(np.int16, copy=False)
        self.last_assign_seconds = {
            "index_host": time.perf_counter() - t1, "index_device": 0.0}
        return rows, inv

    # ---- device key index (FLAGS.use_pallas_index) ----
    def _device_index(self) -> DeviceKeyIndex:
        """The table's DeviceKeyIndex, built and seeded from the host kv on
        first use; it degrades (sticky, loud) when the kv allocates from a
        slot arena (no dense mirror), when the kv's rows are not dense or
        when the seed overflows."""
        dev = self._dev_index
        if dev is None:
            dev = DeviceKeyIndex(self.capacity, device=self.device)
            with self.host_lock:
                if self.index.arena_enabled:
                    dev.degrade("arena-slotted row allocation has no dense "
                                "device mirror")
                elif not dev.seed_from_kv(self.index):
                    dev.degrade("host kv rows are not dense or overflow "
                                "the device index: cannot seed")
            self._dev_index = dev
        return dev

    def _reset_dev_index(self) -> None:
        """Drop the device index after a host kv lifecycle change (load,
        merge_model, shrink); the next flag-on bulk assignment seeds a new
        one from the kv, or degrades where the kv's rows are not dense."""
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

    # ---- eager pull/push (the PV loop, tests) ----
    def pull(self, idx: PullIndex, ops: KernelSet = KERNELS) -> torch.Tensor:
        """Per-key-occurrence pull values [K_pad, 3+mf_dim] of a prepared
        batch; the padded keys read the zero sentinel."""
        rows = torch.from_numpy(idx.unique_rows).to(self.device)
        gi = torch.from_numpy(idx.gather_idx).to(self.device)
        vals_u = pull_values(gather_full_rows(self.state, rows, ops),
                             self.mf_dim)
        return expand_pull(vals_u, gi)

    def push(self, idx: PullIndex, key_grads: torch.Tensor,
             slot_of_key: Optional[np.ndarray] = None,
             ops: KernelSet = KERNELS) -> None:
        """Per-key-occurrence grads [K_pad, 3+mf_dim] in → merge per
        unique row → in-table optimizer (``apply_push``). ``slot_of_key``
        (per padded key) records the rows' slot ids in the host slot
        metadata.

        The port's ``PullIndex`` has no ``key_valid``: the real keys are
        those with ``gather_idx < num_unique`` (``_build_index`` points
        every pad at slot ``num_unique``, as ``ps/extended`` points a
        skipped key). Only those are merged, in key order, so the pads
        never reach the accumulating ``index_put_``; the result is the
        reference's, whose key_valid mask zeroes them."""
        live = np.flatnonzero(idx.gather_idx < idx.num_unique)
        if slot_of_key is not None:
            sok = np.asarray(slot_of_key)[live].astype(np.int16)
            with self.host_lock:
                self.record_slots(idx.unique_rows, idx.gather_idx[live], sok)
        gi = torch.from_numpy(idx.gather_idx[live].astype(np.int64)).to(
            self.device)
        g = key_grads.new_zeros((len(idx.unique_rows), key_grads.shape[1]))
        g.index_put_((gi,), key_grads[torch.from_numpy(live).to(
            key_grads.device)], accumulate=True)
        rows = torch.from_numpy(idx.unique_rows).to(self.device)
        apply_push(self.state, rows, g, self.cfg,
                   generator=self.next_generator(), ops=ops)

    def host_pull(self, keys: np.ndarray,
                  data: Optional[np.ndarray] = None) -> np.ndarray:
        """[n] keys → [n, 3+mf] pull values on the HOST; unknown keys →
        zeros. ``data`` lets callers pass a cached logical mirror."""
        keys = np.ascontiguousarray(keys, np.uint64)
        with self.host_lock:
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
    def _assign_file_rows(self, keys: np.ndarray,
                          slots: np.ndarray) -> np.ndarray:
        """Rows for a save file's keys — slotted when the arena is on and
        the file's slots fit it, so the compact wire stays available after
        a restore — with their slots recorded. Caller holds host_lock."""
        if (self.index.arena_enabled and (slots >= 0).all()
                and (slots < self.arena_slots).all()):
            rows, _ = self.index.assign_slotted(keys,
                                                slots.astype(np.uint16))
        else:
            rows = self.index.assign(keys)
        self.slot_host[rows] = slots
        return rows

    def _insert_file_rows(self, data: np.ndarray, rows: np.ndarray,
                          blob, sel=slice(None)) -> None:
        """Write a save file's field blocks (all but slot, which is host
        metadata) into ``data`` at ``rows``; ``sel`` picks the file's
        rows to write (merge_model)."""
        mf_end = NUM_FIXED + self.mf_dim
        for f in FIELDS:
            if f == "slot":
                continue
            if f == "embedx_w":
                data[rows, NUM_FIXED:mf_end] = blob[f][sel]
            else:
                data[rows, FIELD_COL[f]] = blob[f][sel]
        if self.opt_ext:
            if "opt_ext" in blob \
                    and blob["opt_ext"].shape[1] == self.opt_ext:
                data[rows, mf_end:mf_end + self.opt_ext] = \
                    blob["opt_ext"][sel]
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
        blob = _read_blob(path)
        keys = np.asarray(blob["keys"], np.uint64)
        with self.host_lock:
            if merge:
                data = self.state.data.cpu().numpy().copy()
            else:
                self.index = self._new_kv()
                self._touched[:] = False
                self.slot_host[:] = 0
                data = np.zeros((self.capacity + 1, self.state.feat),
                                np.float32)
            rows = self._assign_file_rows(
                keys, np.asarray(blob["slot"]).astype(np.int16))
            self._insert_file_rows(data, rows, blob)
            self.state = TableState.from_logical(data, self.opt_ext,
                                                 self.device)
        self._reset_dev_index()
        return len(keys)

    # ---- table lifecycle (box_wrapper.h:638, :801-815) ----
    def _rows_tensor(self, rows: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(rows.astype(np.int64)).to(self.device)

    def merge_model(self, path: Union[str, Mapping[str, np.ndarray]]
                    ) -> int:
        """MergeModel (box_wrapper.h:801-803): fold another saved model's
        rows into the live table. Unlike ``load(merge=True)``, which
        overwrites rows from a delta file, this merges statistics: for
        keys present in both, show/clk/delta_score accumulate and the
        weights and optimizer state keep the live values; unseen keys
        come in with every field of the file. The state is updated in
        place. Returns the number of rows in the file."""
        blob = _read_blob(path)
        keys = np.asarray(blob["keys"], np.uint64)
        if len(keys) == 0:
            return 0
        slots_b = np.asarray(blob["slot"]).astype(np.int16)
        with self.host_lock:
            existing = self.index.lookup(keys) >= 0
            new = ~existing
            rows_new = self._assign_file_rows(keys[new], slots_b[new])
            rows_all = self.index.lookup(keys)
            # new rows: every field from the file (a freed or never used
            # row is zero, so the block's zero slot column is what it had)
            block = np.zeros((len(rows_new), self.state.feat), np.float32)
            self._insert_file_rows(block, np.arange(len(rows_new)), blob,
                                   sel=new)
            data = self.state.data
            data[self._rows_tensor(rows_new)] = torch.from_numpy(block).to(
                self.device)
            # rows in both: the statistics accumulate
            stats = np.stack([np.asarray(blob[f])[existing] for f in
                              ("show", "clk", "delta_score")], axis=1)
            rows_old = self._rows_tensor(rows_all[existing])
            data[rows_old, 0:3] += torch.from_numpy(
                stats.astype(np.float32)).to(self.device)
            self._touched[rows_all] = True
            self._reset_dev_index()
        log.info("merge_model: %d rows (%d new, %d stat-merged)",
                 len(keys), len(rows_new), int(existing.sum()))
        return len(keys)

    def merge_models(self, paths, update_type: str = "stats") -> int:
        """MergeMultiModels (box_wrapper.h:812-815): fold several saved
        models into the live table in order. ``update_type`` "stats"
        merges each file as ``merge_model`` does; "overwrite" applies
        each as a delta (``load(merge=True)``: later files win). Returns
        the rows of all files."""
        if update_type not in ("stats", "overwrite"):
            raise ValueError(f"unknown update_type {update_type!r}")
        total = 0
        for p in paths:
            total += (self.merge_model(p) if update_type == "stats"
                      else self.load(p, merge=True))
        return total

    def shrink(self, delete_threshold: Optional[float] = None,
               decay: Optional[float] = None) -> int:
        """Age the features (ShrinkTable, box_wrapper.h:638): decay
        show/clk/delta_score of every row, then release the rows whose
        decayed score falls below the threshold and zero them. Defaults
        from ``FLAGS.shrink_delete_threshold`` and
        ``FLAGS.show_click_decay_rate``. The state is updated in place;
        the freed rows go to the kv's free list, so the kv's rows stop
        being dense and the next flag-on bulk assignment degrades. Returns
        the rows freed."""
        thr = (FLAGS.shrink_delete_threshold if delete_threshold is None
               else delete_threshold)
        dk = FLAGS.show_click_decay_rate if decay is None else decay
        fence = getattr(self, "fence", None)
        if callable(fence):
            # a table with an asynchronous end-of-pass write-back drains
            # it first: aging pre-write-back counters would drop rows the
            # write-back is about to refresh
            fence()
        with self.host_lock:
            keys, rows = self.index.items()
            if len(keys) == 0:
                return 0
            data = self.state.data
            data[:, 0:3] *= dk
            sc = data[self._rows_tensor(rows), 0:2].cpu().numpy()
            show, clk = sc[:, 0], sc[:, 1]
            score = (self.cfg.nonclk_coeff * (show - clk)
                     + self.cfg.clk_coeff * clk)
            freed = self.index.release(keys[score < thr])
            data[self._rows_tensor(freed)] = 0.0
            self._touched[freed] = False
            self.slot_host[freed] = 0
            self._reset_dev_index()
        log.info("shrink: freed %d/%d rows", len(freed), len(keys))
        return int(len(freed))

    @property
    def feature_count(self) -> int:
        return len(self.index)


def _read_blob(path: Union[str, Mapping[str, np.ndarray]]
               ) -> Mapping[str, np.ndarray]:
    """A save file's arrays (or the same mapping in memory), the sharded
    format flattened."""
    if isinstance(path, Mapping):
        return _flatten_sharded_blob(path)
    with np.load(path) as f:
        return _flatten_sharded_blob(dict(f))
