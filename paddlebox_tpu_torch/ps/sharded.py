"""N-shard embedding table — counterpart of ``paddlebox_tpu/ps/sharded.py``
(the HeterComm redesign: heter_comm_inl.h).

The table is split by ``key % N`` (calc_shard_index_kernel,
heter_comm_kernel.cu:91). Each shard has its own host key index and its
own row-major ``[C+1, F]`` ``TableState`` on its device. All the sort,
dedup and routing work of a global batch (N local batches) happens on
the host, in ``prepare_global``:

    for each destination d: unique keys of d's batch, split by owner
    s = key % N into request lists [N, A] (A = padded per-pair width);
    for each owner s: one dedup of every request it serves → serve_rows
    [A2] and resp_idx [N, A] into it, so a row that several destinations
    ask for is served, and its grads merged, once.

The device side (``train/sharded.py``) is two exchanges of value-sized
blocks per step, one each way, plus the dense-gradient sum.

The port drives all N shards from one process, as the reference's
single-controller table does; each shard's state lives on a device of
the ``devices`` list (all on one card when there is one card).
"""

from __future__ import annotations

import logging
import threading
from typing import (Dict, Iterator, List, Mapping, NamedTuple, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch

from paddlebox_tpu_torch.config import FLAGS
from paddlebox_tpu_torch.data.batch import SlotBatch
from paddlebox_tpu_torch.device import resolve_device
from paddlebox_tpu_torch.ops.index import DeviceKeyIndex, book_index_dispatch
from paddlebox_tpu_torch.ops.seqpool_cvm import slot_group_bounds
from paddlebox_tpu_torch.ps.kv import make_kv
from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig, opt_ext_width
from paddlebox_tpu_torch.ps.table import (FIELD_COL, FIELDS, NUM_FIXED,
                                          TableState, fill_oob_pads,
                                          init_table_state, next_bucket)

log = logging.getLogger(__name__)

Devices = Union[str, torch.device, Sequence[Union[str, torch.device]]]


class ShardedPullIndex(NamedTuple):
    """Host-built routing plan for one global batch; leading dim = shard.

    Shapes: N shards, A = per-(dst, owner) request capacity, A2 =
    per-owner serve capacity, K = padded keys per local batch.
    ``req_need`` / ``serve_need`` are the unpadded maxima behind A/A2."""

    resp_idx: np.ndarray     # int32 [N_owner, N_dst, A] → slot in serve_rows
    serve_rows: np.ndarray   # int32 [N_owner, A2]; pads → out of bounds
    serve_valid: np.ndarray  # f32   [N_owner, A2]
    serve_slot: np.ndarray   # f32   [N_owner, A2] slot id of the row's key
    gather_idx: np.ndarray   # int32 [N_dst, K] → index into recv [N*A]
    key_valid: np.ndarray    # f32   [N_dst, K]
    req_capacity: int        # A
    serve_capacity: int      # A2
    req_need: int = 0        # max real requests per (dst, owner)
    serve_need: int = 0      # max real serve rows per owner (+1 sentinel)
    # ---- chunked exchange layout (FLAGS.a2a_chunks > 1) ----
    # empty/None = the monolithic plan. When set, the A axis is split
    # into per-slot-group sections (sum(a2a_sections) == A) so chunk g's
    # exchange ships only its section, and the key stream is re-laid
    # group-contiguous (sum(key_sections) == gather_idx.shape[1]) with
    # the matching segments in ``key_segments``.
    a2a_sections: Tuple[int, ...] = ()
    key_sections: Tuple[int, ...] = ()
    slot_sections: Tuple[int, ...] = ()
    key_segments: Optional[np.ndarray] = None  # int32 [N_dst, sum(K_g)]


def plan_sections(idx: ShardedPullIndex) -> Tuple:
    """The chunk-schedule key of a plan: ``(a2a_sections, key_sections,
    slot_sections)`` for a grouped plan, ``()`` for a monolithic one."""
    if idx.a2a_sections:
        return (tuple(idx.a2a_sections), tuple(idx.key_sections),
                tuple(idx.slot_sections))
    return ()


def section_offsets(sections) -> List[int]:
    """Start offset of each contiguous section (exclusive prefix sum)."""
    off, t = [], 0
    for x in sections:
        off.append(t)
        t += x
    return off


def chunk_local_positions(gi, a_total: int, a_lo: int, ag: int):
    """Global exchange positions ``owner*A + j`` → chunk-local
    ``owner*A_g + (j - a_lo)`` for the section at [a_lo, a_lo+ag).
    Operators only, so it takes numpy arrays and tensors alike."""
    owner = gi // a_total
    return owner * ag + (gi - owner * a_total) - a_lo


def _bucket(n: int, bucket_min: int) -> int:
    return next_bucket(bucket_min, n)


def _forced(width: int, forced: Optional[int], need: int, what: str) -> int:
    """``forced`` in place of the bucketed ``width``; a forced width below
    the need raises."""
    if forced is None:
        return width
    if forced < need:
        raise ValueError(f"forced {what} {forced} < needed {need}")
    return forced


def shard_devices(devices: Devices, n: int) -> List[torch.device]:
    """``devices`` as N resolved devices: one device for every shard, or
    a list of N."""
    if isinstance(devices, (str, torch.device)):
        return [resolve_device(devices)] * n
    devs = [resolve_device(d) for d in devices]
    if len(devs) != n:
        raise ValueError(f"{len(devs)} devices for {n} shards")
    return devs


def _read_raw(path: Union[str, Mapping[str, np.ndarray]]
              ) -> Mapping[str, np.ndarray]:
    """A save file's arrays as they are (or the same mapping in memory)."""
    if isinstance(path, Mapping):
        return path
    with np.load(path) as f:
        return dict(f)


class ShardedEmbeddingTable:
    """N-shard embedding store driven from a single host process.

    Key → owner shard ``key % N``; each shard has its own host kv and a
    ``[C+1, F]`` table state on ``devices[s]``. Unlike the single
    ``EmbeddingTable``, the slot column lives in the device rows (the
    push writes it from the plan's ``serve_slot``), as in the reference's
    sharded table."""

    def __init__(self, num_shards: int, mf_dim: int = 8,
                 capacity_per_shard: Optional[int] = None,
                 cfg: Optional[SparseSGDConfig] = None,
                 req_bucket_min: int = 512,
                 serve_bucket_min: int = 1024,
                 devices: Devices = "cuda") -> None:
        self.n = num_shards
        self.mf_dim = mf_dim
        self.capacity = capacity_per_shard or FLAGS.table_capacity_per_shard
        self.cfg = cfg or SparseSGDConfig()
        self.opt_ext = opt_ext_width(self.cfg, mf_dim)
        self.devices = shard_devices(devices, num_shards)
        self.indexes = [make_kv(self.capacity) for _ in range(num_shards)]
        self.req_bucket_min = req_bucket_min
        self.serve_bucket_min = serve_bucket_min
        self.states = [init_table_state(self.capacity, mf_dim, self.opt_ext,
                                        dev) for dev in self.devices]
        self._touched = np.zeros((num_shards, self.capacity + 1), dtype=bool)
        # serializes host index/touched mutation across threads (the
        # prefetch thread's prepare_global vs save/shrink)
        self.host_lock = threading.Lock()
        # per-shard device key indexes (FLAGS.use_pallas_index), built on
        # first use; None = not built since the last kv lifecycle change
        self._dev_indexes: Optional[List[Optional[DeviceKeyIndex]]] = None
        # THREAD-LOCAL plan marker (ps/tiered.plan_scope): while the
        # calling thread builds a routing plan for a FUTURE pass, its
        # new-key assigns are recorded by _note_plan_assigned instead of
        # being marked touched (they have no values yet and train only
        # after their pass's begin_pass). Thread-local: a streaming
        # prepare_global on another thread (training the open pass)
        # keeps the normal assign.
        self._plan_tls = threading.local()

    @property
    def _plan_depth(self) -> int:
        return getattr(self._plan_tls, "depth", 0)

    @property
    def feat(self) -> int:
        return NUM_FIXED + self.mf_dim + self.opt_ext

    # ------------------------------------------------------------------
    # device key assignment (FLAGS.use_pallas_index): one DeviceKeyIndex
    # per shard mirroring its host kv. The host kv stays authoritative;
    # any state a mirror cannot reproduce exactly degrades that shard,
    # loudly and for good, to the host path.
    def _dev_index_for(self, s: int) -> DeviceKeyIndex:
        """Shard ``s``'s device index, seeded from its host kv on first
        use (call under host_lock)."""
        if self._dev_indexes is None:
            self._dev_indexes = [None] * self.n
        dev = self._dev_indexes[s]
        if dev is None:
            dev = DeviceKeyIndex(self.capacity, device=self.devices[s])
            if not dev.seed_from_kv(self.indexes[s]):
                dev.degrade(f"shard {s}: host kv rows are not dense "
                            "(free-list holes): cannot mirror")
            self._dev_indexes[s] = dev
        return dev

    def _reset_dev_indexes(self) -> None:
        """Forget every shard's device index after a host kv lifecycle
        change (load, shrink, merge): the next flag-on prepare seeds a
        new one, or degrades where the kv's rows are no longer dense."""
        self._dev_indexes = None

    def _shard_rows_device(self, s: int, keys_s: np.ndarray,
                           assign: bool) -> Optional[np.ndarray]:
        """Device route for one owner-shard request list: the shard's
        device index instead of its host kv. Returns int32 rows (assign)
        or rows with miss → C (lookup), or None to take the host kv."""
        dev = self._dev_index_for(s)
        if dev.degraded:
            return None
        if len(self.indexes[s]) != dev.next_row:
            dev.degrade(f"shard {s}: host kv diverged "
                        f"({len(self.indexes[s])} keys vs "
                        f"{dev.next_row} mirrored)")
            return None
        if not assign:
            rows = dev.lookup_rows(keys_s)
            return np.where(rows < 0, self.capacity,
                            rows).astype(np.int32)
        out = dev.assign_unique(keys_s)
        if out is None:
            dev.degrade(f"shard {s}: probe/capacity overflow "
                        f"({len(keys_s)} keys at {dev.next_row} rows, "
                        f"capacity {self.capacity})")
            return None
        rows_u, new_mask = out
        if new_mask.any():
            # mirror only the new keys into the host kv; kv.assign
            # allocates in stream order, so a dense kv reproduces the
            # device rows exactly — anything else means holes
            krows = self.indexes[s].assign(keys_s[new_mask])
            if not np.array_equal(
                    krows, rows_u[new_mask].astype(krows.dtype)):
                dev.degrade(f"shard {s}: host kv allocated other rows "
                            "than the device index (free-list holes)")
                return None
        return rows_u.astype(np.int32, copy=False)

    def _shard_rows(self, s: int, keys_s: np.ndarray,
                    assign: bool) -> np.ndarray:
        """Owner-local rows of one (dst, owner) request list (call under
        host_lock; ``keys_s`` sorted unique keys owned by shard ``s``):
        the seam the monolithic and grouped plans share. With
        FLAGS.use_pallas_index the shard's device index serves it, both
        decisions counted by ``book_index_dispatch``. Plan-depth assigns
        (``_plan_depth``) stay on the host kv: their rows need the
        pre-lookup miss mask and roll back on abort."""
        if assign and self._plan_depth:
            pre = self.indexes[s].lookup(keys_s)
            self._plan_headroom(s, int((pre < 0).sum()))
            rows_s = self.indexes[s].assign(keys_s)
            if (pre < 0).any():
                self._note_plan_assigned(s, keys_s[pre < 0])
            # touched stays clear: plan rows train only after their pass
            # opens; mark_trained_rows flags them after training
            if self._dev_indexes is not None:
                # the mirror missed these assigns: re-seed on next use
                self._dev_indexes[s] = None
            return rows_s
        if FLAGS.use_pallas_index:
            op = "assign" if assign else "lookup"
            rows_s = self._shard_rows_device(s, keys_s, assign)
            if rows_s is not None:
                if assign:
                    self._touched[s][rows_s] = True
                book_index_dispatch(op, "device")
                return rows_s
            book_index_dispatch(op, "host")
        if assign:
            rows_s = self.indexes[s].assign(keys_s)
            self._touched[s][rows_s] = True
        else:
            rows_s = self.indexes[s].lookup(keys_s)
            rows_s = np.where(rows_s < 0, self.capacity,
                              rows_s).astype(rows_s.dtype)
        return rows_s

    def _plan_headroom(self, s: int, need: int) -> None:
        """Hook (called under host_lock) before a plan-depth assign of
        ``need`` new keys: the tiered table frees window rows; this table
        has nothing to free."""

    def _note_plan_assigned(self, s: int, new_keys: np.ndarray) -> None:
        """Hook (called under host_lock) for keys newly assigned during a
        plan build: the tiered table records them as value-less PENDING
        rows; this table needs nothing (fresh zero rows ARE its contract
        for unseen keys)."""

    # ------------------------------------------------------------------
    def prepare_global_eval(self, batches: List[SlotBatch],
                            req_capacity: Optional[int] = None,
                            serve_capacity: Optional[int] = None
                            ) -> ShardedPullIndex:
        """Read-only routing plan: unknown keys serve the zero sentinel
        row instead of allocating (no index mutation). Only for pull-only
        steps: serve_rows may repeat the sentinel."""
        return self.prepare_global(batches, req_capacity, serve_capacity,
                                   assign=False)

    def prepare_global(self, batches: List[SlotBatch],
                       req_capacity: Optional[int] = None,
                       serve_capacity: Optional[int] = None,
                       assign: bool = True,
                       groups: int = 1,
                       req_sections: Optional[Tuple[int, ...]] = None,
                       key_sections: Optional[Tuple[int, ...]] = None
                       ) -> ShardedPullIndex:
        """The routing plan of N local batches (one global batch), which
        share batch_size and num_slots. ``req_capacity`` /
        ``serve_capacity`` force the A / A2 widths (a width below the
        need raises): the sharded resident pass gives every global batch
        of a pass the same shapes this way, since gather_idx encodes
        positions as owner*A + j.

        ``groups > 1`` builds the chunked exchange layout
        (FLAGS.a2a_chunks): the A axis split into contiguous per-slot-
        group sections. It needs slot-qualified keys (every key's
        occurrences in one slot group of its batch); a batch that breaks
        this gets the monolithic plan, with a warning. ``req_sections``
        / ``key_sections`` force its per-group widths, the grouped form
        of ``req_capacity``."""
        if groups > 1:
            return self._prepare_global_grouped(
                batches, groups, serve_capacity=serve_capacity,
                assign=assign, req_sections=req_sections,
                key_sections=key_sections)
        n = self.n
        self._check_group(batches)
        k_pad = max(b.keys.shape[0] for b in batches)

        # per destination: unique local keys and the slot id of each
        # one's first occurrence (the table's slot field)
        dev_uniq: List[np.ndarray] = []
        dev_inv: List[np.ndarray] = []
        dev_uniq_slot: List[np.ndarray] = []
        for b in batches:
            uniq, first, inv = np.unique(
                b.keys[:b.num_keys], return_index=True, return_inverse=True)
            occ_slot = (b.segments[:b.num_keys] % b.num_slots
                        ).astype(np.float32)
            dev_uniq.append(uniq)
            dev_inv.append(inv)
            dev_uniq_slot.append(occ_slot[first])

        # request lists per (dst, owner)
        req_rows = [[None] * n for _ in range(n)]      # [dst][owner] → rows
        req_slots = [[None] * n for _ in range(n)]     # [dst][owner] → slots
        req_pos_of_uniq: List[np.ndarray] = []         # per dst: (owner, j)
        a_max = 1
        for d in range(n):
            uniq = dev_uniq[d]
            owners = (uniq % np.uint64(n)).astype(np.int64)
            pos = np.empty((len(uniq), 2), dtype=np.int64)
            for s in range(n):
                sel = np.nonzero(owners == s)[0]
                with self.host_lock:
                    rows_s = self._shard_rows(s, uniq[sel], assign)
                req_rows[d][s] = rows_s
                req_slots[d][s] = dev_uniq_slot[d][sel]
                pos[sel, 0] = s
                pos[sel, 1] = np.arange(len(sel))
                a_max = max(a_max, len(sel))
            req_pos_of_uniq.append(pos)
        A = _forced(_bucket(a_max, self.req_bucket_min), req_capacity,
                    a_max, "req_capacity")

        # owner-side dedup: all (dst, j) requests to owner s → serve slots
        resp_idx = np.zeros((n, n, A), dtype=np.int32)
        serve_rows_l, serve_slot_l, sinv_l = self._serve_dedup(req_rows,
                                                               req_slots)
        a2_max = max([1] + [len(su) + 1 for su in serve_rows_l])
        for s in range(n):
            sinv = sinv_l[s]
            off = 0
            for d in range(n):
                cnt = len(req_rows[d][s])
                resp_idx[s, d, :cnt] = sinv[off:off + cnt]
                # pads point at the sentinel serve slot (last)
                resp_idx[s, d, cnt:] = len(serve_rows_l[s])
                off += cnt
        A2 = _forced(_bucket(a2_max, self.serve_bucket_min), serve_capacity,
                     a2_max, "serve_capacity")
        serve_rows, serve_valid, serve_slot = self._serve_arrays(
            serve_rows_l, serve_slot_l, resp_idx, A2)

        # dst-side gather: local key occurrence → position in recv [N*A]
        gather_idx = np.full((n, k_pad), n * A - 1, dtype=np.int32)
        key_valid = np.zeros((n, k_pad), dtype=np.float32)
        for d in range(n):
            b = batches[d]
            oi = req_pos_of_uniq[d][dev_inv[d]]          # [nk, 2]
            gather_idx[d, :b.num_keys] = (oi[:, 0] * A + oi[:, 1]).astype(
                np.int32)
            key_valid[d, :b.num_keys] = 1.0
        return ShardedPullIndex(
            resp_idx=resp_idx, serve_rows=serve_rows, serve_valid=serve_valid,
            serve_slot=serve_slot, gather_idx=gather_idx,
            key_valid=key_valid, req_capacity=A, serve_capacity=A2,
            req_need=a_max, serve_need=a2_max)

    def _check_group(self, batches: List[SlotBatch]) -> None:
        if len(batches) != self.n:
            raise ValueError(f"need {self.n} local batches, got "
                             f"{len(batches)}")

    def _serve_dedup(self, req_rows, req_slots):
        """Per owner: the sorted unique rows of every destination's
        requests, their slots (any requester's; the last in destination
        order wins) and each request's serve slot. The monolithic and
        grouped plans share it, so both push the same rows in the same
        order."""
        n = self.n
        serve_rows_l, serve_slot_l, sinv_l = [], [], []
        for s in range(n):
            all_rows = np.concatenate([req_rows[d][s] for d in range(n)])
            all_slots = np.concatenate([req_slots[d][s] for d in range(n)])
            su, sinv = (np.unique(all_rows, return_inverse=True)
                        if len(all_rows) else
                        (np.empty(0, np.int64), np.empty(0, np.int64)))
            slot_l = np.zeros(len(su), np.float32)
            slot_l[sinv] = all_slots
            serve_rows_l.append(su)
            serve_slot_l.append(slot_l)
            sinv_l.append(sinv)
        return serve_rows_l, serve_slot_l, sinv_l

    def _serve_arrays(self, serve_rows_l, serve_slot_l,
                      resp_idx: np.ndarray, A2: int):
        """serve_rows / serve_valid / serve_slot [N, A2]; pad requests
        (resp_idx == u) repointed at the last serve slot, A2 - 1."""
        n = self.n
        serve_rows = np.empty((n, A2), dtype=np.int32)
        serve_valid = np.zeros((n, A2), dtype=np.float32)
        serve_slot = np.zeros((n, A2), dtype=np.float32)
        for s in range(n):
            u = len(serve_rows_l[s])
            serve_rows[s, :u] = serve_rows_l[s]
            fill_oob_pads(serve_rows[s], u, self.capacity)
            serve_valid[s, :u] = 1.0
            serve_slot[s, :u] = serve_slot_l[s]
            resp_idx[s][resp_idx[s] == u] = A2 - 1
        return serve_rows, serve_valid, serve_slot

    def _prepare_global_grouped(
            self, batches: List[SlotBatch], groups: int,
            serve_capacity: Optional[int] = None, assign: bool = True,
            req_sections: Optional[Tuple[int, ...]] = None,
            key_sections: Optional[Tuple[int, ...]] = None
            ) -> ShardedPullIndex:
        """Chunked-exchange plan (see prepare_global). Layout contract:

        - Rows are assigned in the monolithic order (sorted unique per
          (dst, owner) pair) before any re-layout, so new-key row ids,
          and so the whole table state, equal an ``a2a_chunks=1`` run's.
        - The A axis is ``sum(a2a_sections)`` wide; pair (dst, owner)'s
          group-g requests sit at ``[a_lo[g], a_lo[g]+cnt)``. Every
          section keeps at least one trailing pad (A_g ≥ need_g + 1), so
          the group's pad keys read zeros inside the section.
        - The key stream is re-laid group-contiguous (key_sections),
          each section padded with keys that gather the section's last
          (pad) position and pool into the discard bin; the matching
          segments ship as ``key_segments``.
        - The serve side is the monolithic plan's (one per-owner dedup),
          so the push's merge sums each row's grads in the same order.

        The slot-qualified check is per destination: a key in different
        slot groups on different destinations is still exact, since
        groups only shape each destination's own request layout."""
        n = self.n
        self._check_group(batches)
        S = batches[0].num_slots
        bounds = slot_group_bounds(S, groups)
        c = len(bounds)
        if c <= 1:
            return self.prepare_global(batches, assign=assign,
                                       serve_capacity=serve_capacity)
        grp_of_slot = np.zeros(S, np.int64)
        for g, (lo, hi) in enumerate(bounds):
            grp_of_slot[lo:hi] = g

        # uniques and the slot-qualified check BEFORE any index mutation,
        # so the monolithic fallback starts from an untouched index
        dev_uniq: List[np.ndarray] = []
        dev_inv: List[np.ndarray] = []
        dev_uniq_slot: List[np.ndarray] = []
        dev_key_grp: List[np.ndarray] = []
        for b in batches:
            uniq, first, inv = np.unique(
                b.keys[:b.num_keys], return_index=True,
                return_inverse=True)
            occ_slot = (b.segments[:b.num_keys]
                        % b.num_slots).astype(np.int64)
            occ_grp = grp_of_slot[occ_slot]
            key_grp = occ_grp[first]
            if (occ_grp != key_grp[inv]).any():
                log.warning(
                    "a2a_chunks=%d: a key's occurrences span slot groups "
                    "(keys are not slot-qualified): the monolithic "
                    "exchange for this batch", c)
                return self.prepare_global(batches, assign=assign,
                                           serve_capacity=serve_capacity)
            dev_uniq.append(uniq)
            dev_inv.append(inv)
            dev_uniq_slot.append(occ_slot[first].astype(np.float32))
            dev_key_grp.append(key_grp)

        # request lists per (dst, owner): rows assigned in monolithic
        # order, then re-laid group-contiguous with per-group ranks
        req_rows = [[None] * n for _ in range(n)]
        req_slots = [[None] * n for _ in range(n)]
        req_grp = [[None] * n for _ in range(n)]
        need_g = np.zeros(c, np.int64)
        req_pos_of_uniq: List[np.ndarray] = []  # per dst: (owner, g, rank)
        for d in range(n):
            uniq = dev_uniq[d]
            owners = (uniq % np.uint64(n)).astype(np.int64)
            pos = np.empty((len(uniq), 3), dtype=np.int64)
            for s in range(n):
                sel = np.nonzero(owners == s)[0]
                with self.host_lock:
                    rows_s = self._shard_rows(s, uniq[sel], assign)
                grp_s = dev_key_grp[d][sel]
                order = np.argsort(grp_s, kind="stable")
                req_rows[d][s] = rows_s[order]
                req_slots[d][s] = dev_uniq_slot[d][sel][order]
                req_grp[d][s] = grp_s[order]
                ranks = np.empty(len(sel), np.int64)
                for g in range(c):
                    m = grp_s == g
                    cnt = int(m.sum())
                    ranks[m] = np.arange(cnt)
                    need_g[g] = max(need_g[g], cnt)
                pos[sel, 0] = s
                pos[sel, 1] = grp_s
                pos[sel, 2] = ranks
            req_pos_of_uniq.append(pos)
        if req_sections is not None:
            a_secs = tuple(int(x) for x in req_sections)
            for g in range(c):
                _forced(0, a_secs[g], int(need_g[g]) + 1,
                        f"req_sections[{g}]")
        else:
            bmin = max(1, self.req_bucket_min // c)
            a_secs = tuple(_bucket(int(need_g[g]) + 1, bmin)
                           for g in range(c))
        a_lo = np.concatenate([[0], np.cumsum(a_secs)]).astype(np.int64)
        A = int(a_lo[-1])

        # owner-side dedup: the monolithic plan's; only positions move
        resp_idx = np.zeros((n, n, A), dtype=np.int32)
        serve_rows_l, serve_slot_l, sinv_l = self._serve_dedup(req_rows,
                                                               req_slots)
        a2_max = max([1] + [len(su) + 1 for su in serve_rows_l])
        for s in range(n):
            sinv = sinv_l[s]
            off = 0
            for d in range(n):
                cnt = len(req_rows[d][s])
                row = np.full(A, len(serve_rows_l[s]), np.int64)
                if cnt:
                    grp = req_grp[d][s]
                    jpos = a_lo[grp] + np.concatenate(
                        [np.arange(int((grp == g).sum())) for g in range(c)])
                    row[jpos] = sinv[off:off + cnt]
                resp_idx[s, d] = row
                off += cnt
        A2 = _forced(_bucket(a2_max, self.serve_bucket_min), serve_capacity,
                     a2_max, "serve_capacity")
        serve_rows, serve_valid, serve_slot = self._serve_arrays(
            serve_rows_l, serve_slot_l, resp_idx, A2)

        # dst-side gather: group-contiguous key sections
        k_need = np.zeros(c, np.int64)
        occ_grp_dev: List[np.ndarray] = []
        for d in range(n):
            og = dev_key_grp[d][dev_inv[d]]
            occ_grp_dev.append(og)
            for g in range(c):
                k_need[g] = max(k_need[g], int((og == g).sum()))
        if key_sections is not None:
            k_secs = tuple(int(x) for x in key_sections)
            for g in range(c):
                _forced(0, k_secs[g], int(k_need[g]), f"key_sections[{g}]")
        else:
            # power-of-two ladder from a fixed minimum, never from the
            # batch's k_pad, whose wobble would mint distinct layouts
            k_secs = tuple(_bucket(max(1, int(k_need[g])), 8)
                           for g in range(c))
        k_lo = np.concatenate([[0], np.cumsum(k_secs)]).astype(np.int64)
        kp = int(k_lo[-1])
        gather_idx = np.empty((n, kp), dtype=np.int32)
        key_valid = np.zeros((n, kp), dtype=np.float32)
        key_segments = np.empty((n, kp), dtype=np.int32)
        for d, b in enumerate(batches):
            oi = req_pos_of_uniq[d][dev_inv[d]]        # [nk, 3]
            gidx = (oi[:, 0] * A + a_lo[oi[:, 1]] + oi[:, 2]).astype(
                np.int32)
            seg = b.segments[:b.num_keys]
            og = occ_grp_dev[d]
            for g in range(c):
                m = np.nonzero(og == g)[0]             # original order
                lo, kg = int(k_lo[g]), int(k_secs[g])
                # section pads gather the section's guaranteed pad
                # position (the last j of owner n-1's section)
                gather_idx[d, lo:lo + kg] = (n - 1) * A + int(a_lo[g]) \
                    + a_secs[g] - 1
                gather_idx[d, lo:lo + len(m)] = gidx[m]
                key_valid[d, lo:lo + len(m)] = 1.0
                key_segments[d, lo:lo + kg] = b.pad_segment
                key_segments[d, lo:lo + len(m)] = seg[m]
        return ShardedPullIndex(
            resp_idx=resp_idx, serve_rows=serve_rows,
            serve_valid=serve_valid, serve_slot=serve_slot,
            gather_idx=gather_idx, key_valid=key_valid,
            req_capacity=A, serve_capacity=A2,
            req_need=int(need_g.max()), serve_need=a2_max,
            a2a_sections=a_secs, key_sections=k_secs,
            slot_sections=tuple(hi - lo for lo, hi in bounds),
            key_segments=key_segments)

    # ---- host save/load, per shard ----
    def feature_count(self) -> int:
        return sum(len(ix) for ix in self.indexes)

    def obs_stats(self) -> Dict[str, float]:
        """Occupancy gauges for pass events (obs/hub.emit_pass_event):
        totals across shards plus the fullest shard's fill (the key % N
        split skews, and one full shard stalls every step). The tiered
        table adds ``pending``."""
        per_shard = [len(ix) for ix in self.indexes]
        used = sum(per_shard)
        cap = self.capacity * self.n
        return {"capacity": cap, "used": used,
                "fill_frac": round(used / max(cap, 1), 6),
                "max_shard_fill_frac": round(
                    max(per_shard) / max(self.capacity, 1), 6)}

    def _rows_host(self, s: int, rows: np.ndarray) -> np.ndarray:
        """Shard ``s``'s logical rows at ``rows``, on the host."""
        idx = torch.from_numpy(rows.astype(np.int64)).to(self.devices[s])
        return self.states[s].data.index_select(0, idx).cpu().numpy()

    def _logical(self, s: int) -> np.ndarray:
        """A host copy of shard ``s``'s whole [C+1, F] state."""
        return self.states[s].data.cpu().numpy().copy()

    def _dump(self, path: str, row_filter) -> int:
        mf_end = NUM_FIXED + self.mf_dim
        blobs: Dict[str, np.ndarray] = {}
        total = 0
        for s in range(self.n):
            with self.host_lock:
                keys, rows = self.indexes[s].items()
                keys, rows = row_filter(s, keys, rows)
                # clear only the snapshotted rows, inside the lock: rows a
                # concurrent prepare touched keep their flag
                self._touched[s][rows] = False
            sub = self._rows_host(s, rows)
            blobs[f"keys_{s}"] = keys
            for f in FIELDS:
                blobs[f"{f}_{s}"] = (sub[:, NUM_FIXED:mf_end]
                                     if f == "embedx_w"
                                     else sub[:, FIELD_COL[f]])
            if self.opt_ext:
                blobs[f"opt_ext_{s}"] = sub[:, mf_end:]
            total += len(keys)
        np.savez(path, n=self.n, **blobs)
        return total

    def save_base(self, path: str) -> int:
        """Full model dump (SaveBase, box_wrapper.cc:1383): ``n``, then
        ``keys_{s}`` and ``{field}_{s}`` per shard, the reference's
        arrays, uncompressed (``EmbeddingTable.save_base``)."""
        return self._dump(path, lambda s, keys, rows: (keys, rows))

    def save_delta(self, path: str) -> int:
        """Rows touched since the last save (SaveDelta,
        box_wrapper.cc:1406)."""
        def flt(s, keys, rows):
            m = self._touched[s][rows]
            return keys[m], rows[m]
        return self._dump(path, flt)

    def _write_fields(self, data: np.ndarray, rows: np.ndarray,
                      fields: Mapping[str, np.ndarray], s: int,
                      sel=slice(None)) -> None:
        """A save file's field blocks into logical ``data`` at ``rows``
        (``sel`` picks the file's rows)."""
        mf_end = NUM_FIXED + self.mf_dim
        for f in FIELDS:
            if f == "embedx_w":
                data[rows, NUM_FIXED:mf_end] = fields[f][sel]
            else:
                data[rows, FIELD_COL[f]] = fields[f][sel]
        if not self.opt_ext:
            return
        if "opt_ext" in fields and fields["opt_ext"].shape[1] == self.opt_ext:
            data[rows, mf_end:] = fields["opt_ext"][sel]
        elif len(rows):
            data[rows, mf_end:] = 0.0
            log.warning("load: file has no matching opt_ext block for shard "
                        "%d; optimizer state starts fresh", s)

    def load(self, path: Union[str, Mapping[str, np.ndarray]],
             merge: bool = False) -> int:
        """Load a base/delta dump (any shard count, or a single-table
        save: keys re-split by ``key % N``; or the same mapping in
        memory); ``merge=True`` applies it on top of the live table, else
        the table (host index and device rows) starts empty. The shards
        get NEW states either way. Returns the rows in the file."""
        blob = _read_raw(path)
        total = 0
        with self.host_lock:
            if not merge:
                self.indexes = [make_kv(self.capacity)
                                for _ in range(self.n)]
                self._touched[:] = False
            states = []
            for s, (keys, fields) in enumerate(self._file_per_shard(blob)):
                data = (self._logical(s) if merge else
                        np.zeros((self.capacity + 1, self.feat), np.float32))
                rows = self.indexes[s].assign(
                    np.ascontiguousarray(keys, np.uint64))
                self._write_fields(data, rows, fields, s)
                states.append(TableState.from_logical(data, self.opt_ext,
                                                      self.devices[s]))
                total += len(keys)
            self.states = states
            self._reset_dev_indexes()
        return total

    # ---- lifecycle: shrink / merge (box_wrapper.h:638-640, :801-815) ----
    def shrink(self, delete_threshold: Optional[float] = None,
               decay: Optional[float] = None) -> int:
        """ShrinkTable over every shard: decay show/clk/delta_score, then
        release the rows whose decayed score falls below the threshold
        and zero them (``EmbeddingTable.shrink``'s rules). In place."""
        thr = (FLAGS.shrink_delete_threshold
               if delete_threshold is None else delete_threshold)
        dk = FLAGS.show_click_decay_rate if decay is None else decay
        freed_total = 0
        with self.host_lock:
            for s in range(self.n):
                data = self.states[s].data
                data[:, 0:3] *= dk
                keys, rows = self.indexes[s].items()
                if len(keys) == 0:
                    continue
                sc = self._rows_host(s, rows)
                show, clk = sc[:, 0], sc[:, 1]
                score = (self.cfg.nonclk_coeff * (show - clk)
                         + self.cfg.clk_coeff * clk)
                freed = self.indexes[s].release(keys[score < thr])
                data[torch.from_numpy(freed.astype(np.int64)).to(
                    self.devices[s])] = 0.0
                self._touched[s][freed] = False
                freed_total += len(freed)
            self._reset_dev_indexes()
        log.info("sharded shrink: freed %d rows across %d shards",
                 freed_total, self.n)
        return freed_total

    def _file_per_shard(self, blob: Mapping[str, np.ndarray]
                        ) -> Iterator[Tuple[np.ndarray, Dict[str, np.ndarray]]]:
        """(keys, fields) per owner shard of a save file: as stored when
        its shard count is N, else (another N, some shards only, or a
        single-table save) re-split by ``key % N``."""
        want = list(FIELDS) + (["opt_ext"] if self.opt_ext else [])
        if "n" in blob and int(blob["n"]) == self.n \
                and all(f"keys_{s}" in blob for s in range(self.n)):
            for s in range(self.n):
                yield blob[f"keys_{s}"], {f: blob[f"{f}_{s}"] for f in want
                                          if f"{f}_{s}" in blob}
            return
        if "n" in blob:
            fn = int(blob["n"])
            present = [s for s in range(fn) if f"keys_{s}" in blob]
            if present:
                keys = np.concatenate([blob[f"keys_{s}"] for s in present])
                fields = {f: np.concatenate([blob[f"{f}_{s}"]
                                             for s in present])
                          for f in want if f"{f}_{present[0]}" in blob}
            else:
                keys = np.zeros(0, np.uint64)
                fields = {}
        else:
            keys = blob["keys"]
            fields = {f: blob[f] for f in want if f in blob}
        owners = (np.ascontiguousarray(keys, np.uint64)
                  % np.uint64(self.n)).astype(np.int64)
        for s in range(self.n):
            m = owners == s
            yield keys[m], {f: v[m] for f, v in fields.items()}

    def merge_model(self, path: Union[str, Mapping[str, np.ndarray]]
                    ) -> int:
        """MergeModel (box_wrapper.h:801-803) per shard: keys in both
        accumulate show/clk/delta_score and keep the live weights and
        optimizer state; unseen keys come in with every field of the
        file. Takes sharded saves of any shard count and single-table
        saves. Updates the states in place."""
        blob = _read_raw(path)
        total = 0
        with self.host_lock:
            for s, (keys, fields) in enumerate(self._file_per_shard(blob)):
                if len(keys) == 0:
                    continue
                keys = np.ascontiguousarray(keys, np.uint64)
                data = self._logical(s)
                existing = self.indexes[s].lookup(keys) >= 0
                rows_new = self.indexes[s].assign(keys[~existing])
                self._write_fields(data, rows_new, fields, s, sel=~existing)
                rows_old = self.indexes[s].lookup(keys[existing])
                for f in ("show", "clk", "delta_score"):
                    data[rows_old, FIELD_COL[f]] += fields[f][existing]
                self._touched[s][self.indexes[s].lookup(keys)] = True
                self.states[s].data.copy_(torch.from_numpy(data))
                total += len(keys)
            self._reset_dev_indexes()
        log.info("sharded merge_model: %d rows", total)
        return total

    def merge_models(self, paths, update_type: str = "stats") -> int:
        """MergeMultiModels (box_wrapper.h:812-815): "stats" merges each
        file as ``merge_model``; "overwrite" applies each as a delta
        (``load(merge=True)``: later files win)."""
        if update_type not in ("stats", "overwrite"):
            raise ValueError(f"unknown update_type {update_type!r}")
        total = 0
        for p in paths:
            total += (self.merge_model(p) if update_type == "stats"
                      else self.load(p, merge=True))
        return total
