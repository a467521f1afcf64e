"""Device-resident key→row index — counterpart of
``paddlebox_tpu/ops/pallas_index.py`` (its ``scatter_add_update`` is
``ops/kernels.py``'s).

A linear-probe hash table on the device in one int32 tensor [nb, 4] of
16-byte buckets (``new_buckets``): key lo, key hi, row, pad. Every
function takes it as two strided views (``bucket_views``): keys int64
[nb] (the uint64 feature id viewed signed; keys are compared for
equality only) and rows int32 [nb], ``_EMPTY`` where unclaimed. The plain
versions take any two such arrays; the CUDA kernels take only the views
of one bucket tensor (``_bucket_base``), so a probe step is one 16-byte
load.

- ``insert`` places a deduped, first-seen-ordered key stream: a key
  already present returns its row, a new key claims an empty bucket and
  gets row ``next_row + its first-seen rank``. A probe longer than
  ``_MAX_PROBE`` buckets, or more new keys than the rows left, fails the
  WHOLE call and leaves the index as it was.
- ``lookup`` probes read-only; a miss gives -1. Stopping after
  ``_MAX_PROBE`` buckets is safe because ``insert`` never places a key
  further from home.

Each has a CUDA kernel (``csrc/key_index.cu``) and a plain version, the
parallel claim rounds of the reference's ``_insert_xla`` / ``_lookup_xla``.
The two may place a key in different buckets; rows and new-masks are
identical, and every layout either builds is a valid probe table for
the same keys, so comparisons are of logical mappings, never of bucket
bytes.

``DeviceKeyIndex`` is the device half of one table's index. The host kv
stays authoritative; the device index mirrors it only while the kv's
rows are dense, and any state it cannot mirror exactly makes it degrade,
loudly and for good, to the host path (``book_index_dispatch`` counts
each decision). The insert and lookup wrappers book
``pbox_kernel_dispatch_total{kernel="index_insert"|"index_lookup", impl}``
(``cuda`` or ``plain``) while the telemetry hub is active.
"""

from __future__ import annotations

import ctypes
import logging
from typing import TYPE_CHECKING, Dict, Optional, Tuple, Union

import numpy as np
import torch

from paddlebox_tpu_torch.device import resolve_device
from paddlebox_tpu_torch.ops import _build
from paddlebox_tpu_torch.ops.device_unique import dedup_keys_first_seen

if TYPE_CHECKING:
    from paddlebox_tpu_torch.ops.kernels import KernelSet

log = logging.getLogger(__name__)

_EMPTY = -1        # row of an unclaimed bucket
_CLAIMED = -2      # row of a bucket claimed by the running insert
_MAX_PROBE = 64    # probe-chain bound; longer chains overflow to the host
_MIN_BUCKETS = 512
_TILE = 1024       # keys per tile of the CUDA insert (one look-back state)
_FLAG_WORDS = 8    # int32 flags ahead of the tile states; [3] = failed
_M32 = 0xFFFFFFFF

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
# C signatures of csrc/key_index.cu
_INSERT_ARGS = [_P, _I64, _P, _I64, _I64, _I64, _P, _P, _P, _P, _P]
_LOOKUP_ARGS = [_P, _I64, _P, _I64, _P, _P]

#: index-seam dispatch decisions, {("index.<op>", impl): count}, impl
#: "device" or "host", always counted; each one also feeds the hub's
#: ``pbox_kernel_dispatch_total{kernel="index.<op>", impl}`` while the hub
#: is active, as the reference books it
DISPATCH: Dict[Tuple[str, str], int] = {}


def book_index_dispatch(op: str, impl: str) -> None:
    """Count one index-seam dispatch decision (op ∈ {assign, lookup})."""
    key = (f"index.{op}", impl)
    DISPATCH[key] = DISPATCH.get(key, 0) + 1
    _build.book_label(key[0], impl)


# ---------------------------------------------------------------------------
# buckets
# ---------------------------------------------------------------------------

def new_buckets(nb: int, device: Union[str, torch.device]) -> torch.Tensor:
    """An empty index of ``nb`` 16-byte buckets: int32 [nb, 4] holding
    key lo, key hi, row (``_EMPTY``) and pad."""
    buckets = torch.zeros((nb, 4), dtype=torch.int32, device=device)
    buckets[:, 2] = _EMPTY
    return buckets


def bucket_views(buckets: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (keys int64 [nb], rows int32 [nb]) views of a bucket tensor,
    strides 2 and 4: what :func:`insert` and :func:`lookup` take."""
    return buckets.view(torch.int64)[:, 0], buckets[:, 2]


def _bucket_base(bkeys: torch.Tensor, brows: torch.Tensor) -> int:
    """The address of the bucket tensor under ``bkeys``/``brows``, for a
    kernel. Raises unless they are :func:`bucket_views` of one 16-byte
    aligned [nb, 4] int32 tensor: there is no kernel for two separate
    arrays."""
    if bkeys.dtype != torch.int64 or brows.dtype != torch.int32:
        raise TypeError("key index: needs int64 bucket keys and int32 "
                        "bucket rows")
    nb = brows.shape[0]
    base = bkeys.data_ptr()
    storage = bkeys.untyped_storage()
    if (bkeys.dim() != 1 or brows.dim() != 1 or bkeys.shape[0] != nb
            or bkeys.stride() != (2,) or brows.stride() != (4,)
            or brows.data_ptr() != base + 8 or base % 16
            or brows.untyped_storage().data_ptr() != storage.data_ptr()
            or base - storage.data_ptr() + 16 * nb > storage.nbytes()):
        raise ValueError("key index: bucket keys and rows must be the "
                         "bucket_views of one [nb, 4] int32 tensor "
                         "(new_buckets), 16-byte aligned")
    return base


# ---------------------------------------------------------------------------
# hash
# ---------------------------------------------------------------------------

def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for ``a`` in [0, 2^32) held in int64 and a 32-bit
    constant ``c``, exactly: each 16-bit half of ``a`` times ``c`` stays
    below 2^48, so no int64 product overflows."""
    lo = a & 0xFFFF
    hi = a >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def _hash32(keys: torch.Tensor) -> torch.Tensor:
    """int64 keys → their uint32 bucket hash held in int64, bit for bit
    the reference's ``_hash32(hi, lo)`` over the key's 32-bit halves."""
    k = keys.long()
    lo = k & _M32
    hi = (k >> 32) & _M32
    h = (_mul32(lo, 0x9E3779B1) + _mul32(hi, 0x85EBCA77)) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    return h ^ (h >> 16)


# ---------------------------------------------------------------------------
# insert
# ---------------------------------------------------------------------------

def insert_plain(bkeys: torch.Tensor, brows: torch.Tensor,
                 keys: torch.Tensor, next_row: int, capacity: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of :func:`insert`: the reference's ``_insert_xla``.
    Every unplaced key probes at once; an empty bucket goes to the LOWEST
    stream position probing it this round (a scatter-min claim, verified
    by reading it back), the losers probe on, for at most ``_MAX_PROBE``
    rounds. A new key's row comes from a first-seen prefix sum."""
    k = keys.shape[0]
    nb = brows.shape[0]
    dev = keys.device
    pos = torch.arange(k, dtype=torch.int32, device=dev)
    h = _hash32(keys)
    keys = keys.long()
    off = torch.zeros(k, dtype=torch.int64, device=dev)
    row = torch.full((k,), -1, dtype=torch.int32, device=dev)
    new = torch.zeros(k, dtype=torch.bool, device=dev)
    slot = torch.zeros(k, dtype=torch.int64, device=dev)
    done = torch.zeros(k, dtype=torch.bool, device=dev)
    for _ in range(_MAX_PROBE):
        if bool(done.all()):
            break
        b = (h + off) & (nb - 1)
        r = brows[b]
        active = ~done
        is_match = active & (r >= 0) & (bkeys[b] == keys)
        is_empty = active & (r == _EMPTY)
        want = torch.where(is_empty, b, nb)
        claim = torch.full((nb + 1,), k, dtype=torch.int32,
                           device=dev).scatter_reduce_(0, want, pos, "amin")
        win = is_empty & (claim[want] == pos)
        won = b[win]
        bkeys[won] = keys[win]
        brows[won] = _CLAIMED
        row = torch.where(is_match, r, row)
        new |= win
        slot = torch.where(win, b, slot)
        done |= is_match | win
        off += (active & ~done).long()
    rank = torch.cumsum(new, 0) - 1
    num_new = int(new.sum())
    failed = (not bool(done.all())) or next_row + num_new > capacity
    nrow = (next_row + rank).int()
    row = torch.where(new, nrow, row)
    # commit the rows, or give the claimed buckets back
    brows[slot[new]] = _EMPTY if failed else nrow[new]
    return row, new.int(), torch.tensor(failed, device=dev)


def insert(bkeys: torch.Tensor, brows: torch.Tensor, keys: torch.Tensor,
           next_row: int, capacity: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Insert the deduped, first-seen-ordered key stream ``keys`` int64
    [n] into the index ``bkeys`` int64 [nb] / ``brows`` int32 [nb] (nb a
    power of two; on the card the :func:`bucket_views` of one bucket
    tensor), IN PLACE (``csrc/key_index.cu``). Returns ``(rows int32 [n],
    new int32 [n], failed)``: a key's row, whether it was new, and a
    0-dim bool tensor that is True when a probe overflowed or
    ``next_row`` + the new keys exceeded ``capacity``; a failed call
    leaves the index as it found it and its rows must be discarded."""
    if keys.device.type == "cpu" and brows.device.type == "cpu":
        _build.book(insert, "plain")
        return insert_plain(bkeys, brows, keys, next_row, capacity)
    _build.require_cuda("index_insert", keys)
    if keys.dtype != torch.int64:
        raise TypeError("index_insert: needs int64 keys")
    base = _bucket_base(bkeys, brows)
    nb = brows.shape[0]
    if (brows.device != keys.device or keys.dim() != 1 or nb & (nb - 1)
            or nb > 1 << 31):
        raise ValueError("index_insert: buckets [nb] with nb a power of "
                         "two up to 2^31 on the keys' device, keys [n]")
    n = keys.shape[0]
    dev = keys.device
    if n == 0:
        return (torch.empty(0, dtype=torch.int32, device=dev),
                torch.empty(0, dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.bool, device=dev))
    out = torch.empty((3, n), dtype=torch.int32, device=dev)
    rows, new, slot = out
    scratch = torch.empty(_FLAG_WORDS + 2 * -(-n // _TILE),
                          dtype=torch.int32, device=dev)
    fn = _build.function("key_index", "pbx_index_insert", _INSERT_ARGS)
    _build.check(fn(base, nb, keys.data_ptr(), n, int(next_row),
                    int(capacity), rows.data_ptr(), new.data_ptr(),
                    slot.data_ptr(), scratch.data_ptr(),
                    _build.stream(keys)), "index_insert")
    insert.launches += 1
    _build.book(insert, "cuda")
    return rows, new, scratch[3].bool()


insert.launches = 0
insert.label = "index_insert"


# ---------------------------------------------------------------------------
# lookup
# ---------------------------------------------------------------------------

def lookup_plain(bkeys: torch.Tensor, brows: torch.Tensor,
                 keys: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`lookup`: the reference's ``_lookup_xla``,
    all keys probing one bucket a round until a match or an empty
    bucket."""
    k = keys.shape[0]
    nb = brows.shape[0]
    dev = keys.device
    h = _hash32(keys)
    keys = keys.long()
    off = torch.zeros(k, dtype=torch.int64, device=dev)
    row = torch.full((k,), -1, dtype=torch.int32, device=dev)
    done = torch.zeros(k, dtype=torch.bool, device=dev)
    for _ in range(_MAX_PROBE):
        if bool(done.all()):
            break
        b = (h + off) & (nb - 1)
        r = brows[b]
        active = ~done
        is_match = active & (r >= 0) & (bkeys[b] == keys)
        row = torch.where(is_match, r, row)
        done |= is_match | (active & (r == _EMPTY))
        off += (~done).long()
    return row


def lookup(bkeys: torch.Tensor, brows: torch.Tensor,
           keys: torch.Tensor) -> torch.Tensor:
    """Rows of ``keys`` int64 [k] in the index (any order, duplicates
    fine; on the card the :func:`bucket_views` of one bucket tensor) →
    int32 [k], -1 for a miss (``csrc/key_index.cu``). Exact."""
    if keys.device.type == "cpu" and brows.device.type == "cpu":
        _build.book(lookup, "plain")
        return lookup_plain(bkeys, brows, keys)
    _build.require_cuda("index_lookup", keys)
    if keys.dtype != torch.int64:
        raise TypeError("index_lookup: needs int64 keys")
    base = _bucket_base(bkeys, brows)
    nb = brows.shape[0]
    if brows.device != keys.device or keys.dim() != 1 or nb & (nb - 1):
        raise ValueError("index_lookup: buckets [nb] with nb a power of "
                         "two on the keys' device, keys [k]")
    k = keys.shape[0]
    rows = torch.empty(k, dtype=torch.int32, device=keys.device)
    if k == 0:
        return rows
    fn = _build.function("key_index", "pbx_index_lookup", _LOOKUP_ARGS)
    _build.check(fn(base, nb, keys.data_ptr(), k, rows.data_ptr(),
                    _build.stream(keys)), "index_lookup")
    lookup.launches += 1
    _build.book(lookup, "cuda")
    return rows


lookup.launches = 0
lookup.label = "index_lookup"


# ---------------------------------------------------------------------------
# the host-facing index object
# ---------------------------------------------------------------------------

class DeviceKeyIndex:
    """The device half of one table's id→row index: the bucket tensor
    on the device (``buckets``, seen as ``keys``/``rows``) plus the
    host-tracked next-row cursor. The host kv stays
    AUTHORITATIVE (save/load/items); this object mirrors it only while
    the kv's rows are dense (next_row == len(kv)). Any state it cannot
    mirror exactly flips ``degraded`` and the table falls back to the
    host path, loudly, for good."""

    def __init__(self, capacity: int, n_buckets: Optional[int] = None,
                 device: Union[str, torch.device] = "cuda",
                 ops: Optional["KernelSet"] = None) -> None:
        """``ops`` selects the insert and lookup functions: the kernels,
        unless a check on the card passes ``kernels.PLAIN``."""
        if n_buckets is None:
            n_buckets = max(_MIN_BUCKETS,
                            1 << int(2 * capacity - 1).bit_length())
        if n_buckets & (n_buckets - 1):
            raise ValueError(f"n_buckets must be a power of 2: {n_buckets}")
        self.capacity = int(capacity)
        self.n_buckets = int(n_buckets)
        self.device = resolve_device(device)
        self._insert = insert if ops is None else ops.index_insert
        self._lookup = lookup if ops is None else ops.index_lookup
        self.buckets = new_buckets(self.n_buckets, self.device)
        self.keys, self.rows = bucket_views(self.buckets)
        self.next_row = 0
        self.degraded = False
        self.degrade_reason = ""

    def degrade(self, reason: str) -> None:
        if not self.degraded:
            log.warning("device key index degraded -> host path: %s",
                        reason)
        self.degraded = True
        self.degrade_reason = reason

    def _to_device(self, keys: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(
            keys, np.uint64).view(np.int64)).to(self.device)

    def seed_from_kv(self, kv) -> bool:
        """Mirror an existing kv: only possible when its rows are exactly
        0..len-1; inserting the keys in row order then reproduces every
        row. Returns False (→ degrade) otherwise."""
        keys, rows = kv.items()
        n = len(keys)
        if n == 0:
            return True
        if n > self.capacity:
            return False
        order = np.argsort(rows, kind="stable")
        if not np.array_equal(rows[order], np.arange(n, dtype=rows.dtype)):
            return False
        out = self.assign_unique(keys[order])
        if out is None:
            return False
        srows, snew = out
        return bool(np.array_equal(srows, np.arange(n, dtype=np.int64))
                    and snew.all())

    def _commit(self, rows: torch.Tensor, new: torch.Tensor,
                failed: torch.Tensor
                ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        if bool(failed):
            return None
        new_h = new.cpu().numpy().astype(bool)
        self.next_row += int(new_h.sum())
        return rows.cpu().numpy().astype(np.int64), new_h

    def assign_unique(self, uniq: np.ndarray
                      ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Assign rows to a duplicate-free, first-seen-ordered uint64 key
        stream. Returns (rows int64, new_mask bool), or None on probe or
        capacity overflow (the index unchanged)."""
        if len(uniq) == 0:
            return np.zeros(0, np.int64), np.zeros(0, bool)
        return self._commit(*self._insert(
            self.keys, self.rows, self._to_device(uniq), self.next_row,
            self.capacity))

    def assign_raw(self, keys: np.ndarray) -> Optional[Tuple[
            np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
        """Raw-id front door: first-seen dedup and insert on the device.
        Returns (uniq uint64, first_idx int32, inv int32, rows_u int64,
        new_mask bool) in first-seen order, or None on overflow (the
        index unchanged)."""
        n = len(keys)
        if n == 0:
            z = np.zeros(0, np.int32)
            return (np.zeros(0, np.uint64), z, z, z.astype(np.int64),
                    np.zeros(0, bool))
        uniq, first_pos, inv, u = dedup_keys_first_seen(self._to_device(keys))
        out = self._commit(*self._insert(self.keys, self.rows, uniq[:u],
                                         self.next_row, self.capacity))
        if out is None:
            return None
        return (uniq[:u].cpu().numpy().view(np.uint64),
                first_pos[:u].cpu().numpy(), inv.cpu().numpy(), *out)

    def lookup_rows(self, keys: np.ndarray) -> np.ndarray:
        """Rows for uint64 keys (any order, duplicates fine); miss → -1."""
        if len(keys) == 0:
            return np.zeros(0, np.int64)
        rows = self._lookup(self.keys, self.rows, self._to_device(keys))
        return rows.cpu().numpy().astype(np.int64)
