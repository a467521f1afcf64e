"""Key and row dedup on the device — counterpart of
``paddlebox_tpu/ops/device_unique.py``: ``dedup_rows`` (the compact
resident wire's per-batch dedup of row ids) and
``dedup_keys_first_seen`` (first-seen dedup of 64-bit feature ids, the
device key index's front door).

The reference is XLA, not Pallas, so plain PyTorch ops are its port on
both devices. Keys ride as int64 (the uint64 bits viewed signed): they are
compared for equality only, and the sort order only has to group equal
keys, so the sign never matters.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def dedup_rows(rows: torch.Tensor, capacity: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dedup per-key row ids int32 [K] into ``(unique_rows, gather_idx)``,
    both int32 [K] (the ``PullIndex`` contract): the distinct rows
    ascending, then DISTINCT out-of-bounds pads ``capacity + 1 + pos``
    that no key points at (gathers read the zero sentinel, scatters drop
    them); ``unique_rows[gather_idx[i]] == rows[i]``. Padding keys carry
    the sentinel row ``capacity`` and dedup into one regular entry.

    One stable sort carrying the positions, run-start marks, a cumsum of
    the marks into dense unique ids; each key's id goes back through the
    sort permutation, and every run writes its row into its id's slot
    (duplicates write the same value)."""
    k = rows.shape[0]
    dev = rows.device
    pos = torch.arange(k, dtype=torch.int32, device=dev)
    sr, perm = torch.sort(rows.to(torch.int32), stable=True)
    is_first = torch.ones(k, dtype=torch.bool, device=dev)
    is_first[1:] = sr[1:] != sr[:-1]
    uid = torch.cumsum(is_first, 0, dtype=torch.int32) - 1
    gather_idx = torch.empty(k, dtype=torch.int32, device=dev)
    gather_idx[perm] = uid
    unique_rows = capacity + 1 + pos
    unique_rows.index_put_((uid.long(),), sr)
    return unique_rows, gather_idx


def dedup_keys_first_seen(keys: torch.Tensor,
                          num_valid: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor, int]:
    """keys int64 [K], of which the first ``num_valid`` (default all) are
    real and the rest padding with any bits → ``(uniq, first_pos, inv,
    num_unique)``, padded to K as the reference's:

    - uniq int64 [K]: the distinct keys in first-seen order (zeros past
      num_unique);
    - first_pos int32 [K]: each unique's first position (K past
      num_unique);
    - inv int32 [K]: per position, the first-seen rank of its key
      (``uniq[inv[i]] == keys[i]``); padding positions hold num_unique.

    Bit for bit the host ``ps/table.dedup_first_seen``: a stable sort groups
    equal keys with their positions ascending, so each run's head is its
    segment minimum, i.e. the key's first position; sorting the heads
    gives the first-seen order."""
    k = keys.shape[0]
    n = k if num_valid is None else int(num_valid)
    dev = keys.device
    uniq = torch.zeros(k, dtype=torch.int64, device=dev)
    first_pos = torch.full((k,), k, dtype=torch.int32, device=dev)
    inv = torch.empty(k, dtype=torch.int32, device=dev)
    if n == 0:
        inv.fill_(0)
        return uniq, first_pos, inv, 0
    kv = keys[:n].long()
    sk, perm = torch.sort(kv, stable=True)
    is_first = torch.ones(n, dtype=torch.bool, device=dev)
    is_first[1:] = sk[1:] != sk[:-1]
    uid = torch.cumsum(is_first, 0) - 1           # run id of each sorted key
    heads, order = torch.sort(perm[is_first])     # first positions, in order
    u = heads.shape[0]
    rank = torch.empty(u, dtype=torch.int64, device=dev)
    rank[order] = torch.arange(u, dtype=torch.int64, device=dev)
    inv[perm] = rank[uid].int()
    inv[n:] = u
    first_pos[:u] = heads.int()
    uniq[:u] = kv[heads]
    return uniq, first_pos, inv, u
