"""Extended (expand) embedding pulls — pull_box_extended_sparse; the port
of ``paddlebox_tpu/ps/extended.py``.

Reference: paddle/fluid/operators/pull_box_extended_sparse_op.{cc,cu,h} —
one lookup returns TWO embeddings per key: the base ``emb_size`` vector
and an ``emb_extended_size`` "expand" vector from a second value space
(Python surface ``_pull_box_extended_sparse``, contrib/layers/nn.py:1678);
slots listed in ``skip_extend_slots`` only produce the base output (their
expand values read zero and train nothing).

The expand space is a second ``EmbeddingTable`` over the same keys (the
BoxPS core versions both inside one FeatureValue; two tables give the
same math with independent mf dims and optimizers). Pull and push go
through each table's ``pull`` / ``push`` (kernels ``gather_rows`` and
``scatter_add_update``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from paddlebox_tpu_torch.data.batch import SlotBatch
from paddlebox_tpu_torch.ops.kernels import KERNELS, KernelSet
from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
from paddlebox_tpu_torch.ps.table import (EmbeddingTable, PullIndex,
                                          fill_oob_pads, next_bucket)


class ExtendedEmbeddingTable:
    """Base + expand table pair sharing key traffic.

    ``skip_extend_slots`` (attr `skip_extend_slots` of the reference op):
    keys in those slots pull zeros from the expand space and push no
    expand grads — only the base embedding trains for them. The port's
    ``PullIndex`` carries no key mask: a skipped key points its expand
    ``gather_idx`` at the sentinel slot ``num_unique`` (a zero row), which
    ``EmbeddingTable.push`` leaves out of the merge."""

    def __init__(self, mf_dim: int, extend_mf_dim: int,
                 capacity: Optional[int] = None,
                 cfg: Optional[SparseSGDConfig] = None,
                 extend_cfg: Optional[SparseSGDConfig] = None,
                 seed: int = 0, unique_bucket_min: int = 1024,
                 skip_extend_slots: Sequence[int] = (),
                 device: Union[str, torch.device] = "cuda") -> None:
        cap = {} if capacity is None else {"capacity": capacity}
        self.base = EmbeddingTable(mf_dim, cfg=cfg, seed=seed,
                                   unique_bucket_min=unique_bucket_min,
                                   device=device, **cap)
        self.extend = EmbeddingTable(extend_mf_dim, cfg=extend_cfg or cfg,
                                     seed=seed + 1,
                                     unique_bucket_min=unique_bucket_min,
                                     device=device, **cap)
        self.skip_extend_slots = frozenset(skip_extend_slots)

    def prepare(self, batch: SlotBatch) -> Tuple[PullIndex, PullIndex]:
        # dedup once (sorted, as the reference's np.unique); both tables
        # share the unique set, the single dedup feeding both spaces
        valid = batch.keys[:batch.num_keys]
        uniq, inv = np.unique(valid, return_inverse=True)
        inv = inv.reshape(-1).astype(np.int32)
        slot_k = (batch.segments[:batch.num_keys]
                  % batch.num_slots).astype(np.int16)
        with self.base.host_lock:
            rows_b = self.base.index.assign(uniq)
            self.base._touched[rows_b] = True
            self.base.record_slots(rows_b, inv, slot_k)
        idx_b = self.base._build_index(batch, rows_b, inv)
        if not self.skip_extend_slots:
            with self.extend.host_lock:
                rows_e = self.extend.index.assign(uniq)
                self.extend._touched[rows_e] = True
                self.extend.record_slots(rows_e, inv, slot_k)
            return idx_b, self.extend._build_index(batch, rows_e, inv)
        keep = ~np.isin(slot_k, list(self.skip_extend_slots))
        uniq_e, inv_e = np.unique(valid[keep], return_inverse=True)
        inv_e = inv_e.reshape(-1).astype(np.int32)
        with self.extend.host_lock:
            rows_e = self.extend.index.assign(uniq_e)
            self.extend._touched[rows_e] = True
            self.extend.record_slots(rows_e, inv_e, slot_k[keep])
        u = len(uniq_e)
        cap = next_bucket(self.extend.unique_bucket_min, u + 1)
        unique_rows = np.empty(cap, np.int32)
        unique_rows[:u] = rows_e
        fill_oob_pads(unique_rows, u, self.extend.capacity)
        # skipped and padded keys point at the sentinel slot: zero pulls,
        # and no expand grads in the push
        gather_idx = np.full(batch.keys.shape[0], u, dtype=np.int32)
        gather_idx[:batch.num_keys][keep] = inv_e
        return idx_b, PullIndex(unique_rows, gather_idx, u)

    def pull(self, idx: Tuple[PullIndex, PullIndex],
             ops: KernelSet = KERNELS
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """→ (values [K, 3+mf], expand_values [K, 3+extend_mf])."""
        return self.base.pull(idx[0], ops), self.extend.pull(idx[1], ops)

    def push(self, idx: Tuple[PullIndex, PullIndex],
             key_grads: torch.Tensor, extend_key_grads: torch.Tensor,
             slot_of_key=None, ops: KernelSet = KERNELS) -> None:
        self.base.push(idx[0], key_grads, slot_of_key, ops)
        self.extend.push(idx[1], extend_key_grads, slot_of_key, ops)

    @property
    def feature_count(self) -> int:
        return self.base.feature_count
