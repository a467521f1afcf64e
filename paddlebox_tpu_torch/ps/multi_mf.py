"""Per-slot embedding dims (multi_mf_dim) — dim-class tables; the port of
``paddlebox_tpu/ps/multi_mf.py``.

Reference: ``CommonFeatureValueAccessor`` stores a per-feature ``mf_dim``
and lays every value out dynamically (feature_value.h:42-185); the build
pipeline groups keys by their slot's dim class (``multi_mf_dim_`` paths in
ps_gpu_wrapper.cc BuildGPUTask) and the pull/push copy kernels
(``CopyForPull/CopyForPush`` dy_mf variants) read per-slot widths.

The width varies only by SLOT, and slots partition the key space. So:
one full :class:`EmbeddingTable` per DIM CLASS (each with its static row
width, optimizer and slot arena), a per-slot class map, and a batch
splitter that routes each key to its class sub-batch. Pooled outputs
keep their per-slot widths and concatenate in canonical slot order
(``train/multi_mf_step.py``). The routing is host numpy, copied from the
reference so that both packages split a batch into the same arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from paddlebox_tpu_torch.data.batch import SlotBatch
from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
from paddlebox_tpu_torch.ps.table import (EmbeddingTable, PullIndex,
                                          next_bucket)


@dataclasses.dataclass
class ClassBatch:
    """One dim class's slice of a batch: a synthetic SlotBatch over the
    class's slots (S_c bins) plus its PullIndex."""

    batch: SlotBatch
    index: PullIndex


class SlotClassMap:
    """Slot → dim-class routing shared by every multi-mf table (single
    table, sharded, serving): ``slot_mf_dims[i]`` is the embedx width of
    sparse slot i; slots with equal widths form a class, classes ordered
    by width."""

    def __init__(self, slot_mf_dims: Sequence[int]) -> None:
        self.slot_mf_dims = np.asarray(slot_mf_dims, np.int32)
        if (self.slot_mf_dims <= 0).any():
            raise ValueError("slot mf dims must be positive")
        self.dims: List[int] = sorted(set(int(d) for d in slot_mf_dims))
        self.num_slots = len(self.slot_mf_dims)
        self.class_of_slot = np.array(
            [self.dims.index(int(d)) for d in self.slot_mf_dims], np.int32)
        # rank of each slot within its class (the segment renumbering)
        self.slot_rank = np.zeros(self.num_slots, np.int32)
        self.class_slots: List[np.ndarray] = []
        for c in range(len(self.dims)):
            idx = np.nonzero(self.class_of_slot == c)[0]
            self.slot_rank[idx] = np.arange(len(idx), dtype=np.int32)
            self.class_slots.append(idx.astype(np.int32))

    @property
    def num_classes(self) -> int:
        return len(self.dims)

    def class_dim(self, c: int) -> int:
        return self.dims[c]

    def pooled_width(self, cvm_offset: int = 2, use_cvm: bool = True) -> int:
        """Per-record width of the canonical slot-ordered pooled concat."""
        per = (cvm_offset if use_cvm else 0) + 1
        return int(sum(per + d for d in self.slot_mf_dims))

    def slot_route(self) -> List[Tuple[int, int]]:
        """Canonical reassembly order: (class, rank) per global slot."""
        return [(int(self.class_of_slot[s]), int(self.slot_rank[s]))
                for s in range(self.num_slots)]

    def split_batch(self, batch: SlotBatch
                    ) -> Tuple[List[SlotBatch], List[np.ndarray]]:
        """Route keys to per-class synthetic SlotBatches (the multi-mf
        BuildGPUTask grouping, done per batch on the host). A class
        sub-batch keeps the batch's key order, renumbers its segments to
        ``record * S_c + rank`` and pads its keys to
        ``next_bucket(1024, n + 1)`` with pad segment ``B * S_c``. Returns
        the sub-batches and each one's GLOBAL slot id per key (int16)."""
        nk = batch.num_keys
        s = batch.num_slots
        if s != self.num_slots:
            raise ValueError(
                f"batch has {s} slots, table configured for "
                f"{self.num_slots}")
        segs = batch.segments[:nk]
        slot_of_key = (segs % s).astype(np.int32)
        rec_of_key = segs // s
        cls_of_key = self.class_of_slot[slot_of_key]
        out = []
        gslots = []
        for c in range(self.num_classes):
            m = cls_of_key == c
            keys_c = batch.keys[:nk][m]
            gslots.append(slot_of_key[m].astype(np.int16))
            s_c = len(self.class_slots[c])
            segs_c = (rec_of_key[m] * s_c
                      + self.slot_rank[slot_of_key[m]]).astype(np.int32)
            kcap = next_bucket(1024, len(keys_c) + 1)
            keys_pad = np.zeros(kcap, np.uint64)
            keys_pad[:len(keys_c)] = keys_c
            segs_pad = np.full(kcap, batch.batch_size * s_c, np.int32)
            segs_pad[:len(keys_c)] = segs_c
            out.append(SlotBatch(
                keys=keys_pad, segments=segs_pad, num_keys=len(keys_c),
                dense=batch.dense, label=batch.label, show=batch.show,
                clk=batch.clk, batch_size=batch.batch_size,
                num_slots=s_c,
                segments_trivial=batch.segments_trivial))
        return out, gslots


class MultiMfEmbeddingTable(SlotClassMap):
    """One port ``EmbeddingTable`` per distinct slot mf_dim, class c
    seeded ``seed + c``, all on ``device``.

    Keys are routed by their slot's class; each class table sees a
    synthetic batch over only its slots, with segments renumbered to
    ``record * S_c + rank_of_slot_in_class``. The save files are one
    ``{path}.mf{d}.npz`` a class, each the single table's format."""

    def __init__(self, slot_mf_dims: Sequence[int],
                 capacity_per_class: Optional[Dict[int, int]] = None,
                 capacity: Optional[int] = None,
                 cfg: Optional[SparseSGDConfig] = None, seed: int = 0,
                 unique_bucket_min: int = 1024,
                 arena_chunk_bits: Optional[int] = None,
                 device: Union[str, torch.device] = "cuda") -> None:
        super().__init__(slot_mf_dims)
        caps = capacity_per_class or {}
        self.tables: List[EmbeddingTable] = []
        for c, d in enumerate(self.dims):
            n_slots_c = len(self.class_slots[c])
            cap = caps.get(d, capacity)
            self.tables.append(EmbeddingTable(
                mf_dim=d, cfg=cfg, seed=seed + c,
                unique_bucket_min=unique_bucket_min, device=device,
                arena_slots=(n_slots_c if arena_chunk_bits is not None
                             else None),
                arena_chunk_bits=arena_chunk_bits or 12,
                **({} if cap is None else {"capacity": cap})))
        self.device = self.tables[0].device

    @property
    def cfg(self) -> SparseSGDConfig:
        return self.tables[0].cfg

    @property
    def feature_count(self) -> int:
        return sum(t.feature_count for t in self.tables)

    def prepare(self, batch: SlotBatch) -> List[ClassBatch]:
        """Per-class dedup + row assignment (DedupKeysAndFillIdx per dim
        class). Returns one ClassBatch per class, in class order."""
        subs, gslots = self.split_batch(batch)
        out = []
        for b, t, gs in zip(subs, self.tables, gslots):
            idx = t.prepare(b)
            # re-record GLOBAL slot ids: the sub-batch's segments carry
            # class-local ranks, and the persisted FeatureValue slot
            # field must stay globally meaningful (feature_value.h:570)
            with t.host_lock:
                t.record_slots(idx.unique_rows[:idx.num_unique],
                               idx.gather_idx[:b.num_keys], gs)
            out.append(ClassBatch(b, idx))
        return out

    def prepare_eval(self, batch: SlotBatch) -> List[ClassBatch]:
        """Read-only per-class prepare: unknown keys read the zero
        sentinel row, nothing is assigned."""
        subs, _ = self.split_batch(batch)
        return [ClassBatch(b, t.prepare_eval(b))
                for b, t in zip(subs, self.tables)]

    # ---- lifecycle: delegate per class ----
    def save_base(self, path: str) -> int:
        return sum(t.save_base(f"{path}.mf{d}.npz")
                   for t, d in zip(self.tables, self.dims))

    def save_delta(self, path: str) -> int:
        return sum(t.save_delta(f"{path}.mf{d}.npz")
                   for t, d in zip(self.tables, self.dims))

    def load(self, path: str, merge: bool = False) -> int:
        return sum(t.load(f"{path}.mf{d}.npz", merge=merge)
                   for t, d in zip(self.tables, self.dims))

    def shrink(self, **kw) -> int:
        return sum(t.shrink(**kw) for t in self.tables)

    def pull(self, keys: np.ndarray, slots: np.ndarray) -> np.ndarray:
        """Host-side lookup: per-key pull values, padded to the MAX class
        width ([n, 3 + max_mf]; columns beyond the key's slot width are
        zero) — the dy_mf CopyForPull contract with per-slot widths.
        Unknown keys read zeros."""
        keys = np.ascontiguousarray(keys, np.uint64)
        slots = np.asarray(slots, np.int32)
        out = np.zeros((len(keys), 3 + max(self.dims)), np.float32)
        for c in range(self.num_classes):
            m = self.class_of_slot[slots] == c
            if not m.any():
                continue
            vals = self.tables[c].host_pull(keys[m])
            out[np.nonzero(m)[0], :vals.shape[1]] = vals
        return out
