"""Multi-mf × sharded: per-slot embedding dims on the sharded table; the
port of ``paddlebox_tpu/ps/multi_mf_sharded.py``.

Reference: the dynamic-mf accessor IS the sharded multi-GPU PS's value
layout — ``CommonFeatureValueAccessor`` (feature_value.h:42-185) with the
multi-mf build pipeline running per dim class across GPUs
(ps_gpu_wrapper.cc BuildGPUTask multi_mf paths).

One port ``ShardedEmbeddingTable`` per dim class (each with its static
row width and its own ``key % N`` shard layout over the SAME device
list), routed by the shared :class:`SlotClassMap`. A global batch yields
C per-class routing plans; the step (``train/multi_mf_sharded.py``) runs
C pull/push exchange pairs and concatenates the pooled blocks in
canonical slot order. :class:`MultiMfTieredShardedTable` makes each
class a ``TieredShardedEmbeddingTable`` (pass windows over per-shard
host stores).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence

import numpy as np

from paddlebox_tpu_torch.data.batch import SlotBatch
from paddlebox_tpu_torch.ps.multi_mf import SlotClassMap
from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
from paddlebox_tpu_torch.ps.sharded import (Devices, ShardedEmbeddingTable,
                                            ShardedPullIndex)
from paddlebox_tpu_torch.ps.table import host_pull_block
from paddlebox_tpu_torch.ps.tiered import TieredShardedEmbeddingTable

log = logging.getLogger(__name__)


class MultiMfShardedTable(SlotClassMap):
    """One ShardedEmbeddingTable per distinct slot mf_dim, on the same
    devices."""

    def __init__(self, num_shards: int, slot_mf_dims: Sequence[int],
                 capacity_per_shard: Optional[int] = None,
                 capacity_per_class: Optional[Dict[int, int]] = None,
                 cfg: Optional[SparseSGDConfig] = None,
                 req_bucket_min: int = 512,
                 serve_bucket_min: int = 1024, devices: Devices = "cuda",
                 **table_kw) -> None:
        super().__init__(slot_mf_dims)
        self.n = num_shards
        self.cfg = cfg or SparseSGDConfig()
        caps = capacity_per_class or {}
        self.tables: List[ShardedEmbeddingTable] = [
            self._make_class_table(
                num_shards, d,
                capacity_per_shard=caps.get(d, capacity_per_shard),
                cfg=self.cfg, req_bucket_min=req_bucket_min,
                serve_bucket_min=serve_bucket_min, devices=devices,
                **table_kw)
            for d in self.dims]
        self.devices = self.tables[0].devices

    def _make_class_table(self, num_shards: int, mf_dim: int, **kw):
        return ShardedEmbeddingTable(num_shards, mf_dim=mf_dim, **kw)

    # ------------------------------------------------------------------
    def prepare_global(self, batches: List[SlotBatch], assign: bool = True,
                       req_capacities: Optional[List[int]] = None,
                       serve_capacities: Optional[List[int]] = None
                       ) -> List[ShardedPullIndex]:
        """N local batches → per-class routing plans. serve_slot is
        remapped from class-local slot ranks (the sub-batch numbering)
        back to GLOBAL slot ids, so the persisted FeatureValue slot field
        stays globally meaningful (feature_value.h:570)."""
        subs = [self.split_batch(b)[0] for b in batches]   # [N][C]
        return self.prepare_global_from_subs(
            subs, assign=assign, req_capacities=req_capacities,
            serve_capacities=serve_capacities)

    def prepare_global_from_subs(self, subs, assign: bool = True,
                                 req_capacities=None,
                                 serve_capacities=None
                                 ) -> List[ShardedPullIndex]:
        """``prepare_global`` over ALREADY split per-class sub-batches
        (``subs[d][c]`` from ``split_batch``), for callers that also need
        the sub-batches' segments."""
        plans = []
        for c, t in enumerate(self.tables):
            plan = t.prepare_global(
                [subs[d][c] for d in range(len(subs))], assign=assign,
                req_capacity=(req_capacities[c] if req_capacities
                              else None),
                serve_capacity=(serve_capacities[c] if serve_capacities
                                else None))
            gslot = self.class_slots[c][
                plan.serve_slot.astype(np.int32)].astype(np.float32)
            plans.append(plan._replace(serve_slot=gslot))
        return plans

    def prepare_global_eval(self, batches: List[SlotBatch]
                            ) -> List[ShardedPullIndex]:
        return self.prepare_global(batches, assign=False)

    # ---- lifecycle: delegate per class (the multi-mf save format) ----
    def feature_count(self) -> int:
        return sum(t.feature_count() for t in self.tables)

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

    def merge_model(self, path: str) -> int:
        return sum(t.merge_model(f"{path}.mf{d}.npz")
                   for t, d in zip(self.tables, self.dims))

    def merge_models(self, paths, update_type: str = "stats") -> int:
        """MergeMultiModels across dim classes (box_wrapper.h:812-815);
        the tiered subclass inherits it and its calls go to the tiered
        ``merge_model`` / ``load``."""
        if update_type not in ("stats", "overwrite"):
            raise ValueError(f"unknown update_type {update_type!r}")
        return sum((self.merge_model(p) if update_type == "stats"
                    else self.load(p, merge=True)) for p in paths)

    def split_keys_by_class(self, keys: np.ndarray, slots: np.ndarray
                            ) -> List[np.ndarray]:
        """Each class's unique keys of a pass working set (a key goes to
        its slot's class table)."""
        keys = np.ascontiguousarray(keys, np.uint64)
        slots = np.asarray(slots, np.int32)
        cls = self.class_of_slot[slots]
        return [np.unique(keys[cls == c]) for c in range(self.num_classes)]

    def _class_pull(self, t, kc: np.ndarray) -> np.ndarray:
        """[k, 3 + mf] pull values of class table ``t``'s keys ``kc``,
        each shard read on its own device; unknown keys zeros."""
        vals = np.zeros((len(kc), 3 + t.mf_dim), np.float32)
        owners = (kc % np.uint64(t.n)).astype(np.int64)
        for s in range(t.n):
            sm = np.nonzero(owners == s)[0]
            if not len(sm):
                continue
            rows = t.indexes[s].lookup(kc[sm])
            known = rows >= 0
            if known.any():
                vals[sm[known]] = host_pull_block(
                    t._rows_host(s, rows[known]), t.mf_dim)
        return vals

    def pull(self, keys: np.ndarray, slots: np.ndarray) -> np.ndarray:
        """Host-side per-key pull padded to the MAX class width — the
        dy_mf CopyForPull contract; each key goes to its slot's class
        table, then to its owner shard inside it. Unknown keys zeros."""
        keys = np.ascontiguousarray(keys, np.uint64)
        slots = np.asarray(slots, np.int32)
        out = np.zeros((len(keys), 3 + max(self.dims)), np.float32)
        for c, t in enumerate(self.tables):
            m = self.class_of_slot[slots] == c
            if m.any():
                vals = self._class_pull(t, keys[m])
                out[np.nonzero(m)[0], :vals.shape[1]] = vals
        return out


class MultiMfTieredShardedTable(MultiMfShardedTable):
    """Per-slot embedding dims × beyond-HBM tiering × sharding: each dim
    class is a ``TieredShardedEmbeddingTable`` (per-shard host stores
    with pass windows), routed by the shared ``SlotClassMap``. The pass
    lifecycle fans out across the classes; the save surface is
    inherited (each class table's methods already run on its host tier).

    Pass keys arrive WITH their slots (``stage(keys, slots)``): a key's
    dim class is a property of its slot, not of its value."""

    wants_slot_keys = True  # BoxPSHelper passes (keys, slots)
    supports_overlap_stage = True  # the class tables reconcile

    def __init__(self, num_shards: int, slot_mf_dims: Sequence[int],
                 capacity_per_shard: Optional[int] = None,
                 capacity_per_class: Optional[Dict[int, int]] = None,
                 cfg: Optional[SparseSGDConfig] = None,
                 req_bucket_min: int = 512,
                 serve_bucket_min: int = 1024,
                 host_capacity: Optional[int] = None,
                 ssd_dir: Optional[str] = None,
                 devices: Devices = "cuda") -> None:
        """``ssd_dir`` gives each class its own SSD tier under
        ``{ssd_dir}/mf{d}``."""
        self._ssd_dir = ssd_dir
        super().__init__(num_shards, slot_mf_dims,
                         capacity_per_shard=capacity_per_shard,
                         capacity_per_class=capacity_per_class, cfg=cfg,
                         req_bucket_min=req_bucket_min,
                         serve_bucket_min=serve_bucket_min, devices=devices,
                         host_capacity=host_capacity)

    def _make_class_table(self, num_shards: int, mf_dim: int, **kw):
        ssd = (f"{self._ssd_dir}/mf{mf_dim}" if self._ssd_dir is not None
               else None)
        return TieredShardedEmbeddingTable(num_shards, mf_dim=mf_dim,
                                           ssd_dir=ssd, **kw)

    @property
    def in_pass(self) -> bool:
        return any(t.in_pass for t in self.tables)

    # ---- the pass lifecycle across the classes ----
    def stage(self, keys: np.ndarray, slots: np.ndarray,
              background: bool = True) -> None:
        per = self.split_keys_by_class(keys, slots)
        # check EVERY class's per-shard capacity before any class stages:
        # a failure halfway through the fan-out would leave staged
        # classes whose pending stages block the next stage/begin_pass
        for c, (t, ks) in enumerate(zip(self.tables, per)):
            for s, sk in enumerate(t._split_by_owner(ks)):
                if len(sk) > t.capacity:
                    raise ValueError(
                        f"class {c} shard {s} working set ({len(sk)}) "
                        f"exceeds capacity_per_shard ({t.capacity})")
        for c, ks in enumerate(per):
            self.tables[c].stage(ks, background=background)

    def wait_stage_done(self) -> None:
        for t in self.tables:
            t.wait_stage_done()

    def drop_window(self) -> None:
        """Invalidate every class table's window residency (between
        passes); discards pending stages."""
        for t in self.tables:
            t.drop_window()

    def begin_pass(self, keys: Optional[np.ndarray] = None,
                   slots: Optional[np.ndarray] = None) -> int:
        if keys is not None:
            per = self.split_keys_by_class(keys, slots)
            return sum(t.begin_pass(ks)
                       for t, ks in zip(self.tables, per))
        return sum(t.begin_pass() for t in self.tables)

    def end_pass(self) -> int:
        # each class table closes and submits its own async epilogue job;
        # fence() drains all of them
        return sum(t.end_pass() for t in self.tables)

    def fence(self) -> None:
        """Drain every class table's async end_pass epilogue (raises the
        first write-back failure)."""
        for t in self.tables:
            t.fence()

    def endpass_stats(self) -> dict:
        """Epilogue accounting over the dim classes: the additive fields
        sum; ``last_writeback_sec`` takes the max (a sum of per-class
        "last job" durations would be a duration no job had)."""
        parts = [t.endpass_stats() for t in self.tables]
        out: dict = {}
        for k in parts[0] if parts else ():
            vals = [p[k] for p in parts]
            out[k] = (max(vals) if k == "last_writeback_sec"
                      else sum(vals))
        return out

    def spill_cold(self, path_prefix: str, threshold: float) -> int:
        return sum(t.spill_cold(f"{path_prefix}.mf{d}", threshold)
                   for t, d in zip(self.tables, self.dims))

    def _class_pull(self, t, kc: np.ndarray) -> np.ndarray:
        """Host-tier pull (the windows hold only the last pass between
        passes; the whole model lives in the per-shard host stores, whose
        reads fence the epilogue first)."""
        vals = np.zeros((len(kc), 3 + t.mf_dim), np.float32)
        owners = (kc % np.uint64(t.n)).astype(np.int64)
        for s in range(t.n):
            sm = np.nonzero(owners == s)[0]
            if not len(sm):
                continue
            f = t.hosts[s].fetch(kc[sm])
            gate = (f["mf_size"][:, None] > 0)
            vals[sm] = np.concatenate(
                [f["show"][:, None], f["clk"][:, None],
                 f["embed_w"][:, None], f["embedx_w"] * gate], axis=1)
        return vals
