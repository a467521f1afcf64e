"""Online-serving loader — the consumer of base/delta model exports
(counterpart of ``paddlebox_tpu/serving.py``).

The ``.npz`` files ``EmbeddingTable.save_base/save_delta`` write (in
either package) load into a read-only ``ServingModel`` that answers:

- ``embed_lookup(keys)`` — raw feature rows; unknown keys read zeros;
- ``predict(batch)``     — the full CTR forward (pull → fused_seqpool_cvm
  → DeepFM → sigmoid) with eval semantics: nothing trains;
- ``predict_many(...)``  — micro-batches a request stream through ONE
  snapshot.

Queries never read mutable loader state. Every load materializes an
immutable ``ServingSnapshot`` (copy-on-publish: a frozen key index, the
device table, a host mirror and the dense model, captured together) and
swaps it in with one attribute assignment. A query reads ``self._snap``
once and then works only off that snapshot, so a concurrent reload can
neither block nor tear it.
"""

from __future__ import annotations

import copy
import dataclasses
import threading
from typing import List, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from paddlebox_tpu_torch.data.batch import BatchBuilder, SlotBatch
from paddlebox_tpu_torch.data.schema import DataFeedDesc
from paddlebox_tpu_torch.device import resolve_device
from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
from paddlebox_tpu_torch.ps.table import EmbeddingTable
from paddlebox_tpu_torch.train.step import ctr_forward, make_device_batch


class ServingSnapshot:
    """One immutable read view: a frozen ``EmbeddingTable`` (private
    index, its device state), a host mirror of the rows for lookups, and
    the dense model. Nothing mutates a snapshot after construction."""

    __slots__ = ("table", "model", "host_data")

    def __init__(self, table: EmbeddingTable, model: Optional[nn.Module],
                 host_data: np.ndarray) -> None:
        self.table = table
        self.model = model
        self.host_data = host_data

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        """[n] uint64 → [n, 3+mf] pull values off the host mirror;
        unknown keys → zeros."""
        return self.table.host_pull(keys, data=self.host_data)

    def digest(self) -> str:
        """sha256 over the snapshot's logical rows sorted by feasign."""
        return self.table.rows_digest()


class ServingModel:
    """Read-only base+delta consumer (the xbox-server role)."""

    def __init__(self, model: nn.Module, desc: DataFeedDesc, mf_dim: int,
                 capacity: int = 1 << 20, use_cvm: bool = True,
                 cvm_offset: int = 2, need_filter: bool = False,
                 quant_ratio: int = 0,
                 cfg: Optional[SparseSGDConfig] = None,
                 device: Union[str, torch.device] = "cuda") -> None:
        """The seqpool knobs (cvm_offset/need_filter/quant_ratio) must
        match the training step that produced the dense params — they
        change the pooled features. ``cfg`` is the table's optimizer
        config (it sets the row width)."""
        self.device = resolve_device(device)
        self.model = model
        self.desc = desc
        self.use_cvm = use_cvm
        self.cvm_offset = cvm_offset
        self.need_filter = need_filter
        self.quant_ratio = quant_ratio
        self.mf_dim = mf_dim
        self.capacity = capacity
        self._cfg = cfg or SparseSGDConfig()
        #: the LOADER table: the working state the load paths mutate.
        #: Queries never read it — they read the snapshot built from it.
        self.table = self._new_table()
        self.params: Optional[nn.Module] = None
        # the one pointer queries read; writers serialize on the lock and
        # assign a fully built replacement
        self._snap: Optional[ServingSnapshot] = None
        self._reload_lock = threading.RLock()

    def _new_table(self) -> EmbeddingTable:
        return EmbeddingTable(mf_dim=self.mf_dim, capacity=self.capacity,
                              cfg=self._cfg, device=self.device)

    # ---- loading ----
    def load_base(self, path: Union[str, Mapping[str, np.ndarray]]) -> int:
        """Replace the table with a save_base file (or mapping)."""
        with self._reload_lock:
            n = self.table.load(path, merge=False)
            self._refresh_snapshot()
        return n

    def apply_delta(self, path: Union[str, Mapping[str, np.ndarray]]
                    ) -> int:
        """Apply a save_delta file on top (incremental row updates)."""
        with self._reload_lock:
            n = self.table.load(path, merge=True)
            self._refresh_snapshot()
        return n

    def load_params(self, state_dict: Mapping[str, torch.Tensor]) -> None:
        """Publish dense params: a copy of the model takes
        ``state_dict`` (see ``convert.deepfm_state_dict_from_flax``) and
        swaps in beside the current table, so a dense-only refresh
        reaches queries at once."""
        model = copy.deepcopy(self.model)
        model.load_state_dict(state_dict)
        model = model.to(self.device).eval()
        with self._reload_lock:
            self.params = model
            snap = self._snap
            if snap is not None:
                self._snap = ServingSnapshot(snap.table, model,
                                             snap.host_data)

    # ---- snapshot materialization (copy-on-publish) ----
    def _materialize(self) -> ServingSnapshot:
        """Freeze the loader's current state: a private copy of the key
        index (the loader table is private to this model and never
        trained, and every load builds it a new device state, so that
        state is shared) and one host mirror of the rows."""
        loader = self.table
        with loader.host_lock:
            keys, rows = loader.index.items()
        frozen = self._new_table()
        order = np.argsort(rows)
        if not np.array_equal(frozen.index.assign(keys[order]),
                              rows[order]):
            raise RuntimeError("frozen index allocated other rows than "
                               "the loader")
        frozen.state = loader.state
        host_data = loader.state.data.cpu().numpy()
        return ServingSnapshot(frozen, self.params, host_data)

    def _refresh_snapshot(self) -> None:
        """Build-then-swap (caller holds ``_reload_lock``)."""
        self._snap = self._materialize()

    def snapshot(self) -> ServingSnapshot:
        """The currently serving snapshot (one atomic read; the first
        query before any load materializes the empty table)."""
        snap = self._snap
        if snap is not None:
            return snap
        with self._reload_lock:
            if self._snap is None:
                self._refresh_snapshot()
            return self._snap

    # ---- queries ----
    def embed_lookup(self, keys: np.ndarray) -> np.ndarray:
        """[n] uint64 → [n, 3+mf] pull values (show, clk, w, embedx…);
        unknown keys → zeros."""
        return self.snapshot().lookup(keys)

    def _predict_on(self, snap: ServingSnapshot, batch: SlotBatch,
                    return_valid: bool):
        if snap.model is None:
            raise RuntimeError("load_params first")
        idx = snap.table.prepare_eval(batch)
        dev = make_device_batch(batch, idx, self.device)
        with torch.inference_mode():
            pred, ins_w = ctr_forward(
                snap.table.state, snap.model, dev, batch.batch_size,
                batch.num_slots, self.use_cvm, self.cvm_offset,
                self.need_filter, self.quant_ratio)
        if return_valid:
            return pred.cpu().numpy(), ins_w.cpu().numpy()
        return pred.cpu().numpy()

    def predict(self, batch: SlotBatch, return_valid: bool = False):
        """CTR predictions [B] for one batch (unknown keys pull zeros).

        A batch shorter than ``desc.batch_size`` is padded; padding
        entries hold the net's output on zero rows, NOT real predictions
        — ``return_valid=True`` also returns the 0/1 validity mask."""
        return self._predict_on(self.snapshot(), batch, return_valid)

    def predict_many(self, requests, batch_max: int = 0,
                     return_valid: bool = False):
        """Run a request stream through ONE pinned snapshot.
        ``requests`` is an iterable of ``SlotBatch`` or a sequence of
        ``SlotRecord``; records are micro-batched into chunks of at most
        ``batch_max`` (0 = the desc batch size) and only the valid
        predictions are returned, concatenated."""
        snap = self.snapshot()
        reqs = list(requests)
        preds: List[np.ndarray] = []
        valids: List[np.ndarray] = []

        def run(batch: SlotBatch, n_valid: int) -> None:
            pred, ins_w = self._predict_on(snap, batch, return_valid=True)
            preds.append(pred[:n_valid])
            valids.append(ins_w[:n_valid])

        if reqs and not isinstance(reqs[0], SlotBatch):
            cap = self.desc.batch_size
            chunk = cap if batch_max <= 0 else max(1, min(int(batch_max),
                                                          cap))
            builder = BatchBuilder(
                self.desc if chunk == cap
                else dataclasses.replace(self.desc, batch_size=chunk))
            for i in range(0, len(reqs), chunk):
                part = reqs[i:i + chunk]
                run(builder.build(part), len(part))
        else:
            for b in reqs:
                run(b, b.batch_size)
        if not preds:
            empty = np.empty(0, np.float32)
            return (empty, empty) if return_valid else empty
        pred = np.concatenate(preds)
        if return_valid:
            return pred, np.concatenate(valids)
        return pred
