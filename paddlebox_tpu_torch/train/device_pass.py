"""Device-resident pass — counterpart of
``paddlebox_tpu/train/device_pass.py`` (the dedup wire, float32 floats
and the record front).

A pass's batches are packed on the host once: ``ResidentPass.build``
gives every key of the pass its row in ONE bulk assignment
(``EmbeddingTable.bulk_assign_unique``, on the device key index when
``FLAGS.use_pallas_index`` is on), then cuts each batch's pull index out
of it — the batch's sorted unique rows and each key's position among
them. ``upload`` stages the pass on the device in one copy per array, and
``ResidentPassRunner`` runs the staged batches through ``TrainStep``,
slicing each batch's view on the device: no host→device copy per step.

Not ported yet: ``PassPreloader`` (building pass k+1 while pass k
trains), ``build_streamed``, the bit-packed / q8 / compact / slot wires
and the columnar front.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from paddlebox_tpu_torch.config import FLAGS
from paddlebox_tpu_torch.data.dataset import InMemoryDataset
from paddlebox_tpu_torch.device import seeded_generator
from paddlebox_tpu_torch.ps.table import fill_oob_pads, next_bucket_fine
from paddlebox_tpu_torch.train.step import (StepState, TrainStep,
                                            pack_floats, unpack_floats)


class ResidentPass:
    """One pass's batches, packed on the host, then staged on the device.

    Arrays (nb = batches, K = uniform per-batch key capacity, U =
    uniform per-batch unique capacity):
      uniq:   int32 [nb, U]  per-batch unique table rows, ascending, then
              DISTINCT out-of-bounds pads (``fill_oob_pads``: gathers read
              the zero sentinel row, scatters drop them)
      gidx:   int32 [nb, K]  per-key position in uniq; key pads → the
              first pad position (num_unique)
      floats: f32   [nb, B, D+3]  [dense | label | show | clk]
      meta:   int32 [nb, 4]  [num_keys, pad_segment, num_unique,
              first unique row]; stays on the host
      segs:   int32 [nb, K] | None  None when every batch has the trivial
              one-key-per-slot layout
    """

    def __init__(self, uniq: np.ndarray, gidx: np.ndarray,
                 floats: np.ndarray, meta: np.ndarray,
                 segs: Optional[np.ndarray], num_records: int) -> None:
        self.uniq = uniq
        self.gidx = gidx
        self.floats = floats
        self.meta = meta
        self.segs = segs
        self.num_records = num_records
        # (uniq, gidx, floats, segs-or-None) on the device, after upload
        self.dev: Optional[Tuple[Optional[torch.Tensor], ...]] = None
        # host seconds per build stage: front, dedup (of which index_host
        # and index_dev on the bulk path), pack; upload adds h2d
        self.build_stats: Dict[str, float] = {}

    @property
    def num_batches(self) -> int:
        return self.gidx.shape[0]

    @property
    def key_capacity(self) -> int:
        return self.gidx.shape[1]

    @property
    def unique_capacity(self) -> int:
        return self.uniq.shape[1]

    @classmethod
    def build(cls, dataset: InMemoryDataset, table) -> "ResidentPass":
        """Pack a dataset's batches: assign table rows for every key and
        dedup per batch.

        The table's touched flags are NOT set here: a pass built ahead
        has not trained yet. The trainer marks the pass's rows after it
        runs (``mark_trained_rows``)."""
        stats: Dict[str, float] = {}
        t0 = time.perf_counter()
        per_batch, floats, trivial, nrec = cls._front(dataset)
        t1 = time.perf_counter()
        dedup, u_pad, k_max = cls._dedup_phase(per_batch, table,
                                               stats=stats)
        t2 = time.perf_counter()
        uniq, gidx, meta, segs = cls._pack_chunk(per_batch, dedup, u_pad,
                                                 k_max, trivial,
                                                 table.capacity)
        stats.update(front=t1 - t0, dedup=t2 - t1,
                     pack=time.perf_counter() - t2)
        rp = cls(uniq, gidx, floats, meta, segs, nrec)
        rp.build_stats = stats
        return rp

    @classmethod
    def _front(cls, dataset: InMemoryDataset):
        """Slice the pass into per-batch key views and pack the float
        block. Returns (per_batch, floats, trivial, num_records);
        per_batch entries are (keys, slot_of_key, key_capacity,
        pad_segment, segments)."""
        per_batch = []
        floats_l = []
        trivial = True
        nrec = 0
        for b in dataset.batches():
            nk = b.num_keys
            slot_of_key = (b.segments[:nk] % b.num_slots).astype(np.int16)
            per_batch.append((b.keys[:nk], slot_of_key, b.key_capacity,
                              b.pad_segment,
                              b.segments[:nk].astype(np.int32, copy=False)))
            floats_l.append(pack_floats(b.dense, b.label, b.show, b.clk))
            nrec += int((b.show > 0).sum())
            trivial = trivial and b.segments_trivial
        if not per_batch:
            raise ValueError("empty pass")
        return per_batch, np.stack(floats_l), trivial, nrec

    @classmethod
    def _dedup_phase(cls, per_batch, table, threads: int = 4,
                     stats: Optional[Dict[str, float]] = None):
        """Pass-level row assignment and per-batch dedup. Returns
        ([(uniq_sorted, gidx)] per batch, u_pad, k_max).

        BULK path (``FLAGS.bulk_pass_assign``, default): every batch's
        keys concatenated, ONE first-seen dedup + assignment
        (``table.bulk_assign_unique``; ``stats`` gets its host kv and
        device index seconds), then the per-batch sort/rank splits on a
        thread pool (numpy releases the GIL). New rows come in first-seen
        order over the pass, the rows a serial batch walk of the
        first-occurrence index gives.

        SERIAL path (flag off): one index round trip per batch."""
        if FLAGS.bulk_pass_assign:
            keys_all = np.concatenate([k for k, *_ in per_batch])
            slots_all = np.concatenate([s for _, s, *_ in per_batch])
            rows_u, inv = table.bulk_assign_unique(keys_all, slots_all)
            if stats is not None:
                las = table.last_assign_seconds
                stats["index_host"] = las["index_host"]
                stats["index_dev"] = las["index_device"]
            rows_of_key = rows_u[inv]
            bounds = np.cumsum([0] + [len(k) for k, *_ in per_batch])

            def batch_dedup(a, b):
                u, g = np.unique(rows_of_key[a:b], return_inverse=True)
                return (u.astype(np.int32, copy=False),
                        g.astype(np.int32, copy=False))

            with ThreadPoolExecutor(max_workers=threads) as pool:
                dedup = list(pool.map(batch_dedup, bounds[:-1], bounds[1:]))
        else:
            dedup = cls._dedup_serial(per_batch, table, threads)
        u_max = max(len(u) + 1 for u, _ in dedup)
        u_pad = next_bucket_fine(table.unique_bucket_min, u_max)
        k_max = max(kc for _, _, kc, _, _ in per_batch)
        return dedup, u_pad, k_max

    @classmethod
    def _dedup_serial(cls, per_batch, table, threads: int = 4):
        """The per-batch assignment loop: one ``host_lock`` acquisition
        and index round trip per batch."""

        def sort_rank(rows_u, inv):
            u = len(rows_u)
            order = np.argsort(rows_u, kind="stable")
            rank = np.empty(u, np.int32)
            rank[order] = np.arange(u, dtype=np.int32)
            return rows_u[order], rank[inv]

        futs = []
        with ThreadPoolExecutor(max_workers=threads) as pool:
            for keys, slot_of_key, *_ in per_batch:
                with table.host_lock:
                    rows_u, inv = table.index.assign_unique(keys)
                    table.record_slots(rows_u, inv, slot_of_key)
                futs.append(pool.submit(sort_rank, rows_u, inv))
            return [f.result() for f in futs]

    @classmethod
    def _pack_chunk(cls, per_batch, dedup, u_pad: int, k_max: int,
                    trivial: bool, cap: int):
        """Pack the batches into uniform host arrays (uniq, gidx, meta,
        segs-or-None), unique rows ascending."""
        nb = len(per_batch)
        uniq = np.empty((nb, u_pad), np.int32)
        gidx = np.empty((nb, k_max), np.int32)
        meta = np.empty((nb, 4), np.int32)
        segs = None if trivial else np.empty((nb, k_max), np.int32)
        for i, ((keys, _, _, pad_seg, seg_arr),
                (uniq_s, gidx_i)) in enumerate(zip(per_batch, dedup)):
            nk, u = len(keys), len(uniq_s)
            uniq[i, :u] = uniq_s
            fill_oob_pads(uniq[i], u, cap)
            gidx[i, :nk] = gidx_i
            gidx[i, nk:] = u  # key pads → first OOB pad position
            meta[i] = (nk, pad_seg, u, uniq[i, 0])
            if segs is not None:
                segs[i, :nk] = seg_arr
                segs[i, nk:] = pad_seg
        return uniq, gidx, meta, segs

    def upload(self, device: torch.device) -> None:
        """Stage the pass on ``device``: uniq, gidx, floats and (ragged
        layouts) segs, one host→device copy each, as plain int32 and
        float32. The per-batch key counts stay on the host (``meta``).
        The reference's bit-packed wires carry the same content in fewer
        bytes and are not ported yet."""
        if self.dev is not None:
            return
        t0 = time.perf_counter()
        arrays = [self.uniq, self.gidx, self.floats]
        if self.segs is not None:
            arrays.append(self.segs)
        dev = [torch.from_numpy(a).to(device) for a in arrays]
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.build_stats["h2d"] = time.perf_counter() - t0
        self.dev = tuple(dev) + ((None,) if self.segs is None else ())

    def nbytes(self) -> int:
        """Bytes staged on the device (after upload; before it, what
        upload would ship)."""
        if self.dev is not None:
            return sum(t.numel() * t.element_size() for t in self.dev
                       if t is not None)
        n = self.uniq.nbytes + self.gidx.nbytes + self.floats.nbytes
        return n + (self.segs.nbytes if self.segs is not None else 0)

    def mark_trained_rows(self, table) -> None:
        """Flag this pass's rows as touched since the last save — called
        AFTER the pass trains. The OOB pad ids are dropped first."""
        rows = self.uniq.ravel()
        rows = rows[rows <= table.capacity]
        with table.host_lock:
            table._touched[rows] = True


class _BatchView:
    """One staged batch, duck-typed to the ``DeviceBatch`` fields that
    ``TrainStep`` reads."""

    def __init__(self, unique_rows: torch.Tensor, gather_idx: torch.Tensor,
                 segments: Optional[torch.Tensor], floats: torch.Tensor,
                 num_keys: int) -> None:
        self.unique_rows = unique_rows
        self.gather_idx = gather_idx
        self.pool_segments = segments  # None: the trivial layout
        self.num_keys = num_keys
        self.dense, self.label, self.show, _ = unpack_floats(floats)
        self.show_clk = floats[:, -2:].float()


class ResidentPassRunner:
    """Runs a staged pass through a ``TrainStep``, one step per batch,
    each batch's view sliced on the device."""

    def __init__(self, step: TrainStep, trivial_segments: bool,
                 chunk: int = 0) -> None:
        self.step = step
        self.trivial = trivial_segments
        self.chunk = chunk

    def _make_view(self, rp: ResidentPass, i: int) -> _BatchView:
        uniq, gidx, floats, segs = rp.dev
        return _BatchView(uniq[i], gidx[i],
                          None if self.trivial else segs[i], floats[i],
                          int(rp.meta[i, 0]))

    def run_pass(self, state: StepState, rp: ResidentPass, seed: int,
                 global_step: int, chunk: Optional[int] = None
                 ) -> List[torch.Tensor]:
        """Run every staged batch, updating ``state`` in place. Step i
        draws its lazy-mf values from ``seeded_generator(device, seed + 1,
        global_step + i + 1)``, the generator ``Trainer.train_pass`` gives
        the same global step. The host queues ``chunk`` steps (default:
        the runner's, else the whole pass) before it waits for the card.
        Returns the per-step losses (device tensors)."""
        device = state.table.data.device
        rp.upload(device)
        nb = rp.num_batches
        c = chunk or self.chunk or nb
        losses = []
        for i in range(nb):
            gen = seeded_generator(device, seed + 1, global_step + i + 1)
            losses.append(self.step(state, self._make_view(rp, i),
                                    gen)["loss"])
            if (i + 1) % c == 0:
                losses[-1].item()   # the chunk is done on the card
        return losses
