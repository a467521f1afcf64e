"""AucRunner — feature-importance evaluation by slot replacement; a copy
of ``paddlebox_tpu/auc_runner.py`` (host numpy, so the same seed
replaces the same feasigns in both packages).

Reference: fleet/box_wrapper.h:908-1009 (``InitializeAucRunner``,
``GetRandomReplace``, ``RecordReplace``/``RecordReplaceBack``,
``FlipPhase``) and box_wrapper.cc:212-335: during an eval phase, the
feasigns of chosen slots are replaced with feasigns sampled from OTHER
records (reservoir candidate pool: ``RecordCandidateList``,
data_feed.h:1484), destroying that slot's per-instance signal while
preserving its marginal distribution; the AUC drop vs the un-replaced
phase measures the slot's importance.

Replacement is immutable — ``record_replace``
returns NEW SlotRecord objects (originals are kept for
``record_replace_back``), so there is no in-place mutation racing the
reader threads, and the replaced pass flows through the normal
dataset → batch → step path unchanged.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Sequence

import numpy as np

from paddlebox_tpu_torch.data.record import SlotRecord

log = logging.getLogger(__name__)


@dataclasses.dataclass
class RecordCandidateList:
    """Reservoir sample of per-slot feasign arrays (data_feed.h:1484)."""

    capacity: int
    slots: Sequence[int]
    _pool: Dict[int, List[np.ndarray]] = dataclasses.field(
        default_factory=dict)
    _seen: int = 0

    def add_all(self, records: Sequence[SlotRecord],
                rng: np.random.Generator) -> None:
        for rec in records:
            self._seen += 1
            for s in self.slots:
                pool = self._pool.setdefault(s, [])
                vals = rec.slot_keys(s).copy()
                if len(pool) < self.capacity:
                    pool.append(vals)
                else:
                    j = int(rng.integers(0, self._seen))
                    if j < self.capacity:
                        pool[j] = vals

    def sample(self, slot: int, rng: np.random.Generator) -> np.ndarray:
        pool = self._pool.get(slot) or [np.empty(0, np.uint64)]
        return pool[int(rng.integers(0, len(pool)))]

    @property
    def size(self) -> int:
        return min(self._seen, self.capacity)


class AucRunner:
    """Slot-replacement evaluation runner.

    Usage (mirrors the reference pass protocol):
        runner = AucRunner(slots_to_replace=[3, 7], pool_size=10000)
        runner.init_pass(records)              # build candidate pools
        replaced = runner.record_replace(records)   # eval pass input
        ... run eval pass on `replaced`, compare AUC ...
        records = runner.record_replace_back()      # originals
    """

    def __init__(self, slots_to_replace: Sequence[int],
                 pool_size: int = 10000, seed: int = 0) -> None:
        self.slots = list(slots_to_replace)
        self.pool_size = pool_size
        self._rng = np.random.default_rng(seed)
        self.candidates = RecordCandidateList(pool_size, self.slots)
        self._originals: Optional[List[SlotRecord]] = None
        self.phase = 1  # 1 = normal (join), 0 = replaced (eval)

    def init_pass(self, records: Sequence[SlotRecord]) -> None:
        """Collect candidate feasigns (LoadAucRunnerData role)."""
        self.candidates.add_all(records, self._rng)
        log.info("auc_runner: candidate pool size %d for slots %s",
                 self.candidates.size, self.slots)

    def flip_phase(self) -> None:
        self.phase = 1 - self.phase

    def _replace_one(self, rec: SlotRecord) -> SlotRecord:
        off = rec.slot_offsets
        num_slots = len(off) - 1
        pieces = []
        new_off = np.zeros_like(off)
        for s in range(num_slots):
            vals = (self.candidates.sample(s, self._rng)
                    if s in self.slots else rec.slot_keys(s))
            pieces.append(vals)
            new_off[s + 1] = new_off[s] + len(vals)
        keys = (np.concatenate(pieces).astype(np.uint64) if pieces
                else np.empty(0, np.uint64))
        return dataclasses.replace(rec, keys=keys, slot_offsets=new_off)

    def record_replace(
            self, records: Sequence[SlotRecord]) -> List[SlotRecord]:
        """Return records with the chosen slots' feasigns swapped for
        random candidates (RecordReplace, box_wrapper.h:970)."""
        self._originals = list(records)
        out = [self._replace_one(r) for r in records]
        self.flip_phase()
        return out

    def record_replace_back(self) -> List[SlotRecord]:
        """Restore the un-replaced records (RecordReplaceBack)."""
        if self._originals is None:
            raise RuntimeError("record_replace_back before record_replace")
        out, self._originals = self._originals, None
        self.flip_phase()
        return out

    # ---- end-to-end convenience ----
    def slot_importance(self, eval_fn, records: Sequence[SlotRecord],
                        ) -> Dict[int, float]:
        """AUC drop per slot: eval_fn(records) -> auc. Runs one baseline
        eval plus one replaced eval per slot (each slot in isolation)."""
        base = eval_fn(list(records))
        out: Dict[int, float] = {}
        all_slots = self.slots
        for s in all_slots:
            self.slots = [s]
            replaced = self.record_replace(records)
            auc = eval_fn(replaced)
            self.record_replace_back()
            out[s] = base - auc
        self.slots = all_slots
        return out
