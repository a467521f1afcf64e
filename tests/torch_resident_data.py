"""Shared inputs of the resident-pass port tests (``test_torch_resident_
wires.py``, ``test_torch_preload.py``): seeded records, both packages'
datasets, tables and trainers at a small size, and table stand-ins that
force a wire format without a table of that size."""

import threading

import numpy as np
import optax
import torch

import jax
import jax.numpy as jnp

from paddlebox_tpu.data import DataFeedDesc as JDesc
from paddlebox_tpu.data import SlotDef as JSlotDef
from paddlebox_tpu.data.dataset import InMemoryDataset as JDataset
from paddlebox_tpu.data.record import SlotRecord as JRecord
from paddlebox_tpu.models import DeepFM as JDeepFM
from paddlebox_tpu.ps import EmbeddingTable as JTable
from paddlebox_tpu.ps import SparseSGDConfig as JCfg
from paddlebox_tpu.train import Trainer as JTrainer

from paddlebox_tpu_torch import (DeepFM, EmbeddingTable, InMemoryDataset,
                                 Trainer, convert)
from paddlebox_tpu_torch.data import DataFeedDesc, SlotDef, SlotRecord
from paddlebox_tpu_torch.ps.kv import dedup_first_seen_py
from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig

STATE_RTOL, STATE_ATOL = 2e-4, 2e-5   # the ragged train-state class
S, MF, DENSE, BS, CAP = 4, 4, 3, 64, 1 << 12
CFG = dict(mf_create_thresholds=0.0, mf_initial_range=0.0,
           learning_rate=0.05, mf_learning_rate=0.05)
VOCAB = 600                            # ids per slot


def arrays(n=5 * BS, seed=0, trivial=False, slots=S, zipf=1.5):
    """Records as (keys, slot_offsets, dense, label): Zipf-ragged slots
    (or one key per slot), slot-qualified ids (slot * 10 000 + id, so a
    key belongs to one slot)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        counts = (np.ones(slots, np.int64) if trivial
                  else np.minimum(rng.zipf(zipf, size=slots), 8))
        offs = np.zeros(slots + 1, np.int32)
        np.cumsum(counts, out=offs[1:])
        ids = rng.integers(0, VOCAB, size=int(offs[-1])).astype(np.uint64)
        slot = np.repeat(np.arange(slots, dtype=np.uint64), counts)
        out.append((slot * np.uint64(10_000) + ids, offs,
                    (rng.normal(size=DENSE) * [1.0, 10.0, 0.1]
                     ).astype(np.float32), float(i % 2)))
    return out


def _slot_defs(cls, slots=S):
    return ([cls("label", "float", 1), cls("d", "float", DENSE)]
            + [cls(f"S{i}", "uint64") for i in range(slots)])


def port_desc(slots=S, key_bucket_min=512):
    return DataFeedDesc(slots=_slot_defs(SlotDef, slots), label_slot="label",
                        batch_size=BS, key_bucket_min=key_bucket_min)


def jax_desc(slots=S, key_bucket_min=512):
    return JDesc(slots=_slot_defs(JSlotDef, slots), label_slot="label",
                 batch_size=BS, key_bucket_min=key_bucket_min)


def port_dataset(arrs, columnar=False, **kw):
    ds = InMemoryDataset(port_desc(**kw))
    ds.records = [SlotRecord(k, o, d, lb, 1.0, lb) for k, o, d, lb in arrs]
    if columnar:
        ds.columnarize()
    return ds


def jax_dataset(arrs, columnar=False, **kw):
    ds = JDataset(jax_desc(**kw))
    ds.records = [JRecord(k, o, d, lb, 1.0, lb) for k, o, d, lb in arrs]
    if columnar:
        ds.columnarize()
    return ds


def port_table(arena=False, cfg=None, capacity=CAP):
    return EmbeddingTable(mf_dim=MF, capacity=capacity,
                          cfg=SparseSGDConfig(**(cfg or CFG)),
                          unique_bucket_min=512, device="cpu",
                          arena_slots=S if arena else None,
                          arena_chunk_bits=6)


def jax_table(arena=False, cfg=None, capacity=CAP):
    return JTable(mf_dim=MF, capacity=capacity, cfg=JCfg(**(cfg or CFG)),
                  unique_bucket_min=512, arena_slots=S if arena else None,
                  arena_chunk_bits=6)


def params0(seed=4):
    torch.manual_seed(seed)
    return DeepFM(S, 3 + MF, DENSE, hidden=(16, 8)).state_dict()


def port_trainer(params, table=None, **kw):
    model = DeepFM(S, 3 + MF, DENSE, hidden=(16, 8),
                   compute_dtype=torch.float32)
    model.load_state_dict(params)
    return Trainer(model, table or port_table(**kw), port_desc(),
                   tx=lambda p: torch.optim.Adam(p, lr=1e-2, eps=1e-8),
                   seed=3, check_nan_inf=True, device="cpu")


def jax_trainer(table=None, **kw):
    """A JAX trainer and its initial params as a port state_dict."""
    jtr = JTrainer(JDeepFM(hidden=(16, 8), compute_dtype=jnp.float32),
                   table or jax_table(**kw), jax_desc(), tx=optax.adam(1e-2),
                   seed=3)
    return jtr, convert.deepfm_state_dict_from_flax(
        jax.device_get(jtr.state.params))


def jax_state(jtr):
    """(keys, logical rows by field, params) of a JAX trainer, by key."""
    jtr.sync_table()
    keys, rows = jtr.table.index.items()
    order = np.argsort(keys)
    return (keys[order], jtr.table._gather_host(rows[order]),
            convert.deepfm_state_dict_from_flax(
                jax.device_get(jtr.state.params)))


def port_state(tr):
    keys, rows = tr.table.index.items()
    order = np.argsort(keys)
    return (keys[order], tr.table._gather_host(rows[order]),
            tr.model.state_dict())


def assert_state_close(port, ref):
    """Rows by key and dense params within the train-state class."""
    np.testing.assert_array_equal(port[0], ref[0])
    for f in sorted(ref[1]):
        np.testing.assert_allclose(port[1][f], ref[1][f], rtol=STATE_RTOL,
                                   atol=STATE_ATOL, err_msg=f)
    for name, want in ref[2].items():
        np.testing.assert_allclose(port[2][name].numpy(), want.numpy(),
                                   rtol=STATE_RTOL, atol=STATE_ATOL,
                                   err_msg=name)


class _SlotSink:
    """Stands in for ``slot_host``: the pass builds record slots, no test
    here reads them."""

    def __setitem__(self, key, value):
        pass


class _NoArena:
    arena_enabled = False


class RowMapTable:
    """A table stand-in for both packages' ``build_streamed``: the n-th
    first-seen key gets row ``rows_of(n)``. It lets a test force each
    uniq wire (gaps, widths) without a table of that capacity."""

    def __init__(self, capacity, rows_of, device="cpu"):
        self.capacity = capacity
        self.rows_of = rows_of
        self.unique_bucket_min = 512
        self.index = _NoArena()
        self.host_lock = threading.Lock()
        self.last_assign_seconds = {"index_host": 0.0, "index_device": 0.0}
        self.device = torch.device(device)
        self._rows = {}

    def bulk_assign_unique(self, keys, slot_of_key):
        uniq, _, inv = dedup_first_seen_py(np.asarray(keys, np.uint64))
        rows = np.empty(len(uniq), np.int32)
        for j, k in enumerate(uniq.tolist()):
            if k not in self._rows:
                self._rows[k] = self.rows_of(len(self._rows))
            rows[j] = self._rows[k]
        return rows, inv


class _FakeArena:
    """A slot arena whose slot-local row of key ``slot * 10 000 + id`` is
    ``id << shift``, slot s owning chunks [s * R, (s + 1) * R)."""

    arena_enabled = True

    def __init__(self, n_slots, chunk_bits, bits):
        self.n_slots, self.cb = n_slots, chunk_bits
        self.shift = bits - int(VOCAB - 1).bit_length()
        self.ranks = 1 << max(bits - chunk_bits, 0)

    def assign_slotted(self, keys, slots):
        keys = np.asarray(keys, np.int64)
        loc = (keys % 10_000) << self.shift
        s = np.asarray(slots, np.int64)
        row = (((s * self.ranks + (loc >> self.cb)) << self.cb)
               | (loc & ((1 << self.cb) - 1)))
        return row.astype(np.int32), loc.astype(np.int32)

    def arena_export(self):
        c = np.arange(self.n_slots * self.ranks, dtype=np.int32)
        return c // self.ranks, c % self.ranks


class ArenaMapTable:
    """A slot-arena table stand-in for both packages' compact wire: its
    locals need exactly ``bits`` bits."""

    def __init__(self, bits, chunk_bits=12, device="cpu"):
        self.index = _FakeArena(S, chunk_bits, bits)
        self.arena_slots = S
        self.arena_chunk_bits = chunk_bits
        self.capacity = (S * self.index.ranks) << chunk_bits
        self.unique_bucket_min = 512
        self.slot_host = _SlotSink()
        self.host_lock = threading.Lock()
        self.device = torch.device(device)
