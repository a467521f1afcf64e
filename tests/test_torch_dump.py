"""The port's dump (``utils/dump.py``): the cases of
``tests/test_dump.py`` — sample lines through the writer thread, a
trainer pass that dumps every record, and the named parameter dump."""

import glob

import numpy as np
import torch

from paddlebox_tpu_torch import DeepFM, EmbeddingTable, Trainer
from paddlebox_tpu_torch.data import (DataFeedDesc, InMemoryDataset,
                                      SlotDef, SlotRecord)
from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
from paddlebox_tpu_torch.utils.dump import DumpConfig, DumpWriter


def make_trainer(n=300, num_slots=3):
    rng = np.random.default_rng(0)
    desc = DataFeedDesc(
        slots=[SlotDef(name=f"s{i}") for i in range(num_slots)]
        + [SlotDef(name="d0", type="float", dim=2)],
        batch_size=64, key_bucket_min=512)
    recs = []
    for i in range(n):
        keys = rng.integers(0, 40, size=num_slots).astype(np.uint64)
        recs.append(SlotRecord(
            keys=keys, slot_offsets=np.arange(num_slots + 1, dtype=np.int32),
            dense=rng.normal(size=2).astype(np.float32),
            label=float(i % 3 == 0), ins_id=f"ins_{i:05d}"))
    ds = InMemoryDataset(desc)
    ds.records = recs
    table = EmbeddingTable(mf_dim=4, capacity=1 << 10,
                           cfg=SparseSGDConfig(), unique_bucket_min=512,
                           device="cpu")
    torch.manual_seed(0)
    tr = Trainer(DeepFM(num_slots, 7, 2, hidden=(16,)), table, desc,
                 device="cpu")
    return tr, ds


def test_dump_writer_lines(tmp_path):
    cfg = DumpConfig(str(tmp_path / "dump"), fields=["pred", "label"])
    w = DumpWriter(cfg)
    w.add_batch(["a", "b"], {"pred": torch.tensor([0.25, 0.5]),
                             "label": np.array([1.0, 0.0])}, 2)
    w.add_batch(None, {"pred": np.array([0.75]),
                       "label": np.array([1.0])}, 1)
    assert w.close() == 3
    [f] = glob.glob(str(tmp_path / "dump.part-*"))
    lines = open(f).read().strip().split("\n")
    assert lines[0] == "a\tpred:0.25\tlabel:1"
    assert lines[2].startswith("2\tpred:0.75")  # auto id when no ins_id


def test_trainer_dump_pass(tmp_path):
    tr, ds = make_trainer()
    tr.set_dump(DumpConfig(str(tmp_path / "day1/preds"),
                           fields=["pred", "label", "clk"]))
    tr.train_pass(ds)
    [f] = glob.glob(str(tmp_path / "day1/preds.part-*"))
    lines = open(f).read().strip().split("\n")
    assert len(lines) == len(ds.records)
    first = lines[0].split("\t")
    assert first[0] == "ins_00000"
    kv = dict(p.split(":") for p in first[1:])
    assert set(kv) == {"pred", "label", "clk"}
    assert 0.0 <= float(kv["pred"]) <= 1.0
    tr.set_dump(None)
    tr.train_pass(ds)
    assert len(glob.glob(str(tmp_path / "day1/preds.part-*"))) == 1


def test_dump_param(tmp_path):
    tr, _ = make_trainer(n=64)
    path = str(tmp_path / "params.npz")
    n = tr.dump_param(path)
    blob = np.load(path)
    sd = tr.model.state_dict()
    assert n == len(sd) == len(blob.files) > 0
    for name, t in sd.items():
        np.testing.assert_array_equal(blob[name], t.numpy())
