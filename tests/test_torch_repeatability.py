"""The port's CPU training repeats bit for bit between processes at the
host's full thread count, with torch's deterministic algorithms off.

Each row sum of the training step on the CPU (the expand's backward that
merges key grads into unique rows, the push merge, the plain pools) goes
through ``device.index_sum_``, which adds each row's terms in key order.
ATen's accumulating ``index_put_`` on the CPU adds through atomics in
thread order above its 32 768-element grain unless
``torch.use_deterministic_algorithms(True)``: two processes training the
same batches with it differed from the first backward on (the expand's
backward of a 26-slot batch of 4096 records, [532 201, 11] key grads into
[524 288, 11] rows, was the first op to differ).
"""

import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

# two batches of 2048 records over 26 ragged slots (~20K keys a batch,
# 11 pooled floats a key: well past the 32 768-element grain), a DeepFM
# trained on the CPU with torch's default thread count (at least 4)
SCRIPT = r"""
import numpy as np, torch
torch.set_num_threads(max(4, torch.get_num_threads()))
assert not torch.are_deterministic_algorithms_enabled()
from paddlebox_tpu_torch import DeepFM, EmbeddingTable, InMemoryDataset, Trainer
from paddlebox_tpu_torch.data import DataFeedDesc, SlotDef, SlotRecord
from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
from paddlebox_tpu_torch.train.checkpoint import state_digest

S, VOCAB, B, N = 26, 2000, 2048, 4096
rng = np.random.default_rng(7)
counts = 1 + rng.poisson(3.0, size=(N, S))
offs = np.zeros((N, S + 1), np.int32)
np.cumsum(counts, axis=1, out=offs[:, 1:])
base = np.repeat(np.tile(np.arange(S, dtype=np.uint64) * np.uint64(VOCAB),
                         N), counts.reshape(-1))
keys = rng.integers(0, VOCAB, size=int(counts.sum())).astype(np.uint64) + base
starts = np.concatenate([[0], np.cumsum(offs[:, -1])[:-1]])
dense = rng.normal(size=(N, 13)).astype(np.float32)
labels = (rng.random(N) < 0.25).astype(np.float32)
slots = ([SlotDef("label", "float", 1), SlotDef("dense", "float", 13)]
         + [SlotDef(f"C{i}", "uint64") for i in range(S)])
desc = DataFeedDesc(slots=slots, batch_size=B, label_slot="label")
ds = InMemoryDataset(desc)
ds.records = [SlotRecord(keys=keys[starts[i]:starts[i] + offs[i, -1]],
                         slot_offsets=offs[i], dense=dense[i],
                         label=float(labels[i]), show=1.0,
                         clk=float(labels[i])) for i in range(N)]
torch.manual_seed(3)
table = EmbeddingTable(mf_dim=8, capacity=1 << 17, device="cpu",
                       cfg=SparseSGDConfig(mf_create_thresholds=0.0,
                                           mf_initial_range=0.0))
trainer = Trainer(DeepFM(S, 11, 13, hidden=(64, 32)), table, desc,
                  device="cpu")
trainer.train_pass(ds)
print(state_digest(trainer))
"""


def test_cpu_training_repeats_between_processes():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", SCRIPT], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    digests = [out.strip().splitlines()[-1] for out, _ in outs]
    assert digests[0] == digests[1]


def test_op_digest_finds_the_first_differing_op():
    """``tools/op_trace``: the digest logs every float output in order,
    equal for equal runs; one changed input shows at its first op."""
    from paddlebox_tpu_torch.tools.op_trace import OpDigest, first_difference

    def run(x):
        with OpDigest() as d:
            y = torch.zeros(4, 3).index_add_(0, torch.tensor([0, 1, 0]), x)
            (y * 2).sum()
        return d.log

    x = torch.arange(9, dtype=torch.float32).reshape(3, 3)
    a, b = run(x), run(x.clone())
    assert len(a) >= 3 and first_difference(a, b) is None
    x2 = x.clone()
    x2[2, 2] += 1
    i = first_difference(a, run(x2))
    assert i is not None and "index_add" in a[i][0]
