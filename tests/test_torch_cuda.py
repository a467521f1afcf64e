"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU and skip without one. They import neither
jax nor the JAX package, so they run on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: the gather is exact; the pool sums in key order where the
plain ``index_add_`` uses atomics, so it holds rtol 3e-5 / atol 1e-6.
"""

import numpy as np
import pytest
import torch

from paddlebox_tpu_torch import DeepFM, ServingModel
from paddlebox_tpu_torch.convert import table_rows_from_logical
from paddlebox_tpu_torch.data import (BatchBuilder, DataFeedDesc, SlotDef,
                                      SlotRecord)
from paddlebox_tpu_torch.ops import kernels as tk

RTOL, ATOL = 3e-5, 1e-6


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ragged(rng, b=64, s=7, d=11, drop=0.05):
    n = b * s
    seg = np.repeat(np.arange(n, dtype=np.int32), rng.poisson(3.0, size=n))
    seg[rng.random(len(seg)) < drop] = -1            # drop markers
    segments = np.full(len(seg) + 300, n, np.int32)  # tail pads
    segments[:len(seg)] = seg
    values = rng.normal(size=(len(segments), d)).astype(np.float32)
    values[:, :3] = np.abs(values[:, :3]) * 4     # show/clk/conv counts
    keep = (rng.random(len(segments)) < 0.8).astype(np.float32)
    return values, segments, keep, b, s


@pytest.mark.cuda
@pytest.mark.parametrize("feat", [16, 13])   # vector and scalar paths
def test_gather_rows_exact(cuda, feat):
    rng = np.random.default_rng(feat)
    table = torch.from_numpy(
        rng.normal(size=(5001, feat)).astype(np.float32)).to(cuda)
    rows = torch.from_numpy(
        rng.integers(-2, 5100, size=3000).astype(np.int32)).to(cuda)
    got = tk.gather_rows(table, rows)
    torch.cuda.synchronize()
    assert torch.equal(got, tk.gather_rows_plain(table, rows))


@pytest.mark.cuda
@pytest.mark.parametrize("mode,offset", [(tk.CVM_NONE, 2), (tk.CVM_FULL, 2),
                                         (tk.CVM_FULL, 3), (tk.CVM_SHOW, 2),
                                         (tk.CVM_CONV, 3)])
def test_pool_cvm_matches_plain(cuda, mode, offset):
    rng = np.random.default_rng(mode)
    values, segments, keep, b, s = _ragged(rng)
    v, sg, kp = (torch.from_numpy(x).to(cuda)
                 for x in (values, segments, keep))
    got = tk.pool_cvm(v, sg, kp, b, s, mode, offset, 0, 0.25)
    ref = tk.pool_cvm_plain(v, sg, kp, b, s, mode, offset, 0, 0.25)
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_serving_on_card_matches_cpu(cuda):
    """The whole serving path on the card (both kernels launched once per
    predict) against the same ServingModel on the CPU (plain versions).
    f32 tower: only the pooling order differs."""
    rng = np.random.default_rng(0)
    S, mf, vocab, bs = 5, 4, 50, 32
    keys = np.arange(S * vocab, dtype=np.uint64)
    rows = rng.normal(size=(len(keys), 8 + mf)).astype(np.float32)
    rows[:, 0:2] = np.abs(rows[:, 0:2]) * 10
    rows[:, 7] = 1.0
    blob = table_rows_from_logical(keys, rows, mf)
    slots = [SlotDef("dense", "float", 3)] + [
        SlotDef(f"C{i}", "uint64") for i in range(S)]
    desc = DataFeedDesc(slots=slots, batch_size=bs)
    recs = []
    for _ in range(bs):
        counts = 1 + rng.poisson(2.0, size=S)
        offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
        k = (rng.integers(0, vocab + 5, size=offs[-1]).astype(np.uint64)
             + np.repeat(np.arange(S, dtype=np.uint64) * np.uint64(vocab),
                         counts))
        recs.append(SlotRecord(keys=k, slot_offsets=offs,
                               dense=rng.normal(size=3).astype(np.float32)))
    batch = BatchBuilder(desc).build(recs)
    torch.manual_seed(0)
    model = DeepFM(S, 3 + mf, 3, hidden=(16, 8), compute_dtype=torch.float32)
    preds = {}
    for dev in ("cpu", "cuda"):
        srv = ServingModel(model, desc, mf_dim=mf, capacity=1 << 12,
                           device=dev)
        srv.load_base(blob)
        srv.load_params(model.state_dict())
        before = (tk.gather_rows.launches, tk.pool_cvm.launches)
        preds[dev] = srv.predict(batch)
        after = (tk.gather_rows.launches, tk.pool_cvm.launches)
        assert [a - b for a, b in zip(after, before)] == (
            [1, 1] if dev == "cuda" else [0, 0])
    np.testing.assert_allclose(preds["cuda"], preds["cpu"], rtol=1e-5,
                               atol=1e-6)
