"""The port's serving slice against the JAX package: DeepFM with params
carried across by ``convert.py``, and ``ServingModel`` loading the
``.npz`` files a JAX ``Trainer``'s table wrote, predicting on ragged
batches (the non-trivial pool path) with both JAX flag settings.

Tolerances: at float32 the dense net differs only in summation order, so
DeepFM holds rtol 1e-5, and the whole forward holds the serving gate of
``tests/test_serving.py`` (rtol 1e-4 / atol 1e-5). The bf16 tower rounds
its inputs, weights and every layer's output to 8 mantissa bits, and the
two frameworks may round at different points (XLA rounds the product and
then adds the bias in bf16; torch's addmm may round once), so the bf16
logits hold atol 2e-2: a few one-step bf16 rounding flips (2^-8 relative)
of hidden activations, not a drift of the math.
"""

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from paddlebox_tpu.config import flags_scope
from paddlebox_tpu.data import DataFeedDesc as JDesc
from paddlebox_tpu.data import SlotDef as JSlotDef
from paddlebox_tpu.data.batch import BatchBuilder as JBuilder
from paddlebox_tpu.data.dataset import InMemoryDataset
from paddlebox_tpu.data.record import SlotRecord as JRecord
from paddlebox_tpu.models import DeepFM as JDeepFM
from paddlebox_tpu.ps import EmbeddingTable as JTable
from paddlebox_tpu.ps import SparseSGDConfig as JCfg
from paddlebox_tpu.serving import ServingModel as JServing
from paddlebox_tpu.train import Trainer

from paddlebox_tpu_torch import DeepFM, ServingModel
from paddlebox_tpu_torch import convert
from paddlebox_tpu_torch.data import (BatchBuilder, DataFeedDesc, SlotDef,
                                      SlotRecord)

S, MF, DENSE, BS, HIDDEN, CAP = 4, 4, 13, 64, (32, 16), 1 << 12
JAX_FLAGS = {"xla": {}, "pallas": {"use_pallas_gather": True,
                                   "use_pallas_seqpool": True}}


def _arrays(n, vocab, seed, avg=3.0):
    """Ragged records as numpy: per-(record, slot) key counts
    1 + Poisson(avg - 1), slot-qualified keys."""
    rng = np.random.default_rng(seed)
    counts = 1 + rng.poisson(avg - 1.0, size=(n, S))
    out = []
    for i in range(n):
        offs = np.zeros(S + 1, np.int32)
        np.cumsum(counts[i], out=offs[1:])
        slot = np.repeat(np.arange(S), counts[i]).astype(np.uint64)
        keys = (rng.integers(0, vocab, size=offs[-1]).astype(np.uint64)
                + slot * np.uint64(1000) + np.uint64(1))
        label = float(rng.random() < 0.3)
        out.append((keys, offs, rng.normal(size=DENSE).astype(np.float32),
                    label))
    return out


def _jrecords(arrs):
    return [JRecord(keys=k, slot_offsets=o, dense=d, label=l, show=1.0,
                    clk=l) for k, o, d, l in arrs]


def _trecords(arrs):
    return [SlotRecord(keys=k, slot_offsets=o, dense=d, label=l, show=1.0,
                       clk=l) for k, o, d, l in arrs]


def _slots(slot_cls):
    return ([slot_cls("label", "float", 1), slot_cls("dense", "float", DENSE)]
            + [slot_cls(f"C{i}", "uint64") for i in range(S)])


JDESC = JDesc(slots=_slots(JSlotDef), batch_size=BS, label_slot="label")
TDESC = DataFeedDesc(slots=_slots(SlotDef), batch_size=BS,
                     label_slot="label")


def _port_model(compute_dtype=torch.float32):
    return DeepFM(num_slots=S, slot_width=3 + MF, dense_dim=DENSE,
                  hidden=HIDDEN, compute_dtype=compute_dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deepfm_matches_flax(dtype):
    rng = np.random.default_rng(0)
    pooled = rng.normal(size=(BS, S, 3 + MF)).astype(np.float32)
    dense = rng.normal(size=(BS, DENSE)).astype(np.float32)
    jm = JDeepFM(hidden=HIDDEN, compute_dtype=getattr(jnp, dtype))
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(pooled),
                     jnp.asarray(dense))
    ref = np.asarray(jm.apply(params, jnp.asarray(pooled),
                              jnp.asarray(dense)))
    tm = _port_model(getattr(torch, dtype))
    tm.load_state_dict(convert.deepfm_state_dict_from_flax(
        jax.device_get(params)))
    with torch.no_grad():
        got = tm(torch.from_numpy(pooled), torch.from_numpy(dense)).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-2)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A small JAX DeepFM trained one pass on ragged records; its table
    saved as a base, trained again and saved as a delta."""
    tmp = tmp_path_factory.mktemp("torch_serving")
    cfg = JCfg(mf_create_thresholds=0.0, mf_initial_range=1e-2)
    table = JTable(mf_dim=MF, capacity=CAP, cfg=cfg)
    tr = Trainer(JDeepFM(hidden=HIDDEN, compute_dtype=jnp.float32), table,
                 JDESC, tx=optax.adam(1e-2))
    ds = InMemoryDataset(JDESC)
    ds.records = _jrecords(_arrays(4 * BS, vocab=40, seed=1))
    tr.train_pass(ds)
    tr.sync_table()
    base = str(tmp / "base.npz")
    table.save_base(base)
    ds.records = _jrecords(_arrays(2 * BS, vocab=50, seed=2))
    tr.train_pass(ds)
    tr.sync_table()
    delta = str(tmp / "delta.npz")
    table.save_delta(delta)
    params = jax.device_get(tr.state.params)
    return base, delta, params


def _port_server(trained):
    base, delta, params = trained
    srv = ServingModel(_port_model(), TDESC, mf_dim=MF, capacity=CAP,
                       device="cpu")
    assert srv.load_base(base) > 0
    assert srv.apply_delta(delta) > 0
    srv.load_params(convert.deepfm_state_dict_from_flax(params))
    return srv


def _jax_server(trained):
    base, delta, params = trained
    srv = JServing(JDeepFM(hidden=HIDDEN, compute_dtype=jnp.float32), JDESC,
                   mf_dim=MF, capacity=CAP)
    srv.params = params
    srv.load_base(base)
    srv.apply_delta(delta)
    return srv


@pytest.mark.parametrize("flags", sorted(JAX_FLAGS))
def test_predict_matches_jax_serving(trained, flags):
    # vocab 60 > the trained 50: some keys are unknown and read zeros
    arrs = _arrays(BS + 20, vocab=60, seed=7)
    port = _port_server(trained)
    with flags_scope(**JAX_FLAGS[flags], serving_batch_max=24):
        jsrv = _jax_server(trained)
        jb = JBuilder(JDESC).build(_jrecords(arrs[:BS]))
        ref, ref_valid = jsrv.predict(jb, return_valid=True)
        ref_many = jsrv.predict_many(_jrecords(arrs))
    tb = BatchBuilder(TDESC).build(_trecords(arrs[:BS]))
    assert not tb.segments_trivial          # the ragged pool path
    got, valid = port.predict(tb, return_valid=True)
    assert got.shape == (BS,)
    np.testing.assert_array_equal(valid, ref_valid)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    many = port.predict_many(_trecords(arrs), batch_max=24)
    assert many.shape == (len(arrs),)
    np.testing.assert_allclose(many, ref_many, rtol=1e-4, atol=1e-5)
    # pre-batched traffic takes the same path
    np.testing.assert_allclose(port.predict_many([tb]), got, rtol=0,
                               atol=0)


def test_embed_lookup_and_digest_exact(trained):
    port = _port_server(trained)
    jsrv = _jax_server(trained)
    keys, _ = jsrv.table.index.items()
    probe = np.concatenate([keys[:50], np.array([0xDEADBEEF, 999], np.uint64),
                            keys[:3]])
    got = port.embed_lookup(probe)
    np.testing.assert_array_equal(got, jsrv.embed_lookup(probe))
    np.testing.assert_array_equal(got[50:52], 0.0)   # unknown → zeros
    assert np.abs(got[:50]).sum() > 0
    assert port.snapshot().digest() == jsrv.snapshot().digest()


def test_table_handed_over_in_memory(trained):
    """convert.table_rows_from_logical: the logical rows of the JAX table
    load without a file and serve the same rows."""
    jsrv = _jax_server(trained)
    keys, rows = jsrv.table.index.items()
    logical = np.asarray(jax.device_get(jsrv.table.state.data))[rows]
    blob = convert.table_rows_from_logical(keys, logical, MF)
    port = ServingModel(_port_model(), TDESC, mf_dim=MF, capacity=CAP,
                        device="cpu")
    assert port.load_base(blob) == len(keys)
    np.testing.assert_array_equal(port.embed_lookup(keys),
                                  jsrv.embed_lookup(keys))


def test_snapshot_survives_reload(trained):
    """Copy-on-publish: a pinned snapshot keeps answering from the state
    it captured after the loader moves on."""
    base, delta, _ = trained
    port = _port_server(trained)
    pinned = port.snapshot()
    keys, _ = pinned.table.index.items()
    before = pinned.lookup(keys)
    port.load_base(base)          # drops the delta rows
    assert port.snapshot() is not pinned
    np.testing.assert_array_equal(pinned.lookup(keys), before)
