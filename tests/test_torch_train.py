"""The port's training slice against the JAX package, on the CPU.

Every port function here runs its plain kernel versions (CPU tensors);
the JAX side runs both its XLA compositions and, with the flags of
``JAX_FLAGS``, its Pallas kernels in interpret mode. Inputs come from
numpy seeds and cross as numpy.

Tolerances: gathers, the seqpool backward (a gather plus copied show/clk
values), the scatter-add, row assignment and AUC bucket counts are exact
in the reference and must match exactly. The Adagrad row math runs the
same float32 operations in another framework: rtol 1e-6. Whole training
runs hold the reference's ragged train-state class, rtol 2e-4 / atol
2e-5 (the pooling order differs, ~1e-6 per step, compounding over two
passes), and the AUC 1e-5.
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
from paddlebox_tpu.data.dataset import InMemoryDataset as JDataset
from paddlebox_tpu.data.record import SlotRecord as JRecord
from paddlebox_tpu.metrics import auc_add_batch as j_auc_add
from paddlebox_tpu.metrics import auc_compute as j_auc_compute
from paddlebox_tpu.metrics import init_auc_state as j_auc_init
from paddlebox_tpu.models import DeepFM as JDeepFM
from paddlebox_tpu.native import load_native
from paddlebox_tpu.ops import pallas_index as jpi
from paddlebox_tpu.ops import pallas_kernels as jpk
from paddlebox_tpu.ops.seqpool_cvm import fused_seqpool_cvm as j_seqpool
from paddlebox_tpu.ps import EmbeddingTable as JTable
from paddlebox_tpu.ps import SparseSGDConfig as JCfg
from paddlebox_tpu.ps import sgd as jsgd
from paddlebox_tpu.ps import table as jtable
from paddlebox_tpu.ps.kv import NativeKV
from paddlebox_tpu.train import Trainer as JTrainer

from paddlebox_tpu_torch import (DeepFM, EmbeddingTable, InMemoryDataset,
                                 Trainer, convert)
from paddlebox_tpu_torch import metrics as tmetrics
from paddlebox_tpu_torch.data import (BatchBuilder, DataFeedDesc, SlotDef,
                                      SlotRecord)
from paddlebox_tpu_torch.ops import kernels as tk
from paddlebox_tpu_torch.ops.seqpool_cvm import fused_seqpool_cvm
from paddlebox_tpu_torch.ps import sgd as tsgd
from paddlebox_tpu_torch.ps import table as ttable
from paddlebox_tpu_torch.ps.kv import PyKV

JAX_FLAGS = {"xla": {}, "pallas": {"use_pallas_gather": True,
                                   "use_pallas_seqpool": True}}
STATE_RTOL, STATE_ATOL = 2e-4, 2e-5
S, MF, DENSE, BS, CAP = 4, 4, 3, 64, 1 << 12


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def _sorted_ids(rng, k, n, drop=0.1, oob=0.05):
    """Nondecreasing in-range ids (the MXU contract) with −1 and
    out-of-range markers anywhere."""
    ids = np.sort(rng.integers(0, n, size=k)).astype(np.int32)
    ids[rng.random(k) < drop] = -1
    ids[rng.random(k) < oob] = n + 3
    return ids


@pytest.mark.parametrize("k,n,w", [(300, 40, 9), (64, 7, 3), (5, 1, 1)])
def test_segment_gather_matches_mxu_and_xla(k, n, w):
    rng = np.random.default_rng(k)
    src = rng.normal(size=(n, w)).astype(np.float32)
    ids = _sorted_ids(rng, k, n)
    got = tk.segment_gather(torch.from_numpy(src), torch.from_numpy(ids))
    mxu = np.asarray(jpk.segment_gather_mxu(jnp.asarray(src),
                                            jnp.asarray(ids)))
    np.testing.assert_array_equal(got.numpy(), mxu)
    # any id order against the XLA gather with a zero row for misses
    ids = rng.permutation(ids)
    got = tk.segment_gather(torch.from_numpy(src), torch.from_numpy(ids))
    ok = (ids >= 0) & (ids < n)
    xla = np.asarray(jnp.where(jnp.asarray(ok)[:, None],
                               jnp.asarray(src)[np.clip(ids, 0, n - 1)],
                               0.0))
    np.testing.assert_array_equal(got.numpy(), xla)


def test_segment_gather_epilogue_and_empty():
    rng = np.random.default_rng(2)
    b, s, w, ets = 3, 4, 5, 1
    n = b * s
    src = rng.normal(size=(n, w + 2)).astype(np.float32)
    head = rng.normal(size=(b, 2)).astype(np.float32)
    ids = np.array([0, 3, 5, 11, n, -1, 7, 7], np.int32)
    mask = np.array([1, 1, 0, 1, 1, 1, 1, 0], np.float32)
    # strided src: the first w columns of a wider block
    got = tk.segment_gather(torch.from_numpy(src)[:, :w],
                            torch.from_numpy(ids), torch.from_numpy(head),
                            torch.from_numpy(mask), b, s, ets).numpy()
    for i, (r, m) in enumerate(zip(ids, mask)):
        if r >= n or not m:
            np.testing.assert_array_equal(got[i], 0.0)
            continue
        # a negative id keeps its head row (JAX indexes from the end) and
        # gets zero embedx columns
        embedx = src[r, :w] if r >= 0 else np.zeros(w)
        want = np.concatenate([head[min(r // s, b - 1)], np.zeros(ets),
                               embedx])
        np.testing.assert_array_equal(got[i], want)
    empty = tk.segment_gather(torch.zeros((0, w)),
                              torch.tensor([0, -1], dtype=torch.int32))
    np.testing.assert_array_equal(empty.numpy(), np.zeros((2, w)))


# the row widths rows 1 and 13 run at: Adagrad (16), Adam and shared Adam
# (37, 23), the multi-mf classes (12, 16, 24)
ROW_WIDTHS = [12, 16, 23, 24, 37]


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("f", ROW_WIDTHS)
def test_scatter_add_update_matches_reference(f, use_pallas):
    rng = np.random.default_rng(3)
    c, u = 50, 30
    values = rng.normal(size=(c, f)).astype(np.float32)
    rows = rng.permutation(c)[:u].astype(np.int32)
    rows[[2, 9]] = -1 - np.arange(2, dtype=np.int32)   # negative: dropped
    rows[[4, 17]] = c + np.arange(2, dtype=np.int32)   # out of range
    deltas = rng.normal(size=(u, f)).astype(np.float32)
    ref = np.asarray(jpi.scatter_add_update(
        jnp.asarray(values), jnp.asarray(rows), jnp.asarray(deltas),
        use_pallas=use_pallas))
    t = torch.from_numpy(values.copy())
    out = tk.scatter_add_update(t, torch.from_numpy(rows),
                                torch.from_numpy(deltas))
    assert out is t                                  # in place
    np.testing.assert_array_equal(t.numpy(), ref)


@pytest.mark.parametrize("f", ROW_WIDTHS)
def test_gather_rows_matches_pallas_kernel(f):
    """The pull's row gather against the JAX Pallas ``gather_rows`` in
    interpret mode: ids below the sentinel row C, at it and above it (the
    unique-row bucket's pads) read the same rows. Negative ids, which
    the port also sends to the sentinel, are outside the reference's
    contract (its pads all lie above C)."""
    rng = np.random.default_rng(f)
    c, u = 40, 33
    table = rng.normal(size=(c + 1, f)).astype(np.float32)
    rows = rng.permutation(c)[:u].astype(np.int32)
    rows[[1, 8]] = c                                 # the sentinel
    rows[[3, 20, 32]] = c + 1 + np.arange(3, dtype=np.int32)
    ref = np.asarray(jpk.gather_rows(jnp.asarray(table), jnp.asarray(rows)))
    got = tk.gather_rows(torch.from_numpy(table), torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy()[[1, 3, 8, 20, 32]],
                                  np.broadcast_to(table[c], (5, f)))


# ---------------------------------------------------------------------------
# seqpool backward
# ---------------------------------------------------------------------------

def _seg_stream(rng, b, s, k_pad):
    """BatchBuilder-style ids: nondecreasing ins*S+slot for the real keys
    (with empty segments), the pad bin B*S after them."""
    n = b * s
    counts = rng.poisson(1.5, size=n)
    seg = np.repeat(np.arange(n, dtype=np.int32), counts)[:k_pad - 5]
    segments = np.full(k_pad, n, np.int32)
    segments[:len(seg)] = seg
    return segments, len(seg)


@pytest.mark.parametrize("flags", sorted(JAX_FLAGS))
@pytest.mark.parametrize("layout", ["ragged", "trivial"])
@pytest.mark.parametrize("kw", [
    dict(), dict(need_filter=True, threshold=0.9), dict(clk_filter=True),
    dict(use_cvm=False, embed_thres_size=1), dict(cvm_offset=2,
                                                   quant_ratio=64)],
    ids=["full", "filter", "show", "nocvm_ets", "quant"])
def test_seqpool_backward_matches_vjp(flags, layout, kw):
    rng = np.random.default_rng(11)
    b, s, d = 6, 5, 7
    if layout == "ragged":
        segments, nk = _seg_stream(rng, b, s, 96)
        k = len(segments)
    else:
        segments, k = None, b * s + 4        # key bucket past B*S
        nk = b * s - 3                       # a short batch
    values = rng.normal(size=(k, d)).astype(np.float32)
    values[:, :2] = rng.integers(0, 6, size=(k, 2))
    values[:, 1] = np.minimum(values[:, 1], values[:, 0])
    show_clk = rng.integers(0, 3, size=(b, 2)).astype(np.float32)
    key_valid = (np.arange(k) < nk).astype(np.float32)
    args = dict(use_cvm=True, cvm_offset=2, pad_value=0.0,
                need_filter=False, show_coeff=0.2, clk_coeff=1.0,
                threshold=0.96, quant_ratio=0, clk_filter=False)
    args.update(kw)
    ets = args.pop("embed_thres_size", 0)
    jseg = None if segments is None else jnp.asarray(segments)

    def jf(v):
        return j_seqpool(v, jseg, jnp.asarray(show_clk), b, s,
                         args["use_cvm"], args["cvm_offset"],
                         args["pad_value"], args["need_filter"],
                         args["show_coeff"], args["clk_coeff"],
                         args["threshold"], args["quant_ratio"],
                         args["clk_filter"], embed_thres_size=ets,
                         key_valid=jnp.asarray(key_valid))

    with flags_scope(**JAX_FLAGS[flags]):
        out, vjp = jax.vjp(jf, jnp.asarray(values))
        g = rng.normal(size=out.shape).astype(np.float32)
        (ref,) = vjp(jnp.asarray(g))
    v = torch.from_numpy(values).requires_grad_(True)
    got = fused_seqpool_cvm(
        v, None if segments is None else torch.from_numpy(segments),
        torch.from_numpy(show_clk), b, s, embed_thres_size=ets,
        key_valid=torch.from_numpy(key_valid), **args)
    assert tuple(got.shape) == out.shape
    got.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(v.grad.numpy(), np.asarray(ref))
    assert np.abs(v.grad.numpy()).sum() > 0


# ---------------------------------------------------------------------------
# sparse optimizer, table push, key index, AUC
# ---------------------------------------------------------------------------

def _row_state(rng, u, mf):
    show = rng.integers(0, 40, size=u).astype(np.float32)
    clk = np.floor(show * rng.random(u).astype(np.float32) * 0.5)
    cols = dict(show=show, clk=clk,
                delta_score=rng.random(u).astype(np.float32),
                embed_w=rng.normal(size=u).astype(np.float32),
                embed_g2sum=rng.random(u).astype(np.float32) * 3,
                embedx_w=rng.normal(size=(u, mf)).astype(np.float32),
                embedx_g2sum=rng.random(u).astype(np.float32) * 3,
                mf_size=(rng.random(u) < 0.5).astype(np.float32),
                opt_ext=np.zeros((u, 0), np.float32))
    return cols


def test_adagrad_update_matches_reference():
    rng = np.random.default_rng(4)
    u, mf = 200, 4
    cols = _row_state(rng, u, mf)
    g_show = rng.integers(0, 5, size=u).astype(np.float32)
    g_clk = np.minimum(g_show, rng.integers(0, 3, size=u)).astype(
        np.float32)
    g_embed = rng.normal(size=u).astype(np.float32)
    g_embedx = rng.normal(size=(u, mf)).astype(np.float32)
    touched = rng.random(u) < 0.8
    cfg = dict(mf_create_thresholds=3.0, mf_initial_range=0.5)
    key = jax.random.PRNGKey(5)
    init = np.array(jax.random.uniform(key, (u, mf), jnp.float32))
    ref = jsgd.adagrad_update(
        jsgd.RowState(**{k: jnp.asarray(v) for k, v in cols.items()}),
        jnp.asarray(g_show), jnp.asarray(g_clk), jnp.asarray(g_embed),
        jnp.asarray(g_embedx), jnp.asarray(touched), jsgd.SparseSGDConfig(
            **cfg), key)
    got = tsgd.adagrad_update(
        tsgd.RowState(**{k: torch.from_numpy(v) for k, v in cols.items()}),
        torch.from_numpy(g_show), torch.from_numpy(g_clk),
        torch.from_numpy(g_embed), torch.from_numpy(g_embedx),
        torch.from_numpy(touched), tsgd.SparseSGDConfig(**cfg),
        init=torch.from_numpy(init))
    created = (cols["mf_size"] == 0) & (np.asarray(ref.mf_size) > 0)
    assert created.any()
    for f in jsgd.RowState._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=1e-6,
                                   atol=0, err_msg=f)


@pytest.mark.parametrize("flags", sorted(JAX_FLAGS))
def test_apply_push_matches_reference(flags):
    rng = np.random.default_rng(6)
    cap, mf = 60, 4
    feat = 8 + mf
    data = np.zeros((cap + 1, feat), np.float32)
    c = _row_state(rng, cap, mf)
    for name, col in ttable.FIELD_COL.items():
        if name != "slot":
            data[:cap, col] = c[name]
    data[:cap, 8:] = c["embedx_w"]
    u = 40
    rows = np.empty(64, np.int32)
    rows[:u] = rng.permutation(cap)[:u]
    ttable.fill_oob_pads(rows, u, cap)
    grads = rng.normal(size=(64, 3 + mf)).astype(np.float32)
    grads[:, :2] = rng.integers(0, 4, size=(64, 2))
    grads[:, 1] = np.minimum(grads[:, 1], grads[:, 0])
    cfg = dict(mf_create_thresholds=2.0, mf_initial_range=0.3)
    key = jax.random.PRNGKey(9)
    init = np.array(jax.random.uniform(key, (64, mf), jnp.float32))
    with flags_scope(**JAX_FLAGS[flags]):
        ref = jtable.apply_push(
            jtable.TableState.from_logical(data, cap), jnp.asarray(rows),
            jnp.asarray(grads), JCfg(**cfg), key)
        ref = np.asarray(ref.data)
    st = ttable.TableState(torch.from_numpy(data.copy()))
    ttable.apply_push(st, torch.from_numpy(rows), torch.from_numpy(grads),
                      ttable.SparseSGDConfig(**cfg),
                      init=torch.from_numpy(init))
    got = st.data.numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    untouched = np.setdiff1d(np.arange(cap + 1), rows[:u])
    np.testing.assert_array_equal(got[untouched], data[untouched])
    np.testing.assert_array_equal(got[cap], 0.0)


def test_assign_unique_matches_native_kv():
    lib = load_native()
    assert lib is not None, "the native key index must build here"
    native, port = NativeKV(1 << 12, lib), PyKV(1 << 12)
    rng = np.random.default_rng(7)
    for _ in range(4):
        keys = rng.integers(0, 900, size=500).astype(np.uint64)
        r0, i0 = native.assign_unique(keys)
        r1, i1 = port.assign_unique(keys)
        np.testing.assert_array_equal(r1, r0)
        np.testing.assert_array_equal(i1, i0)
    k0, v0 = native.items()
    k1, v1 = port.items()
    assert dict(zip(k0.tolist(), v0.tolist())) == dict(zip(k1.tolist(),
                                                          v1.tolist()))


def test_auc_matches_reference():
    rng = np.random.default_rng(8)
    nb = 1000
    js, ts = j_auc_init(nb), tmetrics.init_auc_state(nb, device="cpu")
    for _ in range(3):
        pred = rng.random(257).astype(np.float32)
        pred[:3] = [0.0, 1.0, 0.9999999]
        label = (rng.random(257) < pred).astype(np.float32)
        w = (rng.random(257) < 0.9).astype(np.float32)
        js = j_auc_add(js, jnp.asarray(pred), jnp.asarray(label),
                       jnp.asarray(w))
        tmetrics.auc_add_batch(ts, torch.from_numpy(pred),
                               torch.from_numpy(label), torch.from_numpy(w))
    np.testing.assert_array_equal(ts.pos.numpy(), np.asarray(js.pos))
    np.testing.assert_array_equal(ts.neg.numpy(), np.asarray(js.neg))
    want = j_auc_compute(js).as_dict()
    got = tmetrics.auc_compute(ts).as_dict()
    assert got["auc"] == want["auc"]
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6)


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

def _ragged_arrays(n=256, seed=0):
    """Zipf-ragged multi-key slots (the shape of the reference's ragged
    train gate), as numpy."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        counts = np.minimum(rng.zipf(1.5, size=S), 8)
        offs = np.zeros(S + 1, np.int32)
        np.cumsum(counts, out=offs[1:])
        keys = rng.integers(0, 3000, size=int(offs[-1])).astype(np.uint64)
        out.append((keys, offs, rng.normal(size=DENSE).astype(np.float32),
                    float(i % 2)))
    return out


def _slots(cls):
    return ([cls("label", "float", 1), cls("d", "float", DENSE)]
            + [cls(f"S{i}", "uint64") for i in range(S)])


def _descs():
    return (JDesc(slots=_slots(JSlotDef), label_slot="label",
                  batch_size=BS, key_bucket_min=512),
            DataFeedDesc(slots=_slots(SlotDef), label_slot="label",
                         batch_size=BS, key_bucket_min=512))


CFG = dict(mf_create_thresholds=0.0, mf_initial_range=0.0,
           learning_rate=0.05, mf_learning_rate=0.05)


def test_prepare_matches_reference():
    arrs = _ragged_arrays(n=200, seed=1)
    jdesc, tdesc = _descs()
    jt = JTable(mf_dim=MF, capacity=CAP, cfg=JCfg(**CFG),
                unique_bucket_min=512)
    tt = EmbeddingTable(mf_dim=MF, capacity=CAP,
                        cfg=ttable.SparseSGDConfig(**CFG),
                        unique_bucket_min=512, device="cpu")
    for i in range(0, len(arrs), BS):
        part = arrs[i:i + BS]
        jb = JBuilder(jdesc).build([JRecord(k, o, d, l, 1.0, l)
                                    for k, o, d, l in part])
        tb = BatchBuilder(tdesc).build([SlotRecord(k, o, d, l, 1.0, l)
                                        for k, o, d, l in part])
        ji, ti = jt.prepare(jb), tt.prepare(tb)
        np.testing.assert_array_equal(ti.unique_rows, ji.unique_rows)
        np.testing.assert_array_equal(ti.gather_idx, ji.gather_idx)
        assert ti.num_unique == ji.num_unique
    np.testing.assert_array_equal(tt.slot_host, jt.slot_host)
    np.testing.assert_array_equal(tt._touched, jt._touched)


def _jax_logical(tr):
    tr.sync_table()
    keys, rows = tr.table.index.items()
    order = np.argsort(keys)
    return keys[order], rows[order], tr.table._gather_host(rows[order])


def _port_logical(table):
    keys, rows = table.index.items()
    order = np.argsort(keys)
    return keys[order], rows[order], table._gather_host(rows[order])


@pytest.mark.parametrize("flags", sorted(JAX_FLAGS))
def test_two_pass_training_matches_jax_trainer(flags, tmp_path):
    arrs = _ragged_arrays()
    jdesc, tdesc = _descs()
    with flags_scope(**JAX_FLAGS[flags]):
        jt = JTable(mf_dim=MF, capacity=CAP, cfg=JCfg(**CFG),
                    unique_bucket_min=512)
        jtr = JTrainer(JDeepFM(hidden=(16, 8), compute_dtype=jnp.float32),
                       jt, jdesc, tx=optax.adam(1e-2), seed=3)
        params0 = jax.device_get(jtr.state.params)
        jds = JDataset(jdesc)
        jds.records = [JRecord(k, o, d, l, 1.0, l) for k, o, d, l in arrs]
        jres = [jtr.train_pass(jds) for _ in range(2)]
        jkeys, jrows, jblob = _jax_logical(jtr)
        jparams = convert.deepfm_state_dict_from_flax(
            jax.device_get(jtr.state.params))

    model = DeepFM(S, 3 + MF, DENSE, hidden=(16, 8),
                   compute_dtype=torch.float32)
    model.load_state_dict(convert.deepfm_state_dict_from_flax(params0))
    tt = EmbeddingTable(mf_dim=MF, capacity=CAP,
                        cfg=ttable.SparseSGDConfig(**CFG),
                        unique_bucket_min=512, device="cpu")
    tr = Trainer(model, tt, tdesc,
                 tx=lambda p: torch.optim.Adam(p, lr=1e-2, eps=1e-8),
                 seed=3, check_nan_inf=True, device="cpu")
    ds = InMemoryDataset(tdesc)
    ds.records = [SlotRecord(k, o, d, l, 1.0, l) for k, o, d, l in arrs]
    tres = [tr.train_pass(ds) for _ in range(2)]

    tkeys, trows, tblob = _port_logical(tt)
    np.testing.assert_array_equal(tkeys, jkeys)
    np.testing.assert_array_equal(trows, jrows)
    for f in sorted(jblob):
        np.testing.assert_allclose(tblob[f], jblob[f], rtol=STATE_RTOL,
                                   atol=STATE_ATOL, err_msg=f)
    assert (tblob["mf_size"] > 0).any()
    sd = tr.model.state_dict()
    for name, want in jparams.items():
        np.testing.assert_allclose(sd[name].numpy(), want.numpy(),
                                   rtol=STATE_RTOL, atol=STATE_ATOL,
                                   err_msg=name)
    for j, t in zip(jres, tres):
        assert t["batches"] == j["batches"] and t["examples"] == j["examples"]
        np.testing.assert_allclose(t["auc"], j["auc"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(t["last_loss"], j["last_loss"],
                                   rtol=STATE_RTOL)
    np.testing.assert_array_equal(tt.state.data.numpy()[CAP], 0.0)

    # the port's save_base loads into the JAX table row for row
    path = str(tmp_path / "base.npz")
    assert tt.save_base(path) == len(tkeys)
    back = JTable(mf_dim=MF, capacity=CAP, cfg=JCfg(**CFG))
    assert back.load(path) == len(tkeys)
    bkeys, brows = back.index.items()
    order = np.argsort(bkeys)
    bblob = back._gather_host(brows[order])
    np.testing.assert_array_equal(bkeys[order], tkeys)
    for f in sorted(tblob):
        np.testing.assert_array_equal(bblob[f], tblob[f], err_msg=f)


def test_eval_pass_and_delta_save(tmp_path):
    """eval_pass reads and never assigns; save_delta holds exactly the
    rows trained since the last clearing save."""
    arrs = _ragged_arrays(n=128, seed=2)
    _, tdesc = _descs()
    tt = EmbeddingTable(mf_dim=MF, capacity=CAP,
                        cfg=ttable.SparseSGDConfig(**CFG),
                        unique_bucket_min=512, device="cpu")
    torch.manual_seed(0)
    tr = Trainer(DeepFM(S, 3 + MF, DENSE, hidden=(16, 8)), tt, tdesc,
                 device="cpu")
    ds = InMemoryDataset(tdesc)
    ds.records = [SlotRecord(k, o, d, l, 1.0, l) for k, o, d, l in arrs]
    out = tr.train_pass(ds)
    assert out["batches"] == 2 and np.isfinite(out["last_loss"])
    n_rows = len(tt.index)
    tt.save_base(str(tmp_path / "base.npz"))
    before = tt.state.data.clone()
    ev = tr.eval_pass(ds)
    assert ev["batches"] == 2 and len(tt.index) == n_rows
    assert torch.equal(tt.state.data, before)
    # second pass on new records: the delta is what it touched
    ds.records = [SlotRecord(k + np.uint64(5000), o, d, l, 1.0, l)
                  for k, o, d, l in arrs[:BS]]
    tr.train_pass(ds)
    delta = tmp_path / "delta.npz"
    n_delta = tt.save_delta(str(delta))
    with np.load(delta) as f:
        assert set(f["keys"].tolist()) == {
            int(x) + 5000 for keys, *_ in arrs[:BS] for x in keys}
    assert n_delta == len(tt.index) - n_rows
    assert tt.save_delta(str(delta)) == 0
