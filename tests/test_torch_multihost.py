"""The multi-process sharded trainer (``train/multihost.py``, ``ShardedTrainer
(pod=)``) on the CPU: two rank processes over gloo, started by the port's
``launch_local``, each owning 2 of 4 shards (``tests/torch_pod_worker.py``).

Held against the port's single-controller ``ShardedTrainer`` over the
same 4 shards and batches bit for bit (each shard's logical rows, the
dense params, every step's loss, the AUC tables, the snapshot, the
per-rank dumps, the per-process save set and a restore from it), and
against the JAX single-process ``ShardedTrainer`` on 4 CPU devices
within the ragged train-state class (rtol 2e-4 / atol 2e-5, AUC 1e-5),
as ``tests/test_torch_sharded.py`` holds the single controller. Lazy mf
creation draws zeros (``mf_initial_range`` 0). Every run is on one CPU
thread, the parent's reference too. Also the reference's
``tests/test_elastic.py`` load cases: a save re-split into a foreign
shard count, and partial per-process files.
"""

import os

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from paddlebox_tpu.config import flags_scope as j_flags_scope
from paddlebox_tpu.models import DeepFM as JDeepFM
from paddlebox_tpu.parallel import make_mesh
from paddlebox_tpu.ps import SparseSGDConfig as JCfg
from paddlebox_tpu.ps.sharded import ShardedEmbeddingTable as JSharded
from paddlebox_tpu.ps.table import FIELDS, TWO_D_FIELDS
from paddlebox_tpu.train.sharded import ShardedTrainer as JShardedTrainer

from paddlebox_tpu_torch import convert
from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
from paddlebox_tpu_torch.ps.sharded import ShardedEmbeddingTable

from test_torch_sharded import (BS, CAP, CFG, DENSE, MF, S, STATE_ATOL,
                                STATE_RTOL, TABLE_KW, _arrays, _base_blob,
                                _datasets, _descs, _jax_logical, _jax_table)
from torch_pod_worker import launch_pod, run_trainer

N = 4
HIDDEN = (16, 16)
CONFIGS = {"mono": dict(chunks=1, zero1=False),
           "zero1": dict(chunks=1, zero1=True),
           "chunked": dict(chunks=2, zero1=False),
           "resident": dict(chunks=1, zero1=False, resident=True)}
JAX_CONFIGS = ("mono", "zero1")


def _train_arrays():
    # 11 local batches (the last one short): 3 global steps at N = 4, the
    # tail group padded with a dead copy
    return _arrays(BS * 10 + 7, seed=23)


@pytest.fixture(scope="module")
def start(tmp_path_factory):
    """The JAX trainer's initial params and the seeded base (both
    packages start from them), and the JAX runs per config: after two
    train passes and an eval pass, logical rows, params and results."""
    jds, _ = _datasets(_train_arrays())
    jdesc, _ = _descs()
    base = str(tmp_path_factory.mktemp("base") / "base.npz")
    blob = _base_blob(seed=5)
    np.savez(base, **blob)
    mesh = make_mesh(N)
    out = {"jax": {}}
    for name in JAX_CONFIGS:
        c = CONFIGS[name]
        table = _jax_table(N)
        table.load(base)
        with j_flags_scope(a2a_chunks=c["chunks"]):
            tr = JShardedTrainer(JDeepFM(hidden=HIDDEN,
                                         compute_dtype=jnp.float32),
                                 table, jdesc, mesh, tx=optax.adam(1e-2),
                                 seed=3, zero1=c["zero1"])
            if "params" not in out:
                out["params"] = convert.deepfm_state_dict_from_flax(
                    jax.device_get(tr.state.params))
            res = [tr.train_pass(jds) for _ in range(2)]
        ev = tr.eval_pass(jds)
        keys, rows = _jax_logical(table)
        out["jax"][name] = dict(
            res=res, eval=ev, keys=keys, rows=rows,
            params=convert.deepfm_state_dict_from_flax(
                jax.device_get(tr.state.params)))
    out["table"] = blob
    return out


def _cfg(start, name):
    c = CONFIGS[name]
    return dict(shards=N, mf=MF, cap=CAP, sgd=CFG, table_kw=TABLE_KW,
                slots=S, dense=DENSE, batch=BS, hidden=HIDDEN,
                chunks=c["chunks"], zero1=c["zero1"],
                resident=c.get("resident", False),
                table=start["table"], params=start["params"],
                arrays=_train_arrays())


@pytest.fixture(scope="module")
def single(start, tmp_path_factory):
    """The port's single-controller runs, one CPU thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        for name in CONFIGS:
            dump = str(tmp_path_factory.mktemp(f"single_{name}"))
            out[name] = run_trainer(_cfg(start, name), dump_dir=dump)
            out[name]["dump_dir"] = dump
    finally:
        torch.set_num_threads(threads)
    return out


@pytest.fixture(scope="module")
def pod(start, tmp_path_factory):
    """The two-rank runs (gloo, CPU), per config."""
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for name in CONFIGS:
            cfg = dict(_cfg(start, name), dump=name == "mono")
            work = tmp_path_factory.mktemp(f"pod_{name}")
            out[name] = launch_pod("train", cfg, work, mp)
            out[name + "_work"] = str(work)
    finally:
        mp.undo()
    return out


def _tensors_equal(a, b, what=""):
    if torch.is_tensor(b):
        assert torch.equal(a, b), what
    elif isinstance(b, dict):
        assert set(a) == set(b), what
        for k in b:
            _tensors_equal(a[k], b[k], f"{what}/{k}")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _tensors_equal(x, y, f"{what}/{i}")
    else:
        assert a == b, what


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_two_ranks_equal_the_single_controller(name, single, pod):
    """Rows of every shard (from its owner), params, every step's loss,
    the passes' results, the eval AUC, the registry AUC and the dense
    snapshot (model, optimizer, AUC tables) equal bit for bit."""
    want, ranks = single[name], pod[name]
    assert [r["owned"] for r in ranks] == [[0, 1], [2, 3]]
    assert all(r["backend"] == "gloo" for r in ranks)
    for r in ranks:
        for s in r["owned"]:
            np.testing.assert_array_equal(r["rows"][s][0],
                                          want["rows"][s][0])
            np.testing.assert_array_equal(r["rows"][s][1],
                                          want["rows"][s][1],
                                          err_msg=f"shard {s}")
        _tensors_equal(r["params"], want["params"], "params")
        assert r["losses"] == want["losses"]
        assert len(r["losses"]) == 6
        for got, w in zip(r["res"], want["res"]):
            for k in ("auc", "last_loss", "batches", "examples",
                      "chunked_batches", "ins_num", "actual_ctr"):
                assert got[k] == w[k], k
        if name == "resident":
            # the resident pass trained what train_pass trains
            _tensors_equal(r["params"], single["mono"]["params"], "params")
        assert r["eval"]["auc"] == want["eval"]["auc"]
        _tensors_equal(r["snapshot"], want["snapshot"], "snapshot")
        assert r["registry"]["auc"] == want["registry"]["auc"]
        assert r["nbytes"]["exchanged"] > 0
        assert r["nbytes"]["staged"] == 0        # gloo on the CPU


@pytest.mark.parametrize("name", JAX_CONFIGS)
def test_two_ranks_match_jax(name, start, pod):
    """The pod's rows (both ranks' shards as one keyed list), params and
    AUCs within the ragged train class of the JAX single process."""
    j, ranks = start["jax"][name], pod[name]
    keys = np.concatenate([r["rows"][s][0] for r in ranks
                           for s in r["owned"]])
    rows = np.concatenate([r["rows"][s][1] for r in ranks
                           for s in r["owned"]])
    order = np.argsort(keys)
    np.testing.assert_array_equal(keys[order], j["keys"])
    np.testing.assert_allclose(rows[order], j["rows"], rtol=STATE_RTOL,
                               atol=STATE_ATOL)
    for k, v in j["params"].items():
        np.testing.assert_allclose(ranks[0]["params"][k].numpy(), v.numpy(),
                                   rtol=STATE_RTOL, atol=STATE_ATOL,
                                   err_msg=k)
    for jr, tr in zip(j["res"], ranks[0]["res"]):
        assert tr["ins_num"] == jr["ins_num"]
        np.testing.assert_allclose(tr["auc"], jr["auc"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(tr["last_loss"], jr["last_loss"],
                                   rtol=STATE_RTOL)
    np.testing.assert_allclose(ranks[0]["eval"]["auc"], j["eval"]["auc"],
                               rtol=0, atol=1e-5)


def test_rank_dumps_concatenate_to_the_single_controllers(single, pod):
    """Each rank writes its destinations' ``.part-<d>`` files; in rank
    order they are the single controller's files, line for line."""
    work = pod["mono_work"]
    parts = sorted(f for f in os.listdir(os.path.join(work, "train_out",
                                                      "dump"))
                   if f.startswith("dump.part-"))
    want = sorted(f for f in os.listdir(single["mono"]["dump_dir"])
                  if f.startswith("dump.part-"))
    assert parts == want == [f"dump.part-{d:05d}" for d in range(N)]
    for f in parts:
        with open(os.path.join(work, "train_out", "dump", f)) as a, \
                open(os.path.join(single["mono"]["dump_dir"], f)) as b:
            assert a.read().splitlines() == b.read().splitlines()


@pytest.mark.parametrize("name", ["mono", "zero1"])
def test_save_set_restores_on_the_pod_and_anywhere(name, single, pod):
    """Each rank saved its owned shards; a fresh pod trainer restored
    from the whole set and the snapshot holds the same rows and dense
    snapshot (``globalize_dense_state(check=True)`` agreed), and the set
    loads into one controller at 4 and at 3 shards with the same
    logical rows."""
    ranks = pod[name]
    for r in ranks:
        _tensors_equal(r["restored_snapshot"], r["snapshot"], "restored")
        for s in r["owned"]:
            np.testing.assert_array_equal(r["restored_rows"][s],
                                          r["rows"][s][1])
    paths = [os.path.join(pod[name + "_work"], "train_out",
                          f"base_r{r}.npz") for r in range(2)]
    assert sum(r["saved"] for r in ranks) == sum(
        len(v[0]) for v in single[name]["rows"].values())
    want = _logical(single[name]["rows"].values())
    for n in (N, 3):
        t = ShardedEmbeddingTable(n, mf_dim=MF, capacity_per_shard=CAP,
                                  cfg=SparseSGDConfig(**CFG), devices="cpu",
                                  **TABLE_KW)
        t.load(paths)
        got = _logical(
            (t.indexes[s].items()[0], t._rows_host(s, t.indexes[s].items()[1]))
            for s in range(n))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def _logical(pairs):
    pairs = list(pairs)
    keys = np.concatenate([k for k, _ in pairs])
    rows = np.concatenate([r for _, r in pairs])
    order = np.argsort(keys)
    return keys[order], rows[order]


# ---- the reference's tests/test_elastic.py load cases --------------------

def _synth_blob(keys, mf=4):
    """A single-table save of ``keys`` with key-derived values."""
    base = keys.astype(np.float32)
    blob = {"keys": keys}
    for f in FIELDS:
        blob[f] = (np.tile(base[:, None], (1, mf)) * 0.01
                   if f in TWO_D_FIELDS else base * 0.001)
    return blob


def _port_rows(t):
    return _logical((t.indexes[s].items()[0],
                     t._rows_host(s, t.indexes[s].items()[1]))
                    for s in range(t.n))


def test_sharded_load_resplits_foreign_shard_count(tmp_path):
    """An n=4 save re-imports into an n=3 table losslessly via the key%N
    re-split — as the JAX table does the same file."""
    keys = np.arange(1, 201, dtype=np.uint64)
    src = str(tmp_path / "src.npz")
    np.savez(src, **_synth_blob(keys))
    cfg = dict(mf_create_thresholds=0.0, mf_initial_range=0.0)

    def mk(n):
        return ShardedEmbeddingTable(n, mf_dim=4, capacity_per_shard=512,
                                     cfg=SparseSGDConfig(**cfg),
                                     devices="cpu", req_bucket_min=64,
                                     serve_bucket_min=64)
    t4 = mk(4)
    assert t4.load(src) == len(keys)
    saved = str(tmp_path / "n4.npz")
    t4.save_base(saved)
    t3 = mk(3)
    assert t3.load(saved) == len(keys)
    k4, r4 = _port_rows(t4)
    k3, r3 = _port_rows(t3)
    np.testing.assert_array_equal(k3, k4)
    np.testing.assert_array_equal(r3, r4)
    j3 = JSharded(3, mf_dim=4, capacity_per_shard=512, cfg=JCfg(**cfg),
                  req_bucket_min=64, serve_bucket_min=64)
    assert j3.load(saved) == len(keys)
    jk, jr = _jax_logical(j3)
    np.testing.assert_array_equal(jk, k3)
    np.testing.assert_array_equal(jr[:, :r3.shape[1]], r3)


def test_file_per_shard_tolerates_partial_files(tmp_path):
    """A per-process save holds only SOME shards; the re-split
    concatenates what is present."""
    cfg = SparseSGDConfig(mf_create_thresholds=0.0, mf_initial_range=0.0)
    blobs = {}
    for s, ks in ((0, np.array([4, 8], np.uint64)),
                  (2, np.array([2, 6], np.uint64))):
        one = _synth_blob(ks)
        blobs[f"keys_{s}"] = ks
        for f in FIELDS:
            blobs[f"{f}_{s}"] = one[f]
    partial = str(tmp_path / "partial.npz")
    np.savez(partial, n=4, **blobs)
    t2 = ShardedEmbeddingTable(2, mf_dim=4, capacity_per_shard=256, cfg=cfg,
                               devices="cpu", req_bucket_min=64,
                               serve_bucket_min=64)
    assert t2.load(partial) == 4
    assert sorted(_port_rows(t2)[0].tolist()) == [2, 4, 6, 8]
