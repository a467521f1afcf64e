"""The port's pass pipeline (``train/device_pass.py`` ``PassPreloader``,
``PassPipeline``, ``poll_preload_abort``; ``ps/epilogue.py``'s hang
deadline) and ``Trainer.train_passes_resident``, on the CPU: the
reference's cases of ``tests/test_device_pass.py`` and
``tests/test_streaming.py``, and the multi-pass run against the JAX
``Trainer``.

Tolerances: port against port (depths, the pipeline against the
preloader, a resumed run against an uninterrupted one, the resident
metric feed against ``train_pass``'s) is bit for bit, by
``state_digest`` or exact messages: depth changes only when a pass is
built, never what it computes, and every step takes its lazy-mf
generator from the global step at training time. These run with one
CPU thread, where the accumulating ``index_put_`` sums in key order.
Against the JAX trainer: rows by key and dense params within the ragged
train-state class, rtol 2e-4 / atol 2e-5, and the metric messages'
AUCs within the same rtol.
"""

import dataclasses
import logging
import threading
import time
import types

import numpy as np
import pytest
import torch

from paddlebox_tpu.resilience import preemption as jpreemption

from paddlebox_tpu_torch.config import flags_scope
from paddlebox_tpu_torch.ps.epilogue import (PipelineHangError,
                                             wait_with_deadline)
from paddlebox_tpu_torch.resilience import preemption
from paddlebox_tpu_torch.resilience.preemption import PreemptedError
from paddlebox_tpu_torch.train import (CheckpointManager, PassPipeline,
                                       PassPreloader, PreloadBuildAborted,
                                       ResidentPass, state_digest)
from paddlebox_tpu_torch.utils.dump import DumpConfig

from torch_resident_data import (STATE_RTOL, arrays, assert_state_close,
                                 jax_dataset, jax_state, jax_trainer,
                                 params0, port_dataset, port_state,
                                 port_trainer)

METRICS = (("auc", "auc", {}),
           ("cmatch_rank", "cmatch_rank_auc",
            {"cmatch_rank_group": "222:1,223:2"}))


@pytest.fixture(autouse=True)
def one_thread_and_clean_stop():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    preemption.clear_stop()
    jpreemption.clear_stop()
    yield
    preemption.clear_stop()
    jpreemption.clear_stop()
    torch.set_num_threads(threads)


def _passes(n, seed=40, columnar=False):
    """``n`` datasets of 3 batches each, their records drawn apart."""
    return [port_dataset(arrays(n=3 * 64 - 5, seed=seed + i),
                         columnar=columnar) for i in range(n)]


def _run(depth, n=4, **kw):
    tr = port_trainer(params0())
    res = tr.train_passes_resident(_passes(n), depth=depth, **kw)
    assert len(res) == n
    return tr, state_digest(tr), res


def test_depths_agree_bit_for_bit():
    """The depth-2 pipeline, depth 1 and the manual depth 0 give the same
    state digest, losses and AUCs over 4 passes."""
    runs = {d: _run(d) for d in (0, 1, 2)}
    assert runs[0][1] == runs[1][1] == runs[2][1]
    for d in (1, 2):
        for a, b in zip(runs[0][2], runs[d][2]):
            assert a["last_loss"] == b["last_loss"] and a["auc"] == b["auc"]
    assert runs[2][0].global_step == 4 * 3


@pytest.mark.parametrize("floats", ["q8", torch.bfloat16],
                         ids=["q8", "bf16"])
def test_float_wire_depths_agree(floats):
    assert _run(2, n=3, floats_dtype=floats)[1] == _run(
        0, n=3, floats_dtype=floats)[1]


def test_compact_wire_depths_agree():
    def run(depth):
        tr = port_trainer(params0(), arena=True)
        tr.train_passes_resident(_passes(3), depth=depth, floats_dtype="q8")
        return state_digest(tr)
    assert run(2) == run(0)


def test_device_index_build_on_worker_equals_flag_off():
    """With ``use_pallas_index`` the worker's builds assign rows through
    the device key index (seeded and inserted on the worker thread): the
    digest equals the flag-off run, and the index mirrors the kv."""
    flag_off = _run(2)[1]
    with flags_scope(use_pallas_index=True):
        tr, digest, _ = _run(2)
    assert digest == flag_off
    dev = tr.table._dev_index
    assert dev is not None and not dev.degraded
    keys, rows = tr.table.index.items()
    np.testing.assert_array_equal(dev.lookup_rows(keys), rows)


def test_multi_pass_matches_jax():
    """Three resident passes through both packages' preloaders (depth 2):
    rows by key and dense params within the train-state class."""
    arrs = [arrays(n=3 * 64 - 5, seed=50 + i) for i in range(3)]
    jtr, params = jax_trainer()
    jres = jtr.train_passes_resident([jax_dataset(a) for a in arrs],
                                     depth=2)
    tr = port_trainer(params)
    res = tr.train_passes_resident([port_dataset(a) for a in arrs], depth=2)
    assert len(res) == len(jres) == 3
    assert_state_close(port_state(tr), jax_state(jtr))
    for a, b in zip(res, jres):
        np.testing.assert_allclose(a["auc"], b["auc"], rtol=STATE_RTOL)


def _fake_pass(nbytes):
    return types.SimpleNamespace(nbytes=lambda: nbytes,
                                 upload=lambda *a, **kw: None,
                                 build_stats={"front": 0.0})


def test_hbm_budget_clamp_is_monotone_and_warns(caplog):
    """A pass bigger than the budget allows clamps the depth, loudly; a
    smaller pass after it never raises the depth again."""
    mb = 1 << 20
    want = [mb // 8, mb // 2, mb // 16, mb // 16]
    sizes = iter(want)
    with flags_scope(preload_hbm_budget_mb=1):
        pre = PassPreloader(iter(range(4)), build_fn=lambda ds: _fake_pass(
            next(sizes)), depth=3, device="cpu")
    with caplog.at_level(logging.WARNING):
        pre.start_next()
        got = []
        while (rp := pre.wait()) is not None:
            got.append(rp.nbytes())
    pre.drain()
    assert got == want
    assert pre.depth_clamped and pre._effective_depth == 2
    assert sum("clamping preload depth 3 -> 2" in r.getMessage()
               for r in caplog.records) == 1


def test_hbm_budget_clamps_real_passes_to_depth_one():
    tr = port_trainer(params0())
    with flags_scope(preload_hbm_budget_mb=1 / (1 << 20)):  # one byte
        pre = PassPreloader(iter(_passes(3)), tr.table, depth=3)
    pre.start_next()
    results = []
    while (rp := pre.wait()) is not None:
        results.append(tr.train_pass_resident(rp))
    pre.drain()
    assert len(results) == 3 and pre.depth_clamped
    assert pre._effective_depth == 1


def test_build_error_mid_queue_served_in_order():
    """Passes built before a failure are served first; the failure raises
    from the wait() that would have returned its pass; later waits return
    None and no further build starts."""
    tr = port_trainer(params0())
    calls = {"n": 0}

    def build(ds):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("boom at build 2")
        return ResidentPass.build_streamed(ds, tr.table, block=False)

    pre = PassPreloader(iter(_passes(3)), build_fn=build, depth=2,
                        device="cpu")
    pre.start_next()
    assert pre.wait() is not None
    with pytest.raises(RuntimeError, match="boom at build 2"):
        pre.wait()
    assert pre.wait() is None
    assert calls["n"] == 2
    pre.drain()


class _StoppingDataset:
    """A dataset whose batch walk calls ``on_batch`` at its second batch
    (a stop arriving mid-front)."""

    def __init__(self, ds, on_batch):
        self._ds, self._on = ds, on_batch
        self.desc = ds.desc

    def batches(self):
        for i, b in enumerate(self._ds.batches()):
            if i == 1:
                self._on()
            yield b


@pytest.mark.parametrize("how", ["request_stop", "preloader_stop"])
def test_stop_aborts_a_build_between_stages(how):
    """A stop arriving while the worker walks the front aborts the build
    at its next stage poll, before any row is assigned; the pipeline ends
    and drain() joins the worker."""
    tr = port_trainer(params0())
    box = {}
    stop = ((lambda: preemption.request_stop("test")) if how ==
            "request_stop" else (lambda: box["pre"].stop()))
    pre = PassPreloader(iter([_StoppingDataset(_passes(1)[0], stop)]),
                        tr.table, depth=1)
    box["pre"] = pre
    pre.start_next()
    assert pre.wait() is None
    pre.drain(timeout=30)
    assert not pre._worker.is_alive()
    assert pre.builds == 0 and len(tr.table.index) == 0


def test_request_stop_keeps_staged_passes_and_drain_joins():
    tr = port_trainer(params0())
    pre = PassPreloader(iter(_passes(6)), tr.table, depth=1)
    try:
        pre.start_next()
        assert pre.wait() is not None
        preemption.request_stop("test")
        served = 0
        while pre.wait() is not None:   # staged passes stay consumable
            served += 1
        assert served <= 1              # depth 1: at most one staged
        pre.drain(timeout=30)
        assert not pre._worker.is_alive()
        assert pre.builds < 6
    finally:
        pre.drain()


def test_poll_is_a_no_op_on_the_main_thread():
    preemption.request_stop("test")
    from paddlebox_tpu_torch.train.device_pass import poll_preload_abort
    poll_preload_abort()                 # the main thread never aborts
    out = {}

    def worker():
        try:
            poll_preload_abort()
        except PreloadBuildAborted as e:
            out["e"] = e

    t = threading.Thread(target=worker)
    t.start()
    t.join(10)
    assert not t.is_alive() and "test" in str(out["e"])


def test_depth_zero_builds_one_pass_per_credit():
    built = []

    def build(ds):
        built.append(ds)
        return _fake_pass(10)

    pre = PassPreloader(iter(range(4)), build_fn=build, depth=0,
                        device="cpu")
    assert pre.start_next()
    assert pre.wait() is not None
    time.sleep(0.2)
    assert built == [0]                  # no free-running build
    pre.start_next()
    assert pre.wait() is not None and built == [0, 1]
    pre.drain()
    assert built == [0, 1]


def test_wait_hang_deadline_names_the_stage():
    release = threading.Event()

    def build(ds):
        release.wait(10)
        return _fake_pass(0)

    pre = PassPreloader(iter([1, 2]), build_fn=build, depth=1, device="cpu")
    pre.start_next()
    with flags_scope(pipeline_wait_timeout_sec=0.3):
        with pytest.raises(PipelineHangError, match="preload.build"):
            pre.wait()
    release.set()
    assert pre.wait() is not None        # the build completes once freed
    pre.drain()


def test_slow_but_moving_pipeline_does_not_trip():
    """Progress resets the deadline: a wait spanning four 0.15 s steps
    under a 0.4 s deadline completes, and so does a preloader whose every
    build takes 0.25 s."""
    cv = threading.Condition()
    state = {"n": 0}

    def tick():
        for _ in range(4):
            time.sleep(0.15)
            with cv:
                state["n"] += 1
                cv.notify_all()

    t = threading.Thread(target=tick)
    t.start()
    with flags_scope(pipeline_wait_timeout_sec=0.4), cv:
        wait_with_deadline(cv, done=lambda: state["n"] == 4,
                           progress=lambda: state["n"],
                           message=lambda: "hung")
    t.join(10)

    def build(ds):
        time.sleep(0.25)
        return _fake_pass(1)

    pre = PassPreloader(iter(range(3)), build_fn=build, depth=1,
                        device="cpu")
    pre.start_next()
    with flags_scope(pipeline_wait_timeout_sec=0.4):
        n = 0
        while pre.wait() is not None:
            n += 1
    pre.drain()
    assert n == 3


def test_pass_pipeline_equals_preloader():
    """``PassPipeline`` over a plain resident table is the preloader: the
    loop of its docstring gives ``train_passes_resident``'s digest
    and accounting; over a pass-window table, begin_pass before a staged
    pass raises."""
    ref = _run(2, n=3)[1]
    tr = port_trainer(params0())
    pipe = PassPipeline(_passes(3), build_fn=lambda ds: (
        ResidentPass.build_streamed(ds, tr.table, block=False)),
        trainer=tr, depth=2)
    pipe.start_next()
    while (rp := pipe.wait()) is not None:
        assert pipe.begin_pass() == 0
        pipe.start_next()
        tr.train_pass_resident(rp)
        assert pipe.end_pass() == 0
    pipe.drain()
    assert state_digest(tr) == ref
    assert pipe.builds == 3 and pipe.depth == 2 and not pipe.depth_clamped
    assert pipe.build_sec_total > 0 and pipe.wait_sec_total >= 0
    assert set(pipe.build_stage_sec) >= {"front", "dedup", "pack", "h2d"}
    window = PassPipeline([], build_fn=None, window_table=object(),
                          device="cpu")
    with pytest.raises(RuntimeError, match="no staged pass"):
        window.begin_pass()


def test_stop_between_passes_checkpoints_and_resumes_exactly(tmp_path):
    """A stop after pass 2 of 4: the pipeline drains, a boundary
    checkpoint and the resume marker are written, ``PreemptedError``
    raises; new objects restore it and train the last two passes to the
    uninterrupted run's digest."""
    ref = _run(2)[1]
    root = str(tmp_path / "ckpt")
    tr = port_trainer(params0())
    inner = tr.train_pass_resident
    done = {"n": 0}

    def stop_after_two(rp, **kw):
        out = inner(rp, **kw)
        done["n"] += 1
        if done["n"] == 2:
            preemption.request_stop("test")
        return out

    tr.train_pass_resident = stop_after_two
    with pytest.raises(PreemptedError) as ei:
        tr.train_passes_resident(_passes(4), depth=2,
                                 checkpoint=CheckpointManager(root))
    assert ei.value.checkpoint_path is not None and ei.value.step == 6
    marker = preemption.read_resume_marker(root)
    assert marker is not None and marker["step"] == 6
    preemption.clear_stop()
    tr2 = port_trainer(params0())
    assert CheckpointManager(root).restore(tr2) == 6
    tr2.train_passes_resident(_passes(4)[2:], depth=2)
    assert state_digest(tr2) == ref


def _metric_records(arrs, seed=60):
    rng = np.random.default_rng(seed)
    from paddlebox_tpu_torch.data import SlotRecord
    return [SlotRecord(k, o, d, lb, 1.0, lb, rank=int(rng.integers(1, 4)),
                       cmatch=int(rng.choice([222, 223])),
                       uid=int(rng.integers(0, 50)))
            for k, o, d, lb in arrs]


def test_resident_metric_feed_matches_train_pass_and_jax():
    """The registry fed after a resident pass (columnar side channels)
    ends with ``train_pass``'s messages exactly, and with the JAX
    resident pass's within the AUC tolerance."""
    from paddlebox_tpu.data.record import SlotRecord as JRecord
    arrs = arrays(n=3 * 64 - 5, seed=61)
    recs = _metric_records(arrs)

    def datasets(columnar):
        ds = port_dataset(arrs)
        ds.records = list(recs)
        if columnar:
            ds.columnarize()
        return ds

    jtr, params = jax_trainer()
    msgs = {}
    for mode in ("train_pass", "resident"):
        tr = port_trainer(params)
        for name, method, kw in METRICS:
            tr.metrics.init_metric(name, method, **kw)
        for _ in range(2):
            if mode == "train_pass":
                tr.train_pass(datasets(False))
            else:
                tr.train_passes_resident([datasets(True)], depth=2)
        msgs[mode] = {n: tr.metrics.get_metric_msg(n) for n, *_ in METRICS}
    assert msgs["resident"] == msgs["train_pass"]
    assert msgs["resident"]["auc"]["ins_num"] == 2 * len(arrs)
    for name, method, kw in METRICS:
        jtr.metrics.init_metric(name, method, **kw)
    for _ in range(2):
        jds = jax_dataset(arrs)
        jds.records = [dataclasses.replace(JRecord(k, o, d, lb, 1.0, lb),
                                           rank=r.rank, cmatch=r.cmatch,
                                           uid=r.uid)
                       for (k, o, d, lb), r in zip(arrs, recs)]
        jds.columnarize()
        jtr.train_pass_resident(jds)
    for name, *_ in METRICS:
        want = jtr.metrics.get_metric_msg(name)
        got = msgs["resident"][name]
        assert got["ins_num"] == want["ins_num"]
        np.testing.assert_allclose(got["auc"], want["auc"],
                                   rtol=STATE_RTOL, err_msg=name)


def test_record_front_skips_the_registry_loudly(caplog):
    tr = port_trainer(params0())
    tr.metrics.init_metric("auc", "auc")
    with caplog.at_level(logging.WARNING):
        tr.train_pass_resident(_passes(1)[0])
    assert any("columnar side channels" in r.getMessage()
               for r in caplog.records)
    assert tr.metrics.get_metric_msg("auc")["ins_num"] == 0


def test_dump_falls_back_to_train_pass_or_raises(tmp_path, caplog):
    arrs = arrays(n=3 * 64 - 5, seed=62)
    ref = port_trainer(params0())
    ref.set_dump(DumpConfig(str(tmp_path / "ref")))
    ref.train_pass(port_dataset(arrs))
    tr = port_trainer(params0())
    tr.set_dump(DumpConfig(str(tmp_path / "res")))
    with caplog.at_level(logging.WARNING):
        out = tr.train_pass_resident(port_dataset(arrs))
    assert any("falling back to train_pass" in r.getMessage()
               for r in caplog.records)
    assert out["batches"] == 3 and state_digest(tr) == state_digest(ref)
    assert tr.stage_timers.seconds.keys() >= {"prepare", "h2d", "step"}
    rp = ResidentPass.build(port_dataset(arrs), tr.table)
    with pytest.raises(ValueError, match="dump is configured"):
        tr.train_pass_resident(rp)
