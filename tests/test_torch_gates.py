"""The port's single-process gate tools against the reference's scripts:
``tools/stream_check.py``, ``tools/preempt_check.py``,
``tools/publish_check.py`` and ``tools/serve_check.py``, each run with
``device="cpu"`` and held to the asserts of the reference's tier-1 wiring
(``tests/test_stream_check.py``, ``test_publish_check.py``,
``test_serve_check.py``; ``scripts/preempt_check.py`` has no test of its
own, so its case holds the script's own asserts). Each tool's
package-independent summary fields must equal the JAX script's on the
same seed: windows, replayed files, fault stats, chain lengths and the
indices of the adopted versions. Digests differ between the packages
(dense params live in different containers) and are compared only
within the port."""

import os

import pytest
import torch

from paddlebox_tpu.resilience import preemption as jpreemption
from scripts import preempt_check as jpreempt
from scripts import publish_check as jpublish
from scripts import serve_check as jserve
from scripts import stream_check as jstream

from paddlebox_tpu_torch.resilience import preemption
from paddlebox_tpu_torch.tools import (preempt_check, publish_check,
                                       serve_check, stream_check)


@pytest.fixture(autouse=True)
def clean_stop():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for m in (preemption, jpreemption):
        m.clear_stop()
    yield
    for m in (preemption, jpreemption):
        m.clear_stop()
        m.uninstall_signal_handlers()
    torch.set_num_threads(threads)


def _run(fn, tmp_path, name, **kw):
    wd = str(tmp_path / name)
    os.makedirs(wd)
    return fn(wd, **kw)


def test_stream_check_gate(tmp_path):
    out = _run(stream_check.run_scenario, tmp_path, "port", seed=7,
               preempt_at=8, device="cpu")
    FILES, WINDOW = stream_check.FILES, stream_check.WINDOW
    assert out["ok"]
    assert out["oracle_windows"] == FILES // WINDOW
    # the kill landed mid-window-2: one window completed, one open
    assert len(out["completed_at_kill"]) == WINDOW
    assert len(out["open_window"]) == WINDOW
    assert out["replayed_files"] == WINDOW
    assert out["resumed_windows"] == FILES // WINDOW - 1
    assert out["events"]["stream_replay"] >= 1
    assert out["fault_stats"]["preempt.signal:fail"]["fired"] == 1
    # the same seed through the reference script
    assert (FILES, WINDOW, stream_check.ROWS, stream_check.BS) == (
        jstream.FILES, jstream.WINDOW, jstream.ROWS, jstream.BS)
    want = _run(jstream.run_scenario, tmp_path, "jax", seed=7, preempt_at=8)
    for k in ("oracle_windows", "completed_at_kill", "open_window",
              "resumed_windows", "replayed_files", "last_common_boundary",
              "fault_stats", "events"):
        assert out[k] == want[k], k


def test_preempt_check_gate(tmp_path):
    """The script's own asserts (resume from the cursor equals the
    uninterrupted run by ``state_digest``, the marker consumed, the
    telemetry events), twice with the same seed, against the reference
    script's counts."""
    outs = [_run(preempt_check.run_scenario, tmp_path, f"port{r}", seed=7,
                 preempt_at=4, device="cpu") for r in (1, 2)]
    out = outs[0]
    assert out["digest_match"]
    assert out["preempted_at"] == 4
    assert out["replayed_batches"] == out["total_batches"] - 4
    assert out["fault_stats"]["preempt.signal:fail"]["fired"] == 1
    assert out["events"]["preempt_requested"] >= 1
    assert out["events"]["emergency_checkpoint"] == 1
    assert out["events"]["cursor_resume"] >= 1
    assert outs[0] == outs[1]
    want = _run(jpreempt.run_scenario, tmp_path, "jax", seed=7,
                preempt_at=4)
    for k in ("total_batches", "preempted_at", "replayed_batches",
              "digest_match", "fault_stats", "events"):
        assert out[k] == want[k], k


def test_publish_check_gate_deterministic(tmp_path):
    outs = [_run(publish_check.run_publish_check, tmp_path, f"port{r}",
                 seed=7, device="cpu") for r in (1, 2)]
    out = outs[0]
    assert out["ok"]
    # every scenario left the reader on a complete, verified version
    assert out["crash_reader_aid"] == out["chain"][1]
    assert out["corrupt_fallback_aid"] == out["chain"][1]
    assert out["final_aid"] == out["chain"][-1]
    assert out["crash_fault"]["artifact.publish:fail"]["fired"] == 1
    # a held lease deferred the sweep; release reclaimed the versions
    assert out["removed_while_leased"] == []
    assert out["removed_after_release"] == out["chain"][:3]
    assert out["counters"]["refused_corrupt"] >= 1
    # the artifact's spill-manifest reference names the tier state
    assert out["tiered"]["spill_digest"]
    # seeded chaos is reproducible: outcome byte-identical across runs
    assert outs[0] == outs[1]
    want = _run(jpublish.run_publish_check, tmp_path, "jax", seed=7)
    for k in ("chain", "crash_fault", "crash_reader_aid",
              "corrupt_fallback_aid", "removed_while_leased",
              "removed_after_release", "final_aid", "counters"):
        assert out[k] == want[k], k
    assert out["tiered"]["aid"] == want["tiered"]["aid"]
    assert out["tiered"]["rows"] == want["tiered"]["rows"]


def test_serve_check_gate_deterministic(tmp_path):
    """The reference's asserts but its two host-clock bounds: the query
    p99 and the largest staleness are printed here, never held (the
    standalone tool holds them)."""
    outs, timings = [], []
    for r in (1, 2):
        t = {}
        outs.append(_run(serve_check.run_serve_check, tmp_path, f"port{r}",
                         seed=7, device="cpu", timings=t))
        timings.append(t)
    print(f"serve_check timings (host clock, CPU): {timings}")
    out = outs[0]
    # stream leg: 1 base + >=3 deltas published while serving answered;
    # served results matched exactly one version's oracle
    assert out["stream_kinds"].count("base") == 1
    assert out["stream_kinds"].count("delta") >= 3
    assert out["stream_served_all_consistent"]
    assert out["stream_preds_consistent"]
    assert out["stream_final_aid"] == out["stream_versions"][-1]
    # every published version answers a DISTINCT lookup digest — the
    # consistency check cannot pass vacuously
    oracle = out["stream_lookup_oracle"]
    assert len(set(oracle.values())) == len(oracle)
    # /readyz: refused before the first adoption, passed after
    assert out["readyz_transition"] == [False, True]
    # tiered leg: SSD-spilled rows served bit-exactly across >=2 swaps
    assert out["tiered_consistent"] and out["tiered_swaps_observed"]
    assert out["tiered_writer_digest"] == out["tiered_replay_digest"]
    assert out["tiered_spill_digest"]
    # chaos legs
    assert out["corrupt_degraded_loud"] and out["corrupt_recovered"]
    assert out["corrupt_served_prior"] and out["corrupt_consistent"]
    assert out["kill_carcass_swept"] and out["kill_serving_unaffected"]
    assert out["kill_consistent"]
    assert out["reload_adopted_nonzero"]
    assert out["reload_degraded_nonzero"]
    # seeded chaos is reproducible: outcome byte-identical across runs
    assert outs[0] == outs[1]
    want = _run(jserve.run_serve_check, tmp_path, "jax", seed=7)
    for k in ("stream_versions", "stream_kinds", "stream_final_aid",
              "readyz_transition", "tiered_chain", "corrupt_chain",
              "corrupt_recovered", "kill_base", "kill_next_adopted",
              "reload_adopted_nonzero", "reload_degraded_nonzero"):
        assert out[k] == want[k], k
    for k in ("stream_lookup_oracle", "tiered_oracle", "corrupt_oracle",
              "kill_oracle"):
        assert sorted(out[k]) == sorted(want[k]), k
    assert len(out["stream_pred_oracle"]) == len(want["stream_pred_oracle"])
