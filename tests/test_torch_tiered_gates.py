"""The port's tiered gate tools against the reference's scripts:
``tools/pipeline_check.py`` (the cases of ``tests/test_pipeline_check.py``),
``tools/ssd_check.py`` (the cases of ``tests/test_ssd_check.py``) and
``tools/chaos_check.py``, each with ``device="cpu"``. The pipeline and
SSD gates' host-tier digests equal the reference's on the same job (the
digest hashes keys and host fields only); the chaos scenario's
package-independent summary fields equal the reference script's at the
same seed, and its digests are compared within the port."""

import os

import jax
import numpy as np

from scripts import chaos_check as jchaos
from scripts import pipeline_check as jpipeline
from scripts import ssd_check as jssd

from paddlebox_tpu_torch.resilience import preemption
from paddlebox_tpu_torch.tools import chaos_check, pipeline_check, ssd_check
from paddlebox_tpu_torch.tools.pipeline_check import (host_tier_digest,
                                                      run_check,
                                                      run_prologue_check,
                                                      run_tiered_prologue_check)
from paddlebox_tpu_torch.tools.ssd_check import (run_overlap_check,
                                                 run_ssd_check)


# ---- the cases of tests/test_pipeline_check.py ------------------------

def test_pipeline_check_gate():
    kw = dict(passes=3, shards=4, keys_per_pass=256, capacity_per_shard=512)
    out = run_check(device="cpu", **kw)
    assert out["ok"]
    assert out["rows"] > 0
    eps = out["async_endpass"]
    assert eps["jobs_run"] >= 3
    assert eps["overlap_sec"] > 0.0
    assert eps["pending"] == 0
    want = jpipeline.run_check(**kw)
    assert (out["digest"], out["rows"]) == (want["digest"], want["rows"])


def test_prologue_gate():
    out = run_prologue_check(passes=7, train_sec=0.08,
                             build_secs=(0.02, 0.14),
                             real_passes=3, real_records=128, device="cpu")
    assert out["ok"]
    assert out["wait_drop_frac"] >= 0.5
    assert out["digest"]


def test_tiered_prologue_gate():
    """The depth-2 tiered pass pipeline (queued stages on the preloader
    worker + async capacity eviction) reproduces the sequential oracle's
    host-tier digest bit-for-bit across 2 seeded runs, and the
    steady-state begin_delta boundary stall drops ≥50% vs the
    no-overlap control. The digest equals the reference script's on
    the same job."""
    kw = dict(passes=4, keys_per_pass=256, capacity_per_shard=512,
              build_delay=0.04, train_sec=0.08)
    out = run_tiered_prologue_check(device="cpu", **kw)
    assert out["ok"]
    assert out["stall_drop_frac"] >= 0.5
    assert out["runs"] >= 4          # ≥2 seeded pipeline runs agreed
    assert out["digest"]
    assert out["digest"] == jpipeline.run_tiered_prologue_check(**kw)["digest"]


def test_host_tier_digest_is_order_insensitive():
    """The digest must hash logical content, not insertion order —
    async and sync runs may land rows in different row ids."""
    def mk(order):
        t = pipeline_check._tiered_table(2, 64, "cpu")
        for ks in order:
            f = {"show": np.ones(len(ks), np.float32),
                 "clk": np.zeros(len(ks), np.float32),
                 "delta_score": np.zeros(len(ks), np.float32),
                 "slot": np.zeros(len(ks), np.float32),
                 "embed_w": ks.astype(np.float32),
                 "embed_g2sum": np.zeros(len(ks), np.float32),
                 "embedx_w": np.zeros((len(ks), 2), np.float32),
                 "embedx_g2sum": np.zeros(len(ks), np.float32),
                 "mf_size": np.zeros(len(ks), np.float32)}
            for s in range(2):
                sel = ks % np.uint64(2) == s
                t.hosts[s].update(ks[sel], {k: v[sel]
                                            for k, v in f.items()})
        return t

    a = np.arange(1, 9, dtype=np.uint64)
    b = np.arange(9, 17, dtype=np.uint64)
    d1 = host_tier_digest(mk([a, b]))
    d2 = host_tier_digest(mk([b, a]))
    assert d1 == d2


# ---- the cases of tests/test_ssd_check.py -----------------------------

def test_ssd_check_gate():
    kw = dict(passes=5, shards=2, keys_per_set=384, host_capacity=260,
              window_cap=224)
    out = run_ssd_check(device="cpu", **kw)
    assert out["ok"]
    assert out["ssd"]["demoted_rows"] > 0
    assert out["ssd"]["promoted_rows"] > 0
    assert out["ssd"]["live_rows"] > 0   # the model genuinely exceeds RAM
    assert out["digest"]
    want = jssd.run_ssd_check(**kw)
    for k in ("digest", "rows", "ssd"):
        assert out[k] == want[k], k


def test_ssd_overlap_gate():
    out = run_overlap_check(passes=4, keys_per_set=1536,
                            host_capacity=1000, window_cap=850,
                            train_sleep=0.12, device="cpu")
    assert out["ok"]
    assert out["wait_overlap_sec"] <= 0.5 * out["wait_sync_sec"]
    assert out["promoted_rows"] > 0


def test_ssd_check_imports_the_port_pipeline_helpers():
    assert ssd_check._train_mutate is pipeline_check._train_mutate
    assert ssd_check.host_tier_digest is pipeline_check.host_tier_digest


# ---- chaos_check --------------------------------------------------------

#: the summary fields that do not depend on the package: what was
#: quarantined, restored and fired, and the row counts
_CHAOS_FIELDS = ("quarantined", "restored_step", "stream_windows",
                 "surviving_records", "fault_stats", "ssd_rows",
                 "ssd_restored_step", "artifact_read_fault_stats",
                 "ssd_demoted", "serving_reload_refusals")


def test_chaos_scenario_matches_reference(tmp_path):
    """The port's scenario twice at seed 7 (every field, digests among
    them, identical), its package-independent fields against the
    reference script's run at the same seed with as many SSD shards as
    the reference has devices."""
    shards = len(jax.devices())
    outs = []
    for run in (1, 2):
        wd = str(tmp_path / f"port{run}")
        os.makedirs(wd)
        outs.append(chaos_check.run_scenario(wd, 7, device="cpu",
                                             shards=shards))
        preemption.clear_stop()
    assert outs[0] == outs[1]
    out = outs[0]
    assert out["quarantined"] == ["criteo_part_001.txt"]
    assert out["surviving_records"] == 240
    assert out["ssd_corrupt_segment_loud"] and out["artifact_corrupt_loud"]
    assert out["elastic_timeout_named"] == ["e1"]
    wd = str(tmp_path / "jax")
    os.makedirs(wd)
    want = jchaos.run_scenario(wd, 7)
    keys = set(_CHAOS_FIELDS) | {
        k for k in want if k.endswith(("_fired", "_loud"))
        or k.startswith("elastic_")}
    assert keys <= set(out)
    for k in sorted(keys):
        assert out[k] == want[k], k
    assert out["resilience"] == want["resilience"]
