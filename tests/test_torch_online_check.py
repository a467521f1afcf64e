"""The port's online-daemon soak gate (``tools/online_check.py``), wired as
the reference wires ``scripts/online_check.py`` in
``tests/test_online_check.py``: the daemon composition (train, boundary
publish, serving adoption, shrink cycles) holds its plateau invariants
over a reduced horizon, the chaos legs (corrupt delta, shrink-seam
faults) recover through the daemon's own supervision, and real-signal
subprocess round trips of ``tools/onlinelearn`` resume bit-consistently
with an unkilled oracle. Everything runs with ``device="cpu"``. No
wall-clock bound is held: serving staleness is held in versions behind
the tip, and the tool prints its seconds. The full 12-window horizon runs
under the ``slow`` marker."""

import os
import subprocess
import sys

import pytest
import torch

from paddlebox_tpu_torch.resilience import preemption
from paddlebox_tpu_torch.tools.online_check import (
    _run_corrupt_delta_leg, _run_kill_leg, _run_shrink_chaos_leg,
    _run_soak_leg, _run_tiered_lifecycle_leg)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_thread_and_clean_stop():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    preemption.clear_stop()
    yield
    preemption.clear_stop()
    preemption.uninstall_signal_handlers()
    torch.set_num_threads(threads)


def test_soak_leg_plateaus_and_is_deterministic(tmp_path):
    """Reduced-horizon soak: 18 windows (6 shrink cycles) of the
    in-process daemon — resident keys, cursor bytes, RSS (to 0.1 MB) and
    staleness in versions plateau, every served lookup bit-matches a
    published version's replay oracle, and the whole outcome is
    seed-deterministic x2. The reference's case runs 9 windows; the
    port's RSS can still rise 0.1 MB a window through a 9-window run's
    last third on a loaded host, so the horizon is doubled rather than
    the resolution coarsened."""
    windows = 18
    outs = []
    for run in (1, 2):
        wd = str(tmp_path / f"run{run}")
        os.makedirs(wd)
        outs.append(_run_soak_leg(wd, seed=7, windows=windows,
                                  device="cpu"))
    sig = outs[0]["sig"]
    assert sig["windows"] == windows
    assert sig["shrink_cycles"] == windows // 3
    assert sig["shrunk_rows_total"] >= 0
    assert len(sig["versions"]) == windows
    # the plateau is the leg's own assertion; re-state the headline:
    # the last third of the live-row series is flat
    live = sig["live_rows"]
    third = windows // 3
    assert max(live[-third:]) <= max(live[:-third]) * 1.05
    assert outs[0]["queries"] > 0
    assert outs[0]["sig"] == outs[1]["sig"]
    for key in ("staleness_sec", "rss_mb"):
        print(f"soak {key} per window:",
              [s[key] for s in outs[0]["samples"]])


def test_tiered_lifecycle_leg_deterministic(tmp_path):
    """Reduced-horizon tiered aging: PassScopedTable → HostStore →
    SsdTier with the async epilogue on — live rows plateau, hot keys
    survive every cycle, and the outcome is deterministic x2."""
    outs = []
    for run in (1, 2):
        wd = str(tmp_path / f"run{run}")
        os.makedirs(wd)
        outs.append(_run_tiered_lifecycle_leg(wd, seed=7, windows=9,
                                              device="cpu"))
    assert outs[0]["shrunk_total"] > 0
    assert outs[0] == outs[1]


def test_corrupt_delta_recovers_via_forced_base(tmp_path):
    """A flipped-byte delta in the publish feed: the daemon's reload
    loop refuses it loudly and keeps serving; the next shrink cycle's
    forced BASE publish is adopted and staleness returns to zero."""
    out = _run_corrupt_delta_leg(str(tmp_path), seed=7, device="cpu")
    assert out["ok"]
    assert out["recovered_version"] != out["refused_version"]
    assert out["refused_version"] in out["versions"]
    assert out["queries"] > 0


def test_shrink_chaos_retries_then_skips_loudly(tmp_path):
    """The ``online.shrink`` fault seam: a transient failure retries on
    the seeded policy (cycle completes); a hard failure skips the cycle
    loudly (counter + flight-recorder bundle) without stalling."""
    out = _run_shrink_chaos_leg(str(tmp_path), seed=7, device="cpu")
    assert out["transient"]["cycles"] == 3
    assert out["transient"]["skipped"] == 0
    assert out["hard"]["skipped"] == 1
    assert out["hard"]["cycles"] == 2
    for sub in ("transient", "hard"):
        assert out[sub]["fault"]["online.shrink:fail"]["fired"] >= 1


def test_sigterm_roundtrip_replays_open_window(tmp_path):
    """Real SIGTERM on a real ``tools/onlinelearn`` process: exit 75 +
    resume marker + mid-window cursor; the relaunch replays the open
    window at-least-once and bit-matches the unkilled oracle at the
    last common window boundary."""
    out = _run_kill_leg(str(tmp_path), seed=7, signame="TERM",
                        device="cpu")
    assert out["ok"] and out["rc"] == 75
    assert out["open_window"]
    assert out["replayed_files"] == len(out["open_window"])
    assert out["boundary_digest"]


def test_sigkill_roundtrip_matches_oracle_exactly(tmp_path):
    """Real SIGKILL: no marker, resume from the last clean boundary —
    the drained daemon's final state bit-matches the unkilled oracle
    EXACTLY (nothing mid-window survived to replay)."""
    out = _run_kill_leg(str(tmp_path), seed=7, signame="KILL",
                        device="cpu")
    assert out["ok"] and out["rc"] == -9
    assert out["open_window"] == []
    assert out["replayed_files"] == 0
    assert out["common_boundary"] == out["final_step"]


@pytest.mark.slow
def test_online_check_full_gate(tmp_path):
    """The full 12-window gate, exactly as released: soak x2 + tiered x2
    + corrupt delta + shrink chaos + both kill legs."""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-m", "paddlebox_tpu_torch.tools.online_check",
         "--device", "cpu", "--workdir", str(tmp_path)],
        capture_output=True, text=True, timeout=1800, env=env)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "PASS" in r.stdout
