"""The port's multi-process gates on the CPU, each beside the reference's
own gate on the same job:

- ``tools/elastic_check`` (``scripts/elastic_check.py``): the window
  schedule ``[4, 4, 3, 3, 4, 4, 4, 3]``, a lossless re-import at every
  re-shard, two seeded runs with the same outcome, and every
  package-independent field of the outcome (the world and step of each
  window, each re-shard's worlds, agreed step and hosts, the dataset
  order, the watchdog's eviction, the restart pointer, the SIGKILL leg)
  equal to the JAX gate's at the reference test's size (96 rows a
  window);
- ``tools/scaling_check``'s digest half (``scripts/scaling_check.py``
  check 1): ``a2a_chunks=2`` equals 1 bit for bit, as the JAX gate's
  does on the same job;
- ``examples/train_multihost.py``: two workers through the port's
  launcher, the TCP shuffle and the host collective; each rank's loaded
  and post-shuffle records and features equal the reference example's,
  and the global AUC is one value on both ranks.
"""

import importlib.util
import json
import os
import subprocess
import sys

import pytest

from paddlebox_tpu_torch.examples import train_multihost as t_example
from paddlebox_tpu_torch.tools import elastic_check as t_elastic
from paddlebox_tpu_torch.tools import scaling_check as t_scaling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 96


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    """Two seeded port runs and the reference gate's run."""
    root = tmp_path_factory.mktemp("elastic")
    port = [t_elastic.run_scenario(str(root / f"port{i}"), seed=7,
                                   rows=ROWS, device="cpu")
            for i in range(2)]
    j = _load("j_elastic_check", os.path.join("scripts", "elastic_check.py"))
    ref = j.run_scenario(str(root / "jax"), seed=7, rows=ROWS)
    return port, ref


def _independent(outcome):
    """The fields of an outcome that do not depend on the package (the
    digests are each package's own hash)."""
    wins = []
    for w in outcome["windows"]:
        c = {"window": w["window"], "np": w["np"], "step": w["step"]}
        if "reshard" in w:
            c["reshard"] = {k: w["reshard"][k] for k in
                            ("old_np", "new_np", "agreed_step", "lost",
                             "joined")}
        wins.append(c)
    keep = ("world_schedule", "oracle_prefix_match", "schedule_oracle_match",
            "dataset_order", "reshard_count", "kv_fault_fired",
            "rendezvous_fault_fired", "restart_pointer_pass",
            "sigkill_lost", "sigkill_survivors", "sigkill_hysteresis_held")
    out = {k: outcome[k] for k in keep}
    out["watchdog_evicted"] = [list(x) for x in outcome["watchdog_evicted"]]
    out["windows"] = wins
    return out


def test_elastic_world_follows_the_schedule(elastic):
    port, _ = elastic
    assert port[0]["ok"]
    assert port[0]["world_schedule"] == t_elastic.WORLD_SCHEDULE == \
        [4, 4, 3, 3, 4, 4, 4, 3]
    assert port[0]["reshard_count"] == len(t_elastic.RESHARD_AT)


def test_elastic_reshards_are_lossless(elastic):
    port, _ = elastic
    by_window = {r["window"]: r for r in port[0]["windows"]}
    for widx, (old_np, new_np) in t_elastic.RESHARD_AT.items():
        rs = by_window[widx]["reshard"]
        assert (rs["old_np"], rs["new_np"]) == (old_np, new_np)
        assert rs["digest_after"] == by_window[widx]["digest"]
        assert rs["agreed_step"] == by_window[widx]["step"]
    quiet = set(range(t_elastic.NUM_WINDOWS)) - set(t_elastic.RESHARD_AT)
    assert all("reshard" not in by_window[w] for w in quiet)


def test_elastic_two_seeded_runs_match(elastic):
    port, _ = elastic
    assert port[0] == port[1]


def test_elastic_outcome_equals_the_reference_gates(elastic):
    port, ref = elastic
    assert ref["ok"]
    assert _independent(port[0]) == _independent(ref)


def test_scaling_check_chunked_digest_equals_monolithic():
    got = t_scaling.parity_check(rows_per_file=400, device="cpu")
    assert got["ok"], got
    assert got["chunked"] == {2: got["batches"]}
    j = _load("j_scaling_check", os.path.join("scripts", "scaling_check.py"))
    assert j.parity_check(rows_per_file=400) is True


def test_train_multihost_example_matches_the_reference(tmp_path):
    data = str(tmp_path / "data")
    args = ["--rows", "600", "--passes", "2", "--batch-size", "64",
            "--data", data]
    out = tmp_path / "port"
    assert t_example.main(args + ["--device", "cpu", "--out",
                                  str(out)]) == 0
    port = [json.loads((out / f"rank{r}.json").read_text())
            for r in range(2)]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    env.pop("XLA_FLAGS", None)
    cp = subprocess.run([sys.executable,
                         os.path.join(REPO, "examples", "train_multihost.py")]
                        + args, env=env, capture_output=True, text=True,
                        timeout=300)
    assert cp.returncode == 0, cp.stderr[-2000:]
    ref = sorted((json.loads(line) for line in cp.stdout.splitlines()
                  if line.startswith("{")), key=lambda r: r["rank"])
    assert len(ref) == 2
    for p, j in zip(port, ref):
        for k in ("rank", "loaded", "after_shuffle", "features"):
            assert p[k] == j[k], k
    assert port[0]["global_auc"] == port[1]["global_auc"]
    assert sum(p["after_shuffle"] for p in port) == 600
