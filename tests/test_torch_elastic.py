"""The port's elastic membership layer and network KV store
(``paddlebox_tpu_torch/distributed/elastic.py``, ``kv_server.py``)
against the reference's: the cases of ``tests/test_elastic.py`` that
need no multi-process trainer (lifecycle, hysteresis, eviction, key
escaping, touch-not-rewrite heartbeats, rendezvous diagnostics, the
consensus participants, the watchdog shrink-and-continue rung, the
membership timeline of ``tools/telemetry_report``), the store cases of
``tests/test_distributed_launch.py``, and a port client against a
reference ``KVServer`` and the reverse (the wire protocol is the same).
``launch_local`` and the re-shard cases wait for the multi-process
trainer (ROADMAP queue 1 item 13, slice 3b). Every server binds port
0."""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from paddlebox_tpu.distributed import kv_server as jkv

from paddlebox_tpu_torch.distributed import (ElasticLevel, ElasticManager,
                                             FileKVStore, KVServer,
                                             TcpKVStore)

REPO = os.path.join(os.path.dirname(__file__), os.pardir)


def _age(store: FileKVStore, key: str, by_sec: float) -> None:
    old = time.time() - by_sec
    os.utime(store._path(key), (old, old))


def _lease(store: FileKVStore, job: str, host: str) -> str:
    key = f"paddlebox/{job}/nodes/{host}"
    store.put(key, json.dumps({"host": host}).encode())
    return key


# ---- FileKVStore hardening ------------------------------------------------

def test_key_escaping_roundtrips_hostile_names(tmp_path):
    """Percent-encoding is reversible: hosts containing the old ``__``
    separator (or slashes) survive list_prefix intact."""
    store = FileKVStore(str(tmp_path))
    for host in ("plain", "tpu__pod__3", "rack/7"):
        store.put(f"paddlebox/j/nodes/{host}", b"x")
    got = sorted(store.list_prefix("paddlebox/j/nodes"))
    assert got == sorted(f"paddlebox/j/nodes/{h}"
                         for h in ("plain", "tpu__pod__3", "rack/7"))
    # membership parsing takes the key's last path segment, so only
    # slash-free hosts (every real hostname) appear under their own name
    store.delete("paddlebox/j/nodes/rack/7")
    mgr = ElasticManager(store, "j", "plain", 2, ttl=60.0)
    assert mgr.alive_hosts() == ["plain", "tpu__pod__3"]


def test_touch_refreshes_without_rewriting_payload(tmp_path):
    store = FileKVStore(str(tmp_path))
    store.put("k", b"payload-v1")
    _age(store, "k", 120.0)
    assert store.touch("k") is True
    assert time.time() - store.mtime("k") < 60.0
    assert store.get("k") == b"payload-v1"  # touch never rewrites bytes
    assert store.touch("missing") is False


def test_list_prefix_skips_inflight_tmp_files(tmp_path):
    store = FileKVStore(str(tmp_path))
    store.put("paddlebox/j/nodes/a", b"x")
    with open(os.path.join(str(tmp_path),
                           store._escape("paddlebox/j/nodes/b")
                           + ".tmp.123"), "wb") as fh:
        fh.write(b"torn")
    assert list(store.list_prefix("paddlebox/j/nodes")) == \
        ["paddlebox/j/nodes/a"]


# ---- lifecycle + hysteresis ----------------------------------------------

def test_heartbeat_keeps_lease_fresh_and_deregister_stops(tmp_path):
    store = FileKVStore(str(tmp_path))
    mgr = ElasticManager(store, "j", "h0", 1, ttl=0.6,
                         heartbeat_period=0.1)
    mgr.register(payload={"slot": 3})
    key = "paddlebox/j/nodes/h0"
    assert json.loads(store.get(key))["slot"] == 3
    time.sleep(0.9)  # > TTL: only the heartbeat keeps it alive
    assert mgr.alive_hosts() == ["h0"]
    mgr.deregister()
    assert store.get(key) is None
    assert not mgr._hb_thread


def test_dead_checks_hysteresis_absorbs_one_missed_poll(tmp_path):
    """A single aged lease must NOT fire a scale event at dead_checks=2;
    a recovery resets the count; two consecutive misses confirm the
    death."""
    store = FileKVStore(str(tmp_path))
    for h in ("h0", "h1"):
        _lease(store, "j", h)
    mgr = ElasticManager(store, "j", "h0", 2, ttl=30.0, dead_checks=2)
    assert mgr.scale_event() is None        # baseline {h0, h1}
    key1 = "paddlebox/j/nodes/h1"
    _age(store, key1, 120.0)
    assert mgr.scale_event() is None        # miss 1: absorbed
    store.touch(key1)
    assert mgr.scale_event() is None        # recovered: count reset
    _age(store, key1, 120.0)
    assert mgr.scale_event() is None        # miss 1 again (fresh count)
    assert mgr.scale_event() == ["h0"]      # miss 2: confirmed dead
    assert mgr.last_event["lost"] == ["h1"]
    # rejoin is admitted on the FIRST poll that sees it
    store.touch(key1)
    assert mgr.scale_event() == ["h0", "h1"]
    assert mgr.last_event["joined"] == ["h1"]


def test_evict_host_bypasses_hysteresis_and_stops_heartbeat(tmp_path):
    store = FileKVStore(str(tmp_path))
    victim = ElasticManager(store, "j", "h1", 2, ttl=30.0,
                            heartbeat_period=0.05)
    victim.register()
    observer = ElasticManager(store, "j", "h0", 2, ttl=30.0,
                              dead_checks=3)
    _lease(store, "j", "h0")
    assert observer.scale_event() is None   # baseline {h0, h1}
    observer.evict_host("h1", "wedged")
    # lease deleted -> the victim's next beat sees it gone and stops
    # WITHOUT resurrecting the lease
    deadline = time.time() + 5.0
    while victim._hb_thread.is_alive() and time.time() < deadline:
        time.sleep(0.05)
    assert not victim._hb_thread.is_alive(), \
        "evicted heartbeat thread kept running"
    assert store.get("paddlebox/j/nodes/h1") is None, \
        "evicted lease was resurrected by the heartbeat"
    # forced-dead bypasses dead_checks=3: confirmed on the next poll
    assert observer.scale_event() == ["h0"]
    assert observer.last_event["lost"] == ["h1"]


@pytest.mark.parametrize("observer", ["port", "jax"],
                         ids=["port-evicts-jax", "jax-evicts-port"])
def test_managers_of_both_packages_share_a_file_store(tmp_path, observer):
    """A reference ``ElasticManager`` and a port one over one
    ``FileKVStore`` directory: each sees the other's lease, the
    other's checkpoint pointer reads the same, and the observer's
    eviction stops the victim's heartbeat without resurrecting its
    lease and is confirmed on the next poll."""
    from paddlebox_tpu.distributed import elastic as jel
    pkgs = {"port": (ElasticManager, FileKVStore),
            "jax": (jel.ElasticManager, jel.FileKVStore)}
    om, ostore = pkgs[observer]
    vm, vstore = pkgs["jax" if observer == "port" else "port"]
    victim = vm(vstore(str(tmp_path)), "mix", "h1", 2, ttl=30.0,
                heartbeat_period=0.05)
    obs = om(ostore(str(tmp_path)), "mix", "h0", 2, ttl=30.0,
             dead_checks=3, heartbeat_period=0.05)
    victim.register()
    obs.register()
    try:
        assert obs.wait_for_np(timeout=10) == ["h0", "h1"]
        assert victim.wait_for_np(timeout=10) == ["h0", "h1"]
        victim.publish_checkpoint("/ckpt/victim", pass_id=7)
        assert obs.latest_checkpoint() == victim.latest_checkpoint()
        assert obs.latest_checkpoint()["pass_id"] == 7
        assert obs.scale_event() is None      # baseline {h0, h1}
        obs.evict_host("h1", "wedged")
        deadline = time.time() + 5.0
        while victim._hb_thread.is_alive() and time.time() < deadline:
            time.sleep(0.05)
        assert not victim._hb_thread.is_alive()
        assert vstore(str(tmp_path)).get("paddlebox/mix/nodes/h1") is None
        assert obs.scale_event() == ["h0"]
        assert obs.last_event["lost"] == ["h1"]
        assert victim.alive_hosts() == ["h0"]
    finally:
        obs.deregister()
        victim.deregister()


def test_wait_for_np_timeout_names_missing_hosts(tmp_path):
    store = FileKVStore(str(tmp_path))
    for h in ("h0", "h1"):
        _lease(store, "j", h)
    mgr = ElasticManager(store, "j", "h0", 2, ttl=30.0,
                         heartbeat_period=0.05)
    assert mgr.scale_event() is None        # members = {h0, h1}
    store.delete("paddlebox/j/nodes/h1")
    with pytest.raises(TimeoutError) as ei:
        mgr.wait_for_np(timeout=0.3)
    assert "h1" in str(ei.value), str(ei.value)


def test_fault_tolerance_vs_elastic_world_ok(tmp_path):
    store = FileKVStore(str(tmp_path))
    for h in ("h0", "h1", "h2"):
        _lease(store, "j", h)
    ft = ElasticManager(store, "j", "h0", 3, ttl=30.0)
    assert ft.level == ElasticLevel.FAULT_TOLERANCE
    el = ElasticManager(store, "j", "h0", 3, min_np=2, max_np=3,
                        ttl=30.0)
    assert el.level == ElasticLevel.ELASTIC
    assert ft.world_ok() and el.world_ok()
    store.delete("paddlebox/j/nodes/h2")
    assert not ft.world_ok()   # fixed np: 2 != 3
    assert el.world_ok()       # floats in [2, 3]
    store.delete("paddlebox/j/nodes/h1")
    assert not el.world_ok()   # below min_np


def test_checkpoint_pointer_roundtrip_and_status(tmp_path):
    store = FileKVStore(str(tmp_path))
    mgr = ElasticManager(store, "j", "h0", 2, min_np=1, max_np=2,
                         ttl=30.0)
    assert mgr.latest_checkpoint() is None
    mgr.publish_checkpoint("/ckpt/latest", pass_id=4)
    assert mgr.latest_checkpoint() == {"path": "/ckpt/latest",
                                       "pass_id": 4}
    st = mgr.membership_status()
    assert st["host"] == "h0" and st["level"] == "ELASTIC"
    assert st["target_np"] == 2 and st["reshard_count"] == 0
    mgr.note_reshard(2, 1, step=7)
    assert mgr.membership_status()["reshard_count"] == 1


def test_membership_probe_feeds_healthz_block(tmp_path):
    from paddlebox_tpu_torch.obs.hub import get_hub, reset_hub
    reset_hub()
    try:
        store = FileKVStore(str(tmp_path))
        _lease(store, "j", "h0")
        mgr = ElasticManager(store, "j", "h0", 1, ttl=30.0)
        assert mgr.scale_event() is None
        get_hub().set_membership_probe(mgr.membership_status)
        block = get_hub().health()["membership"]
        assert block["alive"] == ["h0"] and block["np"] == 1
        # register() installs the manager's own probe
        mgr.register()
        try:
            assert get_hub().health()["membership"]["host"] == "h0"
        finally:
            mgr.deregister()
    finally:
        reset_hub()


# ---- real 2-process heartbeat leg ----------------------------------------

_PEER = """
import sys, time
from paddlebox_tpu_torch.distributed.elastic import (ElasticManager,
                                                     FileKVStore)
root, ttl = sys.argv[1], float(sys.argv[2])
m = ElasticManager(FileKVStore(root), "j2", "peer", 2,
                   ttl=ttl, heartbeat_period=ttl / 5.0)
m.register()
print("up", flush=True)
time.sleep(600)
"""


def test_two_process_heartbeat_sigkill_detection(tmp_path):
    """A REAL peer process heartbeats the shared dir; SIGKILL makes its
    lease expire by genuine TTL and the survivor confirms the death
    (hysteresis honored: never on the first expired poll)."""
    ttl = 0.8
    env = dict(os.environ, PYTHONPATH=os.path.abspath(REPO))
    proc = subprocess.Popen([sys.executable, "-c", _PEER,
                             str(tmp_path), str(ttl)],
                            env=env, stdout=subprocess.PIPE, text=True)
    try:
        assert "up" in proc.stdout.readline()
        mgr = ElasticManager(FileKVStore(str(tmp_path)), "j2", "m0", 2,
                             ttl=ttl, heartbeat_period=0.1,
                             dead_checks=2)
        mgr.register()
        assert mgr.scale_event() is None
        assert mgr.alive_hosts() == ["m0", "peer"]
        proc.send_signal(signal.SIGKILL)
        proc.wait()
        deadline = time.time() + 20.0
        event = None
        while event is None and time.time() < deadline:
            time.sleep(ttl / 2.0)
            event = mgr.scale_event()
        assert event == ["m0"], "SIGKILL'd peer never detected"
        assert mgr.last_event["lost"] == ["peer"]
        mgr.deregister()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# ---- consensus participant narrowing -------------------------------------

def test_consensus_participants_narrow_to_survivors(tmp_path):
    from paddlebox_tpu_torch.resilience.consensus import RestoreConsensus
    c0 = RestoreConsensus(str(tmp_path), 0, 2, timeout=10.0,
                          poll_interval=0.01)
    c1 = RestoreConsensus(str(tmp_path), 1, 2, timeout=10.0,
                          poll_interval=0.01)
    out = {}
    t = threading.Thread(
        target=lambda: out.setdefault("r1", c1.agree_restore_step(12)))
    t.start()
    assert c0.agree_restore_step(10) == 10  # full mesh: min(10, 12)
    t.join(timeout=10.0)
    assert out["r1"] == 10
    # rank 1 died: the survivor narrows and agrees ALONE — no timeout
    # waiting on the dead rank's publish
    c0.set_participants([0])
    assert c0.participants == [0]
    assert c0.agree_restore_step(20) == 20
    with pytest.raises(ValueError):
        c0.set_participants([])
    with pytest.raises(ValueError):
        c0.set_participants([1])  # a world that excludes self


# ---- watchdog shrink-and-continue rung -----------------------------------

def test_shrink_and_continue_rung_evicts_wedged_rank(tmp_path):
    """The rung hands the wedged rank to ``evict_fn``; with
    ``ElasticManager.evict_host`` there, the survivors' next poll
    confirms the death."""
    from paddlebox_tpu_torch.obs.watchdog import (LocalHeartbeatStore,
                                                  StragglerWatchdog,
                                                  shrink_and_continue_action)
    store = FileKVStore(str(tmp_path))
    for h in ("h0", "h1", "h2"):
        _lease(store, "j", h)
    mgr = ElasticManager(store, "j", "h0", 3, ttl=30.0, dead_checks=3)
    assert mgr.scale_event() is None
    evicted = []

    def evict(reports):
        for r in reports:
            evicted.append(r.process)
            mgr.evict_host(f"h{r.process}", r.reason)

    action = shrink_and_continue_action(evict)
    assert action.escalation_name == "shrink_and_continue"
    tvar = [1000.0]
    hb = LocalHeartbeatStore()
    wd = StragglerWatchdog(hb, 0, 3, step_lag=100,
                           heartbeat_timeout=30.0,
                           clock=lambda: tvar[0],
                           escalations=[(0.0, action)])
    hb.publish(2, 50, 1005.0)   # rank 2 wedged long ago
    tvar[0] = 1040.0
    hb.publish(0, 50, tvar[0])
    hb.publish(1, 50, tvar[0])
    reports = wd.poll_once()
    assert [r.process for r in reports] == [2]
    assert reports[0].reason == "stale"
    assert evicted == [2]
    # the rung fires once per stall episode, not once per poll
    wd.poll_once()
    assert evicted == [2]
    assert mgr.scale_event() == ["h0", "h1"]


def test_telemetry_report_membership_timeline():
    from paddlebox_tpu_torch.tools.telemetry_report import \
        membership_summary
    events = [
        {"event": "pass"},
        {"event": "membership_change", "hosts": ["h0", "h2", "h3"],
         "lost": ["h1"], "joined": [], "np": 3, "target_np": 4},
        {"event": "reshard", "old_np": 4, "new_np": 3, "step": 2,
         "count": 1},
        {"event": "membership_change", "hosts": ["h0", "h1", "h2", "h3"],
         "lost": [], "joined": ["h1"], "np": 4, "target_np": 4},
    ]
    assert membership_summary(events) == (
        "membership: np=3 (lost h1) -> reshard 4->3 @step 2 -> "
        "np=4 (joined h1)")
    # a run that ENDS below target carries the degraded flag
    assert "still degraded (3/4)" in membership_summary(events[:3])
    assert membership_summary([{"event": "pass"}]) == ""


def test_membership_events_reach_the_timeline(tmp_path):
    """The manager's own ``membership_change`` and ``reshard`` events,
    through the hub's memory sink, read back as the timeline."""
    from paddlebox_tpu_torch.obs import MemorySink
    from paddlebox_tpu_torch.obs.hub import reset_hub
    from paddlebox_tpu_torch.tools.telemetry_report import \
        membership_summary
    hub = reset_hub()
    sink = MemorySink()
    hub.add_sink(sink)
    try:
        store = FileKVStore(str(tmp_path))
        for h in ("h0", "h1"):
            _lease(store, "j", h)
        mgr = ElasticManager(store, "j", "h0", 2, ttl=30.0)
        assert mgr.scale_event() is None
        mgr.evict_host("h1", "test")
        assert mgr.scale_event() == ["h0"]
        mgr.note_reshard(2, 1, step=5)
        assert membership_summary(sink.events) == (
            "membership: np=1 (lost h1) -> reshard 2->1 @step 5; "
            "still degraded (1/2)")
    finally:
        reset_hub()


# ---- the store cases of tests/test_distributed_launch.py -----------------

def test_file_kv_store_roundtrip(tmp_path):
    kv = FileKVStore(str(tmp_path))
    kv.put("a/b", b"1")
    kv.put("a/c", b"2")
    assert kv.get("a/b") == b"1"
    assert kv.get("missing") is None
    assert set(kv.list_prefix("a").values()) == {b"1", b"2"}
    kv.delete("a/b")
    assert kv.get("a/b") is None
    assert kv.mtime("a/c") > 0


def test_elastic_membership_and_scale_down(tmp_path):
    kv = FileKVStore(str(tmp_path))
    m1 = ElasticManager(kv, "job", "hostA", np=2, ttl=0.5,
                        heartbeat_period=0.1)
    m2 = ElasticManager(kv, "job", "hostB", np=2, ttl=0.5,
                        heartbeat_period=0.1)
    m1.register()
    m2.register()
    assert m1.wait_for_np(timeout=5.0) == ["hostA", "hostB"]
    assert m1.world_ok()
    assert m1.scale_event() is None  # no change yet

    # hostB dies: heartbeat stops, lease expires
    m2.deregister()
    time.sleep(0.7)
    ev = m1.scale_event()
    assert ev == ["hostA"]
    assert not m1.world_ok()  # FAULT_TOLERANCE needs np==2
    m1.deregister()


def test_elastic_level_window(tmp_path):
    kv = FileKVStore(str(tmp_path))
    m = ElasticManager(kv, "job2", "h0", np=4, min_np=2, max_np=4,
                       ttl=0.5, heartbeat_period=0.1)
    assert m.level == ElasticLevel.ELASTIC
    m.register()
    # only one host alive: below min_np
    assert not m.world_ok()
    with pytest.raises(TimeoutError):
        m.wait_for_np(timeout=0.4)
    # second host joins: inside [2,4] window
    m2 = ElasticManager(kv, "job2", "h1", np=4, min_np=2, max_np=4,
                        ttl=0.5, heartbeat_period=0.1)
    m2.register()
    assert m.wait_for_np(timeout=5.0) == ["h0", "h1"]
    m.deregister()
    m2.deregister()


def test_checkpoint_pointer(tmp_path):
    kv = FileKVStore(str(tmp_path))
    m = ElasticManager(kv, "job3", "h0", np=1)
    assert m.latest_checkpoint() is None
    m.publish_checkpoint("/models/delta_7", pass_id=7)
    ckpt = m.latest_checkpoint()
    assert ckpt == {"path": "/models/delta_7", "pass_id": 7}


def _kv_contract(kv, kv2):
    """The KVStore contract over a server, as the reference's case
    holds it; ``kv2`` is a second client of the same server."""
    assert kv.get("a") is None
    assert kv.mtime("a") == 0.0
    assert kv.touch("a") is False
    kv.put("a", b"1")
    kv.put("jobs/x", b"xx")
    kv.put("jobs/y", b"yy")
    assert kv.get("a") == b"1"
    assert kv.mtime("a") > 0.0
    assert kv.list_prefix("jobs/") == {"jobs/x": b"xx", "jobs/y": b"yy"}
    t0 = kv.mtime("a")
    time.sleep(0.01)
    kv.put("a", b"2")   # overwrite bumps mtime
    assert kv.get("a") == b"2" and kv.mtime("a") > t0
    assert kv.touch("a") is True and kv.get("a") == b"2"
    kv.put("empty", b"")
    assert kv.get("empty") == b""
    kv.delete("a")
    assert kv.get("a") is None
    # a second client sees the same state (it's a server, not files)
    assert kv2.get("jobs/x") == b"xx"
    assert kv2.list_prefix("jobs/") == kv.list_prefix("jobs/")


def test_tcp_kv_store_matches_file_kv(tmp_path):
    """TcpKVStore speaks the full KVStore contract against a KVServer —
    drop-in for FileKVStore with no shared filesystem."""
    srv = KVServer()
    try:
        kv, kv2 = TcpKVStore(srv.endpoint), TcpKVStore(srv.endpoint)
        _kv_contract(kv, kv2)
        kv.close()
        kv2.close()
    finally:
        srv.close()


@pytest.mark.parametrize("server,client", [("jax", "port"),
                                           ("port", "jax")],
                         ids=["port-client-jax-server",
                              "jax-client-port-server"])
def test_kv_wire_across_packages(server, client):
    """A client of one package against a server of the other: the same
    contract, and an elastic manager over the mixed pair."""
    srv = (jkv.KVServer if server == "jax" else KVServer)()
    mk = jkv.TcpKVStore if client == "jax" else TcpKVStore
    try:
        kv, kv2 = mk(srv.endpoint), mk(srv.endpoint)
        _kv_contract(kv, kv2)
        port_kv = TcpKVStore(srv.endpoint)
        m = ElasticManager(port_kv, "mixed", "h0", np=1, ttl=30.0)
        m.publish_checkpoint("/ckpt", pass_id=3)
        assert json.loads(kv.get("paddlebox/mixed/ckpt")) == {
            "path": "/ckpt", "pass_id": 3}
        for c in (kv, kv2, port_kv):
            c.close()
    finally:
        srv.close()


def test_elastic_kill_and_rejoin_over_tcp_kv():
    """ElasticManager over the NETWORK KV: two hosts register; one dies
    (lease expires); the survivor sees the scale-down event; the host
    rejoins and the world converges back."""
    srv = KVServer()
    try:
        kv_a = TcpKVStore(srv.endpoint)
        kv_b = TcpKVStore(srv.endpoint)

        def mk(kv, h):
            return ElasticManager(kv, "jobk", h, np=2, min_np=1, max_np=2,
                                  ttl=0.4)
        m_a = mk(kv_a, "hostA")
        m_b = mk(kv_b, "hostB")
        m_a.register()
        m_b.register()
        assert sorted(m_a.wait_for_np(timeout=10)) == ["hostA", "hostB"]
        assert m_a.scale_event() is None  # steady state
        # hostB dies WITHOUT deregistering (kill): its lease expires
        m_b._stop.set()
        m_b._hb_thread.join()
        deadline = time.time() + 10
        ev = None
        while time.time() < deadline and ev is None:
            time.sleep(0.1)
            ev = m_a.scale_event()
        assert ev == ["hostA"], ev            # scale-down observed
        assert m_a.world_ok()                 # min_np=1 keeps the job up
        # hostB rejoins through a FRESH store/manager (process restart)
        kv_b2 = TcpKVStore(srv.endpoint)
        m_b2 = mk(kv_b2, "hostB")
        m_b2.register()
        deadline = time.time() + 10
        ev2 = None
        while time.time() < deadline and ev2 is None:
            time.sleep(0.1)
            ev2 = m_a.scale_event()
        assert ev2 == ["hostA", "hostB"]      # scale-up observed
        assert sorted(m_a.wait_for_np(timeout=10)) == ["hostA", "hostB"]
        m_a.deregister()
        m_b2.deregister()
    finally:
        srv.close()
