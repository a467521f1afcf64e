"""The port's resilience layer (``paddlebox_tpu_torch/resilience``,
``utils/fsio.py``): the retry and fault-injection cases of
``tests/test_resilience.py`` and the host cases of
``tests/test_preemption.py`` with the same assertions (the telemetry
counters aside), and the two packages held against each other: one plan
string fires at the same calls, one seed gives the same backoff
delays."""

import json
import signal

import pytest

from paddlebox_tpu.resilience import faults as jfaults
from paddlebox_tpu.resilience.retry import RetryPolicy as JRetryPolicy
from paddlebox_tpu.utils import fsio as jfsio

from paddlebox_tpu_torch.config import flags_scope
from paddlebox_tpu_torch.resilience import preemption
from paddlebox_tpu_torch.resilience.faults import (FaultPlan, InjectedCrash,
                                                   TransientInjectedError,
                                                   inject, install_from_flags,
                                                   installed, active_plan,
                                                   clear_plan)
from paddlebox_tpu_torch.resilience.retry import (RetryExhausted,
                                                  RetryPolicy,
                                                  TransientError,
                                                  is_retryable)
from paddlebox_tpu_torch.utils import fsio


@pytest.fixture(autouse=True)
def clean_preempt_state():
    preemption.clear_stop()
    yield
    preemption.clear_stop()
    preemption.uninstall_signal_handlers()


def _nosleep_policy(**kw):
    kw.setdefault("base_delay", 0.001)
    kw.setdefault("sleep", lambda s: None)
    return RetryPolicy(**kw)


# ---- RetryPolicy -------------------------------------------------------
def test_retry_succeeds_after_transient():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise TransientError("hiccup")
        return "ok"

    assert _nosleep_policy(max_attempts=4).call(flaky) == "ok"
    assert len(calls) == 3


def test_retry_non_retryable_propagates_untouched():
    def bad():
        raise ValueError("programming error")

    with pytest.raises(ValueError):
        _nosleep_policy().call(bad)
    assert not is_retryable(FileNotFoundError("x"))
    assert is_retryable(ConnectionResetError("x"))
    calls = []

    def missing():
        calls.append(1)
        raise FileNotFoundError("gone")

    with pytest.raises(FileNotFoundError):
        _nosleep_policy(retryable=(OSError,)).call(missing)
    assert len(calls) == 1


def test_retry_exhausts_attempts():
    calls = []

    def always():
        calls.append(1)
        raise TransientError("down")

    with pytest.raises(RetryExhausted) as ei:
        _nosleep_policy(max_attempts=3).call(always)
    assert len(calls) == 3
    assert ei.value.attempts == 3
    assert isinstance(ei.value.last, TransientError)
    assert isinstance(ei.value.__cause__, TransientError)


def test_retry_deadline_caps_wall_time():
    clk = {"t": 0.0}

    def sleep(s):
        clk["t"] += s

    calls = []

    def always():
        calls.append(1)
        clk["t"] += 1.0
        raise TransientError("down")

    p = RetryPolicy(max_attempts=100, base_delay=1.0, max_delay=1.0,
                    deadline=3.5, jitter=0.0, sleep=sleep,
                    clock=lambda: clk["t"])
    with pytest.raises(RetryExhausted) as ei:
        p.call(always)
    assert "deadline" in str(ei.value)
    assert len(calls) < 5


def test_retry_jitter_deterministic_per_seed_and_site():
    a = list(RetryPolicy(site="s1", seed=7, max_attempts=6).delays())
    b = list(RetryPolicy(site="s1", seed=7, max_attempts=6).delays())
    c = list(RetryPolicy(site="s2", seed=7, max_attempts=6).delays())
    d = list(RetryPolicy(site="s1", seed=8, max_attempts=6).delays())
    assert a == b
    assert a != c and a != d
    nojit = list(RetryPolicy(site="s", jitter=0.0, max_attempts=8,
                             base_delay=0.05, max_delay=0.4).delays())
    assert nojit == [0.05, 0.1, 0.2, 0.4, 0.4, 0.4, 0.4]


@pytest.mark.parametrize("site,seed", [("checkpoint.io", 0),
                                       ("serving.reload", 11)])
def test_retry_delays_match_reference(site, seed):
    """The same (seed, site) draws the reference's delays exactly."""
    kw = dict(site=site, seed=seed, max_attempts=9, base_delay=0.05,
              max_delay=2.0, jitter=0.25)
    assert (list(RetryPolicy(**kw).delays())
            == list(JRetryPolicy(**kw).delays()))


def test_retry_from_flags_reads_port_flags():
    with flags_scope(retry_max_attempts=2, retry_deadline_sec=0.0):
        p = RetryPolicy.from_flags(site="x")
    assert p.max_attempts == 2 and p.deadline is None and p.seed == 0


def test_retry_wrap():
    calls = []

    @_nosleep_policy(max_attempts=3).wrap
    def flaky(x):
        calls.append(x)
        if len(calls) < 2:
            raise TransientError("hiccup")
        return x * 2

    assert flaky(4) == 8 and calls == [4, 4]
    assert flaky.__name__ == "flaky"


# ---- FaultPlan ---------------------------------------------------------
def test_fault_plan_parse():
    plan = FaultPlan.parse(
        "seed=9; a.b:fail:nth=2,times=3,exc=crash; "
        "c.d:corrupt:match=*bad*; e.f:slow:delay=0.01")
    assert plan.seed == 9
    kinds = [(s.site, s.kind) for s in plan.specs]
    assert kinds == [("a.b", "fail"), ("c.d", "corrupt"), ("e.f", "slow")]
    assert plan.specs[0].nth == 2 and plan.specs[0].times == 3
    assert plan.specs[0].exc == "crash"
    with pytest.raises(ValueError):
        FaultPlan.parse("justasite")
    with pytest.raises(ValueError):
        FaultPlan.parse("a.b:explode")
    with pytest.raises(ValueError):
        FaultPlan.parse("a.b:fail:bogus=1")
    assert FaultPlan.parse("  ").specs == []


def test_fault_nth_times_and_match():
    plan = FaultPlan.parse("s:fail:nth=2,times=2")
    with installed(plan):
        inject("s")                      # call 1: no fire
        for _ in range(2):               # calls 2,3 fire
            with pytest.raises(TransientInjectedError):
                inject("s")
        inject("s")                      # call 4: past the window
    assert plan.stats()["s:fail"] == {"calls": 4, "fired": 2}

    plan2 = FaultPlan.parse("s:fail:match=*bad*,times=0")
    with installed(plan2):
        inject("s", path="/data/good.txt")   # no match, not even a call
        with pytest.raises(TransientInjectedError):
            inject("s", path="/data/bad.txt")
        with pytest.raises(TransientInjectedError):
            inject("s", path="/data/also_bad.txt")  # times=0: every call
    assert plan2.stats()["s:fail"]["fired"] == 2


def test_fault_corrupt_and_crash_kinds():
    plan = FaultPlan.parse(
        "c:corrupt:times=0; k:fail:exc=crash; o:fail:exc=os")
    with installed(plan):
        got = inject("c", "hello line")
        assert got != "hello line" and "CORRUPT" in got
        assert inject("c", b"bytes")[:9] == b"\x00CORRUPT\x00"
        with pytest.raises(InjectedCrash):
            inject("k")
        with pytest.raises(OSError):
            inject("o")


def test_fault_install_scoping():
    outer = FaultPlan.parse("s:fail:nth=1")
    inner = FaultPlan.parse("")
    with installed(outer):
        with installed(inner):
            inject("s")  # inner (empty) plan shadows outer: no fire
        with pytest.raises(TransientInjectedError):
            inject("s")  # outer restored
    inject("s")  # nothing installed
    assert outer.stats()["s:fail"]["fired"] == 1


def test_fault_probability_deterministic():
    def run():
        plan = FaultPlan.parse("s:fail:p=0.5,times=0", seed=3)
        fired = []
        with installed(plan):
            for i in range(50):
                try:
                    inject("s")
                    fired.append(0)
                except TransientInjectedError:
                    fired.append(1)
        return fired

    a, b = run(), run()
    assert a == b and 0 < sum(a) < 50


@pytest.mark.parametrize("spec", [
    "s:fail:p=0.3,times=0", "s:fail:nth=3,times=4",
    "s:fail:match=*odd*,times=0", "seed=4; s:fail:p=0.7"])
def test_fault_plan_fires_like_reference(spec):
    """One plan string fires at the same calls in both packages."""
    def run(mod, exc):
        plan = mod.FaultPlan.parse(spec, seed=None)
        fired = []
        with mod.installed(plan):
            for i in range(40):
                try:
                    mod.inject("s", path=f"/f/{'odd' if i % 2 else 'e'}")
                    fired.append(0)
                except exc:
                    fired.append(1)
        return fired, plan.stats()

    import paddlebox_tpu_torch.resilience.faults as tfaults
    assert (run(tfaults, tfaults.TransientInjectedError)
            == run(jfaults, jfaults.TransientInjectedError))


def test_install_from_flags():
    assert active_plan() is None
    with flags_scope(fault_plan="seed=6; s:fail:nth=2"):
        plan = install_from_flags()
    try:
        assert plan is active_plan() and plan.seed == 6
        inject("s")
        with pytest.raises(TransientInjectedError):
            inject("s")
    finally:
        clear_plan()
    with flags_scope(fault_plan=""):
        assert install_from_flags() is None
    assert active_plan() is None


# ---- preemption host side -------------------------------------------------
def test_request_stop_roundtrip():
    assert not preemption.stop_requested()
    preemption.request_stop("unit-test")
    assert preemption.stop_requested()
    assert preemption.stop_reason() == "unit-test"
    preemption.request_stop("second")  # first reason wins
    assert preemption.stop_reason() == "unit-test"
    preemption.clear_stop()
    assert not preemption.stop_requested()


def test_injected_fault_becomes_stop_request():
    plan = FaultPlan.parse("preempt.signal:fail:nth=3")
    with installed(plan):
        assert not preemption.stop_requested()   # call 1
        assert not preemption.stop_requested()   # call 2
        assert preemption.stop_requested()       # call 3: fault -> stop
    assert "injected" in preemption.stop_reason()
    assert plan.stats()["preempt.signal:fail"]["fired"] == 1


def test_preempt_fault_os_exc_still_graceful():
    with installed(FaultPlan.parse("preempt.signal:fail:exc=os")):
        assert preemption.stop_requested()
    assert preemption.stop_pending()


def test_stop_pending_skips_the_seam():
    plan = FaultPlan.parse("preempt.signal:fail:nth=1")
    with installed(plan):
        assert not preemption.stop_pending()
        assert plan.stats()["preempt.signal:fail"]["calls"] == 0


def test_signal_handler_is_lock_free():
    """The handler may interrupt code holding the module lock: it must
    not take it; the next poll does the work."""
    import paddlebox_tpu_torch.resilience.preemption as pre
    with pre._LOCK:                 # simulate: interrupted mid-request
        pre._handler(signal.SIGTERM.value, None)   # must not block
        assert pre._SIG_PENDING == "signal:SIGTERM"
        assert not pre._STOP.is_set()
    assert preemption.stop_pending()               # drained at poll
    assert preemption.stop_reason() == "signal:SIGTERM"


def test_install_signal_handlers_idempotent():
    assert preemption.install_signal_handlers()
    assert preemption.install_signal_handlers()
    assert signal.getsignal(signal.SIGTERM) is preemption._handler
    preemption.uninstall_signal_handlers()
    assert signal.getsignal(signal.SIGTERM) is not preemption._handler


def test_resume_marker_roundtrip(tmp_path):
    root = str(tmp_path / "ckpt")
    assert preemption.read_resume_marker(root) is None
    preemption.write_resume_marker(root, step=42, batch_index=7,
                                   reason="signal:SIGTERM")
    m = preemption.read_resume_marker(root)
    assert m["step"] == 42 and m["batch_index"] == 7
    assert m["exit_code"] == preemption.EXIT_RESUME == 75
    assert preemption.clear_resume_marker(root)
    assert preemption.read_resume_marker(root) is None
    assert not preemption.clear_resume_marker(root)  # already gone


# ---- fsio --------------------------------------------------------------
def test_fsio_matches_reference(tmp_path):
    payload = {"step": 3, "files": ["a", "b"], "x": {"y": 1.5}}
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    fsio.atomic_write_json(a, payload)
    jfsio.atomic_write_json(b, payload)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert fsio.read_json(a) == payload == jfsio.read_json(a)
    fsio.atomic_write_bytes(a, b"{torn")
    assert fsio.read_json(a) is None
    assert fsio.read_json(str(tmp_path / "missing.json")) is None
    assert not [p for p in tmp_path.iterdir() if ".tmp" in p.name]
    assert json.loads(open(b).read()) == payload
