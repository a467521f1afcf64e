"""Deterministic, seed-driven fault injection (copy of
``paddlebox_tpu/resilience/faults.py``).

A ``FaultPlan`` is a list of ``FaultSpec``s, each bound to a named site:
a seam in the code that calls :func:`inject`. With no plan installed the
seam costs one module-global read; with a plan, firing is decided by the
spec's call counter (plus an optional glob match and seeded
probability), so the same seed fires the same faults in the same places.

The port's sites, with the reference's names so that one plan string
means the same thing to both packages:

==========================  =============================================
``checkpoint.io``           checkpoint meta/dense file reads and writes
``checkpoint.save_commit``  just before the rename that publishes a
                            checkpoint (``fail`` = crash mid-save)
``checkpoint.cursor``       resume-cursor save/load (``cursor.json``)
``trainer.pass``            start of every ``Trainer.run_pass`` attempt
``preempt.signal``          the batch-boundary stop poll: a ``fail`` here
                            IS a simulated SIGTERM and becomes a graceful
                            stop request, never an exception
``artifact.publish``        just before the rename that publishes an
                            artifact version
``artifact.read``           every registry read on the consumer side
                            (``corrupt`` mangles the bytes)
``serving.reload``          start of every ``ReloadLoop.poll_once``
``dataset.open``            every dataset file open, inside the retried
                            call (a transient fault exercises the retry
                            before it can count against the quarantine)
``reader.file``             each file a reader thread starts on
``parser.record``           every line of the per-line parse
                            (``corrupt`` mangles the line)
``stream.window``           each window a windowed ``QueueDataset``
                            dispatches
``endpass.writeback``       each end-of-pass write-back job before the
                            pull lands rows in the host tier
                            (``ps/tiered.py``, ``ps/pass_table.py``): a
                            ``fail`` surfaces at the next epilogue fence
                            as ``EndPassWritebackError``
``ssd.io``                  every SSD-tier segment file operation
                            (append, read, unlink; ``ps/ssd.py``): a
                            transient ``fail`` retries on the seeded
                            policy (site ``ssd.io``)
``online.supervise``        the online daemon's supervisor seams
                            (``online.OnlineLearner.run`` and the serve
                            leg's start): a transient ``fail`` on the
                            train leg retries on the seeded policy (site
                            ``online.supervise``, mode ``degraded`` while
                            backing off); a deterministic one degrades
                            the daemon to ``serve_only``/``train_only``
``online.shrink``           start of every shrink attempt of the online
                            daemon: transients retry on the seeded policy
                            (site ``online.shrink``); a hard or exhausted
                            failure skips the cycle loudly
``file_mgr.command``        every ``utils/file_mgr.CommandBackend`` CLI
                            invocation
==========================  =============================================

Kinds: ``fail`` (raise; ``exc=transient|crash|os`` picks the type),
``corrupt`` (mutate the value flowing through the seam), ``slow`` (sleep
``delay`` seconds). Spec string::

    seed=7; checkpoint.io:fail:nth=1; artifact.read:corrupt:match=*v2*

``;``-separated ``site:kind[:k=v,...]`` entries with an optional leading
``seed=N``. Keys: ``nth`` (1-based call index the fault first fires at),
``times`` (consecutive matching calls that fire, 0 = every call),
``match`` (glob against the seam's ``path``/``op`` context), ``p``
(seeded probability instead of a call index), ``delay``, ``exc``.
"""

from __future__ import annotations

import fnmatch
import logging
import random
import threading
import time
from typing import Dict, List, Optional

from paddlebox_tpu_torch.resilience.retry import TransientError

log = logging.getLogger(__name__)


class InjectedFault(RuntimeError):
    """Base of every exception raised by fault injection."""


class TransientInjectedError(InjectedFault, TransientError):
    """Injected retryable failure."""


class InjectedCrash(InjectedFault):
    """Injected hard crash (not retryable: a process dying mid-operation;
    recovery must come from atomicity and checkpoints)."""


_EXC_KINDS = {"transient": TransientInjectedError,
              "crash": InjectedCrash,
              "os": OSError}


class FaultSpec:
    """One fault at one site. The call counter advances under the plan
    lock."""

    def __init__(self, site: str, kind: str, nth: int = 1, times: int = 1,
                 match: Optional[str] = None, p: Optional[float] = None,
                 delay: float = 0.05, exc: str = "transient") -> None:
        if kind not in ("fail", "corrupt", "slow"):
            raise ValueError(f"unknown fault kind {kind!r} "
                             "(one of fail/corrupt/slow)")
        if exc not in _EXC_KINDS:
            raise ValueError(f"unknown exc {exc!r} "
                             f"(one of {sorted(_EXC_KINDS)})")
        self.site = site
        self.kind = kind
        self.nth = int(nth)
        self.times = int(times)
        self.match = match
        self.p = None if p is None else float(p)
        self.delay = float(delay)
        self.exc = exc
        self.calls = 0   # matching calls seen
        self.fired = 0   # faults actually fired

    def _matches_ctx(self, ctx: Dict[str, object]) -> bool:
        if self.match is None:
            return True
        hay = str(ctx.get("path", ctx.get("op", "")))
        return fnmatch.fnmatch(hay, self.match)

    def should_fire(self, ctx: Dict[str, object],
                    rng: random.Random) -> bool:
        if not self._matches_ctx(ctx):
            return False
        self.calls += 1
        if self.p is not None:
            hit = rng.random() < self.p
        else:
            hit = (self.calls >= self.nth
                   and (self.times == 0
                        or self.calls < self.nth + self.times))
        if hit:
            self.fired += 1
        return hit

    def describe(self) -> str:
        tail = (f"nth={self.nth},times={self.times}" if self.p is None
                else f"p={self.p}")
        m = f",match={self.match}" if self.match else ""
        return f"{self.site}:{self.kind}:{tail}{m}"


def _corrupt_value(value):
    """Deterministically mangle the value at a ``corrupt`` seam: text and
    bytes become reversed garbage with a marker; anything else None."""
    if isinstance(value, str):
        return "\x00CORRUPT\x00 " + value[::-1]
    if isinstance(value, (bytes, bytearray)):
        return b"\x00CORRUPT\x00 " + bytes(value)[::-1]
    return None


def _book_fault(site: str, spec, ctx) -> None:
    """``pbox_faults_injected_total{site, kind}`` and, with a sink
    attached, a ``fault_injected`` event."""
    try:
        from paddlebox_tpu_torch.obs.hub import get_hub
        hub = get_hub()
        hub.counter("pbox_faults_injected_total",
                    "faults fired by the installed FaultPlan").inc(
                        site=site, kind=spec.kind)
        if hub.active:
            hub.emit("fault_injected", site=site, kind=spec.kind,
                     spec=spec.describe(),
                     **{k: str(v) for k, v in ctx.items()})
    except Exception:
        log.debug("fault telemetry emit failed", exc_info=True)


class FaultPlan:
    def __init__(self, specs: List[FaultSpec], seed: int = 0) -> None:
        self.specs = list(specs)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._rngs: Dict[str, random.Random] = {}
        self._by_site: Dict[str, List[FaultSpec]] = {}
        for s in self.specs:
            self._by_site.setdefault(s.site, []).append(s)

    @classmethod
    def parse(cls, text: str, seed: Optional[int] = None) -> "FaultPlan":
        """Build a plan from the spec string (module docstring). An empty
        string yields an empty plan."""
        specs: List[FaultSpec] = []
        plan_seed = 0 if seed is None else int(seed)
        for raw in text.split(";"):
            entry = raw.strip()
            if not entry:
                continue
            if entry.startswith("seed="):
                if seed is None:
                    plan_seed = int(entry[5:])
                continue
            parts = entry.split(":", 2)
            if len(parts) < 2:
                raise ValueError(
                    f"bad fault spec {entry!r}: want site:kind[:k=v,...]")
            site, kind = parts[0].strip(), parts[1].strip()
            kw: Dict[str, object] = {}
            if len(parts) == 3 and parts[2].strip():
                for pair in parts[2].split(","):
                    k, _, v = pair.partition("=")
                    k = k.strip()
                    if k in ("nth", "times"):
                        kw[k] = int(v)
                    elif k in ("p", "delay"):
                        kw[k] = float(v)
                    elif k in ("match", "exc"):
                        kw[k] = v.strip()
                    else:
                        raise ValueError(
                            f"bad fault spec key {k!r} in {entry!r}")
            specs.append(FaultSpec(site, kind, **kw))
        return cls(specs, seed=plan_seed)

    def _site_rng(self, site: str) -> random.Random:
        rng = self._rngs.get(site)
        if rng is None:
            rng = self._rngs[site] = random.Random(f"{self.seed}:{site}")
        return rng

    def inject(self, site: str, value=None, **ctx):
        """Run the seam: may raise (``fail``), sleep (``slow``) or return
        a mutated ``value`` (``corrupt``); otherwise returns ``value``."""
        specs = self._by_site.get(site)
        if not specs:
            return value
        with self._lock:
            rng = self._site_rng(site)
            to_fire = [s for s in specs if s.should_fire(ctx, rng)]
        for spec in to_fire:
            log.warning("fault injected at %s (%s) ctx=%s", site,
                        spec.describe(), ctx)
            _book_fault(site, spec, ctx)
            if spec.kind == "slow":
                time.sleep(spec.delay)
            elif spec.kind == "corrupt":
                value = _corrupt_value(value)
            else:
                raise _EXC_KINDS[spec.exc](
                    f"injected fault at {site} ({spec.describe()}, "
                    f"ctx={ctx})")
        return value

    def stats(self) -> Dict[str, Dict[str, int]]:
        """``{"site:kind": {"calls": n, "fired": m}}``, the same across
        runs with the same seed."""
        with self._lock:
            return {f"{s.site}:{s.kind}": {"calls": s.calls,
                                           "fired": s.fired}
                    for s in self.specs}

    def install(self) -> "FaultPlan":
        install_plan(self)
        return self


_PLAN: Optional[FaultPlan] = None
_PLAN_LOCK = threading.Lock()


def install_plan(plan: FaultPlan) -> None:
    global _PLAN
    with _PLAN_LOCK:
        _PLAN = plan
    if plan.specs:
        log.warning("fault plan INSTALLED (seed=%d): %s", plan.seed,
                    "; ".join(s.describe() for s in plan.specs))


def clear_plan() -> None:
    global _PLAN
    with _PLAN_LOCK:
        _PLAN = None


def active_plan() -> Optional[FaultPlan]:
    return _PLAN


def install_from_flags() -> Optional[FaultPlan]:
    """Install ``FLAGS.fault_plan`` (no-op when the flag is empty);
    ``Trainer`` calls this at construction."""
    from paddlebox_tpu_torch.config import FLAGS
    if not FLAGS.fault_plan:
        return None
    return FaultPlan.parse(FLAGS.fault_plan).install()


class installed:
    """``with installed(plan): ...`` scopes a plan and restores the one
    installed before it on exit."""

    def __init__(self, plan: FaultPlan) -> None:
        self.plan = plan
        self._prev: Optional[FaultPlan] = None

    def __enter__(self) -> FaultPlan:
        self._prev = active_plan()
        install_plan(self.plan)
        return self.plan

    def __exit__(self, *exc) -> None:
        if self._prev is None:
            clear_plan()
        else:
            install_plan(self._prev)


def inject(site: str, value=None, **ctx):
    """THE seam hook: one global read and a None check when no plan is
    installed."""
    plan = _PLAN
    if plan is None:
        return value
    return plan.inject(site, value, **ctx)
