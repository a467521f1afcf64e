"""Typed telemetry instruments: Counter / Gauge / Histogram.
(Copy of ``paddlebox_tpu/obs/instruments.py``.)

The reference system's monitors are an untyped int64 registry
(``StatRegistry``/``STAT_ADD``, platform/monitor.h:80) plus ad-hoc
per-stage timers. These instruments put a type system on top — monotone
counters, set-style gauges (with a high-watermark helper for HBM/queue
peaks), and fixed-bucket histograms — so one snapshot can render as
structured JSON or Prometheus text exposition (obs/hub.py).

Every instrument is thread-safe and label-aware: a labelless update
writes the ``()`` series; keyword labels key independent series
(``counter.inc(3, shard="0")``). Label values are stringified at update
time so snapshots are stable.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Instrument:
    """Base: name, help text, per-labelset series under one lock."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self._lock = threading.Lock()

    def series(self) -> List[Tuple[LabelKey, object]]:
        raise NotImplementedError


class Counter(Instrument):
    """Monotone float counter (STAT_ADD with labels)."""

    kind = "counter"

    def __init__(self, name: str, help: str = "") -> None:
        super().__init__(name, help)
        self._values: Dict[LabelKey, float] = {}

    def inc(self, value: float = 1.0, **labels: object) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name}: negative inc {value}")
        k = _label_key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + value

    def value(self, **labels: object) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def series(self) -> List[Tuple[LabelKey, float]]:
        with self._lock:
            return sorted(self._values.items())


class Gauge(Instrument):
    """Last-value gauge; ``set_max`` keeps running high watermarks."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "") -> None:
        super().__init__(name, help)
        self._values: Dict[LabelKey, float] = {}

    def set(self, value: float, **labels: object) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def inc(self, value: float = 1.0, **labels: object) -> None:
        k = _label_key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + value

    def set_max(self, value: float, **labels: object) -> None:
        """Watermark update: keep max(current, value)."""
        k = _label_key(labels)
        with self._lock:
            cur = self._values.get(k)
            if cur is None or value > cur:
                self._values[k] = float(value)

    def value(self, **labels: object) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def series(self) -> List[Tuple[LabelKey, float]]:
        with self._lock:
            return sorted(self._values.items())


# seconds-oriented default ladder (stage/pass timings span ms..minutes)
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class _HistSeries:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, nbuckets: int) -> None:
        self.counts = [0] * nbuckets  # cumulative at export, raw here
        self.sum = 0.0
        self.count = 0


class Histogram(Instrument):
    """Fixed-bucket histogram (Prometheus ``le`` semantics at export:
    bucket counts are cumulative, ``+Inf`` == count)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Optional[Sequence[float]] = None) -> None:
        super().__init__(name, help)
        bs = tuple(sorted(buckets)) if buckets else DEFAULT_BUCKETS
        if not bs:
            raise ValueError(f"histogram {name}: empty buckets")
        self.buckets = bs
        self._series: Dict[LabelKey, _HistSeries] = {}

    def observe(self, value: float, **labels: object) -> None:
        import bisect
        k = _label_key(labels)
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            s = self._series.get(k)
            if s is None:
                s = self._series[k] = _HistSeries(len(self.buckets))
            if i < len(self.buckets):
                s.counts[i] += 1
            s.sum += value
            s.count += 1

    def snapshot(self, **labels: object) -> Dict[str, object]:
        """{buckets: {le: cumulative_count}, sum, count} for one series."""
        with self._lock:
            s = self._series.get(_label_key(labels))
            if s is None:
                return {"buckets": {}, "sum": 0.0, "count": 0}
            cum, acc = {}, 0
            for le, c in zip(self.buckets, s.counts):
                acc += c
                cum[le] = acc
            return {"buckets": cum, "sum": s.sum, "count": s.count}

    def series(self) -> List[Tuple[LabelKey, _HistSeries]]:
        with self._lock:
            return sorted(self._series.items(), key=lambda kv: kv[0])

    @staticmethod
    def _quantile_from_counts(buckets: Sequence[float], counts,
                              count: int, q: float) -> float:
        """Estimate quantile ``q`` from fixed-bucket counts the way
        Prometheus's ``histogram_quantile`` does: find the bucket the
        target rank lands in and interpolate linearly inside it. Ranks
        past the last finite bucket clamp to its upper bound (the +Inf
        bucket has no width to interpolate over)."""
        if count <= 0:
            return 0.0
        rank = q * count
        cum = 0
        lo = 0.0
        for le, c in zip(buckets, counts):
            if cum + c >= rank and c > 0:
                return lo + (le - lo) * (rank - cum) / c
            cum += c
            lo = le
        return float(buckets[-1])

    def quantile(self, q: float, **labels: object) -> float:
        """Interpolated quantile (0 < q <= 1) of one series; 0.0 for an
        empty series. Accuracy is bucket-bounded — pick buckets that
        bracket the latencies you care about (SERVING_LATENCY_BUCKETS
        for the serving path)."""
        if not 0.0 < q <= 1.0:
            raise ValueError(f"histogram {self.name}: quantile {q} "
                             "outside (0, 1]")
        with self._lock:
            s = self._series.get(_label_key(labels))
            if s is None:
                return 0.0
            return self._quantile_from_counts(self.buckets, s.counts,
                                              s.count, q)


#: quantiles every histogram exports in the Prometheus text format
#: (scrapeable p50/p90/p99 without server-side histogram_quantile —
#: the serving latency SLO lines; docs/SERVING.md)
EXPORT_QUANTILES: Tuple[float, ...] = (0.5, 0.9, 0.99)

#: serving-latency ladder: batched CPU/TPU lookups + dense forwards sit
#: in the 100µs..100ms band the default seconds ladder cannot resolve
SERVING_LATENCY_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5)


def escape_label_value(v: str) -> str:
    """Prometheus text-format label-value escaping: backslash, double
    quote and newline must be escaped or the exposition line is
    unparseable (label values are arbitrary strings — error reprs,
    file paths — by the time they reach a series key)."""
    return (v.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def iter_prom_lines(inst: Instrument) -> Iterator[str]:
    """Prometheus text-exposition lines for one instrument."""

    def fmt_labels(k: LabelKey, extra: str = "") -> str:
        parts = [f'{n}="{escape_label_value(v)}"' for n, v in k]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    if inst.help:
        yield f"# HELP {inst.name} {inst.help}"
    yield f"# TYPE {inst.name} {inst.kind}"
    if isinstance(inst, Histogram):
        series = inst.series()
        for k, s in series:
            acc = 0
            for le, c in zip(inst.buckets, s.counts):
                acc += c
                le_lbl = 'le="%s"' % le
                yield f"{inst.name}_bucket{fmt_labels(k, le_lbl)} {acc}"
            inf_lbl = 'le="+Inf"'
            yield f"{inst.name}_bucket{fmt_labels(k, inf_lbl)} {s.count}"
            yield f"{inst.name}_sum{fmt_labels(k)} {s.sum}"
            yield f"{inst.name}_count{fmt_labels(k)} {s.count}"
        # interpolated p50/p90/p99 as a SIBLING gauge family
        # (`<name>_quantile`) so dashboards scrape latency SLOs without
        # server-side histogram_quantile. A separate declared family on
        # purpose: bare-name quantile samples are summary-type syntax,
        # and strict parsers reject them inside a histogram family.
        if series:
            yield f"# TYPE {inst.name}_quantile gauge"
            for k, s in series:
                for q in EXPORT_QUANTILES:
                    v = Histogram._quantile_from_counts(
                        inst.buckets, s.counts, s.count, q)
                    q_lbl = 'quantile="%s"' % q
                    yield (f"{inst.name}_quantile"
                           f"{fmt_labels(k, q_lbl)} {v:g}")
    else:
        for k, v in inst.series():
            yield f"{inst.name}{fmt_labels(k)} {v}"
