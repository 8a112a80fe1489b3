"""Minimal Prometheus-compatible metrics: counters, gauges, summaries,
histograms, and the text exposition format v0.0.4.

A copy of flow_pipeline_tpu/obs/metrics.py (stdlib only): the port
registers the reference's metric families under the same names, so the
deploy/ dashboards and alerts read either package, and the exposition
text of the same updates is byte-equal in both.
"""

from __future__ import annotations

import bisect
import threading
from collections import deque
from typing import Optional


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class Counter:
    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self._lock = threading.Lock()
        self._values: dict[tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        key = tuple(sorted(labels.items()))
        with self._lock:
            return self._values.get(key, 0.0)

    _kind = "counter"

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self._kind}"]
        with self._lock:
            items = list(self._values.items()) or [((), 0.0)]
        for key, v in items:
            lines.append(f"{self.name}{_fmt_labels(dict(key))} {v}")
        return "\n".join(lines)


class Gauge(Counter):
    _kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = value

    def remove(self, **labels) -> None:
        """Drop one label-set series. A gauge keyed by a dynamic entity
        (e.g. a mesh member) would otherwise render its last value
        forever after the entity dies — a frozen stale series that
        mimics a live signal."""
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values.pop(key, None)


class Summary:
    """Sliding-window summary with quantiles + running sum/count (the shape
    GoFlow's *_time_us summaries take).

    Observations may carry labels (``observe(v, router="10.0.0.1")``):
    each label set keeps its own window/sum/count and renders as its own
    quantile series — how the reference's perfs dashboards break the
    NFDelaySummary panel down ``by (router)``. The unlabeled form is the
    plain single-series summary it always was, and ``_sum``/``_count``
    stay the ACROSS-ALL-LABELS totals (bench.py's stage budget reads
    them).

    Label values can be attacker-controlled (the collector labels by
    spoofable UDP source address) and each label set pins a full sample
    window, so distinct label sets are CAPPED: once ``max_label_sets``
    exist, observations for unseen label sets fold into an ``_other``
    series per label name — the tail stays measured, memory and scrape
    cost stay bounded."""

    def __init__(self, name: str, help_: str = "", window: int = 1024,
                 max_label_sets: int = 64):
        self.name = name
        self.help = help_
        self._window = window
        self._max_label_sets = max_label_sets
        self._lock = threading.Lock()
        self._obs: dict[tuple, deque] = {}
        self._sums: dict[tuple, float] = {}
        self._counts: dict[tuple, int] = {}
        # totals across label sets (stage budgets)
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            dq = self._obs.get(key)
            if dq is None:
                if key and len(self._obs) >= self._max_label_sets:
                    # cardinality cap: fold the tail into _other so a
                    # spoofed-exporter flood cannot grow this unbounded
                    key = tuple((name, "_other") for name, _ in key)
                    dq = self._obs.get(key)
                if dq is None:
                    dq = self._obs[key] = deque(maxlen=self._window)
            dq.append(value)
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._counts[key] = self._counts.get(key, 0) + 1
            self._sum += value
            self._count += 1

    def quantile(self, q: float, **labels) -> float:
        key = tuple(sorted(labels.items()))
        with self._lock:
            dq = self._obs.get(key)
            if not dq:
                return 0.0
            data = sorted(dq)
        idx = min(len(data) - 1, int(q * len(data)))
        return data[idx]

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} summary"]
        with self._lock:
            snap = {key: sorted(dq) for key, dq in self._obs.items()} \
                or {(): []}
            sums = dict(self._sums)
            counts = dict(self._counts)
        for key, data in snap.items():  # one sort per label set, 3 reads
            for q in (0.5, 0.9, 0.99):
                labels = _fmt_labels({**dict(key), "quantile": str(q)})
                v = data[min(len(data) - 1, int(q * len(data)))] \
                    if data else 0.0
                lines.append(f"{self.name}{labels} {v}")
        for key in snap:
            labels = _fmt_labels(dict(key))
            lines.append(f"{self.name}_sum{labels} {sums.get(key, 0.0)}")
            lines.append(
                f"{self.name}_count{labels} {counts.get(key, 0)}")
        return "\n".join(lines)


# Default buckets for microsecond-scale stage latencies: log-ish spacing
# from 100us (a cheap host stage) to 10s (a wedged sink write), the span
# the pipeline's stages actually occupy.
DEFAULT_US_BUCKETS = (
    100.0, 250.0, 500.0, 1_000.0, 2_500.0, 5_000.0, 10_000.0, 25_000.0,
    50_000.0, 100_000.0, 250_000.0, 500_000.0, 1_000_000.0, 2_500_000.0,
    10_000_000.0,
)


class Histogram:
    """Prometheus-native histogram: cumulative ``le`` buckets plus
    ``_sum``/``_count``.

    This exists next to Summary because the two are NOT interchangeable
    for fleet dashboards: a Summary exports pre-computed per-instance
    quantiles, which cannot be aggregated across workers (the p99 of
    p99s is not the fleet p99), while histogram buckets are plain
    counters — ``sum by (le)`` across instances then
    ``histogram_quantile`` gives honest fleet-wide quantiles, and the
    bucket matrix renders as a Grafana heatmap.

    Labels follow Summary's contract, including the cardinality cap:
    distinct label sets beyond ``max_label_sets`` fold into a per-name
    ``_other`` series, so attacker-influenced label values cannot grow
    the family unbounded (each label set pins len(buckets)+2 series)."""

    _kind = "histogram"

    def __init__(self, name: str, help_: str = "",
                 buckets: tuple = DEFAULT_US_BUCKETS,
                 max_label_sets: int = 64):
        self.name = name
        self.help = help_
        self._buckets = tuple(sorted(float(b) for b in buckets))
        if not self._buckets:
            raise ValueError("histogram needs at least one bucket bound")
        self._max_label_sets = max_label_sets
        self._lock = threading.Lock()
        # per label set: cumulative bucket counts (+Inf last), sum, count
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}

    def _bucket_index(self, value: float) -> int:
        return bisect.bisect_left(self._buckets, value)

    def observe(self, value: float, **labels) -> None:
        idx = self._bucket_index(value)
        key = tuple(sorted(labels.items()))
        with self._lock:
            counts = self._counts.get(key)
            if counts is None:
                if key and len(self._counts) >= self._max_label_sets:
                    # cardinality cap: fold the tail into _other (same
                    # trade as Summary — the tail stays measured, the
                    # scrape stays bounded)
                    key = tuple((name, "_other") for name, _ in key)
                    counts = self._counts.get(key)
                if counts is None:
                    counts = self._counts[key] = \
                        [0] * (len(self._buckets) + 1)
            counts[idx] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value

    def value(self, **labels) -> tuple[int, float]:
        """(count, sum) for one label set — test/debug surface."""
        key = tuple(sorted(labels.items()))
        with self._lock:
            counts = self._counts.get(key)
            return (sum(counts) if counts else 0,
                    self._sums.get(key, 0.0))

    def remove(self, **labels) -> None:
        """Drop one label-set series — the Gauge.remove() contract for
        histograms: a histogram keyed by a dynamic entity (a mesh
        member's submit latency, its audit series) would otherwise
        render its last buckets forever after the entity dies, and a
        frozen bucket matrix reads as a live-but-stalled signal on
        every heatmap."""
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._counts.pop(key, None)
            self._sums.pop(key, None)

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self._kind}"]
        with self._lock:
            snap = {k: list(v) for k, v in self._counts.items()} or \
                {(): [0] * (len(self._buckets) + 1)}
            sums = dict(self._sums)
        for key, counts in snap.items():
            cum = 0
            for bound, c in zip(self._buckets, counts):
                cum += c
                labels = _fmt_labels({**dict(key), "le": _fmt_le(bound)})
                lines.append(f"{self.name}_bucket{labels} {cum}")
            cum += counts[-1]
            labels = _fmt_labels({**dict(key), "le": "+Inf"})
            lines.append(f"{self.name}_bucket{labels} {cum}")
            plain = _fmt_labels(dict(key))
            lines.append(f"{self.name}_sum{plain} {sums.get(key, 0.0)}")
            lines.append(f"{self.name}_count{plain} {cum}")
        return "\n".join(lines)


def _fmt_le(bound: float) -> str:
    """Integral bounds render without the trailing .0 (Prometheus
    convention: le="1000", not le="1000.0")."""
    return str(int(bound)) if bound == int(bound) else str(bound)


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get_or_make(name, lambda: Counter(name, help_), Counter)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get_or_make(name, lambda: Gauge(name, help_), Gauge)

    def summary(self, name: str, help_: str = "", window: int = 1024,
                max_label_sets: int = 64) -> Summary:
        return self._get_or_make(
            name, lambda: Summary(name, help_, window, max_label_sets),
            Summary)

    def histogram(self, name: str, help_: str = "",
                  buckets: tuple = DEFAULT_US_BUCKETS,
                  max_label_sets: int = 64) -> Histogram:
        return self._get_or_make(
            name, lambda: Histogram(name, help_, buckets, max_label_sets),
            Histogram)

    def _get_or_make(self, name, factory, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name} already registered as {type(m).__name__}")
            return m

    def render(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        return "\n".join(m.render() for m in metrics) + "\n"


REGISTRY = MetricsRegistry()
