"""The serving tier's snapshots: the immutable read-side view and its
store.

Counterpart of flow_pipeline_tpu/serve/snapshot.py. A :class:`Snapshot`
is everything a query needs, materialized at publish time: per-family
ranked top rows (already extracted: a ``/query/topk`` is a column slice),
frozen uint64 CMS planes (a ``/query/estimate`` is one
``np_cms_query_u64``), and the newest closed exact-window rows (a
``/query/range`` is a slot filter). Snapshots are IMMUTABLE BY CONTRACT:
the publisher builds fresh host arrays, swaps one reference, and never
touches a published object again, so readers need no lock, just one
attribute load (an attribute read is atomic under the GIL; the swap is
RCU's pointer publish). Nothing here holds a tensor: the publisher
copies card state to the host before it builds a view.
"""

from __future__ import annotations

# Locks: the store's publish side is serialized by _pub_lock; readers
# take NO lock (`current` is one attribute read of an immutable object).
# The range ledger is written from the flusher thread and frozen by the
# publisher under _lock.

import threading
import time
from dataclasses import dataclass, field
from typing import Mapping, Optional, Sequence

import numpy as np

from ..obs import REGISTRY

# Buckets for the query-latency histogram (seconds): cache hits are
# sub-ms; a cold topk/range build or a GC pause pushes toward 100ms.
QUERY_SECONDS_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 1.0,
)

# Closed-window retention in the range ledger, per table: the sinks are
# the durable home of closed rows; the snapshot serves the newest slots
# only.
RANGE_SLOTS = 16

# Metric name and help specs (the reference's, so dashboards resolve
# against the port's /metrics too).
SERVE_METRICS = {
    "queries": ("serve_queries_total",
                "flowserve queries answered (label: endpoint)"),
    "latency": ("serve_query_seconds",
                "flowserve query latency (request parse -> response "
                "written)"),
    "cache_hits": ("serve_cache_hits_total",
                   "flowserve responses served from the (version, "
                   "query) cache"),
    "published": ("serve_snapshots_published_total",
                  "flowserve snapshots published (atomic pointer "
                  "swaps)"),
    "version": ("serve_snapshot_version",
                "version of the currently served snapshot"),
    "timestamp": ("serve_snapshot_timestamp_seconds",
                  "publish wall clock (epoch s) of the currently "
                  "served snapshot — chart time() minus this for live "
                  "age"),
    "age": ("serve_snapshot_age_seconds",
            "age of the served snapshot at the last publish/query "
            "(refreshed per request under load)"),
    "responses": ("serve_responses_total",
                  "flowserve HTTP responses by status code (label: "
                  "code) — the 5xx-rate alert's denominator-free "
                  "signal"),
    "publish_failures": ("serve_publish_failures_total",
                         "mesh snapshot publish attempts that failed "
                         "(flaky member fetch / injected fault) — "
                         "readers keep the previous snapshot"),
}


class FrozenCms:
    """Lazily materialized uint64 CMS planes for one published family.

    Freezing a sketch is megabytes of convert-and-copy per family;
    doing it eagerly on every publish taxes the worker thread for an
    estimate surface most snapshots never serve. The publisher instead
    captures a HOST copy of the planes (the port's CMS updates write
    the card's tensor in place, so a held tensor would change under the
    next batch), and the first ``/query/estimate`` under this snapshot
    pays the f32->u64 freeze ONCE, on a reader thread, memoized under a
    serve-side lock that no worker path takes. The capture is released
    after the freeze (holding both would double the sketch footprint
    for the snapshot's lifetime)."""

    __slots__ = ("_thunk", "_value", "_lock")

    def __init__(self, thunk=None, value: Optional[np.ndarray] = None):
        self._thunk = thunk
        self._value = value
        self._lock = threading.Lock()

    def get(self) -> np.ndarray:
        if self._value is None:
            with self._lock:
                if self._value is None:
                    self._value = self._thunk()
                    # release the captured source planes: holding both
                    # the capture and the frozen copy would double the
                    # sketch footprint for the snapshot's lifetime
                    self._thunk = None
        return self._value


@dataclass(frozen=True)
class FamilyView:
    """One top-K family's frozen read view.

    ``rows`` hold the EXTRACTED ranking at ``depth`` rows — the same
    columns the locked path's ``model.top(k)`` produces, so a k-row
    answer is each column sliced ``[:k]`` (the table is already ranked;
    truncation is exact). ``cms`` is the family's count-min in the
    exact uint64 monoid, lazily frozen (None for dense families, which
    have no sketch — every value is exact already). ``regs`` are a
    spread family's frozen u8 register planes (the exact max-monoid
    canonical form) — what ``/query/spread`` decodes per key; None for
    every other kind."""

    name: str
    kind: str  # "hh" | "dense" | "spread"
    window_start: Optional[int]
    depth: int
    rows: Mapping[str, np.ndarray]
    key_lanes: int  # uint32 key lanes a /query/estimate key must carry
    cms: Optional[FrozenCms]  # -> [P+1, depth, width] uint64
    value_cols: tuple = ()
    regs: Optional[np.ndarray] = None  # spread: [depth, width, m] uint8


@dataclass(frozen=True)
class Snapshot:
    """One immutable published view. ``flows_seen`` is the consumed
    point the snapshot covers (None for a mesh's merged view): the
    freshness token the query API's ``/topk`` compares against the live
    worker before answering lock-free."""

    version: int
    created: float  # publish wall clock (epoch s)
    watermark: float  # newest event time (window end) the view covers
    flows_seen: Optional[int]
    source: str  # "worker" | "mesh"
    families: Mapping[str, FamilyView] = field(default_factory=dict)
    # table -> ((slot, columnar rows), ...) newest-RANGE_SLOTS, ascending
    ranges: Mapping[str, tuple] = field(default_factory=dict)
    # {family: newest JSON-safe sketch-audit report} at publish: what
    # /query/audit serves (empty when -obs.audit=off or nothing has
    # closed yet)
    audit: Mapping[str, dict] = field(default_factory=dict)

    def age(self, now: Optional[float] = None) -> float:
        return max(0.0, (now or time.time()) - self.created)


class RangeLedger:
    """Sink-shaped tap retaining the newest closed exact-window rows.

    Appended to the worker's sink list, it sees every flushed row set on
    the flush path and keeps the last
    :data:`RANGE_SLOTS` window slots per configured table — the data
    ``/query/range`` serves. Rows are stored exactly as the sinks
    received them (late partials append as additional chunks for their
    slot, the sink-merge contract), so the snapshot-served answer is
    bit-exact against what a sink was given for the same slots."""

    def __init__(self, tables: Sequence[str] = (),
                 max_slots: int = RANGE_SLOTS):
        self.tables = set(tables)
        self.max_slots = max_slots
        self._lock = threading.Lock()
        # table -> {slot: [columnar rows chunks]}
        self._slots: dict[str, dict[int, list]] = {}  # guarded by _lock
        # bumps on every retained write: the publisher's "a window
        # closed since the last snapshot" trigger
        self.generation = 0  # guarded by _lock

    def write(self, table: str, rows) -> None:
        """Sink duck type. Splits a multi-window flush by timeslot and
        retains per-slot chunks (newest max_slots slots win)."""
        if table not in self.tables or not isinstance(rows, dict):
            return
        ts = rows.get("timeslot")
        if ts is None or not len(ts):
            return
        with self._lock:
            store = self._slots.setdefault(table, {})
            for slot in np.unique(ts):
                idx = np.flatnonzero(ts == slot)
                chunk = {k: v[idx] for k, v in rows.items()}
                store.setdefault(int(slot), []).append(chunk)
            for old in sorted(store)[:-self.max_slots]:
                del store[old]
            self.generation += 1

    def freeze(self) -> dict[str, tuple]:
        """Immutable {table: ((slot, rows), ...)} copy for a snapshot.
        Per-slot chunks are concatenated once here, at publish time, so
        reads never pay the fold."""
        with self._lock:
            snap = {t: {s: list(chunks) for s, chunks in store.items()}
                    for t, store in self._slots.items()}
        out = {}
        for table, store in snap.items():
            frozen = []
            for slot in sorted(store):
                chunks = store[slot]
                if len(chunks) == 1:
                    rows = dict(chunks[0])
                else:
                    rows = {k: np.concatenate([c[k] for c in chunks])
                            for k in chunks[0]}
                frozen.append((slot, rows))
            out[table] = tuple(frozen)
        return out


class SnapshotStore:
    """The atomic reference the read and write sides share.

    ``current`` is the reader's entire synchronization protocol: one
    attribute load of an immutable snapshot (or None before the first
    publish). ``publish`` stamps the next version, swaps the pointer,
    and updates the serve gauges; publishers are serialized by
    ``_pub_lock`` (the worker thread; never contended on the read
    path)."""

    def __init__(self):
        self._pub_lock = threading.Lock()
        # one-reference RCU swap: written under _pub_lock, read lock-free
        self._current: Optional[Snapshot] = None
        # eager registration: /metrics carries every serve family (as
        # zeros) the moment a store exists
        self.m_queries = REGISTRY.counter(*SERVE_METRICS["queries"])
        self.m_latency = REGISTRY.histogram(
            *SERVE_METRICS["latency"], buckets=QUERY_SECONDS_BUCKETS)
        self.m_cache_hits = REGISTRY.counter(*SERVE_METRICS["cache_hits"])
        self.m_published = REGISTRY.counter(*SERVE_METRICS["published"])
        self.m_version = REGISTRY.gauge(*SERVE_METRICS["version"])
        self.m_timestamp = REGISTRY.gauge(*SERVE_METRICS["timestamp"])
        self.m_age = REGISTRY.gauge(*SERVE_METRICS["age"])
        self.m_responses = REGISTRY.counter(*SERVE_METRICS["responses"])
        self.m_publish_failures = REGISTRY.counter(
            *SERVE_METRICS["publish_failures"])

    @property
    def current(self) -> Optional[Snapshot]:
        return self._current

    def publish(self, *, watermark: float, flows_seen: Optional[int],
                source: str, families: Mapping[str, FamilyView],
                ranges: Mapping[str, tuple],
                audit: Optional[Mapping[str, dict]] = None) -> Snapshot:
        with self._pub_lock:
            prev = self._current
            snap = Snapshot(
                version=(prev.version + 1) if prev else 1,
                created=time.time(),
                watermark=watermark,
                flows_seen=flows_seen,
                source=source,
                families=families,
                ranges=ranges,
                audit=dict(audit) if audit else {},
            )
            self._current = snap  # the RCU publish: one reference swap
        self.m_published.inc()
        self.m_version.set(snap.version)
        self.m_timestamp.set(snap.created)
        self.m_age.set(0.0)
        return snap

    def publish_snapshot(self, snap: Snapshot) -> Optional[Snapshot]:
        """Publish an already-built immutable snapshot, keeping its
        version: the gateway's mirror path (a gateway rebuilds the
        upstream's snapshot and serves it under the upstream's version,
        so answers compare at the same version). Versions are monotone: a
        snapshot at or behind the current one is refused (None), so a
        flapping upstream or a replayed response never moves a reader
        backwards."""
        with self._pub_lock:
            prev = self._current
            if prev is not None and snap.version <= prev.version:
                return None
            self._current = snap  # the RCU publish: one reference swap
        self.m_published.inc()
        self.m_version.set(snap.version)
        self.m_timestamp.set(snap.created)
        self.m_age.set(snap.age())
        return snap

    def adopt_snapshot(self, snap: Snapshot) -> Snapshot:
        """Force-swap to an already-built snapshot even if its version
        runs backwards: the gateway's ``-gateway.adopt-restart`` path,
        where after an upstream restart the operator chose availability
        over monotone reads. ``publish_snapshot`` stays the default."""
        with self._pub_lock:
            self._current = snap  # the RCU publish: one reference swap
        self.m_published.inc()
        self.m_version.set(snap.version)
        self.m_timestamp.set(snap.created)
        self.m_age.set(snap.age())
        return snap

    def observe_query(self, endpoint: str, seconds: float,
                      snap: Optional[Snapshot]) -> None:
        """Per-request metrics hook (the serve server calls it after the
        response is built)."""
        self.m_queries.inc(endpoint=endpoint)
        self.m_latency.observe(seconds)
        if snap is not None:
            self.m_age.set(snap.age())
