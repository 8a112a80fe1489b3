"""The serving tier's publishers: the write side of the snapshot swap.

Counterpart of flow_pipeline_tpu/serve/publisher.py. Two publishers share
the store and ledger machinery:

- :class:`WorkerServePublisher` rides the StreamWorker's batch loop (the
``worker.serve`` hook, called under ``worker.lock`` on the worker thread
after each step's commit): it publishes on the first batch, whenever a
window closed since the last snapshot (a top-K slot advanced, or closed
exact rows reached the range ledger), and at the ``-serve.refresh``
cadence for open-window freshness. Extraction is paid HERE, once per
publish, never per query.
- :class:`MeshServePublisher` runs its own thread (``serve-publish``)
  next to the mesh coordinator: a window merge wakes it (the
  coordinator's ``serve`` hook) and the refresh cadence bounds
  open-window staleness between merges. One publish fans out to every
  live member's state provider once per top-K family, merges the
  payloads on the host (mesh/merge.py) and swaps the merged snapshot,
  so all readers share one fan-out round.

On the card a heavy-hitter family's CMS planes (``[P+1, depth, width]``
float32) live in a tensor that the conservative and linear CMS kernels
update IN PLACE, so a held tensor would change under the next batch:
the capture copies the planes to the host at publish (one card-to-host
copy per family), and the float32 -> uint64 freeze stays lazy (the first
``/query/estimate`` reader pays it). In the mesh each member's payload
comes from ``mesh/codec.py capture_model``, which copies the planes to
the host under the member's worker lock, so the merged views work on
host numpy only. Both publishers count their publishes and time them,
the captures apart (``publishes``, ``publish_seconds``,
``capture_seconds``; in the mesh the capture is the members' fan-out).

Lock order: the worker publisher runs under worker.lock and takes only
the range ledger's lock inside it; the mesh publisher takes the
coordinator's locks only inside ``open_window_payloads``,
``commit_watermark`` and ``audit_reports``, released before any member
is asked for its state. The READ side takes none of them.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..engine.windowed import WindowedHeavyHitter
from ..families import registry
from ..models.heavy_hitter import key_width
from ..models.window_agg import WindowAggregator
from .snapshot import FamilyView, FrozenCms, RangeLedger, Snapshot, \
    SnapshotStore

log = logging.getLogger("flow_pipeline_tpu_torch.serve")


# ---- per-family capture hooks (families/registry.py serve_capture) --------
#
# Worker side: (cms, key_lanes, regs) view parts for one live windowed
# model. Mesh side: (rows, cms, key_lanes, regs) for one merged spec, or
# None when no contribution exists yet. Both are found by the family
# registry, so the publishers iterate families without a per-kind ladder.


def host_copy(a) -> np.ndarray:
    """A host numpy copy of a tensor (on any device) or an array: the
    caller may hold it while the source is written in place."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", copy=True).numpy()
    return np.array(a, copy=True)


def hh_view_parts(m: WindowedHeavyHitter):
    from ..hostsketch.state import frozen_cms

    planes = host_copy(m.model.state.cms)
    return FrozenCms(lambda a=planes: frozen_cms(a)), key_width(m.config), \
        None


def spread_view_parts(m: WindowedHeavyHitter):
    from ..models.spread import spread_key_width

    # the update writes the registers in place: the snapshot freezes its
    # own copy (the immutability contract)
    return None, spread_key_width(m.config), host_copy(m.model.state.regs)


def dense_view_parts(m: WindowedHeavyHitter):
    return None, 1, None


def hh_merged_view(spec, slot, payloads):
    from ..mesh import merge as merge_ops

    depth = spec.k or spec.config.capacity
    merged = merge_ops.merge_hh(payloads, spec.config)
    rows = merge_ops.hh_top_rows(merged, spec.config, depth, slot or 0)
    # the merge already materialized the uint64 planes
    return rows, FrozenCms(value=merged["cms"]), key_width(spec.config), \
        None


def spread_merged_view(spec, slot, payloads):
    from ..mesh import merge as merge_ops
    from ..models.spread import spread_key_width

    if not payloads:
        return None
    depth = spec.k or spec.config.capacity
    merged = merge_ops.merge_spread(payloads, spec.config)
    rows = merge_ops.spread_top_rows(merged, spec.config, depth, slot or 0)
    return rows, None, spread_key_width(spec.config), merged["regs"]


def dense_merged_view(spec, slot, payloads):
    from ..mesh import merge as merge_ops

    if not payloads:
        return None
    depth = spec.k or spec.config.capacity
    totals = merge_ops.merge_dense(payloads)
    rows = merge_ops.dense_top_rows(totals, spec.config, depth, slot or 0)
    return rows, None, 1, None


def _family_from_model(name: str, m: WindowedHeavyHitter):
    """Freeze one windowed top-K model into a read view; returns it with
    the seconds its capture hook took. Caller holds worker.lock and has
    synced sketch states; ``top(depth)`` is the SAME extraction the
    locked query path runs, so a k-row answer from the snapshot is the
    locked answer's exact prefix."""
    depth = m.k
    rows = m.model.top(depth)
    fam = registry.family_for_snapshot(m.model.snapshot_kind) \
        or registry.family("dense")
    t0 = time.perf_counter()
    cms, lanes, regs = registry.hook(fam, "serve_capture")(m)
    capture = time.perf_counter() - t0
    return FamilyView(
        name=name, kind=fam.kind,
        window_start=(int(m.current_slot)
                      if m.current_slot is not None else None),
        depth=int(len(rows["valid"])), rows=rows, key_lanes=lanes,
        cms=cms, value_cols=tuple(getattr(m.config, "value_cols", ())),
        regs=regs), capture


class WorkerServePublisher:
    """Publishes a single worker's snapshots from inside its batch loop."""

    def __init__(self, store: Optional[SnapshotStore] = None,
                 refresh: float = 2.0):
        self.store = store or SnapshotStore()
        self.refresh = refresh
        self.ledger = RangeLedger(())
        # worker thread only (on_batch and publish run under worker.lock)
        self._last_slots: dict[str, Optional[int]] = {}
        self._last_gen = -1
        self._last_publish = 0.0
        self.publishes = 0
        self.publish_seconds = 0.0  # wall of every publish, summed
        self.capture_seconds = 0.0  # of which the families' captures

    def attach(self, worker) -> "WorkerServePublisher":
        """Wire into a StreamWorker BEFORE it runs: the range ledger
        becomes one of its sinks (closed exact-window rows flow through
        the normal flush path) and the worker's per-batch hook points
        here."""
        self.ledger.tables |= {
            name for name, m in worker.models.items()
            if isinstance(m, WindowAggregator)}
        worker.sinks.append(self.ledger)
        worker.serve = self
        return self

    # ---- worker hooks (worker.lock held) -----------------------------------

    def on_batch(self, worker) -> None:
        """Per-batch publish decision: first snapshot, any window close
        since the last one, or the refresh cadence coming due."""
        gen = self.ledger.generation
        closed = gen != self._last_gen or any(
            m.current_slot != self._last_slots.get(name)
            for name, m in worker.models.items()
            if isinstance(m, WindowedHeavyHitter))
        if self.store.current is None or closed or (
                self.refresh > 0
                and time.monotonic() - self._last_publish >= self.refresh):
            self.publish(worker)

    def publish(self, worker) -> Snapshot:
        """Build and swap one snapshot. Caller holds worker.lock (the
        worker calls this from its own loop; tests may call it on a
        quiesced worker). An error propagates to the worker's step."""
        t0 = time.perf_counter()
        worker.sync_sketch_states()
        families = {}
        watermark = 0.0
        capture = 0.0
        for name, m in worker.models.items():
            if isinstance(m, WindowedHeavyHitter):
                families[name], seconds = _family_from_model(name, m)
                capture += seconds
                self._last_slots[name] = m.current_slot
                if m.current_slot is not None:
                    watermark = max(watermark, float(m.current_slot))
            elif isinstance(m, WindowAggregator):
                watermark = max(watermark, float(m.watermark))
        self._last_gen = self.ledger.generation
        audit = None
        for _kind, attr in registry.audit_attrs():
            shadow = getattr(worker.fused, attr, None)
            if shadow is not None:
                # family names are distinct model names: a plain merge
                audit = {**(audit or {}), **shadow.last_reports}
        guard = getattr(worker, "guard", None)
        if guard is not None and guard.armed:
            # the guard is never silent: the snapshot records the
            # sampling level its answers were built under, as a reserved
            # pseudo-model key of the audit dict (the delta codec diffs it)
            audit = dict(audit or {})
            audit["flowguard"] = guard.meta()
        snap = self.store.publish(
            watermark=watermark, flows_seen=worker.flows_seen,
            source="worker", families=families,
            ranges=self.ledger.freeze(),
            # the newest per-family close reports ride the snapshot
            # (read under worker.lock here; served lock-free)
            audit=audit)
        self._last_publish = time.monotonic()
        seconds = time.perf_counter() - t0
        self.publishes += 1
        self.publish_seconds += seconds
        self.capture_seconds += capture
        log.debug("serve published v%d (%.1f ms, %d families)",
                  snap.version, seconds * 1e3, len(families))
        return snap


class MeshServePublisher:
    """Publishes the mesh coordinator's MERGED view on its own thread."""

    def __init__(self, coordinator, store: Optional[SnapshotStore] = None,
                 refresh: float = 2.0, err_backoff_base: float = 0.5,
                 err_backoff_max: float = 30.0,
                 err_log_interval: float = 30.0):
        self.coordinator = coordinator
        self.store = store or SnapshotStore()
        self.refresh = refresh
        # failure-path discipline: exponential backoff between failed
        # publishes (a flapping member must not drive a retry, and a
        # logged traceback, every wake) and a rate limit on the
        # traceback; serve_publish_failures_total counts every failure
        self.err_backoff_base = err_backoff_base
        self.err_backoff_max = err_backoff_max
        self.err_log_interval = err_log_interval
        # publisher thread only (or the caller of publish_now in tests)
        self._fail_streak = 0
        self._last_err_log = 0.0
        self.publishes = 0
        self.publish_seconds = 0.0  # wall of every publish, summed
        self.capture_seconds = 0.0  # of which the members' fan-out
        self.ledger = RangeLedger(())
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def attach(self) -> "MeshServePublisher":
        """Wire into the coordinator BEFORE members join: merged exact
        rows reach the range ledger through the coordinator's sink list;
        a completed merge wakes the publisher thread."""
        self.ledger.tables |= {s.name for s in self.coordinator.specs
                               if not registry.family(s.kind).ranked}
        self.coordinator.sinks.append(self.ledger)
        self.coordinator.serve = self
        return self

    def on_merge(self) -> None:
        """Coordinator hook (runs on the submitting member's thread, no
        coordinator lock held): schedule a publish; the fan-out runs on
        the publisher's thread, never on a member's submit path."""
        self._wake.set()

    # ---- publisher thread --------------------------------------------------

    def start(self) -> "MeshServePublisher":
        self._thread = threading.Thread(
            target=self._run, name="serve-publish", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.publish_now()
                self._fail_streak = 0
            except Exception as e:  # noqa: BLE001 -- serving must outlive a flaky member fetch
                self._on_publish_error(e)
                # the backoff honours the failure streak and IGNORES
                # merge wakes: a flapping member must not turn every
                # merge into an immediate doomed retry
                self._stop.wait(self._error_backoff())
                continue
            self._wake.wait(self.refresh if self.refresh > 0 else None)
            self._wake.clear()

    def _on_publish_error(self, exc: BaseException) -> None:
        """Count and rate-limit one failed publish. Readers keep the
        previous snapshot; the counter and the backoff are the operator
        signal, not a log flood."""
        self._fail_streak += 1
        self.store.m_publish_failures.inc()
        now = time.monotonic()
        if now - self._last_err_log >= self.err_log_interval:
            self._last_err_log = now
            log.exception("serve mesh publish failed (streak %d); "
                          "backing off %.1fs between retries "
                          "(serve_publish_failures_total counts the "
                          "suppressed repeats)",
                          self._fail_streak, self._error_backoff())
        else:
            log.debug("serve mesh publish failed (streak %d): %s",
                      self._fail_streak, exc)

    def _error_backoff(self) -> float:
        """Exponential in the failure streak, floored at the refresh
        cadence, capped at err_backoff_max."""
        base = max(self.err_backoff_base,
                   self.refresh if self.refresh > 0 else 0.0)
        return min(self.err_backoff_max,
                   base * (2 ** max(0, self._fail_streak - 1)))

    def publish_now(self) -> Snapshot:
        """One fan-out PER TOP-K FAMILY (the provider protocol is per
        model), then merge, extract and swap, paid once for every reader
        until the next publish."""
        from ..utils.faults import FAULTS

        if FAULTS.active:  # a failed fan-out or publish: readers keep
            # the previous snapshot, the error path counts and backs off
            FAULTS.check("serve.publish")

        t0 = time.perf_counter()
        capture = 0.0
        coord = self.coordinator
        families = {}
        for spec in coord.specs:
            fam = registry.family(spec.kind)
            merged_view = registry.hook(fam, "serve_capture_merged")
            if merged_view is None:
                continue  # wagg: exact rows ride the range ledger
            t1 = time.perf_counter()
            slot, payloads = coord.open_window_payloads(spec.name)
            capture += time.perf_counter() - t1
            parts = merged_view(spec, slot, payloads)
            if parts is None:
                continue
            rows, cms, lanes, regs = parts
            families[spec.name] = FamilyView(
                name=spec.name, kind=spec.kind, window_start=slot,
                depth=int(len(rows["valid"])), rows=rows,
                key_lanes=lanes, cms=cms,
                value_cols=tuple(getattr(spec.config, "value_cols", ())),
                regs=regs)
        snap = self.store.publish(
            watermark=float(coord.commit_watermark()), flows_seen=None,
            source="mesh", families=families, ranges=self.ledger.freeze(),
            # the coordinator's network-wide audit reports (merged cohort
            # against the merged sketch, refreshed at merge time)
            audit=coord.audit_reports())
        seconds = time.perf_counter() - t0
        self.publishes += 1
        self.publish_seconds += seconds
        self.capture_seconds += capture
        log.debug("serve mesh published v%d (%.1f ms, %d families)",
                  snap.version, seconds * 1e3, len(families))
        return snap


def attach_worker(worker, refresh: float = 2.0,
                  store: Optional[SnapshotStore] = None,
                  ) -> WorkerServePublisher:
    """One-call wiring for a standalone worker (the cli path)."""
    return WorkerServePublisher(store, refresh=refresh).attach(worker)


def attach_mesh(coordinator, refresh: float = 2.0,
                store: Optional[SnapshotStore] = None,
                start: bool = True) -> MeshServePublisher:
    """One-call wiring for a mesh coordinator (the cli path). ``start``
    launches the publisher thread; tests pass False and drive
    ``publish_now`` by hand."""
    pub = MeshServePublisher(coordinator, store, refresh=refresh).attach()
    if start:
        pub.start()
    return pub
