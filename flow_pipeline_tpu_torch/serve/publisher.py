"""The serving tier's worker publisher: the write side of the snapshot
swap.

Counterpart of flow_pipeline_tpu/serve/publisher.py for one worker.
:class:`WorkerServePublisher` rides the StreamWorker's batch loop (the
``worker.serve`` hook, called under ``worker.lock`` on the worker thread
after each step's commit): it publishes on the first batch, whenever a
window closed since the last snapshot (a top-K slot advanced, or closed
exact rows reached the range ledger), and at the ``-serve.refresh``
cadence for open-window freshness. Extraction is paid HERE, once per
publish, never per query.

On the card a heavy-hitter family's CMS planes (``[P+1, depth, width]``
float32) live in a tensor that the conservative and linear CMS kernels
update IN PLACE, so a held tensor would change under the next batch:
the capture copies the planes to the host at publish (one card-to-host
copy per family), and the float32 -> uint64 freeze stays lazy (the first
``/query/estimate`` reader pays it). The publisher counts its publishes
and times them, the capture apart (``publishes``, ``publish_seconds``,
``capture_seconds``).

Lock order: the publisher runs under worker.lock and takes only the range
ledger's lock inside it. The READ side takes neither. The mesh's
publisher (``MeshServePublisher``) waits for the mesh's port.
"""

from __future__ import annotations

import logging
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
# (cms, key_lanes, regs) view parts for one live windowed model, found by
# the family registry, so the publisher iterates families without a
# per-kind ladder.


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


def attach_worker(worker, refresh: float = 2.0,
                  store: Optional[SnapshotStore] = None,
                  ) -> WorkerServePublisher:
    """One-call wiring for a standalone worker (the cli path)."""
    return WorkerServePublisher(store, refresh=refresh).attach(worker)
