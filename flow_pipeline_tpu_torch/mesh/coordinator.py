"""The mesh coordinator: membership, epoch-fenced partition ownership
and the window-close merge barrier.

Counterpart of flow_pipeline_tpu/mesh/coordinator.py; on the same calls
it emits the same rows and writes the same journal. It owns the offset
frontier of every bus partition and merges the members' window state
into the network-wide result (mesh/merge.py), on the host:

- **Membership**: members join, then heartbeat through ``sync()``. A
  member that misses ``heartbeat_timeout`` is fenced; its partitions are
  released and the target assignment recomputed (epoch + 1). ``fence()``
  is the same path on demand.
- **Ownership**: partitions go round-robin over the sorted live member
  ids. A member whose owned set differs from its target is told to
  RESYNC: it submits all of its state with ``release``, drops its
  worker and takes its target set, always from the ``covered`` frontier.
- **Exactness**: a submission carries, per owned partition, the offset
  range consumed since its last accepted submission and the state of
  every window those rows touched (closed windows as final
  contributions, the open window as a replaceable CARRY). A range must
  extend the frontier exactly; a dead member's submissions are refused,
  so its successor replays what was never accepted. A window (model,
  slot) merges once every partition's watermark passes slot + window
  (+ lateness) or is final.

With a journal (mesh/journal.py) every accepted submission, fence, epoch
bump and merged window is durable, and a restarted coordinator recovers
its frontier, carries and ledger from it.
"""

from __future__ import annotations


import logging
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

from ..families import registry
from ..obs.audit import audit_report, publish_report
from ..obs.families import publish_build_info, register_audit_metrics
from ..obs.metrics import REGISTRY
from ..obs.trace import TRACER
from . import codec

log = logging.getLogger("flow_pipeline_tpu_torch.mesh")

# Buckets for the window-merge wall-time histogram (seconds): sub-ms
# in-process folds up to multi-second cross-network merges.
MERGE_SECONDS_BUCKETS = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

# Buckets for the meshscope SLO latencies (seconds): barrier waits and
# submit->merge intervals span "every shard already past the close"
# (ms) to "one shard stalled most of a window" (minutes).
BARRIER_SECONDS_BUCKETS = (
    0.01, 0.05, 0.25, 1.0, 5.0, 15.0, 60.0, 300.0, 900.0, 3600.0,
)

# Buckets for rebalance durations (trigger -> every partition owned
# again): in-process handoffs are ms; cross-process ones ride the
# heartbeat cadence.
REBALANCE_SECONDS_BUCKETS = (
    0.01, 0.05, 0.25, 1.0, 2.5, 5.0, 15.0, 60.0, 300.0,
)

# Merged-rows ledger retention, per model: the newest slots kept for
# queries/tests/debugging. The SINKS are the durable home of merged
# output; an unbounded ledger on an endless stream is a slow OOM
# (days of 5-minute windows accumulate every historical row set).
MERGED_LEDGER_SLOTS = 16

# Lineage-ledger retention, per model (same discipline as the merged
# ledger, looser bound: a lineage record is a few hundred bytes of
# metadata, not row sets, so more history fits the same budget).
LINEAGE_SLOTS = 64

# Merged-audit-cohort retention, per model (sketchwatch): the newest
# slots' merged sampled-exact counters, kept for the mesh-vs-oracle
# bit-equality gate and /query/audit debugging. Cohorts are ~1/256 of
# keys — small, but still bounded like every other ledger here.
AUDIT_LEDGER_SLOTS = 16

# Metric name/help specs live here once; the deploy honesty test
# resolves the Grafana mesh panels against a constructed coordinator.
MESH_METRICS = {
    "members": ("mesh_members", "live flowmesh members"),
    "epoch": ("mesh_epoch", "current flowmesh assignment epoch"),
    "partitions": ("mesh_partitions", "bus partitions under mesh control"),
    "rebalance": ("mesh_rebalance_total",
                  "mesh rebalances (label: reason=join|leave|death)"),
    "merged": ("mesh_windows_merged_total",
               "windows merged network-wide (label: model)"),
    "merge_s": ("mesh_merge_seconds",
                "window-close merge wall time (decode+fold+extract)"),
    "flows": ("mesh_member_flows_total",
              "flows ingested per member (label: member)"),
    "submit": ("mesh_submit_total", "accepted member submissions"),
    "rejected": ("mesh_submit_rejected_total",
                 "rejected member submissions (label: reason)"),
    "late": ("mesh_late_contribution_total",
             "contributions that arrived after their window merged "
             "(label: model)"),
    # meshscope SLO families: mesh-wide freshness + merge-path
    # latency decomposition
    "commit_wm": ("mesh_commit_watermark_seconds",
                  "mesh-wide event-time watermark: min over live "
                  "members' reported watermarks"),
    "member_wm": ("mesh_member_watermark_seconds",
                  "per-member event-time watermark (label: member)"),
    "wm_skew": ("mesh_watermark_skew_seconds",
                "per-member watermark lag behind the mesh leader "
                "(label: member) — the stalled-shard signal"),
    "barrier_s": ("mesh_barrier_wait_seconds",
                  "window first-contribution -> barrier-release wait"),
    "sub2merge_s": ("mesh_submit_to_merge_seconds",
                    "contribution accept -> network-wide merge latency"),
    "rebalance_s": ("mesh_rebalance_duration_seconds",
                    "rebalance trigger -> every partition owned again "
                    "(label: reason)"),
    # flowchaos journal families: write-ahead durability health.
    # Registered eagerly like every other mesh family so the dashboard/
    # alert honesty tests resolve them against a constructed coordinator
    # whether or not a journal is configured.
    "journal_records": ("mesh_journal_records_total",
                        "coordinator WAL records appended (label: kind="
                        "sub|fence|epoch|merged)"),
    "journal_unsynced": ("mesh_journal_unsynced_records",
                         "journal records appended but not yet fsynced "
                         "(group commit drains this to 0 at every ack)"),
    "journal_lag": ("mesh_journal_lag_seconds",
                    "age of the oldest unfsynced journal record "
                    "(0 = clean; sustained > 0 means acks are running "
                    "ahead of durability)"),
    "journal_bytes": ("mesh_journal_bytes",
                      "coordinator WAL file size on disk — compaction "
                      "(checkpoint + truncate at merged-window "
                      "boundaries) is what keeps this bounded at "
                      "production cadence"),
}

# Which MESH_METRICS keys register as what (everything else: counter).
_MESH_GAUGES = frozenset(
    {"members", "epoch", "partitions", "commit_wm", "member_wm",
     "wm_skew", "journal_unsynced", "journal_lag", "journal_bytes"})
_MESH_HISTOGRAMS = {
    "merge_s": MERGE_SECONDS_BUCKETS,
    "barrier_s": BARRIER_SECONDS_BUCKETS,
    "sub2merge_s": BARRIER_SECONDS_BUCKETS,
    "rebalance_s": REBALANCE_SECONDS_BUCKETS,
}


@dataclass(frozen=True)
class ModelSpec:
    """One mergeable model: name, kind tag, frozen config, extraction k,
    window cadence. Built from a worker's models dict so the coordinator
    merges exactly what the members compute."""

    name: str
    kind: str  # "wagg" | "hh" | "dense" | "spread"
    config: Any
    k: int
    window_seconds: int
    allowed_lateness: int = 0


def spec_from_models(models: dict) -> tuple[ModelSpec, ...]:
    """Derive the mergeable model specs from a models dict (the same
    dict cli._build_models produces). DDoS detectors are deliberately
    absent: their per-dst rates are split across shards by the key
    hash, so mesh mode keeps detection per-shard (the HashPipe model —
    per-shard detection) and alerts flow through member sinks."""
    from ..engine.windowed import WindowedHeavyHitter
    from ..models.window_agg import WindowAggregator

    out = []
    for name, m in models.items():
        if isinstance(m, WindowAggregator):
            out.append(ModelSpec(
                name, "wagg", m.config, 0, m.config.window_seconds,
                m.config.allowed_lateness))
        elif isinstance(m, WindowedHeavyHitter):
            fam = registry.family_for_snapshot(m.model.snapshot_kind)
            kind = fam.kind if fam is not None else "dense"
            out.append(ModelSpec(name, kind, m.config, m.k,
                                 m.window_seconds))
    return tuple(out)


class _Member:
    __slots__ = ("alive", "last_hb", "owned", "provider", "clock_offset",
                 "clock_rtt", "watermark", "last_sub")

    def __init__(self, provider=None):
        self.alive = True
        self.last_hb = 0.0
        self.owned: set[int] = set()
        # newest accepted submission id (span.sub) from this incarnation
        # — the lost-ack retry dedupe key. 0 = nothing accepted yet
        # (member ids are minted from 1); a rejoin builds a fresh
        # _Member, and a member object's _sub_seq is monotone across its
        # own rejoins, so ids never run backwards within an incarnation.
        self.last_sub = 0
        self.provider = provider  # callable(model) -> payload
        # member_clock - coordinator_clock, heartbeat-estimated (NTP
        # midpoint, min-RTT sample; mesh/scope.py); None until the
        # member's first clock report
        self.clock_offset: Optional[float] = None
        self.clock_rtt: float = 0.0
        # newest event-time watermark this member reported
        self.watermark: int = 0


class MeshCoordinator:
    """Coordinator and merge engine. Members call it directly in
    process (mesh/runtime.py); its methods are the protocol a remote
    coordinator would serve."""

    def __init__(self, specs: Sequence[ModelSpec], n_partitions: int,
                 sinks: Sequence[Any] = (),
                 heartbeat_timeout: float = 5.0,
                 time_fn: Callable[[], float] = time.monotonic,
                 journal: Optional[str] = None,
                 journal_compact_bytes: int = 64 << 20):
        self.specs = tuple(specs)
        self._by_name = {s.name: s for s in self.specs}
        self.n_partitions = int(n_partitions)
        self.sinks = list(sinks)
        self.heartbeat_timeout = heartbeat_timeout
        self._time = time_fn
        self._lock = threading.Lock()
        self._merge_lock = threading.Lock()
        self.epoch = 0
        self._members: dict[str, _Member] = {}
        self._targets: dict[str, set[int]] = {}
        self._released: set[int] = set(range(self.n_partitions))
        self._covered = [0] * self.n_partitions
        self._wm = [0] * self.n_partitions
        self._final = [False] * self.n_partitions
        # (model, slot) -> list of decoded payloads awaiting the barrier
        self._pending: dict[tuple[str, int], list] = {}
        # member -> latest open-window state {slot: {model: payload}};
        # replaced on every accepted submission, promoted on death
        self._carry: dict[str, dict] = {}
        self._merged_keys: set[tuple[str, int]] = set()
        # windows popped off the barrier but not yet emitted+journaled:
        # _pop_ready_locked marks a window merged BEFORE the lock-free
        # merge/sink-emit runs, so a checkpoint taken in that gap would
        # record it merged while its rows exist nowhere durable —
        # compaction defers while this is non-empty
        self._inflight_keys: set[tuple[str, int]] = set()
        # (model, slot) -> [rows emitted] (late wagg partials append)
        self.merged: dict[tuple[str, int], list] = {}
        # meshscope lineage ledger: per (model, slot), who contributed
        # what and when. Pending records ride the merge barrier next to
        # _pending; merged records move to _lineage_done (retention-
        # bounded like the merged-rows ledger — LINEAGE_SLOTS). Late
        # annotations that land in the pop->seal gap (the merge runs
        # lock-free between them) buffer in _lineage_orphans until the
        # seal drains them.
        self._lineage_pending: dict[tuple[str, int], dict] = {}
        self._lineage_done: dict[tuple[str, int], dict] = {}
        self._lineage_orphans: dict[tuple[str, int], list] = {}
        # rebalance-duration timeline: (wall t0, reason) of the oldest
        # unsettled rebalance; cleared when every live member owns
        # exactly its target set again
        self._rebalance_start: Optional[tuple[float, str]] = None
        # eager registration: /metrics carries every mesh family (as
        # zeros) the moment a coordinator exists — the dashboard honesty
        # test resolves the mesh panels against this surface
        self._m = {k: (REGISTRY.histogram(*v,
                                          buckets=_MESH_HISTOGRAMS[k])
                       if k in _MESH_HISTOGRAMS
                       else REGISTRY.gauge(*v) if k in _MESH_GAUGES
                       else REGISTRY.counter(*v))
                   for k, v in MESH_METRICS.items()}
        self._m["partitions"].set(self.n_partitions)
        self._m["members"].set(0)
        self._m["epoch"].set(0)
        # sketchwatch: merged-cohort audit state. Metrics registered
        # eagerly (the coordinator process publishes the NETWORK-WIDE
        # sketch_* families; members keep their own processes' series).
        self._audit_m = register_audit_metrics()
        # (model, slot) -> merged audit partial {keys, vals, evictions}
        self.audit_merged: dict[tuple[str, int], dict] = {}
        # model -> newest JSON-safe network-wide audit report
        self._audit_reports: dict[str, dict] = {}
        # the hh_sketch label reflects the family the mesh MERGES —
        # dashboards must be able to tell which sketch produced the
        # network-wide series (bench artifacts join against it)
        hh_modes = {getattr(s.config, "hh_sketch", "table")
                    for s in self.specs if s.kind == "hh"}
        from ..engine.worker import _native_caps

        publish_build_info(
            native=_native_caps(), role="coordinator",
            hh_sketch=("none" if not hh_modes
                       else "table" if hh_modes == {"table"}
                       else "invertible" if hh_modes == {"invertible"}
                       else "mixed"))
        # flowchaos write-ahead journal (-mesh.journal=<dir>): accepted
        # submissions, fences, epoch bumps and merged-window keys become
        # durable; a restarted coordinator recovers its frontier/epoch/
        # ledger from them (mesh/journal.py states the contract).
        self._journal = None
        # compaction trigger: checkpoint + truncate once the WAL
        # crosses this size, checked at merged-window boundaries (the
        # point where carries/subs become provably superseded). 0
        # disables the automatic trigger; compact_journal() stays
        # callable either way.
        self.journal_compact_bytes = int(journal_compact_bytes)
        if journal:
            from .journal import CoordinatorJournal

            self._journal = CoordinatorJournal(journal, metrics={
                "records": self._m["journal_records"],
                "unsynced": self._m["journal_unsynced"],
                "lag": self._m["journal_lag"],
                "bytes": self._m["journal_bytes"],
            })
            with self._lock:
                ready = self._recover_locked()
            self._journal.sync()
            if ready:
                self._run_merges(ready)

    # ---- membership -------------------------------------------------------

    def join(self, member_id: str, provider=None) -> dict:
        """Register (or re-register) a member. Returns {"epoch": e}.
        A rejoin under an id that still owns partitions is treated as
        death-then-join: the old incarnation's carry is promoted and its
        partitions released (it crashed and came back before expiry)."""
        fenced = False
        with self._lock:
            old = self._members.get(member_id)
            fold = []
            if old is not None and (old.owned or old.alive):
                # fencing can complete a merge barrier (the promoted
                # carry may be the last missing contribution) — the
                # ready list must reach _run_merges or those windows
                # are popped and silently lost
                fold = self._fence_locked(member_id, "rejoin")
                fenced = True
            self._members[member_id] = m = _Member(provider)
            m.last_hb = self._time()
            self._rebalance_locked("join")
            epoch = self.epoch
        if self._journal is not None:
            self._journal.sync()
        if fold:
            self._run_merges(fold)
        if fenced:
            # crash-restart before expiry: the old incarnation died
            # without a dump — leave the flight-recorder breadcrumb
            # the post-mortem needs (same contract as a worker error)
            self._dump_flight(f"member {member_id} rejoined while "
                              "fenced-alive (crash-restart)")
        return {"epoch": epoch}

    def leave(self, member_id: str) -> None:
        """Graceful leave (after a release/final submission). A member
        leaving while still owning non-final partitions is fenced
        instead — its carry must be promoted and the partitions
        reassigned; finished (final) partitions just release."""
        fold = []
        with self._lock:
            m = self._members.get(member_id)
            if m is None:
                return
            if m.owned and not all(self._final[p] for p in m.owned):
                fold = self._fence_locked(member_id, "leave")
            else:
                self._released |= m.owned
                m.owned = set()
                m.alive = False
                self._carry.pop(member_id, None)
                self._rebalance_locked("leave")
                # same stale-series discipline as the fence path: a
                # departed laggard's frozen skew must not keep paging
                self._m["member_wm"].remove(member=member_id)
                self._m["wm_skew"].remove(member=member_id)
                self._m["sub2merge_s"].remove(member=member_id)
                self._publish_watermarks_locked()
        if self._journal is not None:
            self._journal.sync()
        if fold:
            self._run_merges(fold)

    def fence(self, member_id: str) -> None:
        """Declare a member dead NOW (admin surface; the heartbeat
        timeout calls the same path). Its carry is promoted, partitions
        released, and any later submission from it rejected."""
        fold = []
        fenced = False
        with self._lock:
            m = self._members.get(member_id)
            fenced = m is not None and (m.alive or bool(m.owned))
            fold = self._fence_locked(member_id, "death")
        if self._journal is not None:
            self._journal.sync()
        if fold:
            self._run_merges(fold)
        if fenced:
            self._dump_flight(f"member {member_id} fenced")

    def expire(self, now: Optional[float] = None) -> list[str]:
        """Fence every member whose heartbeat lapsed; returns their ids."""
        now = self._time() if now is None else now
        dead = []
        fold = []
        with self._lock:
            for mid, m in list(self._members.items()):
                if m.alive and now - m.last_hb > self.heartbeat_timeout:
                    fold.extend(self._fence_locked(mid, "death") or [])
                    dead.append(mid)
        if dead and self._journal is not None:
            self._journal.sync()
        if fold:
            self._run_merges(fold)
        if dead:
            self._dump_flight(
                f"member(s) {', '.join(dead)} expired (heartbeat)")
        return dead

    def _fence_locked(self, member_id: str, reason: str):
        """Death path (caller holds _lock): promote carry into pending,
        release partitions, rebalance. Returns ready merges to run."""
        m = self._members.get(member_id)
        if m is None:
            return []
        now = time.time()
        m.alive = False
        self._released |= m.owned
        m.owned = set()
        if self._journal is not None:
            # the fence (and the carry promotion it implies) must replay
            # at this exact point in the record order, or a recovered
            # coordinator would promote an already-promoted carry twice
            self._journal.append("fence", {"member": member_id})
        carry = self._carry.pop(member_id, None)
        TRACER.record("mesh_fence", now, time.time(), member=member_id,
                      reason=reason, promoted=bool(carry))
        if carry:
            span = carry.get("span") or {}
            windows = carry.get("windows", {})
            self._fold_windows_locked(
                windows, member=member_id, span=span,
                ranges=carry.get("ranges"), accepted=now,
                kind="carry-promoted")
            TRACER.record("mesh_carry_promotion", now, time.time(),
                          member=member_id, sub=span.get("sub"),
                          slots=sorted(int(s) for s in windows))
        self._rebalance_locked(reason)
        # the mesh watermark/skew must re-derive over the LIVE set —
        # a dead laggard no longer holds the min down — and the dead
        # member's own series must go away, or its frozen last skew
        # reads as an eternally stalled shard on the dashboards
        self._m["member_wm"].remove(member=member_id)
        self._m["wm_skew"].remove(member=member_id)
        self._m["sub2merge_s"].remove(member=member_id)
        self._publish_watermarks_locked()
        log.warning("mesh member %s fenced (%s); epoch now %d",
                    member_id, reason, self.epoch)
        return self._pop_ready_locked()

    def _rebalance_locked(self, reason: str) -> None:
        self.epoch += 1
        if self._journal is not None:
            self._journal.append("epoch", {"epoch": self.epoch,
                                           "reason": reason})
        live = sorted(mid for mid, m in self._members.items() if m.alive)
        self._targets = {mid: set() for mid in live}
        for p in range(self.n_partitions):
            if live:
                self._targets[live[p % len(live)]].add(p)
        self._m["rebalance"].inc(reason=reason)
        self._m["members"].set(len(live))
        self._m["epoch"].set(self.epoch)
        # rebalance-duration timeline: the clock starts at the FIRST
        # unsettled trigger and keeps its original reason if another
        # rebalance lands mid-flight (the duration then measures the
        # whole disturbance, which is what an operator pages on)
        if self._rebalance_start is None:
            self._rebalance_start = (time.time(), reason)
        self._check_rebalance_settled_locked()

    def _check_rebalance_settled_locked(self) -> None:
        """Close the rebalance timeline once every live member owns
        exactly its target set (and every partition is owned)."""
        if self._rebalance_start is None:
            return
        live = [(mid, m) for mid, m in self._members.items() if m.alive]
        if not live:
            return
        owned = sum(len(m.owned) for _, m in live)
        if owned != self.n_partitions:
            return
        if any(m.owned != self._targets.get(mid, set())
               for mid, m in live):
            return
        t0, reason = self._rebalance_start
        self._rebalance_start = None
        now = time.time()
        self._m["rebalance_s"].observe(now - t0, reason=reason)
        TRACER.record("mesh_rebalance", t0, now, reason=reason,
                      epoch=self.epoch)

    def _dump_flight(self, why: str) -> None:
        """Flight-recorder dump on a coordinator-side death/zombie event
        (fence, expiry, crash-restart rejoin, rejected submission): the
        member that died cannot leave its own breadcrumb, so the
        coordinator's ring — which holds the protocol spans around the
        event, including the rejected submission's span context — is
        the post-mortem. Never raises; no-op when tracing is off."""
        path = TRACER.dump_on_error("coordinator")
        if path:
            log.warning("meshscope: %s; flight recorder dumped to %s",
                        why, path)

    # ---- journal recovery (flowchaos) -------------------------------------

    def _recover_locked(self):
        """Rebuild frontier/epoch/pending/carries/merged-keys by
        replaying the journal through the live fold paths (caller holds
        _lock; runs once, from __init__). Returns the ready merges to
        run lock-free: windows whose barrier had passed but whose
        ``merged`` record never landed re-merge and re-emit here."""
        n = 0
        for kind, meta, blob in self._journal.replay():
            n += 1
            if kind == "chk":
                # a compaction checkpoint: the full recoverable state
                # at the moment of compaction — everything before it
                # was folded in; later records replay on top
                self._restore_checkpoint_locked(codec.decode(blob))
            elif kind == "sub":
                self._replay_submission_locked(meta["member"],
                                               codec.decode(blob))
            elif kind == "fence":
                self._replay_fence_locked(meta["member"])
            elif kind == "epoch":
                if int(meta["epoch"]) > self.epoch:
                    self.epoch = int(meta["epoch"])
            elif kind == "merged":
                # merged AND emitted pre-crash: its contributions must
                # not re-emit — pop them; the key stays remembered so
                # late contributions for it keep registering late
                key = (meta["model"], int(meta["slot"]))
                self._pending.pop(key, None)
                self._lineage_pending.pop(key, None)
                self._merged_keys.add(key)
        if n == 0:
            return []
        # the old incarnation's members are all presumed dead: promote
        # every remaining carry (journaling those fences so a SECOND
        # crash replays identically) and bump the epoch. The members
        # themselves are simply unknown to this incarnation — their next
        # sync gets ``rejoin``, they abandon un-acked state and replay
        # from the recovered frontier: the same zombie/rejoin machinery
        # (and the same exactness argument) as a worker death.
        for member in sorted(self._carry):
            self._journal.append("fence", {"member": member})
            self._replay_fence_locked(member)
        self.epoch += 1
        self._journal.append("epoch", {"epoch": self.epoch,
                                       "reason": "recovery"})
        self._m["epoch"].set(self.epoch)
        log.warning("mesh coordinator recovered from journal: %d "
                    "records, epoch now %d, frontier %s",
                    n, self.epoch, self._covered)
        return self._pop_ready_locked()

    def _replay_submission_locked(self, member: str, payload: dict) -> None:
        """One journaled accepted submission, re-applied. Mirrors
        ``_accept_locked`` minus membership/metrics: ranges were
        validated before the record was written, and a submission's
        ranges cover exactly its owned set."""
        span = payload.get("span") or {}
        ranges = {int(p): [int(r[0]), int(r[1])]
                  for p, r in payload.get("ranges", {}).items()}
        for p, rng in ranges.items():
            if rng[1] > self._covered[p]:
                self._covered[p] = rng[1]
        wm = int(payload.get("watermark", 0))
        for p in ranges:
            if wm > self._wm[p]:
                self._wm[p] = wm
        self._fold_windows_locked(payload.get("closed", {}),
                                  member=member, span=span, ranges=ranges,
                                  kind="closed")
        open_windows = payload.get("open", {})
        if payload.get("release") or payload.get("final"):
            self._fold_windows_locked(open_windows, member=member,
                                      span=span, ranges=ranges,
                                      kind="final-open")
            self._carry.pop(member, None)
        else:
            self._carry[member] = {"windows": open_windows,
                                   "span": span, "ranges": ranges}
        if payload.get("final"):
            for p in ranges:
                self._final[p] = True

    def _checkpoint_state_locked(self) -> dict:
        """The journal-compaction checkpoint: exactly the state
        ``_recover_locked`` rebuilds by replay — the offset frontier,
        watermarks, finality, epoch, the CURRENT carries (every
        superseded carry envelope is dropped here: this is the 379
        MB -> small lever), the pending barrier contributions, and the
        merged-window keys late detection needs. Lineage/metrics are
        deliberately NOT durable (same contract as uncompacted replay,
        which never rebuilt them either)."""
        return {
            "v": 1,
            "epoch": int(self.epoch),
            "covered": [int(x) for x in self._covered],
            "wm": [int(x) for x in self._wm],
            "final": [bool(x) for x in self._final],
            "carry": self._carry,
            "pending": self._pending,
            "merged_keys": sorted([list(k) for k in self._merged_keys]),
        }

    def _restore_checkpoint_locked(self, state: dict) -> None:
        self._covered = [int(x) for x in state["covered"]]
        self._wm = [int(x) for x in state["wm"]]
        self._final = [bool(x) for x in state["final"]]
        if int(state["epoch"]) > self.epoch:
            self.epoch = int(state["epoch"])
        self._carry = {m: dict(c) for m, c in state["carry"].items()}
        self._pending = {(str(k[0]), int(k[1])): list(v)
                         for k, v in state["pending"].items()}
        self._merged_keys = {(str(m), int(s))
                             for m, s in state["merged_keys"]}

    def compact_journal(self) -> bool:
        """Checkpoint + truncate the WAL now.
        Runs under the coordinator lock so no append can race into the
        about-to-be-replaced file; the journal swap is atomic and
        fsynced (mesh/journal.py states the crash-safety argument).
        Returns whether a compaction ran — it DEFERS (False) while any
        window is popped-but-unemitted on another submit thread: such a
        window is already in ``_merged_keys`` but its rows are in no
        sink and its ``merged`` record unwritten, so a checkpoint taken
        now would truncate the ``sub`` records recovery needs to
        re-merge it (the trigger simply fires again at the next merge
        boundary)."""
        if self._journal is None:
            return False
        with self._lock:
            if self._inflight_keys:
                return False
            state = self._checkpoint_state_locked()
            self._journal.compact({"epoch": int(self.epoch)},
                                  codec.encode(state))
        return True

    def _maybe_compact(self) -> None:
        """Merged-window-boundary compaction trigger: every superseded
        carry/sub envelope up to this barrier is now dead weight, so
        once the WAL crosses the size threshold, fold it into one
        checkpoint record."""
        if self._journal is None or self.journal_compact_bytes <= 0:
            return
        if self._journal.size_bytes() >= self.journal_compact_bytes:
            self.compact_journal()

    def _replay_fence_locked(self, member: str) -> None:
        """One journaled fence, re-applied: promote the member's carry
        into the pending barrier exactly as ``_fence_locked`` did live."""
        carry = self._carry.pop(member, None)
        if carry:
            self._fold_windows_locked(
                carry.get("windows", {}), member=member,
                span=carry.get("span") or {},
                ranges=carry.get("ranges"), kind="carry-promoted")

    def close(self) -> None:
        """Release the journal (final fsync + file close). The
        coordinator has no other owned resources; safe to call twice."""
        if self._journal is not None:
            self._journal.close()

    # ---- heartbeat / assignment ------------------------------------------

    def sync(self, member_id: str, clock: Optional[dict] = None) -> dict:
        """Heartbeat + assignment poll. Actions:

        - ``run``    : keep going; ``assign`` carries {partition: resume
                       offset} when ownership was (re)granted this call
        - ``resync`` : owned != target — submit all state with
                       ``release=True``, then sync again to re-acquire
        - ``wait``   : target partitions not yet released by previous
                       owners — idle and sync again
        - ``rejoin`` : unknown or fenced — abandon un-submitted state
                       (the successor replays it) and join() fresh

        ``clock`` is the member's heartbeat-estimated clock report
        ({"offset": coordinator-member s, "rtt": s}, mesh/scope.py);
        every response carries ``now`` (this coordinator's wall clock)
        so the member can keep estimating. Both are what lets
        ``/debug/trace`` emit ONE clock-aligned mesh trace."""
        self.expire()
        now_wall = time.time()
        with self._lock:
            m = self._members.get(member_id)
            if m is None or not m.alive:
                return {"epoch": self.epoch, "action": "rejoin",
                        "assign": None, "now": now_wall}
            m.last_hb = self._time()
            if clock:
                # the member measured coordinator_clock - member_clock;
                # the aggregator wants member - coordinator
                m.clock_offset = -float(clock.get("offset", 0.0))
                m.clock_rtt = float(clock.get("rtt", 0.0))
            target = self._targets.get(member_id, set())
            if m.owned:
                if m.owned == target:
                    return {"epoch": self.epoch, "action": "run",
                            "assign": None, "now": now_wall}
                return {"epoch": self.epoch, "action": "resync",
                        "assign": None, "now": now_wall}
            if target and not (target <= self._released):
                return {"epoch": self.epoch, "action": "wait",
                        "assign": None, "now": now_wall}
            # acquire the full target set atomically (possibly empty:
            # more members than partitions -> this member idles)
            m.owned = set(target)
            self._released -= target
            assign = {p: self._covered[p] for p in sorted(target)}
            self._check_rebalance_settled_locked()
            return {"epoch": self.epoch, "action": "run",
                    "assign": assign, "now": now_wall}

    # ---- submissions ------------------------------------------------------

    def submit(self, member_id: str, payload) -> dict:
        """Accept one member contribution (codec bytes or decoded dict).
        Returns {"ok": True} or {"ok": False, "reason": ...}."""
        raw = None
        if isinstance(payload, (bytes, bytearray)):
            raw = bytes(payload)
            payload = codec.decode(raw)
        t_recv = time.time()
        span = payload.get("span") or {}
        fold = []
        accepted = False
        duplicate = False
        reject_reason = None
        with self._lock:
            m = self._members.get(member_id)
            if m is None or not m.alive:
                self._m["rejected"].inc(reason="fenced")
                reject_reason = "fenced"
            elif span.get("sub") is not None and \
                    int(span["sub"]) <= m.last_sub:
                # lost-ack retry of an ALREADY-ACCEPTED submission:
                # idempotent accept — fold nothing, journal nothing. The
                # frontier-extend check alone cannot catch this when the
                # retried ranges are empty ([covered, covered] — a final
                # or idle-flush submission with no new offsets), and
                # re-folding its closed windows would double-count them.
                m.last_hb = self._time()
                duplicate = True
            else:
                m.last_hb = self._time()
                ranges = payload.get("ranges", {})
                for p, rng in ranges.items():
                    p = int(p)
                    if p not in m.owned or int(rng[0]) != self._covered[p] \
                            or int(rng[1]) < int(rng[0]):
                        # frontier mismatch: protocol violation or a
                        # zombie with stale state — fence, force a
                        # clean rejoin
                        self._m["rejected"].inc(reason="range")
                        reject_reason = "range"
                        fold = self._fence_locked(member_id, "death")
                        break
                else:
                    fold = self._accept_locked(m, member_id, payload,
                                               t_recv, span)
                    accepted = True
                    if self._journal is not None:
                        # under _lock so journal order == accept order;
                        # a buffered append, never an fsync (sync below)
                        self._journal.append(
                            "sub", {"member": member_id},
                            raw if raw is not None
                            else codec.encode(payload))
        if self._journal is not None and (accepted or
                                          reject_reason == "range"):
            # group-commit durability barrier BEFORE the ok ack: an
            # acked submission is always recoverable. The fsync runs
            # with no coordinator lock held; concurrent acks share one
            # disk flush. A "range" rejection journaled a FENCE record
            # (the carry promotion) — it must not linger unfsynced with
            # no later ack to flush it, or the lag gauge would sit
            # frozen while the record stays undurable.
            self._journal.sync()
        if duplicate:
            TRACER.record("mesh_submit_accept", t_recv, time.time(),
                          member=member_id, sub=span.get("sub"),
                          chunk=span.get("chunk"), duplicate=True,
                          windows=0)
            log.info("mesh member %s resubmitted sub=%s (lost ack); "
                     "acked idempotently", member_id, span.get("sub"))
            return {"ok": True, "duplicate": True}
        if fold:
            self._run_merges(fold)
        if accepted:
            TRACER.record("mesh_submit_accept", t_recv, time.time(),
                          member=member_id, sub=span.get("sub"),
                          chunk=span.get("chunk"),
                          windows=len(payload.get("closed", {})))
            return {"ok": True}
        # the rejected submission's span context goes INTO the ring
        # before the dump: a zombie rejection is exactly the event the
        # crash-restart post-mortem needs to see, with the member's
        # own submission id / chunk / wall-clock anchor attached
        TRACER.record("mesh_submit_reject", t_recv, time.time(),
                      member=member_id, reason=reject_reason,
                      sub=span.get("sub"), chunk=span.get("chunk"),
                      sent=span.get("sent"))
        self._dump_flight(
            f"rejected submission from {member_id} ({reject_reason})")
        # the honest cause: "range" (frontier mismatch — a protocol
        # bug to debug) vs "fenced" (zombie — the expected churn path);
        # the member's rejection log prints it
        return {"ok": False, "reason": reject_reason}

    def _accept_locked(self, m: _Member, member_id: str, payload: dict,
                       t_recv: float, span: dict):
        if span.get("sub") is not None:
            m.last_sub = max(m.last_sub, int(span["sub"]))
        for p, rng in payload.get("ranges", {}).items():
            self._covered[int(p)] = int(rng[1])
        wm = int(payload.get("watermark", 0))
        for p in m.owned:
            if wm > self._wm[p]:
                self._wm[p] = wm
        if wm > m.watermark:
            m.watermark = wm
        self._publish_watermarks_locked()
        flows = int(payload.get("flows", 0))
        if flows:
            self._m["flows"].inc(flows, member=member_id)
        self._m["submit"].inc()
        ranges = {int(p): [int(r[0]), int(r[1])]
                  for p, r in payload.get("ranges", {}).items()}
        self._fold_windows_locked(
            payload.get("closed", {}), member=member_id, span=span,
            ranges=ranges, accepted=t_recv, kind="closed")
        open_windows = payload.get("open", {})
        if payload.get("release") or payload.get("final"):
            # the member is resetting (resync) or done: its open state
            # must not sit in a carry nobody will promote
            self._fold_windows_locked(
                open_windows, member=member_id, span=span,
                ranges=ranges, accepted=t_recv, kind="final-open")
            self._carry.pop(member_id, None)
        else:
            self._carry[member_id] = {"windows": open_windows,
                                      "span": span, "ranges": ranges}
        if payload.get("final"):
            for p in m.owned:
                self._final[p] = True
        if payload.get("release"):
            self._released |= m.owned
            m.owned = set()
        return self._pop_ready_locked()

    def _publish_watermarks_locked(self) -> None:
        """Mesh-wide freshness gauges: the commit watermark is the MIN
        over live members' reported watermarks (the merge barrier can
        never be past the slowest shard), and each member's skew is its
        lag behind the mesh leader — the stalled-shard pager signal.
        Members that have never reported (watermark 0: just joined, no
        submission yet) are EXCLUDED — event time is epoch seconds, so
        folding a 0 into the min would crater the watermark by ~56
        years and report the newcomer's skew as the full epoch."""
        wms = {mid: mm.watermark for mid, mm in self._members.items()
               if mm.alive and mm.watermark > 0}
        if not wms:
            return
        hi = max(wms.values())
        self._m["commit_wm"].set(min(wms.values()))
        for mid, w in wms.items():
            self._m["member_wm"].set(w, member=mid)
            self._m["wm_skew"].set(hi - w, member=mid)

    def _fold_windows_locked(self, windows: dict, member=None,
                             span=None, ranges=None, accepted=None,
                             kind: str = "closed") -> None:
        """Fold {slot: {model: payload}} into the pending barrier. A
        contribution for an already-merged window is LATE: exact wagg
        partials are emitted as additional rows (the single-worker late
        semantics — merging sinks combine them); late sketch state has
        no exact merge target left and is dropped, counted.

        The keyword context feeds the meshscope lineage ledger: every
        pending window accumulates WHO contributed (member, submission
        id, offset ranges, member send anchor vs coordinator accept
        wall) and HOW (a closed window, a promoted carry, a late
        partial) — the record `/debug/lineage` answers from."""
        span = span or {}
        for slot, models in windows.items():
            slot = int(slot)
            for name, payload in models.items():
                if name not in self._by_name:
                    continue
                key = (name, slot)
                late = key in self._merged_keys
                if late:
                    self._m["late"].inc(model=name)
                    if payload.get("kind") != "wagg":
                        # dropped — but the lineage of the MERGED window
                        # must still show the late arrival
                        self._lineage_note_late_locked(key, member, span)
                        continue
                    self._pending.setdefault(key, []).append(payload)
                    self._merged_keys.discard(key)  # re-merge partial
                else:
                    self._pending.setdefault(key, []).append(payload)
                rec = self._lineage_pending.get(key)
                if rec is None:
                    rec = self._lineage_pending[key] = {
                        "model": name, "slot": slot, "status": "pending",
                        "contributions": [], "carries_promoted": [],
                        "late": 0,
                        "first_contribution": accepted or time.time(),
                    }
                    if late:
                        # the record is a RE-opening of a merged window
                        # — mark it so the seal treats it as a re-merge
                        # even when the prior lineage record was
                        # retention-evicted (_merged_keys outlives
                        # _lineage_done by design)
                        rec["late_reopen"] = True
                rec["contributions"].append({
                    "member": member,
                    "sub": span.get("sub"),
                    "kind": "late" if late else kind,
                    "ranges": ranges,
                    "submitted": span.get("sent"),
                    "accepted": accepted,
                    "chunk": span.get("chunk"),
                })
                if late:
                    rec["late"] += 1
                if kind == "carry-promoted" and \
                        member not in rec["carries_promoted"]:
                    rec["carries_promoted"].append(member)

    def _lineage_note_late_locked(self, key, member, span) -> None:
        """A late contribution whose window's rows are final (dropped
        sketch state): annotate the merged lineage record if sealed, or
        buffer the annotation if the window is mid-merge (popped from
        pending but not yet sealed — the merge itself runs without any
        lock) so the seal drains it. Caller holds _lock."""
        entry = {
            "member": member, "sub": span.get("sub"),
            "kind": "late-dropped", "ranges": None,
            "submitted": span.get("sent"),
            "accepted": time.time(), "chunk": span.get("chunk"),
        }
        rec = self._lineage_done.get(key)
        if rec is not None:
            rec["late"] += 1
            rec["contributions"].append(entry)
            return
        self._lineage_orphans.setdefault(key, []).append(entry)
        # bound the buffer: an orphan for a retention-EVICTED window
        # (not mid-merge) has no seal left to drain it — drop the
        # oldest slots past a small cap instead of leaking forever
        while len(self._lineage_orphans) > 64:
            del self._lineage_orphans[min(self._lineage_orphans,
                                          key=lambda k: k[1])]

    def _pop_ready_locked(self) -> list:
        """Detach every pending window whose barrier condition holds:
        all partitions final, or watermark past slot + window (+
        lateness). Marks them merged so later contributions register as
        late."""
        ready = []
        now = time.time()
        for key in sorted(self._pending):
            name, slot = key
            spec = self._by_name[name]
            limit = slot + spec.window_seconds + spec.allowed_lateness
            if all(self._final[p] or self._wm[p] >= limit
                   for p in range(self.n_partitions)):
                lin = self._lineage_pending.pop(key, None)
                if lin is not None:
                    lin["barrier_released"] = now
                ready.append((name, slot, self._pending.pop(key), lin))
                self._merged_keys.add(key)
                self._inflight_keys.add(key)
        return ready

    # ---- merging ----------------------------------------------------------

    def _run_merges(self, ready: list) -> None:
        """Fold + extract + emit each detached window. Runs on the
        submitting thread with NO coordinator lock held (merge math and
        sink writes must not serialize member heartbeats)."""
        for name, slot, payloads, lin in ready:
            t0 = time.perf_counter()
            t0_wall = time.time()
            spec = self._by_name[name]
            rows = self._merge_one(spec, slot, payloads)
            t_merged = time.time()
            TRACER.record("mesh_merge", t0_wall, t_merged, model=name,
                          slot=slot, contribs=len(payloads))
            for sink in self.sinks:
                sink.write(name, rows)
            t_emitted = time.time()
            if self._journal is not None:
                # AFTER the sink writes: a crash inside the sink-write ->
                # journal gap re-merges and re-emits this window on
                # recovery — the same irreducible at-least-once window
                # as the worker's flush -> snapshot gap
                self._journal.append("merged", {"model": name,
                                                "slot": int(slot)})
                # ... and fsync IMMEDIATELY: deferring this record to
                # the next member-ack group commit would leave it
                # sitting in the file buffer while the rows are already
                # in the sinks — a crash in that (arbitrarily long:
                # members may be idle) gap re-emits the window on
                # recovery. One fsync per merged window shrinks the
                # at-least-once gap back to the sink-write itself.
                self._journal.sync()
            # only now is the window safe to checkpoint as merged: its
            # rows are in the sinks and (if journaling) its "merged"
            # record is appended. A merge that raises leaves the key
            # in-flight — compaction stays deferred, preserving the
            # uncompacted journal's recovery exactly
            with self._lock:
                self._inflight_keys.discard((name, slot))
            n_rows = self._count_rows(rows)
            TRACER.record("mesh_emit", t_merged, t_emitted, model=name,
                          slot=slot, rows=n_rows)
            # the new contributions BEFORE any re-merge fold-in: the
            # submit->merge latency must only observe this round's
            new_contribs = list(lin["contributions"]) if lin else []
            remerge = False
            with self._merge_lock:
                self.merged.setdefault((name, slot), []).append(rows)
                # bounded retention (newest slots win); _merged_keys is
                # NOT evicted — late-contribution detection must keep
                # working for windows whose rows have aged out
                slots = sorted(s for n, s in self.merged if n == name)
                for s in slots[:-MERGED_LEDGER_SLOTS]:
                    del self.merged[(name, s)]
            if lin is not None:
                # sealing is cheap metadata work: it runs under _lock so
                # late contributions can never fall between "marked
                # merged" and "record sealed" unobserved (the orphan
                # buffer catches the mid-merge gap)
                with self._lock:
                    remerge = self._finish_lineage_locked(
                        name, slot, lin, t0_wall, t_merged, t_emitted,
                        n_rows)
            self._m["merge_s"].observe(time.perf_counter() - t0)
            self._m["merged"].inc(model=name)
            if lin is not None:
                if not remerge:
                    # a late-partial re-merge has no honest barrier
                    # interval (its "first contribution" IS the late
                    # arrival) — observing it would feed bogus ~0
                    # samples into the SLO histogram. The interval ends
                    # at BARRIER RELEASE (the _pop_ready_locked stamp),
                    # not merge start: with several windows detached in
                    # one batch, window B must not absorb window A's
                    # merge+emit wall as "barrier wait".
                    first = lin["first_contribution"]
                    released = lin.get("barrier_released", t0_wall)
                    self._m["barrier_s"].observe(
                        max(0.0, released - first))
                    TRACER.record("mesh_barrier_wait", first, released,
                                  model=name, slot=slot,
                                  contribs=len(new_contribs))
                for c in new_contribs:
                    if c.get("accepted") is not None:
                        # labeled by member: a slow shard's submit->merge
                        # tail is its own series (and is REMOVED when
                        # the member is fenced/leaves — Histogram.remove
                        # mirrors Gauge.remove, so a dead
                        # member's frozen latency never pages)
                        self._m["sub2merge_s"].observe(
                            max(0.0, t_merged - c["accepted"]),
                            member=str(c.get("member") or "unknown"))
            log.info("mesh merged window model=%s slot=%d contribs=%d",
                     name, slot, len(payloads))
        if ready and self._journal is not None:
            self._journal.sync()
            self._maybe_compact()

    def _finish_lineage_locked(self, name: str, slot: int, lin: dict,
                               t0_wall: float, t_merged: float,
                               t_emitted: float, n_rows: int) -> bool:
        """Seal a lineage record at merge time (caller holds _lock) and
        age the per-model ledger (LINEAGE_SLOTS newest slots —
        metadata-sized records, same discipline as the merged-rows
        ledger). A late-partial RE-merge must not destroy the original
        window's lineage — the prior sealed record's contributions,
        first-contribution time, promoted carries and late count fold
        into the new one — and orphaned late annotations buffered
        during the lock-free merge gap drain here. Returns whether
        this was a re-merge."""
        key = (name, slot)
        reopen = lin.pop("late_reopen", False)
        prior = self._lineage_done.get(key)
        if prior is None and reopen:
            # re-merge of a retention-evicted window: nothing to fold,
            # but it IS a re-merge — without this the evicted case
            # would feed the bogus ~0 barrier sample the remerge
            # exclusion exists to prevent
            lin["remerges"] = lin.get("remerges", 0) + 1
        if prior is not None:
            lin["contributions"] = prior["contributions"] + \
                lin["contributions"]
            # min, not prior's: concurrent merges of the same slot may
            # seal in either order
            lin["first_contribution"] = min(prior["first_contribution"],
                                            lin["first_contribution"])
            lin["carries_promoted"] = prior["carries_promoted"] + [
                m for m in lin["carries_promoted"]
                if m not in prior["carries_promoted"]]
            lin["late"] += prior["late"]
            lin["remerges"] = prior.get("remerges", 0) + 1
        orphans = self._lineage_orphans.pop(key, None)
        if orphans:
            lin["contributions"] = lin["contributions"] + orphans
            lin["late"] += len(orphans)
        lin["status"] = "merged"
        lin["members"] = sorted({c["member"]
                                 for c in lin["contributions"]
                                 if c["member"] is not None})
        lin["merge_started"] = t0_wall
        lin["merged"] = t_merged
        lin["emitted"] = t_emitted
        lin["merge_wall_s"] = round(t_merged - t0_wall, 6)
        lin["barrier_wait_s"] = round(
            max(0.0, lin.get("barrier_released", t0_wall)
                - lin["first_contribution"]), 6)
        lin["rows"] = n_rows
        self._lineage_done[key] = lin
        slots = sorted(s for n, s in self._lineage_done if n == name)
        for s in slots[:-LINEAGE_SLOTS]:
            del self._lineage_done[(name, s)]
        return prior is not None or reopen

    @staticmethod
    def _count_rows(rows) -> int:
        """Emitted-row count for one merged window (lineage/emit span):
        top-K dicts carry a validity mask, wagg dicts a timeslot
        column, alert lists are plain."""
        if isinstance(rows, dict):
            if "valid" in rows:
                return int(rows["valid"].sum())
            ts = rows.get("timeslot")
            return int(len(ts)) if ts is not None else 0
        return len(rows)

    def _merge_one(self, spec: ModelSpec, slot: int, payloads: list) -> dict:
        # kind-agnostic: the family registry supplies merge + rows hooks
        # per spec.kind; only the hh sampled-cohort audit (carried inside
        # the merged payload) needs a side effect here
        fam = registry.family(spec.kind)
        merged = registry.hook(fam, "merge")(payloads, spec.config)
        if isinstance(merged, dict):
            audit = merged.get("audit")
            if audit is not None:
                self._audit_merged_window(spec, slot, merged, audit)
        return registry.hook(fam, "top_rows")(merged, spec.config,
                                              spec.k, slot)

    def _audit_merged_window(self, spec: ModelSpec, slot: int,
                             merged: dict, audit: dict) -> None:
        """sketchwatch, network-wide: the members shipped per-shard
        sampled exact cohorts inside their hh payloads; merge_hh folded
        them (uint64 per-key sums — the same linearity as the CMS).
        Audit the MERGED sketch against the MERGED cohort, so the error
        metrics this coordinator publishes describe the network-wide
        answer — not any one shard's."""
        report = audit_report(audit["keys"], audit["vals"], merged,
                              spec.config, spec.k or spec.config.capacity,
                              slot=slot, scale=int(audit.get("scale", 1)))
        evictions = int(audit.get("evictions", 0))
        if evictions:
            self._audit_m["evictions"].inc(evictions, family=spec.name)
        report["evictions"] = evictions
        report = publish_report(spec.name, report,
                                metrics=self._audit_m)
        with self._merge_lock:
            self._audit_reports[spec.name] = report
            self.audit_merged[(spec.name, slot)] = audit
            slots = sorted(s for n, s in self.audit_merged
                           if n == spec.name)
            for s in slots[:-AUDIT_LEDGER_SLOTS]:
                del self.audit_merged[(spec.name, s)]

    def audit_reports(self) -> dict:
        """{model: newest network-wide audit report}."""
        with self._merge_lock:
            return dict(self._audit_reports)

    def audit_cohort(self, name: str, slot: int) -> Optional[dict]:
        """Merged audit partial for one (model, slot) — the ledger the
        mesh-vs-oracle bit-equality gate reads."""
        with self._merge_lock:
            return self.audit_merged.get((name, slot))

    # ---- live queries (mesh-aware /topk) ----------------------------------

    def open_window_payloads(self, name: str,
                             ) -> tuple[Optional[int], list]:
        """(newest open slot, its contribution payloads) for one top-K
        model: every live member's provider state plus the slot's
        pending barrier contributions. The coordinator lock covers only
        the provider/pending SNAPSHOT — the member fan-out runs
        lock-free, and an unreachable member degrades the answer
        instead of blacking it out. The per-query ``/topk`` fan-out
        reads it."""
        with self._lock:
            providers = [(mid, m.provider)
                         for mid, m in self._members.items()
                         if m.alive and m.provider is not None]
            # NOT the carries: every carry belongs to a LIVE member
            # (death promotes them into _pending), and a live member's
            # provider state is a superset of its own carry — folding
            # both would double-count everything since its last
            # submission. What CAN be missing from the providers is a
            # dead member's promoted-but-unmerged contribution: that
            # sits in _pending, disjoint from its successor's state
            # (the successor resumed at the covered frontier).
            pending = {slot: list(payloads)
                       for (n, slot), payloads in self._pending.items()
                       if n == name}
        states: list[tuple[int, dict]] = []
        for mid, provider in providers:
            try:
                res = provider(name)
            except (OSError, ValueError) as e:
                # a dying-but-not-yet-fenced member must DEGRADE the
                # answer (its un-submitted open rows are missing until
                # the fence promotes/replays), never black out /topk
                log.warning("mesh /topk: member %s state fetch failed "
                            "(%s); answering without it", mid, e)
                continue
            if isinstance(res, (bytes, bytearray)):
                res = codec.decode(bytes(res))
            if res and res.get("slot") is not None:
                states.append((int(res["slot"]), res["payload"]))
        slots = [s for s, _ in states] + list(pending)
        if not slots:
            return None, []
        slot = max(slots)
        return slot, [p for s, p in states if s == slot] + \
            pending.get(slot, [])

    def commit_watermark(self) -> int:
        """Mesh-wide event-time watermark: min over live members'
        reported watermarks (never-reported newcomers excluded — the
        same rule as the mesh_commit_watermark_seconds gauge)."""
        with self._lock:
            wms = [m.watermark for m in self._members.values()
                   if m.alive and m.watermark > 0]
        return min(wms) if wms else 0

    def query_topk(self, model: Optional[str] = None,
                   k: Optional[int] = None) -> dict:
        """Fan the query to every live member's state provider and
        answer from the merged open-window view — the network-wide
        equivalent of QueryServer._topk's single-worker answer."""
        spec = None
        if model:
            spec = self._by_name.get(model)
            if spec is None or spec.kind == "wagg":
                raise KeyError(f"no mesh top-K model named {model!r}")
        else:
            # default selection mirrors the single-worker QueryServer:
            # the first model with a top-K surface, dense-backed included
            spec = next((s for s in self.specs
                         if s.kind in ("hh", "dense")), None)
            if spec is None:
                raise KeyError("no top-K model configured")
        slot, payloads = self.open_window_payloads(spec.name)
        if slot is None:
            return {"model": spec.name, "window_start": None, "rows": []}
        from ..sink.base import rows_to_records

        kk = k or spec.k or spec.config.capacity
        fam = registry.family(spec.kind)
        merged = registry.hook(fam, "merge")(payloads, spec.config)
        rows = registry.hook(fam, "top_rows")(merged, spec.config, kk,
                                              slot)
        return {"model": spec.name, "window_start": slot,
                "rows": rows_to_records(rows)}

    # ---- introspection ----------------------------------------------------

    def status(self) -> dict:
        with self._lock:
            return {
                "epoch": self.epoch,
                "partitions": self.n_partitions,
                "members": {
                    mid: {"alive": m.alive,
                          "owned": sorted(m.owned),
                          "target": sorted(self._targets.get(mid, ()))}
                    for mid, m in self._members.items()
                },
                "covered": list(self._covered),
                "watermarks": list(self._wm),
                "final": list(self._final),
                "pending_windows": sorted(
                    f"{n}:{s}" for n, s in self._pending),
            }

    def merged_rows(self, name: str, slot: Optional[int] = None) -> list:
        """Emitted merged rows for one model (all slots, or one) — the
        test/debug ledger."""
        with self._merge_lock:
            if slot is not None:
                return list(self.merged.get((name, slot), []))
            return [rows for (n, _), rs in sorted(self.merged.items())
                    if n == name for rows in rs]

    def lineage(self, model: Optional[str] = None,
                slot: Optional[int] = None) -> list[dict]:
        """The meshscope window-lineage ledger (JSON-safe copies):
        merged records first (newest-LINEAGE_SLOTS per model), then the
        still-pending windows riding the barrier. Each record answers
        "which members built this window, from which offset ranges,
        when, and through which path (closed / promoted carry / late)"."""
        def keep(n, s):
            return (model is None or n == model) and \
                (slot is None or s == slot)

        with self._lock:
            out = [dict(rec, contributions=list(rec["contributions"]))
                   for (n, s), rec in sorted(self._lineage_done.items())
                   if keep(n, s)]
            out += [dict(rec, contributions=list(rec["contributions"]))
                    for (n, s), rec in
                    sorted(self._lineage_pending.items()) if keep(n, s)]
        return out
