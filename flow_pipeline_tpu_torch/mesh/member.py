"""The mesh member: one StreamWorker under the coordinator's control.

Counterpart of flow_pipeline_tpu/mesh/member.py. A member wraps a full
StreamWorker (fused step, host-grouped or host sketch pipeline, prefetch
and flusher threads all unchanged) and adds the mesh's contract:

- window-close CAPTURE: the WindowAggregator and WindowedHeavyHitter
  ``capture`` seams hand each closing window's raw state to the member
  instead of extracting rows; mesh/codec.py copies it to the host (on
  the card too: the CMS kernels write the planes in place, and the
  capture runs before the reset rebinds them), and the member ships it
  to the coordinator tagged with the offset ranges it covers;
- the OPEN-window carry: every submission also snapshots the open
  windows, so a member's death costs its successor at most the rows
  since its last accepted submission (``submit_every`` bounds that);
- the assignment lifecycle: ``sync()`` heartbeats the coordinator; on a
  target change the member RESYNCs (final-submits everything with
  ``release``, drops its worker, stops the worker's threads and builds a
  fresh model set and worker on its new partitions from the
  coordinator's frontier). A fenced member abandons what it did not
  submit; its successor replays those rows.

DDoS detectors stay per shard: their alerts go to the member's sinks.
Everything here runs on the member's one thread, the capture
hooks included (they fire inside ``worker.run_once``); the coordinator's
``/topk`` fan-out reads the member's state under ``worker.lock``.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Optional, Sequence

from ..engine.prefetch import PrefetchConsumer
from ..engine.windowed import WindowedHeavyHitter
from ..engine.worker import StreamWorker, WorkerConfig
from ..models.window_agg import WindowAggregator
from ..obs.metrics import REGISTRY
from ..obs.trace import TRACER
from ..utils.faults import FAULTS
from ..utils.retry import retry_call
from . import codec
from .scope import ClockSync

log = logging.getLogger("flow_pipeline_tpu_torch.mesh")

# The retry policy of the member -> coordinator calls (submit, sync,
# join, leave). Retrying a submit is safe: the coordinator acknowledges
# a resubmitted id once, folding nothing, and a range that no longer
# extends the frontier is refused, after which the member rejoins and
# replays from the frontier.
COORD_RETRIES = 5
COORD_BACKOFF = 0.05
COORD_BACKOFF_MAX = 1.0


class MeshMember:
    """A coordinator-driven StreamWorker shard."""

    def __init__(self, member_id: str, coordinator,
                 consumer_factory: Callable[[Sequence[int]], Any],
                 model_factory: Callable[[], dict],
                 config: WorkerConfig = WorkerConfig(),
                 sinks: Sequence[Any] = (),
                 submit_every: int = 0,
                 sync_interval: float = 0.2):
        self.member_id = member_id
        self.coordinator = coordinator
        self.consumer_factory = consumer_factory
        self.model_factory = model_factory
        # the inner worker's flow_build_info says "member"
        self.config = dataclasses.replace(config, build_role="member")
        self.sinks = list(sinks)
        # > 0: also submit a progress carry every N applied batches, which
        # bounds a successor's replay mid-window
        self.submit_every = submit_every
        self.sync_interval = sync_interval
        self.worker: Optional[StreamWorker] = None
        self._frontier: dict[int, int] = {}
        # slot -> {model: payload}: windows closed since the last submit
        self._captured: dict[int, dict] = {}
        # slot -> {model: audit partial}, sealed at the same closes and
        # put inside the hh payloads at submit
        self._audit_captured: dict[int, dict] = {}
        self._flows_reported = 0
        self._batches_since_submit = 0
        self._last_sync = 0.0
        self._joined = False
        # written by kill() on another thread, read by run(): a latch
        self._dead = False
        # read by the runtime's quiescence poll
        self.idle_streak = 0
        self._sub_seq = 0  # this member's submission ids
        # heartbeat clock offset estimate, sent on the next sync
        self._clock = ClockSync()
        # one coordinator-unreachable warning per outage
        self._last_down_log = 0.0
        self.m_retries = REGISTRY.counter(
            "mesh_member_retries_total",
            "member->coordinator calls retried after a transport "
            "failure (label: op)")

    # ---- coordinator calls, retried ---------------------------------------

    def _coord_call(self, op: str, fn):
        """One coordinator round trip under the bounded retry policy.
        ``op`` names the fault site (``mesh.submit``, ``mesh.sync``) and
        the retry counter's label; an OSError, real or injected, backs
        off and retries, and the last one reaches the caller."""
        site = f"mesh.{op if op in ('submit', 'sync') else 'sync'}"

        def call():
            if FAULTS.active:
                FAULTS.check(site)
            return fn()

        def on_retry(i, exc, delay):
            self.m_retries.inc(op=op)
            log.warning("mesh member %s %s to coordinator failed (%s); "
                        "retry %d/%d in %.2fs", self.member_id, op, exc,
                        i + 1, COORD_RETRIES - 1, delay)

        return retry_call(call, attempts=COORD_RETRIES,
                          base=COORD_BACKOFF, cap=COORD_BACKOFF_MAX,
                          retry_on=(OSError,), on_retry=on_retry)

    # ---- capture hooks ----------------------------------------------------

    def _install_hooks(self, models: dict) -> None:
        for name, m in models.items():
            if isinstance(m, WindowAggregator):
                m.capture = self._wagg_capture(name)
            elif isinstance(m, WindowedHeavyHitter):
                m.capture = self._whh_capture(name)

    def _wagg_capture(self, name: str):
        def capture(popped):
            for slot, store in popped:
                self._captured.setdefault(int(slot), {})[name] = \
                    codec.wagg_payload(store)
        return capture

    def _whh_capture(self, name: str):
        def capture(slot, model):
            self._captured.setdefault(int(slot), {})[name] = \
                codec.capture_model(model)
        return capture

    def _audit_capture(self, name: str, slot: int, part: dict) -> None:
        """The audit's close hook: fires inside the model's close, just
        before the model capture of the same window."""
        self._audit_captured.setdefault(int(slot), {})[name] = part

    # ---- assignment lifecycle ---------------------------------------------

    def _call_sync(self) -> dict:
        """One heartbeat round trip; its stamps and the reply's ``now``
        make one clock offset sample (mesh/scope.py)."""
        t0 = time.time()
        resp = self._coord_call(
            "sync", lambda: self.coordinator.sync(
                self.member_id, clock=self._clock.report()))
        t1 = time.time()
        now = resp.get("now")
        if now is not None:
            self._clock.add(t0, t1, float(now))
        return resp

    def _sync(self) -> None:
        if not self._joined:
            self._coord_call(
                "join", lambda: self.coordinator.join(
                    self.member_id, provider=self._query_state))
            self._joined = True
        resp = self._call_sync()
        action = resp.get("action")
        if action == "rejoin":
            # fenced: what we did not submit is the successor's replay
            self._abandon()
            self._joined = False
            return
        if action == "resync":
            self._resync()
            resp = self._call_sync()  # re-acquire at once
            action = resp.get("action")
        if action == "run" and resp.get("assign") is not None:
            self._start_worker(resp["assign"])

    def _start_worker(self, assign: dict) -> None:
        assign = {int(p): int(off) for p, off in assign.items()}
        self._frontier = dict(assign)
        self._captured = {}
        if not assign:
            self.worker = None
            return
        consumer = self.consumer_factory(sorted(assign))
        if hasattr(consumer, "positions"):
            for p, off in assign.items():
                consumer.positions[p] = off
        models = self.model_factory()
        self._install_hooks(models)
        self.worker = StreamWorker(consumer, models, self.sinks,
                                   **self.config.kwargs())
        self._audit_captured = {}
        aud = getattr(self.worker.fused, "audit", None)
        if aud is not None:
            # closes ship the cohort here; the coordinator audits the
            # merged sketch against the merged cohort
            aud.capture = self._audit_capture
        self._flows_reported = 0
        self._batches_since_submit = 0
        # fresh ownership, fresh backlog: no stale idle streak
        self.idle_streak = 0
        log.info("mesh member %s serving partitions %s",
                 self.member_id, sorted(assign))

    def _resync(self) -> None:
        log.info("mesh member %s resyncing (assignment changed)",
                 self.member_id)
        if self.worker is not None:
            w = self.worker
            w.finalize()  # forced closes fire the capture hooks
            ok = self._submit(release=True)
            self.worker = None
            self._close_consumer(w)
            if not ok and self._joined:
                # the release never landed and the worker is gone: rejoin
                # (the rejoin fence promotes our last accepted carry)
                self._abandon()
                self._joined = False
        else:
            try:
                payload = codec.encode({
                    "member": self.member_id, "ranges": {},
                    "watermark": 0, "closed": {}, "open": {}, "flows": 0,
                    "release": True, "final": False,
                    "span": self._next_span((), ())})
                self._coord_call(
                    "submit", lambda: self.coordinator.submit(
                        self.member_id, payload))
            except OSError as e:
                log.warning("mesh member %s empty-release submit failed "
                            "(%s); rejoining fresh", self.member_id, e)
                self._joined = False
        self._captured = {}
        self._audit_captured = {}
        self._frontier = {}

    def _abandon(self) -> None:
        """Drop the worker without submitting (we were fenced) and stop
        its threads; the successor replays our rows."""
        w, self.worker = self.worker, None
        self._captured = {}
        self._audit_captured = {}
        self._frontier = {}
        if w is not None:
            self._stop_worker_threads(w)

    @staticmethod
    def _stop_worker_threads(w: StreamWorker) -> None:
        if w.executor is not None:
            w.executor.stop()
        if w.flusher is not None:
            w.flusher.stop()
        if isinstance(w.consumer, PrefetchConsumer):
            w.consumer.stop()
        MeshMember._close_consumer(w)

    @staticmethod
    def _close_consumer(w: StreamWorker) -> None:
        """Release a dropped worker's bus client, where it has a close()
        (the in-process consumer has none)."""
        raw = w.consumer
        if isinstance(raw, PrefetchConsumer):
            raw = raw.inner
        close = getattr(raw, "close", None)
        if close is not None:
            close()

    # ---- submissions ------------------------------------------------------

    def _watermark(self, w: StreamWorker) -> int:
        wm = 0
        for m in w.models.values():
            if isinstance(m, WindowAggregator):
                wm = max(wm, int(m.watermark))
            elif isinstance(m, WindowedHeavyHitter) and \
                    m.current_slot is not None:
                wm = max(wm, int(m.current_slot))
        return wm

    def _collect_open(self, w: StreamWorker) -> dict:
        """{slot: {model: payload}} of every open window. The caller holds
        worker.lock and has synced the sketch states."""
        out: dict[int, dict] = {}
        for name, m in w.models.items():
            if isinstance(m, WindowAggregator):
                m._drain()
                for slot, store in m.windows.items():
                    out.setdefault(int(slot), {})[name] = \
                        codec.wagg_payload(store)
            elif isinstance(m, WindowedHeavyHitter) and \
                    m.current_slot is not None:
                payload = codec.capture_model(m.model)
                aud = getattr(w.fused, "audit", None)
                if aud is not None and payload.get("kind") in (
                        "hh", "hh_inv"):
                    # a promoted carry's cohort covers exactly the rows
                    # its sketch covers
                    part = aud.peek_partial(name)
                    if part is not None:
                        payload["audit"] = part
                out.setdefault(int(m.current_slot), {})[name] = payload
        return out

    def _next_span(self, closed_slots, open_slots,
                   chunk: int = -1) -> dict:
        """The span context one submission carries: its id, the window
        slots it touches, the newest chunk that fed it and the send
        time."""
        self._sub_seq += 1
        return {
            "sub": self._sub_seq,
            "member": self.member_id,
            "sent": time.time(),
            "chunk": int(chunk),
            "windows": sorted({int(s) for s in closed_slots} |
                              {int(s) for s in open_slots}),
        }

    def _submit(self, final: bool = False, release: bool = False) -> bool:
        w = self.worker
        if w is None:
            return True
        closed, self._captured = self._captured, {}
        audit_closed, self._audit_captured = self._audit_captured, {}
        for slot, models in closed.items():
            for name, model_payload in models.items():
                part = audit_closed.get(slot, {}).get(name)
                if part is not None and \
                        model_payload.get("kind") in ("hh", "hh_inv"):
                    model_payload["audit"] = part
        with w.lock:
            w.sync_sketch_states()
            # a final or release submission follows worker.finalize():
            # every window was closed into `closed`; a normal one ships
            # the open windows as the carry
            open_windows = {} if (final or release) \
                else self._collect_open(w)
            ranges = {}
            for p, start in self._frontier.items():
                to = max(int(w._covered.get(p, start)), start)
                ranges[p] = [start, to]
            watermark = self._watermark(w)
            flows = w.flows_seen
            chunk = getattr(w, "_trace_chunk", -1)
        span = self._next_span(closed, open_windows, chunk)
        payload = {
            "member": self.member_id,
            "ranges": ranges,
            "watermark": watermark,
            "closed": closed,
            "open": open_windows,
            "flows": flows - self._flows_reported,
            "final": final,
            "release": release,
            "span": span,
        }
        encoded = codec.encode(payload)
        try:
            resp = self._coord_call(
                "submit", lambda: self.coordinator.submit(
                    self.member_id, encoded))
        except OSError as e:
            # retries exhausted: keep the captured windows (nothing else
            # ran on this thread since they were popped) for a later step
            log.warning("mesh member %s submission transport failure "
                        "(%s); keeping state for retry",
                        self.member_id, e)
            TRACER.record("mesh_submit", span["sent"], time.time(),
                          member=self.member_id, sub=span["sub"],
                          chunk=span["chunk"], ok=False,
                          windows=len(closed))
            for slot, models in closed.items():
                self._captured.setdefault(slot, {}).update(models)
            for slot, parts in audit_closed.items():
                self._audit_captured.setdefault(slot, {}).update(parts)
            return False
        TRACER.record("mesh_submit", span["sent"], time.time(),
                      member=self.member_id, sub=span["sub"],
                      chunk=span["chunk"], ok=bool(resp.get("ok")),
                      windows=len(closed))
        if not resp.get("ok"):
            log.warning("mesh member %s submission rejected (%s); "
                        "abandoning state and rejoining",
                        self.member_id, resp.get("reason"))
            self._abandon()
            self._joined = False
            return False
        self._flows_reported = flows
        self._batches_since_submit = 0
        for p, rng in ranges.items():
            self._frontier[p] = rng[1]
        return True

    # ---- step loop --------------------------------------------------------

    def step(self) -> bool:
        """One poll, process and submit round. False when idle."""
        if self._dead:
            return False
        now = time.monotonic()
        # without partitions, poll for an assignment faster than the
        # heartbeat, but bounded
        interval = self.sync_interval if self.worker is not None \
            else min(self.sync_interval, 0.05)
        if now - self._last_sync >= interval:
            self._last_sync = now
            try:
                self._sync()
            except OSError as e:
                # the coordinator is unreachable past the retries: keep
                # our state and heartbeat again next step
                if time.monotonic() - self._last_down_log >= 5.0:
                    self._last_down_log = time.monotonic()
                    log.warning("mesh member %s: coordinator "
                                "unreachable (%s); will keep retrying",
                                self.member_id, e)
                return False
        w = self.worker  # kill() may clear the attribute mid-step
        if w is None or self._dead:
            return False
        progressed = w.run_once()
        if progressed:
            self._batches_since_submit += 1
        if self._captured or (
                self.submit_every
                and self._batches_since_submit >= self.submit_every):
            self._submit()
        elif not progressed and self._batches_since_submit:
            # going idle with unreported progress: report it, or this
            # member's watermark never reaches the coordinator and the
            # merge barrier waits for the next row
            self._submit()
        return progressed

    def run(self, stop, idle_sleep: float = 0.01) -> None:
        """Thread target: step until ``stop`` (a threading.Event) is
        set."""
        while not stop.is_set() and not self._dead:
            try:
                progressed = self.step()
            except Exception:
                if self._dead:
                    return  # kill() tore the worker down mid-step
                raise
            if progressed:
                self.idle_streak = 0
            else:
                self.idle_streak += 1
                stop.wait(idle_sleep)

    def finalize(self) -> None:
        """End of stream: close everything, final-submit, leave."""
        if self._dead:
            return
        if self.worker is not None:
            w = self.worker
            w.finalize()  # the capture hooks take every open window
            if not self._submit(final=True):
                log.error("mesh member %s final submission failed; the "
                          "coordinator will fence this member and "
                          "promote its last accepted carry",
                          self.member_id)
            self.worker = None
            self._close_consumer(w)
        if self._joined:
            try:
                self._coord_call(
                    "leave",
                    lambda: self.coordinator.leave(self.member_id))
            except OSError as e:
                # the heartbeat expiry fences us: the same protocol path
                log.warning("mesh member %s leave failed (%s); relying "
                            "on heartbeat expiry", self.member_id, e)
            self._joined = False

    def kill(self) -> None:
        """Abrupt death: no submission, no leave. The coordinator fences
        the member (heartbeat expiry or fence()) and promotes its last
        accepted carry."""
        self._dead = True
        w, self.worker = self.worker, None
        if w is not None:
            self._stop_worker_threads(w)

    # ---- the /topk fan-out's state provider -------------------------------

    def _query_state(self, model_name: str):
        """Open-window sketch state for the coordinator's ``/topk``
        fan-out, read under worker.lock (the view a single worker's
        QueryServer gets)."""
        w = self.worker
        if w is None:
            return None
        with w.lock:
            m = w.models.get(model_name)
            if not isinstance(m, WindowedHeavyHitter) or \
                    m.current_slot is None:
                return None
            w.sync_sketch_states()
            return {"slot": int(m.current_slot),
                    "payload": codec.capture_model(m.model)}
