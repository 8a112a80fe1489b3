"""StreamWorker: the processor's service loop.

Counterpart of flow_pipeline_tpu/engine/worker.py: poll a batch, run it
through the models (one fused step per chunk by default, engine/fused.py,
or its host-grouped form engine/hostfused.py, which ``host_assist``
selects: ``on``, or ``auto`` with the models on the CPU, as the reference
does on a CPU backend; with ``sketch_backend="host"`` its host sketch
form, hostsketch/pipeline.py, whose heavy-hitter families run in the
native host sketch engine or the fused native pass (``ingest_fused``);
every model's own ``update`` when the set is not fusable or ``fused`` is
off, the reference's ``-processor.fused=false`` branch, and when an
invertible family has no host sketch pipeline to serve it), emit the
rows of closed windows (flows_5m rows, ranked tables, spread detectors,
DDoS alerts) to the sinks,
then snapshot and commit the offsets the emitted state covers
(at-least-once): after any emit, and every ``snapshot_every`` batches
(``-flush.count``). With a ``checkpoint_path`` the snapshot also writes
the open windows' state (engine/checkpoint.py) before the commit, and
``restore()`` resumes from it; a checkpoint either package writes
restores in the other.

With ``prefetch > 0`` the consumer is wrapped in a PrefetchConsumer, so
the next batch is fetched and decoded while this one runs. On the
host-grouped pipeline, ``ingest_mode="pipelined"`` (the default) adds the
reference's ingest runtime (ingest/): a group thread prepares batch N+1
while this thread applies batch N, and a background flusher extracts and
writes closed windows; the flusher is drained before every snapshot and
commit. It needs the prefetch wrap (only the feed thread touches the bus
client), so without it the worker logs why and runs the serial loop. The
worker publishes the reference's metric families (obs/metrics.py; the
families of subsystems that are off as zeros, obs/families.py) and
records ``apply`` and ``flush`` spans into the trace ring (obs/trace.py).
On the host-grouped pipelines ``obs_audit`` (sample by default, as in the
reference; full or off) runs the sketch audit (obs/audit.py). The worker
holds ``lock`` across each step, so the live query API
(engine/query_api.py) reads consistent state. With ``archive_raw`` every
polled batch is handed to the sinks that expose ``archive_raw(batch)``
(the ClickHouse sink's flows_raw table; their ``check_raw_schema`` runs
at construction). The serving tier's publisher (serve/publisher.py)
binds ``serve``, which runs after each step's commit under the lock. The
guard (guard/controller.py, ``guard_lag`` > 0 arms it) reads each batch's
``produced_at`` stamp as watermark lag and walks its degradation ladder:
at level 1 every family's audit cohort and the trace ring pause, at level
2 and above a deterministic hash sample of the rows is admitted (on the
group thread when there is one, before the grouping) and the rest are
shed, their offsets still committed.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Optional, Sequence

from .. import interop
from ..families import registry
from ..guard import GuardConfig, GuardController
from ..models.ddos import DDoSDetector
from ..models.heavy_hitter import HeavyHitterModel
from ..models.window_agg import WindowAggregator, rows_from_stores
from ..obs import families
from ..obs.metrics import REGISTRY
from ..obs.trace import TRACER
from ..obs.tracing import StageTimer
from .checkpoint import checkpoint_exists, load_checkpoint, save_checkpoint
from .fused import FusedPipeline, state_device
from .hostfused import HostGroupPipeline
from .prefetch import PrefetchConsumer
from .windowed import WindowedHeavyHitter

_MODEL_TYPES = (WindowedHeavyHitter, WindowAggregator, DDoSDetector)

# window end -> sink commit latency buckets (seconds), the reference's
COMMIT_LATENCY_BUCKETS = (
    1.0, 5.0, 15.0, 30.0, 60.0, 120.0, 300.0, 600.0, 1_200.0, 1_800.0,
    3_600.0,
)

log = logging.getLogger("flow_pipeline_tpu_torch.worker")

IDLE_SLEEP = 0.05  # seconds between polls of an idle live feed


class _ShedPrep:
    """Stand-in prepared object when the guard's admission sheds a whole
    batch on the group thread: it carries the (now empty) batch through
    the executor so its offset range still reaches the commit path."""

    __slots__ = ("batch",)

    def __init__(self, batch):
        self.batch = batch


@dataclasses.dataclass(frozen=True)
class WorkerConfig:
    """StreamWorker's keyword arguments as one value, with its defaults
    (the reference's WorkerConfig). A mesh member builds a fresh worker
    from it per assignment epoch, with ``build_role`` "member", the role
    the worker's ``flow_build_info`` publishes."""

    poll_max: int = 8192
    prefetch: int = 2
    fused: bool = True
    snapshot_every: int = 50
    checkpoint_path: Optional[str] = None
    host_assist: str = "auto"
    ingest_mode: str = "pipelined"
    ingest_shards: int = 0
    ingest_depth: int = 2
    ingest_flush_queue: int = 8
    ingest_native_group: bool = False
    sketch_backend: str = "device"
    ingest_fused: str = "auto"
    ingest_threads: int = 0
    obs_audit: str = "sample"
    archive_raw: bool = False
    guard_lag: float = 0.0
    guard_max_level: int = 6
    build_role: str = "worker"

    def kwargs(self) -> dict:
        """StreamWorker(consumer, models, sinks, **config.kwargs())."""
        return dataclasses.asdict(self)


class StreamWorker:
    """Drives models from a consumer; emits rows to sinks.

    models: {"name": WindowedHeavyHitter | WindowAggregator |
    DDoSDetector}; sinks: objects with write(table, rows); poll_max: rows
    per poll (the processor's batch); prefetch: decoded batches fetched
    ahead (0 polls inline); fused: one fused step per chunk when the
    model set supports it; snapshot_every: batches between snapshots
    (0: only after emits); checkpoint_path: where snapshots write the
    open windows' state (None: offsets only); host_assist: auto | on |
    off, the host-grouped pipeline; ingest_mode: pipelined | serial;
    ingest_shards: grouping shards (0 auto, 1 disables); ingest_depth:
    prepared batches held ready; ingest_flush_queue: queued flush jobs;
    ingest_native_group: group with the native kernel; sketch_backend:
    device | host, where the heavy-hitter families' sketch step runs;
    ingest_fused: auto | on | off, the fused native pass of the host
    backend; ingest_threads: its thread count (0 auto); obs_audit: off |
    sample | full, the sketch audit of the host-grouped pipelines;
    archive_raw: hand every batch to the sinks' raw archive; guard_lag:
    the guard's watermark-lag budget in seconds (0 disarms it);
    guard_max_level: its ladder ceiling; build_role: the role of its
    ``flow_build_info`` (worker, or member inside a mesh). The
    reference's defaults: 2, True, 50, None, auto, pipelined, 0, 2, 8,
    False, device, auto, 0, sample, False, 0.0, 6 and worker
    (WorkerConfig holds them).
    """

    def __init__(self, consumer, models: dict[str, Any],
                 sinks: Sequence[Any] = (), poll_max: int = 8192,
                 prefetch: int = 2, fused: bool = True,
                 snapshot_every: int = 50,
                 checkpoint_path: Optional[str] = None,
                 host_assist: str = "auto",
                 ingest_mode: str = "pipelined", ingest_shards: int = 0,
                 ingest_depth: int = 2, ingest_flush_queue: int = 8,
                 ingest_native_group: bool = False,
                 sketch_backend: str = "device", ingest_fused: str = "auto",
                 ingest_threads: int = 0, obs_audit: str = "sample",
                 archive_raw: bool = False, guard_lag: float = 0.0,
                 guard_max_level: int = 6, build_role: str = "worker"):
        for name, model in models.items():
            if not isinstance(model, _MODEL_TYPES):
                raise TypeError(f"model {name!r}: {type(model).__name__} is "
                                "not a ported model type")
        if prefetch and consumer is not None and not isinstance(
                consumer, PrefetchConsumer):
            consumer = PrefetchConsumer(consumer, depth=prefetch,
                                        poll_max=poll_max)
        if ingest_mode not in ("pipelined", "serial"):
            raise ValueError(f"ingest_mode must be pipelined|serial, got "
                             f"{ingest_mode!r}")
        if sketch_backend not in ("device", "host"):
            raise ValueError(f"sketch_backend must be device|host, got "
                             f"{sketch_backend!r}")
        if ingest_fused not in ("auto", "on", "off"):
            raise ValueError(f"ingest_fused must be auto|on|off, got "
                             f"{ingest_fused!r}")
        if ingest_threads < 0:
            raise ValueError(f"ingest_threads must be >= 0 (0 = auto), got "
                             f"{ingest_threads}")
        if ingest_fused == "on" and sketch_backend != "host":
            raise ValueError("ingest_fused='on' requires sketch_backend="
                             "'host': the fused pass updates the host "
                             "sketch engine in place")
        if obs_audit not in ("off", "sample", "full"):
            raise ValueError(f"obs_audit must be off|sample|full, got "
                             f"{obs_audit!r}")
        if guard_lag < 0:
            raise ValueError(f"guard_lag must be >= 0 (0 = disarmed), got "
                             f"{guard_lag}")
        # constructed unconditionally (its families exist, as zeros, on
        # every worker), armed only with a lag budget
        self.guard = GuardController(GuardConfig(
            lag_budget=guard_lag, max_level=guard_max_level))
        from ..hostsketch import HostSketchPipeline

        self.consumer = consumer
        # invertible families have no device step: the host sketch
        # pipeline (staged or fused) serves them, else the per-model path
        hh_sketch = _hh_sketch_mode(models)
        self.fused = None
        if fused and models:
            if not FusedPipeline.supported(models):
                log.info("model set not fusable; using per-model updates")
            else:
                host_grouped = HostGroupPipeline.eligible(
                    host_assist, state_device(models))
                if sketch_backend == "host" and host_grouped:
                    self.fused = HostSketchPipeline(
                        models, shards=ingest_shards,
                        native_group=ingest_native_group,
                        fused=ingest_fused, audit=obs_audit,
                        threads=ingest_threads)
                elif sketch_backend == "host":
                    # the host engine consumes the host-grouped tables;
                    # without them there is nothing to feed it
                    log.warning("sketch.backend=host needs the host-grouped "
                                "pipeline (-device cpu or "
                                "-processor.hostassist on); keeping the "
                                "device sketch step")
                    self.fused = FusedPipeline(models)
                elif host_grouped:
                    self.fused = HostGroupPipeline(
                        models, shards=ingest_shards,
                        native_group=ingest_native_group, audit=obs_audit)
                else:
                    self.fused = FusedPipeline(models)
        if hh_sketch in ("invertible", "mixed") and self.fused is not None \
                and not isinstance(self.fused, HostSketchPipeline):
            # the device step cannot fold invertible state
            log.warning("hh.sketch=invertible needs the host sketch "
                        "pipeline (-sketch.backend host with -device cpu "
                        "or -processor.hostassist on); using the "
                        "per-model path for this worker")
            self.fused = None
        if ingest_fused == "on" and not isinstance(self.fused,
                                                   HostSketchPipeline):
            raise RuntimeError(
                "ingest_fused='on' but the host sketch pipeline was not "
                "selected: it needs a fusable model set and host-grouped "
                "pre-aggregation (-device cpu or -processor.hostassist on)")
        # the pipelined ingest runtime: only the host-grouped pipeline has
        # the prepare/apply split
        self.executor = None
        self.flusher = None
        if (ingest_mode == "pipelined" and consumer is not None
                and isinstance(self.fused, HostGroupPipeline)):
            if not isinstance(consumer, PrefetchConsumer):
                # moving poll() onto the group thread while commit() stays
                # here would drive a bus client from two threads; the
                # prefetch wrap keeps it on its feed thread
                log.info("ingest pipelined mode needs the prefetch wrap "
                         "(feed.prefetch > 0); using the serial path")
            else:
                from ..ingest import AsyncFlusher, PipelinedExecutor

                # the guard's admission runs inside the prepare wrapper
                # on the group thread: shed rows never reach grouping
                self.executor = PipelinedExecutor(
                    consumer, self._prepare_admitted, poll_max=poll_max,
                    depth=ingest_depth)
                self.flusher = AsyncFlusher(max_queue=ingest_flush_queue)
                for m in models.values():
                    if isinstance(m, WindowedHeavyHitter) and \
                            hasattr(m.model, "top_lazy"):
                        m.lazy_extract = True
        if obs_audit != "off" and getattr(self.fused, "audit", None) is None \
                and any(isinstance(m, WindowedHeavyHitter)
                        and m.model.snapshot_kind == "windowed_hh"
                        for m in models.values()):
            # the audit reads the host-grouped pipelines' tables; the
            # device-sorted and per-model paths have none
            log.info("obs.audit=%s needs the host-grouped pipeline "
                     "(-device cpu or -processor.hostassist on); the "
                     "sketch audit is off for this worker", obs_audit)
        self.models = models
        self.sinks = list(sinks)
        self.poll_max = poll_max
        # guards model and window state against the query API's readers;
        # held across each step
        self.lock = threading.Lock()
        # the serving tier's publisher (serve.WorkerServePublisher.attach):
        # bound once before the run, then called after each step's commit
        self.serve = None
        self.archive_raw = archive_raw
        self._halt = threading.Event()
        self.snapshot_every = snapshot_every
        self.checkpoint_path = checkpoint_path or None
        self.batches_seen = 0
        self.flows_seen = 0
        # seconds spent in the models' update calls (host clock; device
        # work may still be queued when it stops)
        self.update_seconds = 0.0
        self._covered: dict[int, int] = {}  # partition -> next offset
        self._emitted_since_snapshot = False
        # the reference's families, registered eagerly in its order (the
        # guard's came with the controller), so /metrics carries every one
        # (as zeros until used)
        self.m_flows = REGISTRY.counter("flows_processed_total",
                                        "flows decoded and aggregated")
        self.m_batches = REGISTRY.counter("batches_processed_total",
                                          "batches pulled off the bus")
        self.m_rows = REGISTRY.counter("insert_count",
                                       "rows flushed to sinks")
        self.m_lag = REGISTRY.gauge("consumer_lag", "bus messages behind")
        self.m_raw = REGISTRY.counter("raw_rows_archived",
                                      "rows archived to flows_raw")
        self.m_late = REGISTRY.gauge(
            "late_flows_dropped",
            "rows dropped because their sketch window had closed")
        self.m_proc = REGISTRY.summary("flow_processing_time_us",
                                       "per-batch processing time")
        self.m_commit_wm = REGISTRY.gauge(
            "flow_commit_watermark_seconds",
            "newest flow-export timestamp (window end, epoch s) whose "
            "rows are committed to the sinks")
        self.m_commit_lat = REGISTRY.histogram(
            "flow_sink_commit_latency_seconds",
            "window end (flow export time) -> sink commit latency",
            buckets=COMMIT_LATENCY_BUCKETS)
        for spec in families.HOST_FUSED_COUNTERS:
            REGISTRY.counter(*spec)
        REGISTRY.gauge(*families.DEGRADED_GAUGE)
        families.register_audit_metrics()
        families.publish_build_info(native=_native_caps(),
                                    sketch_backend=sketch_backend,
                                    hh_sketch=hh_sketch, role=build_role)
        self._commit_watermark = 0.0
        self._trace_chunk = -1
        # flow_summary_{processing,flushing}_time_us
        self.stages = StageTimer()
        if archive_raw:
            # fail fast on schema drift instead of crash-looping on 400s
            for sink in self.sinks:
                check = getattr(sink, "check_raw_schema", None)
                if check is not None:
                    check()

    @property
    def chunk_updates(self) -> int:
        """Padded chunks the heavy-hitter families ran, summed: each is
        one CMS update, conservative or linear as the family's config
        says (a fused step counts one for every family)."""
        return sum(m.model.chunk_updates for m in self.models.values()
                   if isinstance(m, WindowedHeavyHitter)
                   and isinstance(m.model, HeavyHitterModel))

    # ---- main loop --------------------------------------------------------

    def run_once(self) -> bool:
        """Poll one batch through the pipeline. Returns False when idle."""
        if self.executor is not None:
            prep = self.executor.next()  # grouped on the group thread
            if prep is None:
                if self.guard.armed:
                    # idle = caught up: lag 0 lets the ladder step back
                    # up without fresh traffic
                    self.guard.observe(0.0)
                return False
            with self.lock:
                self._process(prep.batch, prep)
            return True
        batch = self.consumer.poll(self.poll_max)
        if batch is None or len(batch) == 0:
            if self.guard.armed:
                self.guard.observe(0.0)
            return False
        with self.lock:
            self._process(batch)
        return True

    def _prepare_admitted(self, batch):
        """Group-thread prepare with the guard's admission in front of
        the grouping pass, so shed rows never pay pre-aggregation. A
        stale ``level`` read here sheds one batch at the previous level;
        the per-row scale factor keeps even that exact."""
        if self.guard.sample_shift > 0:
            batch, _ = self.guard.admit(batch)
            if len(batch) == 0:
                return _ShedPrep(batch)
        return self.fused.prepare(batch)

    def _process(self, batch, prep=None) -> None:
        t0 = time.perf_counter()
        t0_wall = time.time()
        self._trace_chunk = batch.chunk_id
        guard = self.guard
        if guard.armed:
            # watermark lag = the age of the backlog head (bus produce
            # time to this pickup); an unstamped batch reports 0
            pa = batch.produced_at
            guard.observe(t0_wall - pa if pa > 0.0 else 0.0)
            if prep is None and guard.sample_shift > 0:
                # the serial path (no group thread): admit here
                batch, _ = guard.admit(batch)
            # level >= 1 drops optional work first: every family's audit
            # cohort stops refreshing and the trace ring stops recording
            for _kind, attr in registry.audit_attrs():
                shadow = getattr(self.fused, attr, None)
                if shadow is not None:
                    shadow.paused = guard.drop_optional
            TRACER.paused = guard.drop_optional
        if self.archive_raw:
            archived = False
            for sink in self.sinks:
                fn = getattr(sink, "archive_raw", None)
                if fn is not None:
                    self.m_raw.inc(fn(batch))
                    archived = True
            # raw rows have no merge semantics to absorb a replayed batch,
            # so the snapshot and commit follow right after archiving
            self._emitted_since_snapshot |= archived
        with self.stages.stage("processing"):
            if len(batch) == 0:
                pass  # shed whole by the guard; its offsets still commit
            elif prep is not None:
                self.fused.apply(prep)
            elif self.fused is not None:
                self.fused.update(batch)
            else:
                for model in self.models.values():
                    model.update(batch)
            self.update_seconds += time.perf_counter() - t0
            for name, model in self.models.items():
                dropped = getattr(model, "late_flows_dropped", None)
                if dropped:
                    self.m_late.set(dropped, model=name)
        self.batches_seen += 1
        self.flows_seen += len(batch)
        self.m_flows.inc(len(batch))
        self.m_batches.inc()
        self.m_proc.observe((time.perf_counter() - t0) * 1e6)
        TRACER.record("apply", t0_wall, time.time(),
                      chunk=self._trace_chunk, rows=len(batch))
        if batch.last_offset >= 0:
            prev = self._covered.get(batch.partition, 0)
            self._covered[batch.partition] = max(prev, batch.last_offset + 1)
        self.flush_closed()
        # snapshot right after a flush that emitted rows (a replay from an
        # older snapshot would re-emit those windows), and every
        # snapshot_every batches
        if self._emitted_since_snapshot or (
                self.snapshot_every
                and self.batches_seen % self.snapshot_every == 0):
            self.snapshot_and_commit()
        if self.serve is not None:
            # the serving tier's publish decision (window close, refresh
            # due), under the lock its readers never take
            self.serve.on_batch(self)

    def run(self, stop_when_idle: bool = True) -> None:
        """Process batches, then drain: until the consumer is caught up
        (``stop_when_idle``, a finite frames file) or, on a live feed,
        until ``request_stop()``. On an error the trace ring is dumped
        and the group, flush and prefetch threads are stopped; the error
        propagates."""
        try:
            while not self._halt.is_set():
                if not self.run_once():
                    if stop_when_idle:
                        break
                    self._halt.wait(IDLE_SLEEP)
            self.finalize()
        except BaseException:
            path = TRACER.dump_on_error("worker")
            if path:
                log.error("worker error: trace ring dumped to %s", path)
            raise
        finally:
            # a crash mid-loop must not leak the threads; best effort:
            # never mask the step's own error
            parts = [("ingest executor", self.executor),
                     ("ingest flusher", self.flusher)]
            if isinstance(self.consumer, PrefetchConsumer):
                parts.append(("prefetch", self.consumer))
            for what, part in parts:
                if part is None:
                    continue
                try:
                    part.stop()
                except Exception:  # noqa: BLE001 -- logged, unwinding
                    log.exception("%s stop failed during unwind", what)

    def request_stop(self) -> None:
        """Ask ``run()`` to drain and return after its current step (a
        live feed never goes idle); safe from any thread."""
        self._halt.set()

    # ---- flushing ---------------------------------------------------------

    def flush_closed(self, force: bool = False) -> None:
        """Emit rows for closed (or all, when force) windows; an inline
        flush that emitted feeds the ``flushing`` stage summary (flusher
        jobs time themselves)."""
        t0 = time.perf_counter()
        if self._flush_closed(force) and self.flusher is None:
            self.stages.observe("flushing", (time.perf_counter() - t0) * 1e6)

    def sync_sketch_states(self) -> None:
        """Export host-backend sketch state into the models before a read
        (checkpoint, forced flush). A no-op on the device backend, where
        model state is always current."""
        sync = getattr(self.fused, "sync_states", None)
        if sync is not None:
            sync()

    def _flush_closed(self, force: bool) -> bool:
        if force:
            # a forced flush closes the OPEN window straight off model
            # state; mid-stream closes sync in the pipeline's _advance_hh
            self.sync_sketch_states()
        emitted = False
        for name, model in self.models.items():
            if isinstance(model, WindowAggregator):
                win = model.config.window_seconds
                if self.flusher is not None:
                    # detach the closed stores here; the rows are built
                    # on the flusher
                    stores = model.pop_closed(force)
                    if stores:
                        self._emit(name, lambda c=model.config, s=stores:
                                   rows_from_stores(c, s),
                                   export_ts=max(s for s, _ in stores)
                                   + win)
                        emitted = True
                else:
                    rows = model.flush(force)
                    if len(rows["timeslot"]):
                        self._emit(name, rows, len(rows["timeslot"]),
                                   export_ts=int(rows["timeslot"].max())
                                   + win)
                        emitted = True
            elif isinstance(model, WindowedHeavyHitter):
                for top in model.flush(force):
                    # a dict, or a LazyWindowTop the write resolves
                    slot = getattr(top, "timeslot", None)
                    if slot is None and len(top["timeslot"]):
                        slot = int(top["timeslot"][0])
                    self._emit(name, top,
                               export_ts=None if slot is None
                               else int(slot) + model.window_seconds)
                    emitted = True
            else:  # DDoSDetector
                if force:
                    model.close_sub_window()
                if model.alerts:
                    alerts, model.alerts = model.alerts, []
                    self._emit(name, alerts, len(alerts))
                    emitted = True
        return emitted

    def _emit(self, table: str, rows, n_rows: Optional[int] = None,
              export_ts: Optional[float] = None) -> None:
        """Write rows (or a deferred producer of rows) to every sink:
        inline, or as a job of the background flusher, whose failure
        fails a later step before its commit. export_ts (window end,
        epoch s) feeds the commit watermark and latency; the closing
        chunk's id is taken here, so the flush span names it across the
        thread hop."""
        self._emitted_since_snapshot = True
        chunk = self._trace_chunk
        if self.flusher is not None:
            self.flusher.submit(lambda: self._write_rows(
                table, rows, n_rows, export_ts, chunk))
            return
        self._write_rows(table, rows, n_rows, export_ts, chunk)

    @staticmethod
    def _row_count(rows) -> int:
        if isinstance(rows, dict):
            if "valid" not in rows:
                return len(rows["timeslot"])
            return int(rows["valid"].sum())
        return len(rows)

    def _write_rows(self, table: str, rows, n_rows: Optional[int],
                    export_ts: Optional[float], chunk: int) -> None:
        """Materialize rows (a producer or a LazyWindowTop), write them
        to every sink, record the ``flush`` span and feed the commit
        watermark and latency."""
        t0 = time.perf_counter()
        t0_wall = time.time()
        if callable(rows):
            rows = rows()
        elif hasattr(rows, "resolve"):
            rows = rows.resolve()
        if n_rows is None:
            n_rows = self._row_count(rows)
        for sink in self.sinks:
            sink.write(table, rows)
        if self.flusher is not None:
            self.stages.observe("flushing", (time.perf_counter() - t0) * 1e6)
        now = time.time()
        TRACER.record("flush", t0_wall, now, chunk=chunk, table=table,
                      rows=n_rows)
        if export_ts is not None:
            # a forced flush pops the open window, whose end lies in the
            # future: clamp to now
            export_ts = min(export_ts, now)
            self.m_commit_lat.observe(now - export_ts, table=table)
            if export_ts > self._commit_watermark:
                self._commit_watermark = export_ts
                self.m_commit_wm.set(export_ts)
        self.m_rows.inc(n_rows)
        log.info("flushed table=%s rows=%d", table, n_rows)

    def finalize(self) -> None:
        """Drain everything (end of stream / shutdown) and stop the
        group, flush and prefetch threads."""
        with self.lock:
            self.flush_closed(force=True)
            self.snapshot_and_commit()
            if self.serve is not None:
                # the end-of-stream view: the forced flush closed every
                # window; readers keep getting answers after the loop
                self.serve.publish(self)
        if self.executor is not None:
            self.executor.stop()
        if self.flusher is not None:
            self.flusher.stop()
        if isinstance(self.consumer, PrefetchConsumer):
            self.consumer.stop()

    # ---- checkpoint / offsets ---------------------------------------------

    def snapshot_and_commit(self) -> None:
        """Snapshot the open state (with a checkpoint path), then commit
        the covered offsets. The order matters: state must be durable
        before the bus forgets the input, and rows handed to the flusher
        must be in the sinks before both (a flush failure raises here,
        and the step dies uncommitted)."""
        if self.flusher is not None:
            self.flusher.drain()
        if self.checkpoint_path:
            save_checkpoint(self.checkpoint_path, self._state())
        self._emitted_since_snapshot = False
        for partition, next_off in sorted(self._covered.items()):
            self.consumer.commit(partition, next_off)
        if isinstance(self.consumer, PrefetchConsumer):
            # the commits run on the feed thread: wait for them
            self.consumer.flush_commits()
        if hasattr(self.consumer, "lag"):
            self.m_lag.set(self.consumer.lag())

    def _state(self) -> dict:
        """The checkpoint tree, in the reference's layout and dtypes
        (host numpy arrays)."""
        # host-backend sketch state lives in the engine between syncs
        self.sync_sketch_states()
        models_state: dict[str, Any] = {}
        for name, model in self.models.items():
            hooks = CHECKPOINT_HOOKS.get(_model_kind(model))
            if hooks is not None:
                models_state[name] = hooks[0](model)
            elif isinstance(model, DDoSDetector):
                models_state[name] = {
                    "kind": "ddos",
                    "state": interop.ddos_state_to_checkpoint(model.state),
                    "current_sub": model.current_sub,
                    "folds": model.folds,
                }
        return {
            "covered": {str(k): v for k, v in self._covered.items()},
            "models": models_state,
            "batches_seen": self.batches_seen,
            "flows_seen": self.flows_seen,
        }

    def restore(self, path: Optional[str] = None) -> bool:
        """Rehydrate from the checkpoint; returns False if none exists.

        Each model's state is restored by its kind's hook onto the
        model's device (the fused step reads the models' state each
        chunk, so it runs on the restored tensors). Unknown kinds are
        skipped silently; kind and layout mismatches skip loudly. The
        consumer then resumes from the covered offsets: call this before
        the first poll (the prefetch thread starts there)."""
        path = path or self.checkpoint_path
        if not path or not checkpoint_exists(path):
            return False
        snap = load_checkpoint(path)
        self._covered = {int(k): v for k, v in snap["covered"].items()}
        self.batches_seen = snap["batches_seen"]
        self.flows_seen = snap["flows_seen"]
        for name, ms in snap["models"].items():
            model = self.models.get(name)
            if model is None:
                log.warning("checkpoint has state for unconfigured model "
                            "%r; skipping", name)
                continue
            hooks = CHECKPOINT_HOOKS.get(ms["kind"])
            if hooks is not None:
                hooks[1](model, ms, name)
            elif ms["kind"] == "ddos":
                if not isinstance(model, DDoSDetector):
                    log.warning("checkpoint kind 'ddos' does not match "
                                "model %r (%s); skipping its state", name,
                                type(model).__name__)
                    continue
                model.state = interop.ddos_state_from_checkpoint(
                    ms["state"], model.device)
                model.current_sub = ms["current_sub"]
                model.folds = ms["folds"]
        # resume reading from the covered offsets, not the poll position
        for p, off in self._covered.items():
            if hasattr(self.consumer, "positions"):
                self.consumer.positions[p] = off
        return True


def _native_caps() -> str:
    """The flow_build_info ``native`` label: the features the port's
    native library serves, comma-joined ("none" when it cannot be built
    here), as the reference labels its library's."""
    from .. import native

    try:
        caps = native.capabilities()
    except (OSError, RuntimeError):
        return "none"
    return ",".join(sorted(f for f, ok in caps.items() if ok)) or "none"


def _hh_sketch_mode(models: dict) -> str:
    """The heavy-hitter sketch family the worker runs: the
    flow_build_info ``hh_sketch`` label ("none" without a heavy-hitter
    family, "mixed" for table and invertible families together)."""
    modes = {m.model.config.hh_sketch for m in models.values()
             if isinstance(m, WindowedHeavyHitter)
             and isinstance(m.model, HeavyHitterModel)}
    if not modes:
        return "none"
    if len(modes) == 1:
        return modes.pop()
    return "mixed"


# ---- per-kind checkpoint hooks ---------------------------------------------
#
# The reference dispatches these through families/registry.py; the port
# keeps a table. save_*(model) -> the model's checkpoint entry (with its
# "kind" tag); restore_*(model, ms, name) rehydrates one model from a
# loaded entry, skipping LOUDLY on a kind or layout mismatch (that
# window's state starts over: never restore the wrong layout).


def _model_kind(model) -> Optional[str]:
    if isinstance(model, WindowAggregator):
        return "window_agg"
    if isinstance(model, WindowedHeavyHitter):
        return model.model.snapshot_kind
    return None


def _kind_matches(model, ms: dict, name: str) -> bool:
    want = _model_kind(model)
    if want != ms["kind"]:
        log.warning(
            "checkpoint kind %r does not match model %r backing (%r); "
            "skipping its state", ms["kind"], name, want)
        return False
    return True


def save_wagg_state(model: WindowAggregator) -> dict:
    model._drain()  # fold the device partials first: the snapshot must
    # cover everything the committed offsets cover
    return {
        "kind": "window_agg",
        "windows": model.windows,
        "watermark": model.watermark,
    }


def restore_wagg_state(model, ms: dict, name: str) -> None:
    if not _kind_matches(model, ms, name):
        return
    windows = {int(slot): dict(store)
               for slot, store in ms["windows"].items()}
    want = model.store_key_lanes
    bad = next((k for store in windows.values()
                for k in store if len(k) != want), None)
    if bad is not None:
        # another grouping layout (e.g. without the sampling-rate lane):
        # restoring it would mis-split key tuples at flush
        log.warning(
            "checkpoint window keys have %d lanes, model "
            "%r expects %d; skipping its window state",
            len(bad), name, want)
    else:
        model.windows = windows
    model.watermark = ms["watermark"]


def save_hh_state(model: WindowedHeavyHitter) -> dict:
    return {
        "kind": "windowed_hh",
        "hh": interop.hh_state_to_checkpoint(model.model.state),
        "current_slot": model.current_slot,
    }


def restore_hh_state(model, ms: dict, name: str) -> None:
    if not _kind_matches(model, ms, name):
        return
    hh = ms["hh"]  # NamedTuple decoded as a field dict
    inv_cfg = model.model.config.hh_sketch == "invertible"
    if ("keysum" in hh) != inv_cfg:
        # a table-family checkpoint restored into an invertible model (or
        # the other way round): the layouts do not convert
        log.warning("checkpoint hh state for model %r is %s but the model "
                    "runs hh_sketch=%s; skipping its state", name,
                    "invertible" if "keysum" in hh else "table",
                    model.model.config.hh_sketch)
        return
    if inv_cfg:
        model.model.state = interop.inv_state_from_checkpoint(hh)
    else:
        model.model.state = interop.hh_state_from_checkpoint(
            hh, model.model.device)
    model.current_slot = ms["current_slot"]


def save_spread_state(model: WindowedHeavyHitter) -> dict:
    return {
        "kind": "windowed_spread",
        "spread": interop.spread_state_to_checkpoint(model.model.state),
        "current_slot": model.current_slot,
    }


def restore_spread_state(model, ms: dict, name: str) -> None:
    if not _kind_matches(model, ms, name):
        return
    model.model.state = interop.spread_state_from_checkpoint(ms["spread"])
    model.current_slot = ms["current_slot"]


def save_dense_state(model: WindowedHeavyHitter) -> dict:
    return {
        "kind": "windowed_dense",
        "totals": interop.dense_totals_to_reference(model.model.totals),
        "current_slot": model.current_slot,
    }


def restore_dense_state(model, ms: dict, name: str) -> None:
    if not _kind_matches(model, ms, name):
        return
    model.model.totals = interop.dense_totals_from_reference(
        ms["totals"], model.model.device)
    model.current_slot = ms["current_slot"]


CHECKPOINT_HOOKS = {
    "window_agg": (save_wagg_state, restore_wagg_state),
    "windowed_hh": (save_hh_state, restore_hh_state),
    "windowed_dense": (save_dense_state, restore_dense_state),
    "windowed_spread": (save_spread_state, restore_spread_state),
}
