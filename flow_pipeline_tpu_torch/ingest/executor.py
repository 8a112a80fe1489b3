"""Pipelined stage executor: overlap host grouping with the device step.

Counterpart of flow_pipeline_tpu/ingest/executor.py. A group thread (``ingest-group``) polls decoded
batches off the consumer and runs the pipeline's prepare half (host
pre-aggregation, no model state) into a bounded queue, so the grouping of
batch N+1 overlaps the device step and window lifecycle of batch N on the
worker thread:

    bus fetch+decode -> [prefetch q] -> group/prepare -> [prepared q]
        -> device step (worker thread) -> [flush q] -> flusher

Backpressure is the queues: a slow device step fills the prepared queue
(``depth`` batches) and the group thread waits; the bytes resident in
that queue are the guard's ``guard_buffer_bytes{stage="group"}``. Batches come out in poll
order, and ``next()`` returns None only after a poll round that started
after the call came back empty with the queue drained, so a caller that
stops when idle never abandons a tail in flight. A poll or prepare error
latches and is raised from ``next()``, failing the worker's step before
its commit.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Callable, Optional

from ..obs.families import register_guard_metrics
from ..obs.metrics import REGISTRY
from ..obs.trace import TRACER

log = logging.getLogger("flow_pipeline_tpu_torch.ingest.executor")


class PipelinedExecutor:
    """Runs ``prepare`` over consumer batches on a dedicated thread;
    ``depth`` prepared batches are held ready at most."""

    def __init__(self, consumer, prepare: Callable, poll_max: int = 32768,
                 depth: int = 2, idle_sleep: float = 0.02):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.consumer = consumer
        self.prepare = prepare
        self.poll_max = poll_max
        self.depth = depth
        self.idle_sleep = idle_sleep
        self._out: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._idle = threading.Event()
        # freshness accounting, as engine/prefetch.py's (the group thread
        # writes both)
        self._started = 0
        self._completed_start = 0
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self.m_depth = REGISTRY.gauge(
            "ingest_queue_depth", "items queued per ingest stage")
        self.m_high = REGISTRY.gauge(
            "ingest_queue_highwater", "max queue depth seen per ingest stage")
        self.high_water = 0
        self.prepared = 0  # batches prepared (group thread)
        # the guard's occupancy gauge: live bytes in the prepared queue
        self.m_bytes = register_guard_metrics()["buffer_bytes"]
        self._bytes_lock = threading.Lock()
        self._bytes = 0  # guarded by _bytes_lock

    # ---- worker surface ---------------------------------------------------

    def next(self):
        """The next prepared batch, or None when the stream is idle (a
        fresh idle round and an empty queue). Raises the first stage
        error."""
        if self._thread is None:
            self._start()
        started_before = self._started
        while True:
            if self._error is not None:
                raise self._error
            try:
                item, t_enq, chunk = self._out.get(timeout=self.idle_sleep)
                self.m_depth.set(self._out.qsize(), stage="group")
                self._track_bytes(-self._nbytes(item))
                # prepared-to-picked-up: whether the device step or the
                # group thread holds this chunk back
                TRACER.record("queue_wait", t_enq, time.time(),
                              chunk=chunk, stage="group")
                return item
            except queue.Empty:
                if not self._thread.is_alive():
                    if self._error is not None:
                        raise self._error
                    return None
                if self._idle.is_set() and \
                        self._completed_start > started_before:
                    return None

    def stop(self, timeout: float = 5.0) -> None:
        """Stop the group thread and drop prepared batches not yet
        applied (their offsets are uncommitted, so they replay)."""
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("ingest group thread did not stop in time")
        self._thread = None
        self._stop.clear()
        while True:
            try:
                self._out.get_nowait()
            except queue.Empty:
                break
        self._idle.clear()
        self._error = None
        self.m_depth.set(0, stage="group")
        with self._bytes_lock:
            self._bytes = 0
        self.m_bytes.set(0, stage="group")

    # ---- occupancy accounting ---------------------------------------------

    @staticmethod
    def _nbytes(prep) -> int:
        batch = getattr(prep, "batch", None)
        return batch.nbytes() if batch is not None else 0

    def _track_bytes(self, delta: int) -> None:
        with self._bytes_lock:
            self._bytes += delta
            b = self._bytes
        self.m_bytes.set(b, stage="group")

    # ---- group thread -----------------------------------------------------

    def _start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name="ingest-group", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            if self._out.full():
                # the device side is behind: wait instead of spinning
                self._stop.wait(self.idle_sleep)
                continue
            self._started += 1
            round_no = self._started
            try:
                batch = self.consumer.poll(self.poll_max)
            except Exception as e:  # noqa: BLE001 -- raised by next()
                log.exception("ingest poll failed; surfacing to worker")
                self._error = e
                break
            if batch is None or len(batch) == 0:
                self._idle.set()
                self._completed_start = round_no
                self._stop.wait(self.idle_sleep)
                continue
            chunk = getattr(batch, "chunk_id", -1)
            try:
                with TRACER.span("prepare", chunk=chunk, rows=len(batch)):
                    prep = self.prepare(batch)
            except Exception as e:  # noqa: BLE001 -- raised by next()
                log.exception("ingest prepare failed; surfacing to worker")
                self._error = e
                break
            self._idle.clear()
            self._completed_start = round_no
            self.prepared += 1
            # this thread is the only producer and checked full() above
            self._out.put((prep, time.time(), chunk))
            self._track_bytes(self._nbytes(prep))
            depth = self._out.qsize()
            self.m_depth.set(depth, stage="group")
            if depth > self.high_water:
                self.high_water = depth
                self.m_high.set(depth, stage="group")
