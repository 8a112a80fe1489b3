"""Background flusher: closed-window extraction and sink writes off the
hot path.

Counterpart of flow_pipeline_tpu/ingest/flush.py. The worker captures a
closed window's state under its step (dict pops, tensor references) and
hands zero-arg jobs here; one thread (``ingest-flush``) runs them in
submission order. A failed job must fail the step, not drop rows (at
least once): the first job error is latched and raised, wrapped in
FlushError, from the next ``submit()`` or ``drain()`` on the worker
thread, and the worker drains before every offset commit.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Callable, Optional

from ..obs.metrics import REGISTRY

log = logging.getLogger("flow_pipeline_tpu_torch.ingest.flush")


class FlushError(RuntimeError):
    """A background flush job failed; the cause is __cause__."""


class AsyncFlusher:
    """One background thread draining a bounded queue of flush jobs;
    ``submit()`` blocks when ``max_queue`` jobs wait (backpressure)."""

    def __init__(self, max_queue: int = 8):
        self.max_queue = max_queue
        self._jobs: queue.Queue = queue.Queue(maxsize=max_queue)
        self._error: Optional[BaseException] = None  # under _cv
        self._cv = threading.Condition()
        self._inflight = 0  # queued + running, under _cv
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.m_depth = REGISTRY.gauge(
            "ingest_queue_depth", "items queued per ingest stage")
        self.m_high = REGISTRY.gauge(
            "ingest_queue_highwater", "max queue depth seen per ingest stage")
        self._high = 0
        self.jobs_run = 0  # finished jobs (flusher thread)

    # ---- worker-thread surface -------------------------------------------

    def submit(self, job: Callable[[], None]) -> None:
        """Enqueue one zero-arg job. Raises FlushError if an earlier job
        failed (the step that sees it must not commit)."""
        self._check()
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="ingest-flush", daemon=True)
            self._thread.start()
        with self._cv:
            self._inflight += 1
        self._jobs.put(job)
        depth = self._jobs.qsize()
        self.m_depth.set(depth, stage="flush")
        if depth > self._high:
            self._high = depth
            self.m_high.set(depth, stage="flush")

    def drain(self, timeout: float = 60.0) -> None:
        """Block until every submitted job has finished; raise the first
        failure. Call before committing offsets."""
        with self._cv:
            done = self._cv.wait_for(
                lambda: self._inflight == 0 or self._error is not None,
                timeout)
        self._check()
        if not done:
            raise FlushError("flush queue did not drain in time")

    def stop(self, timeout: float = 30.0) -> None:
        """Drain and stop the thread. Safe to call twice."""
        if self._thread is None:
            return
        try:
            self.drain(timeout)
        finally:
            self._stop.set()
            self._jobs.put(None)  # wake the thread
            self._thread.join(timeout)
            if self._thread.is_alive():
                # wedged inside a job: a second consumer of the queue
                # would run jobs out of order, so refuse to pretend
                raise TimeoutError(
                    "ingest flusher thread did not stop in time")
            self._thread = None
            self._stop.clear()

    def _check(self) -> None:
        with self._cv:
            err, self._error = self._error, None
        if err is not None:
            raise FlushError(f"background flush failed: {err}") from err

    # ---- flusher thread ---------------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            job = self._jobs.get()
            if job is None:
                continue
            try:
                job()
                self.jobs_run += 1
            except Exception as e:  # noqa: BLE001 -- latched for the worker
                log.exception("flush job failed; surfacing to worker")
                with self._cv:
                    if self._error is None:
                        self._error = e
            finally:
                self.m_depth.set(self._jobs.qsize(), stage="flush")
                with self._cv:
                    self._inflight -= 1
                    self._cv.notify_all()
