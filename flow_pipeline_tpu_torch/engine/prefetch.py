"""Prefetching consumer: overlap the host's fetch and decode with the
device step.

Counterpart of flow_pipeline_tpu/engine/prefetch.py without the guard
metrics. The wrapped consumer runs on one thread, ``feed-prefetch``,
which keeps at most ``depth`` decoded batches ready, so the worker's
device step for batch i overlaps the host work for batch i+1 (and torch's
asynchronous launches overlap the device work itself with the next poll).

Threading contract: after the first poll the wrapped consumer belongs to
the feed thread alone (a Kafka client is not thread-safe), so commits are
queued and run on that thread between polls. ``flush_commits()`` blocks
until the queued commits have run; the worker calls it after committing,
so "rows emitted, then offsets committed" keeps its order. The thread
starts at the first poll, never before: a checkpoint restore seeks the
wrapped consumer's ``positions`` (reached through the delegation below)
before anything is fetched.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Optional

log = logging.getLogger("flow_pipeline_tpu_torch.prefetch")


class PrefetchConsumer:
    """Wraps a transport consumer with a fetch-ahead thread; exposes the
    consumer surface the worker uses (poll, commit)."""

    def __init__(self, consumer, depth: int = 2, poll_max: int = 8192,
                 idle_sleep: float = 0.02):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.inner = consumer
        self.depth = depth
        # written by the owner thread, read by the feed thread: a new size
        # applies from the next feed round
        self.poll_max = poll_max
        self.idle_sleep = idle_sleep
        self._batches: queue.Queue = queue.Queue(maxsize=depth)
        self._commits: queue.Queue = queue.Queue()
        # commits queued but not yet run; counted under _cv, since a bare
        # "queue empty" test races with a commit taken but not yet run
        self._pending = 0
        self._cv = threading.Condition()
        self._stop = threading.Event()
        self._idle = threading.Event()  # the last inner poll was empty
        # poll() freshness: rounds begun, and the start number of the last
        # finished round (the feed thread writes both)
        self._started = 0
        self._completed_start = 0
        # the feed thread's first error, raised to the caller
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None

    # ---- consumer surface --------------------------------------------------

    def poll(self, max_messages: int = 8192):
        """The next prefetched batch, or None once the wrapped consumer is
        idle: only after a feed round that started after this call came
        back empty, so a fetch in flight is never mistaken for the end of
        the stream."""
        self.poll_max = max_messages
        if self._thread is None:
            self._start()
        started_before = self._started
        while True:
            if self._error is not None:
                raise self._error
            try:
                return self._batches.get(timeout=self.idle_sleep)
            except queue.Empty:
                if not self._thread.is_alive():
                    # it may have died during the get(): its error first
                    if self._error is not None:
                        raise self._error
                    return None
                if self._idle.is_set() and \
                        self._completed_start > started_before:
                    return None

    def commit(self, partition: int, next_offset: int) -> None:
        """Queue the commit for the feed thread; ``flush_commits()`` waits
        for it. With no live feed thread it commits directly."""
        if self._thread is None or not self._thread.is_alive():
            self.inner.commit(partition, next_offset)
            return
        with self._cv:
            self._pending += 1
        self._commits.put((partition, next_offset))

    def flush_commits(self, timeout: float = 30.0) -> None:
        """Block until every queued commit has run on the consumer."""
        if self._thread is None:
            return
        with self._cv:
            done = self._cv.wait_for(
                lambda: self._pending == 0 or self._error is not None,
                timeout)
        if self._error is not None:
            raise self._error
        if not done:
            raise TimeoutError("prefetch commit queue did not drain")

    def __getattr__(self, name):
        # lag / positions delegate to the wrapped consumer and exist only
        # if it has them (callers test with hasattr). restore()
        # sets positions before the first poll starts the thread; after
        # that the thread owns them.
        if name == "inner":  # not set yet (mid-construction)
            raise AttributeError(name)
        return getattr(self.inner, name)

    # ---- lifecycle ---------------------------------------------------------

    def _start(self) -> None:
        self._thread = threading.Thread(target=self._run,
                                        name="feed-prefetch", daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        """Run the queued commits and stop the thread. Batches fetched but
        not read are dropped; their offsets were never committed, so they
        replay."""
        if self._thread is None:
            return
        self.flush_commits(timeout)
        self._stop.set()
        self._thread.join(timeout)
        if self._thread.is_alive():
            # stuck in a blocking inner call: keep ownership (the thread
            # exits when the call returns), so nothing else touches the
            # consumer concurrently
            raise TimeoutError("prefetch thread did not stop in time")
        self._thread = None
        self._stop.clear()

    def _run(self) -> None:
        while not self._stop.is_set():
            self._drain_commits()
            if self._batches.full():
                self._stop.wait(self.idle_sleep)  # the device side is behind
                continue
            self._started += 1
            round_no = self._started
            try:
                batch = self.inner.poll(self.poll_max)
            except Exception as e:  # noqa: BLE001 -- raised by poll()
                log.exception("prefetch poll failed; raising it to the "
                              "caller")
                with self._cv:
                    self._error = e
                    self._cv.notify_all()
                break
            if batch is None or len(batch) == 0:
                self._idle.set()
                self._completed_start = round_no
                self._stop.wait(self.idle_sleep)
                continue
            self._idle.clear()
            self._completed_start = round_no
            self._batches.put(batch)
        self._drain_commits()

    def _drain_commits(self) -> None:
        while True:
            try:
                partition, next_offset = self._commits.get_nowait()
            except queue.Empty:
                return
            try:
                self.inner.commit(partition, next_offset)
            except Exception as e:  # noqa: BLE001 -- raised by flush_commits()
                log.exception("prefetch commit failed; raising it to the "
                              "caller")
                with self._cv:
                    if self._error is None:
                        self._error = e
            finally:
                with self._cv:
                    self._pending -= 1
                    self._cv.notify_all()
