"""Per-chunk structured tracing with a flight recorder.

A copy of flow_pipeline_tpu/obs/trace.py (stdlib only). One chunk's life
spans several threads: the feed thread (fetch and decode), the worker
(the device step) and the sink writes. This module records per-chunk
spans (name, chunk id, thread, wall interval) into a fixed-size,
lock-safe ring, so the last spans of pipeline causality can be read from
a live process through the metrics server's ``/debug/trace``, or from
the dump the worker writes on an unhandled error.

Modes (``-obs.trace``, env fallback ``FLOWTPU_TRACE``):

- ``off``: recording disabled; ``span()`` costs one attribute read.
- ``ring``: the default; spans land in the bounded ring, the oldest
  overwritten.
- ``always``: every span is kept (unbounded), for tests and short
  diagnostic runs.

Export is Chrome trace-event JSON (``traceEvents`` of ``ph: "X"``
complete events), loadable in Perfetto or chrome://tracing; spans with
the same ``chunk`` arg line up across thread tracks.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Optional

TRACE_MODES = ("off", "ring", "always")

# One process-wide chunk-id mint: Consumer.poll stamps every decoded
# FlowBatch, and the id rides PreparedBatch -> executor queue -> worker
# apply -> flush jobs, tying one chunk's spans together across threads.
_CHUNK_IDS = itertools.count(1)


def next_chunk_id() -> int:
    return next(_CHUNK_IDS)


class TraceRecorder:
    """Fixed-size span ring buffer (mode "ring") or unbounded span list
    (mode "always"), safe to record into from any thread."""

    def __init__(self, capacity: int = 8192,
                 mode: Optional[str] = None):
        if capacity < 1:
            raise ValueError("trace ring capacity must be >= 1")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._ring: list = [None] * capacity
        self._next = 0
        self._dropped = 0
        self._always: list = []
        self._mode = "off"
        # flowguard: level >= 1 pauses recording — the flight recorder
        # is optional work, dropped before any DATA is. Pausing keeps
        # the ring's existing spans (a post-mortem still sees the lead-up
        # to the overload); configure() resets it.
        self.paused = False
        self.configure(mode if mode is not None
                       else os.environ.get("FLOWTPU_TRACE", "ring"))

    # ---- configuration ----------------------------------------------------

    def configure(self, mode: str) -> "TraceRecorder":
        if mode not in TRACE_MODES:
            raise ValueError(
                f"obs.trace must be one of {'|'.join(TRACE_MODES)}, "
                f"got {mode!r}")
        with self._lock:
            self._mode = mode
            self._ring = [None] * self.capacity
            self._next = 0
            self._dropped = 0
            self._always = []
            self.paused = False
        return self

    @property
    def mode(self) -> str:
        return self._mode

    # ---- recording --------------------------------------------------------

    def record(self, name: str, t0: float, t1: float,
               chunk: Optional[int] = None, **args) -> None:
        """One completed span. t0/t1 are time.time() seconds (wall clock
        — the Chrome format's ``ts`` is an absolute microsecond epoch);
        extra kwargs land in the event's ``args``."""
        if self._mode == "off" or self.paused:
            return
        ev = (name, t0, t1, threading.current_thread().name, chunk,
              args or None)
        with self._lock:
            if self._mode == "always":
                self._always.append(ev)
                return
            if self._ring[self._next] is not None:
                self._dropped += 1
            self._ring[self._next] = ev
            self._next = (self._next + 1) % self.capacity

    @contextlib.contextmanager
    def span(self, name: str, chunk: Optional[int] = None, **args):
        """Record the wrapped block as one span. Near-free when off."""
        if self._mode == "off" or self.paused:
            yield
            return
        t0 = time.time()
        try:
            yield
        finally:
            self.record(name, t0, time.time(), chunk, **args)

    # ---- export -----------------------------------------------------------

    def snapshot(self) -> list:
        """Recorded spans, oldest first."""
        with self._lock:
            if self._mode == "always":
                return list(self._always)
            out = self._ring[self._next:] + self._ring[:self._next]
        return [ev for ev in out if ev is not None]

    def chrome_trace(self) -> dict:
        """The Chrome trace-event JSON object (Perfetto-loadable):
        complete ("ph": "X") events with microsecond timestamps, one
        ``tid`` per recording thread, chunk ids under ``args.chunk``."""
        events = []
        pid = os.getpid()
        for name, t0, t1, thread, chunk, args in self.snapshot():
            ev = {
                "name": name,
                "ph": "X",
                "ts": round(t0 * 1e6, 1),
                "dur": round((t1 - t0) * 1e6, 1),
                "pid": pid,
                "tid": thread,
            }
            a = dict(args) if args else {}
            if chunk is not None:
                a["chunk"] = chunk
            if a:
                ev["args"] = a
            events.append(ev)
        with self._lock:
            dropped = self._dropped
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "source": "flow-pipeline-tpu flowtrace",
                "mode": self._mode,
                "dropped_spans": dropped,
            },
        }

    def dump(self, path: str) -> str:
        """Write the Chrome trace JSON to ``path``; returns the path."""
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path

    def dump_on_error(self, tag: str = "worker") -> Optional[str]:
        """Best-effort flight-recorder dump for an unhandled error —
        never raises (the original exception must win), returns the
        written path or None. The dump goes next to the system tempdir
        so a crash-looping worker leaves a breadcrumb per process."""
        if self._mode == "off":
            return None
        import tempfile

        path = os.path.join(
            tempfile.gettempdir(),
            f"flowtrace-{tag}-{os.getpid()}.json")
        try:
            return self.dump(path)
        except Exception:  # noqa: BLE001 — the original error must win
            return None


# The process-wide recorder every pipeline stage records into. Tests
# and bench legs reconfigure it per leg (configure() resets the ring).
TRACER = TraceRecorder()
