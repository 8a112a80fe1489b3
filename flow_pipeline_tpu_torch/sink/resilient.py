"""Sink resilience: bounded retries and a replayable dead-letter spill.

A copy of flow_pipeline_tpu/sink/resilient.py. :class:`ResilientSink`
wraps any sink:

1. **Retry**: bounded exponential backoff with jitter
   (``utils/retry.py``) around the inner ``write()``; transient faults
   (and injected ``sink.write`` faults) never surface.
2. **Dead-letter**: a batch that exhausts its retries is written to
   ``<dir>/deadletter/`` as one atomic JSON file (records normalized by
   ``rows_to_records``, so a spill is sink-agnostic) and the write
   returns: the worker survives and commits past the batch, and the rows
   stay durable on disk.
3. **Replay**: :func:`replay_deadletter` re-ingests the spill into any
   sinks. The file format is the reference's, so either package replays
   the other's spill.

Without a dead-letter directory the wrapper retries and then re-raises:
the step fails, its offsets stay uncommitted and the input replays on
restart.

Metrics (registered at construction): ``sink_write_retries_total{table}``,
``sink_write_failures_total{table}`` (exhausted batches),
``sink_deadletter_total{table}`` (spilled) and ``sink_deadletter_depth``
(files on disk).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional, Sequence

from ..obs.metrics import REGISTRY
from ..utils import fsutil
from ..utils.faults import FAULTS
from ..utils.retry import retry_call
from .base import rows_to_records

log = logging.getLogger("flow_pipeline_tpu_torch.sink")


class _TransientSinkError(Exception):
    """Wrapper marking an inner-sink exception as retryable: the retry
    filter must be a positive list (this + OSError for injected/real
    transport faults), never bare Exception — NON_RETRYABLE bugs pass
    through untouched. ``__cause__`` carries the real error."""

DEADLETTER_SUBDIR = "deadletter"

# Deterministic-bug exceptions: retrying these only triples their
# latency, and SPILLING them would park a poison batch at the head of
# the dead-letter queue (replay stops at the first failure to preserve
# order, so one poison file wedges every recoverable batch behind it).
# They re-raise immediately — fail the step loudly, offsets uncommitted,
# the crash-and-replay contract. Everything else (a DB client's
# OperationalError, sqlite "database is locked", HTTP errors — many of
# which are NOT OSError subclasses) is treated as potentially transient:
# retried, then dead-lettered.
NON_RETRYABLE = (TypeError, ValueError, KeyError, IndexError,
                 AttributeError)

SINK_METRICS = {
    "retries": ("sink_write_retries_total",
                "sink write attempts retried after a transient failure "
                "(label: table)"),
    "failures": ("sink_write_failures_total",
                 "sink writes that exhausted their retry budget "
                 "(label: table)"),
    "dead": ("sink_deadletter_total",
             "batches spilled to the dead-letter directory "
             "(label: table)"),
    "depth": ("sink_deadletter_depth",
              "dead-letter files currently on disk awaiting replay"),
}


def _register_metrics() -> dict:
    return {
        "retries": REGISTRY.counter(*SINK_METRICS["retries"]),
        "failures": REGISTRY.counter(*SINK_METRICS["failures"]),
        "dead": REGISTRY.counter(*SINK_METRICS["dead"]),
        "depth": REGISTRY.gauge(*SINK_METRICS["depth"]),
    }


class ResilientSink:
    """Retry + dead-letter wrapper around one inner sink. The wrapper is
    transparent for the pass-through surfaces the worker probes
    (``archive_raw``/``check_raw_schema``/``query``/``tables``)."""

    def __init__(self, inner, retries: int = 4, backoff: float = 0.05,
                 backoff_max: float = 2.0, jitter: float = 0.25,
                 deadletter_dir: Optional[str] = None, sleep=time.sleep):
        self.inner = inner
        self.retries = max(1, int(retries))
        self.backoff = backoff
        self.backoff_max = backoff_max
        self.jitter = jitter
        self._sleep = sleep
        self._seq = 0
        self._m = _register_metrics()
        self.deadletter_dir = None
        if deadletter_dir:
            self.deadletter_dir = os.path.join(deadletter_dir,
                                               DEADLETTER_SUBDIR)
            os.makedirs(self.deadletter_dir, exist_ok=True)
            # a restart must report the backlog it inherited, not 0
            self._m["depth"].set(len(self._dlq_files()))

    # ---- pass-throughs (duck-typed sink surfaces) --------------------------

    def __getattr__(self, name):
        # archive_raw / check_raw_schema / query / tables / close:
        # resolved on the inner sink so the worker's feature probes see
        # the wrapped sink's real capabilities
        return getattr(self.inner, name)

    # ---- the resilient write ----------------------------------------------

    def write(self, table: str, rows) -> None:
        def attempt():
            if FAULTS.active:
                FAULTS.check("sink.write")
            try:
                self.inner.write(table, rows)
            except NON_RETRYABLE:
                # a deterministic bug, not an outage: no retry, no
                # poison spill — fail the step (see NON_RETRYABLE)
                raise
            except Exception as e:
                raise _TransientSinkError(e) from e

        def on_retry(i, exc, delay):
            self._m["retries"].inc(table=table)
            log.warning("sink write %s failed (%s); retry %d/%d in "
                        "%.2fs", table, exc.__cause__ or exc, i + 1,
                        self.retries - 1, delay)

        try:
            retry_call(attempt, attempts=self.retries, base=self.backoff,
                       cap=self.backoff_max, jitter=self.jitter,
                       retry_on=(_TransientSinkError, OSError),
                       sleep=self._sleep, on_retry=on_retry)
            return
        except NON_RETRYABLE:
            raise
        except Exception as e:  # noqa: BLE001 -- exhausted: dead-letter or re-raise
            self._m["failures"].inc(table=table)
            cause = e.__cause__ if isinstance(e, _TransientSinkError) \
                else e
            if self.deadletter_dir is None:
                raise cause from None
            self._spill(table, rows, cause)

    def _spill(self, table: str, rows, exc: BaseException) -> None:
        """Frame one exhausted batch to the dead-letter directory
        (atomic tmp+rename; records pre-normalized so replay is
        sink-agnostic). Never raises on the happy path — the whole
        point is that the worker survives."""
        records = rows_to_records(rows)
        self._seq += 1
        name = (f"{int(time.time() * 1000):013d}-{os.getpid()}-"
                f"{self._seq:06d}-{table}.dlq.json")
        path = os.path.join(self.deadletter_dir, name)
        doc = {"table": table, "records": records,
               "spilled_at": time.time(), "error": repr(exc),
               "version": 1}
        # the whole atomic-publish sentence in one call: write a temp,
        # fsync it, atomically replace, fsync the directory entry — a
        # power loss can never drop or tear a spill the worker already
        # committed past
        fsutil.write_bytes_durable(
            path, json.dumps(doc, default=str).encode("utf-8"))
        self._m["dead"].inc(table=table)
        self._m["depth"].set(len(self._dlq_files()))
        log.error("sink write %s exhausted %d attempts (%s); %d rows "
                  "dead-lettered to %s (replay with replay_deadletter)",
                  table, self.retries, exc, len(records), path)

    def _dlq_files(self) -> list[str]:
        if self.deadletter_dir is None or \
                not os.path.isdir(self.deadletter_dir):
            return []
        return sorted(f for f in os.listdir(self.deadletter_dir)
                      if f.endswith(".dlq.json"))


def deadletter_files(root_dir: str) -> list[str]:
    """Absolute paths of the spill files under ``root_dir`` (accepts
    either the sink root or the deadletter/ subdir itself), oldest
    first (names sort by spill time)."""
    d = root_dir
    if os.path.basename(os.path.normpath(d)) != DEADLETTER_SUBDIR:
        d = os.path.join(d, DEADLETTER_SUBDIR)
    if not os.path.isdir(d):
        return []
    return [os.path.join(d, f) for f in sorted(os.listdir(d))
            if f.endswith(".dlq.json")]


def replay_deadletter(root_dir: str, sinks: Sequence,
                      delete: bool = True) -> tuple[int, int]:
    """Re-ingest every dead-letter file into ``sinks`` in spill order.
    A file is deleted only after EVERY sink accepted it (at-least-once:
    a replay crash re-replays — merging tables absorb repeats the same
    way they absorb worker replays). Returns (files_replayed,
    rows_replayed); the first failing file aborts the run so ordering
    is preserved for the next attempt."""
    files = deadletter_files(root_dir)
    n_rows = 0
    m = _register_metrics()
    for i, path in enumerate(files):
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        table, records = doc["table"], doc["records"]
        try:
            for sink in sinks:
                sink.write(table, records)
        except Exception as e:  # noqa: BLE001 -- stop at the first failure, keep order
            log.error("replay of %s failed (%s); %d file(s) left in "
                      "place", path, e, len(files) - i)
            raise
        n_rows += len(records)
        if delete:
            # no dir-fsync after removing a replayed spill: a crash
            # resurrects the file and it replays again (at-least-once)
            os.remove(path)
        log.info("replayed %d rows into %s from %s", len(records), table,
                 os.path.basename(path))
    m["depth"].set(len(deadletter_files(root_dir)))
    return len(files), n_rows
