"""StreamWorker: the processor's service loop.

Counterpart of flow_pipeline_tpu/engine/worker.py, the per-model path
(the reference's ``-processor.fused=false`` branch): poll a batch, hand it
to every model's ``update``, emit the rows of closed windows (flows_5m
rows, ranked tables, DDoS alerts) to the sinks, then commit the offsets
the emitted state covers (at-least-once). Guard, serving, the pipelined
ingest runtime and its flusher thread, fused pipelines, checkpoints and
the audit are not ported.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Sequence

from ..models.ddos import DDoSDetector
from ..models.heavy_hitter import HeavyHitterModel
from ..models.window_agg import WindowAggregator
from .windowed import WindowedHeavyHitter

_MODEL_TYPES = (WindowedHeavyHitter, WindowAggregator, DDoSDetector)

log = logging.getLogger("flow_pipeline_tpu_torch.worker")


class StreamWorker:
    """Drives models from a consumer; emits rows to sinks.

    models: {"name": WindowedHeavyHitter | WindowAggregator |
    DDoSDetector}; sinks: objects with write(table, rows); poll_max: rows
    per poll (the processor's batch).
    """

    def __init__(self, consumer, models: dict[str, Any],
                 sinks: Sequence[Any] = (), poll_max: int = 8192):
        for name, model in models.items():
            if not isinstance(model, _MODEL_TYPES):
                raise TypeError(f"model {name!r}: {type(model).__name__} is "
                                "not a ported model type")
        self.consumer = consumer
        self.models = models
        self.sinks = list(sinks)
        self.poll_max = poll_max
        self.batches_seen = 0
        self.flows_seen = 0
        # seconds spent in the models' update calls (host clock; device
        # work may still be queued when it stops)
        self.update_seconds = 0.0
        self._covered: dict[int, int] = {}  # partition -> next offset
        self._emitted_since_commit = False

    @property
    def chunk_updates(self) -> int:
        """Padded chunks the heavy-hitter families ran, summed: each is
        one CMS update, conservative or linear as the family's config
        says."""
        return sum(m.model.chunk_updates for m in self.models.values()
                   if isinstance(m, WindowedHeavyHitter)
                   and isinstance(m.model, HeavyHitterModel))

    # ---- main loop --------------------------------------------------------

    def run_once(self) -> bool:
        """Poll one batch through the pipeline. Returns False when idle."""
        batch = self.consumer.poll(self.poll_max)
        if batch is None or len(batch) == 0:
            return False
        t0 = time.perf_counter()
        for model in self.models.values():
            model.update(batch)
        self.update_seconds += time.perf_counter() - t0
        self.batches_seen += 1
        self.flows_seen += len(batch)
        if batch.last_offset >= 0:
            prev = self._covered.get(batch.partition, 0)
            self._covered[batch.partition] = max(prev, batch.last_offset + 1)
        self.flush_closed()
        # commit right after a flush that emitted rows: a replay from
        # older offsets would re-emit those windows. (Checkpoints are not
        # ported, so the open window's state does not survive a crash.)
        if self._emitted_since_commit:
            self.commit()
        return True

    def run(self) -> None:
        """Process until the consumer is caught up, then drain (the input
        is a finite frames file)."""
        while self.run_once():
            pass
        self.finalize()

    # ---- flushing ---------------------------------------------------------

    def flush_closed(self, force: bool = False) -> None:
        """Emit rows for closed (or all, when force) windows."""
        for name, model in self.models.items():
            if isinstance(model, WindowAggregator):
                rows = model.flush(force)
                if len(rows["timeslot"]):
                    self._emit(name, rows, len(rows["timeslot"]))
            elif isinstance(model, WindowedHeavyHitter):
                for top in model.flush(force):
                    self._emit(name, top, int(top["valid"].sum()))
            else:  # DDoSDetector
                if force:
                    model.close_sub_window()
                if model.alerts:
                    alerts, model.alerts = model.alerts, []
                    self._emit(name, alerts, len(alerts))

    def _emit(self, table: str, rows, n_rows: int) -> None:
        self._emitted_since_commit = True
        for sink in self.sinks:
            sink.write(table, rows)
        log.info("flushed table=%s rows=%d", table, n_rows)

    def finalize(self) -> None:
        """Drain everything (end of stream / shutdown)."""
        self.flush_closed(force=True)
        self.commit()

    def commit(self) -> None:
        """Commit the offsets covered by emitted state."""
        self._emitted_since_commit = False
        for partition, next_off in sorted(self._covered.items()):
            self.consumer.commit(partition, next_off)
