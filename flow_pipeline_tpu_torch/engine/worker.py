"""StreamWorker: the processor's service loop.

Counterpart of flow_pipeline_tpu/engine/worker.py: poll a batch, run it
through the models (one fused step per chunk by default, engine/fused.py;
every model's own ``update`` when the set is not fusable or ``fused`` is
off, the reference's ``-processor.fused=false`` branch), emit the rows of
closed windows (flows_5m rows, ranked tables, DDoS alerts) to the sinks,
then commit the offsets the emitted state covers (at-least-once). With
``prefetch > 0`` the consumer is wrapped in a PrefetchConsumer, so the
next batch is fetched and decoded while this one runs. Guard, serving,
the pipelined ingest runtime and its flusher thread, checkpoints and the
audit are not ported.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Sequence

from ..models.ddos import DDoSDetector
from ..models.heavy_hitter import HeavyHitterModel
from ..models.window_agg import WindowAggregator
from .fused import FusedPipeline
from .prefetch import PrefetchConsumer
from .windowed import WindowedHeavyHitter

_MODEL_TYPES = (WindowedHeavyHitter, WindowAggregator, DDoSDetector)

log = logging.getLogger("flow_pipeline_tpu_torch.worker")


class StreamWorker:
    """Drives models from a consumer; emits rows to sinks.

    models: {"name": WindowedHeavyHitter | WindowAggregator |
    DDoSDetector}; sinks: objects with write(table, rows); poll_max: rows
    per poll (the processor's batch); prefetch: decoded batches fetched
    ahead (0 polls inline); fused: one fused step per chunk when the
    model set supports it (the reference's defaults: 2 and True).
    """

    def __init__(self, consumer, models: dict[str, Any],
                 sinks: Sequence[Any] = (), poll_max: int = 8192,
                 prefetch: int = 2, fused: bool = True):
        for name, model in models.items():
            if not isinstance(model, _MODEL_TYPES):
                raise TypeError(f"model {name!r}: {type(model).__name__} is "
                                "not a ported model type")
        if prefetch and consumer is not None and not isinstance(
                consumer, PrefetchConsumer):
            consumer = PrefetchConsumer(consumer, depth=prefetch,
                                        poll_max=poll_max)
        self.consumer = consumer
        self.fused = None
        if fused and models:
            if FusedPipeline.supported(models):
                self.fused = FusedPipeline(models)
            else:
                log.info("model set not fusable; using per-model updates")
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
        says (a fused step counts one for every family)."""
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
        if self.fused is not None:
            self.fused.update(batch)
        else:
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
        is a finite frames file). The prefetch thread is stopped on the
        way out, also when a step raises."""
        try:
            while self.run_once():
                pass
            self.finalize()
        finally:
            if isinstance(self.consumer, PrefetchConsumer):
                try:  # best effort: never mask the step's own error
                    self.consumer.stop()
                except Exception:  # noqa: BLE001 -- logged, unwinding
                    log.exception("prefetch stop failed during unwind")

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
        """Drain everything (end of stream / shutdown) and stop the
        prefetch thread."""
        self.flush_closed(force=True)
        self.commit()
        if isinstance(self.consumer, PrefetchConsumer):
            self.consumer.stop()

    def commit(self) -> None:
        """Commit the offsets covered by emitted state."""
        self._emitted_since_commit = False
        for partition, next_off in sorted(self._covered.items()):
            self.consumer.commit(partition, next_off)
        if isinstance(self.consumer, PrefetchConsumer):
            # the commits run on the feed thread: wait for them
            self.consumer.flush_commits()
