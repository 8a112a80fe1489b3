"""Window-driving wrapper for the ranked models.

Counterpart of flow_pipeline_tpu/engine/windowed.py without the mesh
capture seam: rows are split by tumbling window slot, a window closes
when a later slot arrives (its top-K rows are extracted, then the model
is reset), and rows of an already closed slot are dropped and counted.
The backing model is a HeavyHitterModel by default; ``model_cls``
DenseTopKModel serves the port tables and SpreadModel the spread
detectors.

With ``lazy_extract`` (the pipelined ingest runtime sets it) a close
captures the window's state as a LazyWindowTop and the extraction runs
later, on the background flusher. The port updates a sketch's CMS counts
IN PLACE, so a capture is safe only because nothing writes into the
captured tensors after the close: ``reset()`` of every ranked model
binds fresh tensors (hh_init, dense_init, spread_init), every later
update writes those, and the spread model, whose registers the host
update writes in place, copies them at the capture.
"""

from __future__ import annotations

import numpy as np

from ..device import DEFAULT_DEVICE
from ..models.heavy_hitter import HeavyHitterConfig, HeavyHitterModel
from ..models.oracle import SECONDS_PER_SLOT
from ..schema.batch import FlowBatch


class LazyWindowTop:
    """Deferred top-K extraction of one closed window: ``resolve()``
    materializes the rows wherever the flusher runs it."""

    __slots__ = ("_thunk", "timeslot")

    def __init__(self, thunk, timeslot: int):
        self._thunk = thunk
        self.timeslot = timeslot

    def resolve(self) -> dict:
        top = self._thunk()
        top["timeslot"] = np.full(len(top["valid"]), self.timeslot,
                                  dtype=np.uint64)
        return top


class WindowedHeavyHitter:
    """Tumbling-window top-K: update(batch) per batch; flush() yields rows
    for closed windows (one reset sketch per window)."""

    def __init__(self, config: HeavyHitterConfig = HeavyHitterConfig(),
                 window_seconds: int = SECONDS_PER_SLOT, k: int = 100,
                 model_cls=HeavyHitterModel, device=DEFAULT_DEVICE):
        self.config = config
        self.window_seconds = window_seconds
        self.k = k
        self.model = model_cls(config, device=device)
        self.current_slot: int | None = None
        # the sketch audit's seam (obs/audit.py): called with (closing
        # slot, model) before a close extracts, so the audit seals its
        # cohort against the closing state; the host-grouped pipelines
        # set it under -obs.audit
        self.audit_hook = None
        # close windows as LazyWindowTop handles (the worker sets it in
        # pipelined mode when the model can capture its state)
        self.lazy_extract = False
        self._pending: list = []  # dicts, or LazyWindowTop when lazy
        # Sketch windows cannot reopen (the sketch was reset at close), so
        # rows older than the current slot are dropped and counted here.
        self.late_flows_dropped = 0

    def update(self, batch: FlowBatch) -> None:
        if len(batch) == 0:
            return
        slots = (batch.columns["time_received"].astype(np.int64)
                 // self.window_seconds * self.window_seconds)
        for slot in np.unique(slots):
            idx = np.flatnonzero(slots == slot)
            part = FlowBatch({k: v[idx] for k, v in batch.columns.items()},
                             batch.partition)
            slot = int(slot)
            if self.current_slot is None:
                self.current_slot = slot
            elif slot > self.current_slot:
                self._close()
                self.current_slot = slot
            elif slot < self.current_slot:
                self.late_flows_dropped += len(part)
                continue
            self.model.update(part)

    def _close(self) -> None:
        if self.audit_hook is not None:
            self.audit_hook(self.current_slot, self.model)
        if self.lazy_extract and hasattr(self.model, "top_lazy"):
            self._pending.append(LazyWindowTop(
                self.model.top_lazy(self.k), self.current_slot))
        else:
            # extract BEFORE reset: a sketch is updated in place
            top = self.model.top(self.k)
            top["timeslot"] = np.full(len(top["valid"]), self.current_slot,
                                      dtype=np.uint64)
            self._pending.append(top)
        self.model.reset()

    def flush(self, force: bool = False) -> list:
        """Rows for closed windows (and the open one too, when force):
        dicts, or unresolved LazyWindowTop handles under lazy_extract."""
        if force and self.current_slot is not None:
            self._close()
            self.current_slot = None
        out, self._pending = self._pending, []
        return out
