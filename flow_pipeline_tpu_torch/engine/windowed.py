"""Window-driving wrapper for the heavy-hitter model.

Counterpart of flow_pipeline_tpu/engine/windowed.py without the mesh
capture, audit and lazy-extraction seams: rows are split by tumbling
window slot, a window closes when a later slot arrives (its top-K rows
are extracted, then the sketch is reset), and rows of an already closed
slot are dropped and counted.
"""

from __future__ import annotations

import numpy as np

from ..device import DEFAULT_DEVICE
from ..models.heavy_hitter import HeavyHitterConfig, HeavyHitterModel
from ..models.oracle import SECONDS_PER_SLOT
from ..schema.batch import FlowBatch


class WindowedHeavyHitter:
    """Tumbling-window top-K: update(batch) per batch; flush() yields rows
    for closed windows (one reset sketch per window)."""

    def __init__(self, config: HeavyHitterConfig = HeavyHitterConfig(),
                 window_seconds: int = SECONDS_PER_SLOT, k: int = 100,
                 device=DEFAULT_DEVICE):
        self.config = config
        self.window_seconds = window_seconds
        self.k = k
        self.model = HeavyHitterModel(config, device=device)
        self.current_slot: int | None = None
        self._pending: list[dict] = []
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
        # extract BEFORE reset: the sketch is updated in place
        top = self.model.top(self.k)
        top["timeslot"] = np.full(len(top["valid"]), self.current_slot,
                                  dtype=np.uint64)
        self._pending.append(top)
        self.model.reset()

    def flush(self, force: bool = False) -> list[dict]:
        """Rows for closed windows (and the open one too, when force)."""
        if force and self.current_slot is not None:
            self._close()
            self.current_slot = None
        out, self._pending = self._pending, []
        return out
