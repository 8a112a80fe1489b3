"""Consumer: bus -> decoded FlowBatch with offset bookkeeping.

Offsets are committed explicitly by the caller after its downstream
flush (at-least-once). Partitions are polled round-robin, one partition
per poll, exactly as the reference consumer does, so both packages see
the same batches in the same order. Each decoded batch gets a chunk id
and a ``decode`` span in the trace ring, and the fetch and decode feed
the ``flow_summary_consume_{fetch,decode}_time_us`` stage summaries.
"""

from __future__ import annotations

import time
from typing import Optional

from ..obs.trace import TRACER, next_chunk_id
from ..obs.tracing import StageTimer
from ..schema.batch import FlowBatch
from .bus import InProcessBus

# feed-path stage timing; every consumer feeds the one process registry
_STAGES = StageTimer()


class Consumer:
    """Single-group consumer over all partitions of a topic. Only
    length-prefixed (framed) topics are supported."""

    def __init__(self, bus: InProcessBus, topic: str = "flows",
                 group: str = "tpu-processor",
                 partitions: Optional[list[int]] = None):
        self.bus = bus
        self.topic = topic
        self.group = group
        self.partitions = (partitions if partitions is not None
                           else list(range(bus.partitions(topic))))
        # next offset to READ per partition (resumes from the last commit)
        self.positions = {p: bus.committed(group, topic, p)
                          for p in self.partitions}
        self._rr_idx = 0

    def poll(self, max_messages: int = 8192) -> Optional[FlowBatch]:
        """Up to max_messages from the next partition that has data,
        decoded into one batch (offsets stay contiguous). None when fully
        caught up."""
        for p in self._rotation():
            with _STAGES.stage("consume_fetch"):
                span = self.bus.fetch_span(self.topic, p, self.positions[p],
                                           max_messages)
            if span is None:
                continue
            data, first, last, produced = span
            t0 = time.time()
            with _STAGES.stage("consume_decode"):
                batch = FlowBatch.from_wire(data)
            batch.partition = p
            batch.first_offset = first
            batch.last_offset = last
            # the guard's lag signal: when the span's oldest message was
            # produced
            batch.produced_at = produced
            self.positions[p] = last + 1
            # decode is where a chunk is born: mint its trace id here
            batch.chunk_id = next_chunk_id()
            TRACER.record("decode", t0, time.time(), chunk=batch.chunk_id,
                          rows=len(batch), partition=p)
            return batch
        return None

    def _rotation(self):
        # rotate the start partition so one hot partition cannot starve
        # the others
        if not self.partitions:
            return []
        first = self._rr_idx % len(self.partitions)
        self._rr_idx += 1
        return self.partitions[first:] + self.partitions[:first]

    def commit(self, partition: int, next_offset: int) -> None:
        """Call after downstream flush covers offsets < next_offset."""
        self.bus.commit(self.group, self.topic, partition, next_offset)

    def lag(self) -> int:
        return self.bus.lag(self.group, self.topic)
