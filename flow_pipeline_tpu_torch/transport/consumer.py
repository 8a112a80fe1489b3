"""Consumer: bus -> decoded FlowBatch with offset bookkeeping.

Offsets are committed explicitly by the caller after its downstream
flush (at-least-once). Partitions are polled round-robin, one partition
per poll, exactly as the reference consumer does, so both packages see
the same batches in the same order.
"""

from __future__ import annotations

from typing import Optional

from ..schema.batch import FlowBatch
from .bus import InProcessBus


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
            span = self.bus.fetch_span(self.topic, p, self.positions[p],
                                       max_messages)
            if span is None:
                continue
            data, first, last = span
            batch = FlowBatch.from_wire(data)
            batch.partition = p
            batch.first_offset = first
            batch.last_offset = last
            self.positions[p] = last + 1
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
