"""In-process partitioned bus with Kafka semantics.

Topics hold P append-only partition logs of opaque byte messages; consumers
address messages by (partition, offset) and commit offsets per consumer
group. Thread-safe. Keyless produce round-robins over partitions exactly
as the reference bus does, so a frames file lands on the same partitions
and offsets in both packages.
"""

from __future__ import annotations

import threading
from typing import Iterable, Optional


class InProcessBus:
    """A broker-less Kafka: partitioned logs + group offset commits."""

    def __init__(self):
        self._lock = threading.RLock()
        self._topics: dict[str, list[list[bytes]]] = {}
        # (group, topic, p) -> next offset
        self._commits: dict[tuple[str, str, int], int] = {}
        self._rr = 0  # keyless-produce round-robin cursor

    def create_topic(self, topic: str, partitions: int = 2) -> None:
        """Idempotent; the reference's default is 2 partitions."""
        with self._lock:
            self._topics.setdefault(topic, [[] for _ in range(partitions)])

    def partitions(self, topic: str) -> int:
        with self._lock:
            return len(self._topics[topic])

    def produce_many(self, topic: str, values: Iterable[bytes],
                     partition: Optional[int] = None) -> int:
        """Bulk append under one lock; without a partition the values
        round-robin over the partitions in order."""
        values = list(values)
        with self._lock:
            if topic not in self._topics:
                self.create_topic(topic)
            parts = self._topics[topic]
            if partition is not None:
                parts[partition].extend(values)
            else:
                np_ = len(parts)
                start = self._rr
                for i in range(np_):
                    chunk = values[i::np_]
                    if chunk:
                        parts[(start + i) % np_].extend(chunk)
                self._rr += len(values)
        return len(values)

    def fetch_span(self, topic: str, partition: int, offset: int,
                   max_messages: int = 1024):
        """Up to max_messages from ``offset`` as ONE concatenated byte
        string: (data, first_offset, last_offset), or None when caught
        up."""
        with self._lock:
            log = self._topics[topic][partition]
            end = min(len(log), offset + max_messages)
            if end <= offset:
                return None
            return b"".join(log[offset:end]), offset, end - 1

    # ---- consumer-group offsets ------------------------------------------

    def committed(self, group: str, topic: str, partition: int) -> int:
        """Next offset to read for the group (0 if never committed)."""
        with self._lock:
            return self._commits.get((group, topic, partition), 0)

    def commit(self, group: str, topic: str, partition: int,
               next_offset: int) -> None:
        """Record that the group has durably processed offsets <
        next_offset. Commits never move backwards."""
        with self._lock:
            key = (group, topic, partition)
            if next_offset > self._commits.get(key, 0):
                self._commits[key] = next_offset
