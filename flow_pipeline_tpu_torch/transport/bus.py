"""In-process partitioned bus with Kafka semantics.

Topics hold P append-only partition logs of opaque byte messages; consumers
address messages by (partition, offset) and commit offsets per consumer
group. Thread-safe. Keyless produce round-robins over partitions exactly
as the reference bus does, so a frames file lands on the same partitions
and offsets in both packages. The fault plan's ``bus.produce`` and
``bus.poll`` sites are checked where the reference checks them. Every
produce call stamps its wall clock on the partitions it appends to, so a
span fetch reports when its oldest message was produced: the guard's lag
signal (guard/controller.py).
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Iterable, Optional

from ..utils.faults import FAULTS


class InProcessBus:
    """A broker-less Kafka: partitioned logs + group offset commits."""

    def __init__(self):
        self._lock = threading.RLock()
        self._topics: dict[str, list[list[bytes]]] = {}
        # (group, topic, p) -> next offset
        self._commits: dict[tuple[str, str, int], int] = {}
        self._rr = 0  # keyless-produce round-robin cursor
        # the guard's lag signal: per (topic, partition) an ascending list
        # of (first offset of a produce call, wall clock), one entry per
        # produce CALL; an offset's stamp is found by bisect
        self._stamps: dict[str, list[list]] = {}

    def create_topic(self, topic: str, partitions: int = 2) -> None:
        """Idempotent; the reference's default is 2 partitions."""
        with self._lock:
            self._topics.setdefault(topic, [[] for _ in range(partitions)])
            self._stamps.setdefault(topic, [[] for _ in range(partitions)])

    def partitions(self, topic: str) -> int:
        with self._lock:
            return len(self._topics[topic])

    def produce(self, topic: str, value: bytes,
                partition: Optional[int] = None) -> tuple[int, int]:
        """Append one message (round-robin without a partition, as the
        reference's keyless produce); returns (partition, offset)."""
        if FAULTS.active:  # fault seam: produce
            FAULTS.check("bus.produce")
        with self._lock:
            if topic not in self._topics:
                self.create_topic(topic)
            parts = self._topics[topic]
            if partition is None:
                partition = self._rr % len(parts)
                self._rr += 1
            log = parts[partition]
            self._stamps[topic][partition].append((len(log), time.time()))
            log.append(value)
            return partition, len(log) - 1

    def produce_many(self, topic: str, values: Iterable[bytes],
                     partition: Optional[int] = None) -> int:
        """Bulk append under one lock; without a partition the values
        round-robin over the partitions in order."""
        if FAULTS.active:  # fault seam: produce
            FAULTS.check("bus.produce")
        values = list(values)
        now = time.time()
        with self._lock:
            if topic not in self._topics:
                self.create_topic(topic)
            parts = self._topics[topic]
            stamps = self._stamps[topic]
            if partition is not None:
                stamps[partition].append((len(parts[partition]), now))
                parts[partition].extend(values)
            else:
                np_ = len(parts)
                start = self._rr
                for i in range(np_):
                    chunk = values[i::np_]
                    if chunk:
                        p = (start + i) % np_
                        stamps[p].append((len(parts[p]), now))
                        parts[p].extend(chunk)
                self._rr += len(values)
        return len(values)

    def fetch_span(self, topic: str, partition: int, offset: int,
                   max_messages: int = 1024):
        """Up to max_messages from ``offset`` as ONE concatenated byte
        string: (data, first_offset, last_offset, produced_at), or None
        when caught up; produced_at is the wall clock the first message of
        the span was produced (0.0 if unstamped)."""
        if FAULTS.active:  # fault seam: consumer-side poll
            FAULTS.check("bus.poll")
        with self._lock:
            log = self._topics[topic][partition]
            end = min(len(log), offset + max_messages)
            if end <= offset:
                return None
            data = b"".join(log[offset:end])
            produced = self._stamp_at(topic, partition, offset)
        return data, offset, end - 1, produced

    def _stamp_at(self, topic: str, partition: int, offset: int) -> float:
        """Produce wall clock covering ``offset`` (0.0 if unstamped).
        The caller holds _lock."""
        stamps = self._stamps.get(topic)
        if not stamps:
            return 0.0
        log = stamps[partition]
        i = bisect.bisect_right(log, (offset, float("inf"))) - 1
        return log[i][1] if i >= 0 else 0.0

    def produced_at(self, topic: str, partition: int, offset: int) -> float:
        """The produce wall clock of the message at ``offset``."""
        with self._lock:
            return self._stamp_at(topic, partition, offset)

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

    def lag(self, group: str, topic: str) -> int:
        """Messages the group has not committed, over all partitions."""
        with self._lock:
            return sum(
                len(log) - self._commits.get((group, topic, p), 0)
                for p, log in enumerate(self._topics[topic]))
