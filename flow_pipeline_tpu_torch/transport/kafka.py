"""Kafka adapters: the same frame contract on topic ``flows`` against a
real broker.

A copy of flow_pipeline_tpu/transport/kafka.py over the port's own wire
codec and FlowBatch. Against a real cluster these adapters speak the
FlowMessage contract of GoFlow, the reference mocker and ClickHouse's
Kafka-engine tables. The client import is gated: where no ``kafka``
module (kafka-python) imports, ``available()`` is False, constructing an
adapter raises, and every entry point that needs one exits with code 2.

- :class:`KafkaProducerAdapter` sends one message per flow, framed
  (``-proto.fixedlen``: ``wire.encode_frame``) or bare
  (``wire.encode_message``), on the client's partitioner or a pinned
  partition (``-produce.shard``).
- :class:`KafkaConsumerAdapter` commits by hand after the worker's flush
  (at-least-once), subscribes as a group member or, given
  ``partitions``, assigns them itself (the mesh member: the coordinator
  is the assignor) and seeks ``positions`` before its first poll. One
  broker poll may return several partitions' records: each becomes a
  batch of its own, queued, none dropped.

Fault sites: ``kafka.send`` and ``kafka.poll``.
"""

from __future__ import annotations

from collections import deque
from typing import Optional

from ..schema import wire
from ..schema.batch import FlowBatch
from ..utils.faults import FAULTS

_IMPORT_ERROR: Optional[str] = None
try:  # depends on the environment
    from kafka import KafkaConsumer as _KC, KafkaProducer as _KP  # type: ignore
except Exception as e:  # noqa: BLE001 -- any import failure gates it off
    _KC = _KP = None
    _IMPORT_ERROR = f"kafka-python not importable: {e}"


def available() -> bool:
    return _KP is not None


def _require() -> None:
    if not available():
        raise RuntimeError(
            f"real Kafka transport unavailable ({_IMPORT_ERROR}); "
            "use transport.InProcessBus")


class KafkaProducerAdapter:
    """transport.Producer's surface, against a broker."""

    def __init__(self, brokers: str, topic: str = "flows",
                 fixedlen: bool = False):
        _require()
        self._producer = _KP(bootstrap_servers=brokers.split(","))
        self.topic = topic
        self.fixedlen = fixedlen
        self.produced = 0

    def send(self, msg, partition: Optional[int] = None) -> None:
        """``partition`` pins the message (the mesh's key-hash shard
        contract); None keeps the client's partitioner."""
        if FAULTS.active:
            FAULTS.check("kafka.send")
        data = (wire.encode_frame(msg) if self.fixedlen
                else wire.encode_message(msg))
        self._producer.send(self.topic, data, partition=partition)
        self.produced += 1

    def flush(self) -> None:
        self._producer.flush()


class KafkaConsumerAdapter:
    """transport.Consumer's poll/commit surface, against a broker, with
    manual commits (``enable_auto_commit=False``): offsets reach the
    broker only when the worker commits after its flush."""

    def __init__(self, brokers: str, topic: str = "flows",
                 group: str = "tpu-processor", fixedlen: bool = False,
                 partitions: Optional[list[int]] = None):
        _require()
        self.topic = topic
        self.fixedlen = fixedlen
        self._pending: deque = deque()  # fetched, not yet returned
        # explicit ownership: assign() instead of the group's rebalancer,
        # so the broker never moves a partition under the mesh
        # coordinator. Offsets written to ``positions`` before the first
        # poll are seeked (the coordinator's resume frontier).
        self.partitions = partitions
        self.positions: dict[int, int] = {}
        self._seeked = partitions is None
        common = dict(bootstrap_servers=brokers.split(","), group_id=group,
                      enable_auto_commit=False,
                      auto_offset_reset="earliest")
        if partitions is None:
            self._consumer = _KC(topic, **common)
        else:
            from kafka import TopicPartition  # type: ignore

            self._consumer = _KC(**common)
            self._consumer.assign(
                [TopicPartition(topic, p) for p in partitions])

    def poll(self, max_messages: int = 8192) -> Optional[FlowBatch]:
        """One partition's batch per call; the other partitions' records
        of the same broker poll wait in the queue."""
        if FAULTS.active:
            FAULTS.check("kafka.poll")
        if self._pending:
            return self._pending.popleft()
        if not self._seeked:
            from kafka import TopicPartition  # type: ignore

            for p, off in self.positions.items():
                self._consumer.seek(TopicPartition(self.topic, p), off)
            self._seeked = True
        records = self._consumer.poll(timeout_ms=200,
                                      max_records=max_messages)
        for tp, msgs in records.items():
            if not msgs:
                continue
            if self.fixedlen:
                batch = FlowBatch.from_wire(b"".join(m.value for m in msgs))
            else:
                batch = FlowBatch.from_messages(
                    [wire.decode_message(m.value) for m in msgs])
            batch.partition = tp.partition
            batch.first_offset = msgs[0].offset
            batch.last_offset = msgs[-1].offset
            self._pending.append(batch)
        return self._pending.popleft() if self._pending else None

    def close(self) -> None:
        """Release the broker connection (a mesh member drops and rebuilds
        its consumer at every rebalance)."""
        self._consumer.close()

    def commit(self, partition: int, next_offset: int) -> None:
        from kafka import TopicPartition  # type: ignore
        from kafka.structs import OffsetAndMetadata  # type: ignore

        tp = TopicPartition(self.topic, partition)
        try:  # kafka-python >= 2.1: (offset, metadata, leader_epoch)
            om = OffsetAndMetadata(next_offset, "", -1)
        except TypeError:  # older: (offset, metadata)
            om = OffsetAndMetadata(next_offset, "")
        self._consumer.commit({tp: om})
