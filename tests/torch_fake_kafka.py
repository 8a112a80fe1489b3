"""An in-memory broker behind the part of the kafka-python surface that
both packages' Kafka adapters use (transport/kafka.py), for tests and
chip_smoke.py on machines without a Kafka client or broker.

- ``KafkaProducer(bootstrap_servers=...)``: ``send(topic, value,
  partition=None)``, ``flush()``, ``close()``. A message without a
  partition goes to the next one round-robin, per producer: the same
  sends land alike on every run.
- ``KafkaConsumer(*topics, bootstrap_servers, group_id,
  enable_auto_commit, auto_offset_reset)``: subscribed to the topic's
  every partition, or ``assign([TopicPartition])``; ``seek(tp, offset)``;
  ``poll(timeout_ms, max_records)`` returns ``{TopicPartition: [record]}``
  (records with ``.value`` and ``.offset``), up to ``max_records`` in
  all, starting one partition further round every poll, so one poll may
  hold several partitions' records; ``commit({tp: OffsetAndMetadata})``;
  ``close()``. A consumer starts at its group's committed offset, else
  at the earliest.
- ``TopicPartition`` and ``structs.OffsetAndMetadata`` (kafka-python
  2.1's three fields; ``installed(..., offset_arity=2)`` gives the older
  two).

A broker with ``interrupt_when_drained`` raises KeyboardInterrupt from a
poll that finds nothing left, which is how a Kafka-fed entry of either
package stops (the reference's loops end only on an interrupt); the poll
must then run on the entry's own thread (``-feed.prefetch 0`` and
``-processor.hostassist off``).

``installed(broker)`` puts the client module in ``sys.modules`` as
``kafka`` and ``kafka.structs`` and its classes into both packages'
``transport.kafka`` (or into the port's alone), and restores all of it
on exit. This is a module of
helpers, not a ``kafka`` package: a package of that name under tests/
would be importable in every test process, and the reference's gate
would find it.
"""

from __future__ import annotations

import contextlib
import importlib
import sys
import threading
import types
from collections import namedtuple

TopicPartition = namedtuple("TopicPartition", "topic partition")
OffsetAndMetadata = namedtuple("OffsetAndMetadata",
                               "offset metadata leader_epoch")
OffsetAndMetadata2 = namedtuple("OffsetAndMetadata", "offset metadata")
ConsumerRecord = namedtuple("ConsumerRecord",
                            "topic partition offset value")

# both packages' adapter modules, patched alike
ADAPTER_MODULES = ("flow_pipeline_tpu.transport.kafka",
                   "flow_pipeline_tpu_torch.transport.kafka")


class Broker:
    """Topics of ``partitions`` partitions each (created at first use),
    their logs, and the groups' committed offsets."""

    def __init__(self, partitions: int = 2):
        self.partitions = partitions
        self.logs: dict[str, list[list[bytes]]] = {}
        self.committed: dict[tuple, int] = {}
        self.interrupt_when_drained = False
        self.lock = threading.Lock()
        self.sent = 0
        self.flushes = 0

    def topic(self, name: str) -> list[list[bytes]]:
        with self.lock:
            return self.logs.setdefault(
                name, [[] for _ in range(self.partitions)])

    def messages(self, topic: str = "flows") -> list[list[bytes]]:
        """Each partition's messages, in offset order."""
        return [list(p) for p in self.topic(topic)]

    def reset_groups(self) -> None:
        """Forget every committed offset: the next consumers read from
        the start again."""
        with self.lock:
            self.committed.clear()


def client_module(broker: Broker, offset_arity: int = 3):
    """The ``kafka`` module over ``broker``."""

    class KafkaProducer:
        def __init__(self, bootstrap_servers=None, **_):
            self.bootstrap_servers = bootstrap_servers
            self._next = 0

        def send(self, topic, value, partition=None, key=None):
            log = broker.topic(topic)
            if partition is None:
                partition = self._next % len(log)
                self._next += 1
            if not 0 <= partition < len(log):
                raise AssertionError(f"Unrecognized partition {partition}")
            with broker.lock:
                log[partition].append(bytes(value))
                broker.sent += 1

        def flush(self, timeout=None):
            broker.flushes += 1

        def close(self, timeout=None):
            pass

    class KafkaConsumer:
        def __init__(self, *topics, bootstrap_servers=None, group_id=None,
                     enable_auto_commit=True, auto_offset_reset="latest",
                     **_):
            if enable_auto_commit:
                raise AssertionError("the adapters commit by hand")
            if auto_offset_reset != "earliest":
                raise AssertionError(auto_offset_reset)
            self.group = group_id
            self._assigned = [TopicPartition(t, p) for t in topics
                              for p in range(len(broker.topic(t)))]
            self._positions: dict = {}
            self._rr = 0
            self.closed = False

        def assign(self, partitions):
            self._assigned = [TopicPartition(*tp) for tp in partitions]

        def seek(self, tp, offset):
            if tp not in self._assigned:
                raise AssertionError(f"{tp} is not assigned")
            self._positions[tp] = offset

        def _position(self, tp) -> int:
            if tp not in self._positions:
                self._positions[tp] = broker.committed.get(
                    (self.group, tp.topic, tp.partition), 0)
            return self._positions[tp]

        def poll(self, timeout_ms=0, max_records=None):
            if self.closed:
                raise AssertionError("poll after close")
            left = max_records if max_records else float("inf")
            out = {}
            n = len(self._assigned)
            for i in range(n):
                tp = self._assigned[(self._rr + i) % n]
                log = broker.topic(tp.topic)[tp.partition]
                pos = self._position(tp)
                take = int(min(len(log) - pos, left))
                if take <= 0:
                    continue
                out[tp] = [ConsumerRecord(tp.topic, tp.partition, pos + j,
                                          log[pos + j])
                           for j in range(take)]
                self._positions[tp] = pos + take
                left -= take
                if not left:
                    break
            self._rr += 1
            if not out and broker.interrupt_when_drained:
                raise KeyboardInterrupt
            return out

        def commit(self, offsets):
            with broker.lock:
                for tp, om in offsets.items():
                    broker.committed[(self.group, tp.topic,
                                      tp.partition)] = om.offset

        def close(self):
            self.closed = True

    structs = types.ModuleType("kafka.structs")
    structs.OffsetAndMetadata = (OffsetAndMetadata if offset_arity == 3
                                 else OffsetAndMetadata2)
    structs.TopicPartition = TopicPartition
    mod = types.ModuleType("kafka")
    mod.KafkaProducer = KafkaProducer
    mod.KafkaConsumer = KafkaConsumer
    mod.TopicPartition = TopicPartition
    mod.structs = structs
    return mod


@contextlib.contextmanager
def installed(broker: Broker, offset_arity: int = 3,
              modules=ADAPTER_MODULES):
    """The fake client in ``sys.modules`` and in the adapter ``modules``
    (both packages' by default; where the JAX package must not load,
    the port's alone) for the block; everything restored after it."""
    mod = client_module(broker, offset_arity)
    saved_mods = {name: sys.modules.get(name)
                  for name in ("kafka", "kafka.structs")}
    adapters = [importlib.import_module(name) for name in modules]
    saved = [(a, a._KP, a._KC) for a in adapters]
    sys.modules["kafka"] = mod
    sys.modules["kafka.structs"] = mod.structs
    for a in adapters:
        a._KP, a._KC = mod.KafkaProducer, mod.KafkaConsumer
    try:
        yield broker
    finally:
        for a, kp, kc in saved:
            a._KP, a._KC = kp, kc
        for name, old in saved_mods.items():
            if old is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = old
