"""Producer: FlowMessages -> framed bytes -> bus.

A copy of flow_pipeline_tpu/transport/producer.py.
"""

from __future__ import annotations

from typing import Optional

from ..schema import wire
from ..schema.message import FlowMessage
from .bus import InProcessBus


class Producer:
    """Publishes FlowMessages to a topic. ``fixedlen`` selects
    length-prefixed framing (the reference's ``-proto.fixedlen``);
    unprefixed messages are the Go inserter's contract."""

    def __init__(self, bus: InProcessBus, topic: str = "flows",
                 fixedlen: bool = False):
        self.bus = bus
        self.topic = topic
        self.fixedlen = fixedlen
        self.produced = 0

    def send(self, msg: FlowMessage, partition: Optional[int] = None) -> None:
        data = (wire.encode_frame(msg) if self.fixedlen
                else wire.encode_message(msg))
        self.bus.produce(self.topic, data, partition)
        self.produced += 1
