"""Transport: the in-process partitioned bus, its consumer and producer,
the gRPC feed (``transport/feed.py``, imported on use: it needs grpcio)
and the Kafka adapters (``transport/kafka.py``, imported on use: they
need a kafka-python client and are gated off without one).

Counterpart of flow_pipeline_tpu/transport (bus, consumer, producer,
feed and kafka, with the fault-injection and tracing seams).
"""

from .bus import InProcessBus
from .consumer import Consumer
from .producer import Producer

__all__ = ["InProcessBus", "Consumer", "Producer"]
