"""Transport: the in-process partitioned bus, its consumer and producer,
and the gRPC feed (``transport/feed.py``, imported on use: it needs
grpcio).

Counterpart of flow_pipeline_tpu/transport (bus, consumer, producer and
feed, with the fault-injection and tracing seams). The Kafka adapters
are not ported: no Kafka client is installed.
"""

from .bus import InProcessBus
from .consumer import Consumer
from .producer import Producer

__all__ = ["InProcessBus", "Consumer", "Producer"]
