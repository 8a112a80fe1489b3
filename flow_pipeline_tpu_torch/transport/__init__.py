"""Transport: the in-process partitioned bus and its consumer.

Counterpart of flow_pipeline_tpu/transport (bus + consumer) without the
fault-injection and tracing seams. Kafka adapters are not ported.
"""

from .bus import InProcessBus
from .consumer import Consumer

__all__ = ["InProcessBus", "Consumer"]
