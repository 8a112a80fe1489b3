"""Observability: metrics, the /metrics server and the trace ring.

Counterpart of flow_pipeline_tpu/obs (metrics, server, trace and the
stage timers), copied so the port imports nothing of the JAX package.
Each package keeps its own process-global REGISTRY and TRACER.
"""

from .metrics import (REGISTRY, Counter, Gauge, Histogram, MetricsRegistry,
                      Summary)
from .server import MetricsServer
from .trace import TRACER, TraceRecorder, next_chunk_id

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Summary",
    "MetricsRegistry",
    "REGISTRY",
    "MetricsServer",
    "TRACER",
    "TraceRecorder",
    "next_chunk_id",
]
