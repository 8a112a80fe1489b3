"""Stream engine: the windowed ranked-model wrapper, the fused step, the
prefetch feed, the worker loop and its supervisor (the live query API is
engine/query_api.py)."""

from .fused import FusedPipeline
from .prefetch import PrefetchConsumer
from .supervisor import Supervisor, SupervisorConfig
from .windowed import WindowedHeavyHitter
from .worker import StreamWorker

__all__ = ["FusedPipeline", "PrefetchConsumer", "Supervisor",
           "SupervisorConfig", "WindowedHeavyHitter", "StreamWorker"]
