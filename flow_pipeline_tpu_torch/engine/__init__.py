"""Stream engine: the windowed ranked-model wrapper, the fused step, the
prefetch feed and the worker loop."""

from .fused import FusedPipeline
from .prefetch import PrefetchConsumer
from .windowed import WindowedHeavyHitter
from .worker import StreamWorker

__all__ = ["FusedPipeline", "PrefetchConsumer", "WindowedHeavyHitter",
           "StreamWorker"]
