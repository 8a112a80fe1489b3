"""Stream engine: the windowed heavy-hitter wrapper and the worker loop."""

from .windowed import WindowedHeavyHitter
from .worker import StreamWorker

__all__ = ["WindowedHeavyHitter", "StreamWorker"]
