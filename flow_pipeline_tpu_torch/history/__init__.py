"""The history tier: a durable snapshot archive and time-travel queries.

Counterpart of flow_pipeline_tpu/history: :mod:`.archive` for the
durability and damage story, :mod:`.server` for the read surface.
"""

from .archive import (HISTORY_METRICS, KEYFRAME_EVERY, RETAIN_BYTES,
                      ArchiveReader, ArchiveWriter, HistoryGapError,
                      register_history_metrics)
from .server import HistoryServer

__all__ = [
    "HISTORY_METRICS",
    "KEYFRAME_EVERY",
    "RETAIN_BYTES",
    "ArchiveReader",
    "ArchiveWriter",
    "HistoryGapError",
    "HistoryServer",
    "register_history_metrics",
]
