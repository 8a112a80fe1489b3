"""Sinks: flushed aggregate rows -> storage.

Counterpart of flow_pipeline_tpu/sink for the stdlib sinks: StdoutSink
(demos) and SQLiteSink with the reference-shaped tables (``ddl``). Postgres, ClickHouse and the resilient wrapper are not
ported.
"""

from . import ddl
from .base import StdoutSink, rows_to_records
from .sqlite import SQLiteSink

__all__ = ["StdoutSink", "SQLiteSink", "rows_to_records", "ddl"]
