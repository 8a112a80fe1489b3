"""Sinks: flushed aggregate rows -> storage.

Counterpart of flow_pipeline_tpu/sink for the stdlib sinks: StdoutSink
(demos), SQLiteSink with the reference-shaped tables (``ddl``) and the
ResilientSink wrapper (retries and the dead-letter spill). Postgres and
ClickHouse are not ported.
"""

from . import ddl
from .base import StdoutSink, rows_to_records
from .resilient import ResilientSink, replay_deadletter
from .sqlite import SQLiteSink

__all__ = ["StdoutSink", "SQLiteSink", "ResilientSink", "replay_deadletter",
           "rows_to_records", "ddl"]
