"""Sinks: flushed aggregate rows -> storage.

Counterpart of flow_pipeline_tpu/sink: StdoutSink (demos), SQLiteSink with the reference-shaped tables (``ddl``),
ClickHouseSink (HTTP JSONEachRow, stdlib urllib), PostgresSink (gated on
``psycopg2``, as in the reference) and the ResilientSink wrapper
(retries and the dead-letter spill).
"""

from . import ddl
from .base import StdoutSink, rows_to_records
from .clickhouse import ClickHouseSink
from .postgres import PostgresSink
from .resilient import ResilientSink, replay_deadletter
from .sqlite import SQLiteSink

__all__ = ["StdoutSink", "SQLiteSink", "PostgresSink",
           "ClickHouseSink", "ResilientSink", "replay_deadletter",
           "rows_to_records", "ddl"]
