"""ClickHouse sink (gated on an HTTP endpoint).

Writes pre-aggregated flows_5m rows straight into the SummingMergeTree
table (ref: compose/clickhouse/create.sh:70-90) over the HTTP interface
using JSONEachRow — no client library, just stdlib urllib. The
TPU engine replaces the Kafka-engine + MV chain, so only the final tables
are needed; partial rows for the same (Date, Timeslot, key) are summed by
the engine at merge time, which is exactly the late-data contract our
aggregator emits.

A copy of flow_pipeline_tpu/sink/clickhouse.py (stdlib urllib) without
the raw archive (``archive_raw``, ``-archive.raw``), which the port's
worker does not run.
"""

from __future__ import annotations

# Every request carries a timeout: a hung endpoint must surface as an
# error the retry ladder handles, not a flush thread blocked for good.

import json
import urllib.error
import urllib.parse
import urllib.request


from . import ddl
from .base import rows_to_records


class ClickHouseSink:
    def __init__(self, url: str = "http://localhost:8123",
                 database: str = "default", timeout: float = 5.0,
                 create_tables: bool = True):
        self.url = url.rstrip("/")
        self.database = database
        self.timeout = timeout
        if create_tables:
            # a bare clickhouse-server has no schema; without this the first
            # flush 400s and the processor crash-loops
            for stmt in (ddl.CLICKHOUSE_FLOWS_RAW, ddl.CLICKHOUSE_FLOWS_5M,
                         ddl.CLICKHOUSE_TOP_TALKERS,
                         ddl.CLICKHOUSE_TOP_SRC_IPS,
                         ddl.CLICKHOUSE_TOP_DST_IPS,
                         ddl.CLICKHOUSE_TOP_SRC_PORTS,
                         ddl.CLICKHOUSE_TOP_DST_PORTS,
                         ddl.CLICKHOUSE_DDOS_ALERTS):
                self._post(stmt)
            for stmt in ddl.CLICKHOUSE_MIGRATIONS:
                self._post(stmt)

    def _post(self, query: str, body: bytes = b"") -> bytes:
        req = urllib.request.Request(
            f"{self.url}/?database={self.database}&query="
            + urllib.parse.quote(query),
            data=body,
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return resp.read()

    def ping(self) -> bool:
        try:
            req = urllib.request.Request(f"{self.url}/ping")
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return resp.read().strip() == b"Ok."
        except (urllib.error.URLError, OSError):
            return False

    # flush-row keys -> ClickHouse column names (the tables use the
    # reference's CamelCase columns, ref: compose/clickhouse/create.sh:70-90)
    _FLOWS_5M_COLS = {
        "timeslot": "Timeslot",
        "src_as": "SrcAS",
        "dst_as": "DstAS",
        "etype": "EType",
        "bytes": "Bytes",
        "packets": "Packets",
        "count": "Count",
        "bytes_scaled": "Bytes_scaled",
        "packets_scaled": "Packets_scaled",
    }

    def write(self, table: str, rows) -> None:
        records = rows_to_records(rows)
        if not records:
            return
        ddl.assign_ranks(table, records)
        cols = ddl.TABLE_COLUMNS.get(table)
        if cols is not None:
            # Keep only DDL'd columns: flush rows carry extra keys (e.g.
            # the *_est CMS bounds) that JSONEachRow would reject as
            # unknown fields against the CREATEd tables.
            records = [{c: r.get(c) for c in cols if c in r} for r in records]
        if table == "flows_5m":
            records = [
                {self._FLOWS_5M_COLS.get(k, k): v for k, v in r.items()}
                for r in records
            ]
            for r in records:
                r.setdefault("Date", int(r.get("Timeslot", 0)) // 86400)
        body = "\n".join(json.dumps(r, default=str) for r in records).encode()
        self._post(f"INSERT INTO {table} FORMAT JSONEachRow", body)
