"""ClickHouse sink (gated on an HTTP endpoint).

Writes pre-aggregated flows_5m rows straight into the SummingMergeTree
table (ref: compose/clickhouse/create.sh:70-90) over the HTTP interface
using JSONEachRow — no client library, just stdlib urllib. The
TPU engine replaces the Kafka-engine + MV chain, so only the final tables
are needed; partial rows for the same (Date, Timeslot, key) are summed by
the engine at merge time, which is exactly the late-data contract our
aggregator emits.

A copy of flow_pipeline_tpu/sink/clickhouse.py (stdlib urllib), the raw
archive of ``-archive.raw`` (``archive_raw``, ``check_raw_schema``)
included.
"""

from __future__ import annotations

# Every request carries a timeout: a hung endpoint must surface as an
# error the retry ladder handles, not a flush thread blocked for good.

import ipaddress
import json
import urllib.error
import urllib.parse
import urllib.request

import numpy as np

from . import ddl
from .base import rows_to_records
from ..schema.batch import words_to_addr


def raw_records(batch) -> list[dict]:
    """FlowBatch -> flows_raw rows (ref: compose/clickhouse/create.sh:36-62
    column names). Addresses render as IPv6 text for the IPv6 columns; all
    16 address bytes round-trip exactly. Date is MATERIALIZED server-side
    from TimeReceived (see ddl.CLICKHOUSE_FLOWS_RAW), so it is not built
    here."""
    c = batch.columns
    n = len(batch)
    src = np.asarray(c["src_addr"], dtype=np.uint32)
    dst = np.asarray(c["dst_addr"], dtype=np.uint32)
    smp = np.asarray(c["sampler_address"], dtype=np.uint32)
    out = []
    for i in range(n):
        out.append({
            "TimeReceived": int(c["time_received"][i]),
            "TimeFlowStart": int(c["time_flow_start"][i]),
            "SequenceNum": int(c["sequence_num"][i]),
            "SamplingRate": int(c["sampling_rate"][i]),
            "SamplerAddress": str(ipaddress.IPv6Address(words_to_addr(smp[i]))),
            "SrcAddr": str(ipaddress.IPv6Address(words_to_addr(src[i]))),
            "DstAddr": str(ipaddress.IPv6Address(words_to_addr(dst[i]))),
            "SrcAS": int(c["src_as"][i]),
            "DstAS": int(c["dst_as"][i]),
            "EType": int(c["etype"][i]),
            "Proto": int(c["proto"][i]),
            "SrcPort": int(c["src_port"][i]),
            "DstPort": int(c["dst_port"][i]),
            "Bytes": int(c["bytes"][i]),
            "Packets": int(c["packets"][i]),
        })
    return out


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

    # address columns every archive row ships; each must EXIST (an absent
    # column 400s JSONEachRow as unknown) and be type IPv6 (older DDLs
    # used FixedString(16); SamplerAddress is newer than both)
    _RAW_ADDR_COLS = ("SrcAddr", "DstAddr", "SamplerAddress")

    def check_raw_schema(self) -> None:
        """Fail fast with remediation if flows_raw predates the IPv6
        address columns or the SamplerAddress column: CREATE IF NOT
        EXISTS silently keeps an old schema, and the first archive insert
        would then 400 and crash-loop the processor with no hint why."""
        cols = ", ".join(f"'{c}'" for c in self._RAW_ADDR_COLS)
        try:
            out = self._post(
                "SELECT name, type FROM system.columns "
                "WHERE database = currentDatabase() AND table = 'flows_raw' "
                f"AND name IN ({cols}) FORMAT JSONEachRow"
            )
        except (urllib.error.URLError, OSError):
            return  # server unreachable: the insert path will surface it
        types = {
            r["name"]: r["type"]
            for r in (json.loads(line) for line in out.decode().splitlines()
                      if line)
        }
        # a column that is entirely absent returns no row: presence must
        # be asserted explicitly, not just the type of what came back
        bad = [c for c in self._RAW_ADDR_COLS if types.get(c) != "IPv6"]
        if bad:
            raise RuntimeError(
                f"flows_raw columns {bad} are missing or not type IPv6 (a "
                "table created by an older DDL?); migrate with e.g. ALTER "
                "TABLE flows_raw ADD COLUMN IF NOT EXISTS SamplerAddress "
                "IPv6, MODIFY COLUMN SrcAddr IPv6, MODIFY COLUMN DstAddr "
                "IPv6 (or DROP the table) before enabling -archive.raw"
            )

    def archive_raw(self, batch) -> int:
        """Opt-in full-fidelity archive into flows_raw (the reference's
        raw-rows query path, ref: compose/clickhouse/create.sh:36-62). The
        worker calls this only on sinks that expose it and only when
        archiving is enabled."""
        records = raw_records(batch)
        if not records:
            return 0
        body = "\n".join(json.dumps(r) for r in records).encode()
        self._post("INSERT INTO flows_raw FORMAT JSONEachRow", body)
        return len(records)
