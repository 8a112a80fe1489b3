"""Postgres sink (gated on psycopg2).

Reference-parity edge: the same ``flows`` table the Go inserter fills
(ref: compose/postgres/create.sh:5-24, inserter/inserter.go:95-106) plus
aggregate tables. Uses execute_values-style multi-row inserts — the
reference's row-at-a-time Exec is why it caps at a few thousand rows/sec
(ref: README.md:86-88).

SQL generation is separated from execution so tests cover the statements
without a server: ``insert_sql(table, records)`` returns (sql, args).

A copy of flow_pipeline_tpu/sink/postgres.py.
"""

from __future__ import annotations

from typing import Optional

from . import ddl
from .base import rows_to_records

_IMPORT_ERROR: Optional[str] = None
try:  # pragma: no cover - psycopg2 presence depends on the environment
    import psycopg2  # type: ignore
except Exception as e:  # noqa: BLE001
    psycopg2 = None
    _IMPORT_ERROR = str(e)


_COLUMNS = ddl.TABLE_COLUMNS  # shared single source of truth (sink/ddl.py)

DDL = {
    "flows": ddl.POSTGRES_FLOWS,
    "flows_5m": ddl.POSTGRES_FLOWS_5M,
    "top_talkers": ddl.POSTGRES_TOP_TALKERS,
    "top_src_ips": ddl.POSTGRES_TOP_SRC_IPS,
    "top_dst_ips": ddl.POSTGRES_TOP_DST_IPS,
    "top_src_ports": ddl.POSTGRES_TOP_SRC_PORTS,
    "top_dst_ports": ddl.POSTGRES_TOP_DST_PORTS,
    "ddos_alerts": ddl.POSTGRES_DDOS_ALERTS,
}


def available() -> bool:
    return psycopg2 is not None


def insert_sql(table: str, records: list[dict]) -> tuple[str, list]:
    """One multi-row INSERT statement for a known table: VALUES (...), (...),
    ... with flattened args — a single round trip per flush, not one per row
    (the reference's row-at-a-time Exec is its throughput ceiling). Quoted
    identifiers come from the static column table, never from user data."""
    cols = _COLUMNS[table]
    ddl.assign_ranks(table, records)
    collist = ", ".join(f'"{c}"' for c in cols)
    row_ph = "(" + ", ".join(["%s"] * len(cols)) + ")"
    placeholders = ", ".join([row_ph] * len(records))
    sql = f'INSERT INTO "{table}" ({collist}) VALUES {placeholders}'
    args = [r.get(c) for r in records for c in cols]
    return sql, args


class PostgresSink:
    def __init__(self, dsn: str):
        if not available():
            raise RuntimeError(
                f"psycopg2 not importable ({_IMPORT_ERROR}); "
                "use SQLiteSink"
            )
        self._conn = psycopg2.connect(dsn)
        with self._conn, self._conn.cursor() as cur:
            for stmt in DDL.values():
                cur.execute(stmt)
            for stmt in ddl.POSTGRES_MIGRATIONS:
                cur.execute(stmt)

    def write(self, table: str, rows) -> None:
        records = rows_to_records(rows)
        if not records or table not in _COLUMNS:
            return
        sql, args = insert_sql(table, records)
        with self._conn, self._conn.cursor() as cur:
            cur.execute(sql, args)

    def close(self) -> None:
        self._conn.close()
