"""SQLite sink: a real queryable store from the stdlib.

Rows land in the typed tables of ``ddl``; rows of any other table (the
spread detectors') land in a ``journal`` table as (table_name, one JSON
record), as the reference's sink writes them.
"""

from __future__ import annotations

import json
import sqlite3
import threading

from . import ddl
from .base import rows_to_records


class SQLiteSink:
    def __init__(self, path: str = ":memory:"):
        # one connection guarded by a lock: the worker thread writes while
        # a caller may query from another thread
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        with self._lock:
            for stmt in ddl.SQLITE_TABLES.values():
                self._conn.executescript(stmt)
            self._conn.execute("CREATE TABLE IF NOT EXISTS journal "
                               "(table_name TEXT, record TEXT)")
            self._conn.commit()

    def write(self, table: str, rows) -> None:
        cols = ddl.TABLE_COLUMNS.get(table)
        if cols is None:
            records = rows_to_records(rows)
            if records:
                with self._lock:
                    self._conn.executemany(
                        "INSERT INTO journal (table_name, record) "
                        "VALUES (?, ?)",
                        [(table, json.dumps(r, default=str))
                         for r in records])
                    self._conn.commit()
            return
        records = ddl.assign_ranks(table, rows_to_records(rows))
        if not records:
            return
        placeholders = ",".join("?" for _ in cols)
        collist = ",".join(f'"{c}"' for c in cols)
        with self._lock:
            self._conn.executemany(
                f'INSERT INTO "{table}" ({collist}) VALUES ({placeholders})',
                [tuple(r.get(c) for c in cols) for r in records])
            self._conn.commit()

    def query(self, sql: str, params=()) -> list[tuple]:
        with self._lock:
            return list(self._conn.execute(sql, params))

    def close(self) -> None:
        with self._lock:
            self._conn.close()
