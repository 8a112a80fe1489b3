"""Sink plumbing: row normalization + trivial sinks."""

from __future__ import annotations

import sys
from typing import Any

import numpy as np

from ..schema.batch import words_to_addr


def _addr_str(words) -> str:
    """[4] uint32 words -> printable address. IPv4-in-trailing-4-bytes
    renders dotted quad (the convention Grafana queries decode,
    ref: viz-ch.json IPv4NumToString(...substring(reverse(SrcAddr),13,4))."""
    raw = words_to_addr(np.asarray(words, dtype=np.uint32))
    if raw[:12] == b"\x00" * 12:
        return ".".join(str(b) for b in raw[12:])
    import ipaddress

    return str(ipaddress.IPv6Address(raw))


def rows_to_records(rows: Any) -> list[dict]:
    """Columnar flush output (dict of arrays) -> list of flat records with
    printable addresses; rows with valid=False are skipped."""
    names = list(rows.keys())
    n = len(rows[names[0]]) if names else 0
    records = []
    for i in range(n):
        if "valid" in rows and not rows["valid"][i]:
            continue
        rec = {}
        for name in names:
            if name == "valid":
                continue
            v = rows[name][i]
            if isinstance(v, np.ndarray):  # [4] address words
                rec[name] = _addr_str(v)
            else:
                rec[name] = v.item() if isinstance(v, np.generic) else v
        records.append(rec)
    return records


class StdoutSink:
    """Prints one line per record (demos)."""

    def __init__(self, stream=None, limit_per_flush: int = 20):
        self.stream = stream or sys.stdout
        self.limit = limit_per_flush

    def write(self, table: str, rows) -> None:
        records = rows_to_records(rows)
        for rec in records[: self.limit]:
            print(f"{table} {rec}", file=self.stream)
        if len(records) > self.limit:
            print(f"{table} ... {len(records) - self.limit} more rows",
                  file=self.stream)
