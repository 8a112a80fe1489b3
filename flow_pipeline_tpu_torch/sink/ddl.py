"""Schema DDL as code for the port's SQLite sink.

The heavy-hitter tables of flow_pipeline_tpu/sink/ddl.py, with the same
column order, so the two packages write identical rows.
"""

# Flush-table name -> column order (single source of truth for the sink).
TABLE_COLUMNS = {
    "top_talkers": ["timeslot", "rank", "src_addr", "dst_addr", "src_port",
                    "dst_port", "proto", "bytes", "packets", "count"],
    "top_src_ips": ["timeslot", "rank", "src_addr", "bytes", "packets",
                    "count"],
    "top_dst_ips": ["timeslot", "rank", "dst_addr", "bytes", "packets",
                    "count"],
}

RANKED_TABLES = {"top_talkers", "top_src_ips", "top_dst_ips"}


def assign_ranks(table: str, records: list[dict]) -> list[dict]:
    """Top-K tables' rows are emitted in rank order; materialize the rank."""
    if table in RANKED_TABLES:
        for rank, r in enumerate(records):
            r.setdefault("rank", rank)
    return records


SQLITE_TABLES = {
    "top_talkers": """
CREATE TABLE IF NOT EXISTS top_talkers (
    timeslot INTEGER, rank INTEGER, src_addr TEXT, dst_addr TEXT,
    src_port INTEGER, dst_port INTEGER, proto INTEGER,
    bytes INTEGER, packets INTEGER, count INTEGER
);
""",
    "top_src_ips": """
CREATE TABLE IF NOT EXISTS top_src_ips (
    timeslot INTEGER, rank INTEGER, src_addr TEXT,
    bytes INTEGER, packets INTEGER, count INTEGER
);
""",
    "top_dst_ips": """
CREATE TABLE IF NOT EXISTS top_dst_ips (
    timeslot INTEGER, rank INTEGER, dst_addr TEXT,
    bytes INTEGER, packets INTEGER, count INTEGER
);
""",
}
