"""Schema DDL as code for the port's SQLite sink.

The processor's seven tables of flow_pipeline_tpu/sink/ddl.py (flows_5m,
the three heavy-hitter tables, the two port tables, ddos_alerts), with
the same column order, so the two packages write identical rows.
"""

# Flush-table name -> column order (single source of truth for the sink).
TABLE_COLUMNS = {
    "flows_5m": ["timeslot", "src_as", "dst_as", "etype", "bytes", "packets",
                 "count", "bytes_scaled", "packets_scaled"],
    "top_talkers": ["timeslot", "rank", "src_addr", "dst_addr", "src_port",
                    "dst_port", "proto", "bytes", "packets", "count"],
    "top_src_ips": ["timeslot", "rank", "src_addr", "bytes", "packets",
                    "count"],
    "top_dst_ips": ["timeslot", "rank", "dst_addr", "bytes", "packets",
                    "count"],
    "top_src_ports": ["timeslot", "rank", "src_port", "bytes", "packets",
                      "count"],
    "top_dst_ports": ["timeslot", "rank", "dst_port", "bytes", "packets",
                      "count"],
    "ddos_alerts": ["sub_window", "bucket", "dst_addr", "rate", "zscore",
                    "baseline_quantile"],
}

RANKED_TABLES = {"top_talkers", "top_src_ips", "top_dst_ips",
                 "top_src_ports", "top_dst_ports"}


def assign_ranks(table: str, records: list[dict]) -> list[dict]:
    """Top-K tables' rows are emitted in rank order; materialize the rank."""
    if table in RANKED_TABLES:
        for rank, r in enumerate(records):
            r.setdefault("rank", rank)
    return records


SQLITE_TABLES = {
    "flows_5m": """
CREATE TABLE IF NOT EXISTS flows_5m (
    timeslot INTEGER, src_as INTEGER, dst_as INTEGER, etype INTEGER,
    bytes INTEGER, packets INTEGER, count INTEGER,
    bytes_scaled INTEGER, packets_scaled INTEGER
);
""",
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
    "top_src_ports": """
CREATE TABLE IF NOT EXISTS top_src_ports (
    timeslot INTEGER, rank INTEGER, src_port INTEGER,
    bytes INTEGER, packets INTEGER, count INTEGER
);
""",
    "top_dst_ports": """
CREATE TABLE IF NOT EXISTS top_dst_ports (
    timeslot INTEGER, rank INTEGER, dst_port INTEGER,
    bytes INTEGER, packets INTEGER, count INTEGER
);
""",
    "ddos_alerts": """
CREATE TABLE IF NOT EXISTS ddos_alerts (
    sub_window INTEGER, bucket INTEGER, dst_addr TEXT,
    rate REAL, zscore REAL, baseline_quantile REAL
);
""",
}
