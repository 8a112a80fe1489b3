"""Schema DDL as code, for every storage target.

Shapes mirror the reference so its Grafana dashboards keep working:
- Postgres ``flows`` raw table: 14 columns + id (ref: compose/postgres/create.sh:5-24)
- ClickHouse ``flows_raw`` / ``flows_5m`` + materialized views
  (ref: compose/clickhouse/create.sh:36-110)
plus this framework's own aggregate tables (flows_5m rows arrive
pre-aggregated from the TPU, so the ClickHouse MV chain is optional).

A copy of flow_pipeline_tpu/sink/ddl.py: the port writes the same tables
with the same column order, so the two packages write identical rows.
"""

POSTGRES_FLOWS = """
CREATE TABLE IF NOT EXISTS flows (
    id             BIGSERIAL PRIMARY KEY,
    date_inserted  TIMESTAMP,
    time_flow      TIMESTAMP,
    type           INT,
    sampling_rate  BIGINT,
    src_as         BIGINT,
    dst_as         BIGINT,
    src_ip         INET,
    dst_ip         INET,
    bytes          BIGINT,
    packets        BIGINT,
    etype          INT,
    proto          INT,
    src_port       INT,
    dst_port       INT
);
"""

# bytes_scaled/packets_scaled: sampling-rate-corrected sums
# (sum over rows of value * max(sampling_rate, 1)) — what the reference
# computes at query time over raw rows (sum(bytes*sampling_rate), ref:
# compose/grafana/dashboards/viz.json:62); pre-aggregated serving must
# store it or the rate information is unrecoverable.
POSTGRES_FLOWS_5M = """
CREATE TABLE IF NOT EXISTS flows_5m (
    timeslot       BIGINT,
    src_as         BIGINT,
    dst_as         BIGINT,
    etype          INT,
    bytes          BIGINT,
    packets        BIGINT,
    count          BIGINT,
    bytes_scaled   BIGINT,
    packets_scaled BIGINT
);
"""

POSTGRES_TOP_TALKERS = """
CREATE TABLE IF NOT EXISTS top_talkers (
    timeslot  BIGINT,
    rank      INT,
    src_addr  TEXT,
    dst_addr  TEXT,
    src_port  INT,
    dst_port  INT,
    proto     INT,
    bytes     BIGINT,
    packets   BIGINT,
    count     BIGINT
);
"""

POSTGRES_TOP_SRC_IPS = """
CREATE TABLE IF NOT EXISTS top_src_ips (
    timeslot  BIGINT,
    rank      INT,
    src_addr  TEXT,
    bytes     BIGINT,
    packets   BIGINT,
    count     BIGINT
);
"""

POSTGRES_TOP_DST_IPS = """
CREATE TABLE IF NOT EXISTS top_dst_ips (
    timeslot  BIGINT,
    rank      INT,
    dst_addr  TEXT,
    bytes     BIGINT,
    packets   BIGINT,
    count     BIGINT
);
"""

POSTGRES_TOP_SRC_PORTS = """
CREATE TABLE IF NOT EXISTS top_src_ports (
    timeslot  BIGINT,
    rank      INT,
    src_port  INT,
    bytes     BIGINT,
    packets   BIGINT,
    count     BIGINT
);
"""

POSTGRES_TOP_DST_PORTS = """
CREATE TABLE IF NOT EXISTS top_dst_ports (
    timeslot  BIGINT,
    rank      INT,
    dst_port  INT,
    bytes     BIGINT,
    packets   BIGINT,
    count     BIGINT
);
"""

POSTGRES_DDOS_ALERTS = """
CREATE TABLE IF NOT EXISTS ddos_alerts (
    sub_window         BIGINT,
    bucket             INT,
    dst_addr           TEXT,
    rate               DOUBLE PRECISION,
    zscore             DOUBLE PRECISION,
    baseline_quantile  DOUBLE PRECISION
);
"""

# Full-fidelity raw archive (ref: compose/clickhouse/create.sh:36-62).
# Two deliberate divergences: SrcAddr/DstAddr/SamplerAddress are the IPv6
# domain type (16 bytes on disk, like the reference's FixedString(16))
# because rows arrive over JSONEachRow, where raw bytes cannot be
# round-tripped but IPv6 text can — IPv6NumToString-style queries keep
# working; and Date is
# MATERIALIZED server-side from TimeReceived instead of being shipped per
# row (the reference derives it in its flows_raw_view MV the same way).
CLICKHOUSE_FLOWS_RAW = """
CREATE TABLE IF NOT EXISTS flows_raw (
    Date Date MATERIALIZED toDate(toDateTime(TimeReceived)),
    TimeReceived UInt64,
    TimeFlowStart UInt64,
    SequenceNum UInt32,
    SamplingRate UInt64,
    SamplerAddress IPv6,
    SrcAddr IPv6,
    DstAddr IPv6,
    SrcAS UInt32,
    DstAS UInt32,
    EType UInt32,
    Proto UInt32,
    SrcPort UInt32,
    DstPort UInt32,
    Bytes UInt64,
    Packets UInt64
) ENGINE = MergeTree()
PARTITION BY Date
ORDER BY TimeReceived;
"""

CLICKHOUSE_TOP_TALKERS = """
CREATE TABLE IF NOT EXISTS top_talkers (
    timeslot UInt64,
    rank UInt32,
    src_addr String,
    dst_addr String,
    src_port UInt32,
    dst_port UInt32,
    proto UInt32,
    bytes UInt64,
    packets UInt64,
    count UInt64
) ENGINE = MergeTree()
ORDER BY (timeslot, rank);
"""

CLICKHOUSE_TOP_SRC_IPS = """
CREATE TABLE IF NOT EXISTS top_src_ips (
    timeslot UInt64,
    rank UInt32,
    src_addr String,
    bytes UInt64,
    packets UInt64,
    count UInt64
) ENGINE = MergeTree()
ORDER BY (timeslot, rank);
"""

CLICKHOUSE_TOP_DST_IPS = """
CREATE TABLE IF NOT EXISTS top_dst_ips (
    timeslot UInt64,
    rank UInt32,
    dst_addr String,
    bytes UInt64,
    packets UInt64,
    count UInt64
) ENGINE = MergeTree()
ORDER BY (timeslot, rank);
"""

CLICKHOUSE_TOP_SRC_PORTS = """
CREATE TABLE IF NOT EXISTS top_src_ports (
    timeslot UInt64,
    rank UInt32,
    src_port UInt32,
    bytes UInt64,
    packets UInt64,
    count UInt64
) ENGINE = MergeTree()
ORDER BY (timeslot, rank);
"""

CLICKHOUSE_TOP_DST_PORTS = """
CREATE TABLE IF NOT EXISTS top_dst_ports (
    timeslot UInt64,
    rank UInt32,
    dst_port UInt32,
    bytes UInt64,
    packets UInt64,
    count UInt64
) ENGINE = MergeTree()
ORDER BY (timeslot, rank);
"""

CLICKHOUSE_DDOS_ALERTS = """
CREATE TABLE IF NOT EXISTS ddos_alerts (
    sub_window UInt64,
    bucket UInt32,
    dst_addr String,
    rate Float64,
    zscore Float64,
    baseline_quantile Float64
) ENGINE = MergeTree()
ORDER BY sub_window;
"""

CLICKHOUSE_FLOWS_5M = """
CREATE TABLE IF NOT EXISTS flows_5m (
    Date Date,
    Timeslot DateTime,
    SrcAS UInt32,
    DstAS UInt32,
    EType UInt32,
    Bytes UInt64,
    Packets UInt64,
    Count UInt64,
    Bytes_scaled UInt64,
    Packets_scaled UInt64
) ENGINE = SummingMergeTree()
ORDER BY (Date, Timeslot, SrcAS, DstAS, EType);
"""

# Widened-schema migrations, issued at sink startup right after the
# CREATEs: CREATE TABLE IF NOT EXISTS silently keeps a pre-existing table
# WITHOUT the r4 *_scaled columns, so the first insert after an upgrade
# would fail (unknown JSONEachRow field in ClickHouse / undefined column
# in Postgres) and crash-loop the processor — the failure mode
# check_raw_schema exists to prevent for flows_raw (ADVICE r4). Both
# dialects support ADD COLUMN IF NOT EXISTS, so these are idempotent and
# free on a current schema.
POSTGRES_MIGRATIONS = (
    "ALTER TABLE flows_5m ADD COLUMN IF NOT EXISTS bytes_scaled BIGINT",
    "ALTER TABLE flows_5m ADD COLUMN IF NOT EXISTS packets_scaled BIGINT",
)
CLICKHOUSE_MIGRATIONS = (
    "ALTER TABLE flows_5m ADD COLUMN IF NOT EXISTS Bytes_scaled UInt64",
    "ALTER TABLE flows_5m ADD COLUMN IF NOT EXISTS Packets_scaled UInt64",
)

# Flush-table name -> column order, shared by every SQL sink (single source
# of truth; the sinks must not drift from each other or from the DDL above).
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
    "flows": ["time_flow", "type", "sampling_rate", "src_as", "dst_as",
              "src_ip", "dst_ip", "bytes", "packets", "etype", "proto",
              "src_port", "dst_port"],
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
    "flows": """
CREATE TABLE IF NOT EXISTS flows (
    id            INTEGER PRIMARY KEY AUTOINCREMENT,
    date_inserted TEXT DEFAULT CURRENT_TIMESTAMP,
    time_flow     TEXT,
    type          INTEGER,
    sampling_rate INTEGER,
    src_as        INTEGER,
    dst_as        INTEGER,
    src_ip        TEXT,
    dst_ip        TEXT,
    bytes         INTEGER,
    packets       INTEGER,
    etype         INTEGER,
    proto         INTEGER,
    src_port      INTEGER,
    dst_port      INTEGER
);
""",
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
