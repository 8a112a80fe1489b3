"""The FlowMessage record type.

One flow observation as emitted by a collector (sFlow/NetFlow/IPFIX decode)
or by the synthetic generator. The field set and proto3 field numbers are the
wire contract shared with the reference pipeline (ref: pb-ext/flow.proto:7-65);
every producer/consumer in this framework speaks exactly this schema so stock
components (GoFlow, ClickHouse Kafka-engine tables, the reference inserter)
interoperate with ours on the same bus.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class FlowType(enum.IntEnum):
    """Flow protocol that produced the record (ref: pb-ext/flow.proto:9-15)."""

    FLOWUNKNOWN = 0
    SFLOW_5 = 1
    NETFLOW_V5 = 2
    NETFLOW_V9 = 3
    IPFIX = 4


# Wire field table: (proto field number, attribute name, wire kind).
# Kind is either "varint" (all integer/enum fields) or "bytes" (addresses).
# Numbers must never change: they are the on-the-wire contract
# (ref: pb-ext/flow.proto:16-64).
FIELDS: tuple[tuple[int, str, str], ...] = (
    (1, "type", "varint"),
    (2, "time_received", "varint"),
    (3, "sampling_rate", "varint"),
    (4, "sequence_num", "varint"),
    (5, "time_flow_end", "varint"),
    (6, "src_addr", "bytes"),
    (7, "dst_addr", "bytes"),
    (9, "bytes", "varint"),
    (10, "packets", "varint"),
    (11, "sampler_address", "bytes"),
    (14, "src_as", "varint"),
    (15, "dst_as", "varint"),
    (18, "in_if", "varint"),
    (19, "out_if", "varint"),
    (20, "proto", "varint"),
    (21, "src_port", "varint"),
    (22, "dst_port", "varint"),
    (23, "ip_tos", "varint"),
    (24, "forwarding_status", "varint"),
    (25, "ip_ttl", "varint"),
    (26, "tcp_flags", "varint"),
    (30, "etype", "varint"),
    (31, "icmp_type", "varint"),
    (32, "icmp_code", "varint"),
    (37, "ipv6_flow_label", "varint"),
    (38, "time_flow_start", "varint"),
    (42, "flow_direction", "varint"),
)

FIELD_BY_NUMBER = {num: (name, kind) for num, name, kind in FIELDS}


@dataclass
class FlowMessage:
    """A single flow record. All integers are non-negative; addresses are
    16-byte strings (IPv4 embedded per the collector's convention: the
    reference stores IPv4 in the trailing 4 bytes of a FixedString(16),
    ref: compose/clickhouse/create.sh:44-45 + viz-ch.json IPv4 extraction).
    """

    type: int = FlowType.FLOWUNKNOWN
    time_received: int = 0
    sampling_rate: int = 0
    sequence_num: int = 0
    time_flow_start: int = 0
    time_flow_end: int = 0
    src_addr: bytes = b""
    dst_addr: bytes = b""
    sampler_address: bytes = b""
    bytes: int = 0
    packets: int = 0
    src_as: int = 0
    dst_as: int = 0
    in_if: int = 0
    out_if: int = 0
    proto: int = 0
    src_port: int = 0
    dst_port: int = 0
    ip_tos: int = 0
    forwarding_status: int = 0
    ip_ttl: int = 0
    tcp_flags: int = 0
    etype: int = 0
    icmp_type: int = 0
    icmp_code: int = 0
    ipv6_flow_label: int = 0
    flow_direction: int = 0
