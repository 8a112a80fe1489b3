"""Flow collector: sFlow/NetFlow/IPFIX UDP -> FlowMessage -> bus.

Counterpart of flow_pipeline_tpu/collector (pure Python, copied).

The reference outsources collection to the external GoFlow image (run as
``cloudflare/goflow:latest`` with UDP 6343 sFlow + 2055 NetFlow/IPFIX and a
:8080 metrics port — ref: compose/docker-compose-clickhouse-collect.yml:47-62,
README.md:15). This package brings collection into the framework so no
external binary is required:

- ``netflow``: NetFlow v5 (fixed layout), NetFlow v9 and IPFIX
  (template-based) datagram decoders.
- ``sflow``: sFlow v5 flow-sample decoder, parsing the sampled raw packet
  headers (Ethernet / 802.1Q / IPv4 / IPv6 / TCP / UDP / ICMP).
- ``udp``: the listener service wiring decoders to a Producer, exposing the
  GoFlow-shaped metric surface (SURVEY.md §2-C12: flow_process_nf_*,
  flow_traffic_*, udp_traffic_*, flow_decoder_count, ...) so the reference's
  perfs dashboards keep working against our collector.

All decoders are pure functions bytes -> list[FlowMessage]; the reference's
observed semantics (16-byte addresses with IPv4 in the trailing bytes,
TimeReceived in seconds, sampling rate per flow) are preserved.
"""

from .netflow import decode_netflow, TemplateCache
from .sflow import decode_sflow
from .udp import CollectorServer, CollectorConfig

__all__ = [
    "decode_netflow",
    "TemplateCache",
    "decode_sflow",
    "CollectorServer",
    "CollectorConfig",
]
