"""Collector service: UDP listeners -> decoders -> Producer.

Replaces the external GoFlow container (ref:
compose/docker-compose-clickhouse-collect.yml:47-62) with in-framework
listeners on the same ports (sFlow 6343, NetFlow/IPFIX 2055) and the same
observed metric surface (SURVEY.md §2-C12), so the reference's perfs
dashboard panels resolve against our /metrics:

    udp_traffic_bytes / udp_traffic_packets
    flow_traffic_bytes{type=...,remote_ip=...} / flow_traffic_packets{...}
    flow_process_nf_flowset_records_sum{router=...}
    flow_process_nf_errors_count{router=...}
    flow_process_nf_templates_count  (+ per-router series)
    flow_process_sf_samples_sum{type=FlowSample,agent=...}
    flow_process_sf_errors_count{agent=...}
    flow_summary_decoding_time_us{name=...}
    flow_decoder_count{worker=...}

The router/agent label carries the exporter's address (port stripped) so
the dashboards can break panels down per exporter, the way the
reference's perfs.json does with `by (router)` / `by (agent)`.

A copy of flow_pipeline_tpu/collector/udp.py; the listener threads keep
the reference's names (``collector-netflow``, ``collector-sflow``).
"""

from __future__ import annotations

import logging
import socket
import struct
import threading
import time
from dataclasses import dataclass
from typing import Optional

from ..obs import REGISTRY, MetricsRegistry
from ..schema.message import FlowType
from .netflow import TemplateCache, decode_netflow
from .sflow import decode_sflow

log = logging.getLogger("flow_pipeline_tpu_torch.collector")

_TYPE_NAMES = {
    FlowType.SFLOW_5: "sFlow",
    FlowType.NETFLOW_V5: "NetFlow",
    FlowType.NETFLOW_V9: "NetFlow",
    FlowType.IPFIX: "NetFlow",
}


def _exporter_ip(source: str) -> str:
    """Exporter address without the ephemeral port: the `router`/`agent`
    label value (the reference's perfs dashboards break every per-flow
    panel down `by (router)` / `by (agent)` — an unlabeled counter
    cannot answer "which exporter went quiet")."""
    host, _, port = source.rpartition(":")
    return host if host else source


def _export_clock(data: bytes) -> int:
    """Exporter wall-clock from a NetFlow/IPFIX header (0 if unreadable).

    v5/v9 carry unix_secs at offset 8; IPFIX carries export time at
    offset 4 (RFC 7011 §3.1). Used for the delay summary only — flow
    timestamps come from the full decode.
    """
    try:
        version = struct.unpack_from(">H", data, 0)[0]
        if version in (5, 9):
            return struct.unpack_from(">I", data, 8)[0]
        if version == 10:
            return struct.unpack_from(">I", data, 4)[0]
    except struct.error:
        pass
    return 0


@dataclass(frozen=True)
class CollectorConfig:
    netflow_addr: Optional[tuple[str, int]] = ("0.0.0.0", 2055)
    sflow_addr: Optional[tuple[str, int]] = ("0.0.0.0", 6343)
    recv_buf: int = 1 << 20


class CollectorServer:
    """Threaded UDP listeners feeding a Producer (bus or Kafka adapter)."""

    def __init__(self, producer, config: CollectorConfig = CollectorConfig(),
                 registry: MetricsRegistry = REGISTRY):
        self.producer = producer
        self.config = config
        self.templates = TemplateCache()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._sockets: list[socket.socket] = []
        self.ports: dict[str, int] = {}

        self.m_udp_bytes = registry.counter("udp_traffic_bytes")
        self.m_udp_pkts = registry.counter("udp_traffic_packets")
        self.m_flow_bytes = registry.counter("flow_traffic_bytes")
        self.m_flow_pkts = registry.counter("flow_traffic_packets")
        self.m_nf_records = registry.counter("flow_process_nf_flowset_records_sum")
        self.m_nf_errors = registry.counter("flow_process_nf_errors_count")
        self.m_sf_errors = registry.counter("flow_process_sf_errors_count")
        self.m_nf_templates = registry.gauge("flow_process_nf_templates_count")
        self.m_sf_samples = registry.counter("flow_process_sf_samples_sum")
        self.m_decode_us = registry.summary("flow_summary_decoding_time_us")
        self.m_nf_delay = registry.summary(
            "flow_process_nf_delay_summary_seconds",
            "seconds between the exporter's header clock and processing",
        )
        self.m_workers = registry.gauge("flow_decoder_count")

    # ---- datagram handling (also the direct test surface) -----------------

    def handle_netflow(self, data: bytes, source: str = "") -> int:
        self.m_udp_bytes.inc(len(data))
        self.m_udp_pkts.inc()
        router = _exporter_ip(source)
        now = time.time()
        t0 = time.perf_counter()
        try:
            # Stamp receive time here (as the reference collector does) so a
            # skewed exporter clock cannot shift window assignment; the
            # exporter header clock remains the fallback only when now=None
            # (direct decode_netflow callers, e.g. tests).
            msgs = decode_netflow(data, self.templates, source,
                                  now=int(now))
        except (ValueError, struct.error) as e:
            # struct.error covers malformed datagrams that trip fixed-layout
            # unpacks before a bounds check — one spoofed packet must never
            # kill the listener
            self.m_nf_errors.inc(router=router)
            log.debug("netflow decode error from %s: %s", source, e)
            return 0
        finally:
            self.m_decode_us.observe((time.perf_counter() - t0) * 1e6,
                                     name="NetFlow")
        self.m_nf_templates.set(len(self.templates))
        self.m_nf_templates.set(self.templates.count_for(source),
                                router=router)
        self.m_nf_records.inc(len(msgs), router=router)
        # "time between flow and processing" (the reference perfs.json
        # NFDelaySummary panel): exporter header clock -> now, observed once
        # per record so busy exporters weight the quantiles like GoFlow's.
        export_clock = _export_clock(data)
        if export_clock:
            delay = max(0.0, now - export_clock)
            for _ in msgs:
                # labeled per exporter so the dashboards can chart delay
                # quantiles BY ROUTER (the reference perfs.json breaks
                # NFDelaySummary down the same way); the quantile-only
                # panels keep matching — they filter no other label
                self.m_nf_delay.observe(delay, router=router)
        return self._publish(msgs, router)

    def handle_sflow(self, data: bytes, source: str = "") -> int:
        self.m_udp_bytes.inc(len(data))
        self.m_udp_pkts.inc()
        agent = _exporter_ip(source)
        t0 = time.perf_counter()
        try:
            msgs = decode_sflow(data)
        except (ValueError, struct.error) as e:
            self.m_sf_errors.inc(agent=agent)
            log.debug("sflow decode error from %s: %s", source, e)
            return 0
        finally:
            self.m_decode_us.observe((time.perf_counter() - t0) * 1e6,
                                     name="sFlow")
        self.m_sf_samples.inc(len(msgs), type="FlowSample", agent=agent)
        return self._publish(msgs, agent)

    def _publish(self, msgs, remote_ip: str = "") -> int:
        for m in msgs:
            self.producer.send(m)
            name = _TYPE_NAMES.get(m.type, "unknown")
            self.m_flow_bytes.inc(m.bytes, type=name, remote_ip=remote_ip)
            self.m_flow_pkts.inc(m.packets, type=name, remote_ip=remote_ip)
        return len(msgs)

    # ---- service lifecycle ------------------------------------------------

    def start(self) -> "CollectorServer":
        listeners = []
        if self.config.netflow_addr:
            listeners.append(("netflow", self.config.netflow_addr,
                              self.handle_netflow))
        if self.config.sflow_addr:
            listeners.append(("sflow", self.config.sflow_addr,
                              self.handle_sflow))
        for name, addr, handler in listeners:
            sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                            self.config.recv_buf)
            sock.bind(addr)
            sock.settimeout(0.2)
            self._sockets.append(sock)
            self.ports[name] = sock.getsockname()[1]
            t = threading.Thread(
                target=self._serve, args=(sock, handler, name),
                name=f"collector-{name}", daemon=True,
            )
            self._threads.append(t)
            t.start()
            log.info("listening %s on %s:%d", name, addr[0], self.ports[name])
        self.m_workers.set(len(self._threads), worker="udp")
        return self

    def _serve(self, sock, handler, name) -> None:
        while not self._stop.is_set():
            try:
                data, addr = sock.recvfrom(65535)
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                handler(data, f"{addr[0]}:{addr[1]}")
            except Exception:  # noqa: BLE001 — the listener must survive
                log.exception("unexpected %s handler failure", name)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2)
        for s in self._sockets:
            s.close()
