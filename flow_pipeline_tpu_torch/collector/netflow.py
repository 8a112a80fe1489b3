"""NetFlow v5 / v9 / IPFIX datagram decoders.

Wire layouts per the protocol specs (RFC 3954 for v9, RFC 7011 for IPFIX;
v5 is the classic fixed 48-byte record). Field semantics follow the
reference pipeline's observed conventions: IPv4 addresses embed in the
trailing 4 bytes of the 16-byte address (ref: compose/clickhouse/create.sh
FixedString(16) + viz-ch.json extraction), timestamps are unix seconds,
and v9/IPFIX flow start/end sysuptime offsets convert against the export
header clock.

A copy of flow_pipeline_tpu/collector/netflow.py (pure Python).
"""

from __future__ import annotations

import struct
import time
from dataclasses import dataclass, field
from typing import Optional

from ..schema.message import FlowMessage, FlowType


def _v4(addr4: bytes) -> bytes:
    """IPv4 -> 16-byte trailing embedding."""
    return b"\x00" * 12 + addr4


# ---------------------------------------------------------------------------
# NetFlow v5
# ---------------------------------------------------------------------------

_V5_HEADER = struct.Struct(">HHIIIIBBH")
_V5_RECORD = struct.Struct(">4s4s4sHHIIIIHHBBBBHHBBH")


def decode_v5(data: bytes, now: Optional[int] = None) -> list[FlowMessage]:
    if len(data) < _V5_HEADER.size:
        raise ValueError("short NetFlow v5 header")
    (_, count, sysuptime, unix_secs, _nsecs, seq, _etype, _eid,
     sampling) = _V5_HEADER.unpack_from(data, 0)
    sampling_rate = sampling & 0x3FFF  # top 2 bits are the sampling mode
    now = now or unix_secs  # caller's receive time wins over exporter clock
    msgs = []
    off = _V5_HEADER.size
    for i in range(count):
        if off + _V5_RECORD.size > len(data):
            raise ValueError(f"truncated v5 record {i}")
        (src, dst, _nexthop, in_if, out_if, pkts, octets, first, last,
         sport, dport, _pad, tcp_flags, proto, tos, src_as, dst_as,
         _smask, _dmask, _pad2) = _V5_RECORD.unpack_from(data, off)
        off += _V5_RECORD.size
        # First/Last are sysuptime millis; anchor them to the export clock
        start = unix_secs - max(0, (sysuptime - first)) // 1000
        end = unix_secs - max(0, (sysuptime - last)) // 1000
        msgs.append(
            FlowMessage(
                type=FlowType.NETFLOW_V5,
                time_received=now,
                time_flow_start=start,
                time_flow_end=end,
                sampling_rate=sampling_rate or 1,
                sequence_num=seq & 0xFFFFFFFF,
                src_addr=_v4(src),
                dst_addr=_v4(dst),
                bytes=octets,
                packets=pkts,
                src_port=sport,
                dst_port=dport,
                proto=proto,
                ip_tos=tos,
                tcp_flags=tcp_flags,
                in_if=in_if,
                out_if=out_if,
                src_as=src_as,
                dst_as=dst_as,
                etype=0x0800,
            )
        )
    return msgs


# ---------------------------------------------------------------------------
# NetFlow v9 / IPFIX (template-based)
# ---------------------------------------------------------------------------

# field type -> FlowMessage attribute handler. v9 and IPFIX share these IDs
# for the fields this pipeline carries.
_INT_FIELDS = {
    1: "bytes",  # IN_BYTES
    2: "packets",  # IN_PKTS
    4: "proto",  # PROTOCOL
    5: "ip_tos",  # SRC_TOS
    6: "tcp_flags",
    7: "src_port",
    10: "in_if",
    11: "dst_port",
    14: "out_if",
    16: "src_as",
    17: "dst_as",
    31: "ipv6_flow_label",
    32: "icmp_type",  # ICMP_TYPE: type*256 + code (split below)
    34: "sampling_rate",  # SAMPLING_INTERVAL
    61: "flow_direction",
    89: "forwarding_status",
    192: "ip_ttl",  # IPFIX ipTTL
}
_ADDR4_FIELDS = {8: "src_addr", 12: "dst_addr", 15: None}  # 15 = next hop, dropped
_ADDR6_FIELDS = {27: "src_addr", 28: "dst_addr"}
_TIME_FIELDS = {21: "last", 22: "first"}  # sysuptime ms (v9)
_TS_SEC_FIELDS = {150: "start_s", 151: "end_s"}  # IPFIX absolute seconds
_TS_MS_FIELDS = {152: "start_ms", 153: "end_ms"}  # IPFIX absolute millis


@dataclass
class TemplateCache:
    """(source, domain/source-id, template id) -> [(field type, length)].

    Templates arrive in-band; data sets that reference an unseen template
    are counted and skipped (the GoFlow behavior behind its
    flow_process_nf_errors_count metric). Options templates are tracked
    separately: their data records carry exporter-wide state — notably the
    sampling interval — which is cached per (source, domain) and applied to
    flow records that do not carry an inline sampling field."""

    templates: dict[tuple, list[tuple[int, int]]] = field(default_factory=dict)
    options: set = field(default_factory=set)  # keys that are options templates
    sampling: dict[tuple, int] = field(default_factory=dict)  # (src, dom) -> rate
    missing: int = 0
    # per-ROUTER template tally (source with the ephemeral port
    # stripped — the granularity of the exported `router` label),
    # maintained at put() time: count_for runs once per datagram on the
    # decode hot path, so it must not scan the whole cache (1000 routers
    # x 20 templates would be a 20k-tuple walk per packet), and tallying
    # the full ip:port would make one router's series flap between its
    # per-port counts instead of aggregating.
    by_router: dict[str, int] = field(default_factory=dict)

    @staticmethod
    def _router(source: str) -> str:
        host, _, _ = source.rpartition(":")
        return host if host else source

    def put(self, source: str, domain: int, tid: int,
            fields: list[tuple[int, int]], is_options: bool = False) -> None:
        key = (source, domain, tid)
        if key not in self.templates:  # refreshes don't re-count
            router = self._router(source)
            self.by_router[router] = self.by_router.get(router, 0) + 1
        self.templates[key] = fields
        if is_options:
            self.options.add(key)
        else:
            self.options.discard(key)

    def get(self, source: str, domain: int, tid: int):
        t = self.templates.get((source, domain, tid))
        if t is None:
            self.missing += 1
        return t

    def count_for(self, source: str) -> int:
        """Templates cached for one ROUTER (``source`` may carry the
        port; it is stripped to match the exported label) — the
        per-router flow_process_nf_templates_count series
        (collector.udp)."""
        return self.by_router.get(self._router(source), 0)

    def is_options(self, source: str, domain: int, tid: int) -> bool:
        return (source, domain, tid) in self.options

    def exporter_sampling(self, source: str, domain: int) -> int:
        return self.sampling.get((source, domain), 0)

    def __len__(self) -> int:
        return len(self.templates)


def _uint(b: bytes) -> int:
    return int.from_bytes(b, "big")


# RFC 7011 §7: a template field length of 0xFFFF marks a variable-length
# field whose actual size is a per-record 1-byte prefix (or 255 followed by
# a 2-byte length). NetFlow v9 has no such encoding, but treating 0xFFFF
# identically there is safe: no fixed v9 field is 65535 bytes wide.
VARLEN = 0xFFFF


def _varlen_slice(data: bytes, p: int, end: int) -> tuple[bytes, int]:
    """Read one variable-length field's content; returns (raw, new offset)."""
    if p >= end:
        raise ValueError("varlen field prefix overruns set")
    ln = data[p]
    p += 1
    if ln == 255:  # 3-byte form
        if p + 2 > end:
            raise ValueError("varlen field extended prefix overruns set")
        ln = struct.unpack_from(">H", data, p)[0]
        p += 2
    if p + ln > end:
        raise ValueError("varlen field content overruns set")
    return data[p : p + ln], p + ln


def _min_record_len(fields) -> int:
    """Lower bound on one data record's wire size: fixed widths plus at
    least one length-prefix byte per variable-length field."""
    return sum(1 if flen == VARLEN else flen for _, flen in fields)


def _record_from_fields(fields, data, off, flow_type, now, header_secs,
                        sysuptime, seq, end=None) -> tuple[FlowMessage, int, bool]:
    """Returns (msg, new offset, has_inline_sampling). The flag matters:
    sampling_rate defaults to 1, so 'field absent' and 'explicit inline 1'
    (unsampled flows from an otherwise-sampling exporter) are otherwise
    indistinguishable to the exporter-rate inheritance."""
    if end is None:
        end = len(data)
    msg = FlowMessage(type=flow_type, time_received=now, sequence_num=seq,
                      sampling_rate=1)
    times = {}
    etype = 0x0800
    has_sampling = False
    for ftype, flen in fields:
        if flen == VARLEN:
            # Variable-length content (RFC 7011 §7) is strings/opaque data;
            # every field this pipeline maps is fixed-width, so consume the
            # bytes and move on — the record stays decodable.
            _, off = _varlen_slice(data, off, end)
            continue
        # In a varlen-bearing template the outer loop's min-length check
        # cannot guarantee the fixed tail fits: a long varlen value can
        # leave fewer bytes than the remaining fixed fields, and slicing
        # past ``end`` would silently read the NEXT set's bytes as content.
        if off + flen > end:
            raise ValueError("record field overruns set")
        raw = data[off : off + flen]
        off += flen
        if ftype in _INT_FIELDS:
            if ftype in _SAMPLING_FIELDS:
                has_sampling = True
            setattr(msg, _INT_FIELDS[ftype], _uint(raw))
        elif ftype in _ADDR4_FIELDS:
            attr = _ADDR4_FIELDS[ftype]
            if attr:
                setattr(msg, attr, _v4(raw[:4]))
        elif ftype in _ADDR6_FIELDS:
            setattr(msg, _ADDR6_FIELDS[ftype], raw[:16])
            etype = 0x86DD
        elif ftype in _TIME_FIELDS:
            times[_TIME_FIELDS[ftype]] = _uint(raw)
        elif ftype in _TS_SEC_FIELDS:
            times[_TS_SEC_FIELDS[ftype]] = _uint(raw)
        elif ftype in _TS_MS_FIELDS:
            times[_TS_MS_FIELDS[ftype]] = _uint(raw)
        # unknown fields are skipped (length still consumed)
    if msg.icmp_type:
        msg.icmp_code = msg.icmp_type & 0xFF
        msg.icmp_type >>= 8
    msg.etype = etype
    if "first" in times:  # v9 sysuptime-relative millis
        msg.time_flow_start = header_secs - max(0, sysuptime - times["first"]) // 1000
    if "last" in times:
        msg.time_flow_end = header_secs - max(0, sysuptime - times["last"]) // 1000
    if "start_s" in times:
        msg.time_flow_start = times["start_s"]
    if "end_s" in times:
        msg.time_flow_end = times["end_s"]
    if "start_ms" in times:
        msg.time_flow_start = times["start_ms"] // 1000
    if "end_ms" in times:
        msg.time_flow_end = times["end_ms"] // 1000
    if not msg.time_flow_start:
        msg.time_flow_start = now
    if not msg.time_flow_end:
        msg.time_flow_end = msg.time_flow_start
    return msg, off, has_sampling


def _read_field_specs(data, off, end, count, enterprise: bool):
    """``enterprise`` is the IPFIX PEN rule (bit 15 => 4 extra bytes);
    NetFlow v9 has no such encoding, so its callers pass False — a v9
    vendor field type >= 0x8000 is just a type, not a length change."""
    fields = []
    for _ in range(count):
        # field specs must stay inside this flowset: an overstated count
        # would otherwise swallow the next set's bytes and cache a
        # corrupt template that mis-decodes every later record
        if off + 4 > end:
            raise ValueError("template field specs overrun flowset")
        ftype, flen = struct.unpack_from(">HH", data, off)
        off += 4
        if enterprise and ftype & 0x8000:  # IPFIX enterprise: skip the PEN
            if off + 4 > end:
                raise ValueError("enterprise field PEN overruns flowset")
            off += 4
            ftype = 0  # unknown -> skipped at decode
        fields.append((ftype, flen))
    return fields, off


def _decode_templates(data, off, end, source, domain, cache,
                      enterprise=False):
    while off + 4 <= end:
        tid, fcount = struct.unpack_from(">HH", data, off)
        off += 4
        fields, off = _read_field_specs(data, off, end, fcount, enterprise)
        cache.put(source, domain, tid, fields)
    return off


def _decode_options_templates_v9(data, off, end, source, domain, cache):
    """v9 options template: tid, scope length (bytes), options length
    (bytes), then scope + option field specs (RFC 3954 §6.1)."""
    while off + 6 <= end:
        tid, scope_len, opt_len = struct.unpack_from(">HHH", data, off)
        off += 6
        if tid == 0:  # padding
            break
        n_fields = (scope_len + opt_len) // 4
        fields, off = _read_field_specs(data, off, end, n_fields,
                                        enterprise=False)
        cache.put(source, domain, tid, fields, is_options=True)
    return off


def _decode_options_templates_ipfix(data, off, end, source, domain, cache):
    """IPFIX options template: tid, total field count, scope field count,
    then the field specs (RFC 7011 §3.4.2.2)."""
    while off + 6 <= end:
        tid, fcount, _scope_count = struct.unpack_from(">HHH", data, off)
        off += 6
        if tid == 0:  # padding
            break
        fields, off = _read_field_specs(data, off, end, fcount,
                                        enterprise=True)
        cache.put(source, domain, tid, fields, is_options=True)
    return off


# option-data field types carrying the exporter's sampling interval
_SAMPLING_FIELDS = {34, 305}  # SAMPLING_INTERVAL, samplingPacketInterval


def _decode_options_data(fields, data, off, end, source, domain, cache):
    """Scan option data records for a sampling interval; cache it
    exporter-wide."""
    rec_len = _min_record_len(fields)
    if rec_len <= 0:
        return
    while off + rec_len <= end:
        p = off
        for ftype, flen in fields:
            if flen == VARLEN:
                _, p = _varlen_slice(data, p, end)
                continue
            if p + flen > end:  # fixed tail after a long varlen value
                raise ValueError("options record field overruns set")
            if ftype in _SAMPLING_FIELDS:
                rate = _uint(data[p : p + flen])
                if rate:
                    cache.sampling[(source, domain)] = rate
            p += flen
        off = p  # varlen fields make records variable-width


def decode_v9(data: bytes, cache: TemplateCache, source: str = "",
              now: Optional[int] = None) -> list[FlowMessage]:
    if len(data) < 20:
        raise ValueError("short NetFlow v9 header")
    _, count, sysuptime, unix_secs, seq, source_id = struct.unpack_from(
        ">HHIIII", data, 0
    )
    now = now or unix_secs
    msgs = []
    inherit = []  # records lacking an inline sampling field
    off = 20
    while off + 4 <= len(data):
        set_id, set_len = struct.unpack_from(">HH", data, off)
        if set_len < 4 or off + set_len > len(data):
            raise ValueError("bad v9 flowset length")
        body_end = off + set_len
        body = off + 4
        if set_id == 0:  # template set
            _decode_templates(data, body, body_end, source, source_id, cache)
        elif set_id == 1:  # options template (sampling-rate carrier)
            try:
                _decode_options_templates_v9(data, body, body_end, source,
                                             source_id, cache)
            except ValueError:
                pass  # a malformed options set must not drop the datagram's flows
        elif set_id > 255:  # data set
            fields = cache.get(source, source_id, set_id)
            if fields is not None:
                if cache.is_options(source, source_id, set_id):
                    try:
                        _decode_options_data(fields, data, body, body_end,
                                             source, source_id, cache)
                    except ValueError:
                        pass  # a corrupt options record must not drop the datagram's flows
                else:
                    rec_len = _min_record_len(fields)
                    while body + rec_len <= body_end and rec_len > 0:
                        msg, body, has_sampling = _record_from_fields(
                            fields, data, body, FlowType.NETFLOW_V9, now,
                            unix_secs, sysuptime, seq, end=body_end,
                        )
                        msgs.append(msg)
                        if not has_sampling:
                            inherit.append(msg)
        off = body_end
    _apply_exporter_sampling(inherit, cache, source, source_id)
    return msgs


def decode_ipfix(data: bytes, cache: TemplateCache, source: str = "",
                 now: Optional[int] = None) -> list[FlowMessage]:
    if len(data) < 16:
        raise ValueError("short IPFIX header")
    _, length, export_secs, seq, domain = struct.unpack_from(">HHIII", data, 0)
    now = now or export_secs
    msgs = []
    inherit = []  # records lacking an inline sampling field
    off = 16
    end = min(len(data), length)
    while off + 4 <= end:
        set_id, set_len = struct.unpack_from(">HH", data, off)
        if set_len < 4 or off + set_len > end:
            raise ValueError("bad IPFIX set length")
        body_end = off + set_len
        body = off + 4
        if set_id == 2:  # template set
            _decode_templates(data, body, body_end, source, domain, cache,
                              enterprise=True)
        elif set_id == 3:  # options template (sampling-rate carrier)
            try:
                _decode_options_templates_ipfix(data, body, body_end, source,
                                                domain, cache)
            except ValueError:
                pass  # a malformed options set must not drop the datagram's flows
        elif set_id > 255:
            fields = cache.get(source, domain, set_id)
            if fields is not None:
                if cache.is_options(source, domain, set_id):
                    try:
                        _decode_options_data(fields, data, body, body_end,
                                             source, domain, cache)
                    except ValueError:
                        pass  # a corrupt options record must not drop the datagram's flows
                else:
                    rec_len = _min_record_len(fields)
                    while body + rec_len <= body_end and rec_len > 0:
                        msg, body, has_sampling = _record_from_fields(
                            fields, data, body, FlowType.IPFIX, now,
                            export_secs, 0, seq, end=body_end,
                        )
                        msgs.append(msg)
                        if not has_sampling:
                            inherit.append(msg)
        off = body_end
    _apply_exporter_sampling(inherit, cache, source, domain)
    return msgs


def _apply_exporter_sampling(msgs, cache: TemplateCache, source: str,
                             domain: int) -> None:
    """Flows WITHOUT an inline sampling field (callers pass only those)
    inherit the exporter-wide rate announced via options data; records stay
    at the default 1 when neither exists."""
    rate = cache.exporter_sampling(source, domain)
    if not rate:
        return
    for m in msgs:
        m.sampling_rate = rate


def decode_netflow(data: bytes, cache: TemplateCache, source: str = "",
                   now: Optional[int] = None) -> list[FlowMessage]:
    """Dispatch on the version word (v5 / v9 / IPFIX share UDP 2055)."""
    if len(data) < 2:
        raise ValueError("empty datagram")
    version = struct.unpack_from(">H", data, 0)[0]
    if version == 5:
        return decode_v5(data, now)
    if version == 9:
        return decode_v9(data, cache, source, now)
    if version == 10:
        return decode_ipfix(data, cache, source, now)
    raise ValueError(f"unsupported NetFlow version {version}")
