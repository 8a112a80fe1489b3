"""sFlow v5 datagram decoder (flow samples with raw packet headers).

Layout per the sFlow v5 spec (sflow.org): XDR-encoded datagram carrying
samples; each flow sample carries flow records; record type 1 is the raw
sampled packet header, which we parse down the Ethernet / 802.1Q / IPv4 /
IPv6 / TCP / UDP / ICMP stack for the FlowMessage fields. Counter samples
are skipped (the pipeline carries flows, matching the collector role in
ref: README.md:15).

A copy of flow_pipeline_tpu/collector/sflow.py (pure Python).
"""

from __future__ import annotations

import struct
import time
from typing import Optional

from ..schema.message import FlowMessage, FlowType

_FMT_FLOW_SAMPLE = 1
_FMT_FLOW_SAMPLE_EXPANDED = 3
_REC_RAW_PACKET = 1
_PROTO_ETHERNET = 1


def _parse_packet_header(hdr: bytes, msg: FlowMessage) -> bool:
    """Ethernet(+VLAN) -> IP -> L4. Returns False if not IP."""
    if len(hdr) < 14:
        return False
    etype = struct.unpack_from(">H", hdr, 12)[0]
    off = 14
    if etype == 0x8100 and len(hdr) >= 18:  # 802.1Q VLAN tag
        etype = struct.unpack_from(">H", hdr, 16)[0]
        off = 18
    msg.etype = etype
    if etype == 0x0800 and len(hdr) >= off + 20:  # IPv4
        ihl = (hdr[off] & 0x0F) * 4
        msg.ip_tos = hdr[off + 1]
        msg.ip_ttl = hdr[off + 8]
        msg.proto = hdr[off + 9]
        msg.src_addr = b"\x00" * 12 + hdr[off + 12 : off + 16]
        msg.dst_addr = b"\x00" * 12 + hdr[off + 16 : off + 20]
        l4 = off + ihl
    elif etype == 0x86DD and len(hdr) >= off + 40:  # IPv6
        vtc_fl = struct.unpack_from(">I", hdr, off)[0]
        msg.ipv6_flow_label = vtc_fl & 0xFFFFF
        msg.ip_tos = (vtc_fl >> 20) & 0xFF
        msg.proto = hdr[off + 6]
        msg.ip_ttl = hdr[off + 7]
        msg.src_addr = hdr[off + 8 : off + 24]
        msg.dst_addr = hdr[off + 24 : off + 40]
        l4 = off + 40
    else:
        return False
    if msg.proto in (6, 17) and len(hdr) >= l4 + 4:  # TCP/UDP ports
        msg.src_port, msg.dst_port = struct.unpack_from(">HH", hdr, l4)
        if msg.proto == 6 and len(hdr) >= l4 + 14:
            msg.tcp_flags = hdr[l4 + 13]
    elif msg.proto in (1, 58) and len(hdr) >= l4 + 2:  # ICMP(v6)
        msg.icmp_type, msg.icmp_code = hdr[l4], hdr[l4 + 1]
    return True


def decode_sflow(data: bytes, now: Optional[int] = None) -> list[FlowMessage]:
    if len(data) < 28:
        raise ValueError("short sFlow datagram")
    now = now or int(time.time())
    version, ip_ver = struct.unpack_from(">II", data, 0)
    if version != 5:
        raise ValueError(f"unsupported sFlow version {version}")
    off = 8
    agent_len = 4 if ip_ver == 1 else 16
    agent = data[off : off + agent_len]
    off += agent_len
    _sub_agent, seq, _uptime, n_samples = struct.unpack_from(">IIII", data, off)
    off += 16
    sampler = b"\x00" * 12 + agent if agent_len == 4 else agent

    msgs = []
    for _ in range(n_samples):
        if off + 8 > len(data):
            raise ValueError("truncated sFlow sample header")
        fmt, slen = struct.unpack_from(">II", data, off)
        off += 8
        s_end = off + slen
        if s_end > len(data):
            raise ValueError("truncated sFlow sample")
        fmt_type = fmt & 0xFFF  # low bits: format within enterprise 0
        if fmt_type in (_FMT_FLOW_SAMPLE, _FMT_FLOW_SAMPLE_EXPANDED):
            p = off
            if fmt_type == _FMT_FLOW_SAMPLE:
                (_sseq, _source, rate, _pool, _drops, in_if, out_if,
                 n_rec) = struct.unpack_from(">IIIIIIII", data, p)
                p += 32
            else:  # expanded: source/interface fields are (format, value)
                (_sseq, _sfmt, _sval, rate, _pool, _drops, in_fmt, in_val,
                 out_fmt, out_val, n_rec) = struct.unpack_from(
                    ">IIIIIIIIIII", data, p
                )
                in_if, out_if = in_val, out_val
                p += 44
            for _ in range(n_rec):
                # Bounds discipline matches the v9 flowset checks: a corrupt
                # rlen/n_rec must not read into the next sample's bytes and
                # silently mis-parse records.
                if p + 8 > s_end:
                    raise ValueError("truncated sFlow flow-record header")
                rfmt, rlen = struct.unpack_from(">II", data, p)
                p += 8
                r_end = p + rlen
                if r_end > s_end:
                    raise ValueError("sFlow flow record overruns sample")
                if (rfmt & 0xFFF) == _REC_RAW_PACKET and rlen >= 16:
                    proto, frame_len, _stripped, hdr_len = struct.unpack_from(
                        ">IIII", data, p
                    )
                    hdr = data[p + 16 : min(p + 16 + hdr_len, r_end)]
                    if proto == _PROTO_ETHERNET:
                        msg = FlowMessage(
                            type=FlowType.SFLOW_5,
                            time_received=now,
                            time_flow_start=now,
                            time_flow_end=now,
                            sampling_rate=rate or 1,
                            sequence_num=seq,
                            sampler_address=sampler,
                            bytes=frame_len,
                            packets=1,
                            in_if=in_if,
                            out_if=out_if,
                        )
                        if _parse_packet_header(hdr, msg):
                            msgs.append(msg)
                p = r_end
        off = s_end
    return msgs
