"""Protobuf wire codec for FlowMessage — dependency-free.

Implements just enough of the proto3 wire format (varints + length-delimited
bytes) to encode/decode FlowMessage records and the length-prefixed framing
the reference pipeline uses for ClickHouse consumption (the producer writes
"messages with their lengths", ref: mocker/mocker.go:95-102, README.md:104).

This pure-Python codec is the plain version of the port's native
columnar decoder (flow_pipeline_tpu_torch/native), which FlowBatch.from_wire
uses; the tests hold the two against each other.
"""

from __future__ import annotations

from .message import FlowMessage, FIELDS, FIELD_BY_NUMBER

_WT_VARINT = 0
_WT_LEN = 2


def _put_varint(out: bytearray, value: int) -> None:
    if value < 0:
        raise ValueError("varint fields must be non-negative")
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _get_varint(buf: bytes | memoryview, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            # Canonical proto parsers truncate to 64 bits; match them.
            return result & 0xFFFFFFFFFFFFFFFF, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def encode_message(msg: FlowMessage) -> bytes:
    """Serialize one FlowMessage. Proto3 semantics: zero/empty fields are
    omitted from the wire."""
    out = bytearray()
    for num, name, kind in FIELDS:
        value = getattr(msg, name)
        if kind == "varint":
            if value:
                _put_varint(out, (num << 3) | _WT_VARINT)
                _put_varint(out, int(value))
        else:
            if value:
                _put_varint(out, (num << 3) | _WT_LEN)
                _put_varint(out, len(value))
                out += value
    return bytes(out)


def decode_message(data: bytes | memoryview) -> FlowMessage:
    """Parse one FlowMessage. Unknown fields are skipped (forward compat);
    unknown wire types raise."""
    msg = FlowMessage()
    pos = 0
    n = len(data)
    while pos < n:
        tag, pos = _get_varint(data, pos)
        num, wt = tag >> 3, tag & 0x7
        if wt == _WT_VARINT:
            value, pos = _get_varint(data, pos)
            entry = FIELD_BY_NUMBER.get(num)
            if entry is not None and entry[1] == "varint":
                setattr(msg, entry[0], value)
        elif wt == _WT_LEN:
            length, pos = _get_varint(data, pos)
            if pos + length > n:
                raise ValueError("truncated length-delimited field")
            entry = FIELD_BY_NUMBER.get(num)
            if entry is not None and entry[1] == "bytes":
                setattr(msg, entry[0], bytes(data[pos : pos + length]))
            pos += length
        elif wt == 5:  # 32-bit, skip
            if pos + 4 > n:
                raise ValueError("truncated fixed32 field")
            pos += 4
        elif wt == 1:  # 64-bit, skip
            if pos + 8 > n:
                raise ValueError("truncated fixed64 field")
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wt}")
    return msg


def encode_frame(msg: FlowMessage) -> bytes:
    """Length-prefixed encoding (varint length + body) — the `proto.fixedlen`
    framing the reference enables for ClickHouse's Protobuf Kafka format
    (ref: mocker/mocker.go:95-102)."""
    body = encode_message(msg)
    out = bytearray()
    _put_varint(out, len(body))
    return bytes(out) + body


def encode_stream(msgs) -> bytes:
    """Concatenate length-prefixed frames for a sequence of messages."""
    out = bytearray()
    for m in msgs:
        out += encode_frame(m)
    return bytes(out)


def iter_raw_frames(data: bytes | memoryview):
    """Yield each length-prefixed frame's raw bytes (prefix included) without
    decoding — for splitting a frames stream onto a bus/partitions with one
    decode total downstream."""
    pos = 0
    n = len(data)
    view = memoryview(data)
    while pos < n:
        start = pos
        length, pos = _get_varint(view, pos)
        if pos + length > n:
            raise ValueError("truncated frame")
        pos += length
        yield bytes(view[start:pos])


def decode_frames(data: bytes | memoryview) -> list[FlowMessage]:
    """Parse a concatenation of length-prefixed FlowMessage frames."""
    msgs = []
    pos = 0
    n = len(data)
    view = memoryview(data)
    while pos < n:
        length, pos = _get_varint(view, pos)
        if pos + length > n:
            raise ValueError("truncated frame")
        msgs.append(decode_message(view[pos : pos + length]))
        pos += length
    return msgs
