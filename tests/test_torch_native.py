"""The port's native frame decoder (flow_pipeline_tpu_torch/native) against
its plain version, the port's pure-Python codec (schema/wire.py), and
against the JAX package's native decoder where that library loads.

Inputs are seeded: mocker and Zipf streams, every field at random widths
(uint64 counters, 4-, 16- and 20-byte addresses), all-default messages
(1-byte frames), unknown fields, skipped fixed32/fixed64 fields, wire
types that do not match the schema, and truncated or corrupted tails.
Decoded columns must be equal, dtype and value (tolerance: none); input
one decoder refuses, the other must refuse too, with ValueError.
"""

import threading

import numpy as np
import pytest

from flow_pipeline_tpu_torch import native
from flow_pipeline_tpu_torch.gen import FlowGenerator, MockerProfile, ZipfProfile
from flow_pipeline_tpu_torch.schema import wire
from flow_pipeline_tpu_torch.schema.batch import (ADDR_COLUMNS, COLUMNS,
                                                  FlowBatch)
from flow_pipeline_tpu_torch.schema.message import FIELDS


def _varint(v: int) -> bytes:
    out = bytearray()
    wire._put_varint(out, v)
    return bytes(out)


def _frame(body: bytes) -> bytes:
    return _varint(len(body)) + body


def _random_body(rng) -> bytes:
    """A message with a random subset of fields at random widths, plus
    noise the decoders must skip."""
    body = bytearray()
    for num, _name, kind in FIELDS:
        if rng.random() < 0.4:
            continue
        if kind == "varint":
            bits = int(rng.choice([8, 32, 33, 63, 64]))
            body += _varint((num << 3) | 0)
            body += _varint(int(rng.integers(0, 2**bits - 1, dtype=np.uint64,
                                             endpoint=True)))
        else:
            n = int(rng.choice([0, 4, 16, 20]))
            body += _varint((num << 3) | 2) + _varint(n)
            body += rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if rng.random() < 0.5:  # unknown varint and bytes fields
        body += _varint((77 << 3) | 0) + _varint(12345)
        body += _varint((78 << 3) | 2) + _varint(3) + b"abc"
    if rng.random() < 0.5:  # fixed32 and fixed64, skipped
        body += _varint((79 << 3) | 5) + b"\x01\x02\x03\x04"
        body += _varint((80 << 3) | 1) + bytes(8)
    if rng.random() < 0.3:  # bytes for a varint field, varint for bytes
        body += _varint((9 << 3) | 2) + _varint(2) + b"xy"
        body += _varint((6 << 3) | 0) + _varint(99)
    return bytes(body)


def _streams():
    rng = np.random.default_rng(42)
    mixed = b"".join(_frame(_random_body(rng)) for _ in range(600))
    defaults = b"".join(_frame(b"") for _ in range(17))  # 1-byte frames
    return {
        "mocker": FlowGenerator(MockerProfile(), seed=1).batch(3000).to_wire(),
        "zipf": FlowGenerator(ZipfProfile(), seed=2,
                              rate=500.0).batch(3000).to_wire(),
        "random_fields": mixed,
        "all_default": defaults,
        "interleaved": b"".join(
            _frame(b"") + _frame(_random_body(rng)) for _ in range(100)),
        "empty": b"",
    }


STREAMS = _streams()


def _assert_same(got: FlowBatch, want: FlowBatch):
    assert len(got) == len(want)
    assert list(got.columns) == [*COLUMNS, *ADDR_COLUMNS]
    for name, col in want.columns.items():
        assert got.columns[name].dtype == col.dtype, name
        np.testing.assert_array_equal(got.columns[name], col, err_msg=name)


def _outcome(fn, data):
    try:
        return fn(data)
    except ValueError:
        return ValueError


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_native_matches_python_decode(name):
    data = STREAMS[name]
    got = FlowBatch.from_wire(data)  # the native decoder
    want = FlowBatch.from_python_wire(data)
    _assert_same(got, want)
    assert native.count_frames(data) == len(want)
    if name == "all_default":
        assert len(data) == len(want) == 17
        assert all(not col.any() for col in got.columns.values())


@pytest.mark.parametrize("name", ["mocker", "random_fields"])
def test_truncated_and_corrupted_tails(name):
    """Every cut of the stream's last frames, and seeded byte flips:
    both decoders decode the same rows or both refuse."""
    data = STREAMS[name]
    rng = np.random.default_rng(9)
    refused = 0
    cases = [data[:len(data) - k] for k in range(1, 40)]
    for _ in range(200):
        buf = bytearray(data[:400])
        for pos in rng.integers(0, len(buf), 3):
            buf[pos] = int(rng.integers(0, 256))
        cases.append(bytes(buf))
    for case in cases:
        got = _outcome(FlowBatch.from_wire, case)
        want = _outcome(FlowBatch.from_python_wire, case)
        if want is ValueError:
            assert got is ValueError
            refused += 1
        else:
            assert got is not ValueError
            _assert_same(got, want)
    assert refused > 10  # the cuts did hit truncated frames


def test_matches_reference_native_decoder():
    """Equal to the JAX package's native decode_stream, where its library
    is built (decided here, at run time); the port's Python decode is
    checked against it either way."""
    from flow_pipeline_tpu import native as jnative

    for data in STREAMS.values():
        got = FlowBatch.from_wire(data)
        if jnative.available():
            _assert_same(got, jnative.decode_stream(data))
        _assert_same(FlowBatch.from_python_wire(data), got)


def test_build_is_atomic_under_concurrency(tmp_path):
    """Two builds of a fresh directory at once: both return the same
    library, it loads and decodes, and no temporary file is left."""
    paths, errors = [], []

    def build():
        try:
            paths.append(native.build(tmp_path))
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(paths) == 2 and paths[0] == paths[1]
    assert sorted(p.name for p in tmp_path.iterdir()) == [paths[0].name]
    lib = native.load(paths[0])
    data = STREAMS["zipf"]
    assert lib.fpt_count_frames(data, len(data)) == 3000
    assert native.build_key("g++") != native.build_key("clang++")


def test_from_wire_uses_native_and_refuses_malformed():
    """The native path really is the one from_wire takes: the library is
    loaded after a decode, and malformed input raises ValueError naming
    the frame."""
    FlowBatch.from_wire(STREAMS["mocker"])
    assert native.available()
    with pytest.raises(ValueError, match="frame"):
        FlowBatch.from_wire(b"\x05\x08")
    with pytest.raises(ValueError, match="frame"):
        FlowBatch.from_wire(_frame(b"\x0f"))  # wire type 7


def _batch(name):
    """A batch to encode: a generated stream, or the decoded random-field
    or all-default stream (uint64 extremes, 4/16/20-byte addresses,
    all-zero rows)."""
    return FlowBatch.from_python_wire(STREAMS[name])


@pytest.mark.parametrize("name", ["mocker", "zipf", "random_fields",
                                  "all_default", "empty"])
def test_encoder_round_trips_and_matches_python_rows(name):
    """fpt_encode_stream (``to_wire``) decodes back to the batch, through
    the native and the Python decoder; its plain version
    (``to_python_wire``) differs only by writing all-zero addresses,
    which both decode to the same rows."""
    batch = _batch(name)
    data = batch.to_wire()
    _assert_same(FlowBatch.from_wire(data), batch)
    _assert_same(FlowBatch.from_python_wire(data), batch)
    plain = batch.to_python_wire()
    assert len(data) <= len(plain)
    _assert_same(FlowBatch.from_wire(plain), FlowBatch.from_wire(data))
    if name == "all_default":
        assert data == b"\x00" * 17  # every field omitted: empty bodies
    if len(batch):
        with pytest.raises(ValueError, match="too small"):
            native.encode_stream(batch, out_capacity=4)


@pytest.mark.parametrize("name", ["mocker", "zipf", "random_fields",
                                  "all_default"])
def test_encoder_matches_reference_native_encoder(name):
    """The same bytes as the JAX package's native encode_stream (skipped
    where its library is not built)."""
    from flow_pipeline_tpu import native as jnative
    from flow_pipeline_tpu.schema.batch import FlowBatch as JBatch

    if not jnative.available():
        pytest.skip("the JAX package's native library is not built "
                    "(make native)")
    batch = _batch(name)
    want = jnative.encode_stream(JBatch(columns={
        k: v.copy() for k, v in batch.columns.items()}))
    assert batch.to_wire() == want
