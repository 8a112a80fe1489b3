"""Columnar FlowBatch: struct-of-arrays layout for device batches.

Design notes:

- Flows arrive as protobuf records; the device wants dense, fixed-width,
  same-dtype lanes. We decode straight into a struct-of-arrays where every
  column is a length-N numpy array and 16-byte addresses become ``[N, 4]``
  uint32 word lanes (big-endian word order, so IPv4-in-trailing-4-bytes —
  the collector convention, ref: compose/clickhouse/create.sh:44-45 — lands
  in word 3).
- All device-bound columns are (u)int32 bit patterns, the layout the
  JAX package ships to its device, so both packages hash the same words.
  Timestamps are seconds-since-epoch and fit uint32; per-flow
  Bytes/Packets are bounded by sample size (<64 KiB) and fit too.
- Batches carry their source offset range ``(partition, first_offset,
  last_offset)`` so sketch snapshots can record exactly which input they
  cover (at-least-once resume; the reference loses up to flush.count-1 rows
  by marking offsets before flush, ref: inserter/inserter.go:188 — we fix
  that by design).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional

import numpy as np

from .message import FlowMessage
from . import wire

# Column name -> numpy dtype for 1-D columns. Address columns are [N,4] uint32.
# Fields that are uint64 on the wire (timestamps, sampling rate, byte/packet
# counts — ref: pb-ext/flow.proto uint64 fields) keep 64 bits host-side and
# narrow at the device boundary (see device_columns).
COLUMNS: dict[str, np.dtype] = {
    "type": np.dtype(np.uint32),
    "time_received": np.dtype(np.uint64),
    "sampling_rate": np.dtype(np.uint64),
    "sequence_num": np.dtype(np.uint32),
    "time_flow_start": np.dtype(np.uint64),
    "time_flow_end": np.dtype(np.uint64),
    "bytes": np.dtype(np.uint64),
    "packets": np.dtype(np.uint64),
    "src_as": np.dtype(np.uint32),
    "dst_as": np.dtype(np.uint32),
    "in_if": np.dtype(np.uint32),
    "out_if": np.dtype(np.uint32),
    "proto": np.dtype(np.uint32),
    "src_port": np.dtype(np.uint32),
    "dst_port": np.dtype(np.uint32),
    "ip_tos": np.dtype(np.uint32),
    "forwarding_status": np.dtype(np.uint32),
    "ip_ttl": np.dtype(np.uint32),
    "tcp_flags": np.dtype(np.uint32),
    "etype": np.dtype(np.uint32),
    "icmp_type": np.dtype(np.uint32),
    "icmp_code": np.dtype(np.uint32),
    "ipv6_flow_label": np.dtype(np.uint32),
    "flow_direction": np.dtype(np.uint32),
}

ADDR_COLUMNS = ("src_addr", "dst_addr", "sampler_address")


def lane_width(name: str) -> int:
    """Device lanes a column occupies: addresses are 4 uint32 words, scalars 1.
    The single source of truth for key packing/unpacking widths."""
    return 4 if name in ADDR_COLUMNS else 1


def addr_to_words(addr: bytes) -> np.ndarray:
    """16-byte address -> 4 big-endian uint32 words. Short input (e.g. a raw
    IPv4) is left-padded to 16 bytes, matching the trailing-bytes embedding."""
    b = addr[-16:].rjust(16, b"\x00")
    return np.frombuffer(b, dtype=">u4").astype(np.uint32)


def words_to_addr(words: np.ndarray) -> bytes:
    return np.asarray(words, dtype=">u4").tobytes()


@dataclass
class FlowBatch:
    """A batch of N flows in struct-of-arrays layout.

    ``columns`` maps each 1-D column name to a length-N array (dtypes per
    COLUMNS); ``src_addr``/``dst_addr``/``sampler_address`` are [N,4] uint32.

    Normalization: the columnar form is fixed-width, so an absent address
    (``b""`` on the wire) and the all-zero address ``::`` are the same value
    here — exactly the collapse the reference's FixedString(16) storage makes
    (ref: compose/clickhouse/create.sh:44-45). ``to_messages`` yields 16-byte
    addresses for every row.
    """

    columns: dict[str, np.ndarray]
    partition: int = 0
    first_offset: int = -1
    last_offset: int = -1
    # trace id minted at decode (obs/trace.py); -1 when untraced
    chunk_id: int = -1
    # the guard's lag signal: wall clock when the batch's OLDEST message
    # was produced onto the bus (0.0 when the transport does not stamp;
    # the guard then sees no lag and stays at level 0). now - produced_at
    # is the age of the backlog head, what -guard.lag is measured against
    produced_at: float = 0.0

    # ---- construction -----------------------------------------------------

    @staticmethod
    def empty(n: int = 0) -> "FlowBatch":
        cols = {name: np.zeros(n, dtype=dt) for name, dt in COLUMNS.items()}
        for name in ADDR_COLUMNS:
            cols[name] = np.zeros((n, 4), dtype=np.uint32)
        return FlowBatch(cols)

    @staticmethod
    def from_messages(msgs: Iterable[FlowMessage]) -> "FlowBatch":
        msgs = list(msgs)
        batch = FlowBatch.empty(len(msgs))
        cols = batch.columns
        masks = {name: (1 << (8 * dt.itemsize)) - 1 for name, dt in COLUMNS.items()}
        for i, m in enumerate(msgs):
            for name in COLUMNS:
                # Mask to column width: oversized varints from a peer must not
                # kill the ingest path (numpy 2.x raises OverflowError).
                cols[name][i] = getattr(m, name) & masks[name]
            for name in ADDR_COLUMNS:
                cols[name][i] = addr_to_words(getattr(m, name))
        return batch

    @staticmethod
    def from_wire(data: bytes) -> "FlowBatch":
        """Decode a length-prefixed frame stream into a batch with the
        native columnar decoder (flow_pipeline_tpu_torch/native, built at
        first use). The pure-Python codec (``from_python_wire``) is its
        plain version; nothing falls back to it."""
        from .. import native

        return native.decode_stream(data)

    @staticmethod
    def from_python_wire(data: bytes) -> "FlowBatch":
        """Decode a length-prefixed frame stream with the pure-Python
        codec (schema/wire.py): the plain version of ``from_wire``."""
        return FlowBatch.from_messages(wire.decode_frames(data))

    def to_wire(self) -> bytes:
        """Length-prefixed frame stream for the whole batch, from the
        native bulk encoder (built at first use, as ``from_wire``'s
        decoder). ``to_python_wire`` is its plain version; nothing falls
        back to it."""
        from .. import native

        return native.encode_stream(self)

    def to_python_wire(self) -> bytes:
        """The pure-Python encoding (schema/wire.py): the plain version of
        ``to_wire``. It writes an all-zero address as 16 zero bytes where
        the native encoder omits the field; both decode to equal rows."""
        return wire.encode_stream(self.to_messages())

    # ---- views ------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.columns["bytes"])

    def to_messages(self) -> list[FlowMessage]:
        out = []
        for i in range(len(self)):
            m = FlowMessage()
            for name in COLUMNS:
                setattr(m, name, int(self.columns[name][i]))
            for name in ADDR_COLUMNS:
                setattr(m, name, words_to_addr(self.columns[name][i]))
            out.append(m)
        return out

    def device_columns(self, names: Optional[Iterable[str]] = None) -> dict:
        """Columns as int32-lane numpy arrays ready for the device copy.

        uint32 columns are bit-cast to int32 (raw words); uint64 columns are
        saturated to 2^32-1 then narrowed — timestamps in seconds fit uint32
        until 2106, and per-flow byte/packet counts above 4.29e9 clamp rather
        than wrap (window accumulators re-widen on device). May alias the
        batch's memory; treat as read-only."""
        if names is None:
            names = list(COLUMNS) + list(ADDR_COLUMNS)
        out = {}
        for name in names:
            arr = self.columns[name]
            if arr.dtype == np.uint64:
                arr = np.minimum(arr, np.uint64(0xFFFFFFFF)).astype(np.uint32)
            out[name] = arr.view(np.int32) if arr.dtype == np.uint32 else arr
        return out

    def nbytes(self) -> int:
        """Resident column bytes: the guard's buffer accounting unit
        (guard_buffer_bytes)."""
        return sum(v.nbytes for v in self.columns.values())

    def take(self, mask: np.ndarray) -> "FlowBatch":
        """Rows selected by a boolean mask, as fresh arrays. The offset
        range is kept unchanged: the guard's admission uses this, and the
        rows the mask drops were still consumed from the bus, so their
        offsets must keep committing."""
        cols = {k: v[mask] for k, v in self.columns.items()}
        return FlowBatch(cols, self.partition, self.first_offset,
                         self.last_offset, self.chunk_id, self.produced_at)

    def slice(self, start: int, stop: int) -> "FlowBatch":
        stop = min(stop, len(self))  # offsets must cover only real rows
        cols = {k: v[start:stop] for k, v in self.columns.items()}
        first = self.first_offset + start if self.first_offset >= 0 else -1
        last = self.first_offset + stop - 1 if self.first_offset >= 0 else -1
        return FlowBatch(cols, self.partition, first, last, self.chunk_id,
                         self.produced_at)

    def pad_to(self, n: int) -> tuple["FlowBatch", np.ndarray]:
        """Pad to length n (fixed chunk shapes); returns (batch, valid mask).
        Padding rows are all-zero, which every kernel treats as weight-0.
        When already exactly n long, the same batch is returned (no copy) —
        treat the result as read-only."""
        cur = len(self)
        if cur > n:
            raise ValueError(f"batch of {cur} cannot pad to {n}")
        mask = np.zeros(n, dtype=bool)
        mask[:cur] = True
        if cur == n:
            return self, mask
        cols = {}
        for k, v in self.columns.items():
            shape = (n,) + v.shape[1:]
            padded = np.zeros(shape, dtype=v.dtype)
            padded[:cur] = v
            cols[k] = padded
        return FlowBatch(cols, self.partition, self.first_offset,
                         self.last_offset, self.chunk_id,
                         self.produced_at), mask

    @staticmethod
    def concat(batches: list["FlowBatch"]) -> "FlowBatch":
        if not batches:
            return FlowBatch.empty(0)
        cols = {
            k: np.concatenate([b.columns[k] for b in batches])
            for k in batches[0].columns
        }
        return FlowBatch(
            cols,
            batches[0].partition,
            batches[0].first_offset,
            batches[-1].last_offset,
            produced_at=batches[0].produced_at,
        )
