"""The mesh coordinator's write-ahead journal (``-mesh.journal DIR``).

Counterpart of flow_pipeline_tpu/mesh/journal.py; a file either package
writes replays in the other. mesh/coordinator.py appends one record per
protocol decision: ``sub`` (an accepted member submission, its codec
envelope verbatim, fsynced before the ack returns), ``fence`` (a member
death: its carry was promoted at this point of the record order),
``epoch`` (a rebalance), ``merged`` (a window merged and written to the
sinks; recovery does not emit it again) and ``chk`` (a compaction
checkpoint: the coordinator's recoverable state as the first record of
a fresh file that atomically replaces the old one).

``append()`` buffers under the journal lock; ``sync()`` is the group
commit, one flush and fsync for every record appended since the last.
Recovery replays every intact record in order and stops, with a
warning, at a torn tail (a short or CRC-failing last record).

Wire format: ``FJRNL1\n``, then per record ``u32 body_len | u32
crc32(body) | body``, the body one JSON header line, ``\n`` and an
optional binary blob (the codec envelope).
"""

from __future__ import annotations

import json
import logging
import os
import struct
import threading
import time
import zlib
from typing import Iterator, Optional

from ..utils import fsutil

log = logging.getLogger("flow_pipeline_tpu_torch.mesh")

MAGIC = b"FJRNL1\n"
_HEAD = struct.Struct("<II")  # body_len, crc32(body)

JOURNAL_FILE = "coordinator.journal"


class CoordinatorJournal:
    """One append-only journal file under ``dir``. ``metrics`` is an
    optional dict with ``records`` (Counter, label kind),
    ``unsynced`` (Gauge) and ``lag`` (Gauge) — the coordinator passes
    its eagerly-registered families so dashboards resolve whether or
    not a journal exists."""

    def __init__(self, dir_: str, metrics: Optional[dict] = None):
        os.makedirs(dir_, exist_ok=True)
        self.dir = dir_
        self.path = os.path.join(dir_, JOURNAL_FILE)
        size = os.path.getsize(self.path) \
            if os.path.exists(self.path) else 0
        if 0 < size < len(MAGIC):
            # a crash during the very FIRST init tore the magic write
            # (nothing was ever acked against this file): start fresh
            # rather than wedging every subsequent startup on it
            log.warning("journal %s: torn file magic (%d bytes); "
                        "starting a fresh journal", self.path, size)
            os.truncate(self.path, 0)
            size = 0
        self._lock = threading.Lock()
        self._f = fsutil.open_durable(self.path, "ab")
        self._dirty = 0  # records appended, not yet fsynced
        self._oldest_dirty = 0.0  # wall stamp of the oldest unsynced append
        self._closed = False
        self._bytes = size  # file size incl. magic
        self._m = metrics or {}
        if self._m.get("bytes") is not None:
            self._m["bytes"].set(size)
        if size == 0:
            with self._lock:
                self._f.write(MAGIC)
                fsutil.fsync_file(self._f)
                self._bytes = len(MAGIC)
            if self._m.get("bytes") is not None:
                self._m["bytes"].set(len(MAGIC))
            # the DIRECTORY entry must be durable too: fsyncing file
            # contents alone does not persist a freshly created name —
            # power loss could otherwise drop the whole journal file
            # after acks went out, silently voiding the recovery
            # contract
            fsutil.fsync_dir(dir_)

    # ---- write side --------------------------------------------------------

    def append(self, kind: str, meta: dict, blob: bytes = b"") -> None:
        """Buffer one record (cheap: an in-process file write). Callers
        that need durability call ``sync()`` before acking."""
        header = json.dumps({"t": kind, **meta}).encode() + b"\n"
        body = header + blob
        rec = _HEAD.pack(len(body), zlib.crc32(body)) + body
        now = time.time()
        with self._lock:
            if self._closed:
                return
            self._f.write(rec)
            self._bytes += len(rec)
            nbytes = self._bytes
            if self._dirty == 0:
                self._oldest_dirty = now
            self._dirty += 1
            dirty = self._dirty
            oldest = self._oldest_dirty
        if self._m:
            self._m["records"].inc(kind=kind)
            self._m["unsynced"].set(dirty)
            self._m["lag"].set(now - oldest)
            if self._m.get("bytes") is not None:
                self._m["bytes"].set(nbytes)

    def sync(self) -> None:
        """Group-commit barrier: flush + fsync everything appended so
        far. A no-op when clean; concurrent callers whose records were
        covered by another caller's fsync return immediately."""
        with self._lock:
            if self._closed or self._dirty == 0:
                return
            fsutil.fsync_file(self._f)
            self._dirty = 0
        if self._m:
            self._m["unsynced"].set(0)
            self._m["lag"].set(0.0)

    def size_bytes(self) -> int:
        """Current journal file size (buffered writes included) — the
        compaction trigger's input and the mesh_journal_bytes gauge."""
        with self._lock:
            return self._bytes

    def compact(self, meta: dict, blob: bytes) -> None:
        """Checkpoint + truncate: atomically replace the journal with a
        fresh file whose FIRST (and only) record is a ``chk`` carrying
        the coordinator's recoverable state. The caller must serialize
        against its own appenders (the coordinator holds its _lock —
        an append racing the swap would land in the dead file and be
        silently lost). Crash-safe at every step: the new file is
        fully written + fsynced BEFORE the rename, the rename is atomic,
        and the directory entry is fsynced after — a crash leaves either
        the complete old journal or the complete compacted one."""
        header = json.dumps({"t": "chk", **meta}).encode() + b"\n"
        body = header + blob
        rec = _HEAD.pack(len(body), zlib.crc32(body)) + body
        tmp = self.path + ".compact"
        with self._lock:
            if self._closed:
                return
            # flush the old handle first: buffered appends must not
            # outlive the swap and resurface via the stale fd
            fsutil.fsync_file(self._f)
            with fsutil.open_durable(tmp, "wb") as f:
                f.write(MAGIC)
                f.write(rec)
                fsutil.fsync_file(f)
            fsutil.replace(tmp, self.path)
            self._f.close()
            self._f = fsutil.open_durable(self.path, "ab")
            self._bytes = len(MAGIC) + len(rec)
            self._dirty = 0
            nbytes = self._bytes
        fsutil.fsync_dir(self.dir)
        if self._m:
            self._m["records"].inc(kind="chk")
            self._m["unsynced"].set(0)
            self._m["lag"].set(0.0)
            if self._m.get("bytes") is not None:
                self._m["bytes"].set(nbytes)
        log.info("journal %s compacted to %d bytes (checkpoint + "
                 "truncate)", self.path, nbytes)

    def close(self) -> None:
        self.sync()
        with self._lock:
            if not self._closed:
                self._closed = True
                self._f.close()

    # ---- read side ---------------------------------------------------------

    def replay(self) -> Iterator[tuple[str, dict, bytes]]:
        """Yield (kind, meta, blob) for every intact record, stopping —
        with a warning, not an error — at a torn tail (truncated or
        CRC-failing final record: the crash interrupted an append whose
        ack never went out)."""
        yield from replay_journal(self.path)


def replay_journal(path: str) -> Iterator[tuple[str, dict, bytes]]:
    """Replay a journal file (see :class:`CoordinatorJournal.replay`)."""
    if not os.path.exists(path):
        return
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if len(magic) < len(MAGIC):
            # torn first-init write: nothing was ever acked against
            # this file — recover to empty, don't wedge startup
            log.warning("journal %s: torn file magic; treating as "
                        "empty", path)
            return
        if magic != MAGIC:
            # a FULL-length mismatch is a foreign file, not a torn
            # write — refuse rather than silently ignore its contents
            raise ValueError(f"{path}: not a coordinator journal "
                             "(bad magic)")
        n = 0
        while True:
            head = f.read(_HEAD.size)
            if len(head) < _HEAD.size:
                if head:
                    log.warning("journal %s: torn record header after "
                                "%d records; recovering to there", path, n)
                return
            body_len, crc = _HEAD.unpack(head)
            body = f.read(body_len)
            if len(body) < body_len or zlib.crc32(body) != crc:
                log.warning("journal %s: torn/corrupt record after %d "
                            "records; recovering to there", path, n)
                return
            nl = body.index(b"\n")
            meta = json.loads(body[:nl].decode())
            kind = meta.pop("t")
            n += 1
            yield kind, meta, body[nl + 1:]
