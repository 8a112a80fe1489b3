"""The history tier's archive: the durable snapshot timeline on disk.

Counterpart of flow_pipeline_tpu/history/archive.py (stdlib and numpy
only); its segment files are byte-equal to the reference's for the same
state sequence, and each package reads the other's. The serving tier
holds the newest snapshot plus RANGE_SLOTS closed windows; this module
persists the gateway's delta chain so that any archived version rebuilds
on demand, bit for bit:

- :class:`ArchiveWriter` subscribes to a serving tier's ``/sub/snapshot``
  feed (the :class:`~..gateway.subscriber._Upstream` transport a gateway
  replica uses), or is driven passively by an embedding gateway, and
  appends each version transition as one CRC-framed record: a full
  **keyframe** every ``keyframe_every`` versions (and at every chain
  break), a **delta** otherwise. Keyframes start a new segment file;
  appends are group-committed with ``fsync``, rotations with a directory
  fsync, all through utils/fsutil.py.
- :class:`ArchiveReader` rebuilds a version from the nearest keyframe
  <= target, applying deltas forward with ``gateway.delta.apply_delta``.
- Retention is byte-bounded (``retain_bytes``) and evicts WHOLE keyframe
  segments, oldest first. The segment being written is never evicted.

Damage model: a torn tail, CRC mismatch, unparseable header, or chain
hole invalidates the REST of that segment (deltas after a hole cannot
be anchored), and the reader skips forward to the next segment's
keyframe. A damaged or evicted version answers
:class:`HistoryGapError` with the nearest archived versions on either
side — an honest 404, never a silently-wrong snapshot.

Record layout (per record, after the per-segment ``FHARC1\\n`` magic)::

    u32 body_len | u32 crc32(body) | body
    body = JSON meta line + b"\\n" + one FGWD1 frame
           (gateway.delta.encode_full for keyframes,
            encode_delta for deltas)

The meta line carries {t, v, from, ts, wm, slots} so the reader can
index versions, timestamps and closed range slots WITHOUT decoding
blobs; the FGWD1 frame inside carries its own CRC, so every blob read
is re-validated end-to-end at reconstruction time.
"""

from __future__ import annotations

# The writer's segment and ledger state is guarded by _lock; the
# subscription mirror state is touched only by the writer's own poll
# thread (or sync_once test callers, never both). The reader's segment
# index and state cache are guarded by its own _lock. The subscription
# transport is gateway.subscriber._Upstream, with an explicit per-request
# timeout. Segment appends, rotations and evictions all go through
# utils/fsutil.py: records become durable at the group commit's fsync, a
# new segment's name and an eviction at the directory's fsync.

import json
import logging
import os
import re
import struct
import threading
import time
import zlib
from typing import Optional

from ..gateway.delta import (DeltaError, DeltaGapError, apply_delta,
                             decode_frames, encode_delta, encode_full,
                             state_to_snapshot)
from ..obs.metrics import REGISTRY
from ..utils import fsutil

log = logging.getLogger("flow_pipeline_tpu_torch.history")

MAGIC = b"FHARC1\n"
_HEAD = struct.Struct("<II")  # body_len, crc32(body)
_SEG_RE = re.compile(r"seg-(\d{20})\.fharc$")

KEYFRAME_EVERY = 64     # -history.keyframe: deltas between keyframes
RETAIN_BYTES = 1 << 30  # -history.retain: archive byte bound (1 GiB)

# Metric name and help specs (the reference's, so dashboards resolve
# against the port's /metrics too).
HISTORY_METRICS = {
    "records": ("history_records_total",
                "flowhistory records archived (label: kind=key|delta)"),
    "record_bytes": ("history_record_bytes_total",
                     "flowhistory bytes appended to the archive (label: "
                     "kind=key|delta) — delta/key is the on-disk "
                     "compression ratio"),
    "archive_bytes": ("history_archive_bytes",
                      "flowhistory archive size on disk across all "
                      "segments, after retention"),
    "segments": ("history_segments",
                 "flowhistory keyframe segments on disk"),
    "evicted": ("history_evicted_segments_total",
                "flowhistory whole segments evicted by the "
                "-history.retain byte bound"),
    "lag": ("history_lag_versions",
            "newest version the upstream feed advertised minus the "
            "newest archived version — archive staleness"),
    "refused": ("history_refused_total",
                "version transitions the archive refused for moving "
                "backwards (an upstream RESTART republishing from a "
                "fresh store) — the archived timeline stays monotone"),
    "resyncs": ("history_resyncs_total",
                "full-snapshot resyncs forced on the archive "
                "subscription by a delta chain break (label: "
                "reason=gap|crc|error)"),
    "poll_failures": ("history_poll_failures_total",
                      "archive subscription polls that failed in "
                      "transport — the archive keeps its last durable "
                      "record, the gap stays visible as lag"),
    "reconstructs": ("history_reconstructs_total",
                     "snapshot reconstructions served from the archive "
                     "(keyframe read + delta replay)"),
    "reconstruct_seconds": ("history_reconstruct_seconds",
                            "wall seconds per archive reconstruction"),
    "reconstruct_depth": ("history_reconstruct_depth",
                          "delta-chain length replayed per "
                          "reconstruction (0 = keyframe hit)"),
    "gap_answers": ("history_gap_answers_total",
                    "time-travel queries answered 404 because the "
                    "version fell in an evicted or damaged gap"),
    "damage": ("history_damage_skipped_total",
               "archive segments whose tail was dropped at scan for "
               "CRC/parse/chain damage — the reader skipped to the "
               "next intact keyframe"),
}

_HIST_GAUGES = frozenset({"archive_bytes", "segments", "lag"})
_HIST_SECONDS_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                         0.5, 1.0, 2.5, 5.0)
_HIST_DEPTH_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0,
                       128.0, 256.0)


def register_history_metrics() -> dict:
    """Register (or fetch) every flowhistory metric family on the
    global registry. Idempotent; returns {spec key: metric}."""
    out = {}
    for key, spec in HISTORY_METRICS.items():
        if key in _HIST_GAUGES:
            out[key] = REGISTRY.gauge(*spec)
        elif key == "reconstruct_seconds":
            out[key] = REGISTRY.histogram(*spec,
                                          buckets=_HIST_SECONDS_BUCKETS)
        elif key == "reconstruct_depth":
            out[key] = REGISTRY.histogram(*spec,
                                          buckets=_HIST_DEPTH_BUCKETS)
        else:
            out[key] = REGISTRY.counter(*spec)
    return out


class HistoryGapError(ValueError):
    """The requested version fell in an evicted or damaged gap.
    Carries the nearest archived versions on either side (either may
    be None) so the 404 can offer them as hints."""

    def __init__(self, version: int, before: Optional[int],
                 after: Optional[int]):
        self.version = int(version)
        self.before = before
        self.after = after
        hints = []
        if before is not None:
            hints.append(f"nearest before: v{before}")
        if after is not None:
            hints.append(f"nearest after: v{after}")
        detail = "; ".join(hints) if hints else "archive is empty"
        super().__init__(
            f"version {version} is not archived ({detail})")


def _segment_path(dir_: str, version: int) -> str:
    # zero-padded to 20 digits: lexicographic order == numeric order
    return os.path.join(dir_, f"seg-{version:020d}.fharc")


def _meta_line(kind: str, state: dict,
               from_version: Optional[int]) -> bytes:
    meta = {
        "t": kind,
        "v": int(state["version"]),
        "ts": float(state["created"]),
        "wm": float(state["watermark"]),
        # closed range slots per table: the reader's slot index reads
        # this WITHOUT decoding blobs (gateway range retention)
        "slots": {table: [int(s) for s, _ in slots]
                  for table, slots in state["ranges"].items()},
    }
    if from_version is not None:
        meta["from"] = int(from_version)
    return json.dumps(meta, separators=(",", ":"), sort_keys=True).encode()


class ArchiveWriter:
    """Append the snapshot delta chain to a segment archive.

    Two driving modes over one durability core:

    - **passive**: an embedding gateway (``-history.dir`` on ``gateway``)
      calls ``record(prev_state, cur_state)`` per mirrored transition
      and ``commit()`` per poll — the archive rides the mirror thread.
    - **subscriber**: constructed with ``upstream=``, the writer owns a
      :class:`~..gateway.subscriber._Upstream` and polls the feed
      itself (``sync_once`` / ``start``): the standalone ``history``
      tier.

    Crash safety is the journal discipline: records become durable at
    ``commit()`` (flush + fsync), a rotation fsyncs the finished
    segment AND the directory, and after any restart the first record
    is forced to a keyframe in a NEW segment — a torn tail left by a
    crash mid-append is simply never appended to again, and the reader
    drops it at scan.
    """

    def __init__(self, dir_: str, keyframe_every: int = KEYFRAME_EVERY,
                 retain_bytes: int = RETAIN_BYTES, upstream=None,
                 name: str = "history", poll: float = 0.25,
                 timeout: float = 10.0, store=None):
        if keyframe_every < 1:
            raise ValueError(
                f"history keyframe cadence must be >= 1, got "
                f"{keyframe_every}")
        if retain_bytes < 1:
            raise ValueError(
                f"history retain bound must be >= 1 byte, got "
                f"{retain_bytes}")
        self.dir = dir_
        self.keyframe_every = int(keyframe_every)
        self.retain_bytes = int(retain_bytes)
        self.poll = poll
        os.makedirs(dir_, exist_ok=True)
        self._m = register_history_metrics()
        self._lock = threading.Lock()
        self._fh = None  # open segment file  # guarded by _lock
        self._seg_path: Optional[str] = None  # guarded by _lock
        self._seg_bytes = 0  # current segment size  # guarded by _lock
        # closed/pre-existing segments, oldest first: [(path, bytes)]
        self._closed: list = []  # guarded by _lock
        self._last_version = 0  # newest archived version  # guarded by _lock
        self._since_key = 0  # deltas since the keyframe  # guarded by _lock
        self._dirty = False  # unsynced appends  # guarded by _lock
        self._rotated = False  # dir entry not yet fsynced  # guarded by _lock
        # adopt what a previous incarnation left behind: retention and
        # the monotone version ledger must span restarts
        for path in sorted(os.listdir(dir_)):
            if _SEG_RE.search(path):
                full = os.path.join(dir_, path)
                try:
                    self._closed.append((full, os.path.getsize(full)))
                except OSError:  # pragma: no cover - racing an eviction
                    continue
        if self._closed:
            tail = ArchiveReader(dir_).versions()
            if tail:
                self._last_version = tail[-1]
        self._publish_gauges_locked()
        # ---- optional subscription (the standalone flowhistory tier)
        if upstream is not None:
            from ..gateway.subscriber import _Upstream

            self._up = _Upstream(upstream, name=name, timeout=timeout)
        else:
            self._up = None
        self.store = store  # optional live mirror store (HistoryServer)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- durability core ---------------------------------------------------

    @property
    def last_version(self) -> int:
        with self._lock:
            return self._last_version

    def record(self, prev_state: Optional[dict], cur_state: dict) -> str:
        """Append one version transition. Returns "key", "delta", or
        "skip" (a backwards version — upstream restart — is refused:
        the archived timeline stays monotone, like the serving store).
        Durable only after the next :meth:`commit`."""
        with self._lock:
            return self._record_locked(prev_state, cur_state)

    def _record_locked(self, prev_state, cur_state) -> str:
        version = int(cur_state["version"])
        if self._last_version and version <= self._last_version:
            self._m["refused"].inc()
            log.warning(
                "history refused v%d at or behind archived v%d — "
                "upstream restart; the archive keeps the old timeline "
                "(point -history.dir elsewhere to archive the new one)",
                version, self._last_version)
            return "skip"
        keyframe = (self._fh is None or prev_state is None
                    or int(prev_state["version"]) != self._last_version
                    or self._since_key >= self.keyframe_every)
        if keyframe:
            blob = encode_full(cur_state)
            kind, label, from_v = "key", "key", None
        else:
            blob = encode_delta(prev_state, cur_state)
            kind, label = "dlt", "delta"
            from_v = int(prev_state["version"])
        body = _meta_line(kind, cur_state, from_v) + b"\n" + blob
        rec = _HEAD.pack(len(body), zlib.crc32(body)) + body
        if keyframe:
            self._rotate_locked(version)
        self._fh.write(rec)
        self._seg_bytes += len(rec)
        self._dirty = True
        self._since_key = 0 if keyframe else self._since_key + 1
        self._last_version = version
        self._m["records"].inc(kind=label)
        self._m["record_bytes"].inc(len(rec), kind=label)
        return label

    def _rotate_locked(self, version: int) -> None:
        if self._fh is not None:
            fsutil.fsync_file(self._fh)
            self._fh.close()
            self._closed.append((self._seg_path, self._seg_bytes))
        path = _segment_path(self.dir, version)
        self._fh = fsutil.open_durable(path, "wb")
        self._fh.write(MAGIC)
        self._seg_path = path
        self._seg_bytes = len(MAGIC)
        self._rotated = True

    def commit(self) -> None:
        """Group commit: fsync appended records (and, after a rotation,
        the directory entry), then enforce retention. The unit of
        durability — a crash between commits loses at most the
        uncommitted tail, which the reader drops at scan."""
        with self._lock:
            self._commit_locked()

    def _commit_locked(self) -> None:
        if self._fh is not None and self._dirty:
            fsutil.fsync_file(self._fh)
            self._dirty = False
        if self._rotated:
            fsutil.fsync_dir(self.dir)
            self._rotated = False
        self._evict_locked()
        self._publish_gauges_locked()

    def _evict_locked(self) -> None:
        """Evict WHOLE closed segments, oldest first, until the archive
        fits ``retain_bytes``. The live segment is never evicted — the
        newest chain always survives retention."""
        total = self._seg_bytes + sum(b for _, b in self._closed)
        evicted = False
        # with no live segment open, the newest CLOSED segment is the
        # newest chain — retention never deletes the whole archive
        keep = 0 if self._fh is not None else 1
        while len(self._closed) > keep and total > self.retain_bytes:
            path, size = self._closed.pop(0)
            try:
                fsutil.remove(path)
            except OSError:  # pragma: no cover - already gone
                pass
            total -= size
            evicted = True
            self._m["evicted"].inc()
        if evicted:
            fsutil.fsync_dir(self.dir)

    def _publish_gauges_locked(self) -> None:
        self._m["archive_bytes"].set(
            self._seg_bytes + sum(b for _, b in self._closed))
        self._m["segments"].set(
            len(self._closed) + (1 if self._fh is not None else 0))

    def close(self) -> None:
        """Commit and close the live segment. A later ``record`` starts
        a fresh keyframe segment (same as a restart)."""
        with self._lock:
            self._commit_locked()
            if self._fh is not None:
                self._fh.close()
                self._closed.append((self._seg_path, self._seg_bytes))
                self._fh = None
                self._seg_path = None
                self._seg_bytes = 0

    # ---- subscription mode -------------------------------------------------

    def sync_once(self) -> str:
        """One poll+archive step against the configured upstream.
        Returns the sync kind ("none" | "delta" | "full" | "resync")."""
        if self._up is None:
            raise RuntimeError("ArchiveWriter has no upstream "
                               "(constructed for passive recording)")
        data = self._up.fetch(self._up.version)
        try:
            return self._apply(data)
        except DeltaGapError as e:
            return self._schedule_resync("gap", e)
        except DeltaError as e:
            return self._schedule_resync("crc", e)
        except (KeyError, ValueError, TypeError) as e:
            return self._schedule_resync("error", e)

    def _schedule_resync(self, reason: str, err: Exception) -> str:
        self._m["resyncs"].inc(reason=reason)
        log.warning("history subscription: %s (%s); full resync",
                    reason, err)
        self._up.state = None  # since=0 on the next poll -> full frame
        return "resync"

    def _apply(self, data: bytes) -> str:
        up = self._up
        kind = "none"
        for tree in decode_frames(data):
            t = tree["t"]
            if t == "none":
                self._m["lag"].set(
                    max(0, int(tree["to"]) - self.last_version))
                continue
            if t == "full":
                # a full frame is a bootstrap or post-resync snapshot:
                # chain continuity to the previous mirror is unknown,
                # so the archive anchors a fresh keyframe
                prev, up.state = None, tree["state"]
                if kind != "full":
                    kind = "full"
            elif t == "delta":
                if up.state is None:
                    raise DeltaGapError("delta frame with no local base")
                prev = up.state
                up.state = apply_delta(up.state, tree)
                if kind == "none":
                    kind = "delta"
            else:
                raise DeltaError(f"unknown frame kind {t!r}")
            self.record(prev, up.state)
            if self.store is not None:
                # the writer doubles as a serving mirror: the live head
                # answers /query/* with zero reconstruction, exactly
                # like a gateway replica (monotone publish — a refused
                # restart stays visible via history_refused_total)
                self.store.publish_snapshot(state_to_snapshot(up.state))
            self._m["lag"].set(0)
        if kind != "none":
            self.commit()
        return kind

    def start(self) -> "ArchiveWriter":
        self._thread = threading.Thread(
            target=self._run, name="history-archiver", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.close()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.sync_once()
            except OSError as e:
                # upstream down: the archive keeps its last durable
                # record; the gap stays visible as history_lag_versions
                self._m["poll_failures"].inc()
                log.debug("history poll failed: %s", e)
            self._stop.wait(self.poll)


class ArchiveReader:
    """Reconstruct archived versions: nearest keyframe <= target, then
    ``apply_delta`` forward. Scanning is incremental (a segment rescans
    only when its size/mtime changes) and damage-tolerant: a torn tail
    is dropped quietly (the normal crash/in-flight-append shape), a
    CRC/parse/chain failure drops the rest of the segment LOUDLY
    (``history_damage_skipped_total``) and reconstruction resumes at
    the next segment's keyframe."""

    # reconstructed states kept hot; sequential time-travel queries
    # (dashboards scrubbing) extend a cached chain instead of replaying
    # from the keyframe every time
    STATE_CACHE = 8

    def __init__(self, dir_: str):
        self.dir = dir_
        self._m = register_history_metrics()
        self._lock = threading.Lock()
        # path -> {"sig": (size, mtime_ns), "recs": [...]}
        self._segcache: dict = {}  # guarded by _lock
        self._states: dict = {}  # version -> state, LRU  # guarded by _lock
        self._state_order: list = []  # LRU order, oldest first  # guarded by _lock

    # ---- scanning ----------------------------------------------------------

    def _scan_locked(self) -> list:
        """[(path, recs)] across intact segment prefixes, in version
        order. ``recs`` entries: {t, v, from?, ts, wm, slots, off, len}
        with off/len locating the FGWD1 blob inside the file."""
        segs = []
        try:
            names = sorted(os.listdir(self.dir))
        except OSError:
            return segs
        seen = set()
        for name in names:
            if not _SEG_RE.search(name):
                continue
            path = os.path.join(self.dir, name)
            try:
                st = os.stat(path)
            except OSError:
                continue  # racing an eviction
            seen.add(path)
            sig = (st.st_size, st.st_mtime_ns)
            ent = self._segcache.get(path)
            if ent is None or ent["sig"] != sig:
                ent = {"sig": sig, "recs": self._scan_segment(path)}
                self._segcache[path] = ent
            if ent["recs"]:
                segs.append((path, ent["recs"]))
        for stale in set(self._segcache) - seen:
            del self._segcache[stale]
        return segs

    def _scan_segment(self, path: str) -> list:
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return []
        if not data.startswith(MAGIC):
            self._m["damage"].inc()
            log.warning("history segment %s: bad magic — skipped",
                        path)
            return []
        recs = []
        off = len(MAGIC)
        while off < len(data):
            head = data[off:off + _HEAD.size]
            if len(head) < _HEAD.size:
                log.debug("history %s: torn tail header at %d",
                          path, off)
                break
            body_len, crc = _HEAD.unpack(head)
            body = data[off + _HEAD.size:off + _HEAD.size + body_len]
            if len(body) < body_len:
                log.debug("history %s: torn tail body at %d",
                          path, off)
                break
            if zlib.crc32(body) != crc:
                self._damage(path, off, "record CRC mismatch")
                break
            nl = body.find(b"\n")
            if nl < 0:
                self._damage(path, off, "missing meta line")
                break
            try:
                meta = json.loads(body[:nl])
            except ValueError:
                self._damage(path, off, "unparseable meta line")
                break
            kind = meta.get("t")
            if not recs:
                if kind != "key":
                    self._damage(path, off, "segment does not open "
                                            "with a keyframe")
                    break
            elif kind != "dlt" or int(meta.get("from", -1)) != \
                    recs[-1]["v"]:
                # a mid-segment keyframe or a chain hole: deltas past
                # this point have no anchor — the rest is unusable
                self._damage(path, off, "delta chain hole")
                break
            recs.append({
                "t": kind, "v": int(meta["v"]), "ts": float(meta["ts"]),
                "wm": float(meta["wm"]), "slots": meta.get("slots", {}),
                "off": off + _HEAD.size + nl + 1,
                "len": body_len - nl - 1,
            })
            off += _HEAD.size + body_len
        return recs

    def _damage(self, path: str, off: int, why: str) -> None:
        self._m["damage"].inc()
        log.warning("history segment %s damaged at byte %d (%s) — "
                    "skipping to the next keyframe segment", path, off,
                    why)

    # ---- index queries -----------------------------------------------------

    def versions(self) -> list:
        """Every reconstructible version, ascending."""
        with self._lock:
            return [r["v"] for _, recs in self._scan_locked()
                    for r in recs]

    def nearest(self, version: int):
        """(nearest archived version <= target or None,
        nearest archived version > target or None)."""
        before = after = None
        for v in self.versions():
            if v <= version:
                before = v
            elif after is None:
                after = v
                break
        return before, after

    def version_at(self, ts: float):
        """Newest archived version created at or before ``ts`` (the
        ?at= resolution rule), or None when the archive starts later."""
        found = None
        with self._lock:
            for _, recs in self._scan_locked():
                for r in recs:
                    if r["ts"] <= ts:
                        found = r["v"]
                    else:
                        return found
        return found

    def slot_index(self) -> dict:
        """{table: {slot: newest archived version holding it}} — the
        gateway range-retention index, read from record metas alone."""
        out: dict = {}
        with self._lock:
            for _, recs in self._scan_locked():
                for r in recs:
                    for table, slots in r["slots"].items():
                        tbl = out.setdefault(table, {})
                        for slot in slots:
                            tbl[int(slot)] = r["v"]
        return out

    def stats(self) -> dict:
        with self._lock:
            segs = self._scan_locked()
            nbytes = 0
            for path, _ in segs:
                try:
                    nbytes += os.path.getsize(path)
                except OSError:
                    continue
            versions = [r["v"] for _, recs in segs for r in recs]
            return {
                "segments": len(segs),
                "bytes": nbytes,
                "versions": len(versions),
                "oldest": versions[0] if versions else None,
                "newest": versions[-1] if versions else None,
            }

    # ---- reconstruction ----------------------------------------------------

    def reconstruct(self, version: int) -> dict:
        """The canonical state dict at ``version``, rebuilt from the
        nearest keyframe. Raises :class:`HistoryGapError` when the
        version was never archived, was evicted, or sits behind
        damage."""
        t0 = time.perf_counter()
        with self._lock:
            state, depth = self._reconstruct_locked(int(version))
        self._m["reconstructs"].inc()
        self._m["reconstruct_seconds"].observe(time.perf_counter() - t0)
        self._m["reconstruct_depth"].observe(depth)
        return state

    def snapshot(self, version: int):
        """The reconstructed :class:`~..serve.snapshot.Snapshot` — just
        a Snapshot: the unchanged ServeServer handlers run over it."""
        return state_to_snapshot(self.reconstruct(version))

    def _reconstruct_locked(self, version: int):
        cached = self._states.get(version)
        if cached is not None:
            self._touch_locked(version)
            return cached, 0
        segs = self._scan_locked()
        target = None
        for path, recs in segs:
            if recs[0]["v"] <= version <= recs[-1]["v"]:
                idx = next((i for i, r in enumerate(recs)
                            if r["v"] == version), None)
                if idx is not None:
                    target = (path, recs, idx)
                break
        if target is None:
            raise HistoryGapError(version,
                                  *self._nearest_from(segs, version))
        path, recs, idx = target
        # start from the newest cached state on this chain, else the
        # keyframe; every blob decode re-validates the inner FGWD1 CRC
        start = 0
        state = None
        for i in range(idx, 0, -1):
            hit = self._states.get(recs[i]["v"])
            if hit is not None:
                if recs[i]["v"] == version:
                    self._touch_locked(version)
                    return hit, 0
                start, state = i + 1, hit
                break
        try:
            with open(path, "rb") as f:
                depth = 0
                for i in range(start, idx + 1):
                    rec = recs[i]
                    f.seek(rec["off"])
                    blob = f.read(rec["len"])
                    tree = next(decode_frames(blob))
                    if rec["t"] == "key":
                        state = tree["state"]
                    else:
                        state = apply_delta(state, tree)
                        depth += 1
        except (OSError, DeltaError, StopIteration) as e:
            # the file changed under us (eviction mid-read) or a blob
            # failed its inner CRC despite a clean scan: invalidate the
            # segment and answer a gap — NEVER a damaged snapshot
            self._segcache.pop(path, None)
            if not isinstance(e, OSError):
                self._damage(path, recs[start]["off"], f"blob decode "
                             f"failed mid-reconstruction ({e})")
            fresh = self._scan_locked()
            raise HistoryGapError(
                version, *self._nearest_from(fresh, version)) from e
        self._cache_locked(version, state)
        return state, depth

    @staticmethod
    def _nearest_from(segs, version: int):
        before = after = None
        for _, recs in segs:
            for r in recs:
                if r["v"] <= version:
                    before = r["v"]
                elif after is None:
                    after = r["v"]
                    return before, after
        return before, after

    def _cache_locked(self, version: int, state: dict) -> None:
        if version not in self._states:
            self._state_order.append(version)
        self._states[version] = state
        while len(self._state_order) > self.STATE_CACHE:
            evict = self._state_order.pop(0)
            self._states.pop(evict, None)

    def _touch_locked(self, version: int) -> None:
        try:
            self._state_order.remove(version)
        except ValueError:
            pass
        self._state_order.append(version)
