"""The history tier's read surface: time-travel queries over the archive.

Counterpart of flow_pipeline_tpu/history/server.py; its bodies are
byte-equal to the reference's for equal archives.

    GET /query/topk?at=<unix ts>     top-K as of a wall-clock instant
    GET /query/estimate?version=<v>  per-key estimate at an exact version
    GET /query/range?from=&to=       closed windows, INCLUDING slots
                                     older than the upstream RANGE_SLOTS
                                     (filled from the archive)
    GET /history/index               what the archive holds

A :class:`HistoryServer` is a :class:`~..serve.server.ServeServer`
whose store mirrors the live head (the archive subscription publishes
into it) plus one extra trick: a query carrying ``at=`` or
``version=`` reconstructs that version from the archive and runs the
UNCHANGED handler over it — a reconstructed Snapshot is just a
Snapshot, so the answer is byte-identical to what the live path served
at that version (the record-and-replay parity suite pins this).

Honesty at the edges: a version that was evicted or sits behind
damaged segments answers 404 with the nearest archived versions as
hints (``nearest_before``/``nearest_after``) — never a guess, never a
damaged snapshot. ``at=`` resolves to the newest version created at or
before the instant; an ``at=`` predating the whole archive is the same
honest 404.
"""

from __future__ import annotations

# It inherits the ServeServer transport; the only mutable state added is
# the time-travel response cache, guarded by _hist_lock. Rebuilt snapshots
# are immutable; the reader serializes its own access.

import json
import logging
import threading
import time
import zlib
from urllib.parse import parse_qs, urlparse

from ..serve.server import CACHE_ENTRIES, ServeServer, _http_response
from ..serve.snapshot import SnapshotStore
from ..sink.base import rows_to_records
from .archive import (ArchiveReader, HistoryGapError,
                      register_history_metrics)

log = logging.getLogger("flow_pipeline_tpu_torch.history")


class HistoryServer(ServeServer):
    """ServeServer + the archive time-travel surface."""

    def __init__(self, reader: ArchiveReader, store=None,
                 port: int = 8085, host: str = "127.0.0.1",
                 max_inflight: int = 0, deadline: float = 0.1,
                 feed_bytes: int = 0):
        super().__init__(store if store is not None else SnapshotStore(),
                         port=port, host=host, max_inflight=max_inflight,
                         deadline=deadline, feed_bytes=feed_bytes)
        self.reader = reader
        self._hm = register_history_metrics()
        # (version, endpoint, normalized query) -> (etag, body):
        # archived versions are immutable, so entries never go stale —
        # the dict is bounded like the live cache
        self._hist_lock = threading.Lock()
        self._hist_cache: dict = {}  # guarded by _hist_lock

    # ---- dispatch ----------------------------------------------------------

    def _respond_inner(self, target: str, inm: str | None) -> bytes:
        url = urlparse(target)
        if url.path == "/history/index":
            return self._index()
        q = {k: v[0] for k, v in parse_qs(url.query).items()}
        if url.path.startswith("/query/") and \
                ("at" in q or "version" in q):
            return self._respond_history(url.path, q, inm)
        if url.path == "/query/range":
            return self._respond_range(q, inm)
        return super()._respond_inner(target, inm)

    def _index(self) -> bytes:
        stats = self.reader.stats()
        snap = self.store.current
        stats["live_version"] = snap.version if snap else 0
        stats["slots"] = {table: sorted(slots)
                          for table, slots in
                          self.reader.slot_index().items()}
        return _http_response(200, json.dumps(stats).encode())

    # ---- time travel (?at= / ?version=) ------------------------------------

    def _resolve_version(self, q: dict) -> int:
        if "version" in q:
            return int(q["version"])
        at = float(q["at"])
        version = self.reader.version_at(at)
        if version is None:
            _, after = self.reader.nearest(-1)
            raise HistoryGapError(0, None, after)
        return version

    def _gap_response(self, e: HistoryGapError) -> bytes:
        self._hm["gap_answers"].inc()
        return _http_response(404, json.dumps({
            "error": str(e),
            "nearest_before": e.before,
            "nearest_after": e.after,
        }).encode())

    def _respond_history(self, endpoint: str, q: dict,
                         inm: str | None) -> bytes:
        t0 = time.perf_counter()
        try:
            try:
                version = self._resolve_version(q)
            except HistoryGapError as e:
                return self._gap_response(e)
            handler = self._handler_for(endpoint)
            if handler is None:
                return _http_response(404, json.dumps(
                    {"error": f"unknown path {endpoint}"}).encode())
            # at=/version= is consumed HERE: the handler sees exactly
            # the query the live path saw, so the body it builds is
            # byte-identical to the live answer at that version
            qq = {k: v for k, v in q.items()
                  if k not in ("at", "version")}
            key = (version, endpoint, tuple(sorted(qq.items())))
            with self._hist_lock:
                ent = self._hist_cache.get(key)
            if ent is None:
                try:
                    snap = self.reader.snapshot(version)
                except HistoryGapError as e:
                    return self._gap_response(e)
                body = json.dumps(handler(snap, qq),
                                  default=str).encode()
                etag = (f'"hist-v{version}-'
                        f'{zlib.crc32(repr(key).encode()):08x}"')
                ent = (etag, body)
                with self._hist_lock:
                    if len(self._hist_cache) < CACHE_ENTRIES:
                        self._hist_cache[key] = ent
            etag, body = ent
            if inm is not None and inm == etag:
                return _http_response(304, b"", etag)
            return _http_response(200, body, etag)
        except (KeyError, ValueError) as e:
            return _http_response(400, json.dumps(
                {"error": str(e)}).encode())
        except Exception:  # noqa: BLE001 -- a handler bug must surface as a COUNTABLE 500, not a dropped connection
            log.exception("history handler failed for %s", endpoint)
            return _http_response(500, json.dumps(
                {"error": "internal serving error"}).encode())
        finally:
            self.store.observe_query(endpoint,
                                     time.perf_counter() - t0,
                                     self.store.current)

    # ---- deep range (live slots + archived slots) --------------------------

    def _respond_range(self, q: dict, inm: str | None) -> bytes:
        """/query/range without at=: the live answer, EXTENDED with
        archived slots older than what the serving snapshot still
        holds. The archived rows are the exact rows the live path
        served when those slots were current — the range-retention
        parity test pins the bytes."""
        t0 = time.perf_counter()
        endpoint = "/query/range"
        try:
            snap = self.store.current
            body = self._deep_range(snap, q)
            payload = json.dumps(body, default=str).encode()
            etag = f'"histr-{zlib.crc32(payload):08x}"'
            if inm is not None and inm == etag:
                return _http_response(304, b"", etag)
            return _http_response(200, payload, etag)
        except (KeyError, ValueError) as e:
            return _http_response(400, json.dumps(
                {"error": str(e)}).encode())
        except Exception:  # noqa: BLE001 -- same countable-500 contract as the live path
            log.exception("history range failed")
            return _http_response(500, json.dumps(
                {"error": "internal serving error"}).encode())
        finally:
            self.store.observe_query(endpoint,
                                     time.perf_counter() - t0,
                                     self.store.current)

    def _deep_range(self, snap, q: dict) -> dict:
        index = self.reader.slot_index()
        if snap is not None:
            body = self._range(snap, q)
        else:
            # archive-only serving (no live head yet): same body shape,
            # built purely from archived slots
            name = q.get("model") or next(iter(sorted(index)), None)
            if name is None:
                raise KeyError("no exact-window table in the served "
                               "snapshot or the archive")
            body = {"model": name, "version": 0, "watermark": 0.0,
                    "from": int(q.get("from", 0)),
                    "to": int(q["to"]) if "to" in q else None,
                    "slots": [], "rows": []}
        table = index.get(body["model"], {})
        lo, hi = body["from"], body["to"]
        live = set(body["slots"])
        want = sorted(s for s in table
                      if s >= lo and (hi is None or s < hi)
                      and s not in live)
        arch_slots, arch_rows = [], []
        for slot in want:
            try:
                state = self.reader.reconstruct(table[slot])
            except HistoryGapError:
                continue  # evicted between index and read: honest miss
            rows = next((r for s, r in state["ranges"].get(
                body["model"], []) if int(s) == slot), None)
            if rows is None:  # pragma: no cover - index/blob skew
                continue
            arch_slots.append(slot)
            arch_rows.extend(rows_to_records(rows))
        # archived slots are strictly older than the live window: they
        # prepend, keeping the slot order ascending end to end
        body["slots"] = arch_slots + list(body["slots"])
        body["rows"] = arch_rows + list(body["rows"])
        body["archived_slots"] = arch_slots
        return body
