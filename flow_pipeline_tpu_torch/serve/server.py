"""The serving tier's read endpoint: lock-free queries over the
published snapshot.

Counterpart of flow_pipeline_tpu/serve/server.py:

    GET /query/version              snapshot identity and freshness
    GET /query/topk?model=&k=       ranked top-K rows (a column slice)
    GET /query/estimate?model=&key= per-key uint64 CMS estimate
    GET /query/spread?model=&key=   per-key register-decoded distinct
                                    count (spread families; without
                                    key=, the ranked-by-spread rows)
    GET /query/range?model=&from=&to=  closed exact-window rows by slot
    GET /query/audit?model=         the newest sketch-audit reports
    GET /sub/snapshot?since=V       subscription frames (gateway/feed.py)
    GET /healthz                    liveness

Every handler loads the snapshot pointer ONCE and computes from that
immutable host object: no worker lock, no card access. Responses carry
the snapshot ``version`` and an ``ETag``; a repeated query hits the
``(version, normalized query)`` cache and an ``If-None-Match``
revalidation costs a 304 with no body. The JSON bodies are the
reference's, byte for byte, for equal snapshots.

The transport is a minimal threaded HTTP/1.1 loop (one thread per
keep-alive connection) instead of ``BaseHTTPRequestHandler``, whose
header parsing costs about half a millisecond per request: a cached
query costs one request-line parse, one dict lookup and one ``sendall``
of a pre-assembled buffer (Nagle off). Only ``If-None-Match`` and
``Connection: close`` are read from the headers.
"""

from __future__ import annotations

# Handlers run on one thread per connection; the only shared mutable
# state is the response cache, guarded by _cache_lock. The snapshot
# itself is immutable: readers hold no lock over it by design.

import json
import logging
import socket
import socketserver
import threading
import time
import zlib
from urllib.parse import parse_qs, urlparse

from ..obs.families import register_guard_metrics
from ..sink.base import rows_to_records
from .snapshot import Snapshot, SnapshotStore

log = logging.getLogger("flow_pipeline_tpu_torch.serve")

# Response-cache entry bound per snapshot version: distinct normalized
# queries are few (dashboards repeat), but k=/from=/to= are
# client-controlled, so the map must not grow unbounded.
CACHE_ENTRIES = 1024

_REASONS = {200: "OK", 304: "Not Modified", 400: "Bad Request",
            404: "Not Found", 503: "Service Unavailable",
            501: "Not Implemented"}


def _http_response(code: int, body: bytes = b"",
                   etag: str | None = None,
                   ctype: str = "application/json",
                   extra: list | None = None) -> bytes:
    """One fully assembled HTTP/1.1 response (single sendall)."""
    head = [f"HTTP/1.1 {code} {_REASONS.get(code, 'OK')}",
            f"Content-Type: {ctype}",
            f"Content-Length: {len(body)}"]
    if etag:
        head.append(f"ETag: {etag}")
    if extra:
        head.extend(extra)
    return ("\r\n".join(head) + "\r\n\r\n").encode() + body


class _ServeHandler(socketserver.BaseRequestHandler):
    """Keep-alive GET loop. ``self.server.outer`` is the ServeServer."""

    def handle(self):  # noqa: C901 -- the whole point is one flat hot loop
        outer = self.server.outer
        sock = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(60.0)
        with outer._conns_lock:
            if outer._stopping:
                return  # raced a stop(): don't serve from a dead replica
            outer._conns.add(sock)
        rfile = sock.makefile("rb", buffering=65536)
        try:
            while True:
                line = rfile.readline(65537)
                if not line or line in (b"\r\n", b"\n"):
                    return  # closed (or stray blank line: give up)
                parts = line.split()
                if len(parts) < 2:
                    sock.sendall(_http_response(400))
                    return
                method, target = parts[0], parts[1].decode(
                    "latin-1", "replace")
                # headers: skip byte-wise; only If-None-Match matters
                inm = None
                close = False
                while True:
                    h = rfile.readline(65537)
                    if not h or h in (b"\r\n", b"\n"):
                        break
                    lo = h[:17].lower()
                    if lo.startswith(b"if-none-match:"):
                        inm = h.split(b":", 1)[1].strip().decode(
                            "latin-1", "replace")
                    elif lo.startswith(b"connection:") and \
                            b"close" in h.lower():
                        close = True
                if method != b"GET":
                    sock.sendall(_http_response(501))
                    return
                sock.sendall(outer._respond(target, inm))
                if close:
                    return
        except OSError:
            return  # client went away mid-request; nothing to salvage
        finally:
            with outer._conns_lock:
                outer._conns.discard(sock)
            try:
                rfile.close()
            except OSError:
                pass


class _Server(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True


class ServeServer:
    """Background serving-tier HTTP server. Port 0 picks a free port.

    Read-side admission (``max_inflight`` > 0, ``-guard.serve_queue``):
    at most ``max_inflight`` requests compute concurrently; a request
    that cannot be admitted within ``deadline`` seconds is REJECTED with
    503 + ``Retry-After: 1`` and counted in ``guard_shed_total`` instead
    of queueing unboundedly. ``/healthz`` bypasses admission: liveness
    must stay observable under the overload that saturates the query
    paths.
    """

    def __init__(self, store: SnapshotStore, port: int = 8083,
                 host: str = "127.0.0.1", max_inflight: int = 0,
                 deadline: float = 0.1, feed_bytes: int = 0):
        self.store = store
        if deadline < 0:
            raise ValueError(
                f"serve admission deadline must be >= 0, got {deadline}")
        self.deadline = deadline
        if feed_bytes < 0:
            raise ValueError(
                f"serve feed byte budget must be >= 0, got {feed_bytes}")
        # -serve.feed_bytes: the subscription feed's delta-chain byte
        # budget (0 = the library default, gateway/feed.py)
        self.feed_bytes = feed_bytes
        self._sem = (threading.BoundedSemaphore(max_inflight)
                     if max_inflight > 0 else None)
        self.m_shed = register_guard_metrics()["shed"]
        # the guard controller, when one runs in this process
        # (set_guard): /healthz reports its ladder level
        self.guard = None
        self._cache_lock = threading.Lock()
        self._cache_version = -1  # guarded by _cache_lock
        self._cache: dict = {}  # guarded by _cache_lock
        # raw-target alias onto _cache entries: a repeated query skips
        # urlparse/parse_qs entirely (same version discipline; distinct
        # spellings of one normalized query just spend alias slots)
        self._alias: dict = {}  # guarded by _cache_lock
        # the subscription feed (gateway/feed.py): built lazily on the
        # first /sub/snapshot poll, so a plain serve deployment never
        # allocates it. Lock-free lazy init is fine: feeds over one
        # store are interchangeable (worst case two subscribers race
        # one redundant construction).
        self._feed = None
        # live keep-alive connections: stop() must actually sever them
        # (a "stopped" server whose established connections keep
        # answering serves an ever-staler snapshot)
        self._conns_lock = threading.Lock()
        self._conns: set = set()  # guarded by _conns_lock
        self._stopping = False  # guarded by _conns_lock
        self._server = _Server((host, port), _ServeHandler)
        self._server.outer = self
        self.host = host
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="serve-http",
            daemon=True)

    def set_guard(self, controller) -> "ServeServer":
        """Attach the in-process guard controller: /healthz starts
        reporting ``degraded`` + ``guard_level`` so health checks can
        tell a degraded replica from a dead one. Call once at wiring,
        before traffic."""
        self.guard = controller
        return self

    # ---- request dispatch --------------------------------------------------

    def _respond(self, target: str, inm: str | None) -> bytes:
        """One request -> one fully assembled response buffer, counted
        by status code (the buffer always opens "HTTP/1.1 NNN", so the
        code is bytes [9:12]: one slice, no re-parse)."""
        if self._sem is not None and not target.startswith("/healthz"):
            if not self._sem.acquire(timeout=self.deadline):
                # bounded accept queue: past the deadline the request
                # is shed LOUDLY — counted, attributed, retryable
                self.m_shed.inc(stage="serve", reason="queue_full")
                resp = _http_response(
                    503, b'{"error": "overloaded, retry"}',
                    extra=["Retry-After: 1"])
                self.store.m_responses.inc(code="503")
                return resp
            try:
                resp = self._respond_inner(target, inm)
            finally:
                self._sem.release()
        else:
            resp = self._respond_inner(target, inm)
        self.store.m_responses.inc(code=resp[9:12].decode("ascii"))
        return resp

    def _respond_inner(self, target: str, inm: str | None) -> bytes:
        t0 = time.perf_counter()
        snap = self.store.current  # ONE pointer load per request
        if snap is not None:
            # hot path: a repeated query is one dict lookup
            with self._cache_lock:
                ent = self._alias.get(target) \
                    if self._cache_version == snap.version else None
            if ent is not None:
                etag, body = ent
                self.store.m_cache_hits.inc()
                endpoint = target.split("?", 1)[0]
                resp = _http_response(304, b"", etag) \
                    if inm is not None and inm == etag \
                    else _http_response(200, body, etag)
                self.store.observe_query(
                    endpoint, time.perf_counter() - t0, snap)
                return resp
        url = urlparse(target)
        endpoint = url.path
        try:
            if endpoint == "/healthz":
                health = {"ok": True,
                          "version": snap.version if snap else 0,
                          "degraded": False}
                if self.guard is not None and self.guard.level >= 1:
                    # degraded, NOT dead: the ring client deprioritizes
                    # this replica but keeps it as a last resort
                    health["degraded"] = True
                    health["guard_level"] = self.guard.level
                return _http_response(200, json.dumps(health).encode())
            if endpoint == "/sub/snapshot":
                # subscription poll: binary frames, never the JSON cache
                # (since= changes every poll; the feed memoizes per
                # version on its own)
                return self._sub_snapshot(url, inm)
            handler = self._handler_for(endpoint)
            if handler is None:
                return _http_response(404, json.dumps(
                    {"error": f"unknown path {endpoint}"}).encode())
            if snap is None:
                return _http_response(503, json.dumps(
                    {"error": "no snapshot published yet"}).encode())
            q = {k: v[0] for k, v in parse_qs(url.query).items()}
            if endpoint == "/query/version":
                # not cached: `age` is live by definition
                return _http_response(200, json.dumps(
                    handler(snap, q), default=str).encode())
            key = (endpoint, tuple(sorted(q.items())))
            etag, body = self._cached(snap, key,
                                      lambda: handler(snap, q),
                                      target)
            if inm is not None and inm == etag:
                return _http_response(304, b"", etag)
            return _http_response(200, body, etag)
        except (KeyError, ValueError) as e:
            return _http_response(400, json.dumps(
                {"error": str(e)}).encode())
        except Exception:  # noqa: BLE001 -- a handler bug surfaces as a counted 500, not a dropped connection
            log.exception("serve handler failed for %s", target)
            return _http_response(500, json.dumps(
                {"error": "internal serving error"}).encode())
        finally:
            self.store.observe_query(
                endpoint, time.perf_counter() - t0, snap)

    def _handler_for(self, endpoint: str):
        return {
            "/query/version": self._version,
            "/query/topk": self._topk,
            "/query/estimate": self._estimate,
            "/query/spread": self._spread,
            "/query/range": self._range,
            "/query/audit": self._audit,
        }.get(endpoint)

    # ---- subscription feed ---------------------------------------------------

    def _sub_snapshot(self, url, inm: str | None) -> bytes:
        if self._feed is None:
            from ..gateway.feed import SnapshotFeed

            self._feed = SnapshotFeed(self.store) if not self.feed_bytes \
                else SnapshotFeed(self.store,
                                  history_bytes=self.feed_bytes)
        q = {k: v[0] for k, v in parse_qs(url.query).items()}
        kind, cur, frames = self._feed.frame_since(
            int(q.get("since", 0)))
        # ETag-conditional polls: a subscriber that is already current
        # sends If-None-Match with the version it holds; when the feed
        # is still at that version ("none") the poll costs headers, not
        # a body. The etag encodes the CURRENT feed version, so it only
        # ever matches a poll whose since == cur: a delta or full ship
        # is never masked.
        etag = f'"sub-v{cur}"'
        if kind == "none" and inm is not None and inm == etag:
            return _http_response(304, b"", etag)
        return _http_response(200, frames, etag,
                              ctype="application/octet-stream")

    def warm(self, targets) -> int:
        """Pre-render responses for ``targets`` into the (version, query)
        cache against the CURRENT snapshot: a gateway calls this the
        moment a mirrored snapshot lands, so the hot query set is a dict
        lookup before any reader asks. Returns how many targets rendered
        (unknown paths and handler errors are skipped: warming is an
        optimization, never a failure source)."""
        snap = self.store.current
        if snap is None:
            return 0
        n = 0
        for target in targets:
            url = urlparse(target)
            handler = self._handler_for(url.path)
            if handler is None or url.path == "/query/version":
                continue  # version is live by definition: not cached
            try:
                q = {k: v[0] for k, v in parse_qs(url.query).items()}
                key = (url.path, tuple(sorted(q.items())))
                self._cached(snap, key, lambda: handler(snap, q), target)
                n += 1
            except Exception:  # noqa: BLE001 -- a bad warm target must not take down the mirror thread
                log.debug("serve warm failed for %s", target,
                          exc_info=True)
        return n

    def invalidate_cache(self) -> None:
        """Drop every cached response. A gateway adopting an upstream
        restart needs this: the adopted stream's version counter
        restarts, so a new version can collide with an old cached entry
        that version equality alone cannot tell apart."""
        with self._cache_lock:
            self._cache = {}
            self._alias = {}
            self._cache_version = -1

    # ---- response cache ----------------------------------------------------

    def _cached(self, snap: Snapshot, key, build, target: str):
        """(etag, body) for one normalized query against one snapshot
        version. The cache holds exactly one version's entries — a
        pointer swap invalidates it wholesale (the next request under
        the new version replaces the dicts)."""
        with self._cache_lock:
            if self._cache_version != snap.version:
                self._cache = {}
                self._alias = {}
                self._cache_version = snap.version
            ent = self._cache.get(key)
        if ent is not None:
            self.store.m_cache_hits.inc()
            return ent
        body = json.dumps(build(), default=str).encode()
        etag = f'"v{snap.version}-{zlib.crc32(repr(key).encode()):08x}"'
        ent = (etag, body)
        with self._cache_lock:
            if self._cache_version == snap.version and \
                    len(self._cache) < CACHE_ENTRIES:
                self._cache[key] = ent
                if len(self._alias) < CACHE_ENTRIES:
                    self._alias[target] = ent
        return ent

    # ---- endpoints (pure functions of one immutable snapshot) --------------

    @staticmethod
    def _version(snap: Snapshot, q) -> dict:
        return {
            "version": snap.version,
            "created": snap.created,
            "age_seconds": round(snap.age(), 3),
            "watermark": snap.watermark,
            "flows_seen": snap.flows_seen,
            "source": snap.source,
            "models": {name: {"kind": f.kind,
                              "window_start": f.window_start,
                              "depth": f.depth}
                       for name, f in snap.families.items()},
            "ranges": {table: [slot for slot, _ in slots]
                       for table, slots in snap.ranges.items()},
        }

    @staticmethod
    def _pick_family(snap: Snapshot, q):
        name = q.get("model")
        if name:
            fam = snap.families.get(name)
            if fam is None:
                raise KeyError(f"no served model named {name!r}")
            return fam
        for fam in snap.families.values():
            return fam  # publisher preserves the worker's model order
        raise KeyError("no top-K family in the served snapshot")

    def _topk(self, snap: Snapshot, q) -> dict:
        fam = self._pick_family(snap, q)
        k = int(q.get("k", 10))
        if k < 0:
            # a negative k would slice rows off the END of the ranking
            raise ValueError(f"k must be >= 0, got {k}")
        k = min(k, fam.depth)
        # the stored rows ARE the ranked extraction: k rows = column
        # prefix (exact — the table is ranked before it is stored)
        rows = {name: col[:k] for name, col in fam.rows.items()}
        return {
            "model": fam.name,
            "version": snap.version,
            "watermark": snap.watermark,
            "window_start": fam.window_start,
            "k": k,
            "rows": rows_to_records(rows),
        }

    def _estimate(self, snap: Snapshot, q) -> dict:
        import numpy as np

        from ..hostsketch.engine import np_cms_query_u64

        fam = self._pick_family(snap, q)
        if fam.kind == "spread":
            raise ValueError(
                f"model {fam.name!r} is spread-backed (distinct counts, "
                "not volumes): use /query/spread")
        if fam.cms is None:
            raise ValueError(
                f"model {fam.name!r} is {fam.kind}-backed (exact): it has "
                "no CMS to estimate from — use /query/topk")
        if "key" not in q:
            raise KeyError("key= is required (comma-separated uint32 "
                           f"lanes, {fam.key_lanes} for this model)")
        lanes = [int(x) for x in q["key"].split(",")]
        if len(lanes) != fam.key_lanes:
            raise ValueError(
                f"key must carry {fam.key_lanes} uint32 lanes for model "
                f"{fam.name!r}, got {len(lanes)}")
        if not all(0 <= x < 2**32 for x in lanes):
            # out-of-range lanes would raise OverflowError inside numpy
            # — which is not in the 400 net and would abort the
            # keep-alive connection instead of answering
            raise ValueError("key lanes must be uint32 (0 <= lane < "
                             "2^32)")
        keys = np.asarray([lanes], dtype=np.uint32)
        est = np_cms_query_u64(fam.cms.get(), keys)[0]
        names = list(fam.value_cols) + ["count"]
        return {
            "model": fam.name,
            "version": snap.version,
            "window_start": fam.window_start,
            "key": lanes,
            "estimates": {n: int(est[j]) for j, n in enumerate(names)},
        }

    def _spread(self, snap: Snapshot, q) -> dict:
        """The spread read surface. With ``key=``: the per-key
        register-decoded distinct-count estimate (hostsketch/engine.py
        ``np_spread_query`` over the snapshot's frozen u8 planes, the
        reference's decode). Without: the ranked-by-spread top rows,
        like /query/topk but scoped to spread families."""
        import numpy as np

        from ..hostsketch.engine import np_spread_query

        name = q.get("model")
        if name:
            fam = snap.families.get(name)
            if fam is None:
                raise KeyError(f"no served model named {name!r}")
        else:
            fam = next((f for f in snap.families.values()
                        if f.kind == "spread"), None)
            if fam is None:
                raise KeyError("no spread family in the served snapshot")
        if fam.kind != "spread" or fam.regs is None:
            raise ValueError(
                f"model {fam.name!r} is {fam.kind}-backed: it has no "
                "spread registers — use /query/topk or /query/estimate")
        if "key" in q:
            lanes = [int(x) for x in q["key"].split(",")]
            if len(lanes) != fam.key_lanes:
                raise ValueError(
                    f"key must carry {fam.key_lanes} uint32 lanes for "
                    f"model {fam.name!r}, got {len(lanes)}")
            if not all(0 <= x < 2**32 for x in lanes):
                raise ValueError("key lanes must be uint32 (0 <= lane < "
                                 "2^32)")
            keys = np.asarray([lanes], dtype=np.uint32)
            return {
                "model": fam.name,
                "version": snap.version,
                "window_start": fam.window_start,
                "key": lanes,
                "spread": float(np_spread_query(fam.regs, keys)[0]),
            }
        k = int(q.get("k", 10))
        if k < 0:
            raise ValueError(f"k must be >= 0, got {k}")
        k = min(k, fam.depth)
        rows = {name: col[:k] for name, col in fam.rows.items()}
        return {
            "model": fam.name,
            "version": snap.version,
            "watermark": snap.watermark,
            "window_start": fam.window_start,
            "k": k,
            "rows": rows_to_records(rows),
        }

    @staticmethod
    def _audit(snap: Snapshot, q) -> dict:
        """The newest per-family sketch-audit reports the snapshot
        carries. Empty models = audit off or nothing closed yet: an
        answer, not an error."""
        name = q.get("model")
        if name:
            report = snap.audit.get(name)
            if report is None:
                raise KeyError(f"no audit report for model {name!r}")
            models = {name: report}
        else:
            models = dict(snap.audit)
        return {
            "version": snap.version,
            "source": snap.source,
            "watermark": snap.watermark,
            "models": models,
        }

    @staticmethod
    def _range(snap: Snapshot, q) -> dict:
        name = q.get("model")
        if name:
            slots = snap.ranges.get(name)
            if slots is None:
                raise KeyError(f"no served range table named {name!r}")
        else:
            name = next(iter(snap.ranges), None)
            if name is None:
                raise KeyError("no exact-window table in the served "
                               "snapshot")
            slots = snap.ranges[name]
        lo = int(q.get("from", 0))
        hi = int(q["to"]) if "to" in q else None
        out_slots, records = [], []
        for slot, rows in slots:
            if slot < lo or (hi is not None and slot >= hi):
                continue
            out_slots.append(slot)
            records.extend(rows_to_records(rows))
        return {
            "model": name,
            "version": snap.version,
            "watermark": snap.watermark,
            "from": lo,
            "to": hi,
            "slots": out_slots,
            "rows": records,
        }

    # ---- lifecycle ---------------------------------------------------------

    def start(self) -> "ServeServer":
        self._thread.start()
        log.info("serving tier on http://%s:%d/query", self.host, self.port)
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        with self._conns_lock:
            self._stopping = True
            conns = list(self._conns)
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass  # already gone
            try:
                sock.close()
            except OSError:
                pass
