"""The gateway's consistent-hash ring and failover query client.

Counterpart of flow_pipeline_tpu/gateway/ring.py (stdlib only). K
stateless gateway replicas each hold the same immutable mirrored
snapshot, so ANY replica can answer ANY query — the ring is a cache-
affinity and load-spreading device, not a correctness one: routing a
repeated query to the same replica keeps hitting that replica's
``(version, query)`` response cache, and killing a replica moves only
its arc onto the survivors (the classic consistent-hashing property;
a modulo ring would remap almost every key).

:class:`GatewayClient` is the client half of the replication story:
route by query key, and on a transport failure mark the replica dead
for a cooldown and retry the SAME query on the next live arc — which is
what makes a replica kill invisible (zero 5xx: a dead socket is retried
elsewhere, never surfaced)."""

from __future__ import annotations

# HashRing is immutable after construction; GatewayClient state is
# guarded by its _lock (tests drive it from N reader threads). Every query
# carries an explicit timeout: a wedged replica costs the client one
# bounded request, not a hang.

import bisect
import http.client
import threading
import time
import zlib

# Virtual nodes per replica: enough that 2-4 replica rings split load
# evenly (the estate's deployment size), cheap to build.
VNODES = 64


def _point(s: str) -> int:
    # crc32: stable across processes and Python builds (hash() is
    # per-process salted — two clients would disagree on the ring)
    return zlib.crc32(s.encode("utf-8", "surrogatepass"))


class HashRing:
    """Immutable consistent-hash ring over node name strings."""

    def __init__(self, nodes, vnodes: int = VNODES):
        self.nodes = tuple(dict.fromkeys(nodes))  # order-stable dedupe
        pts = sorted((_point(f"{n}#{i}"), n)
                     for n in self.nodes for i in range(vnodes))
        self._keys = [p for p, _ in pts]
        self._owners = [n for _, n in pts]

    def node_for(self, key: str, skip=()) -> str | None:
        """The first live node clockwise from the key's point.
        ``skip`` masks dead nodes — their arcs fall to the successors,
        which is exactly the replica-kill remap."""
        if not self._keys:
            return None
        i = bisect.bisect(self._keys, _point(key)) % len(self._keys)
        for step in range(len(self._keys)):
            n = self._owners[(i + step) % len(self._keys)]
            if n not in skip:
                return n
        return None


class GatewayClient:
    """Keep-alive query client over a gateway replica set."""

    def __init__(self, addrs, timeout: float = 10.0,
                 dead_for: float = 1.0, vnodes: int = VNODES,
                 monotone_wait: float = 0.5):
        self.ring = HashRing([a if isinstance(a, str) else f"{a[0]}:{a[1]}"
                              for a in addrs], vnodes=vnodes)
        self.timeout = timeout
        self.dead_for = dead_for
        self.monotone_wait = monotone_wait
        self._lock = threading.Lock()
        self._dead: dict[str, float] = {}  # node -> retry-at  # guarded by _lock
        # replicas that answered 503 + Retry-After (the guard's serve
        # admission) are DEGRADED, not dead — deprioritized until the advertised
        # retry time but still eligible as a last resort (an
        # overloaded replica can answer; a dead one cannot)
        self._degraded: dict[str, float] = {}  # node -> retry-at  # guarded by _lock
        self.retries = 0  # transport failovers taken  # guarded by _lock
        self.deprioritized = 0  # 503-driven reroutes taken  # guarded by _lock
        # session watermark for monotone reads: the highest snapshot
        # version any response carried. A failover target slightly
        # behind it is re-polled briefly (it mirrors the same upstream
        # and catches up within its poll cadence) instead of handing
        # the session a version that runs backwards.
        self.watermark = 0  # guarded by _lock
        self.stale_reads = 0  # monotone waits that timed out  # guarded by _lock
        self._tls = threading.local()

    def _skip(self) -> set:
        now = time.monotonic()
        with self._lock:
            for n, until in list(self._dead.items()):
                if until <= now:
                    del self._dead[n]
            return set(self._dead)

    def _mark_dead(self, node: str) -> None:
        with self._lock:
            self._dead[node] = time.monotonic() + self.dead_for
            self.retries += 1

    def _slow(self) -> set:
        now = time.monotonic()
        with self._lock:
            for n, until in list(self._degraded.items()):
                if until <= now:
                    del self._degraded[n]
            return set(self._degraded)

    def _mark_degraded(self, node: str, retry_after: float) -> None:
        with self._lock:
            self._degraded[node] = time.monotonic() + max(
                0.05, min(retry_after, 30.0))
            self.deprioritized += 1

    def _conn_for(self, node: str):
        # one connection per (thread, node): http.client connections are
        # not thread-safe, and the closed-loop client model is
        # one-request-at-a-time per thread anyway
        conns = getattr(self._tls, "conns", None)
        if conns is None:
            conns = self._tls.conns = {}
        conn = conns.get(node)
        if conn is None:
            host, _, port = node.rpartition(":")
            conn = conns[node] = http.client.HTTPConnection(
                host, int(port), timeout=self.timeout)
        return conn

    def get(self, path: str, key: str | None = None) -> tuple[int, bytes]:
        """One GET, routed by ``key`` (default: the path itself, so
        repeated queries pin to one replica's response cache). Tries
        every live replica before giving up — a dead replica costs a
        failover, never an error surfaced to the caller while any
        replica lives."""
        last_err: Exception | None = None
        last_503: tuple[int, bytes] | None = None
        tried: set[str] = set()
        for _ in range(max(1, len(self.ring.nodes))):
            # preference order: healthy first, then degraded (they DO
            # answer, just slowly), then through the dead set rather
            # than failing a query the survivors could serve
            node = self.ring.node_for(
                key or path, skip=self._skip() | self._slow() | tried)
            if node is None:
                node = self.ring.node_for(key or path,
                                          skip=self._skip() | tried)
            if node is None:
                node = self.ring.node_for(key or path, skip=tried)
            if node is None:
                break
            try:
                conn = self._conn_for(node)
                conn.request("GET", path)
                resp = conn.getresponse()
                body = resp.read()
                if resp.status == 503:
                    ra = resp.getheader("Retry-After")
                    if ra is not None:
                        # an overload shed: the replica is degraded,
                        # not dead — deprioritize it for the
                        # advertised interval and try another arc
                        try:
                            after = float(ra)
                        except ValueError:
                            after = 1.0
                        self._mark_degraded(node, after)
                        last_503 = (resp.status, body)
                        tried.add(node)
                        continue
                return resp.status, body
            except (OSError, http.client.HTTPException) as e:
                # HTTPException covers a replica killed MID-RESPONSE
                # (IncompleteRead/BadStatusLine are NOT OSErrors) —
                # the contract is "retried elsewhere, never surfaced"
                last_err = e
                tried.add(node)
                self._mark_dead(node)
                conns = getattr(self._tls, "conns", {})
                stale = conns.pop(node, None)
                if stale is not None:
                    stale.close()
        if last_503 is not None:
            # every replica is overloaded: surface the honest 503 (the
            # caller can retry after the advertised interval) — a shed
            # is an answer, a ConnectionError is an outage
            return last_503
        raise ConnectionError(
            f"no gateway replica answered {path!r}") from last_err

    def get_json(self, path: str, key: str | None = None,
                 monotone: bool = True, wait: float | None = None):
        """GET + JSON decode with MONOTONE READS: if the answering
        replica is behind the session's version watermark (a failover
        onto a mirror that has not polled past the dead replica's last
        version yet), briefly re-poll — the mirror catches up within
        its poll cadence. If it stays behind past ``wait``,
        availability wins: the stale answer is returned and counted
        (``stale_reads``), never an error."""
        import json

        deadline = time.monotonic() + (
            self.monotone_wait if wait is None else wait)
        while True:
            code, body = self.get(path, key=key)
            doc = json.loads(body) if body else None
            v = doc.get("version") if isinstance(doc, dict) else None
            if v is None or code != 200:
                return code, doc
            with self._lock:
                wm = self.watermark
                if not monotone or v >= wm:
                    self.watermark = max(wm, int(v))
                    return code, doc
            if time.monotonic() >= deadline:
                with self._lock:
                    self.stale_reads += 1
                return code, doc
            time.sleep(0.01)

    def close(self) -> None:
        conns = getattr(self._tls, "conns", {})
        for conn in conns.values():
            conn.close()
        conns.clear()
