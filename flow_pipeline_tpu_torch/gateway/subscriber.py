"""The gateway's subscriber: a replica mirroring upstream snapshots.

Counterpart of flow_pipeline_tpu/gateway/subscriber.py (stdlib and numpy
only). A :class:`SnapshotGateway` subscribes to one or more upstream
snapshot streams (a worker's serving tier, ``-serve.addr``, over HTTP via
``/sub/snapshot``, or in process via a store or feed object) and rebuilds
each stream into its OWN :class:`~..serve.SnapshotStore`. The gateway's
``ServeServer`` runs the unchanged handler code over the rebuilt
immutable snapshot, and the rebuild carries the upstream's arrays bit for
bit (gateway/delta.py), so every ``/query/*`` answer equals the direct
snapshot path's at the same version. Nothing here touches the card: the
upstream publisher froze its snapshots to host arrays.

Mirroring rules:

- polls carry ``since=<local version>``; the upstream feed answers
  "none" (current), a delta chain, or a full snapshot;
- a delta gap, CRC failure or any apply error drops local delta state
  and re-polls with ``since=0``: a full resync
  (``gateway_resyncs_total`` by reason); resync is the bootstrap path;
- versions are monotone: ``publish_snapshot`` refuses to move the store
  backwards, so a flapping upstream or a replayed response never
  un-publishes;
- the moment a snapshot lands, the hot query set (top-K at default k,
  per family and bare) is pre-rendered into the serve response cache
  (``ServeServer.warm``) on the subscriber thread.

The first upstream is the PRIMARY: its store is what the gateway's serve
surface answers from. Further upstreams mirror into their own stores
(``gateway.stores``).
"""

from __future__ import annotations

# Each upstream's mirror state is touched only by its own poll thread (or
# by sync_once callers in tests, never both); the stores carry their own
# RCU contract. Every subscription poll carries an explicit timeout: a
# wedged upstream costs one bounded fetch per cadence, not a hung mirror
# thread.

import http.client
import logging
import threading
from typing import Optional

from ..obs.metrics import REGISTRY
from ..serve.snapshot import SnapshotStore
from ..utils.faults import FAULTS
from .delta import (DeltaError, DeltaGapError, apply_delta, decode_frames,
                    state_to_snapshot)
from .feed import SnapshotFeed

log = logging.getLogger("flow_pipeline_tpu_torch.gateway")

# Metric name and help specs (the reference's, so dashboards resolve
# against the port's /metrics too).
GATEWAY_METRICS = {
    "syncs": ("gateway_syncs_total",
              "flowgate subscription polls answered (label: "
              "kind=full|delta|none)"),
    "sync_bytes": ("gateway_sync_bytes_total",
                   "flowgate bytes shipped by the subscription feed "
                   "(label: kind=full|delta) — delta/full is the "
                   "fan-in-cost ratio"),
    "resyncs": ("gateway_resyncs_total",
                "flowgate full-snapshot resyncs forced by a delta "
                "chain break (label: reason=gap|crc|error)"),
    "upstream_restarts": ("gateway_upstream_restarts_total",
                          "flowgate polls whose reconstructed snapshot "
                          "was refused for being at or behind the "
                          "served mirror (label: upstream) — an "
                          "upstream RESTART republishing from a fresh "
                          "store; the stateless replica keeps serving "
                          "its pre-restart snapshot (restart it to "
                          "adopt the new stream)"),
    "poll_failures": ("gateway_poll_failures_total",
                      "flowgate subscription polls that failed in "
                      "transport (upstream down/unreachable) — the "
                      "mirror keeps serving its last snapshot"),
    "upstream_version": ("gateway_upstream_version",
                         "newest version the upstream feed advertised "
                         "(label: upstream) — minus "
                         "serve_snapshot_version = mirror lag"),
    "prerendered": ("gateway_prerendered_total",
                    "hot-query responses pre-rendered into the serve "
                    "cache at snapshot-landing time"),
    "upstreams": ("gateway_upstreams",
                  "configured upstream subscriptions"),
}


class _Upstream:
    """One subscription: transport + mirror state + local store."""

    def __init__(self, target, name: str, timeout: float):
        self.name = name
        self.timeout = timeout
        self._http: Optional[tuple[str, int]] = None
        self._feed: Optional[SnapshotFeed] = None
        if isinstance(target, str):
            host, _, port = target.rpartition(":")
            self._http = (host or "127.0.0.1", int(port))
        elif isinstance(target, SnapshotFeed):
            self._feed = target
        elif isinstance(target, SnapshotStore):
            self._feed = SnapshotFeed(target)
        else:
            raise TypeError(
                f"upstream must be 'host:port', a SnapshotStore or a "
                f"SnapshotFeed, got {type(target).__name__}")
        self.store = SnapshotStore()
        # touched only by this upstream's own poll thread
        self.state: Optional[dict] = None  # canonical mirror state
        self.conn: Optional[http.client.HTTPConnection] = None

    @property
    def version(self) -> int:
        return 0 if self.state is None else int(self.state["version"])

    def fetch(self, since: int) -> bytes:
        if self._feed is not None:
            return self._feed.frame_since(since)[2]
        if self.conn is None:
            self.conn = http.client.HTTPConnection(
                *self._http, timeout=self.timeout)
        try:
            # ETag-conditional poll: the server tags every subscription
            # answer with the CURRENT feed version, so a mirror already
            # at `since` revalidates instead of re-downloading the "none"
            # frame. 304 means what an empty frame list means to _apply:
            # nothing new.
            self.conn.request("GET", f"/sub/snapshot?since={since}",
                              headers={"If-None-Match": f'"sub-v{since}"'})
            resp = self.conn.getresponse()
            body = resp.read()
        except (OSError, http.client.HTTPException) as e:
            conn, self.conn = self.conn, None
            if conn is not None:
                conn.close()
            if isinstance(e, OSError):
                raise
            # an upstream dying MID-RESPONSE surfaces as
            # IncompleteRead/BadStatusLine, an HTTPException and not an
            # OSError: normalize so the poll loop's outage handling
            # covers it instead of the exception killing the thread
            raise ConnectionError(
                f"upstream {self.name} died mid-response: {e!r}") from e
        if resp.status == 304:
            return b""  # already current: zero frames -> kind "none"
        if resp.status != 200:
            raise OSError(f"upstream {self.name} answered "
                          f"{resp.status} for /sub/snapshot")
        return body


class SnapshotGateway:
    """One replica of a K-replica read tier: mirror upstream snapshot
    streams and serve the primary through a local store. ``archive``: a
    history ArchiveWriter (``-history.dir``) recording every transition
    of the primary stream."""

    def __init__(self, upstreams, poll: float = 0.25,
                 timeout: float = 10.0, prerender: bool = True,
                 adopt_restart: bool = False, archive=None):
        if not upstreams:
            raise ValueError("at least one upstream is required")
        # -history.dir: the archive rides the PRIMARY mirror thread; every
        # applied transition is archived, so the replica's /query/range
        # reaches past the upstream's RANGE_SLOTS and ?at=/?version= time
        # travel answers from the same process
        self.archive = archive
        # -gateway.adopt-restart: swap to an upstream's post-restart
        # stream (availability) instead of holding the pre-restart
        # snapshot until an operator restarts this replica (monotone
        # reads, the default)
        self.adopt_restart = adopt_restart
        self.upstreams = [
            up if isinstance(up, _Upstream)
            else _Upstream(up, name=(up if isinstance(up, str)
                                     else f"inproc-{i}"), timeout=timeout)
            for i, up in enumerate(upstreams)]
        self.poll = poll
        self.prerender = prerender
        self.store = self.upstreams[0].store  # the PRIMARY serving store
        self.stores = {u.name: u.store for u in self.upstreams}
        # the serve surface to pre-render into; wired by serve_on() (the
        # server needs the store, which needs this object: two phases)
        self.server = None
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._m = {k: (REGISTRY.gauge(*v)
                       if k in ("upstream_version", "upstreams")
                       else REGISTRY.counter(*v))
                   for k, v in GATEWAY_METRICS.items()}
        self._m["upstreams"].set(len(self.upstreams))

    # ---- wiring ------------------------------------------------------------

    def serve_on(self, server) -> "SnapshotGateway":
        """Attach the ServeServer built over ``self.store`` so landing
        snapshots pre-render the hot query set into its cache."""
        self.server = server
        return self

    # ---- one mirror step (tests drive this deterministically) --------------

    def sync_once(self, index: int = 0) -> str:
        """One poll+apply for one upstream. Returns the sync kind
        ("none" | "delta" | "full" | "resync" | "error")."""
        up = self.upstreams[index]
        if FAULTS.active:  # fault seam: a failed or injected poll (the
            # mirror keeps serving its previous snapshot)
            FAULTS.check("gateway.poll")
        data = up.fetch(up.version)
        try:
            return self._apply(up, data)
        except DeltaGapError as e:
            return self._schedule_resync(up, "gap", e)
        except DeltaError as e:
            return self._schedule_resync(up, "crc", e)
        except (KeyError, ValueError, TypeError) as e:
            # a malformed tree from a version-skewed upstream: the same
            # answer as damage (drop local state, take a full snapshot)
            return self._schedule_resync(up, "error", e)

    def _schedule_resync(self, up: _Upstream, reason: str,
                         err: Exception) -> str:
        self._m["resyncs"].inc(reason=reason)
        log.warning("gateway upstream %s: %s (%s); full resync",
                    up.name, reason, err)
        up.state = None  # since=0 on the next poll -> full frame
        return "resync"

    def _apply(self, up: _Upstream, data: bytes) -> str:
        kind = "none"
        for tree in decode_frames(data):
            t = tree["t"]
            if t == "none":
                self._m["upstream_version"].set(int(tree["to"]),
                                                upstream=up.name)
                continue
            if t == "full":
                # chain continuity across a full resync is unknown, so
                # the archive (if any) anchors a fresh keyframe
                prev, up.state = None, tree["state"]
                kind = "full"
            elif t == "delta":
                if up.state is None:
                    raise DeltaGapError("delta frame with no local base")
                prev = up.state
                up.state = apply_delta(up.state, tree)
                if kind != "full":
                    kind = "delta"
            else:
                raise DeltaError(f"unknown frame kind {t!r}")
            if self.archive is not None and up is self.upstreams[0]:
                # archive the PRIMARY stream's transition before the
                # publish: the archived chain is exactly what the serve
                # surface answers from (record-and-replay parity)
                self.archive.record(prev, up.state)
            self._m["upstream_version"].set(up.version, upstream=up.name)
        self._m["syncs"].inc(kind=kind)
        if kind != "none" and self.archive is not None:
            self.archive.commit()  # group commit per poll, not per frame
        if kind != "none":
            self._m["sync_bytes"].inc(len(data), kind=kind)
            snap = up.store.publish_snapshot(state_to_snapshot(up.state))
            if snap is None:
                # the store refused: rebuilt version <= served version.
                # Deltas only move forward, so this is an upstream
                # RESTART (a fresh process republishing from v1). The
                # replica stays monotone by keeping its pre-restart
                # snapshot; adopting the new stream is an operator action
                # (replicas are stateless: restart them), and this
                # counter is what pages it. The log warns only at the
                # full-frame restart moment, not every refused delta.
                self._m["upstream_restarts"].inc(upstream=up.name)
                if kind == "full" and self.adopt_restart:
                    # -gateway.adopt-restart: the operator chose
                    # availability, so adopt the post-restart stream now;
                    # only on a FULL frame (a self-consistent snapshot)
                    # and still counted above
                    snap = up.store.adopt_snapshot(
                        state_to_snapshot(up.state))
                    if up is self.upstreams[0] and \
                            self.server is not None:
                        # the adopted stream's version counter restarts:
                        # a new version can collide with an old cached
                        # response, so drop them all
                        self.server.invalidate_cache()
                    log.warning(
                        "gateway upstream %s republished v%d at or "
                        "behind the served version — upstream restart "
                        "ADOPTED (-gateway.adopt-restart): serving the "
                        "new stream from v%d", up.name, up.version,
                        snap.version)
                    if up is self.upstreams[0] and \
                            self.server is not None and self.prerender:
                        self._m["prerendered"].inc(
                            self.server.warm(self._hot_targets(snap)))
                elif kind == "full":
                    log.warning(
                        "gateway upstream %s republished v%d at or "
                        "behind served v%d — upstream restart; replica "
                        "keeps serving its pre-restart snapshot "
                        "(restart this replica to adopt the new "
                        "stream)", up.name, up.version,
                        up.store.current.version)
            elif up is self.upstreams[0] and \
                    self.server is not None and self.prerender:
                self._m["prerendered"].inc(
                    self.server.warm(self._hot_targets(snap)))
        return kind

    @staticmethod
    def _hot_targets(snap) -> list[str]:
        """The queries every dashboard issues the moment a version
        lands: top-K at the default slice, bare and per model. Rendering
        them now moves them off the readers' tail."""
        return ["/query/topk"] + [f"/query/topk?model={name}"
                                  for name in snap.families]

    # ---- mirror threads ----------------------------------------------------

    def start(self) -> "SnapshotGateway":
        self._threads = [
            threading.Thread(target=self._run, args=(i,),
                             name=f"gateway-sub-{u.name}", daemon=True)
            for i, u in enumerate(self.upstreams)]
        for t in self._threads:
            t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)

    def _run(self, index: int) -> None:
        up = self.upstreams[index]
        while not self._stop.is_set():
            try:
                self.sync_once(index)
            except OSError as e:
                # upstream down (or an injected gateway.poll fault):
                # count it and keep serving the mirrored snapshot;
                # staleness stays visible (gateway_upstream_version stops
                # advancing)
                self._m["poll_failures"].inc()
                log.debug("gateway upstream %s poll failed: %s",
                          up.name, e)
            self._stop.wait(self.poll)
