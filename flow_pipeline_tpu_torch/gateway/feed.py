"""The subscription feed: the publisher side of delta shipping.

Counterpart of flow_pipeline_tpu/gateway/feed.py. One
:class:`SnapshotFeed` sits next to a :class:`~..serve.SnapshotStore` and
answers ``/sub/snapshot?since=V`` polls (serve/server.py routes them
here). It is lazy the way ``FrozenCms`` is: nothing is encoded until a
subscriber asks, and the encode runs on the subscriber's reader thread;
the worker's publish stays one pointer swap.

Per observed version the feed keeps ONE full frame plus a bounded chain
of delta frames between consecutively OBSERVED versions (a feed polled
slower than the publisher publishes produces coarser deltas). A
subscriber older than the chain, an evicted history, or a brand-new
subscriber (``since=0``) gets the full frame: the resync path is the
bootstrap path. The subscriber side is gateway/subscriber.py.
"""

from __future__ import annotations

# Polled from N subscriber HTTP threads; one lock guards the memoized
# state and frames. The store pointer read inside is the lock-free read
# every serve reader does.

import threading
from collections import deque
from typing import Optional

from .delta import encode_delta, encode_full, encode_none, snapshot_state

# Delta-chain retention (observed version transitions). A subscriber
# further behind than this gets a full snapshot — at production poll
# cadences (sub-second) 64 transitions is tens of seconds of outage
# ridden on deltas.
FEED_HISTORY = 64

# ...and a cumulative BYTE budget on the same chain (-serve.feed_bytes):
# under saturated ingest every CMS tile is dirty and a delta is about a
# full snapshot's size, so a count-only bound could hold 64 snapshots'
# worth of bytes. Evicting the oldest links past the budget widens the
# full-resync window, the fallback every evicted subscriber takes.
FEED_HISTORY_BYTES = 128 << 20


class SnapshotFeed:
    """Delta/full frame source for one snapshot store."""

    def __init__(self, store, history: int = FEED_HISTORY,
                 history_bytes: int = FEED_HISTORY_BYTES):
        self.store = store
        self.history_bytes = history_bytes
        self._lock = threading.Lock()
        self._state: Optional[dict] = None  # guarded by _lock
        self._full: Optional[bytes] = None  # guarded by _lock
        # (from_version, to_version, frame bytes), consecutive by
        # construction: each append chains from the previous _state
        self._deltas: deque = deque(maxlen=history)  # guarded by _lock
        self._delta_bytes_held = 0  # guarded by _lock
        # the shipping-cost ledger: per-transition encoded sizes, the
        # bytes-per-publish evidence for delta against full shipping
        self._stats = {"publishes": 0, "full_bytes": 0,  # guarded by _lock
                       "delta_bytes": 0, "deltas": 0}

    def _refresh_locked(self) -> None:
        snap = self.store.current
        if snap is None:
            return
        if self._state is not None and \
                snap.version <= self._state["version"]:
            return
        state = snapshot_state(snap)
        full = encode_full(state)
        self._stats["publishes"] += 1
        self._stats["full_bytes"] += len(full)
        if self._state is not None:
            frame = encode_delta(self._state, state)
            if len(self._deltas) == self._deltas.maxlen:
                # the append below will silently drop the oldest link
                self._delta_bytes_held -= len(self._deltas[0][2])
            self._deltas.append(
                (self._state["version"], state["version"], frame))
            self._delta_bytes_held += len(frame)
            while self._delta_bytes_held > self.history_bytes \
                    and self._deltas:
                self._delta_bytes_held -= len(self._deltas.popleft()[2])
            self._stats["deltas"] += 1
            self._stats["delta_bytes"] += len(frame)
        self._state, self._full = state, full

    def frame_since(self, since: int) -> tuple[str, int, bytes]:
        """(kind, current_version, frames) for one subscriber poll.
        ``kind``: "none" (already current), "delta" (a chain of >= 1
        delta frames), or "full" (bootstrap / gap / evicted history)."""
        with self._lock:
            self._refresh_locked()
            if self._state is None:
                return "none", 0, encode_none(0)
            cur = self._state["version"]
            if since == cur:
                return "none", cur, encode_none(cur)
            if since:
                frms = [frm for frm, _, _ in self._deltas]
                if since in frms:
                    # the deque links consecutively, so everything from
                    # the `since` link onward IS the exact chain to cur
                    chain = list(self._deltas)[frms.index(since):]
                    return "delta", cur, b"".join(f for _, _, f in chain)
            return "full", cur, self._full

    def stats(self) -> dict:
        """A copy of the shipping-cost ledger, with per-publish
        averages."""
        with self._lock:
            out = dict(self._stats)
        if out["publishes"]:
            out["full_bytes_per_publish"] = round(
                out["full_bytes"] / out["publishes"], 1)
        if out["deltas"]:
            out["delta_bytes_per_publish"] = round(
                out["delta_bytes"] / out["deltas"], 1)
        return out
