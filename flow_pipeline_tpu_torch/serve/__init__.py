"""The serving tier: versioned-snapshot query serving for heavy
concurrent reads.

Counterpart of flow_pipeline_tpu/serve. The live query
API (engine/query_api.py) answers under the worker's lock: correct, but
every reader stalls the worker and each other. The serving tier
decouples the two:

- the WRITE side (the worker thread, or in the mesh the coordinator's
  publisher thread; serve/publisher.py) publishes an
  immutable :class:`~.snapshot.Snapshot` (extracted top-K rows per
  family, host copies of the card's CMS planes frozen lazily to uint64
  for per-key estimates, the newest closed exact-window rows, the
  watermark) by one atomic reference swap, at every window close and at
  the ``-serve.refresh`` cadence;
- the READ side (:class:`~.server.ServeServer`) loads the pointer and
  answers ``/query/*`` without taking ANY worker lock or touching the
  card, behind a response cache keyed by ``(version, normalized
  query)`` with ETag/304 revalidation, and serves the subscription feed
  (gateway/feed.py).

In the mesh the coordinator's publisher serves the network-wide MERGED
view, so no reader fans out to the members per query.
"""

from .publisher import (MeshServePublisher, WorkerServePublisher,
                        attach_mesh, attach_worker)
from .server import ServeServer
from .snapshot import FamilyView, RangeLedger, Snapshot, SnapshotStore

__all__ = [
    "FamilyView",
    "MeshServePublisher",
    "RangeLedger",
    "ServeServer",
    "Snapshot",
    "SnapshotStore",
    "WorkerServePublisher",
    "attach_mesh",
    "attach_worker",
]
