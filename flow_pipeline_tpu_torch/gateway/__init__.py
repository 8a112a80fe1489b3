"""The gateway: a replicated, delta-fed read tier for the serving tier.

Counterpart of flow_pipeline_tpu/gateway:

- the publisher side (a worker's ``-serve.addr``) answers the
  subscription feed (:mod:`.feed`): between versions it ships deltas
  (:mod:`.delta`), and a version gap or CRC mismatch falls back to a full
  snapshot;
- each gateway replica (:mod:`.subscriber`) mirrors the upstream's
  versioned snapshot stream into its own ``SnapshotStore`` and serves it
  through the unchanged ``ServeServer``, so every ``/query/*`` answer
  equals the direct snapshot path's at the same version;
- K replicas sit behind client-side consistent hashing over the query
  key (:mod:`.ring`).

It reads host snapshots only: nothing here touches the card.
"""

from .delta import (DeltaError, DeltaGapError, apply_delta, decode_frames,
                    diff_states, encode_delta, encode_full, encode_none,
                    snapshot_state, state_to_snapshot)
from .feed import SnapshotFeed
from .ring import GatewayClient, HashRing
from .subscriber import GATEWAY_METRICS, SnapshotGateway

__all__ = [
    "DeltaError",
    "DeltaGapError",
    "GATEWAY_METRICS",
    "GatewayClient",
    "HashRing",
    "SnapshotFeed",
    "SnapshotGateway",
    "apply_delta",
    "decode_frames",
    "diff_states",
    "encode_delta",
    "encode_full",
    "encode_none",
    "snapshot_state",
    "state_to_snapshot",
]
