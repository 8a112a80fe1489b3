"""The serving tier's subscription feed: the publisher side of delta
shipping (feed.py) and its snapshot delta codec (delta.py). The
reference's gateway replicas (subscriber, ring) and the ``gateway``
entry are not ported yet."""

from .delta import (DeltaError, decode_frames, diff_states, encode_delta,
                    encode_full, encode_none, snapshot_state,
                    state_to_snapshot)
from .feed import SnapshotFeed

__all__ = [
    "DeltaError",
    "SnapshotFeed",
    "decode_frames",
    "diff_states",
    "encode_delta",
    "encode_full",
    "encode_none",
    "snapshot_state",
    "state_to_snapshot",
]
