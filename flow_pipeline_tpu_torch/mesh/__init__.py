"""The mesh: N stream workers over a key-hash-sharded stream, their
window state merged network-wide at each close.

Counterpart of flow_pipeline_tpu/mesh, in process: the state codec
(codec.py), the host merges (merge.py), the coordinator (coordinator.py)
with its write-ahead journal (journal.py), the member (member.py), the
clock alignment (scope.py) and the in-process runtime (runtime.py)
behind ``pipeline -mesh.workers N``; the merged serving tier rides it
(serve/publisher.py ``MeshServePublisher``). Of the reference's mesh
only the mesh over HTTP (flow_pipeline_tpu/mesh/server.py) is not
ported yet.
"""

from .codec import capture_model, decode, encode
from .coordinator import MeshCoordinator, ModelSpec, spec_from_models
from .member import MeshMember
from .runtime import (InProcessMesh, SHARD_KEY_COLS, produce_sharded,
                      shard_ids)
from .scope import ClockSync, TraceLane, aggregate_traces, estimate_offset

__all__ = [
    "capture_model", "decode", "encode",
    "MeshCoordinator", "MeshMember", "ModelSpec", "spec_from_models",
    "InProcessMesh", "SHARD_KEY_COLS", "produce_sharded", "shard_ids",
    "ClockSync", "TraceLane", "aggregate_traces", "estimate_offset",
]
