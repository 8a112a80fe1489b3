"""The mesh: N stream workers over a key-hash-sharded stream, their
window state merged network-wide at each close.

Counterpart of flow_pipeline_tpu/mesh: the state codec (codec.py), the
host merges (merge.py), the coordinator (coordinator.py) with its
write-ahead journal (journal.py), the member (member.py), the clock
alignment (scope.py) and the in-process runtime (runtime.py) behind
``pipeline -mesh.workers N``; the merged serving tier rides it
(serve/publisher.py ``MeshServePublisher``). The mesh over HTTP
(server.py) carries the same protocol across processes: the
coordinator's server behind ``processor -mesh.role coordinator``, and
``RemoteCoordinator`` and ``MemberStateServer`` for a member in a
process of its own.
"""

from .codec import capture_model, decode, encode
from .coordinator import MeshCoordinator, ModelSpec, spec_from_models
from .member import MeshMember
from .runtime import (InProcessMesh, SHARD_KEY_COLS, produce_sharded,
                      shard_ids)
from .scope import ClockSync, TraceLane, aggregate_traces, estimate_offset
from .server import (MemberStateServer, MeshCoordinatorServer,
                     RemoteCoordinator)

__all__ = [
    "capture_model", "decode", "encode",
    "MeshCoordinator", "MeshMember", "ModelSpec", "spec_from_models",
    "InProcessMesh", "SHARD_KEY_COLS", "produce_sharded", "shard_ids",
    "MeshCoordinatorServer", "RemoteCoordinator", "MemberStateServer",
    "ClockSync", "TraceLane", "aggregate_traces", "estimate_offset",
]
