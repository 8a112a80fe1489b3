"""Device sharding: shard slots, sharded models and their merges.

Counterpart of flow_pipeline_tpu/parallel/. The reference scales by Kafka
partitions and merges partial aggregates at merge time; here, as in the
reference's TPU form:

- flow batches are cut into row blocks over a 1-D ``data`` mesh of N
  shard slots (the analogue of Kafka partitions; parallel/mesh.py);
- every shard runs the same model update on its block, with no
  communication;
- sketch states are commutative monoids, so the shards merge at window
  close: a sum for the CMS, the rates and the port tables, and an
  in-order topk_merge fold of the candidate tables.

Several processes extend the same mesh over torch.distributed
(parallel/multihost.py); nothing in the kernels changes.
"""

from .mesh import make_mesh, shard_batch_columns
from .sharded import (
    ShardedDDoSDetector,
    ShardedDenseTopK,
    ShardedHeavyHitter,
    ShardedWindowAggregator,
    sharded_hh_merge,
    sharded_hh_update,
)
from .multihost import LocalShardFeeder, MultihostPipeline, init_distributed

__all__ = [
    "make_mesh",
    "shard_batch_columns",
    "ShardedDDoSDetector",
    "ShardedDenseTopK",
    "ShardedHeavyHitter",
    "ShardedWindowAggregator",
    "sharded_hh_update",
    "sharded_hh_merge",
    "init_distributed",
    "LocalShardFeeder",
    "MultihostPipeline",
]
