"""Host dataplane runtime of the host-grouped pipeline.

Counterpart of flow_pipeline_tpu/ingest:

- ingest.shard     sharded grouping: hash-prefix shards grouped on a
                   persistent thread pool (numpy releases the GIL), the
                   same output as the serial groupby;
- ingest.executor  the pipelined stage: a group thread runs the
                   pipeline's prepare half (host grouping) of batch N+1
                   while the worker thread applies batch N, behind a
                   bounded queue;
- ingest.flush     the background flusher: top-K extraction and sink
                   writes of closed windows off the update path, errors
                   latched back to the worker before its next commit.
"""

from .executor import PipelinedExecutor
from .flush import AsyncFlusher, FlushError
from .shard import ShardPool, group_by_key_sharded, shared_pool

__all__ = ["AsyncFlusher", "FlushError", "PipelinedExecutor", "ShardPool",
           "group_by_key_sharded", "shared_pool"]
