"""Sharded host grouping: partition by hash prefix, group per shard.

Counterpart of flow_pipeline_tpu/ingest/shard.py. Rows whose 64-bit key
hashes share a top-bit prefix can only group with each other, so prefix
shards group independently and their outputs concatenate into exactly
the serial result (shards ascend by prefix, hashes ascend within a
shard). Two distinct keys collide only in the full hash, so they land in
the same shard, and the per-shard verify still sees them.

The pool is a ThreadPoolExecutor (threads named ``ingest-shard``) kept
alive across batches.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..ops import hostgroup

# Below this many rows the serial path keeps the job (the reference's
# break-even estimate).
MIN_SHARD_ROWS = 8192


def default_workers() -> int:
    return max(1, min(8, os.cpu_count() or 1))


class ShardPool:
    """Persistent worker threads for GIL-releasing group work."""

    def __init__(self, workers: int = 0):
        self.workers = workers or default_workers()
        self._ex = ThreadPoolExecutor(
            max_workers=self.workers, thread_name_prefix="ingest-shard")

    def map(self, fn, items) -> list:
        """fn over items on the pool, in order; one item runs inline."""
        items = list(items)
        if len(items) <= 1:
            return [fn(x) for x in items]
        return list(self._ex.map(fn, items))

    def shutdown(self) -> None:
        self._ex.shutdown(wait=False, cancel_futures=True)

    def __enter__(self) -> "ShardPool":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()


# One process-wide pool: pipelines are rebuilt freely, and per-instance
# pools would strand idle threads.
_SHARED_LOCK = threading.Lock()
_SHARED: ShardPool | None = None


def shared_pool() -> ShardPool:
    """The process-wide pool, created once."""
    global _SHARED
    with _SHARED_LOCK:
        if _SHARED is None:
            _SHARED = ShardPool()
        return _SHARED


def _shard_bits(shards: int) -> int:
    bits = 1
    while (1 << bits) < shards:
        bits += 1
    return bits


def group_by_key_sharded(lanes: np.ndarray, planes: list[np.ndarray],
                         pool: ShardPool | None, shards: int = 0,
                         exact: bool = True, native: bool = False):
    """ops/hostgroup.py group_by_key over hash-prefix shards on ``pool``:
    the same contract and output. Small batches, no pool, a one-thread
    pool and the native kernel (one C pass already) take the serial
    path."""
    n, w = lanes.shape
    if pool is None or n < MIN_SHARD_ROWS or pool.workers <= 1 or native:
        return hostgroup.group_by_key(lanes, planes, exact, native=native)
    shards = shards or pool.workers
    bits = _shard_bits(shards)

    h = np.empty(n, np.uint64)
    step = -(-n // pool.workers)
    blocks = [slice(i, min(i + step, n)) for i in range(0, n, step)]

    def do_hash(sl):
        h[sl] = hostgroup.hash_u64(lanes[sl])

    pool.map(do_hash, blocks)

    sid = (h >> np.uint64(64 - bits)).astype(np.int64)
    parts = [np.flatnonzero(sid == s) for s in range(1 << bits)]

    def do_group(idx):
        if idx.size == 0:
            return None
        sl = lanes[idx]
        perm, starts = hostgroup.grouping_perm(sl, exact, h=h[idx])
        return hostgroup.reduce_groups(
            sl, [p[idx] for p in planes], perm, starts)

    results = [r for r in pool.map(do_group, parts) if r is not None]
    if not results:
        return hostgroup._empty_groups(w, planes)
    uniq = np.concatenate([r[0] for r in results])
    counts = np.concatenate([r[2] for r in results])
    sums = [np.concatenate([r[1][j] for r in results])
            for j in range(len(planes))]
    return uniq, sums, counts
