"""This process's shard blocks as one host array (a leaf module: the
models and the parallel layer both use it without importing each
other)."""

from __future__ import annotations

import numpy as np


def local_device_blocks(arr) -> np.ndarray:
    """The shard blocks of ``arr`` that this process holds, stacked in
    shard order on a leading axis, as host numpy. ``arr`` is a sequence of
    per-shard tensors (a sharded model keeps one per local shard, each on
    its shard's device) or one tensor or array whose leading axis is
    already the shard axis; either comes back whole, since a process
    holds only its own shards."""
    if isinstance(arr, (list, tuple)):
        return np.stack([_host(a) for a in arr])
    return _host(arr)


def _host(a) -> np.ndarray:
    if hasattr(a, "detach"):  # a torch tensor, on any device
        return a.detach().cpu().numpy()
    return np.asarray(a)
