"""Shard slots and batch placement.

Counterpart of flow_pipeline_tpu/parallel/mesh.py. The reference's mesh
is a 1-D ``Mesh`` over the first N JAX devices and raises when N exceeds
them. The port's mesh is N shard slots with shard i on
``devices[i % len(devices)]``: ``-processor.mesh 4`` runs four shards on
one card, as the reference's CPU tests run eight shards on one CPU
(forced virtual devices). ``devices`` is every visible card for
``cuda``, one card for ``cuda:K`` and ``[cpu]`` for ``cpu``.

Under several processes (parallel/multihost.py init_distributed) the N
shards split into equal contiguous blocks, process p holding shards
[p * N / P, (p + 1) * N / P); a mesh then carries the devices of this
process's shards only.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device

DATA_AXIS = "data"

log = logging.getLogger("flow_pipeline_tpu_torch.parallel")

# the device init_distributed was given: this process's default pool (a
# process holds one process group, so this is process state, as it is)
_DIST = {"device": None}


@dataclass(frozen=True)
class Mesh:
    """N shard slots over this process's devices."""

    devices: tuple[torch.device, ...]  # one per LOCAL shard, in order
    size: int  # N, the global shard count
    process_index: int = 0
    process_count: int = 1
    axis: str = DATA_AXIS

    @property
    def local_size(self) -> int:
        return self.size // self.process_count

    @property
    def local_start(self) -> int:
        """Global index of this process's first shard."""
        return self.process_index * self.local_size


def process_count() -> int:
    dist = torch.distributed
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def process_index() -> int:
    dist = torch.distributed
    return (dist.get_rank()
            if dist.is_available() and dist.is_initialized() else 0)


def _device_pool(devices) -> list[torch.device]:
    if devices is None:
        devices = _DIST["device"] or DEFAULT_DEVICE
    if isinstance(devices, (str, torch.device)):
        dev = resolve_device(devices)
        if dev.type == "cuda" and dev.index is None:
            return [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
        return [dev]
    pool = [resolve_device(d) for d in devices]
    if not pool:
        raise ValueError("make_mesh needs at least one device")
    return pool


def make_mesh(n_devices: Optional[int] = None, devices=None,
              axis: str = DATA_AXIS) -> Mesh:
    """A 1-D mesh of ``n_devices`` shards (default: one per device of
    every process), shard i on ``devices[i % len(devices)]``.
    ``devices``: None (the device init_distributed was given, else every
    visible card), "cuda", "cuda:K", "cpu", or a list of devices.

    Flow aggregation is pure data parallelism: sketches are replicated
    monoid accumulators, so one ``data`` axis is the whole story."""
    pool = _device_pool(devices)
    procs, rank = process_count(), process_index()
    n = len(pool) * procs if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    if n % procs:
        raise ValueError(f"{n} shards do not split evenly over {procs} "
                         f"processes")
    local = n // procs
    start = rank * local
    mesh = Mesh(tuple(pool[i % len(pool)] for i in range(start, start + local)),
                n, rank, procs, axis)
    if procs == 1:
        log.info("mesh: %d shards over %d devices (%s)", n, len(pool),
                 ", ".join(map(str, pool)))
    else:
        log.info("mesh: %d shards over %d devices in each of %d processes "
                 "(process %d holds shards %d-%d)", n, len(pool), procs,
                 rank, start, start + local - 1)
    return mesh


def place_blocks(mesh: Mesh, cols: dict, valid, n_blocks: int,
                 first: int = 0):
    """Rows [b * B, (b + 1) * B) of ``cols``/``valid`` for the blocks
    ``first`` .. ``first + len(mesh.devices) - 1`` of ``n_blocks``, each
    on its local shard's device. Returns (per-shard column dicts,
    per-shard valid tensors)."""
    valid = np.asarray(valid)
    rows = valid.shape[0]
    if rows % n_blocks:
        raise ValueError(f"{rows} rows do not split into {n_blocks} equal "
                         f"shard blocks (pad the batch to a multiple of "
                         f"the mesh size first)")
    per = rows // n_blocks
    out_cols, out_valid = [], []
    for j, dev in enumerate(mesh.devices):
        sl = slice((first + j) * per, (first + j + 1) * per)
        out_cols.append({
            k: torch.from_numpy(np.ascontiguousarray(np.asarray(v)[sl])).to(
                dev) for k, v in cols.items()})
        out_valid.append(torch.from_numpy(
            np.ascontiguousarray(valid[sl])).to(dev))
    return out_cols, out_valid


def shard_batch_columns(mesh: Mesh, cols: dict, valid,
                        axis: str = DATA_AXIS):
    """Place a global batch's columns row-blocked over the mesh: row
    block i goes to shard i on its device. Rows must divide by the mesh
    size (pad the batch to n_shards * per_shard_batch first). Under
    several processes each keeps only its own shards' blocks.

    Returns (cols, valid): a column dict and a valid tensor per local
    shard, in shard order (the reference returns global arrays sharded
    on the ``data`` axis)."""
    del axis  # one axis: the name is the reference's
    return place_blocks(mesh, cols, valid, mesh.size, mesh.local_start)
