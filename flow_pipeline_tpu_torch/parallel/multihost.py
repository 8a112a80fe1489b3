"""Several processes over torch.distributed.

Counterpart of flow_pipeline_tpu/parallel/multihost.py. The reference
extends its mesh across hosts with jax.distributed; the port runs one
process per host (or per card) in a torch.distributed process group:

    init_distributed("127.0.0.1:29500", 2, rank, backend="gloo")
    mesh = make_mesh(4, devices="cpu")   # 4 shards, 2 in each process
    feeder = LocalShardFeeder(mesh)      # places this process's rows
    pipe = MultihostPipeline(mesh, wagg_config, {"top_pairs": cfg})

Each process consumes its own partitions (the consumer-group assignment
is the data-parallel split) and places its rows on its own shards; the
hot path has no collective. The merges at window close are collectives
that every process enters at the same step: the shards' CMS planes and
candidate tables are all-gathered and folded in global shard order, so
the merged sketch is the same on every process and the same as one
process's at the same N (an all_reduce would sum the float planes in the
ring's order); exact integer sums (the port tables) use all_reduce.

The backend is the caller's: gloo (any device; CUDA tensors are staged
through pinned host copies for the collective, the sketch state stays on
the card between merges) or NCCL (one card per rank, the state's own
device).
"""

from __future__ import annotations

from datetime import timedelta
from typing import Optional

import numpy as np
import torch

from .mesh import _DIST, DATA_AXIS, Mesh, place_blocks

__all__ = ["LocalShardFeeder", "MultihostPipeline", "all_gather_shards",
           "all_reduce_sum", "init_distributed", "reassign_lost_partitions"]


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int, backend: str = "gloo", device=None,
                     timeout: float = 300.0) -> None:
    """Join the process group (idempotent; nothing to do for one
    process). ``coordinator_address`` is host:port of process 0 (or a
    torch init URL). ``device`` is this process's default mesh device
    (make_mesh(devices=None)); NCCL needs one card per rank, made
    current here."""
    if num_processes <= 1:
        return
    dist = torch.distributed
    if dist.is_initialized():
        return
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be gloo|nccl, got {backend!r}")
    dev = torch.device(device) if device is not None else None
    if backend == "nccl":
        if dev is None or dev.type != "cuda" or dev.index is None:
            raise ValueError("nccl needs device='cuda:K', one card per rank")
        torch.cuda.set_device(dev)
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id,
                            timeout=timedelta(seconds=timeout))
    _DIST["device"] = dev


def backend() -> Optional[str]:
    """The process group's backend, None outside one."""
    dist = torch.distributed
    return dist.get_backend() if dist.is_initialized() else None


def _staged(t: torch.Tensor) -> torch.Tensor:
    """The tensor a collective of this backend takes: a pinned host copy
    of a CUDA tensor under gloo, the tensor itself otherwise."""
    t = t.contiguous()
    if t.is_cuda and backend() != "nccl":
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host
    return t


def all_gather_shards(local: torch.Tensor, device) -> list[torch.Tensor]:
    """[L, ...] local shard blocks of every process -> the N shards in
    global order, on ``device``."""
    dist = torch.distributed
    src = _staged(local)
    out = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.all_gather(out, src)
    return [x.to(device) for blk in out for x in blk.unbind(0)]


def all_reduce_sum(t: torch.Tensor, device) -> torch.Tensor:
    """The sum of ``t`` over every process, on ``device``."""
    src = _staged(t).clone()
    torch.distributed.all_reduce(src, op=torch.distributed.ReduceOp.SUM)
    return src.to(device)


def reassign_lost_partitions(lost: dict[int, int], survivors: list[int],
                             n_batches: int
                             ) -> dict[int, list[tuple[int, int]]]:
    """Deterministic reassignment of permanently lost hosts' partitions.

    ``lost`` maps each orphaned partition to its COMMITTED offset (the
    batch index its late owner had made durable, 0 if it never
    snapshotted); ``survivors`` is the ordered surviving-process list.
    Returns {survivor: [(partition, batch_index), ...]}, round-robining
    the orphaned (partition, batch) slices over the survivors from each
    partition's committed offset: the consumer-group rebalance rule as a
    pure function, so every survivor computes the same map with no
    coordination. Committed offsets give at-least-once without
    duplication: what the dead host processed but did not make durable
    is replayed, what lies under its committed offsets is not."""
    out: dict[int, list[tuple[int, int]]] = {s: [] for s in survivors}
    i = 0
    for part in sorted(lost):
        for b in range(lost[part], n_batches):
            out[survivors[i % len(survivors)]].append((part, b))
            i += 1
    return out


class MultihostPipeline:
    """The worker loop over a mesh that spans processes.

    Every process consumes its own partitions (its block of each global
    batch), places them on its shards with LocalShardFeeder, and the
    sharded models step with no cross-process traffic; collectives run
    only at a forced flush (the sketch merge).

    Emission contract:
    - flows_5m rows are HOST-PARTIAL: each process emits the partial
      aggregates of the rows it ingested, and merging sinks combine them
      by key, as SummingMergeTree merges partial rows.
    - top-K rows come from the merged sketch and are identical on every
      process, so only one process needs to write them.

    Checkpoints are per process: each saves its window store and ITS
    shards of the sketch state (local_state), and a restarted world
    rebuilds each process's shards from its own checkpoint."""

    def __init__(self, mesh: Mesh, wagg_config, hh_configs: dict,
                 k: int = 100):
        from .sharded import ShardedHeavyHitter, ShardedWindowAggregator

        self.mesh = mesh
        self.feeder = LocalShardFeeder(mesh)
        self.wagg = ShardedWindowAggregator(wagg_config, mesh)
        self.hh = {name: ShardedHeavyHitter(cfg, mesh)
                   for name, cfg in hh_configs.items()}
        self.k = k
        self.batches_done = 0

    def update(self, local_cols: dict, local_valid: np.ndarray,
               watermark: int) -> None:
        """One global batch step. Each process passes ITS rows (its
        shards' blocks, padded to batch_size per local shard) and the
        GLOBAL batch watermark (no process sees every row)."""
        cols, valid = self.feeder.feed_columns(local_cols, local_valid)
        self.wagg.update_device_columns(cols, valid, watermark)
        for m in self.hh.values():
            m.update_device_columns(cols, valid)
        self.batches_done += 1

    def flush(self, force: bool = False) -> dict:
        """Rows to emit: {'flows_5m': host-partial rows} always, plus one
        merged top-K rows dict per sketch model when force-closing. Every
        process must call it at the same step: the merge is a
        collective."""
        out = {"flows_5m": self.wagg.flush(force)}
        if force:
            for name, m in self.hh.items():
                out[name] = m.top(self.k)
                m.reset()
        return out

    def snapshot(self, path: str) -> None:
        from ..engine.checkpoint import save_checkpoint

        self.wagg._drain()  # the snapshot covers everything ingested
        save_checkpoint(path, {
            "batches_done": self.batches_done,
            "wagg": {"windows": self.wagg.windows,
                     "watermark": self.wagg.watermark},
            "hh": {name: m.local_state() for name, m in self.hh.items()},
        })

    def restore(self, path: str) -> Optional[int]:
        """Rehydrate this process's share; returns the number of batches
        the snapshot covers (the resume offset), or None without one."""
        from ..engine.checkpoint import checkpoint_exists, load_checkpoint

        if not checkpoint_exists(path):
            return None
        snap = load_checkpoint(path)
        self.batches_done = snap["batches_done"]
        self.wagg.windows = {
            int(slot): dict(store)
            for slot, store in snap["wagg"]["windows"].items()}
        self.wagg.watermark = snap["wagg"]["watermark"]
        for name, local in snap["hh"].items():
            self.hh[name].load_local_state(local)
        return self.batches_done


class LocalShardFeeder:
    """Places this process's rows on its own shards.

    A process holding L of the N shards feeds rows = L * B (B rows per
    shard, after padding); block j goes to its local shard j, with no
    cross-process movement."""

    def __init__(self, mesh: Mesh, axis: str = DATA_AXIS):
        self.mesh = mesh
        self.axis = axis

    def feed_columns(self, cols: dict, valid: np.ndarray):
        """(per-shard column dicts, per-shard valid tensors) of this
        process's shards."""
        return place_blocks(self.mesh, cols, valid, len(self.mesh.devices))
