"""The in-process mesh: a coordinator and N member threads in one
process, sharing one card.

Counterpart of flow_pipeline_tpu/mesh/runtime.py, the harness behind
``pipeline -mesh.workers N``: flows are sharded by key hash over the bus
partitions (every row of a 5-tuple lands on one partition, so each
shard's sketches see each key's whole substream), N MeshMember threads
consume their assigned partitions, and the coordinator merges window
state at close. Each member's worker launches its kernels on the
device's current stream from its own thread: the launches of the N
members queue on that one stream, one cooperative grid at a time.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Optional, Sequence

import numpy as np

from ..engine.hostfused import _key_lanes_into
from ..engine.worker import WorkerConfig
from ..hostsketch.engine import hash_words_np
from ..schema import wire
from ..schema.batch import FlowBatch
from ..transport import Consumer, InProcessBus
from .coordinator import MeshCoordinator, spec_from_models
from .member import MeshMember

log = logging.getLogger("flow_pipeline_tpu_torch.mesh")

# The shard key: the finest key family (the 5-tuple). The top-talkers
# family's keys then each land wholly on one shard, so its merged tables
# are a disjoint union with exact sums; the per-IP and per-port families
# spread a key over shards and merge as sketch monoids (the CMS sum is
# still the union stream's sketch; the table fold is exact while every
# shard that saw a key keeps it resident, always while distinct keys <=
# capacity).
SHARD_KEY_COLS = ("src_addr", "dst_addr", "src_port", "dst_port", "proto")


def shard_ids(batch: FlowBatch, n_partitions: int,
              key_cols: Sequence[str] = SHARD_KEY_COLS):
    """Per-row partition ids: murmur3 over the uint32 key lanes mod P
    (deterministic: every run shards a stream alike)."""
    lanes = _key_lanes_into(batch.columns, tuple(key_cols))
    return hash_words_np(lanes) % np.uint32(n_partitions)


def produce_sharded(bus: InProcessBus, topic: str, batch: FlowBatch,
                    n_partitions: int,
                    key_cols: Sequence[str] = SHARD_KEY_COLS) -> int:
    """Append one generated batch to the bus, key-hash sharded; rows keep
    the batch's time order within each partition."""
    pids = shard_ids(batch, n_partitions, key_cols)
    for p in range(n_partitions):
        idx = np.flatnonzero(pids == p)
        if not len(idx):
            continue
        part = FlowBatch({k: v[idx] for k, v in batch.columns.items()})
        bus.produce_many(topic, wire.iter_raw_frames(part.to_wire()),
                         partition=p)
    return len(batch)


class InProcessMesh:
    """A coordinator and N member threads over one in-process bus."""

    def __init__(self, bus: InProcessBus, topic: str, n_workers: int,
                 model_factory: Callable[[], dict],
                 config: WorkerConfig = WorkerConfig(),
                 sinks: Sequence[Any] = (),
                 member_sinks: Sequence[Any] = (),
                 heartbeat_timeout: float = 30.0,
                 submit_every: int = 0,
                 sync_interval: float = 0.05,
                 journal: Optional[str] = None):
        self.bus = bus
        self.topic = topic
        # one throwaway model set gives the merge specs; members build
        # their own per assignment epoch
        self.coordinator = MeshCoordinator(
            spec_from_models(model_factory()), bus.partitions(topic),
            sinks=sinks, heartbeat_timeout=heartbeat_timeout,
            journal=journal)
        self.members = []
        for i in range(n_workers):
            mid = f"w{i}"
            self.members.append(MeshMember(
                mid, self.coordinator,
                consumer_factory=self._consumer_factory(mid),
                model_factory=model_factory, config=config,
                sinks=list(member_sinks), submit_every=submit_every,
                sync_interval=sync_interval))
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    def _consumer_factory(self, member_id: str):
        def factory(partitions):
            return Consumer(self.bus, self.topic,
                            group=f"mesh-{member_id}",
                            partitions=list(partitions))
        return factory

    # ---- lifecycle ----------------------------------------------------------

    def start(self) -> "InProcessMesh":
        # every member joins before any thread consumes, so the first
        # assignment covers the full membership (no immediate resync)
        for m in self.members:
            self.coordinator.join(m.member_id, provider=m._query_state)
            m._joined = True
        for m in self.members:
            t = threading.Thread(target=m.run, args=(self._stop,),
                                 name=f"mesh-{m.member_id}", daemon=True)
            self._threads.append(t)
            t.start()
        return self

    def kill_member(self, i: int, fence: bool = True) -> str:
        """A member's abrupt death: stopped without a submission, then (by
        default) fenced at once, the deterministic stand-in for the
        heartbeat expiry."""
        m = self.members[i]
        m.kill()
        if fence:
            self.coordinator.fence(m.member_id)
        return m.member_id

    def wait_idle(self, idle_rounds: int = 20, timeout: float = 300.0,
                  poll: float = 0.02) -> None:
        """Block until every live member has been idle for
        ``idle_rounds`` steps and every partition is owned, on two
        consecutive polls (a pre-produced stream consumed and every
        rebalance settled)."""
        deadline = time.monotonic() + timeout
        streak = 0
        while time.monotonic() < deadline:
            live = [m for m in self.members if not m._dead]
            ok = live and all(m.idle_streak >= idle_rounds for m in live)
            if ok:
                st = self.coordinator.status()
                owned = sum(len(v["owned"])
                            for v in st["members"].values())
                ok = owned == st["partitions"]
            streak = streak + 1 if ok else 0
            if streak >= 2:
                return
            time.sleep(poll)
        raise TimeoutError("mesh did not quiesce within timeout")

    def finalize(self) -> None:
        """Stop the member threads, final-submit every live member, merge
        everything outstanding, release the coordinator's journal."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout=60)
        for m in self.members:
            m.finalize()
        self.coordinator.close()

    def run(self, idle_rounds: int = 20, timeout: float = 300.0) -> float:
        """start(), wait_idle(), finalize(); returns the wall seconds from
        the start to quiescence."""
        t0 = time.perf_counter()
        self.start()
        try:
            self.wait_idle(idle_rounds=idle_rounds, timeout=timeout)
            elapsed = time.perf_counter() - t0
        finally:
            self.finalize()
        return elapsed
