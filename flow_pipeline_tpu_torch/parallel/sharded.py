"""Sharded models: one state per shard, merged at window close.

Counterpart of flow_pipeline_tpu/parallel/sharded.py. A global batch of
``batch_size * N`` rows is cut into N row blocks; block i updates shard
i's state on its device, with no communication. The shards merge only at
window close:

    CMS, DDoS rates, port-table totals : a sum over shards
    top-K candidate tables            : every shard's table, folded in
                                        shard order with topk_merge
    DDoS witnesses                    : the address of the shard with the
                                        largest wmax (first shard on ties)
    flows_5m collision flag           : OR over the shards

Within a process the merge is plain tensor ops: every shard's tensor
moves to the first local shard's device and the fold runs there in shard
order, as the reference's static fold does. Under several processes
(parallel/multihost.py) the shards of the other processes are
all-gathered first, so every process folds the same tensors in the same
global order and gets the same merged state; the port-table totals, an
exact int32 sum, are summed by all_reduce instead.

Each shard runs the single-device model's own update (models/*), so a
heavy-hitter shard launches the CMS kernel once per chunk on its card.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import interop
from ..models import ddos as ddos_mod
from ..models import dense_top as dense_mod
from ..models import heavy_hitter as hh
from ..models.window_agg import (WindowAggConfig, WindowAggregator, _update,
                                 _update_exact, group_cols)
from ..ops import topk as topk_ops
from ..schema.batch import FlowBatch
from .mesh import DATA_AXIS, Mesh, make_mesh, shard_batch_columns

__all__ = ["DATA_AXIS", "ShardedDDoSDetector", "ShardedDenseTopK",
           "ShardedHeavyHitter", "ShardedWindowAggregator",
           "sharded_hh_merge", "sharded_hh_update", "stack_state"]


def _resolve_mesh(mesh: Optional[Mesh], device) -> Mesh:
    return mesh if mesh is not None else make_mesh(devices=device)


def _all_shards(mesh: Mesh, tensors) -> list[torch.Tensor]:
    """Every shard's tensor in global shard order, on the first local
    shard's device: this process's own, and under several processes the
    others' all-gathered."""
    dev = mesh.devices[0]
    local = [t.to(dev) for t in tensors]
    if mesh.process_count == 1:
        return local
    from .multihost import all_gather_shards

    return all_gather_shards(torch.stack(local), dev)


def _sum_in_order(tensors) -> torch.Tensor:
    """t0 + t1 + ... left to right, into a fresh tensor (shard 0's state
    is never aliased: the CMS kernels write it in place)."""
    total = tensors[0].clone()
    for t in tensors[1:]:
        total += t
    return total


def _stack(states, cls):
    """One state of stacked [L, ...] fields on the first shard's device."""
    dev = getattr(states[0], cls._fields[0]).device
    return cls(*(torch.stack([getattr(s, f).to(dev) for s in states])
                 for f in cls._fields))


# ---------------------------------------------------------------------------
# Heavy hitter, sharded
# ---------------------------------------------------------------------------


def stack_state(state: hh.HHState, n_dev: int) -> hh.HHState:
    """A fresh single-shard state replicated onto a leading shard axis."""
    return hh.HHState(*(t.unsqueeze(0).expand((n_dev,) + tuple(t.shape))
                        .clone() for t in state))


def sharded_hh_update(mesh: Mesh, config: hh.HeavyHitterConfig):
    """The per-shard update: (states, per-shard cols, per-shard valid) ->
    states. No communication: each shard's hh_update on its own block."""
    del mesh  # every shard's placement is in its tensors

    def update(states, cols, valid):
        return [hh.hh_update(s, c, v, config=config)
                for s, c, v in zip(states, cols, valid)]

    return update


def sharded_hh_merge(mesh: Mesh, config: hh.HeavyHitterConfig):
    """The window-close merge: per-shard states -> one merged HHState on
    the first local shard's device. The CMS planes summed, the candidate
    tables folded in shard order with topk_merge (which drops the
    sentinel rows of empty slots)."""
    del config

    def merge(states) -> hh.HHState:
        cms = _all_shards(mesh, [s.cms for s in states])
        tk = _all_shards(mesh, [s.table_keys for s in states])
        tv = _all_shards(mesh, [s.table_vals for s in states])
        mk, mv = tk[0], tv[0]
        for d in range(1, len(tk)):
            cand_valid = torch.ones(tk[d].shape[0], dtype=torch.bool,
                                    device=tk[d].device)
            mk, mv = topk_ops.topk_merge(mk, mv, tk[d], tv[d], cand_valid)
        return hh.HHState(cms=_sum_in_order(cms), table_keys=mk,
                          table_vals=mv)

    return merge


class ShardedHeavyHitter:
    """Heavy-hitter model over a mesh.

    The HeavyHitterModel surface, but ``update()`` consumes global
    batches cut into shard blocks, and ``top()`` merges the shards
    first. ``states`` holds one HHState per local shard; ``state`` is
    their stacked view (the reference's [N, ...] layout)."""

    snapshot_kind = "windowed_hh"  # the worker's checkpoint kind tag

    def __init__(self, config: hh.HeavyHitterConfig,
                 mesh: Optional[Mesh] = None, device=None):
        if config.hh_sketch != "table":
            raise ValueError("ShardedHeavyHitter runs the table family "
                             f"only, got hh_sketch={config.hh_sketch!r}")
        self.config = config
        self.mesh = _resolve_mesh(mesh, device)
        self.n_dev = self.mesh.size
        self.device = self.mesh.devices[0]
        self._update = sharded_hh_update(self.mesh, config)
        self._merge = sharded_hh_merge(self.mesh, config)
        self.states = [hh.hh_init(config, d) for d in self.mesh.devices]
        # CMS updates summed over the shards (one per shard per chunk)
        self.chunk_updates = 0

    @property
    def global_batch(self) -> int:
        return self.config.batch_size * self.n_dev

    @property
    def state(self) -> hh.HHState:
        return _stack(self.states, hh.HHState)

    def update(self, batch: FlowBatch) -> None:
        gb = self.global_batch
        names = hh.input_cols(self.config)
        for start in range(0, len(batch), gb):
            padded, mask = batch.slice(start, start + gb).pad_to(gb)
            cols, valid = shard_batch_columns(
                self.mesh, padded.device_columns(names), mask)
            self.update_device_columns(cols, valid)

    def update_device_columns(self, cols, valid) -> None:
        """Update from columns already placed on the local shards (one
        column dict and valid tensor per local shard, each of
        ``batch_size`` rows): the multi-process feed path, where each
        process supplies only its own shards (LocalShardFeeder)."""
        self.states = self._update(self.states, cols, valid)
        for _ in cols:
            hh.count_chunk_update(self)

    def merged_state(self) -> hh.HHState:
        return self._merge(self.states)

    def local_state(self) -> dict[str, np.ndarray]:
        """This process's shards of the state as stacked host numpy in
        the reference's dtypes: the per-process checkpoint unit."""
        return dict(zip(hh.HHState._fields,
                        interop.hh_shards_to_reference(self.states)))

    def load_local_state(self, local: dict) -> None:
        """Rebuild this process's shards from what its local_state()
        returned."""
        self.states = interop.hh_shards_from_reference(
            local["cms"], local["table_keys"], local["table_vals"],
            self.mesh.devices)

    def top(self, k: int | None = None) -> dict[str, np.ndarray]:
        return hh._top_from_state(self.merged_state(), self.config,
                                  k or self.config.capacity)

    def reset(self) -> None:
        self.states = [hh.hh_init(self.config, d) for d in self.mesh.devices]


# ---------------------------------------------------------------------------
# Exact window aggregation, sharded
# ---------------------------------------------------------------------------


class ShardedWindowAggregator(WindowAggregator):
    """Exact windowed aggregation over a mesh.

    Each shard groups its block on its device (the hash-grouped step);
    the per-shard partials queue as one partial whose collision flag is
    the OR over the shards, so the exact fallback reruns every shard of
    that chunk, as the reference's pmax-globalized flag does. The host
    fold treats the shard blocks as more partial rows: partial sums merge
    exactly in any order. Under several processes each process folds its
    own shards' partials: flows_5m rows are host-partial (the fallback is
    process-local, so no collective is needed for the flag)."""

    def __init__(self, config: WindowAggConfig = WindowAggConfig(),
                 mesh: Optional[Mesh] = None, device=None):
        mesh = _resolve_mesh(mesh, device)
        super().__init__(config, device=mesh.devices[0])
        self.mesh = mesh
        self.n_dev = mesh.size

    @property
    def global_batch(self) -> int:
        return self.config.batch_size * self.n_dev

    def _names(self) -> list[str]:
        return ["time_received", *group_cols(self.config),
                *self.config.value_cols]

    def update(self, batch: FlowBatch) -> None:
        if len(batch) == 0:
            return
        gb = self.global_batch
        for start in range(0, len(batch), gb):
            self._update_sharded_chunk(batch.slice(start, start + gb))
        wm = int(batch.columns["time_received"].max())
        if wm > self.watermark:
            self.watermark = wm

    def _update_sharded_chunk(self, batch: FlowBatch) -> None:
        padded, mask = batch.pad_to(self.global_batch)
        host_cols = padded.device_columns(self._names())
        cols, valid = shard_batch_columns(self.mesh, host_cols, mask)

        def exact():
            # closes over the HOST columns: a pending fallback holds no
            # device memory
            c, v = shard_batch_columns(self.mesh, host_cols, mask)
            return self._exact(c, v)

        self._add_sharded(cols, valid, exact)

    def _exact(self, cols, valid):
        """The lexicographic step on every shard: (keys, sums, counts, n)
        as per-shard lists."""
        return tuple(map(list, zip(*(_update_exact(self.config, c, v)
                                     for c, v in zip(cols, valid)))))

    def _add_sharded(self, cols, valid, fallback) -> None:
        parts = [_update(self.config, c, v) for c, v in zip(cols, valid)]
        dev = self.mesh.devices[0]
        # any-shard OR, on the device: the drain reads it (no sync here)
        collided = torch.stack([p[4].to(dev) for p in parts]).any()
        keys, sums, counts, n = (list(x) for x in zip(*(p[:4]
                                                        for p in parts)))
        self.add_partial((keys, sums, counts, n, collided),
                         fallback=fallback)

    def update_device_columns(self, cols, valid,
                              watermark: Optional[int] = None) -> None:
        """Update from columns already placed on the local shards (see
        ShardedHeavyHitter). The caller supplies the batch's watermark: a
        process sees only its own rows, so max(time_received) must come
        from the feed layer."""
        self._add_sharded(cols, valid, lambda: self._exact(cols, valid))
        if watermark is not None and watermark > self.watermark:
            self.watermark = watermark


# ---------------------------------------------------------------------------
# DDoS detection, sharded
# ---------------------------------------------------------------------------


class ShardedDDoSDetector(ddos_mod.DDoSDetector):
    """DDoS detector over a mesh.

    Each shard scatters its block into its own rate and witness arrays.
    A sub-window close merges once: the rates summed in shard order, and
    per bucket the witness address of the shard with the largest wmax
    (the first such shard on ties, as jnp.argmax picks; an elementwise
    max would splice words of different addresses). The EW baseline and
    the quantile histogram are replicated on every shard and are NOT
    summed (summing replicas would multiply the histogram's mass by N at
    every close); the close runs once on the merged state and the new
    state is written back to every shard."""

    def __init__(self, config: ddos_mod.DDoSConfig = ddos_mod.DDoSConfig(),
                 mesh: Optional[Mesh] = None, device=None):
        mesh = _resolve_mesh(mesh, device)
        self.mesh = mesh
        self.n_dev = mesh.size
        # the base class binds its fresh state through the setter below,
        # which replicates it onto every shard
        super().__init__(config, device=mesh.devices[0])

    @property
    def global_batch(self) -> int:
        return self.config.batch_size * self.n_dev

    @property
    def state(self) -> ddos_mod.DDoSState:
        return _stack(self.states, ddos_mod.DDoSState)

    @state.setter
    def state(self, value: ddos_mod.DDoSState) -> None:
        """One single-shard state, replicated onto every shard (a copy
        each)."""
        self.states = [ddos_mod.DDoSState(*(t.to(d, copy=True)
                                            for t in value))
                       for d in self.mesh.devices]

    def _accumulate(self, batch: FlowBatch) -> None:
        gb = self.global_batch
        names = ddos_mod.ddos_input_cols(self.config)
        for start in range(0, len(batch), gb):
            padded, mask = batch.slice(start, start + gb).pad_to(gb)
            cols, valid = shard_batch_columns(
                self.mesh, padded.device_columns(names), mask)
            self.states = [ddos_mod.ddos_accumulate(s, c, v,
                                                    config=self.config)
                           for s, c, v in zip(self.states, cols, valid)]

    def merged_state(self) -> ddos_mod.DDoSState:
        """The shards merged, before the close: rates summed, witnesses
        picked by wmax; the replicated fields are the first shard's."""
        rates = _all_shards(self.mesh, [s.rates for s in self.states])
        wmax_all = torch.stack(_all_shards(self.mesh,
                                           [s.wmax for s in self.states]))
        addrs_all = torch.stack(_all_shards(self.mesh,
                                            [s.addrs for s in self.states]))
        # the first shard holding the largest wmax (torch.argmax promises
        # no order among ties; jnp.argmax takes the first)
        best = wmax_all.max(dim=0).values
        idx = torch.arange(wmax_all.shape[0], device=wmax_all.device)
        winner = torch.where(wmax_all == best, idx[:, None],
                             wmax_all.shape[0]).min(dim=0).values
        addrs = addrs_all[winner, torch.arange(winner.shape[0],
                                               device=winner.device)]
        first = ddos_mod.DDoSState(*(t.to(self.mesh.devices[0])
                                     for t in self.states[0]))
        return first._replace(rates=_sum_in_order(rates), addrs=addrs,
                              wmax=best)

    def close_sub_window(self) -> list[dict]:
        new, z, rates = ddos_mod.ddos_close_window(
            self.merged_state(), config=self.config, spec=self.spec)
        self.state = new  # replicated back onto every shard
        return self._emit_alerts(z, rates, new.hist, new.addrs)

    def local_state(self) -> ddos_mod.DDoSState:
        """This process's shards as stacked host numpy in the reference's
        dtypes (the checkpoint form)."""
        return ddos_mod.DDoSState(*interop.ddos_shards_to_reference(
            self.states))

    def load_local_state(self, fields) -> None:
        get = (fields.get if isinstance(fields, dict)
               else lambda f: getattr(fields, f))
        self.states = interop.ddos_shards_from_reference(
            *(get(f) for f in ddos_mod.DDoSState._fields),
            devices=self.mesh.devices)


# ---------------------------------------------------------------------------
# Dense exact top-K (the port tables), sharded
# ---------------------------------------------------------------------------


class ShardedDenseTopK(dense_mod.DenseTopKModel):
    """Port tables over a mesh: per-shard (lo, hi) int32 planes, a sum
    monoid, summed at close (each shard's lo stays below 2^16, so N
    shards sum far from int32 overflow; the exact uint64 recombination
    happens at extraction, dense_top._planes_to_uint64)."""

    def __init__(self, config: dense_mod.DenseTopConfig,
                 mesh: Optional[Mesh] = None, device=None):
        self.config = config
        self.mesh = _resolve_mesh(mesh, device)
        self.n_dev = self.mesh.size
        self.device = self.mesh.devices[0]
        self.shard_totals = [dense_mod.dense_init(config, d)
                             for d in self.mesh.devices]

    @property
    def global_batch(self) -> int:
        return self.config.batch_size * self.n_dev

    @property
    def totals(self) -> torch.Tensor:
        """The stacked [L, domain, P+1, 2] view of the local shards."""
        return torch.stack([t.to(self.device) for t in self.shard_totals])

    def update(self, batch: FlowBatch) -> None:
        gb = self.global_batch
        names = dense_mod.dense_input_cols(self.config)
        for start in range(0, len(batch), gb):
            padded, mask = batch.slice(start, start + gb).pad_to(gb)
            cols, valid = shard_batch_columns(
                self.mesh, padded.device_columns(names), mask)
            self.shard_totals = [
                dense_mod.dense_update(t, c, v, config=self.config)
                for t, c, v in zip(self.shard_totals, cols, valid)]

    def _merged_totals(self) -> torch.Tensor:
        local = _sum_in_order([t.to(self.device) for t in self.shard_totals])
        if self.mesh.process_count == 1:
            return local
        from .multihost import all_reduce_sum

        return all_reduce_sum(local, self.device)  # int32: exact

    def top(self, k: int | None = None) -> dict[str, np.ndarray]:
        return dense_mod._top_from_totals(self._merged_totals(), self.config,
                                          k)

    def top_lazy(self, k: int | None = None):
        """top(k) of the merged totals as they are now (the inherited form
        would rank the stacked per-shard view)."""
        totals, config = self._merged_totals(), self.config
        return lambda: dense_mod._top_from_totals(totals, config, k)

    def local_state(self) -> np.ndarray:
        """This process's shards as stacked [L, domain, P+1, 2] int32 host
        numpy (the checkpoint form)."""
        return interop.dense_shards_to_reference(self.shard_totals)

    def load_local_state(self, totals) -> None:
        self.shard_totals = interop.dense_shards_from_reference(
            totals, self.mesh.devices)

    def reset(self) -> None:
        self.shard_totals = [dense_mod.dense_init(self.config, d)
                             for d in self.mesh.devices]
