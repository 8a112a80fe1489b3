"""Exact windowed aggregation (the flows_5m rollup), in torch.

Counterpart of flow_pipeline_tpu/models/window_agg.py, single-device:
per-chunk exact partial aggregates on the model's device, keyed on
(timeslot, *key columns[, sampling rate]), then a host store that merges
partials into per-timeslot dicts of uint64 accumulators and flushes a
window once the watermark has passed its end plus ``allowed_lateness``.

Exactness: each value column rides to the device as two 16-bit int32
planes, so per-chunk int32 sums cannot overflow (batch_size <= 32768)
and integer sums are the same in any order: the card's atomic scatters
give the CPU's bits. The device step groups by the 64-bit hash
(ops/segment.py hash_groupby) and returns a collision flag that stays on
the device until the drain (no sync per chunk); a chunk whose flag fired
is re-run through the lexicographic sort_groupby. The host recombines
lo + (hi << 16) in uint64 numpy, so flows_5m is bit-exact at any size.

The host-grouped pipeline (engine/hostfused.py) groups chunks on the
host in uint64 already and hands its rows to ``add_host_rows``, which
skips the device planes and the collision fallback.

Late rows for an already flushed window reopen it; the next flush emits
them as additional partial rows for the same (timeslot, key), which sinks
merge by key as the reference's SummingMergeTree does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..ops.hostgroup import _lex_regroup
from ..ops.segment import hash_groupby, sort_groupby
from ..schema.batch import FlowBatch, lane_width
from ..schema.keys import as_u32
from .oracle import SECONDS_PER_SLOT


@dataclass(frozen=True)
class WindowAggConfig:
    key_cols: tuple[str, ...] = ("src_as", "dst_as", "etype")
    value_cols: tuple[str, ...] = ("bytes", "packets")
    window_seconds: int = SECONDS_PER_SLOT
    allowed_lateness: int = 0
    batch_size: int = 8192  # chunk rows; shorter chunks are padded
    # The sampling rate rides as one extra grouping lane and flush() emits
    # exact uint64 ``<value>_scaled`` sums (value * max(rate, 1)) beside
    # the raw ones; None emits the raw sums under the scaled names.
    scale_col: Optional[str] = "sampling_rate"


def group_cols(config: WindowAggConfig) -> tuple[str, ...]:
    """Grouping lanes: key columns plus the sampling-rate lane when scaled
    serving is on."""
    if config.scale_col:
        return (*config.key_cols, config.scale_col)
    return config.key_cols


def _window_keys_values(window: int, key_cols, value_cols, cols):
    """(timeslot, *keys) lanes [N, W] int64 holding uint32, and 16-bit
    value planes [N, 2V] int32 (lo, hi per value column)."""
    ts = as_u32(cols["time_received"])
    lanes = [ts - ts % window]
    for name in key_cols:
        arr = as_u32(cols[name])
        lanes.extend([arr] if arr.dim() == 1 else arr.unbind(1))
    planes = []
    for name in value_cols:
        v = as_u32(cols[name])
        planes.append((v & 0xFFFF).to(torch.int32))
        planes.append((v >> 16).to(torch.int32))
    return torch.stack(lanes, dim=1), torch.stack(planes, dim=1)


def _update(config: WindowAggConfig, cols: dict, valid: torch.Tensor):
    """Hash-grouped fast path: (keys, sums, counts, n_groups, collided)."""
    keys, values = _window_keys_values(
        config.window_seconds, group_cols(config), config.value_cols, cols)
    return hash_groupby(keys, values, valid)


def _update_exact(config: WindowAggConfig, cols: dict, valid: torch.Tensor):
    """Lexicographic path, the collision fallback: (keys, sums, counts,
    n_groups)."""
    keys, values = _window_keys_values(
        config.window_seconds, group_cols(config), config.value_cols, cols)
    return sort_groupby(keys, values, valid)


# Device partials queued before a host fold is forced: a drain syncs the
# device (it reads every queued collision flag and group count), so it
# runs every DRAIN_PENDING_MAX chunks or at a flush, never per chunk.
DRAIN_PENDING_MAX = 32


class WindowAggregator:
    """Streaming exact aggregator: update(batch) per batch, flush() yields
    finalized window rows."""

    def __init__(self, config: WindowAggConfig = WindowAggConfig(),
                 device: str | torch.device = DEFAULT_DEVICE):
        if config.batch_size > 32768:
            raise ValueError(
                "batch_size must be <= 32768 (int32 exactness of the 16-bit "
                "value planes)")
        self.config = config
        self.device = resolve_device(device)
        # windows: timeslot -> {key tuple -> uint64 [*values, count]}
        self.windows: dict[int, dict[tuple, np.ndarray]] = {}
        self.watermark = 0  # max time_received seen
        # (device partial, exact fallback) pairs not yet folded
        self._pending_partials: list = []
        # host-grouped (keys, uint64 values) rows not yet folded, and
        # their smallest slot
        self._pending_host: list = []
        self._min_pending_slot: Optional[int] = None
        # the mesh member's seam (mesh/member.py): popped (slot, store)
        # pairs go to it and nothing closes locally
        self.capture = None

    @property
    def store_key_lanes(self) -> int:
        """Width of the window-store key tuples (the timeslot is the dict
        key, not part of the tuple)."""
        return sum(lane_width(n) for n in self.config.key_cols) + (
            1 if self.config.scale_col else 0)

    def update(self, batch: FlowBatch) -> None:
        if len(batch) == 0:
            return
        bs = self.config.batch_size
        for start in range(0, len(batch), bs):  # chunk arbitrary batch sizes
            self._update_chunk(batch.slice(start, start + bs))
        wm = int(batch.columns["time_received"].max())
        if wm > self.watermark:
            self.watermark = wm

    def _update_chunk(self, batch: FlowBatch) -> None:
        padded, mask = batch.pad_to(self.config.batch_size)
        host_cols = padded.device_columns(
            ["time_received", *group_cols(self.config),
             *self.config.value_cols])
        cols = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in host_cols.items()}
        valid = torch.from_numpy(mask).to(self.device)
        self.add_partial(_update(self.config, cols, valid),
                         fallback=self._exact_fallback(host_cols, mask))

    def _exact_fallback(self, host_cols: dict, mask):
        """Deferred exact recompute of one chunk. Closes over the HOST
        numpy columns, so a pending fallback holds no device memory."""
        def run():
            cols = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                self.device) for k, v in host_cols.items()}
            return _update_exact(self.config, cols,
                                 torch.from_numpy(mask).to(self.device))

        return run

    def add_partial(self, partial, fallback=None) -> None:
        """Queue one device partial: (keys, sums, counts, n) exact, or
        (keys, sums, counts, n, collided) hash-grouped; a sharded
        aggregator's keys, sums, counts and n are per-shard lists under
        one collision flag. ``fallback`` is a zero-arg callable giving the
        exact partial of the same chunk; it runs at drain time iff the
        chunk's collision flag fired."""
        self._pending_partials.append((partial, fallback))
        if len(self._pending_partials) >= DRAIN_PENDING_MAX:
            self._drain()

    def add_host_rows(self, keys, sums, counts) -> None:
        """Queue host-grouped EXACT rows for the window store: ``keys``
        [R, 1 + key lanes] uint32 with the timeslot lane first (the
        device partials' layout), ``sums`` [R, nvals] uint64, ``counts``
        [R] integers. They fold at the next drain, with the device
        partials."""
        expect = 1 + self.store_key_lanes
        if keys.ndim != 2 or keys.shape[1] != expect:
            raise ValueError(
                f"add_host_rows keys must be [R, {expect}] "
                f"([timeslot, *key lanes"
                f"{', rate' if self.config.scale_col else ''}]) for this "
                f"config; got {keys.shape}")
        vals = np.concatenate(
            [sums.astype(np.uint64), counts.astype(np.uint64)[:, None]],
            axis=1)
        self._pending_host.append((keys.astype(np.uint32), vals))
        if len(keys):
            lo = int(keys[:, 0].min())
            if self._min_pending_slot is None or lo < self._min_pending_slot:
                self._min_pending_slot = lo
        if len(self._pending_host) >= DRAIN_PENDING_MAX:
            self._drain()

    def _drain(self) -> None:
        if self._pending_host:
            pending_h, self._pending_host = self._pending_host, []
            self._min_pending_slot = None
            self._fold_rows(np.concatenate([k for k, _ in pending_h]),
                            np.concatenate([v for _, v in pending_h]))
        pending, self._pending_partials = self._pending_partials, []
        if not pending:
            return
        all_keys, all_sums, all_counts = [], [], []
        for partial, fallback in pending:
            if len(partial) == 5:
                keys, sums, counts, n, collided = partial
                if bool(collided):  # the first host read of this chunk
                    # a 64-bit grouping-hash collision: recompute this
                    # chunk lexicographically
                    if fallback is None:
                        raise RuntimeError(
                            "hash-grouped partial collided and no exact "
                            "fallback was provided")
                    keys, sums, counts, n = fallback()[:4]
            else:
                keys, sums, counts, n = partial
            if isinstance(keys, list):
                # per-shard partials of a sharded aggregator
                # (parallel/sharded.py): each shard's rows are more
                # partial rows of the same fold
                parts = zip(keys, sums, counts, n)
            else:
                parts = ((keys, sums, counts, n),)
            for k, s, c, g in parts:
                g = int(g)
                # slice on the device: copy only the g real group rows
                all_keys.append(k[:g].cpu().numpy())
                all_sums.append(s[:g].cpu().numpy())
                all_counts.append(c[:g].cpu().numpy())
        self._merge_partials(np.concatenate(all_keys),
                             np.concatenate(all_sums),
                             np.concatenate(all_counts))

    def _merge_partials(self, keys, plane_sums, counts) -> None:
        """Fold device partials (keys + 16-bit value planes + counts) into
        the per-window host accumulators."""
        n = keys.shape[0]
        if n == 0:
            return
        keys = keys.astype(np.uint32)
        plane_sums = plane_sums.astype(np.uint64)
        counts = counts.astype(np.uint64)
        # recombine the (lo, hi) 16-bit planes of each value column
        nvals = len(self.config.value_cols)
        vals = np.empty((n, nvals + 1), dtype=np.uint64)
        for j in range(nvals):
            vals[:, j] = plane_sums[:, 2 * j] + (
                plane_sums[:, 2 * j + 1] << np.uint64(16))
        vals[:, nvals] = counts
        self._fold_rows(keys, vals)

    def _fold_rows(self, keys, vals) -> None:
        """Merge (slot, key) rows and their uint64 value/count columns
        into the per-window dicts: one lexsort over the drain's rows, dict
        work only per unique (slot, key)."""
        n = keys.shape[0]
        if n == 0:
            return
        order, starts = _lex_regroup(keys)
        uniq = keys[order][starts]
        sums = np.add.reduceat(vals[order], starts, axis=0)
        for i in range(len(starts)):
            slot = int(uniq[i, 0])
            key = tuple(int(x) for x in uniq[i, 1:])
            wstore = self.windows.setdefault(slot, {})
            acc = wstore.get(key)
            if acc is None:
                wstore[key] = sums[i].copy()
            else:
                acc += sums[i]

    def closed_slots(self) -> list[int]:
        self._drain()
        limit = self.watermark - self.config.allowed_lateness
        return sorted(
            s for s in self.windows if s + self.config.window_seconds <= limit)

    def _nothing_closable(self) -> bool:
        """Proof that flush(force=False) would emit nothing, without a
        drain: any pending device partial means "maybe closable"; pending
        host rows carry their smallest slot."""
        if self._pending_partials:
            return False
        cand = min(self.windows) if self.windows else None
        if self._min_pending_slot is not None and (
                cand is None or self._min_pending_slot < cand):
            cand = self._min_pending_slot
        if cand is None:
            return True
        limit = self.watermark - self.config.allowed_lateness
        return cand + self.config.window_seconds > limit

    def pop_closed(self, force: bool = False) -> list[tuple[int, dict]]:
        """Detach finalized windows (all, if force) as (slot, store)
        pairs. Late rows for a popped slot open a fresh store, emitted as
        additional partial rows."""
        if not force and self._nothing_closable():
            return []
        self._drain()
        slots = sorted(self.windows) if force else self.closed_slots()
        popped = [(slot, self.windows.pop(slot)) for slot in slots]
        if self.capture is not None:
            self.capture(popped)  # the stores merge at the coordinator
            return []
        return popped

    def flush(self, force: bool = False) -> dict[str, np.ndarray]:
        """Pop finalized windows (all, if force) as columnar rows, per-rate
        subgroups folded back to the key shape with exact uint64
        ``<value>_scaled`` columns (see rows_from_stores)."""
        return rows_from_stores(self.config, self.pop_closed(force))


def wagg_rows(store: dict, config: WindowAggConfig, k: int,
              slot: int) -> dict[str, np.ndarray]:
    """Rows of ONE window store, with the ranked families' row-hook
    signature; ``k`` is unused (every exact group is emitted)."""
    return rows_from_stores(config, [(slot, store)])


def rows_from_stores(config: WindowAggConfig,
                     stores: list[tuple[int, dict]]) -> dict[str, np.ndarray]:
    """Columnar flush rows from popped (slot, store) pairs: per slot one
    lexicographic regroup that folds the per-rate subgroups back to the
    reference key shape, with uint64 sums and ``<value>_scaled`` sums
    (value * max(rate, 1); equal to the raw sums without a scale
    column)."""
    scaled = config.scale_col is not None
    nvals = len(config.value_cols)
    ts_parts, key_parts, val_parts, scaled_parts = [], [], [], []
    for slot, store in stores:
        if not store:
            continue
        keys = np.fromiter(
            (x for key in store for x in key), dtype=np.uint64,
            count=len(store) * (len(next(iter(store)))),
        ).reshape(len(store), -1)
        vals = np.stack(list(store.values())).astype(np.uint64)
        if scaled:
            base, rate = keys[:, :-1], np.maximum(keys[:, -1], 1)
            svals = vals[:, :nvals] * rate[:, None]
            order, starts = _lex_regroup(base)
            key_arr = base[order][starts]
            val_arr = np.add.reduceat(vals[order], starts, axis=0)
            scaled_arr = np.add.reduceat(svals[order], starts, axis=0)
        else:
            order = np.lexsort(keys.T[::-1])
            key_arr = keys[order]
            val_arr = vals[order]
            scaled_arr = val_arr[:, :nvals].copy()
        ts_parts.append(np.full(len(key_arr), slot, np.uint64))
        key_parts.append(key_arr)
        val_parts.append(val_arr)
        scaled_parts.append(scaled_arr)
    if not ts_parts:
        empty = {"timeslot": np.zeros(0, np.uint64)}
        for name in config.value_cols + ("count",):
            empty[name] = np.zeros(0, np.uint64)
        for name in config.key_cols:
            empty[name] = np.zeros(0, np.uint64)
        for name in config.value_cols:
            empty[f"{name}_scaled"] = np.zeros(0, np.uint64)
        return empty
    key_arr = np.concatenate(key_parts)
    val_arr = np.concatenate(val_parts)
    scaled_arr = np.concatenate(scaled_parts)
    out = {"timeslot": np.concatenate(ts_parts)}
    col = 0
    for name in config.key_cols:
        width = lane_width(name)
        out[name] = (key_arr[:, col] if width == 1
                     else key_arr[:, col:col + 4])
        col += width
    for j, name in enumerate(config.value_cols):
        out[name] = val_arr[:, j]
    out["count"] = val_arr[:, nvals]
    for j, name in enumerate(config.value_cols):
        out[f"{name}_scaled"] = scaled_arr[:, j]
    return out
