"""Heavy-hitter model: count-min sketch + top-K candidate table, in torch.

Counterpart of flow_pipeline_tpu/models/heavy_hitter.py. The table
family (``hh_sketch="table"``):

    batch columns
      -> hash groupby on the key tuple        (exact per-batch pre-agg)
      -> count-min update, conservative (default) or linear
                                              (CUDA kernels on a card)
      -> prefilter to 2*capacity candidates
      -> top-K table merge with CMS-seeded admission

State lives on the model's device for the whole window; the host sees
only the top-K rows at window close. Both CMS updates write the sketch
in place, so ``HHState.cms`` is the same tensor before and after
an update: nothing may hold the current state across one. ``reset()``
binds fresh tensors, so a closed window's state (WindowedHeavyHitter's
eager extraction, or a ``top_lazy`` capture) is never written again.

The invertible family (``hh_sketch="invertible"``) replaces the table
and its admission with key-recovery planes beside the CMS buckets (u64
wrap sums, ``InvState``, host numpy by design as in the reference): the
update is one per-bucket fold, and the heavy keys are decoded from the
sketch at window close (hostsketch/engine.py inv_extract). Its home is
the host sketch pipeline (hostsketch/pipeline.py); a model updated on
its own groups each chunk on the host and folds it with the numpy twin.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..ops import cms as cms_ops
from ..ops import cms_cuda
from ..ops import topk as topk_ops
from ..ops.segment import hash_groupby_float, hash_lanes
from ..schema.batch import FlowBatch, lane_width
from ..schema.keys import as_u32


@dataclass(frozen=True)
class HeavyHitterConfig:
    key_cols: tuple[str, ...] = ("src_addr", "dst_addr")
    value_cols: tuple[str, ...] = ("bytes", "packets")  # plane 0 ranks
    depth: int = 4
    width: int = 1 << 16
    # Conservative update (smaller overestimates, not mergeable) or the
    # linear one (exactly mergeable: per-shard sketches sum to the whole).
    conservative: bool = True
    capacity: int = 1024  # candidate table rows
    batch_size: int = 8192
    # Feed the table merge only 2*capacity candidates: the batch's top
    # groups by plane-0 sum plus every group whose key is already
    # resident in the table (see the reference's config docstring).
    table_prefilter: bool = True
    # "est": space-saving admission (topk_merge_est); "plain": batch-sum
    # merge (topk_merge), the reference's benchmarking leg.
    table_admission: str = "est"
    # Multiply every value plane by max(<scale_col>, 1) per row.
    scale_col: str | None = "sampling_rate"
    # Sketch family: "table" (CMS + top-K admission table) or
    # "invertible" (key-recovery planes decoded at window close; forces
    # the plain count-plane update, so conservative, table_prefilter and
    # table_admission do not apply to it).
    hh_sketch: str = "table"

    def __post_init__(self):
        if self.hh_sketch not in ("table", "invertible"):
            raise ValueError(
                f"hh_sketch must be table|invertible, got "
                f"{self.hh_sketch!r}")
        if self.table_admission not in ("est", "plain"):
            raise ValueError(
                f"table_admission must be est|plain, got "
                f"{self.table_admission!r}")


class HHState(NamedTuple):
    """Sketch state on the model's device."""

    cms: torch.Tensor  # [P+1, depth, width] float32 (value planes + count)
    table_keys: torch.Tensor  # [C, Wk] int64 holding uint32 lanes
    table_vals: torch.Tensor  # [C, P+1] float32


class InvState(NamedTuple):
    """Invertible-family state: exact uint64 planes, host numpy by design
    (a lane times a count does not fit a float layout, so the u64 monoid
    is the canonical form)."""

    cms: np.ndarray       # [P+1, depth, width] uint64
    keysum: np.ndarray    # [depth, width, key_width] uint64
    keycheck: np.ndarray  # [depth, width] uint64


def key_width(config: HeavyHitterConfig) -> int:
    return sum(lane_width(name) for name in config.key_cols)


def input_cols(config: HeavyHitterConfig) -> list[str]:
    """Columns the update step reads: keys + values + the scale column."""
    out = [*config.key_cols, *config.value_cols]
    if config.scale_col:
        out.append(config.scale_col)
    return out


def inv_init(config: HeavyHitterConfig) -> InvState:
    planes = len(config.value_cols) + 1  # + count
    w = key_width(config)
    return InvState(
        cms=np.zeros((planes, config.depth, config.width), np.uint64),
        keysum=np.zeros((config.depth, config.width, w), np.uint64),
        keycheck=np.zeros((config.depth, config.width), np.uint64))


def hh_init(config: HeavyHitterConfig,
            device: str | torch.device = DEFAULT_DEVICE):
    """A fresh state: HHState on ``device`` for the table family, a host
    InvState for the invertible family."""
    if config.hh_sketch == "invertible":
        return inv_init(config)
    dev = resolve_device(device)
    planes = len(config.value_cols) + 1  # + count
    tk, tv = topk_ops.topk_init(config.capacity, key_width(config), planes,
                                device=dev)
    return HHState(
        cms=cms_ops.cms_init(planes, config.depth, config.width, device=dev),
        table_keys=tk, table_vals=tv)


def _key_lanes(cols: dict, key_cols) -> torch.Tensor:
    """[N, Wk] int64 uint32 lanes in key-column order."""
    lanes = []
    for name in key_cols:
        arr = as_u32(cols[name])
        lanes.append(arr[:, None] if arr.dim() == 1 else arr)
    return torch.cat(lanes, dim=1)


def _cms_add(config: HeavyHitterConfig):
    """The CMS update op for ``config.conservative``. Both share
    ops/cms.py's bucket scheme and state layout, and each wrapper
    launches its CUDA kernel for a CUDA sketch and runs the plain version
    for a CPU one (the reference's ``cms_impl`` choice has no counterpart:
    the port has one route per device)."""
    return (cms_cuda.cms_add_conservative if config.conservative
            else cms_cuda.cms_add)


def _apply_grouped(state: HHState, uniq, sums, row_valid,
                   config: HeavyHitterConfig) -> HHState:
    """CMS + table merge over pre-aggregated groups. ``uniq`` [N, Wk]
    unique key rows, ``sums`` [N, P+1] float32 with the count plane last,
    ``row_valid`` [N] bool.

    With ``est`` admission the update also returns every group's
    estimate from the updated sketch (one launch on a card), so the
    table merge reads those instead of hashing the candidates again."""
    uniq = uniq.contiguous()
    admit_est = config.table_admission == "est"
    out = _cms_add(config)(state.cms, uniq, sums.contiguous(),
                           row_valid.contiguous(), with_estimate=admit_est)
    new_cms, est = out if admit_est else (out, None)
    if config.table_prefilter and uniq.shape[0] > 2 * config.capacity:
        # Residents are boosted to +inf so they always pass; membership
        # rides one 32-bit hash lane (no false negatives).
        c = config.capacity
        th, _ = hash_lanes(state.table_keys)
        gh, _ = hash_lanes(uniq)
        ts, _ = torch.sort(th)
        pos = torch.clamp(torch.searchsorted(ts, gh), 0, c - 1)
        resident = (ts[pos] == gh) & row_valid
        metric = torch.where(row_valid, sums[:, 0], float("-inf"))
        metric = torch.where(resident, float("inf"), metric)
        # jax.lax.top_k returns the lower index first among equal values;
        # a stable descending sort does the same (torch.topk promises no
        # order for ties).
        _, order = torch.sort(metric, descending=True, stable=True)
        sel = order[:2 * c]
        uniq, sums, row_valid = uniq[sel], sums[sel], row_valid[sel]
        if admit_est:
            est = est[sel]
    if not admit_est:
        tk, tv = topk_ops.topk_merge(
            state.table_keys, state.table_vals, uniq, sums, row_valid)
        return HHState(cms=new_cms, table_keys=tk, table_vals=tv)
    # Space-saving admission: new keys enter with their CMS estimate (the
    # sketch above counted the whole batch).
    tk, tv = topk_ops.topk_merge_est(
        state.table_keys, state.table_vals, uniq, sums, est, row_valid)
    return HHState(cms=new_cms, table_keys=tk, table_vals=tv)


def hh_update(state: HHState, cols: dict, valid: torch.Tensor, *,
              config: HeavyHitterConfig) -> HHState:
    """One batch step on the state's device. ``cols`` hold int32 bit
    patterns of the FlowBatch columns (FlowBatch.device_columns)."""
    keys = _key_lanes(cols, config.key_cols)
    # Reinterpret as unsigned before the float cast so saturated counters
    # (>= 2^31) stay positive.
    planes = [as_u32(cols[name]).to(torch.float32)
              for name in config.value_cols]
    if config.scale_col:
        rate = torch.clamp(as_u32(cols[config.scale_col]).to(torch.float32),
                           min=1.0)
        planes = [p * rate for p in planes]
    values = torch.stack(
        planes + [torch.ones(keys.shape[0], dtype=torch.float32,
                             device=keys.device)], dim=1)
    uniq, sums, counts = hash_groupby_float(keys, values, valid)
    return _apply_grouped(state, uniq, sums, counts > 0, config)


def hh_estimates(state: HHState) -> torch.Tensor:
    """CMS point estimates for every table key: [C, P+1] float32."""
    return cms_ops.cms_query(state.cms, state.table_keys)


def _top_from_state(state: HHState, config: HeavyHitterConfig,
                    k: int) -> dict[str, np.ndarray]:
    """Top-k rows as host numpy columns (the reference's dtypes: uint32
    keys, float32 values)."""
    keys, vals, valid = topk_ops.topk_extract(
        state.table_keys, state.table_vals, k)
    ests = hh_estimates(state)[:k]
    keys = keys.cpu().numpy().astype(np.uint32)
    vals = vals.cpu().numpy()
    ests = ests.cpu().numpy()
    valid = valid.cpu().numpy()
    out: dict[str, np.ndarray] = {}
    col = 0
    for name in config.key_cols:
        w = lane_width(name)
        out[name] = keys[:, col:col + w] if w == 4 else keys[:, col]
        col += w
    for j, name in enumerate(config.value_cols):
        out[name] = vals[:, j]
        out[f"{name}_est"] = ests[:, j]
    out["count"] = vals[:, -1]
    out["count_est"] = ests[:, -1]
    out["valid"] = valid
    return out


def _inv_top_from_state(state: InvState, config: HeavyHitterConfig,
                        k: int) -> dict[str, np.ndarray]:
    """Top-k rows of an invertible state: the heavy keys decoded from the
    sketch (hostsketch/engine.py inv_extract), ranked (primary desc, lex
    asc); the est columns are the CMS point estimates of the same
    planes. The table path's columns, shapes and dtypes."""
    from ..hostsketch.engine import inv_extract, np_cms_query

    keys, vals = inv_extract(state, config.capacity)
    keys, vals = keys[:k], vals[:k]
    valid = (keys != np.uint32(0xFFFFFFFF)).any(axis=1)
    ests = np_cms_query(np.asarray(state.cms), keys)
    out: dict[str, np.ndarray] = {}
    col = 0
    for name in config.key_cols:
        w = lane_width(name)
        out[name] = keys[:, col:col + w] if w == 4 else keys[:, col]
        col += w
    for j, name in enumerate(config.value_cols):
        out[name] = vals[:, j]
        out[f"{name}_est"] = ests[:, j]
    out["count"] = vals[:, -1]
    out["count_est"] = ests[:, -1]
    out["valid"] = valid
    return out


class HeavyHitterModel:
    """Host wrapper: feed batches, extract top-K at window close."""

    snapshot_kind = "windowed_hh"  # the worker's checkpoint kind tag

    def __init__(self, config: HeavyHitterConfig = HeavyHitterConfig(),
                 device: str | torch.device = DEFAULT_DEVICE):
        self.config = config
        self.device = resolve_device(device)
        self.state = hh_init(config, self.device)
        # padded chunks fed to hh_update: each is one CMS update (of the
        # config's kind)
        self.chunk_updates = 0

    def update(self, batch: FlowBatch) -> None:
        if self.config.hh_sketch == "invertible":
            self._inv_update(batch)
            return
        bs = self.config.batch_size
        for start in range(0, len(batch), bs):  # chunk arbitrary batch sizes
            padded, mask = batch.slice(start, start + bs).pad_to(bs)
            cols = padded.device_columns(input_cols(self.config))
            cols = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                self.device) for k, v in cols.items()}
            self.state = hh_update(
                self.state, cols, torch.from_numpy(mask).to(self.device),
                config=self.config)
            self.chunk_updates += 1

    def _inv_update(self, batch: FlowBatch) -> None:
        """The invertible family updated on its own (outside the host
        sketch pipeline): each chunk grouped as the staged prepare half
        groups it, then folded in place with the numpy twin."""
        from ..engine.hostfused import _key_lanes_into, _value_planes_np
        from ..hostsketch.engine import np_inv_update
        from ..ops.hostgroup import group_by_key

        cfg = self.config
        for start in range(0, len(batch), cfg.batch_size):
            chunk = batch.slice(start, start + cfg.batch_size)
            if len(chunk) == 0:
                continue
            cols = chunk.columns
            lanes = _key_lanes_into(cols, cfg.key_cols)
            vals = _value_planes_np(cols, cfg.value_cols, cfg.scale_col)
            uniq, sums, counts = group_by_key(lanes, [vals], exact=False)
            addends = np.concatenate(
                [sums[0].astype(np.float32),
                 counts.astype(np.float32)[:, None]], axis=1)
            np_inv_update(self.state, np.ascontiguousarray(
                uniq, dtype=np.uint32), addends)

    def top(self, k: int | None = None) -> dict[str, np.ndarray]:
        """Top-k rows: keys split back into columns, table values (which
        rank the rows and upper-bound true totals) and CMS estimates. The
        invertible family decodes its ranking from the sketch here, and
        its values are the keys' exact sums."""
        k = k or self.config.capacity
        if self.config.hh_sketch == "invertible":
            return _inv_top_from_state(self.state, self.config, k)
        return _top_from_state(self.state, self.config, k)

    def top_lazy(self, k: int | None = None):
        """Zero-arg closure giving top(k) of the state as it is now, for
        the ingest flusher. Valid once the model has moved to a fresh
        state (``reset()`` binds new tensors; the CMS updates write the
        current state in place), which is how the window wrapper uses it:
        capture, then reset."""
        state, config = self.state, self.config
        k = k or config.capacity
        if config.hh_sketch == "invertible":
            # the numpy fold writes these planes in place: capture copies
            state = InvState(state.cms.copy(), state.keysum.copy(),
                             state.keycheck.copy())
            return lambda: _inv_top_from_state(state, config, k)
        return lambda: _top_from_state(state, config, k)

    def reset(self) -> None:
        self.state = hh_init(self.config, self.device)
