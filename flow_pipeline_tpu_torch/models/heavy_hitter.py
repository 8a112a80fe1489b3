"""Heavy-hitter model: count-min sketch + top-K candidate table, in torch.

Counterpart of flow_pipeline_tpu/models/heavy_hitter.py, table family
only:

    batch columns
      -> hash groupby on the key tuple        (exact per-batch pre-agg)
      -> conservative count-min update        (the CUDA kernel on a card)
      -> prefilter to 2*capacity candidates
      -> top-K table merge with CMS-seeded admission

State lives on the model's device for the whole window; the host sees
only the top-K rows at window close. The conservative update writes the
sketch in place, so ``HHState.cms`` is the same tensor before and after
an update: nothing may hold an old state across one
(WindowedHeavyHitter extracts before it resets, which is safe).
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
    # Only the "table" family is ported; "invertible" is refused.
    hh_sketch: str = "table"

    def __post_init__(self):
        if self.hh_sketch != "table":
            raise ValueError(
                f"hh_sketch={self.hh_sketch!r} is not ported: the port "
                "has the table family only (the invertible family is "
                "queued in ROADMAP.md)")
        if self.table_admission not in ("est", "plain"):
            raise ValueError(
                f"table_admission must be est|plain, got "
                f"{self.table_admission!r}")


class HHState(NamedTuple):
    """Sketch state on the model's device."""

    cms: torch.Tensor  # [P+1, depth, width] float32 (value planes + count)
    table_keys: torch.Tensor  # [C, Wk] int64 holding uint32 lanes
    table_vals: torch.Tensor  # [C, P+1] float32


def key_width(config: HeavyHitterConfig) -> int:
    return sum(lane_width(name) for name in config.key_cols)


def input_cols(config: HeavyHitterConfig) -> list[str]:
    """Columns the update step reads: keys + values + the scale column."""
    out = [*config.key_cols, *config.value_cols]
    if config.scale_col:
        out.append(config.scale_col)
    return out


def hh_init(config: HeavyHitterConfig,
            device: str | torch.device = DEFAULT_DEVICE) -> HHState:
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


def _apply_grouped(state: HHState, uniq, sums, row_valid,
                   config: HeavyHitterConfig) -> HHState:
    """CMS + table merge over pre-aggregated groups. ``uniq`` [N, Wk]
    unique key rows, ``sums`` [N, P+1] float32 with the count plane last,
    ``row_valid`` [N] bool."""
    # the conservative update (the reference's default; the linear one is
    # not ported): the CUDA kernel for a CUDA sketch, the plain version
    # for a CPU one
    new_cms = cms_cuda.cms_add_conservative(
        state.cms, uniq.contiguous(), sums.contiguous(),
        row_valid.contiguous())
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
    if config.table_admission == "plain":
        tk, tv = topk_ops.topk_merge(
            state.table_keys, state.table_vals, uniq, sums, row_valid)
        return HHState(cms=new_cms, table_keys=tk, table_vals=tv)
    # Space-saving admission: new keys enter with their CMS estimate (the
    # sketch above counted the whole batch).
    est = cms_ops.cms_query(new_cms, uniq)
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


class HeavyHitterModel:
    """Host wrapper: feed batches, extract top-K at window close."""

    def __init__(self, config: HeavyHitterConfig = HeavyHitterConfig(),
                 device: str | torch.device = DEFAULT_DEVICE):
        self.config = config
        self.device = resolve_device(device)
        self.state = hh_init(config, self.device)
        # padded chunks fed to hh_update: each is one CMS update
        self.chunk_updates = 0

    def update(self, batch: FlowBatch) -> None:
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

    def top(self, k: int | None = None) -> dict[str, np.ndarray]:
        """Top-k rows: keys split back into columns, table values (which
        rank the rows and upper-bound true totals) and CMS estimates."""
        return _top_from_state(self.state, self.config,
                               k or self.config.capacity)

    def reset(self) -> None:
        self.state = hh_init(self.config, self.device)
