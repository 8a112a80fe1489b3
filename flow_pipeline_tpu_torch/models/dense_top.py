"""Dense exact top-K for small key domains (the port tables), in torch.

Counterpart of flow_pipeline_tpu/models/dense_top.py: a 16-bit port
space fits an exact dense accumulator, so each batch is one scatter-add
and top-K is one sort of the totals.

Exactness: float32 sums lose increments past 2^24, so each value rides as
two 16-bit planes in int32 with a carry per sub-chunk:

    partial: scatter-add of (v & 0xFFFF, v >> 16) over <= 2^15-row
        sub-chunks, bounded by 2^15 * (2^16 - 1) < 2^31;
    fold (two-stage carry): the partial's lo plane normalizes to 16 bits
        first, then adds the carried-in lo; hi counts 2^16 units.

Integer scatters are exact in any order, so the card's atomics give the
CPU's bits. Ranking uses float32 (hi * 65536 + lo) * 2 + seen, evaluated
in the reference's order; the reported values are recombined exactly in
uint64 on the host.

The model has the HeavyHitterModel surface (update/top/reset), so the
port's WindowedHeavyHitter drives it (``model_cls=DenseTopKModel``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..schema.batch import FlowBatch
from ..schema.keys import MASK32, as_u32


@dataclass(frozen=True)
class DenseTopConfig:
    key_col: str = "src_port"
    # distinct key values; keys are ints in [0, domain), and rows whose
    # key falls outside are dropped (2^16 covers ports)
    domain: int = 1 << 16
    value_cols: tuple[str, ...] = ("bytes", "packets")  # plane 0 ranks
    batch_size: int = 8192
    # each value is multiplied by max(<scale_col>, 1) in uint32,
    # saturating at 2^32 - 1
    scale_col: str | None = "sampling_rate"


# Largest sub-chunk whose scatter partial stays int32-exact when every
# row lands on one cell with a saturated 16-bit plane: 2^15 * 0xFFFF
# = 0x7FFF8000 < 2^31.
_DENSE_SUB_MAX = 32768


def dense_input_cols(config: DenseTopConfig) -> list[str]:
    """Columns the update step reads: key + values + the scale column."""
    out = [config.key_col, *config.value_cols]
    if config.scale_col:
        out.append(config.scale_col)
    return out


def dense_init(config: DenseTopConfig, device=DEFAULT_DEVICE) -> torch.Tensor:
    """[domain, P+1, 2] int32 zeros: (lo, hi) planes per value column and
    the count."""
    return torch.zeros((config.domain, len(config.value_cols) + 1, 2),
                       dtype=torch.int32, device=device)


def _drop_index(key: torch.Tensor, domain: int) -> torch.Tensor:
    """Scatter index of each row, or ``domain`` (a scratch row that is cut
    off afterwards) for a row the reference's ``mode="drop"`` drops. As
    in the reference, a negative index in [-domain, 0) counts from the
    end; anything else outside [0, domain) is dropped, never wrapped."""
    idx = torch.where(key < 0, key + domain, key)
    return torch.where((idx >= 0) & (idx < domain), idx, domain)


def dense_update(totals: torch.Tensor, cols: dict, valid: torch.Tensor, *,
                 config: DenseTopConfig) -> torch.Tensor:
    """New totals after one batch. ``totals`` [domain, P+1, 2] int32 with
    lo normalized to [0, 2^16); ``cols`` int32 bit patterns of the
    FlowBatch columns. Exact for any batch size."""
    key_full = cols[config.key_col].to(torch.int64)
    # invalid rows -> index `domain`: out of range high, dropped
    key_full = torch.where(valid, key_full, config.domain)
    lanes = [as_u32(cols[name]) for name in config.value_cols]
    if config.scale_col:
        rate = torch.clamp(as_u32(cols[config.scale_col]), min=1)

        def _scale(v):
            # saturating u32 multiply: exact whenever v * rate < 2^32
            lim = MASK32 // torch.clamp(v, min=1)
            return torch.where(rate > lim, MASK32,
                               v * torch.minimum(rate, lim))
        lanes = [_scale(v) for v in lanes]
    lanes.append(torch.ones_like(key_full))  # count
    lo = torch.stack([(v & 0xFFFF).to(torch.int32) for v in lanes], dim=1)
    hi = torch.stack([(v >> 16).to(torch.int32) for v in lanes], dim=1)
    planes_full = torch.stack([lo, hi], dim=2)  # [N, P+1, 2]
    planes_full = torch.where(valid[:, None, None], planes_full, 0)
    domain = config.domain
    for start in range(0, key_full.shape[0], _DENSE_SUB_MAX):
        key = _drop_index(key_full[start:start + _DENSE_SUB_MAX], domain)
        planes = planes_full[start:start + _DENSE_SUB_MAX]
        partial = torch.zeros((domain + 1,) + tuple(totals.shape[1:]),
                              dtype=torch.int32, device=totals.device)
        partial = partial.index_add_(0, key, planes)[:domain]
        # two-stage carry: normalize the partial's lo plane, then add the
        # carried-in lo (< 2^16); both sums fit int32
        p_lo = partial[:, :, 0] & 0xFFFF
        p_carry = partial[:, :, 0] >> 16
        lo_sum = totals[:, :, 0] + p_lo
        new_lo = lo_sum & 0xFFFF
        carry = lo_sum >> 16
        new_hi = totals[:, :, 1] + partial[:, :, 1] + p_carry + carry
        totals = torch.stack([new_lo, new_hi], dim=2)
    return totals


def dense_top(totals: torch.Tensor, *, config: DenseTopConfig, k: int):
    """Rank by plane 0: (keys [k] int64, planes [k, P+1, 2], valid [k]).

    Validity comes from the count plane (a key seen only in zero-byte
    flows is a real row); the ranking carries a count-presence bit so such
    keys outrank never-seen cells. Ties (most ports sit at rank 0 or 1,
    and float32 rounds ranks above 2^24) go to the lower index first, as
    ``jax.lax.top_k`` orders them: a stable descending sort, not
    torch.topk, which promises no order among ties."""
    seen = (totals[:, -1, 0] + totals[:, -1, 1]) > 0  # count planes >= 0
    rank = (totals[:, 0, 1].to(torch.float32) * 65536.0
            + totals[:, 0, 0].to(torch.float32)) * 2.0 \
        + seen.to(torch.float32)
    _, order = torch.sort(rank, descending=True, stable=True)
    idx = order[:k]
    return idx, totals[idx], seen[idx]


def _planes_to_uint64(planes: np.ndarray) -> np.ndarray:
    """[..., 2] int32 (lo, hi) -> exact uint64 totals."""
    p = planes.astype(np.uint64)
    return p[..., 0] + (p[..., 1] << np.uint64(16))


def _top_from_totals(totals: torch.Tensor, config: DenseTopConfig,
                     k: int | None) -> dict[str, np.ndarray]:
    """Top-k rows from one totals tensor (the reference's dtypes: int32
    keys, uint64 values)."""
    k = min(k or 100, config.domain)
    idx, planes, valid = dense_top(totals, config=config, k=k)
    rows = _planes_to_uint64(planes.cpu().numpy())  # exact values
    out: dict[str, np.ndarray] = {
        config.key_col: idx.cpu().numpy().astype(np.int32)}
    for j, name in enumerate(config.value_cols):
        out[name] = rows[:, j]
    out["count"] = rows[:, -1]
    out["valid"] = valid.cpu().numpy()
    return out


class DenseTopKModel:
    """Host wrapper with the HeavyHitterModel surface (update/top/reset),
    so WindowedHeavyHitter drives it interchangeably."""

    snapshot_kind = "windowed_dense"  # the worker's checkpoint kind tag

    def __init__(self, config: DenseTopConfig = DenseTopConfig(),
                 device: str | torch.device = DEFAULT_DEVICE):
        self.config = config
        self.device = resolve_device(device)
        self.totals = dense_init(config, self.device)

    def update(self, batch: FlowBatch) -> None:
        bs = self.config.batch_size
        for start in range(0, len(batch), bs):
            padded, mask = batch.slice(start, start + bs).pad_to(bs)
            cols = padded.device_columns(dense_input_cols(self.config))
            cols = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                self.device) for k, v in cols.items()}
            self.totals = dense_update(
                self.totals, cols, torch.from_numpy(mask).to(self.device),
                config=self.config)

    def top(self, k: int | None = None) -> dict[str, np.ndarray]:
        return _top_from_totals(self.totals, self.config, k)

    def top_lazy(self, k: int | None = None):
        """Zero-arg closure giving top(k) of the totals as they are now
        (dense_update and reset() bind new tensors, so the capture stays
        valid after the model moves on)."""
        totals, config = self.totals, self.config
        return lambda: _top_from_totals(totals, config, k)

    def reset(self) -> None:
        self.totals = dense_init(self.config, self.device)
