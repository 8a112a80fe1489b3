"""DDoS spike detector: per-DstAddr EWMA + quantile sketch on Packets.

Counterpart of flow_pipeline_tpu/models/ddos.py, single-device:

- DstAddr hashes into an [M] bucket array; each detection sub-window
  scatter-adds the per-dst Packets sums (sampling-rate scaled) into the
  bucket rates.
- At sub-window close: z-score of each bucket's rate against its EW
  mean/variance baseline (ops/ewma.py) and the rate's rank against the
  population quantile sketch (ops/quantile.py). A bucket alarms when
  z >= z_threshold and rate >= quantile(q), after the warm-up windows.
- An [M, 4] witness store names the dst with the largest per-batch sum
  in each bucket this sub-window.

Witness ties: when two dsts of one bucket tie on the largest sum, the
reference's scatter-set writes them in row order on the CPU, so the last
tied row (the lexicographically largest dst, since groups come out in key
order) wins. The port pins that rule: the largest row index per bucket by
``scatter_reduce_("amax")``, then a gather. A plain index_put_ with
duplicate indices would leave the winner to the card's scheduling.

The normalized rate entropy and its EW baseline are kept as attributes
and published as the reference's ``flow_entropy`` and
``flow_entropy_baseline`` gauges.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..obs.metrics import REGISTRY
from ..ops import ewma as ewma_ops
from ..ops.quantile import QuantileSketchSpec
from ..ops.segment import sort_groupby_float
from ..schema.batch import FlowBatch
from ..schema.keys import as_u32

ENTROPY_GAUGE = ("flow_entropy",
                 "normalized Shannon entropy of per-bucket rates at the "
                 "last sub-window close (1 = uniform, -> 0 as one bucket "
                 "dominates)")
ENTROPY_BASELINE_GAUGE = ("flow_entropy_baseline",
                          "EW baseline of flow_entropy (fold weight "
                          "-ddos.entropy_alpha)")


@dataclass(frozen=True)
class DDoSConfig:
    n_buckets: int = 1 << 14  # 16384 dst buckets
    sub_window_seconds: int = 10  # detection cadence
    alpha: float = 0.3  # EW fold weight
    z_threshold: float = 4.0
    quantile: float = 0.99
    min_sigma: float = 4.0
    rel_sigma: float = 0.25  # sigma floor as a fraction of the EW mean
    warmup_windows: int = 3  # no alerts until the baseline folded this often
    batch_size: int = 8192
    value_col: str = "packets"
    rel_err: float = 0.01
    entropy_alpha: float = 0.1  # EW fold weight of the entropy baseline
    # rates reflect the traffic the samples represent (float32 multiply);
    # None disables
    scale_col: str | None = "sampling_rate"


def ddos_input_cols(config: DDoSConfig) -> list[str]:
    """Columns the accumulate step reads."""
    out = ["dst_addr", config.value_col]
    if config.scale_col:
        out.append(config.scale_col)
    return out


def rate_entropy(rates: np.ndarray) -> tuple[float, int]:
    """(normalized Shannon entropy, active buckets) of one sub-window's
    [M] bucket rates: -sum(p ln p) / ln(M) over the positive buckets
    (1.0 is mass uniform over ALL buckets); fewer than two positive
    buckets report 0. Float64 numpy on the host."""
    rates = np.asarray(rates, np.float64)
    m = rates.size
    pos = rates[rates > 0]
    active = int(pos.size)
    if active <= 1 or m < 2:
        return 0.0, active
    p = pos / pos.sum()
    return float(-(p * np.log(p)).sum() / np.log(m)), active


class DDoSState(NamedTuple):
    mean: torch.Tensor  # [M] float32
    var: torch.Tensor  # [M] float32
    seen: torch.Tensor  # [M] bool
    rates: torch.Tensor  # [M] float32, the current sub-window's
    hist: torch.Tensor  # [B] float32 quantile sketch of past rates
    addrs: torch.Tensor  # [M, 4] int64 holding the witness dst's uint32 words
    wmax: torch.Tensor  # [M] float32 largest per-dst sum this sub-window


def ddos_init(config: DDoSConfig, spec: QuantileSketchSpec,
              device=DEFAULT_DEVICE) -> DDoSState:
    mean, var, seen = ewma_ops.ewma_init(config.n_buckets, device)
    m = config.n_buckets
    return DDoSState(
        mean=mean, var=var, seen=seen,
        rates=torch.zeros(m, dtype=torch.float32, device=device),
        hist=spec.init(device),
        addrs=torch.zeros((m, 4), dtype=torch.int64, device=device),
        wmax=torch.zeros(m, dtype=torch.float32, device=device))


def _accumulate_grouped(state: DDoSState, uniq, dsums, row_valid,
                        config: DDoSConfig) -> DDoSState:
    """Scatter pre-aggregated per-dst sums into the current sub-window.
    ``uniq`` [N, 4] unique dst rows, ``dsums`` [N] float32, ``row_valid``
    [N] bool."""
    m = config.n_buckets
    buckets = ewma_ops.bucket_of(uniq, m)
    rates = ewma_ops.rate_accumulate(state.rates, buckets, dsums, row_valid)
    # invalid rows go to the scratch row m, cut off afterwards (the
    # reference's out-of-range-high index that mode="drop" discards)
    safe = torch.where(row_valid, buckets, m)
    masked = torch.where(row_valid, dsums, -1.0)
    wmax = torch.cat([state.wmax, state.wmax.new_zeros(1)]).scatter_reduce_(
        0, safe, masked, "amax")[:m]
    is_witness = row_valid & (masked >= wmax[buckets])
    # one winner per bucket: the last witness row, as the reference's
    # in-order scatter-set leaves it
    rows = torch.arange(uniq.shape[0], device=uniq.device)
    wb = torch.where(is_witness, buckets, m)
    last = torch.full((m + 1,), -1, dtype=torch.int64, device=uniq.device)
    last = last.scatter_reduce_(0, wb, torch.where(is_witness, rows, -1),
                                "amax")[:m]
    has = last >= 0
    addrs = torch.where(has[:, None], uniq[last.clamp(min=0)], state.addrs)
    return state._replace(rates=rates, addrs=addrs, wmax=wmax)


def ddos_accumulate(state: DDoSState, cols: dict, valid: torch.Tensor, *,
                    config: DDoSConfig) -> DDoSState:
    """Scatter one chunk into the current sub-window. The chunk is first
    collapsed to per-dst sums (lexicographic groupby), so the scatter sees
    each dst once and the witness is the dst with the largest sum."""
    dst = as_u32(cols["dst_addr"])
    # uint32 reinterpretation keeps saturated counters (>= 2^31) positive
    vals = as_u32(cols[config.value_col]).to(torch.float32)
    if config.scale_col:
        vals = vals * torch.clamp(
            as_u32(cols[config.scale_col]).to(torch.float32), min=1.0)
    uniq, sums, counts = sort_groupby_float(dst, vals[:, None], valid)
    return _accumulate_grouped(state, uniq, sums[:, 0], counts > 0, config)


def ddos_close_window(state: DDoSState, *, config: DDoSConfig,
                      spec: QuantileSketchSpec):
    """Close a sub-window: score, fold the baseline, reset the rates.

    Returns (new_state, z [M], rates [M])."""
    ew = (state.mean, state.var, state.seen)
    z = ewma_ops.zscores(ew, state.rates, config.min_sigma, config.rel_sigma)
    hist = spec.add(state.hist, state.rates, valid=state.rates > 0)
    mean, var, seen = ewma_ops.ewma_fold(ew, state.rates, config.alpha)
    new_state = state._replace(
        mean=mean, var=var, seen=seen, rates=torch.zeros_like(state.rates),
        hist=hist, wmax=torch.zeros_like(state.wmax))
    return new_state, z, state.rates


class DDoSDetector:
    """Host wrapper: feed batches; sub-windows close on time_received."""

    def __init__(self, config: DDoSConfig = DDoSConfig(),
                 device: str | torch.device = DEFAULT_DEVICE):
        self.config = config
        self.device = resolve_device(device)
        self.spec = QuantileSketchSpec(rel_err=config.rel_err)
        self.state = ddos_init(config, self.spec, self.device)
        self.current_sub = None  # sub-window start
        self.folds = 0  # closed sub-windows; alerts suppressed in warm-up
        self.alerts: list[dict] = []  # drained by the worker per flush
        self.recent = deque(maxlen=1000)  # kept for the live query API
        # rows of a closed sub-window (its rates already reset) are
        # dropped: folding them into the current one could fire spurious
        # alerts
        self.late_flows_dropped = 0
        # rate entropy of the last closed sub-window and its EW baseline
        # (None until a close with >= 2 active buckets)
        self.entropy: float | None = None
        self.entropy_baseline: float | None = None
        # registered eagerly: the gauges are on /metrics from the first
        # scrape, not only after the first close
        REGISTRY.gauge(*ENTROPY_GAUGE)
        REGISTRY.gauge(*ENTROPY_BASELINE_GAUGE)

    def update(self, batch: FlowBatch) -> None:
        if len(batch) == 0:
            return
        # split rows by sub-window (a batch may straddle boundaries)
        subs = (batch.columns["time_received"].astype(np.int64)
                // self.config.sub_window_seconds
                * self.config.sub_window_seconds)
        for sub in np.unique(subs):
            idx = np.flatnonzero(subs == sub)
            part = FlowBatch({k: v[idx] for k, v in batch.columns.items()},
                             batch.partition)
            sub = int(sub)
            if self.current_sub is None:
                self.current_sub = sub
            elif sub > self.current_sub:
                self.close_sub_window()
                self.current_sub = sub
            elif sub < self.current_sub:
                self.late_flows_dropped += len(part)
                continue
            self._accumulate(part)

    def _accumulate(self, batch: FlowBatch) -> None:
        bs = self.config.batch_size
        for start in range(0, len(batch), bs):  # chunk arbitrary batch sizes
            padded, mask = batch.slice(start, start + bs).pad_to(bs)
            cols = padded.device_columns(ddos_input_cols(self.config))
            cols = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                self.device) for k, v in cols.items()}
            self.state = ddos_accumulate(
                self.state, cols, torch.from_numpy(mask).to(self.device),
                config=self.config)

    def close_sub_window(self) -> list[dict]:
        """Score and roll the sub-window; returns (and records) new
        alerts."""
        self.state, z, rates = ddos_close_window(
            self.state, config=self.config, spec=self.spec)
        return self._emit_alerts(z, rates, self.state.hist,
                                 self.state.addrs)

    def _fold_entropy(self, rates: np.ndarray) -> None:
        """Publish the sub-window's rate entropy and fold its EW
        baseline, on every close (before the warm-up gate)."""
        h, active = rate_entropy(rates)
        self.entropy = h
        if active > 1:
            a = self.config.entropy_alpha
            self.entropy_baseline = (
                h if self.entropy_baseline is None
                else (1.0 - a) * self.entropy_baseline + a * h)
        REGISTRY.gauge(*ENTROPY_GAUGE).set(h)
        if self.entropy_baseline is not None:
            REGISTRY.gauge(*ENTROPY_BASELINE_GAUGE).set(
                self.entropy_baseline)

    def _emit_alerts(self, z, rates, hist, addrs) -> list[dict]:
        """Gating and alert construction."""
        rates = rates.cpu().numpy()
        self._fold_entropy(rates)
        self.folds += 1
        if self.folds <= self.config.warmup_windows:
            return []
        z = z.cpu().numpy()
        gate = self.spec.quantile(hist.cpu().numpy(), self.config.quantile)
        hot = np.nonzero(
            (z >= self.config.z_threshold) & (rates >= max(gate, 1.0)))[0]
        addrs = addrs.cpu().numpy().astype(np.uint32)
        new = [
            {
                "sub_window": self.current_sub,
                "bucket": int(b),
                "dst_addr": addrs[b],
                "rate": float(rates[b]),
                "zscore": float(z[b]),
                "baseline_quantile": float(gate),
            }
            for b in hot
        ]
        self.alerts.extend(new)
        self.recent.extend(new)
        return new
