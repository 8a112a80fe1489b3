"""Spread (distinct-count) model: per-key HLL register planes and a
candidate table ranked by spread.

Counterpart of flow_pipeline_tpu/models/spread.py. Where the heavy-hitter
family sums bytes and packets per key, the spread family counts the
DISTINCT values of ``elem_col`` per key (ops/spread.py has the register
protocol): superspreaders (src -> distinct dst addresses) and port scans
(src -> distinct dst ports).

Each update chunk:

- registers: the chunk is grouped to unique (key, element) pairs (the
  max monoid makes that equal to raw row updates), then scatter-maxed
  into the registers (hostsketch/engine.py np_spread_update);
- candidate table: the pairs are regrouped by key, and per-chunk
  distinct-pair counts accumulate in a sentinel-padded table as the
  admission metric. Reported spreads are decoded from the registers at
  extraction (np_spread_query), never taken from the metric.

The state is host numpy by design, on the card as on the CPU: u8
registers and u32 keys whose exact max monoid is the canonical form. The
update mutates ``regs`` in place, so a capture (top_lazy) copies.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np

from ..obs.metrics import REGISTRY
from ..schema.batch import FlowBatch, lane_width

_SENTINEL = np.uint32(0xFFFFFFFF)

# The largest decoded spread among a detector's extracted rows, labelled
# by its model name (the reference's alerting gauge).
SPREAD_TOP_GAUGE = ("spread_top_max",
                    "max register-decoded spread among the extracted "
                    "top rows, per spread detector model")


@dataclass(frozen=True)
class SpreadConfig:
    key_cols: tuple[str, ...] = ("src_addr",)
    elem_col: str = "dst_addr"  # the counted dimension
    depth: int = 2
    width: int = 1 << 12  # buckets per depth row
    registers: int = 64   # m u8 registers per bucket
    capacity: int = 512   # candidate table rows
    batch_size: int = 8192


class SpreadState(NamedTuple):
    """Host numpy spread state (the update writes ``regs`` in place)."""

    regs: np.ndarray          # [depth, width, m] uint8
    table_keys: np.ndarray    # [capacity, key_width] uint32
    table_metric: np.ndarray  # [capacity] float32 (admission metric)


def spread_key_width(config: SpreadConfig) -> int:
    return sum(lane_width(name) for name in config.key_cols)


def spread_init(config: SpreadConfig) -> SpreadState:
    if config.depth < 1 or config.width < 1 or config.registers < 2:
        raise ValueError(
            f"spread needs depth>=1, width>=1, registers>=2 "
            f"(got {config.depth}/{config.width}/{config.registers})")
    if config.elem_col in config.key_cols:
        raise ValueError(
            f"spread elem_col {config.elem_col!r} cannot be a key "
            f"column: a key always touches exactly one of itself")
    return SpreadState(
        regs=np.zeros((config.depth, config.width, config.registers),
                      np.uint8),
        table_keys=np.full((config.capacity, spread_key_width(config)),
                           _SENTINEL, np.uint32),
        table_metric=np.zeros(config.capacity, np.float32),
    )


def spread_top_from(state, config: SpreadConfig,
                    k: int) -> dict[str, np.ndarray]:
    """Top-k rows ranked by register-decoded spread, descending, ties in
    lexicographic key order. A pure function of (regs, table_keys,
    table_metric); ``state`` is a SpreadState or a checkpoint field
    dict."""
    from ..hostsketch.engine import np_spread_query

    if isinstance(state, dict):
        regs = np.asarray(state["regs"], np.uint8)
        tk = np.asarray(state["table_keys"], np.uint32)
        tm = np.asarray(state["table_metric"], np.float32)
    else:
        regs, tk, tm = state.regs, state.table_keys, state.table_metric
    kw = tk.shape[1]
    real = (tk != _SENTINEL).any(axis=1)
    keys = np.ascontiguousarray(tk[real], np.uint32)
    metric = np.asarray(tm, np.float32)[real]
    # lex-sort, then a stable sort by -spread: (spread desc, lex asc)
    lex = np.lexsort(keys.T[::-1])
    keys, metric = keys[lex], metric[lex]
    spread = np_spread_query(regs, keys).astype(np.float32)
    order = np.argsort(-spread, kind="stable")[:k]
    n = len(order)
    out_keys = np.full((k, kw), _SENTINEL, np.uint32)
    out_spread = np.zeros(k, np.float32)
    out_metric = np.zeros(k, np.float32)
    out_keys[:n] = keys[order]
    out_spread[:n] = spread[order]
    out_metric[:n] = metric[order]
    valid = np.zeros(k, bool)
    valid[:n] = True
    out: dict[str, np.ndarray] = {}
    col = 0
    for name in config.key_cols:
        w = lane_width(name)
        out[name] = out_keys[:, col:col + w] if w == 4 else out_keys[:, col]
        col += w
    out["spread"] = out_spread
    out["pairs"] = out_metric
    out["valid"] = valid
    return out


def spread_fold(state: SpreadState, config: SpreadConfig,
                pairs: np.ndarray, cand_keys: np.ndarray,
                cand_counts: np.ndarray) -> SpreadState:
    """Fold one chunk's unique (key, element) pair rows and its per-key
    distinct-pair counts into ``state``: registers in place, a new
    candidate table."""
    from ..hostsketch.engine import np_spread_table_merge, np_spread_update

    kw = spread_key_width(config)
    np_spread_update(state.regs, pairs[:, :kw], pairs[:, kw:])
    tk, tm = np_spread_table_merge(state.table_keys, state.table_metric,
                                   cand_keys, cand_counts)
    return SpreadState(state.regs, tk, tm)


def spread_prepare(pair_lanes: np.ndarray, kw: int, group):
    """(pairs [G, kw+ew] u32 unique (key, element) rows, cand_keys
    [Gk, kw] u32, cand_counts [Gk] f32 distinct pairs per key) of one
    chunk's [N, kw+ew] pair lanes, grouped with ``group(lanes, planes,
    exact)`` (ops/hostgroup.py group_by_key or a sharded twin; the group
    order is irrelevant to the fold)."""
    pairs, _, _ = group(pair_lanes, [], False)
    pairs = np.ascontiguousarray(pairs, dtype=np.uint32)
    cand_keys, _, pair_counts = group(
        np.ascontiguousarray(pairs[:, :kw]), [], False)
    return (pairs, np.ascontiguousarray(cand_keys, np.uint32),
            pair_counts.astype(np.float32))


class SpreadModel:
    """Host wrapper with the HeavyHitterModel surface (update, top,
    top_lazy, reset, snapshot_kind), so the window wrapper, the worker's
    flush and checkpoint drive it unchanged. ``device`` is accepted for
    the wrapper's signature; the state stays on the host."""

    snapshot_kind = "windowed_spread"  # the worker's checkpoint kind tag

    def __init__(self, config: SpreadConfig = SpreadConfig(), device=None):
        self.config = config
        self.state = spread_init(config)
        # detector name for the alerting gauge (the CLI sets it; None
        # keeps extraction metric-silent)
        self.metric_label: str | None = None
        REGISTRY.gauge(*SPREAD_TOP_GAUGE)

    def update(self, batch: FlowBatch) -> None:
        """Fold a batch chunk by chunk (the host-grouped pipeline folds
        prepared pair tables instead: the same registers and table)."""
        from ..engine.hostfused import _key_lanes_into
        from ..ops.hostgroup import group_by_key

        cfg = self.config
        kw = spread_key_width(cfg)
        bs = cfg.batch_size
        for start in range(0, len(batch), bs):
            chunk = batch.slice(start, start + bs)
            if len(chunk) == 0:
                continue
            lanes = _key_lanes_into(chunk.columns,
                                  (*cfg.key_cols, cfg.elem_col))
            self.state = spread_fold(self.state, cfg,
                                     *spread_prepare(lanes, kw, group_by_key))

    def _publish(self, top: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        if self.metric_label is not None:
            peak = float(top["spread"][0]) if top["valid"].any() else 0.0
            REGISTRY.gauge(*SPREAD_TOP_GAUGE).set(
                peak, model=self.metric_label)
        return top

    def top(self, k: int | None = None) -> dict[str, np.ndarray]:
        """Top-k rows by decoded spread; ``pairs`` is the accumulated
        admission metric (an upper bound on the true distinct count)."""
        k = k or self.config.capacity
        return self._publish(spread_top_from(self.state, self.config, k))

    def top_lazy(self, k: int | None = None):
        """Zero-arg closure giving top(k) of the state as it is NOW. The
        update writes the registers in place, so the capture copies."""
        config = self.config
        k = k or config.capacity
        state = SpreadState(self.state.regs.copy(),
                            self.state.table_keys.copy(),
                            self.state.table_metric.copy())
        return lambda: self._publish(spread_top_from(state, config, k))

    def reset(self) -> None:
        self.state = spread_init(self.config)
