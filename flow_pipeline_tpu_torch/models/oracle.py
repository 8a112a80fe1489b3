"""Exact aggregation oracle (numpy, host-side).

Copy of flow_pipeline_tpu/models/oracle.py's exact groupby: uint64-exact
per-key sums of any key tuple, optionally per 5-minute timeslot (the
reference's ClickHouse ``toStartOfFiveMinute``). The ground truth the
heavy-hitter tables are checked against (chip_smoke.py ranks it for the
exact top-K). Slow is fine, wrong is not.
"""

from __future__ import annotations

import numpy as np

from ..schema.batch import FlowBatch

SECONDS_PER_SLOT = 300  # toStartOfFiveMinute


def _key_matrix(batch: FlowBatch, key_cols: list[str], timeslot: bool) -> np.ndarray:
    """Stack key columns into an [N, W] uint64 matrix (addresses expand to
    4 words each) for lexicographic row grouping."""
    lanes = []
    if timeslot:
        ts = batch.columns["time_received"].astype(np.uint64)
        lanes.append((ts // SECONDS_PER_SLOT * SECONDS_PER_SLOT)[:, None])
    for name in key_cols:
        arr = batch.columns[name]
        if arr.ndim == 2:
            lanes.append(arr.astype(np.uint64))
        else:
            lanes.append(arr.astype(np.uint64)[:, None])
    return np.concatenate(lanes, axis=1)


def exact_groupby(
    batch: FlowBatch,
    key_cols: list[str],
    value_cols: list[str] = ("bytes", "packets"),
    timeslot: bool = True,
    scale_col: str | None = None,
) -> dict[str, np.ndarray]:
    """Exact groupby-sum over arbitrary key tuples.

    Returns a dict with one array per key column (addresses as [G,4]),
    optionally a leading ``timeslot`` key, summed ``value_cols`` (uint64),
    and ``count``. Rows are in lexicographic key order.

    With ``scale_col`` the dict additionally carries exact uint64
    ``<value>_scaled`` sums of value * max(rate, 1) — the reference's
    query-time ``sum(Bytes*SamplingRate)`` semantics
    (ref: compose/grafana/dashboards/viz-ch.json), ground truth for the
    sampling-corrected serving path.
    """
    keys = _key_matrix(batch, key_cols, timeslot)
    # Row-wise unique via void view (contiguous rows as opaque keys)
    kc = np.ascontiguousarray(keys)
    voided = kc.view([("", kc.dtype)] * kc.shape[1]).reshape(-1)
    uniq, inverse = np.unique(voided, return_inverse=True)
    g = len(uniq)
    uniq_rows = uniq.view(kc.dtype).reshape(g, kc.shape[1])

    out: dict[str, np.ndarray] = {}
    col_idx = 0
    if timeslot:
        out["timeslot"] = uniq_rows[:, 0]
        col_idx = 1
    for name in key_cols:
        arr = batch.columns[name]
        w = 4 if arr.ndim == 2 else 1
        cols = uniq_rows[:, col_idx : col_idx + w]
        out[name] = cols if w == 4 else cols[:, 0]
        col_idx += w
    rate = None
    if scale_col is not None:
        rate = np.maximum(batch.columns[scale_col].astype(np.uint64), 1)
    for name in value_cols:
        # np.add.at, not float bincount: uint64-exact accumulation
        vals = batch.columns[name].astype(np.uint64)
        acc = np.zeros(g, dtype=np.uint64)
        np.add.at(acc, inverse, vals)
        out[name] = acc
        if rate is not None:
            sacc = np.zeros(g, dtype=np.uint64)
            np.add.at(sacc, inverse, vals * rate)
            out[f"{name}_scaled"] = sacc
    out["count"] = np.bincount(inverse, minlength=g).astype(np.uint64)
    return out
