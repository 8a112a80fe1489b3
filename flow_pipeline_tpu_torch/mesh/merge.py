"""The mesh's window-close merges: the monoid algebra, on the host.

Counterpart of flow_pipeline_tpu/mesh/merge.py, bit-equal to it on the
same payloads. The coordinator folds the members' serialized window
state (mesh/codec.py) without touching a device:

- exact window aggregates: per-key uint64 sum;
- CMS planes: element-wise uint64 sum (the count-min sketch is linear,
  so the sum of per-shard sketches is the sketch of the union stream;
  under conservative update a valid, slightly looser upper bound);
- top-K candidate tables: concatenate, sum per key, rank by the primary
  plane descending with the lexicographic tie-break, truncate to the
  capacity (with key-hash sharding the key sets are disjoint, so the
  merged values are exact);
- invertible planes: element-wise uint64 wrapping sum, the table then
  decoded once from the merged sketch;
- spread registers: element-wise uint8 max;
- dense accumulators: element-wise int64 sum of the (lo, hi) planes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..hostsketch.engine import inv_extract, np_cms_query
from ..models.heavy_hitter import HeavyHitterConfig, key_width
from ..ops.hostgroup import _lex_regroup
from ..schema.batch import lane_width

_SENTINEL = np.uint32(0xFFFFFFFF)


# ---- exact window aggregates ------------------------------------------------


def merge_wagg(payloads: list[dict], config=None) -> dict:
    """Fold wagg payloads (keys [G, L] u32, vals [G, V] u64) into one
    window-store dict {key tuple -> uint64 vector}. ``config`` is unused;
    every family's merge hook shares one signature."""
    real = [p for p in payloads if len(p["keys"])]
    if not real:
        return {}
    keys = np.concatenate([p["keys"].astype(np.uint32) for p in real])
    vals = np.concatenate([p["vals"].astype(np.uint64) for p in real])
    order, starts = _lex_regroup(keys)
    uniq = keys[order][starts]
    sums = np.add.reduceat(vals[order], starts, axis=0)
    return {tuple(int(x) for x in uniq[i]): sums[i]
            for i in range(len(starts))}


# ---- heavy-hitter sketch state ----------------------------------------------


def merge_hh(payloads: list[dict], config: HeavyHitterConfig) -> dict:
    """Fold hh payloads into one {cms, table_keys, table_vals}: the CMS
    by uint64 element sum, the tables by the table-table fold (every real
    row, per-key plane sums, ranked by plane 0 descending with the stable
    lexicographic tie-break, truncated to the capacity). Invertible
    payloads go to :func:`merge_hh_inv`; a family mixing both raises.
    The members' audit cohorts, carried in the payloads, fold too."""
    if any(p.get("kind") == "hh_inv" for p in payloads):
        if not all(p.get("kind") == "hh_inv" for p in payloads):
            raise ValueError(
                "cannot merge mixed hh/hh_inv payloads for one family "
                "— every member must run the same -hh.sketch")
        return merge_hh_inv(payloads, config)
    planes = len(config.value_cols) + 1
    kw = key_width(config)
    cms = np.zeros((planes, config.depth, config.width), np.uint64)
    rows_k, rows_v = [], []
    for p in payloads:
        cms += p["cms"].astype(np.uint64)
        tk = p["table_keys"].astype(np.uint32)
        tv = p["table_vals"].astype(np.float32)
        real = (tk != _SENTINEL).any(axis=1)
        rows_k.append(tk[real])
        rows_v.append(tv[real])
    new_keys = np.full((config.capacity, kw), _SENTINEL, np.uint32)
    new_vals = np.zeros((config.capacity, planes), np.float32)
    keys = np.concatenate(rows_k) if rows_k else new_keys[:0]
    vals = np.concatenate(rows_v) if rows_v else new_vals[:0]
    if len(keys):
        order, starts = _lex_regroup(keys)
        uniq = keys[order][starts]
        sums = np.add.reduceat(vals[order], starts,
                               axis=0).astype(np.float32)
        top = np.argsort(-sums[:, 0], kind="stable")[:config.capacity]
        new_keys[:len(top)] = uniq[top]
        new_vals[:len(top)] = sums[top]
    out = {"kind": "hh", "cms": cms, "table_keys": new_keys,
           "table_vals": new_vals}
    audits = [p["audit"] for p in payloads if p.get("audit") is not None]
    if audits:
        out["audit"] = merge_audit(audits)
    return out


def merge_hh_inv(payloads: list[dict], config: HeavyHitterConfig) -> dict:
    """Fold invertible payloads: the count, value and key-recovery planes
    by element-wise uint64 wrapping sum; the merged table is decoded once
    from the merged sketch (hostsketch/engine.py inv_extract), so the
    merged dict has the table fold's {cms, table_keys, table_vals}
    shape."""
    planes = len(config.value_cols) + 1
    kw = key_width(config)
    cms = np.zeros((planes, config.depth, config.width), np.uint64)
    keysum = np.zeros((config.depth, config.width, kw), np.uint64)
    keycheck = np.zeros((config.depth, config.width), np.uint64)
    with np.errstate(over="ignore"):
        for p in payloads:
            cms += np.asarray(p["cms"], dtype=np.uint64)
            keysum += np.asarray(p["keysum"], dtype=np.uint64)
            keycheck += np.asarray(p["keycheck"], dtype=np.uint64)
    table_keys, table_vals = inv_extract(
        {"cms": cms, "keysum": keysum, "keycheck": keycheck},
        config.capacity)
    out = {"kind": "hh", "cms": cms, "table_keys": table_keys,
           "table_vals": table_vals, "keysum": keysum,
           "keycheck": keycheck}
    audits = [p["audit"] for p in payloads if p.get("audit") is not None]
    if audits:
        out["audit"] = merge_audit(audits)
    return out


def merge_audit(parts: list[dict]) -> dict:
    """Fold audit partials ({keys [K, W] u32, vals [K, P+1] u64}) into
    one: per-key uint64 sums, keys in lexicographic order (the order the
    members serialize, so merging one part gives it back bit for bit)."""
    real = [p for p in parts if len(p["keys"])]
    evictions = int(sum(int(p.get("evictions", 0)) for p in parts))
    scale = int(max(int(p.get("scale", 1)) for p in parts))
    if not real:
        first = parts[0]
        return {"keys": first["keys"][:0].astype(np.uint32),
                "vals": first["vals"][:0].astype(np.uint64),
                "evictions": evictions, "scale": scale}
    keys = np.concatenate([p["keys"].astype(np.uint32) for p in real])
    vals = np.concatenate([p["vals"].astype(np.uint64) for p in real])
    order, starts = _lex_regroup(keys)
    return {"keys": np.ascontiguousarray(keys[order][starts]),
            "vals": np.add.reduceat(vals[order], starts, axis=0),
            "evictions": evictions, "scale": scale}


def hh_top_rows(merged: dict, config: HeavyHitterConfig, k: int,
                slot: int) -> dict[str, np.ndarray]:
    """Columnar top-k rows of one merged hh payload, shaped and typed as
    a single worker's window-close rows (the timeslot column included)."""
    k = min(k, config.capacity)
    keys = merged["table_keys"][:k]
    vals = merged["table_vals"][:k]
    valid = (keys != _SENTINEL).any(axis=1)
    ests = np_cms_query(merged["cms"], keys)[:k]
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
    out["timeslot"] = np.full(len(valid), slot, dtype=np.uint64)
    return out


# ---- spread (distinct-count) sketch state -----------------------------------


def merge_spread(payloads: list[dict], config) -> dict:
    """Fold spread payloads into one {regs, table_keys, table_metric}:
    the registers by element-wise uint8 max (exact for any split of the
    stream), the candidate tables by per-key sums of the admission
    metric, ranked descending with the stable lexicographic tie-break and
    truncated to the capacity. Reported spreads are decoded from the
    merged registers (spread_top_rows), never from the metric."""
    from ..models.spread import spread_key_width

    if any(p.get("kind") != "spread" for p in payloads):
        raise ValueError(
            "cannot merge mixed spread/non-spread payloads for one "
            "family — every member must run the same model kind")
    regs = np.zeros((config.depth, config.width, config.registers),
                    np.uint8)
    rows_k, rows_m = [], []
    for p in payloads:
        np.maximum(regs, np.asarray(p["regs"], dtype=np.uint8), out=regs)
        tk = p["table_keys"].astype(np.uint32)
        tm = p["table_metric"].astype(np.float32)
        real = (tk != _SENTINEL).any(axis=1)
        rows_k.append(tk[real])
        rows_m.append(tm[real])
    kw = spread_key_width(config)
    new_keys = np.full((config.capacity, kw), _SENTINEL, np.uint32)
    new_metric = np.zeros(config.capacity, np.float32)
    keys = np.concatenate(rows_k) if rows_k else new_keys[:0]
    metric = np.concatenate(rows_m) if rows_m else new_metric[:0]
    if len(keys):
        order, starts = _lex_regroup(keys)
        uniq = keys[order][starts]
        sums = np.add.reduceat(metric[order], starts).astype(np.float32)
        top = np.argsort(-sums, kind="stable")[:config.capacity]
        new_keys[:len(top)] = uniq[top]
        new_metric[:len(top)] = sums[top]
    return {"kind": "spread", "regs": regs, "table_keys": new_keys,
            "table_metric": new_metric}


def spread_top_rows(merged: dict, config, k: int,
                    slot: int) -> dict[str, np.ndarray]:
    """Columnar top-k rows of one merged spread payload (the shared
    decode-at-read extraction, models/spread.py spread_top_from), with
    the timeslot column."""
    from ..models.spread import spread_top_from

    top = spread_top_from(merged, config, k)
    top["timeslot"] = np.full(len(top["valid"]), slot, dtype=np.uint64)
    return top


# ---- dense accumulators -----------------------------------------------------


def merge_dense(payloads: list[dict], config=None) -> np.ndarray:
    """Element-wise int64 sum of dense (lo, hi) planes. ``config`` is
    unused; every family's merge hook shares one signature."""
    out = payloads[0]["totals"].astype(np.int64).copy()
    for p in payloads[1:]:
        out += p["totals"].astype(np.int64)
    return out


def dense_top_rows(totals: np.ndarray, config, k: int,
                   slot: int) -> dict[str, np.ndarray]:
    """Top-k rows of merged dense totals through the model's own exact
    extraction on the host (summed lo planes stay far below int32 before
    the exact lo + (hi << 16) recombination)."""
    from ..models.dense_top import _top_from_totals

    planes = torch.from_numpy(
        np.asarray(totals, dtype=np.int64).astype(np.int32))
    top = _top_from_totals(planes, config, k)
    top["timeslot"] = np.full(len(top["valid"]), slot, dtype=np.uint64)
    return top
