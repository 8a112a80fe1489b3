"""Device-resident top-K candidate table, in torch.

Counterpart of flow_pipeline_tpu/ops/topk.py: a fixed-capacity table of
(key, value-vector) rows, merged with each batch's unique keys by a
sort/segment groupby and a ranking on plane 0. Ranking uses a STABLE
descending order (``torch.sort(-primary, stable=True)``, as
``jnp.argsort`` is stable), so equal values rank in group order: the
unsigned lexicographic key order that ``sort_groupby_float`` produces.
"""

from __future__ import annotations

import torch

from .segment import SENTINEL, sort_groupby_float


def topk_init(capacity: int, key_width: int, planes: int,
              device: str | torch.device = "cuda"):
    """Empty table: sentinel keys, zero values."""
    keys = torch.full((capacity, key_width), SENTINEL, dtype=torch.int64,
                      device=device)
    vals = torch.zeros((capacity, planes), dtype=torch.float32, device=device)
    return keys, vals


def _rank(uniq, vals, counts, c: int):
    real = counts > 0
    primary = torch.where(real, vals[:, 0], float("-inf"))
    _, order = torch.sort(-primary, stable=True)
    top = order[:c]
    new_keys = torch.where(real[top][:, None], uniq[top], SENTINEL)
    new_vals = torch.where(real[top][:, None], vals[top], 0.0)
    return new_keys, new_vals


def _table_valid(table_keys):
    return (table_keys != SENTINEL).any(dim=1)


def topk_merge(table_keys, table_vals, cand_keys, cand_vals, cand_valid):
    """Merge candidate rows into the table, summing duplicate keys;
    returns (keys, vals) of the same capacity ranked by plane 0
    descending. The all-sentinel key marks empty slots, so a real
    all-1s candidate is dropped (as in the reference)."""
    c = table_keys.shape[0]
    cand_valid = cand_valid & _table_valid(cand_keys)
    all_keys = torch.cat([table_keys, cand_keys.to(torch.int64)])
    all_vals = torch.cat([table_vals, cand_vals.to(torch.float32)])
    all_valid = torch.cat([_table_valid(table_keys), cand_valid])
    uniq, sums, counts = sort_groupby_float(all_keys, all_vals, all_valid)
    return _rank(uniq, sums, counts, c)


def topk_merge_est(table_keys, table_vals, cand_keys, cand_sums, cand_est,
                   cand_valid):
    """topk_merge with space-saving admission: a key already in the table
    takes its batch sums, a NEW key enters with its CMS estimate."""
    c, p = table_vals.shape
    n = cand_keys.shape[0]
    dev = table_vals.device
    cand_valid = cand_valid & _table_valid(cand_keys)
    all_keys = torch.cat([table_keys, cand_keys.to(torch.int64)])
    tz = torch.zeros_like(table_vals)
    cz = torch.zeros((n, p), dtype=torch.float32, device=dev)
    # planes: [table mass P | batch sums P | entry est P | is_table 1]
    t_rows = torch.cat(
        [table_vals, tz, tz, torch.ones((c, 1), device=dev)], dim=1)
    c_rows = torch.cat(
        [cz, cand_sums.to(torch.float32), cand_est.to(torch.float32),
         torch.zeros((n, 1), device=dev)], dim=1)
    all_vals = torch.cat([t_rows, c_rows])
    all_valid = torch.cat([_table_valid(table_keys), cand_valid])
    uniq, sums, counts = sort_groupby_float(all_keys, all_vals, all_valid)
    resident = sums[:, 3 * p] > 0
    vals = sums[:, :p] + torch.where(
        resident[:, None], sums[:, p:2 * p], sums[:, 2 * p:3 * p])
    return _rank(uniq, vals, counts, c)


def topk_extract(table_keys, table_vals, k: int):
    """Top-k rows (already ranked): (keys, vals, valid)."""
    return table_keys[:k], table_vals[:k], _table_valid(table_keys)[:k]
