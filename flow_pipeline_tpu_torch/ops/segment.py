"""Sort-based exact groupby, in torch.

Counterpart of flow_pipeline_tpu/ops/segment.py: the 64-bit hash sort
and its groupings (``hash_groupby_float`` for the heavy-hitter path,
``hash_groupby`` with its collision flag for flows_5m), and the
lexicographic groupbys (``sort_groupby_float`` for the top-K merge and
the DDoS detector, ``sort_groupby`` for flows_5m's exact fallback).

Key lanes are int64 tensors holding uint32 values (schema/keys.py says
why). Group ORDER is part of the contract: the top-K merge breaks rank
ties by position, so groups must come out in the reference's order —
unsigned ``(h1, h2)`` order for the hash path, unsigned lexicographic
key order for the sort path. Shapes are static as in the reference: N
rows in, N group slots out, reality judged by ``counts > 0``.
"""

from __future__ import annotations

import torch

from ..schema.keys import MASK32, as_u32, fmix32, mul32, rotl32

SENTINEL = MASK32

# Two decorrelated odd multipliers and seeds for the paired 32-bit mixes
# that form the 64-bit grouping hash (the reference's constants).
_HASH_MULT = (0x9E3779B1, 0x85EBCA77)
_HASH_SEED = (0x2545F491, 0x27220A95)


def hash_lanes(keys: torch.Tensor):
    """Two independent 32-bit mixes of each [N, W] key row.

    Returns (h1, h2), each [N] int64 holding a uint32."""
    n, w = keys.shape
    ku = as_u32(keys)
    out = []
    for mult, seed in zip(_HASH_MULT, _HASH_SEED):
        h = torch.full((n,), seed, dtype=torch.int64, device=keys.device)
        for i in range(w):
            h = mul32(h ^ ku[:, i], mult)
            h = rotl32(h, 13)
        out.append(fmix32(h))
    return out[0], out[1]


def _u64_order_key(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """One int64 whose signed order is the unsigned order of (h1, h2).

    A plain ``(h1 << 32) | h2`` sorts wrong when h1 >= 2^31 (it turns
    negative); shifting h1 down by 2^31 first maps [0, 2^32) onto the
    signed range, and the product stays inside int64."""
    return (h1 - (1 << 31)) * (1 << 32) + h2


def hash_sort(keys: torch.Tensor, valid: torch.Tensor):
    """Sort rows by the 64-bit hash of their key tuple. Invalid rows hash
    to the all-1s sentinel pair and sort last.

    Returns (sorted_hashes [N, 2] int64, perm [N] int64)."""
    h1, h2 = hash_lanes(keys)
    h1 = torch.where(valid, h1, SENTINEL)
    h2 = torch.where(valid, h2, SENTINEL)
    _, perm = torch.sort(_u64_order_key(h1, h2), stable=True)
    return torch.stack([h1[perm], h2[perm]], dim=1), perm


def presorted_segments(sorted_keys: torch.Tensor) -> torch.Tensor:
    """Segment ids [N] int64 for rows already in key order: a new segment
    starts wherever a row differs from the one before it."""
    n, w = sorted_keys.shape
    is_boundary = torch.ones(n, dtype=torch.bool, device=sorted_keys.device)
    if n > 1:
        is_boundary[1:] = (sorted_keys[1:] != sorted_keys[:-1]).any(dim=1)
    return torch.cumsum(is_boundary.to(torch.int64), 0) - 1


def segment_sum(vals: torch.Tensor, seg_ids: torch.Tensor,
                n: int) -> torch.Tensor:
    out = torch.zeros((n,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, seg_ids, vals)


def _segment_min_keys(keys: torch.Tensor, seg_ids: torch.Tensor,
                      n: int) -> torch.Tensor:
    """Lane-wise min of [N, W] key rows per segment; empty segments keep
    the sentinel (the identity of min over uint32)."""
    out = torch.full((n, keys.shape[1]), SENTINEL, dtype=torch.int64,
                     device=keys.device)
    idx = seg_ids[:, None].expand_as(keys)
    return out.scatter_reduce_(0, idx, keys, "amin", include_self=False)


def _hash_grouped(sorted_hashes, sorted_keys, sorted_vals, sorted_cnt,
                  detect: bool = False):
    """Segment reductions over rows already hash-sorted. The reported key
    is the per-group lane-wise min of the real keys (two tuples colliding
    in the full 64-bit hash merge into one group, as in the reference).
    With ``detect`` a fourth result is a 0-dim bool tensor, True iff some
    group held two different real key tuples (a 64-bit hash collision);
    it stays on the device until the caller reads it."""
    n = sorted_hashes.shape[0]
    seg_ids = presorted_segments(sorted_hashes)
    sums = segment_sum(sorted_vals, seg_ids, n)
    counts = segment_sum(sorted_cnt, seg_ids, n)
    uniq = _segment_min_keys(sorted_keys, seg_ids, n)
    real = counts > 0
    sums = torch.where(real[:, None], sums, torch.zeros_like(sums[:1]))
    uniq = torch.where(real[:, None], uniq, SENTINEL)
    counts = torch.where(real, counts, 0)
    if not detect:
        return uniq, sums, counts
    rep_rows = uniq[seg_ids]  # [N, W] group representative per row
    mismatch = (sorted_keys != rep_rows).any(dim=1) & (sorted_cnt > 0)
    return uniq, sums, counts, mismatch.any()


def hash_groupby_float(keys: torch.Tensor, values: torch.Tensor,
                       valid: torch.Tensor):
    """Groupby-sum of float value planes via the 64-bit hash sort.

    Returns (uniq [N, W] int64, sums [N, P] float32, counts [N] int32).
    Groups come out in unsigned (h1, h2) order, padding last."""
    ku = torch.where(valid[:, None], as_u32(keys), SENTINEL)
    fv = torch.where(valid[:, None], values.to(torch.float32), 0.0)
    cnt = valid.to(torch.int32)
    sh, perm = hash_sort(keys, valid)
    return _hash_grouped(sh, ku[perm], fv[perm], cnt[perm])


def hash_groupby(keys: torch.Tensor, values: torch.Tensor,
                 valid: torch.Tensor):
    """sort_groupby semantics (int32 planes + n_groups) via the hash sort,
    plus the collision flag: the exact aggregator's fast path.

    Returns (unique_keys [N, W] int64, sums [N, V] int32, counts [N]
    int32, n_groups 0-dim int32, collided 0-dim bool). Real groups fill a
    contiguous prefix (padding hashes to the sentinel pair and sorts
    last). Callers must honor ``collided`` (re-run through sort_groupby)
    to stay bit-exact. Integer sums are exact in any order, so the card's
    atomic index_add_ gives the same bits as the CPU."""
    ku = torch.where(valid[:, None], as_u32(keys), SENTINEL)
    vals = torch.where(valid[:, None], values.to(torch.int32), 0)
    cnt = valid.to(torch.int32)
    sh, perm = hash_sort(keys, valid)
    uniq, sums, counts, collided = _hash_grouped(
        sh, ku[perm], vals[perm], cnt[perm], detect=True)
    n_groups = (counts > 0).sum(dtype=torch.int32)
    return uniq, sums, counts, n_groups, collided


def _lex_perm(ku: torch.Tensor) -> torch.Tensor:
    """Permutation that sorts [N, W] uint32 lanes (int64 carriers)
    lexicographically: a chain of stable sorts from the last lane to the
    first, so equal rows keep their input order."""
    n, w = ku.shape
    perm = torch.arange(n, device=ku.device)
    for i in reversed(range(w)):
        _, order = torch.sort(ku[perm, i], stable=True)
        perm = perm[order]
    return perm


def sort_groupby(keys: torch.Tensor, values: torch.Tensor,
                 valid: torch.Tensor):
    """Exact groupby-sum of int32 ``values`` by row-tuples of ``keys``,
    groups in unsigned lexicographic key order.

    Returns (unique_keys [N, W] int64, sums [N, V] int32, counts [N]
    int32, n_groups 0-dim int32). Rows >= n_groups are padding (sentinel
    keys, zero sums); reality is judged by counts (see the reference's
    sentinel caveat: a valid all-1s key shares the padding segment)."""
    n = keys.shape[0]
    ku = torch.where(valid[:, None], as_u32(keys), SENTINEL)
    vals = torch.where(valid[:, None], values.to(torch.int32), 0)
    cnt = valid.to(torch.int32)
    perm = _lex_perm(ku)
    sk = ku[perm]
    seg_ids = presorted_segments(sk)
    sums = segment_sum(vals[perm], seg_ids, n)
    counts = segment_sum(cnt[perm], seg_ids, n)
    uniq = torch.full_like(sk, SENTINEL)
    uniq[seg_ids] = sk  # keys are constant within a segment
    real = counts > 0
    sums = torch.where(real[:, None], sums, 0)
    uniq = torch.where(real[:, None], uniq, SENTINEL)
    return uniq, sums, counts, real.sum(dtype=torch.int32)


def sort_rows_float(keys: torch.Tensor, values: torch.Tensor,
                    valid: torch.Tensor):
    """Unsigned lexicographic row sort with float payload riding along.
    Invalid rows get all-sentinel keys (they sort last) and zeroed
    payload/count.

    The multi-key sort is a chain of stable sorts from the last lane to
    the first (least significant first), so rows are ordered by lane 0,
    then lane 1, and so on; equal rows keep their input order.

    Returns (sorted_keys [N, W] int64, sorted_vals [N, P] float32,
    sorted_cnt [N] int32)."""
    ku = torch.where(valid[:, None], as_u32(keys), SENTINEL)
    fv = torch.where(valid[:, None], values.to(torch.float32), 0.0)
    cnt = valid.to(torch.int32)
    perm = _lex_perm(ku)
    return ku[perm], fv[perm], cnt[perm]


def presorted_groupby_float(sorted_keys, sorted_vals, sorted_cnt):
    """Groupby of presorted float payload rows. Keys are constant within
    a segment, so every row writes the same group key."""
    n = sorted_keys.shape[0]
    seg_ids = presorted_segments(sorted_keys)
    sums = segment_sum(sorted_vals, seg_ids, n)
    counts = segment_sum(sorted_cnt, seg_ids, n)
    uniq = torch.full_like(sorted_keys, SENTINEL)
    uniq[seg_ids] = sorted_keys
    real = counts > 0
    sums = torch.where(real[:, None], sums, 0.0)
    uniq = torch.where(real[:, None], uniq, SENTINEL)
    counts = torch.where(real, counts, 0)
    return uniq, sums, counts


def sort_groupby_float(keys: torch.Tensor, values: torch.Tensor,
                       valid: torch.Tensor):
    """Exact groupby-sum of float planes by row-tuples of ``keys``, groups
    in unsigned lexicographic key order.

    Returns (unique_keys [N, W] int64, sums [N, P] float32,
    counts [N] int32); rows with counts == 0 are padding (sentinel keys,
    zero sums)."""
    return presorted_groupby_float(*sort_rows_float(keys, values, valid))
