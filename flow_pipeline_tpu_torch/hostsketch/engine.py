"""Host (numpy) twins of the sketch updates: the spread family's part.

Counterpart of the numpy half of flow_pipeline_tpu/hostsketch/engine.py,
limited to what the spread family needs: the murmur3 hash over uint32
word lanes, the count-min bucket rows, the candidate-table merge and the
spread register update, query and table merge. The reference routes the
register update through its native ``hs_spread_update`` when that library
is built; both give the same registers (an integer max is order-free), so
the port always takes the numpy route here.
"""

from __future__ import annotations

import numpy as np

from ..ops.spread import (SPREAD_REG_SEED, SPREAD_RHO_SEED, SPREAD_RHO_ZERO,
                          spread_decode)

_SENTINEL = np.uint32(0xFFFFFFFF)

_C1 = np.uint32(0xCC9E2D51)
_C2 = np.uint32(0x1B873593)
_FMIX1 = np.uint32(0x85EBCA6B)
_FMIX2 = np.uint32(0xC2B2AE35)


def hash_words_np(words: np.ndarray, seed: int = 0) -> np.ndarray:
    """murmur3_x86_32 over uint32 word lanes [..., W] -> uint32 [...]
    (schema/keys.py hash_words in numpy)."""
    w = np.asarray(words, dtype=np.uint32)
    with np.errstate(over="ignore"):  # uint32 wraparound is the algorithm
        h = np.full(w.shape[:-1], np.uint32(seed), dtype=np.uint32)
        nwords = w.shape[-1]
        for i in range(nwords):
            k = w[..., i].copy()
            k *= _C1
            k = ((k << np.uint32(15)) | (k >> np.uint32(17))).astype(np.uint32)
            k *= _C2
            h ^= k
            h = ((h << np.uint32(13)) | (h >> np.uint32(19))).astype(np.uint32)
            h = h * np.uint32(5) + np.uint32(0xE6546B64)
        h ^= np.uint32(nwords * 4)
        h ^= h >> np.uint32(16)
        h *= _FMIX1
        h ^= h >> np.uint32(13)
        h *= _FMIX2
        h ^= h >> np.uint32(16)
    return h


def _np_buckets(keys: np.ndarray, depth: int, width: int) -> np.ndarray:
    """[depth, n] int64 bucket indices (ops/cms.py cms_buckets in numpy)."""
    out = np.empty((depth, keys.shape[0]), np.int64)
    for d in range(depth):
        h = hash_words_np(keys, seed=d)
        out[d] = (h % np.uint32(width)).astype(np.int64)
    return out


def np_topk_merge(table_keys: np.ndarray, table_vals: np.ndarray,
                  cand_keys: np.ndarray, cand_sums: np.ndarray,
                  cand_est: np.ndarray):
    """ops/topk.py topk_merge_est on the host (cand_est = cand_sums gives
    the plain batch-sum merge). Returns (new_keys [cap, kw] uint32
    sentinel-padded, new_vals [cap, planes] float32), ranked by plane 0
    descending with lexicographic key order on ties."""
    cap, kw = table_keys.shape
    planes = table_vals.shape[1]
    t_real = (table_keys != _SENTINEL).any(axis=1)
    # the all-sentinel key marks empty slots: never a candidate
    c_real = (cand_keys != _SENTINEL).any(axis=1)
    n_t = int(t_real.sum())
    keys = np.concatenate([table_keys[t_real],
                           cand_keys[c_real].astype(np.uint32)])
    zeros_t = np.zeros((n_t, planes), np.float32)
    zeros_c = np.zeros((int(c_real.sum()), planes), np.float32)
    tvals = np.concatenate([table_vals[t_real], zeros_c])
    csums = np.concatenate([zeros_t, cand_sums[c_real].astype(np.float32)])
    cests = np.concatenate([zeros_t, cand_est[c_real].astype(np.float32)])
    is_table = np.zeros(len(keys), bool)
    is_table[:n_t] = True
    if len(keys) == 0:
        return (np.full((cap, kw), _SENTINEL, np.uint32),
                np.zeros((cap, planes), np.float32))
    # group by key in lexicographic order (the tie-break baseline)
    order = np.lexsort(keys.T[::-1])
    sk = keys[order]
    boundary = np.empty(len(keys), bool)
    boundary[0] = True
    np.any(sk[1:] != sk[:-1], axis=1, out=boundary[1:])
    starts = np.flatnonzero(boundary)
    uniq = sk[starts]
    g_t = np.add.reduceat(tvals[order], starts, axis=0)
    g_s = np.add.reduceat(csums[order], starts, axis=0)
    g_e = np.add.reduceat(cests[order], starts, axis=0)
    resident = np.add.reduceat(
        is_table[order].astype(np.uint64), starts) > 0
    vals = g_t + np.where(resident[:, None], g_s, g_e)
    # primary desc; the stable sort keeps lex order on ties
    top = np.argsort(-vals[:, 0], kind="stable")[:cap]
    new_keys = np.full((cap, kw), _SENTINEL, np.uint32)
    new_vals = np.zeros((cap, planes), np.float32)
    new_keys[:len(top)] = uniq[top]
    new_vals[:len(top)] = vals[top]
    return new_keys, new_vals


# ---- the spread family -----------------------------------------------------


def _np_bit_length_u32(h: np.ndarray) -> np.ndarray:
    """Integer bit_length of uint32 (0 -> 0), the same binary search over
    shifts as ops/spread.py _bit_length_u32."""
    h = np.asarray(h, dtype=np.uint32).copy()
    n = np.zeros(h.shape, np.uint32)
    for shift in (16, 8, 4, 2, 1):
        big = (h >> np.uint32(shift)) != 0
        n[big] += np.uint32(shift)
        h[big] >>= np.uint32(shift)
    return n + (h != 0).astype(np.uint32)


def np_spread_reg_rho(elems: np.ndarray, m: int):
    """Element lanes -> (register index [n] int64, rho [n] uint8), rho =
    33 - bit_length(h2) in [1, 33]."""
    elems = np.ascontiguousarray(elems, dtype=np.uint32)
    r = (hash_words_np(elems, seed=SPREAD_REG_SEED)
         % np.uint32(m)).astype(np.int64)
    h2 = hash_words_np(elems, seed=SPREAD_RHO_SEED)
    rho = (np.uint32(SPREAD_RHO_ZERO)
           - _np_bit_length_u32(h2)).astype(np.uint8)
    return r, rho


def np_spread_update(regs: np.ndarray, keys: np.ndarray,
                     elems: np.ndarray) -> None:
    """Scatter-max register update IN PLACE over real rows only (callers
    slice): regs [D, W, m] uint8 C-contiguous, keys [n, kw] and elems
    [n, ew] uint32 lanes."""
    depth, width, m = regs.shape
    if keys.shape[0] == 0:
        return
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    buckets = _np_buckets(keys, depth, width)
    r, rho = np_spread_reg_rho(elems, m)
    for d in range(depth):
        # flat view of the contiguous [W, m] row block (no copy)
        np.maximum.at(regs[d].reshape(-1), buckets[d] * m + r, rho)


def np_spread_query(regs: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """[n] float64 spread estimates of ``keys`` from the registers: the
    one decode every reader uses."""
    regs = np.asarray(regs)
    if keys.shape[0] == 0:
        return np.zeros(0, np.float64)
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    buckets = _np_buckets(keys, regs.shape[0], regs.shape[1])
    return spread_decode(regs, buckets)


def np_spread_table_merge(table_keys: np.ndarray, table_metric: np.ndarray,
                          cand_keys: np.ndarray, cand_pairs: np.ndarray):
    """Candidate-table admission fold: per-key distinct-pair counts
    accumulate (an upper bound on the true distinct count) and the top
    ``capacity`` keys by that metric stay. Returns (keys [cap, kw] uint32
    sentinel-padded, metric [cap] float32). The metric only admits keys:
    reported spreads are decoded from the registers."""
    tk, tv = np_topk_merge(
        table_keys, np.asarray(table_metric, np.float32)[:, None],
        cand_keys, np.asarray(cand_pairs, np.float32)[:, None],
        np.asarray(cand_pairs, np.float32)[:, None])
    return tk, tv[:, 0]
