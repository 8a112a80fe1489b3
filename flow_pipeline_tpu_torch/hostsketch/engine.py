"""Host sketch engine: the host twin of models/heavy_hitter.py
``_apply_grouped`` (CMS update -> table prefilter -> admission merge), the
invertible family's fold and decode, and the spread family's fold.

Counterpart of flow_pipeline_tpu/hostsketch/engine.py. Two backends
behind one surface:

- **native**: the threaded uint64 engine of native/hostsketch.cc (the
  port's ``fpt_hs_*`` exports), the production route. The library is
  built at first use; a missing compiler or a failed build raises.
- **numpy**: the pure-numpy twins of the same semantics below, the plain
  versions the native kernels are tested against. The engine serves them
  only when asked to (``HostSketchEngine(use_native="numpy")``, the
  reference's own opt-out).

Every step reproduces the device step's arithmetic decisions exactly:
buckets from the same murmur3 word-lane hash, conservative targets
against the pre-update sketch, the prefilter's resident-hash boost with
a stable top-2C selection (lowest index first on ties), and the
admission merge's (primary desc, lex key asc) ranking. The engine has no
lock: every mutation runs on the worker thread (HostSketchPipeline), and
the native kernels join their threads before returning.
"""

from __future__ import annotations

import os

import numpy as np

from ..models.heavy_hitter import HeavyHitterConfig
from ..ops.hostgroup import hash_u64
from ..ops.spread import (SPREAD_REG_SEED, SPREAD_RHO_SEED, SPREAD_RHO_ZERO,
                          spread_decode)
from .state import (_U64_CAP, HostHHState, HostInvState, from_device_state,
                    host_hh_init, host_inv_init, to_device_state)

_SENTINEL = np.uint32(0xFFFFFFFF)

# The invertible sketch's checksum hash constants: protocol constants
# shared bit for bit with native/hostsketch.cc inv_key_hash (all
# arithmetic mod 2^64).
INV_HASH_SEED = np.uint64(0x9E3779B97F4A7C15)
INV_HASH_M1 = np.uint64(0xFF51AFD7ED558CCD)
INV_HASH_M2 = np.uint64(0xC4CEB9FE1A85EC53)
_U64_ALL = np.uint64(0xFFFFFFFFFFFFFFFF)

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




def sketch_backend_available() -> bool:
    """Whether the native engine can serve: its library loads (building
    it first if needed; False only without a compiler)."""
    from .. import native

    return native.sketch_available()


# ---- numpy twins of the native entry points --------------------------------


def _addend_u64(vals: np.ndarray) -> np.ndarray:
    """f32 addends -> u64, as native addend_u64 casts them: negatives and
    NaN add nothing, values at or past 2^64 (inf included) clamp to
    UINT64_MAX, the rest cast exactly."""
    v = np.asarray(vals, dtype=np.float32)
    with np.errstate(invalid="ignore"):
        v = np.where(np.isnan(v) | (v <= 0), np.float32(0.0), v)
        big = v >= np.float32(2.0**64)
        v = np.minimum(v, _U64_CAP)
    out = v.astype(np.uint64)
    out[big] = _U64_ALL
    return out


def _np_buckets(keys: np.ndarray, depth: int, width: int) -> np.ndarray:
    """[depth, n] int64 bucket indices (ops/cms.py cms_buckets in numpy)."""
    out = np.empty((depth, keys.shape[0]), np.int64)
    for d in range(depth):
        h = hash_words_np(keys, seed=d)
        out[d] = (h % np.uint32(width)).astype(np.int64)
    return out


def _bucket_groups(b: np.ndarray):
    """Sort and segment one depth row's bucket indices: (order, starts,
    uniq) with rows ``order[starts[i]:starts[i+1]]`` all in bucket
    ``uniq[i]``, so a reduceat and ONE fancy-indexed accumulate replace a
    per-element ``ufunc.at``. u64 wrap sums and maxes are order-free, so
    the regrouping is bit-exact."""
    order = np.argsort(b, kind="stable")
    sb = b[order]
    boundary = np.empty(len(sb), bool)
    boundary[0] = True
    np.not_equal(sb[1:], sb[:-1], out=boundary[1:])
    starts = np.flatnonzero(boundary)
    return order, starts, sb[starts]


# numpy >= 1.25 has fast integer ufunc.at (add, maximum); older numpy's
# buffered ufunc.at is slow, and the grouped scatter wins there. Both
# branches are bit-exact twins; the flag only chooses the cheaper one.
_GROUPED_SCATTER = tuple(
    int(x) for x in np.__version__.split(".")[:2]) < (1, 25)


def np_cms_update(cms: np.ndarray, keys: np.ndarray, vals: np.ndarray,
                  conservative: bool,
                  buckets: np.ndarray | None = None) -> None:
    """uint64 CMS update in place over real rows only (callers slice).
    ``buckets`` (``_np_buckets(keys, depth, width)``) lets a caller reuse
    one hash pass for the update and the admission query."""
    p, depth, width = cms.shape
    if keys.shape[0] == 0:
        return
    if buckets is None:
        buckets = _np_buckets(keys, depth, width)
    add = _addend_u64(vals)
    grouped = _GROUPED_SCATTER
    if not conservative:
        with np.errstate(over="ignore"):
            for d in range(depth):
                if grouped:
                    order, starts, ub = _bucket_groups(buckets[d])
                    g = np.add.reduceat(add[order], starts, axis=0)
                    cms[:, d, ub] += g.T
                else:
                    for pi in range(p):
                        np.add.at(cms[pi, d], buckets[d], add[:, pi])
        return
    # conservative: targets against the PRE-update sketch, then an
    # order-free scatter-max (the device step's two halves)
    est = np_cms_query_u64(cms, keys, buckets)
    target = est + add
    for d in range(depth):
        if grouped:
            order, starts, ub = _bucket_groups(buckets[d])
            g = np.maximum.reduceat(target[order], starts, axis=0)
            cms[:, d, ub] = np.maximum(cms[:, d, ub], g.T)
        else:
            for pi in range(p):
                np.maximum.at(cms[pi, d], buckets[d], target[:, pi])


def np_cms_query_u64(cms: np.ndarray, keys: np.ndarray,
                     buckets: np.ndarray | None = None) -> np.ndarray:
    """[n, P] uint64 min-over-depth estimates."""
    p, depth, width = cms.shape
    if buckets is None:
        buckets = _np_buckets(keys, depth, width)
    est = np.ascontiguousarray(cms[:, 0, buckets[0]].T)
    for d in range(1, depth):
        np.minimum(est, cms[:, d, buckets[d]].T, out=est)
    return est


def np_cms_query(cms: np.ndarray, keys: np.ndarray,
                 buckets: np.ndarray | None = None) -> np.ndarray:
    """[n, P] float32 estimates (ops/cms.py cms_query's host twin)."""
    return np_cms_query_u64(cms, keys, buckets).astype(np.float32)


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


# ---- the invertible family -------------------------------------------------
#
# The invertible family replaces the admission table with key-recovery
# planes folded beside the CMS buckets (the same murmur3 buckets):
#
#   cms[p, d, b]    += addend_u64(vals[p])          (plain; all planes)
#   keysum[d, b, l] += key[l] * cnt                 (wrap)
#   keycheck[d, b]  += inv_key_hash(key) * cnt      (wrap)
#
# Every cell is a plain u64 wrap sum, so the state is LINEAR in the stream:
# chunking, sharding and thread order cannot change it. Heavy keys are
# recovered at window close by peeling pure buckets (np_inv_decode): a
# bucket holding one distinct key divides out exactly and verifies
# against the checksum plane and its own bucket hash.
#
# The peel assumes every row's count addend is at least 1, as the
# pipeline's count plane makes it (one per flow, grouped). A row with
# count 0 adds its value planes without touching count, keysum or
# keycheck, so a bucket can look pure while it carries another key's
# value: then the numpy twin (rounds, lowest depth row first) and the
# native kernel (a LIFO work list) report different rows' values.


def np_inv_key_hash(keys: np.ndarray) -> np.ndarray:
    """[n] uint64 checksum hash of [n, W] uint32 key lanes (native
    inv_key_hash's twin, wrap arithmetic mod 2^64)."""
    keys = np.asarray(keys, dtype=np.uint32)
    with np.errstate(over="ignore"):
        h = np.full(keys.shape[0], INV_HASH_SEED, np.uint64)
        for lane in range(keys.shape[1]):
            h = h ^ keys[:, lane].astype(np.uint64)
            h = h * INV_HASH_M1
            h = h ^ (h >> np.uint64(33))
        h = h * INV_HASH_M2
        h = h ^ (h >> np.uint64(29))
    return h


def np_inv_update(st: HostInvState, keys: np.ndarray,
                  vals: np.ndarray) -> None:
    """Invertible update in place over real rows only (callers slice):
    ``keys`` [n, kw] uint32, ``vals`` [n, P+1] float32 addends with the
    count plane LAST (its u64 cast is the key's weight)."""
    planes, depth, width = st.cms.shape
    if keys.shape[0] == 0:
        return
    keys = np.asarray(keys, dtype=np.uint32)
    buckets = _np_buckets(keys, depth, width)
    add = _addend_u64(vals)
    cnt = add[:, -1]
    h64 = np_inv_key_hash(keys)
    with np.errstate(over="ignore"):
        lanes_u64 = keys.astype(np.uint64) * cnt[:, None]
        check = h64 * cnt
        if _GROUPED_SCATTER:
            for d in range(depth):
                order, starts, ub = _bucket_groups(buckets[d])
                st.cms[:, d, ub] += \
                    np.add.reduceat(add[order], starts, axis=0).T
                st.keysum[d][ub] += \
                    np.add.reduceat(lanes_u64[order], starts, axis=0)
                st.keycheck[d][ub] += \
                    np.add.reduceat(check[order], starts)
        else:
            for pi in range(planes):
                for d in range(depth):
                    np.add.at(st.cms[pi, d], buckets[d], add[:, pi])
            for d in range(depth):
                np.add.at(st.keysum[d], buckets[d], lanes_u64)
                np.add.at(st.keycheck[d], buckets[d], check)


def np_inv_decode(cms: np.ndarray, keysum: np.ndarray,
                  keycheck: np.ndarray):
    """Heavy-key recovery by peeling pure buckets (native hs_inv_decode's
    twin; inputs read-only, the peel works on copies). Returns (keys [K,
    kw] uint32, vals [K, P+1] uint64 exact sums) in lexicographic key
    order."""
    planes, depth, width = cms.shape
    kw = keysum.shape[2]
    cms = cms.copy()
    keysum = keysum.copy()
    keycheck = keycheck.copy()
    out_keys: list[np.ndarray] = []
    out_vals: list[np.ndarray] = []
    n_out = 0
    # an honest state decodes at most depth*width keys (each decode
    # zeroes its own bucket); the cap bounds the peel on a corrupted one,
    # as the native kernel's output buffers do
    max_out = depth * width
    seen: set[bytes] = set()
    cand = cms[-1] != 0  # [depth, width] candidate buckets this round
    while cand.any() and n_out < max_out:
        d_idx, b_idx = np.nonzero(cand)
        cnt = cms[-1, d_idx, b_idx]
        ok = cnt != 0
        cnt_safe = np.where(ok, cnt, np.uint64(1))
        ks = keysum[d_idx, b_idx, :]
        q = ks // cnt_safe[:, None]
        ok &= (q * cnt_safe[:, None] == ks).all(axis=1)  # divides evenly
        ok &= (q <= np.uint64(0xFFFFFFFF)).all(axis=1)
        qk = q.astype(np.uint32)
        with np.errstate(over="ignore"):
            ok &= np_inv_key_hash(qk) * cnt_safe == keycheck[d_idx, b_idx]
        for d in range(depth):  # the key must hash to this bucket
            m = ok & (d_idx == d)
            if m.any():
                h = hash_words_np(np.ascontiguousarray(qk[m]), seed=d)
                ok[np.nonzero(m)[0][h % np.uint32(width) != b_idx[m]]] \
                    = False
        rows = np.flatnonzero(ok)
        if not len(rows):
            break
        # dedup within the round (a key pure in several rows decodes in
        # each, with identical values) and against earlier rounds
        kview = np.ascontiguousarray(qk[rows]).view(
            [("", np.uint32)] * kw).reshape(-1)
        _, first = np.unique(kview, return_index=True)
        picked = []
        for i in sorted(first):
            if kview[i].tobytes() not in seen:
                seen.add(kview[i].tobytes())
                picked.append(rows[i])
        if not picked:
            break
        picked = np.asarray(picked[:max_out - n_out])
        dec_keys = np.ascontiguousarray(qk[picked])
        dec_vals = np.stack(
            [cms[p, d_idx[picked], b_idx[picked]] for p in range(planes)],
            axis=1)
        out_keys.append(dec_keys)
        out_vals.append(dec_vals)
        n_out += len(picked)
        # peel each decoded key from every depth row (wrap subtraction),
        # then rescan only the touched buckets
        dcnt = dec_vals[:, -1]
        h64 = np_inv_key_hash(dec_keys)
        touched = np.zeros((depth, width), bool)
        with np.errstate(over="ignore"):
            lanes_u64 = dec_keys.astype(np.uint64) * dcnt[:, None]
            check = h64 * dcnt
            for d in range(depth):
                bb = (hash_words_np(dec_keys, seed=d)
                      % np.uint32(width)).astype(np.int64)
                for p in range(planes):
                    np.subtract.at(cms[p, d], bb, dec_vals[:, p])
                np.subtract.at(keysum[d], bb, lanes_u64)
                np.subtract.at(keycheck[d], bb, check)
                touched[d, bb] = True
        cand = touched & (cms[-1] != 0)
    if not out_keys:
        return (np.zeros((0, kw), np.uint32),
                np.zeros((0, planes), np.uint64))
    keys = np.concatenate(out_keys)
    vals = np.concatenate(out_vals)
    order = np.lexsort(keys.T[::-1])
    return (np.ascontiguousarray(keys[order]),
            np.ascontiguousarray(vals[order]))


def inv_decode_state(state, use_native: bool = True):
    """Lexicographically ordered decode of any invertible-state form
    (HostInvState, InvState, or a checkpoint field dict): the native
    kernel, as in the reference whenever its library loads (its decode
    set does not depend on the peel order, so the sort makes the two
    routes array-equal on pipeline states), or with ``use_native=False``
    the numpy twin."""
    if isinstance(state, dict):
        cms, ks, kc = state["cms"], state["keysum"], state["keycheck"]
    else:
        cms, ks, kc = state.cms, state.keysum, state.keycheck
    cms = np.ascontiguousarray(np.asarray(cms), dtype=np.uint64)
    ks = np.ascontiguousarray(np.asarray(ks), dtype=np.uint64)
    kc = np.ascontiguousarray(np.asarray(kc), dtype=np.uint64)
    if not use_native:
        return np_inv_decode(cms, ks, kc)
    from .. import native

    keys, vals = native.hs_inv_decode(cms, ks, kc)
    order = np.lexsort(keys.T[::-1])
    return (np.ascontiguousarray(keys[order]),
            np.ascontiguousarray(vals[order]))


def inv_extract(state, capacity: int, use_native: bool = True):
    """The ranked candidate table of an invertible sketch at window close:
    (table_keys [capacity, kw] uint32 sentinel-padded, table_vals
    [capacity, P+1] float32), ranked by the exact u64 primary sums
    descending with the lexicographic tie-break, the table family's
    ranking. The all-sentinel key is dropped, as topk_merge_est drops
    it."""
    keys, vals = inv_decode_state(state, use_native)
    real = (keys != _SENTINEL).any(axis=1)
    keys, vals = keys[real], vals[real]
    kw = keys.shape[1]
    planes = vals.shape[1]
    # stable ascending sort of (U64_MAX - primary): primary desc with the
    # lex order (the decode's) on ties
    order = np.argsort(_U64_ALL - vals[:, 0], kind="stable")[:capacity]
    table_keys = np.full((capacity, kw), _SENTINEL, np.uint32)
    table_vals = np.zeros((capacity, planes), np.float32)
    table_keys[:len(order)] = keys[order]
    table_vals[:len(order)] = vals[order].astype(np.float32)
    return table_keys, table_vals


# ---- the spread family -----------------------------------------------------
#
# Per-key HLL register planes [depth, width, m] uint8 over the same bucket
# rows the CMS uses; every update is an integer max, so chunking,
# grouping, thread order and sharding cannot change a bit of the state.


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


def spread_apply_update(regs: np.ndarray, keys: np.ndarray,
                        elems: np.ndarray, threads: int = 1, stats=None,
                        use_native: bool = True) -> None:
    """Fold one pre-grouped (key, element) table into the registers: the
    threaded native kernel, or with ``use_native=False`` the numpy twin
    (the same registers: an integer max is order-free)."""
    if not use_native:
        np_spread_update(regs, keys, elems)
        return
    from .. import native

    native.hs_spread_update(regs, keys, elems, threads, stats=stats)


# ---- the engine -------------------------------------------------------------


class HostSketchEngine:
    """Per-family host sketch state and the grouped-update step, owned and
    driven by HostSketchPipeline on the worker thread. The parallelism
    lives inside the native kernels, which join before returning.

    ``use_native``: "auto" and "native" run the native kernels (building
    the library; a build failure raises), "numpy" the numpy twins.
    ``threads`` 0 picks half the cores, at most 4 (the kernels are
    memory-bound: more threads mostly thrash the shared cache)."""

    def __init__(self, configs: list[HeavyHitterConfig],
                 use_native: str = "auto", threads: int = 0):
        if use_native not in ("auto", "native", "numpy"):
            raise ValueError(
                f"use_native must be auto|native|numpy, got {use_native!r}")
        self.configs = list(configs)
        self.native = use_native != "numpy"
        if self.native and not sketch_backend_available():
            raise RuntimeError("the native host sketch engine cannot be "
                               "built here (no g++ on PATH)")
        self.threads = threads or max(1, min(4, (os.cpu_count() or 1) // 2))
        self.states: list[HostHHState | HostInvState | None] = \
            [None] * len(self.configs)
        for cfg in self.configs:
            if cfg.table_admission not in ("est", "plain"):
                raise ValueError(f"table_admission must be est|plain, got "
                                 f"{cfg.table_admission!r}")

    def _invertible(self, i: int) -> bool:
        return self.configs[i].hh_sketch == "invertible"

    # ---- state plumbing ---------------------------------------------------

    def reset(self, i: int) -> None:
        self.states[i] = host_inv_init(self.configs[i]) \
            if self._invertible(i) else host_hh_init(self.configs[i])

    def import_state(self, i: int, device_state) -> None:
        self.states[i] = from_device_state(device_state)

    def export_state(self, i: int, device):
        """Family ``i``'s state as a fresh model-facing state (a torch
        HHState on ``device``, or an InvState)."""
        if self.states[i] is None:
            self.reset(i)
        return to_device_state(self.states[i], device)

    # ---- the grouped update step ------------------------------------------

    def update(self, i: int, uniq: np.ndarray, sums: np.ndarray,
               n_groups: int, stats=None) -> None:
        """Fold one prepared group table into family ``i``: the host twin
        of heavy_hitter._apply_grouped. ``uniq`` [B, W] uint32 padded,
        ``sums`` [B, P+1] float32 (count plane last), the first
        ``n_groups`` rows real. The prefilter condition tests the PADDED
        B (the device step's static-shape condition); with n_groups <=
        2*capacity both branches give the same table, so slicing to the
        real rows first stays bit-exact."""
        cfg = self.configs[i]
        if self.states[i] is None:
            self.reset(i)
        st = self.states[i]
        if n_groups <= 0:
            return  # an all-invalid chunk: CMS and table are no-ops
        padded_b = uniq.shape[0]
        uniq = np.ascontiguousarray(uniq[:n_groups], dtype=np.uint32)
        sums = np.ascontiguousarray(sums[:n_groups], dtype=np.float32)
        threads = 1 if n_groups < 2048 else self.threads
        if self.native:
            from .. import native
        if self._invertible(i):
            # the invertible family's whole step: one per-bucket fold
            if self.native:
                native.hs_inv_update(st.cms, st.keysum, st.keycheck, uniq,
                                     sums, None, threads, stats=stats)
            else:
                np_inv_update(st, uniq, sums)
            return
        buckets = None
        if self.native:
            native.hs_cms_update(st.cms, uniq, sums, None, cfg.conservative,
                                 threads, stats=stats)
        else:
            # one hash pass for the update and the admission query
            buckets = _np_buckets(uniq, st.cms.shape[1], st.cms.shape[2])
            np_cms_update(st.cms, uniq, sums, cfg.conservative,
                          buckets=buckets)
        if cfg.table_prefilter and padded_b > 2 * cfg.capacity:
            sel = self._prefilter(st, uniq, sums, cfg.capacity, threads,
                                  stats)
            uniq = np.ascontiguousarray(uniq[sel])
            sums = np.ascontiguousarray(sums[sel])
            if buckets is not None:
                buckets = np.ascontiguousarray(buckets[:, sel])
        if cfg.table_admission == "plain":
            est = sums
        elif self.native:
            est = native.hs_cms_query(st.cms, uniq, threads, stats=stats)
        else:
            est = np_cms_query(st.cms, uniq, buckets)
        if self.native:
            native.hs_topk_merge(st.table_keys, st.table_vals, uniq, sums,
                                 est, None, stats=stats)
        else:
            st.table_keys, st.table_vals = np_topk_merge(
                st.table_keys, st.table_vals, uniq, sums, est)

    def _prefilter(self, st: HostHHState, uniq: np.ndarray,
                   sums: np.ndarray, cap: int, threads: int, stats=None):
        """The prefilter of _apply_grouped: residents (the 32-bit hash
        lane of hash_lanes, the high word of ops/hostgroup.py hash_u64,
        found in the table's) boosted to +inf, then the top 2C rows by
        (metric desc, index asc). Returns the selected row indices."""
        if self.native:
            from .. import native

            return native.hs_hh_prefilter(st.table_keys, uniq, sums,
                                          threads, stats=stats)
        th = (hash_u64(np.ascontiguousarray(st.table_keys))
              >> np.uint64(32)).astype(np.uint32)
        gh = (hash_u64(uniq) >> np.uint64(32)).astype(np.uint32)
        ts = np.sort(th)
        pos = np.clip(np.searchsorted(ts, gh), 0, cap - 1)
        resident = ts[pos] == gh
        metric = sums[:, 0].copy()
        metric[resident] = np.float32(np.inf)
        return np.argsort(-metric, kind="stable")[:2 * cap]
