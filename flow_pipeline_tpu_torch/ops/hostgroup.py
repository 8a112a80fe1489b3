"""Host-side exact groupby (numpy, or the port's native hash-group).

Counterpart of flow_pipeline_tpu/ops/hostgroup.py. The host-grouped
pipeline (engine/hostfused.py) groups each chunk here and ships only the
compact group tables to the device step. Grouping identity is the 64-bit
key hash ``hash_u64`` (the pair of ops/segment.py hash_lanes packed
high/low into one u64); with ``exact`` a full-key verification catches a
hash collision and regroups lexicographically, so the result is always
exact. ``native=True`` runs the C kernel of native/flowdecode.cc (same
hash, a stable radix sort and the verify in one pass, the same group
order); it is built at first use and raises when it cannot be, never
falling back to numpy.
"""

from __future__ import annotations

import numpy as np

# ops/segment.py's _HASH_MULT / _HASH_SEED, as numpy scalars
_MULTS = (np.uint32(0x9E3779B1), np.uint32(0x85EBCA77))
_SEEDS = (np.uint32(0x2545F491), np.uint32(0x27220A95))


def hash_u64(lanes: np.ndarray) -> np.ndarray:
    """[N, W] uint32 key lanes -> [N] uint64: the two 32-bit mixes of
    ops/segment.py hash_lanes packed high/low, so one ``np.argsort``
    orders rows by the full 64-bit identity."""
    n, w = lanes.shape
    out = []
    with np.errstate(over="ignore"):  # uint32 wraparound is the algorithm
        for mult, seed in zip(_MULTS, _SEEDS):
            h = np.full(n, seed, np.uint32)
            for i in range(w):
                h = (h ^ lanes[:, i]) * mult
                h = (h << np.uint32(13)) | (h >> np.uint32(19))
            h ^= h >> np.uint32(16)
            h *= np.uint32(0x85EBCA6B)
            h ^= h >> np.uint32(13)
            h *= np.uint32(0xC2B2AE35)
            h ^= h >> np.uint32(16)
            out.append(h)
    return (out[0].astype(np.uint64) << np.uint64(32)) | out[1]


def native_group_available() -> bool:
    """Whether the native hash-group kernel can serve (its library loads,
    building it first if needed; False without a compiler)."""
    from .. import native

    return native.available()


def _empty_groups(w: int, planes: list[np.ndarray]):
    return (np.zeros((0, w), np.uint32),
            [np.zeros((0,) + p.shape[1:],
                      np.float64 if np.issubdtype(p.dtype, np.floating)
                      else np.uint64) for p in planes],
            np.zeros(0, np.int64))


def _lex_regroup(lanes: np.ndarray):
    """Exact lexicographic grouping of [N, W] rows: (perm, group starts
    in the permuted order)."""
    n = lanes.shape[0]
    perm = np.lexsort(lanes.T[::-1])
    sl = lanes[perm]
    boundary = np.empty(n, dtype=bool)
    boundary[0] = True
    np.any(sl[1:] != sl[:-1], axis=1, out=boundary[1:])
    return perm, np.flatnonzero(boundary)


def grouping_perm(lanes: np.ndarray, exact: bool, h: np.ndarray = None,
                  native: bool = False):
    """(perm, starts) of the hash grouping of ``lanes`` [N, W] uint32:
    rows ``perm[starts[i]:starts[i+1]]`` form group i, groups in hash
    order. ``h`` passes precomputed hashes (the sharded path)."""
    n = lanes.shape[0]
    if native and h is None:
        from .. import native as native_lib

        perm, starts, collided = native_lib.hash_group(lanes)
        if exact and collided:
            return _lex_regroup(lanes)
        return perm, starts
    if h is None:
        h = hash_u64(lanes)
    perm = np.argsort(h)  # the identity is the hash: stability is moot
    sh = h[perm]
    boundary = np.empty(n, dtype=bool)
    boundary[0] = True
    np.not_equal(sh[1:], sh[:-1], out=boundary[1:])
    starts = np.flatnonzero(boundary)
    if exact:
        # verify every row against its group's first row; a 64-bit hash
        # collision regroups lexicographically
        sl = lanes[perm]
        seg = np.cumsum(boundary) - 1
        if (sl != sl[starts][seg]).any():
            return _lex_regroup(lanes)
    return perm, starts


def reduce_groups(lanes: np.ndarray, planes: list[np.ndarray],
                  perm: np.ndarray, starts: np.ndarray):
    """(uniq, sums, counts) of a grouping from grouping_perm. Each plane
    is summed per group in float64 (floating planes) or uint64 (integer
    planes); callers cast down."""
    n = perm.shape[0]
    uniq = lanes[perm[starts]]
    counts = np.diff(np.append(starts, n)).astype(np.int64)
    sums = []
    for p in planes:
        acc_dtype = (np.float64 if np.issubdtype(p.dtype, np.floating)
                     else np.uint64)
        sums.append(np.add.reduceat(p[perm].astype(acc_dtype), starts,
                                    axis=0))
    return uniq, sums, counts


def group_by_key(lanes: np.ndarray, planes: list[np.ndarray],
                 exact: bool = True, native: bool = False):
    """Groupby-sum of ``planes`` ([N] or [N, P] arrays) by the rows of
    ``lanes`` [N, W] uint32. ``exact`` verifies every row against its
    group's key (sketch callers pass False and accept a merge of two
    keys on a 64-bit collision, as the device groupby does); ``native``
    groups with the C kernel. Returns (uniq [G, W] uint32, sums per
    plane, counts [G] int64), groups in hash order."""
    n, w = lanes.shape
    if n == 0:
        return _empty_groups(w, planes)
    perm, starts = grouping_perm(lanes, exact, native=native)
    return reduce_groups(lanes, planes, perm, starts)


def select_lanes(key_cols: tuple, widths: dict[str, int],
                 subset: tuple) -> list[int]:
    """Lane indices of the ``subset`` columns inside the concatenated
    lane layout of ``key_cols`` (an address takes ``widths[name]``
    lanes). Raises KeyError when a subset column is absent."""
    offsets = {}
    off = 0
    for name in key_cols:
        offsets[name] = off
        off += widths[name]
    out: list[int] = []
    for name in subset:
        start = offsets[name]
        out.extend(range(start, start + widths[name]))
    return out
