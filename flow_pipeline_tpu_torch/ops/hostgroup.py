"""Host-side exact grouping helpers (numpy).

Copy of the two pure-numpy pieces of flow_pipeline_tpu/ops/hostgroup.py
that the port uses: ``hash_u64``, the 64-bit grouping hash of key lanes
(the pair of ops/segment.py hash_lanes packed high/low into one u64), and
``_lex_regroup``, the exact lexicographic grouping that flows_5m's host
fold (models/window_agg.py rows_from_stores) runs over uint64 key rows.
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
