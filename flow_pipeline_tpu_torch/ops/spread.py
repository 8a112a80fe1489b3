"""Distinct-count (spread) sketch ops: a CMS of HyperLogLogs.

Counterpart of flow_pipeline_tpu/ops/spread.py. Per key, u8 HLL register
rows over the count-min bucket scheme of ops/cms.py:

    regs: [depth, width, m] uint8      (m registers per bucket)
    bucket_d(key) = hash_words(key_lanes, seed=d) % width
    r             = hash_words(elem_lanes, SPREAD_REG_SEED) % m
    rho           = clz32(hash_words(elem_lanes, SPREAD_RHO_SEED)) + 1
    update:  regs[d, bucket_d, r] = max(regs[d, bucket_d, r], rho)

Every update is an integer max, so the state is a commutative,
associative and idempotent monoid: update order, chunking and
pre-grouping to unique (key, element) pairs cannot change a bit of it,
and a merge is an element-wise max. ``spread_update`` is the torch form
(u32 lanes in int64 carriers, as everywhere in the port); the processor
keeps spread state in host numpy and folds it with the numpy twin
(hostsketch/engine.py np_spread_update), which gives the same registers.

The estimate is decoded at read time on the host in float64 (HLL
harmonic mean, linear counting for small ranges, the 32-bit large-range
correction, then min over depth rows), copied from the reference bit for
bit, including where it is not monotone in the registers.
"""

from __future__ import annotations

import numpy as np
import torch

from ..schema.keys import hash_words
from .cms import cms_buckets

# Element-hash protocol constants (the reference's, shared with the
# numpy twin). Both lie far outside the bucket seeds 0..depth-1.
SPREAD_REG_SEED = 0x9E3779B9
SPREAD_RHO_SEED = 0x85EBCA6B

# rho of a zero hash: all 32 bits are leading zeros, plus one
SPREAD_RHO_ZERO = 33


def spread_init(depth: int, width: int, m: int,
                device: str | torch.device = "cuda") -> torch.Tensor:
    """Fresh register planes: [depth, width, m] uint8 zeros."""
    return torch.zeros((depth, width, m), dtype=torch.uint8, device=device)


def _bit_length_u32(h: torch.Tensor) -> torch.Tensor:
    """Integer bit_length of u32 values in int64 carriers (0 -> 0), by the
    reference's binary search over shifts."""
    n = torch.zeros_like(h)
    for shift in (16, 8, 4, 2, 1):
        big = (h >> shift) != 0
        n = torch.where(big, n + shift, n)
        h = torch.where(big, h >> shift, h)
    return n + (h != 0).to(h.dtype)


def spread_update(regs: torch.Tensor, keys: torch.Tensor,
                  elems: torch.Tensor, valid=None) -> torch.Tensor:
    """Scatter-max update of ``regs`` with (key, element) rows; returns
    new registers (``regs`` is not written).

    regs [D, W, m] uint8; keys [N, Wk] and elems [N, We] integer lanes
    (low 32 bits are the word); valid [N] bool (padded rows contribute
    rho = 0, a no-op under max)."""
    d, w, m = regs.shape
    buckets = cms_buckets(keys, d, w)  # [D, N] int64
    r = hash_words(elems, seed=SPREAD_REG_SEED) % m
    h2 = hash_words(elems, seed=SPREAD_RHO_SEED)
    rho = (SPREAD_RHO_ZERO - _bit_length_u32(h2)).to(torch.uint8)
    if valid is not None:
        rho = torch.where(valid, rho, torch.zeros_like(rho))
    out = regs.clone()
    for di in range(d):
        out[di].view(-1).scatter_reduce_(0, buckets[di] * m + r, rho,
                                         "amax")
    return out


def spread_merge(*states: torch.Tensor) -> torch.Tensor:
    """Element-wise max fold: the exact merge."""
    out = states[0]
    for s in states[1:]:
        out = torch.maximum(out, s)
    return out


# ---- decode: host float64, the reference's arithmetic --------------------

def _hll_alpha(m: int) -> float:
    if m == 16:
        return 0.673
    if m == 32:
        return 0.697
    if m == 64:
        return 0.709
    return 0.7213 / (1.0 + 1.079 / m)


_TWO32 = float(1 << 32)


def spread_estimate(rows: np.ndarray) -> np.ndarray:
    """HLL estimate per register row: rows [..., m] uint8 -> [...]
    float64 (harmonic mean; linear counting when E <= 2.5 m with empty
    registers; the 32-bit large-range correction)."""
    rows = np.asarray(rows, dtype=np.uint8)
    m = rows.shape[-1]
    alpha = _hll_alpha(m)
    inv = np.ldexp(1.0, -rows.astype(np.int64))  # exact 2^-reg
    est = alpha * m * m / np.sum(inv, axis=-1)
    zeros = np.count_nonzero(rows == 0, axis=-1)
    small = (est <= 2.5 * m) & (zeros > 0)
    with np.errstate(divide="ignore"):
        lc = m * np.log(np.where(zeros > 0, m / np.maximum(zeros, 1), 1.0))
    est = np.where(small, lc, est)
    large = est > _TWO32 / 30.0
    est = np.where(large, -_TWO32 * np.log1p(-np.minimum(est, _TWO32 * 0.99999)
                                             / _TWO32), est)
    return est


def spread_decode(regs: np.ndarray, buckets: np.ndarray) -> np.ndarray:
    """Point estimates for pre-hashed buckets, min over depth rows.
    regs [D, W, m] uint8, buckets [D, N] integers -> [N] float64."""
    regs = np.asarray(regs)
    d = regs.shape[0]
    ests = [spread_estimate(regs[di, np.asarray(buckets[di])])
            for di in range(d)]
    return np.minimum.reduce(ests)
