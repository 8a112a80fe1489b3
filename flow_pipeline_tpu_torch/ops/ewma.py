"""Per-bucket EWMA baselines (mean + variance) for anomaly detection.

Counterpart of flow_pipeline_tpu/ops/ewma.py: keys hash into a fixed
bucket array, each window's rates are scatter-added, and the window close
folds the rate into an exponentially weighted mean and variance per
bucket; z-scores against that baseline drive the DDoS detector.

The fold's multiply-adds are evaluated with one rounding each and the
square root correctly rounded (ops/f32math.py), as the reference
computes them, so the baseline's and the z-scores' bits match the
reference's on the CPU and on the card.
"""

from __future__ import annotations

import torch

from ..schema.keys import hash_words
from .f32math import fma32, sqrt32


def ewma_init(n_buckets: int, device="cpu"):
    """(mean, var, seen) arrays."""
    return (torch.zeros(n_buckets, dtype=torch.float32, device=device),
            torch.zeros(n_buckets, dtype=torch.float32, device=device),
            torch.zeros(n_buckets, dtype=torch.bool, device=device))


def bucket_of(keys: torch.Tensor, n_buckets: int,
              seed: int = 0x5EED) -> torch.Tensor:
    """[N, W] key lanes -> [N] int64 bucket ids."""
    return hash_words(keys, seed=seed) % n_buckets


def rate_accumulate(rates, buckets, values, valid):
    """Scatter-add per-row values into the window's per-bucket rates (a
    new tensor). Integer-valued sums below 2^24 are exact in any order."""
    v = torch.where(valid, values.to(torch.float32), 0.0)
    return rates.index_add(0, buckets, v)


def ewma_fold(state, rates, alpha: float):
    """Close a window: d = x - mean; mean += a*d; var = (1-a)*(var +
    a*d^2). Buckets never seen before take their first rate as the mean
    (no cold-start alarm)."""
    mean, var, seen = state
    a = torch.tensor(alpha, dtype=torch.float32, device=rates.device)
    d = rates - mean
    new_mean = torch.where(seen, fma32(d, a, mean), rates)
    new_var = torch.where(seen, (1.0 - a) * fma32(a * d, d, var),
                          torch.zeros_like(var))
    new_seen = seen | (rates > 0)
    return new_mean, new_var, new_seen


def zscores(state, rates, min_sigma: float = 1.0, rel_sigma: float = 0.25):
    """Per-bucket z-score of the window's rate against the EW baseline,
    the denominator floored at ``min_sigma`` and ``rel_sigma * mean``."""
    mean, var, seen = state
    f32 = dict(dtype=torch.float32, device=rates.device)
    sigma = torch.maximum(sqrt32(var), torch.tensor(min_sigma, **f32))
    sigma = torch.maximum(sigma, torch.tensor(rel_sigma, **f32) * mean)
    z = (rates - mean) / sigma
    return torch.where(seen, z, 0.0)
